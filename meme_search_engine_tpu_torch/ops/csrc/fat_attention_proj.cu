// Fat-layout ViT self-attention fused with the o-projection and the
// residual add, for the SigLIP image tower on Hopper (sm_90a):
//   out = res + attention(qkvf) @ Wo + bo
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/attention.py:fat_vit_mha_packed_proj
//   (_fat_vit_proj_kernel)
// which computes what the image tower computes as kernels 7 + 2
// (fat_vit_mha_packed, then matmul_residual) in one launch, the attention
// rounded to bf16 before Wo (attention.py:413-415).
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at B=128,
// SP=736, H=16, C=80, H*D = DM = 1152: 339 GFLOP of attention (Q.K^T over
// C columns, P.V over the D + 1 the output reads) and 250 GFLOP of
// projection (0.60 ms) against 1.09 GB of qkvf, res, Wo and the output
// (0.33 ms), so operations bound it.
//
// Design: a thread-block cluster over heads. One (image, 128-row query
// block) needs the attention of all H heads before its projection, and
// that block, 128 x 1152 bf16 (295 KB), does not fit one CTA's shared
// memory. So the heads are spread over a cluster of H / 2 CTAs (8 at
// SO400M, the portable cluster size), CTA j taking heads 2j and 2j + 1.
// The grid is persistent: as many clusters as the card holds at once (15
// of 8 on an H100, cudaOccupancyMaxActiveClusters) walk the tiles, an
// image's query blocks next to each other, so the clusters on them read
// its K and V from L2 once between them; a tile's attention loads start as
// soon as this CTA is done with the last tile's ring, under the cluster
// barrier that ends it (2-5% faster than a cluster a tile).
// - Attention phase: each CTA is a CTA of kernel 7 (fat_attention.cuh):
//   a producer warpgroup whose one thread issues the TMA loads (Q, 3-stage
//   K and V rings), two consumer warpgroups of 64 rows taking turns on the
//   tensor cores, here with each key tile's softmax after both of its
//   products (the overlapped order of kernel 7 makes ptxas serialise every
//   wgmma of the kernel, the projection's too: 2.86 against 2.58 ms). Its
//   two heads' O / l go, rounded to bf16, into a (128, 2 DP) slice of its
//   own shared memory (DP: D rounded up to 8; 37 KB at SO400M) as 32-byte
//   swizzled 16-column slabs, the K-major layout the projection's wgmma
//   reads. The attention output never goes to device memory.
// - Projection phase, after a cluster barrier: CTA j computes output
//   columns [NC j, NC j + NC) (NC = 144 at SO400M) over K = H DP, in
//   k-chunks of 48 columns (3 slabs; 24 at SO400M): first the three of
//   its own slice, read in place, then those of peer (j + 1) % CL, (j + 2)
//   % CL, ... Peers push their chunks into this CTA's 6-stage ring (the
//   memory of the attention's buffers) with bulk copies across the
//   cluster's shared memory, which complete on a barrier of this CTA; a
//   chunk's Wo rows (this CTA's columns) come by TMA as two 64-column boxes,
//   128-byte swizzled, and one 16-column box. One producer thread keeps the
//   ring's Wo loads going, another pushes this CTA's slice to its peers.
//   A peer pushes chunk t into a stage only after this CTA's consumers
//   have finished chunk t - 6 there and arrived on that peer's barrier for
//   chunk t (one barrier a chunk, so none runs a phase ahead of its
//   waiter). Each consumer warpgroup issues m64n128k16 + m64n16k16 wgmmas
//   (SS) into fp32 accumulators that start as bo. Wo is read from L2 once
//   per cluster: 2.0 GB at B = 128.
// - Epilogue: res comes by TMA into the output staging (the ring's first
//   two stages, once their last chunks are done), each thread adds its
//   accumulators to its own words and rounds once to bf16, then TMA stores
//   clip rows past SP and columns past DM.
//
// On an H100 SXM at B = 128 it takes about 1.8 ms against 1.47-1.48 for
// kernels 7 + 2 (PERF.md lists the states tried); the attention phase, at
// kernel 7's rate on the 120 SMs the clusters hold, and the projection
// phase, which nothing overlaps, add up.
//
// Geometries: a CTA's slice, 2 DP columns, is a multiple of 16 and NC a
// wgmma N. Compiled for the fat widths padded to 16 (CP) of SO400M (80: DP
// 72, NC 144), tiny_test_config (32: DP 16, NC 32, clusters of 2, chunks
// of one slab) and tiny_fat_test_config (16: DP 8, NC 16; DM = 112 over 8
// CTAs is 14 columns, so the last CTA's 16 lie past DM: Wo's reads there
// give 0 and its stores are clipped). The wrapper pads qkvf's heads to CP
// and Wo's rows to DP a head (zero rows) where they are narrower.
//
// Where it is delicate:
// - Deadlock. Every new wait traps after 2^26 polls (hopper.cuh), so a
//   broken handshake fails as a launch error.
// - Peers' memory. Two cluster barriers a tile: no CTA pushes into a
//   peer's ring before every CTA of the cluster has written its slice
//   (and so finished its attention), and none writes its slice again, or
//   exits, before every CTA has consumed every chunk of the tile.
// - The peer handshake's scope. The arrivals on a peer's barriers and the
//   waits on them take the default (CTA) scope, as CUTLASS's cluster
//   pipelines do; release and acquire at cluster scope cost 0.45 ms here
//   (2.32 against 1.87).
// - The ragged tail (736 = 5 * 128 + 96): Q rows past SP are zeros (the
//   maps are 3-D, so a box never reads the next image), their output rows
//   are finite and the stores clip them; res reads past SP give 0.

#include "fat_attention.cuh"

namespace {

using fat::bf16;
using fat::BQ;
using fat::NT;

constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int NS = 6;           // the projection ring's stages

// per fat width CP: DP, the head width in the attention slice (D rounded
// up to 8), and NC, the output columns of a CTA
template <int CP>
struct Geom;
template <>
struct Geom<80> {
  static constexpr int DP = 72, NC = 144;
};
template <>
struct Geom<32> {
  static constexpr int DP = 16, NC = 32;
};
template <>
struct Geom<16> {
  static constexpr int DP = 8, NC = 16;
};

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int CP>
struct Proj {
  using L = fat::Layout<CP>;
  static constexpr int DP = Geom<CP>::DP, NC = Geom<CP>::NC;
  static constexpr int W = 2 * DP;  // a CTA's two heads: its slice's columns
  static_assert(W % 16 == 0 && NC % 16 == 0, "slices and output slabs of 16 columns");
  // the k-chunk: SUB 16-column slabs of a slice (48 columns at SO400M),
  // NSUB of them a slice, T in all
  static constexpr int SUB = W / 16 % 3 == 0 ? 3 : 1, NSUB = W / 16 / SUB;
  static constexpr int MAX_T = MAX_CLUSTER * NSUB;
  // a slice: 128 rows x W, K-major slabs of 16 columns; a chunk's A: SUB
  // of them; its B: KC rows (K) x NC, MN-major, as NW boxes of 64 columns
  // (128-byte swizzled, 128-byte rows) and NN slabs of 16 (32-byte
  // swizzled)
  static constexpr int KC = 16 * SUB, NW = NC / 64, NN = NC % 64 / 16;
  static_assert(NW == 0 || NW == 2, "a wgmma N of 128 for the wide boxes");
  static constexpr int A_SLAB = BQ * 32, A_BYTES = W / 16 * A_SLAB, A_CHUNK = SUB * A_SLAB;
  static constexpr int B_WBOX = KC * 128, B_SLAB = KC * 32;
  static constexpr int B_CHUNK = NW * B_WBOX + NN * B_SLAB;
  // the ring's stages take the attention's buffers
  static constexpr int STAGE = round_up(A_CHUNK + B_CHUNK, 1024), RING = NS * STAGE;
  static_assert(RING <= L::BYTES, "the ring fits the attention's buffers");
  // the output staging at the ring's start: each warpgroup's NC / 16
  // slabs of 64 rows x 16 columns, first holding res; it covers the first
  // RES_STAGES stages
  static constexpr int OUT_SLAB = 64 * 32, STAGING = 2 * (NC / 16) * OUT_SLAB;
  static constexpr int RES_STAGES = (STAGING + STAGE - 1) / STAGE;
  static_assert(STAGING <= RING, "output staging fits the ring");
  static constexpr int BARS = L::BARS + 2 * NS + 2 * MAX_T + 2;
  static constexpr int SMEM = 1024 + L::BYTES + A_BYTES + 8 * BARS;
};

// byte address of element (r, c) of a 32-byte swizzled slab of 16 columns
// (rows of 32 B; the 16-byte half c / 8 swaps when bit 2 of r is set)
__device__ __forceinline__ uint32_t swz32(uint32_t slab, int r, int c) {
  return slab + r * 32 + ((((c >> 3) ^ (r >> 2)) & 1) << 4) + (c & 7) * 2;
}

template <int CP>
__global__ void __launch_bounds__(NT, 1)
fat_attention_proj_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap two_wide,
                          const __grid_constant__ CUtensorMap two_narrow,
                          const __grid_constant__ CUtensorMap tres,
                          const __grid_constant__ CUtensorMap tout, const bf16* __restrict__ bo,
                          int B, int SP, int D, int DM) {
  using P = Proj<CP>;
  constexpr int NC = P::NC, W = P::W;
  extern __shared__ unsigned char smem_raw[];
  // the attention's buffers (then the projection's ring and the output
  // staging), this CTA's slice, the barriers; the same offsets in every
  // CTA, so a peer's buffer is peer_addr of this CTA's
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t slice = ring + P::L::BYTES;
  const uint32_t bar0 = slice + P::A_BYTES;
  const fat::Tile at = fat::tile_smem<CP>(ring, bar0);
  const uint32_t b_full = bar0 + 8 * P::L::BARS, stage_empty = b_full + 8 * NS,
                 a_full = stage_empty + 8 * NS, may_push = a_full + 8 * P::MAX_T,
                 res_full = may_push + 8 * P::MAX_T, region_free = res_full + 8;

  // a persistent grid of clusters walks the (image, query block) tiles,
  // an image's blocks next to each other
  const int CL = cluster_nctarank(), rank = cluster_ctarank();
  const int nq = (SP + BQ - 1) / BQ, tiles = B * nq, clusters = gridDim.x / CL;
  const int col0 = rank * NC;  // this CTA's output columns
  const int T = CL * P::NSUB;  // chunks a tile
  // stage s takes chunks s, s + NS, ... of every tile: uses(s) a tile
  auto uses = [&](int s) { return s < T ? (T - s + NS - 1) / NS : 0; };
  if (threadIdx.x == 0) {
    fat::init_tile_barriers(at);
    for (int s = 0; s < NS; ++s) {
      mbar_init(b_full + 8 * s, 1);       // the producer's expect_tx arrival
      mbar_init(stage_empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    // one each a chunk, used once a tile: the pushing peer's expect_tx
    // arrival, and the receiving peer's consumer warpgroups' arrivals
    for (int t = 0; t < P::MAX_T; ++t) {
      mbar_init(a_full + 8 * t, 1);
      mbar_init(may_push + 8 * t, 2);
    }
    mbar_init(res_full, 1);     // the producer's expect_tx arrival
    mbar_init(region_free, 2);  // each consumer warpgroup, its stores read
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each tile passes two cluster barriers: A, every slice written (then
  // the pushes may start), and E, every chunk consumed (then a slice may
  // be written again); a thread arrives at E and waits for it only when
  // it next needs it. The attention of tile i + 1 loads into the ring
  // once this CTA is done with tile i (region_free), under barrier E.
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // producer: one thread issues every load, another every push
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    int n = 0;  // key tiles loaded
    for (int tile = cluster_id_x(), it = 0; tile < tiles; tile += clusters, ++it) {
      const int b = tile / nq, qb = tile % nq;
      if (threadIdx.x == 256) {
        if (it > 0) mbar_wait(region_free, (it - 1) & 1);
        for (int i = 0; i < 2; ++i)
          fat::load_tile<CP>(at, &tq, &tk, &tv, b, (2 * rank + i) * CP, qb, nq, 2 * it + i, n);
      }
      if (it > 0) cluster_wait();  // E of the last tile
      cluster_arrive();            // A
      cluster_wait();
      if (threadIdx.x == 256) {
        // the ring: chunk t (slabs [SUB sub, SUB sub + SUB) of peer src's
        // slice, src = rank + t / NSUB) goes to stage t % NS once chunk
        // t - NS has left it (the last tile's chunks all have); its Wo
        // rows by TMA
        for (int t = 0; t < T; ++t) {
          const int st = t % NS, src = (rank + t / P::NSUB) % CL, sub = t % P::NSUB;
          const uint32_t b_st = ring + st * P::STAGE + P::A_CHUNK;
          if (t >= NS) mbar_wait(stage_empty + 8 * st, (it * uses(st) + t / NS - 1) & 1);
          mbar_expect_tx(b_full + 8 * st, P::B_CHUNK);
          const int row = src * W + P::KC * sub;
#pragma unroll
          for (int w = 0; w < P::NW; ++w)
            tma_load(b_st + w * P::B_WBOX, &two_wide, col0 + 64 * w, row, b_full + 8 * st);
#pragma unroll
          for (int sl = 0; sl < P::NN; ++sl)
            tma_load(b_st + P::NW * P::B_WBOX + sl * P::B_SLAB, &two_narrow,
                     col0 + 64 * P::NW + 16 * sl, row, b_full + 8 * st);
        }
        // res into the output staging once the last chunks of the stages
        // under it have left them
        for (int s = 0; s < P::RES_STAGES && s < T; ++s)
          mbar_wait(stage_empty + 8 * s, ((it + 1) * uses(s) - 1) & 1);
        mbar_expect_tx(res_full, P::STAGING);
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int sl = 0; sl < NC / 16; ++sl)
            tma_load(ring + (h * (NC / 16) + sl) * P::OUT_SLAB, &tres, col0 + 16 * sl,
                     qb * BQ + 64 * h, b, res_full);
      } else if (threadIdx.x == 288) {
        // the pushes: this CTA's slice is chunk t of peer dst = rank - t /
        // NSUB for t past the first NSUB (the peer's own); each goes once
        // dst has said its stage is free
        for (int t = P::NSUB; t < T; ++t) {
          const int st = t % NS, dst = (rank + CL - t / P::NSUB) % CL, sub = t % P::NSUB;
          if (t >= NS) mbar_wait(may_push + 8 * t, it & 1);
          const uint32_t bar = peer_addr(a_full + 8 * t, dst), to = peer_addr(ring + st * P::STAGE, dst);
          mbar_expect_tx_peer(bar, P::A_CHUNK);
          bulk_copy_to_peer(to, slice + sub * P::A_CHUNK, P::A_CHUNK, bar);
        }
      }
      cluster_arrive();  // E
    }
  } else {
    // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const bool leader = tid == 0;
    // chunk d's products are done: its stage is free, and the peer that
    // pushes chunk d + NS into it may
    auto release = [&](int d) {
      if (leader) {
        mbar_arrive(stage_empty + 8 * (d % NS));
        const int c = d + NS;
        if (c < T) mbar_arrive_peer(peer_addr(may_push + 8 * c, (rank + c / P::NSUB) % CL));
      }
    };
    int n = 0;  // key tiles consumed
    for (int tile = cluster_id_x(), it = 0; tile < tiles; tile += clusters, ++it) {
      const int b = tile / nq, qb = tile % nq;
      if (wg == 1) bar_arrive<256>(1);  // warpgroup 0 goes first
      for (int i = 0; i < 2; ++i) {
        float o[CP / 2], l[2];
        fat::attend_tile<CP, false>(at, o, l, 2 * it + i, n, nq, SP, D, wg);
        if (i == 0 && it > 0) cluster_wait();  // E of the last tile: the slice is free
        // O / l of head 2 rank + i into slice columns [i DP, i DP + DP):
        // columns past D are 0 (Wo's pad rows)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wg * 64 + warp * 16 + g + 8 * hh;
          const float inv_l = 1.0f / l[hh];
#pragma unroll
          for (int j = 0; j < CP / 8; ++j) {
            const int c = 8 * j + 2 * q, cs = i * P::DP + c;
            if (c < P::DP) {
              const float v0 = c < D ? o[4 * j + 2 * hh] * inv_l : 0.f;
              const float v1 = c + 1 < D ? o[4 * j + 2 * hh + 1] * inv_l : 0.f;
              sts_u32(swz32(slice + (cs >> 4) * P::A_SLAB, r, cs & 15), fat::pack_bf16(v0, v1));
            }
          }
        }
      }
      if (wg == 0) bar_sync<256>(1);  // warpgroup 1's last opening of it
      fence_proxy_async();            // the slice, for the wgmmas and the pushes

      // the accumulators start as bo: thread (g, q) of warp w holds rows
      // 16 w + g (+ 8) and columns 8 j + 2 q (+ 1) of the warpgroup's tile
      float acc[NC / 2];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = col0 + 8 * j + 2 * q;  // DM % 8 == 0: col < DM covers col + 1
        float2 bias = make_float2(0.f, 0.f);
        if (col < DM)
          bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bo + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          acc[4 * j + 2 * hh] = bias.x;
          acc[4 * j + 2 * hh + 1] = bias.y;
        }
      }
      cluster_arrive();  // A
      cluster_wait();

      // acc += A_t Wo[K_t, col0 : col0 + NC] over the chunks t of the
      // ring's producer (the first NSUB from this CTA's slice, in place);
      // a chunk is released once the next one is issued (more in flight
      // ran slower)
      for (int t = 0; t < T; ++t) {
        const int st = t % NS;
        const uint32_t a_st = ring + st * P::STAGE, b_st = a_st + P::A_CHUNK;
        mbar_wait(b_full + 8 * st, (it * uses(st) + t / NS) & 1);
        uint32_t a = slice + t * P::A_CHUNK;  // t < NSUB
        if (t >= P::NSUB) {
          mbar_wait(a_full + 8 * t, it & 1);
          a = a_st;
        }
        const uint64_t da = fat::kmajor_desc(a + wg * 64 * 32);
        const uint64_t dbw = smem_desc(b_st, P::B_WBOX, 1024);
        const uint64_t dbn = smem_desc(b_st + P::NW * P::B_WBOX, P::B_SLAB, 256, SWIZZLE_32B);
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < P::SUB; ++kk) {
          const uint64_t dak = da + kk * (P::A_SLAB >> 4);
          if constexpr (P::NW > 0) Mma<64 * P::NW, 1>::ss(acc, dak, dbw + kk * (2048 >> 4));
          if constexpr (P::NN > 0)
            Mma<16 * P::NN, 1>::ss(acc + 32 * P::NW, dak, dbn + kk * (512 >> 4));
        }
        wgmma_commit();
        if (t > 0) {
          wgmma_wait<1>();
          release(t - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) fence_operand(acc[i]);
      release(T - 1);
      cluster_arrive();  // E: every chunk of this CTA consumed

      // epilogue: the staging holds this warpgroup's res in NC / 16 slabs
      // of 64 rows; each thread adds its own words in place, then TMA
      // stores; once they have read the staging the ring is free
      mbar_wait(res_full, it & 1);
      const uint32_t stage = ring + wg * (NC / 16) * P::OUT_SLAB;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = warp * 16 + g + 8 * hh, c = 8 * j + 2 * q;
          const uint32_t addr = swz32(stage + (c >> 4) * P::OUT_SLAB, r, c & 15);
          const float2 r2 = __bfloat1622float2(u32_as_bf2(lds_u32(addr)));
          sts_u32(addr,
                  fat::pack_bf16(acc[4 * j + 2 * hh] + r2.x, acc[4 * j + 2 * hh + 1] + r2.y));
        }
      fence_proxy_async();
      bar_sync<128>(4 + wg);
      if (leader) {
#pragma unroll
        for (int sl = 0; sl < NC / 16; ++sl)
          tma_store(&tout, stage + sl * P::OUT_SLAB, col0 + 16 * sl, qb * BQ + wg * 64, b);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(region_free);
      }
    }
  }
  // the last E: no CTA exits while a peer may still copy into it
  if (static_cast<int>(cluster_id_x()) < tiles) cluster_wait();
}

// the cluster size of a geometry, or 0 if the kernel does not take it
template <int CP>
int cluster_size(int H, int D, int DM) {
  const int cl = H / 2;
  if (H % 2 || cl < 1 || cl > MAX_CLUSTER || D >= CP || (D + 7) / 8 * 8 != Geom<CP>::DP ||
      DM % 8 || round_up((DM + cl - 1) / cl, 16) != Geom<CP>::NC)
    return 0;
  return cl;
}

template <int CP>
cudaLaunchConfig_t launch_config(int clusters, int cl, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * cl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Proj<CP>::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CP>
int occupancy(int H, int D, int DM, int* cluster, int* clusters);

template <int CP>
int launch(const void* qkvf, const void* wo, const void* bo, const void* res, void* out, int B,
           int SP, int H, int D, int DM, cudaStream_t stream) {
  using P = Proj<CP>;
  static_assert(P::SMEM <= fat::SMEM_LIMIT, "shared memory");
  const int cl = cluster_size<CP>(H, D, DM);
  if (!cl) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || SP == 0) return 0;
  CUtensorMap tq, tk, tv, two_wide, two_narrow, tres, tout;
  const long long row = 3LL * H * CP, batch = row * SP;
  const char* base = static_cast<const char*>(qkvf);
  if (int e = fat::make_map(&tq, base, B, SP, H * CP, row, batch)) return e;
  if (int e = fat::make_map(&tk, base + 2LL * H * CP, B, SP, H * CP, row, batch)) return e;
  if (int e = fat::make_map(&tv, base + 4LL * H * CP, B, SP, H * CP, row, batch)) return e;
  {  // Wo (H DP rows, DM columns): boxes of a k-chunk's KC rows x 64 or 16 columns
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(DM), static_cast<cuuint64_t>(H * P::DP)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(DM) * 2};
    const cuuint32_t wide[2] = {64, static_cast<cuuint32_t>(P::KC)};
    const cuuint32_t narrow[2] = {16, static_cast<cuuint32_t>(P::KC)};
    if (int e = tensor_map(&two_wide, wo, 2, dims, strides, wide, CU_TENSOR_MAP_SWIZZLE_128B))
      return e;
    if (int e = tensor_map(&two_narrow, wo, 2, dims, strides, narrow, CU_TENSOR_MAP_SWIZZLE_32B))
      return e;
  }
  {  // res and out (B, SP, DM): boxes of a warpgroup's 64 rows x 16 columns
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DM), static_cast<cuuint64_t>(SP),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DM) * 2,
                                   static_cast<cuuint64_t>(DM) * SP * 2};
    const cuuint32_t box[3] = {16, 64, 1};
    if (int e = tensor_map(&tres, res, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B)) return e;
    if (int e = tensor_map(&tout, out, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B)) return e;
  }
  // as many clusters as the card holds at once (each then takes every
  // clusters-th tile), or one per tile
  static int resident[MAX_CLUSTER + 1] = {};  // by cluster size
  if (!resident[cl]) {
    int c = 0;
    if (int e = occupancy<CP>(H, D, DM, &c, &resident[cl])) return e;
    if (resident[cl] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int tiles = B * ((SP + BQ - 1) / BQ);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<CP>(tiles < resident[cl] ? tiles : resident[cl], cl, stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, fat_attention_proj_kernel<CP>, tq, tk, tv, two_wide,
                                       two_narrow, tres, tout, static_cast<const bf16*>(bo), B, SP,
                                       D, DM);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int CP>
int occupancy(int H, int D, int DM, int* cluster, int* clusters) {
  const int cl = cluster_size<CP>(H, D, DM);
  if (!cl) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fat_attention_proj_kernel<CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Proj<CP>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<CP>(1, cl, nullptr, &attr);
  *cluster = cl;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, fat_attention_proj_kernel<CP>, &cfg));
}

}  // namespace

extern "C" {

// out(B, SP, DM) = res + attention(qkvf) @ wo + bo, bf16, from a contiguous
// packed (B, SP, 3*H*C) qkvf, wo (H*DP, DM), bo (DM,) and res (B, SP, DM),
// DP = D rounded up to 8 (wo's rows h*DP + D .. h*DP + DP - 1 zero).
// Needs C equal to 80 (SO400M, D = 72), 32 (D = 16) or 16 (D <= 8) (the
// wrapper pads the tiny test configs' fat widths 24 and 8 to those), H
// even and at most 16 (a cluster of H / 2 CTAs, two heads each), DM a
// multiple of 8 with DM / (H / 2) rounded up to 16 equal to 144, 32 or 16
// respectively, and 16-byte aligned operands.
int mse_fat_attention_proj(const void* qkvf, const void* wo, const void* bo,
                           const void* res, void* out, int B, int SP, int H, int C,
                           int D, int DM, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 80:
      return launch<80>(qkvf, wo, bo, res, out, B, SP, H, D, DM, s);
    case 32:
      return launch<32>(qkvf, wo, bo, res, out, B, SP, H, D, DM, s);
    case 16:
      return launch<16>(qkvf, wo, bo, res, out, B, SP, H, D, DM, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the cluster size the kernel launches for a geometry and how many such
// clusters the card holds at once (cudaOccupancyMaxActiveClusters)
int mse_fat_attention_proj_occupancy(int H, int C, int D, int DM, int* cluster, int* clusters) {
  switch (C) {
    case 80:
      return occupancy<80>(H, D, DM, cluster, clusters);
    case 32:
      return occupancy<32>(H, D, DM, cluster, clusters);
    case 16:
      return occupancy<16>(H, D, DM, cluster, clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
