// GEMM kernels with a fused LayerNorm prologue and bias / gelu / residual /
// key-mask epilogues, for the SigLIP image tower on Hopper (sm_90a).
//
// Replaces the TPU kernels
//   meme_search_engine_tpu/ops/fused.py:ln_matmul        (_ln_mm_kernel)
//   meme_search_engine_tpu/ops/fused.py:matmul_residual  (_mm_res_kernel)
// and, as two launches, the two variants of
//   meme_search_engine_tpu/ops/fused.py:ln_mlp_residual  (_ln_mlp_res_kernel,
//                                                          _ln_mlp_kernel).
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at the image
// tower's shapes (M = B*736 rows, K = 1152 or 4352, N = 1152..4352) every
// call does hundreds of operations per byte moved, so all of them are
// bound by tensor-core operations, not bytes, and only wgmma reaches the
// tensor cores' full rate.
//
// Design: a persistent, warp-specialised kernel of three warpgroups, one
// CTA per SM walking 128 x BN output tiles (BN 128, 192 or 256: without
// LN the widest that wastes few of N's columns, with LN the fewest tiles,
// see pick_bn). Warpgroup 2 produces: one of its threads
// keeps a ring of three or four stages full with TMA loads, a 128 x 64 tile
// of A (K-major) and a 64 x BN tile of W (N-major, BN/64 boxes), both
// 128-byte swizzled, each stage guarded by a full and an empty mbarrier.
// Warpgroups 0 and 1 consume, each owning 64 rows of the tile with fp32
// accumulators in registers; both operands reach wgmma from shared memory
// (the SS form), W as an MN-major B operand. One stage's products stay in
// flight while the next stage's are issued.
//
// With LN (ln_matmul), the producer warpgroup's other three warps normalise
// each A stage once, in place, before the consumers read it: each thread
// takes 8 columns of 10 or 11 rows, reads them from the swizzled stage,
// computes (x - mu) * rs * g + b in fp32, rounds to bf16 and writes them
// back where they were, then the warps fence the stage for the async proxy
// and arrive on its third barrier, "normalised", which the consumers wait
// on instead of "full". The rows' (mu, 1/sigma) come from a one-warp-per-row
// pre-pass and are staged in shared memory a tile at a time, gamma and beta
// once a launch. So the normalised activations never reach device memory,
// the consumers hold no A fragments, and LN tiles can be 256 wide.
// The normalising sets the pace (at K = 1152 it takes about 1.3 times a
// stage's products), so the consumers sleep while they wait for it, and the
// warpgroups keep the block's 168 registers a thread: ptxas holds the
// consumers' code to that count, and the normalising warps use the rest.
//
// The epilogue works from the accumulators: bias in fp32, then ln_matmul's
// optional tanh-gelu and packed-QKV key mask, or matmul_residual's residual
// (loaded by TMA into shared memory while the products run), one rounding
// to bf16, then the tile goes through 128-byte-swizzled shared memory to
// TMA stores, which run on while the next tile's products do. TMA fills
// out-of-bounds loads with zeros and clips out-of-bounds stores, which
// covers ragged M, N and K (gamma and beta are staged as zero past K, so
// the normalised stage stays zero there).
//
// Numerics follow the reference: LN statistics in fp32, LN output rounded
// to bf16 before the MMA (fused.py:39-41), fp32 accumulation, bias (and
// residual) added in fp32, one rounding to bf16.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BK = 64, NT = 384, MAX_STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;  // one stage of A: 128 rows of 128 B
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory a block can use
constexpr int BAR_BYTES = 3 * MAX_STAGES * 8 + 16;  // full, empty, normalised, two residual

struct Epilogue {
  const bf16* bias;  // (N,)
  const bf16* res;   // (M, N), matmul_residual only
  int act;           // 0: none, 1: tanh-gelu
  // packed fat-QKV key mask: rows with (row % sp) >= n get, in columns
  // [hc, 2hc), 0 everywhere except -1e30 where (col - hc) % c == d; n is
  // lens[row / sp], each sequence's own valid length, or n_valid for every
  // sequence where lens is null
  int n_valid, sp, hc, c, d;  // c == 0: no mask
  const int* lens;            // (M / sp,) or null
};

// whether row r is a pad row of its sequence under the key mask
__device__ __forceinline__ bool masked_row(const Epilogue& epi, int r, int M) {
  if (epi.c == 0 || r >= M) return false;
  return r % epi.sp >= (epi.lens ? __ldg(epi.lens + r / epi.sp) : epi.n_valid);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 0.5 x (1 + tanh(u)) written as x * sigmoid(2u), u = sqrt(2/pi) (x +
// 0.044715 x^3): one exponential; the limits are exact (x -> -inf gives
// -0, x -> inf gives x)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
  return __fdividef(x, 1.0f + __expf(-2.0f * k0 * (x + 0.044715f * x * x * x)));
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// fp32 LayerNorm statistics (mean, 1/sqrt(var + 1e-6)) of each row of
// x(M, K), one warp per row, two passes (mean, then centred variance).
// Computed once here rather than in every CTA of a row block: with
// N / BN tiles per row block, recomputing them re-read x up to 34 times.
__global__ void __launch_bounds__(256)
ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int M, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  float s = 0.f;
  for (int c = lane; c < K / 8; c += 32) {
    Pack8 p;
    p.u = xr[c];
#pragma unroll
    for (int t = 0; t < 8; ++t) s += __bfloat162float(p.h[t]);
  }
  const float mu = warp_sum(s) / K;
  float v = 0.f;
  for (int c = lane; c < K / 8; c += 32) {
    Pack8 p;
    p.u = xr[c];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float d = __bfloat162float(p.h[t]) - mu;
      v += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(v) / K + 1e-6f);
  if (lane == 0) stats[row] = make_float2(mu, rs);
}

// LayerNorm of two bf16 values of one row: (x - mu) * rs * g + b in fp32,
// rounded to bf16; st = (mu, rs)
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float2 st, float g0, float b0, float g1,
                                            float b1) {
  const float x0 = __uint_as_float(v << 16), x1 = __uint_as_float(v & 0xffff0000u);
  return bf2_as_u32(__floats2bfloat162_rn((x0 - st.x) * st.y * g0 + b0, (x1 - st.x) * st.y * g1 + b1));
}

// normalises, in place, one 16-byte chunk (8 columns) of each of the rows
// r0 + 12 j (j = 0, 1, ...) below BM of an A stage, every row's load first,
// then the arithmetic, so that the loads' latency is paid once. The
// 128-byte swizzle puts chunk c of row r at chunk c ^ (r % 8), and r % 8
// alternates between two values from one of these rows to the next, so row
// j's chunk lies at even (j even) or odd (j odd) + 1536 j bytes. g, b: the
// chunk's gamma and beta; st: the rows' (mu, rs), 12 apart; eleven: whether
// row 10 is below BM
__device__ __forceinline__ void ln_chunk_rows(unsigned char* even, unsigned char* odd, bool eleven,
                                              const float2* st, const float (&g)[8],
                                              const float (&b)[8]) {
  uint4 w[11];
  float2 rs[11];
#pragma unroll
  for (int j = 0; j < 11; ++j) {
    if (j < 10 || eleven) {
      w[j] = *reinterpret_cast<const uint4*>((j & 1 ? odd : even) + 1536 * j);
      rs[j] = st[12 * j];
    }
  }
#pragma unroll
  for (int j = 0; j < 11; ++j) {
    if (j < 10 || eleven) {
      uint4 y;
      y.x = ln_pair(w[j].x, rs[j], g[0], b[0], g[1], b[1]);
      y.y = ln_pair(w[j].y, rs[j], g[2], b[2], g[3], b[3]);
      y.z = ln_pair(w[j].z, rs[j], g[4], b[4], g[5], b[5]);
      y.w = ln_pair(w[j].w, rs[j], g[6], b[6], g[7], b[7]);
      *reinterpret_cast<uint4*>((j & 1 ? odd : even) + 1536 * j) = y;
    }
  }
}

// mbar_wait for a thread that has nothing else to do meanwhile: each poll
// may suspend it for up to a microsecond, until the phase completes, so it
// takes no issue slots from the warps beside it on its SM sub-partition; a
// wait that never ends traps after 2^22 polls
__device__ __forceinline__ void mbar_sleep(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 22)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(1000)
        : "memory");
  } while (!done);
}

// The ring's position as a consumer walks it.
struct Ring {
  uint32_t s0, ready0, empty0;  // shared addresses: stage 0, the barriers the consumers
                                // wait on (full, or with LN normalised) and release
  int stages, stage, prev;      // prev: the stage whose products are still in flight
  uint32_t phase;

  // with LN the consumers sleep while they wait, and the normalising
  // warps beside them get their issue slots
  template <bool LN>
  __device__ __forceinline__ void wait_ready() const {
    if (LN)
      mbar_sleep(ready0 + 8 * stage, phase);
    else
      mbar_wait(ready0 + 8 * stage, phase);
  }
  // release the stage in flight (its products are done) and make the
  // current one the stage in flight
  __device__ __forceinline__ void release_prev(bool leader) {
    if (prev >= 0 && leader) mbar_arrive(empty0 + 8 * prev);
    prev = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int BN, bool LN>
__global__ void __launch_bounds__(NT, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
            const __grid_constant__ CUtensorMap tma_out,
            const __grid_constant__ CUtensorMap tma_res, const bf16* __restrict__ gamma,
            const bf16* __restrict__ beta, const float2* __restrict__ stats, int M, int N,
            int K, int stages, Epilogue epi) {
  constexpr int STAGE = A_BYTES + BK * BN * 2;  // A, then W as BN/64 boxes of 64 x 64
  constexpr int HALF = 64 * BN * 2;             // a consumer's 64 rows of the output tile
  extern __shared__ unsigned char smem_raw[];
  // shared memory: the ring's stages, the output tile, the barriers, then
  // with LN gamma and beta, and two tiles' row statistics (2 x BM float2).
  // Stages and the output tile start on 1024-byte
  // boundaries: the 128-byte swizzle repeats every 8 rows of 128 B, and
  // TMA and wgmma both read it from the address.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t s0 = raw + pad, out0 = s0 + stages * STAGE;
  const uint32_t full0 = out0 + 2 * HALF, empty0 = full0 + MAX_STAGES * 8,
                 normed0 = empty0 + MAX_STAGES * 8, res0 = normed0 + MAX_STAGES * 8;
  __nv_bfloat162* gb =  // (gamma, beta) of each k
      reinterpret_cast<__nv_bfloat162*>(smem_raw + pad + stages * STAGE + 2 * HALF + BAR_BYTES);

  const int KT = (K + BK - 1) / BK, tiles_n = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * tiles_n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 2);   // one arrival per consumer warpgroup
      mbar_init(normed0 + 8 * s, 3);  // one arrival per normalising warp
    }
    mbar_init(res0, 1);  // each consumer's residual rows
    mbar_init(res0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (LN) {
    for (int k = threadIdx.x; k < KT * BK; k += NT)
      gb[k] = k < K ? __halves2bfloat162(gamma[k], beta[k]) : __floats2bfloat162_rn(0.f, 0.f);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // without LN the producer gives its registers to the consumers; with
    // LN its normalising warps keep the block's 168 a thread (ptxas holds
    // the consumers' code to that count either way)
    if (!LN) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int t = threadIdx.x - 256;
    if (t == 0) {
      // producer: one thread issues every TMA load of the ring
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < KT; ++kt) {
          const uint32_t full = full0 + 8 * stage, sa = s0 + stage * STAGE;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, STAGE);
          tma_load(sa, &tma_a, kt * BK, m0, full);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(sa + A_BYTES + j * BK * 128, &tma_w, n0 + 64 * j, kt * BK, full);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (LN && t >= 32) {
      // normaliser: the other three warps. Thread u takes chunk u % 8 (8
      // columns) of rows u / 8 + 12 j of each A stage, so a quarter-warp
      // reads and writes one row's 8 chunks, which the swizzle puts in
      // distinct banks, and the chunk's gamma and beta are read once a
      // stage. Each tile's row statistics are staged in shared memory, so
      // that no load in the loop waits on L1 or L2; two buffers, since a
      // warp may start a tile while another still reads the last one's
      const int u = t - 32, c = u & 7, r0 = u >> 3;
      const int even = r0 * 128 + ((c ^ (r0 & 7)) << 4), odd = r0 * 128 + ((c ^ (r0 & 7) ^ 4) << 4);
      float2* const st_tiles = reinterpret_cast<float2*>(gb + KT * BK);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x, parity = 0; tile < tiles; tile += gridDim.x, parity ^= 1) {
        float2* const st = st_tiles + parity * BM;
        const int m0 = (tile / tiles_n) * BM;
        st[u] = m0 + u < M ? stats[m0 + u] : make_float2(0.f, 0.f);
        if (u + 96 < BM) st[u + 96] = m0 + u + 96 < M ? stats[m0 + u + 96] : make_float2(0.f, 0.f);
        bar_sync<96>(3);  // the tile's statistics are in; the tile before the last is done
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint4 lo = *reinterpret_cast<const uint4*>(gb + kt * BK + 8 * c);
          const uint4 hi = *reinterpret_cast<const uint4*>(gb + kt * BK + 8 * c + 4);
          const uint32_t gbw[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          float g[8], b[8];  // (gamma, beta) pairs in bf16: gamma low, beta high
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            g[e] = __uint_as_float(gbw[e] << 16);
            b[e] = __uint_as_float(gbw[e] & 0xffff0000u);
          }
          unsigned char* const a = smem_raw + pad + stage * STAGE;
          ln_chunk_rows(a + even, a + odd, r0 < 8, st + r0, g, b);
          fence_proxy_async();  // the consumers' wgmma reads the stage through the async proxy
          __syncwarp();
          if ((t & 31) == 0) mbar_arrive(normed0 + 8 * stage);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
    if (!LN) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const bool leader = tid == 0;
    // this consumer's half of the output tile: BN/64 boxes of 64 rows of
    // 128 B, 128-byte swizzled like the operands, so that the fragment
    // stores below hit 32 distinct banks
    const uint32_t half = out0 + wg * HALF, res_bar = res0 + 8 * wg;
    uint32_t res_phase = 0;
    Ring ring{s0, LN ? normed0 : full0, empty0, stages, 0, -1, 0};
    float acc[BN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      const int mh = m0 + wg * 64;                     // the first row of this consumer's half
      const int row0 = mh + warp * 16 + g;             // this thread's rows: row0, row0 + 8
      if (!LN && leader) {
        // the residual rows come in by TMA while the products run, into
        // the output tile once its last store has read it
        bulk_wait_read();
        mbar_expect_tx(res_bar, HALF);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) tma_load(half + j * 8192, &tma_res, n0 + 64 * j, mh, res_bar);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0.f;
        fence_operand(acc[i]);
      }
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t sa = s0 + ring.stage * STAGE;
        ring.wait_ready<LN>();
        const uint64_t da = smem_desc(sa + wg * 64 * 128, 16, 1024);
        const uint64_t db = smem_desc(sa + A_BYTES, BK * 128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<BN>::ss(acc, da + kk * (32 >> 4), db + kk * (16 * 128 >> 4));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        ring.release_prev(leader);
      }
      // the last stage's products
      wgmma_wait<0>();
      if (ring.prev >= 0 && leader) mbar_arrive(empty0 + 8 * ring.prev);
      ring.prev = -1;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);

      // epilogue from the accumulators: bias, gelu, residual, key mask,
      // then the tile through shared memory to one TMA store per box,
      // which clips rows past M and columns past N and runs on while the
      // next tile's products do
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        if (col >= N) continue;  // N % 8 == 0, so col + 1 < N too
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(epi.bias + col);
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[4 * j + t] += (t & 1) ? __high2float(b2) : __low2float(b2);
      }
      if (LN && epi.act == 1) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = gelu_tanh(acc[i]);
      }
      if constexpr (!LN) {
        mbar_wait(res_bar, res_phase);
        res_phase ^= 1;
      } else {
        if (leader) bulk_wait_read();  // the last tile's store has read the buffer
        bar_sync<128>(1 + wg);
      }
      bool pad_row[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        pad_row[hh] = LN && masked_row(epi, row0 + 8 * hh, M);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = warp * 16 + g + 8 * hh;  // row within the half; r % 8 == g
          const uint32_t addr = half + (j / 8) * 8192 + r * 128 + (((j % 8) ^ g) << 4) + 4 * q;
          float v[2] = {acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]};
          if constexpr (!LN) {
            const __nv_bfloat162 r2 = u32_as_bf2(lds_u32(addr));
            v[0] += __low2float(r2);
            v[1] += __high2float(r2);
          }
          if (pad_row[hh]) {
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const int cc = n0 + 8 * j + 2 * q + t;
              if (cc >= epi.hc && cc < 2 * epi.hc)
                v[t] = ((cc - epi.hc) % epi.c == epi.d) ? -1e30f : 0.f;
            }
          }
          sts_u32(addr, bf2_as_u32(__floats2bfloat162_rn(v[0], v[1])));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync<128>(1 + wg);
      if (leader) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) tma_store(&tma_out, half + j * 8192, n0 + 64 * j, mh);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// -- host side ----------------------------------------------------------------

// a map over a row-major (rows, cols) bf16 array whose boxes are box_rows
// rows of 64 columns (128 B), 128-byte swizzled; out-of-bounds reads give 0
int make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Without LN, the widest tile that wastes at most 1/32 of N's columns,
// else the one that wastes the fewest (the widest on a tie). With LN each
// tile normalises its A stages anew, and that sets the pace at every
// width, so the fewest tiles across N win, wasted columns or not: the
// narrowest width that gives as few as 256 does.
int pick_bn(int N, bool ln) {
  const int widths[3] = {256, 192, 128};
  if (ln) {
    int best = 256;
    for (int bn : widths)
      if ((N + bn - 1) / bn == (N + 255) / 256) best = bn;
    return best;
  }
  int best = 128, waste = 1 << 30;
  for (int bn : widths) {
    const int w = (bn - N % bn) % bn;
    if (32 * w <= N) return bn;
    if (w < waste) best = bn, waste = w;
  }
  return best;
}

template <int BN, bool LN>
int run(const CUtensorMap& ta, const CUtensorMap& tw, const bf16* g, const bf16* b,
        const float2* stats, bf16* out, int M, int N, int K, const Epilogue& epi,
        cudaStream_t stream) {
  constexpr int STAGE = A_BYTES + BK * BN * 2;
  // the output (and residual) in boxes of 64 rows of 64 columns
  CUtensorMap to, tr;
  if (int e = make_map(&to, out, M, N, 64)) return e;
  if (int e = make_map(&tr, epi.res ? static_cast<const void*>(epi.res) : out, M, N, 64))
    return e;
  const int extra = 1024 + BM * BN * 2 + BAR_BYTES + (LN ? (K + BK - 1) / BK * BK * 4 + 2 * BM * 8 : 0);
  int stages = (SMEM_LIMIT - extra) / STAGE;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = stages * STAGE + extra;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BN, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  gemm_kernel<BN, LN><<<tiles < sms ? tiles : sms, NT, smem, stream>>>(
      ta, tw, to, tr, g, b, stats, M, N, K, stages, epi);
  return static_cast<int>(cudaGetLastError());
}

template <bool LN>
int launch(const bf16* a, const bf16* g, const bf16* b, float2* stats, const bf16* w,
           bf16* out, int M, int N, int K, const Epilogue& epi, cudaStream_t stream) {
  if (M == 0 || N == 0) return 0;
  if (LN) {
    ln_stats_kernel<<<(M + 7) / 8, 256, 0, stream>>>(a, stats, M, K);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // activations change address on every call, so the maps are made here
  CUtensorMap ta, tw;
  if (int e = make_map(&ta, a, M, K, BM)) return e;
  if (int e = make_map(&tw, w, K, N, BK)) return e;
  const int bn = pick_bn(N, LN);
  if (bn == 128) return run<128, LN>(ta, tw, g, b, stats, out, M, N, K, epi, stream);
  if (bn == 192) return run<192, LN>(ta, tw, g, b, stats, out, M, N, K, epi, stream);
  return run<256, LN>(ta, tw, g, b, stats, out, M, N, K, epi, stream);
}

}  // namespace

extern "C" {

// out(M,N) = act(LN(x)(M,K) @ w(K,N) + bias) with the optional key mask.
// Needs K % 8 == 0, N % 8 == 0 and 16-byte aligned, contiguous operands.
// `stats` is (M,) float2 scratch for the row statistics. `lens`: null, or
// the (M / sp,) int32 valid lengths of the sequences, in place of n_valid.
int mse_ln_matmul(const void* x, const void* g, const void* b, const void* w,
                  const void* bias, void* out, void* stats, int M, int N, int K, int act,
                  int n_valid, int sp, int hc, int c, int d, const void* lens, void* stream) {
  Epilogue epi{static_cast<const bf16*>(bias), nullptr, act, n_valid, sp, hc, c, d,
               static_cast<const int*>(lens)};
  return launch<true>(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                      static_cast<const bf16*>(b), static_cast<float2*>(stats),
                      static_cast<const bf16*>(w), static_cast<bf16*>(out), M, N, K, epi,
                      static_cast<cudaStream_t>(stream));
}

// out(M,N) = res(M,N) + x(M,K) @ w(K,N) + bias.
int mse_matmul_residual(const void* x, const void* w, const void* bias,
                        const void* res, void* out, int M, int N, int K,
                        void* stream) {
  Epilogue epi{static_cast<const bf16*>(bias), static_cast<const bf16*>(res), 0,
               0, 1, 0, 0, 0, nullptr};
  return launch<false>(static_cast<const bf16*>(x), nullptr, nullptr, nullptr,
                       static_cast<const bf16*>(w), static_cast<bf16*>(out), M, N, K,
                       epi, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
