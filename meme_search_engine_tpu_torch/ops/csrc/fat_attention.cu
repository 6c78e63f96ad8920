// Fat-layout ViT self-attention for the SigLIP image tower on Hopper (sm_90a).
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/attention.py:_fat_vit_kernel
// behind both fat_vit_mha (separate q/k/v arrays) and fat_vit_mha_packed
// (one packed [q | k | v] array): the host encodes one TMA map per operand
// from a base pointer, a row stride (3*H*C packed, H*C unpacked) and a
// batch stride, and the head's columns start at h*C in each, so one
// kernel serves both.
//
// What it computes (attention.py:270-292): per head, S = Q.K^T in fp32
// (q pre-scaled, the constant column masks pad keys with -1e30), P =
// exp(S - rowmax) rounded to bf16, O = P.V in fp32, l = O[:, D] (v's ones
// column), out = O[:, :D] / l in bf16. The softmax is online: K and V of
// one head (235 KB at SO400M) do not fit a block's shared memory, so the
// row max runs along the key tiles and O is rescaled when it grows.
//
// Bound on an H100 SXM at B=128, SP=736, H=16, C=80, D=72: 339 GFLOP of
// products (Q.K^T over C columns, P.V over the D + 1 that the output
// reads; 0.34 ms at 989 TFLOP/s; the kernel computes P.V over all CP
// columns, 355 GFLOP), 1.11e9 exponentials (0.27 ms at 16 a clock on each
// of 132 SMs at 1.98 GHz), 941 MB in and out (0.28 ms).
// The products bind, the exponentials close behind: the design keeps
// both units busy at once.
//
// Design (FlashAttention-3's shape). A persistent CTA per SM of three
// warpgroups walks (image, head, 128-query block) tiles, the six query
// blocks of one (image, head) next to each other in the order, so they
// run together and read that head's K and V from L2 once between them
// rather than twelve times as 64-row blocks did.
// - Warpgroup 2 produces: one of its threads issues every TMA load: a
//   tile's Q (128 rows) into one of two buffers, and 128-key tiles of K
//   and V into two rings of three stages, each buffer and stage with a
//   full and an empty mbarrier.
// - Warpgroups 0 and 1 consume, 64 query rows each. S = Q.K^T is an SS
//   wgmma m64n128k16, K-major for both operands, CP/16 k-steps. The S
//   accumulators become P's bf16 A-operand registers directly (the
//   accumulator layout of m64nN is the register A layout of the next
//   product), and O += P.V is an RS wgmma m64nCPk16 over 8 k-steps with V
//   MN-major in shared memory (the transpose bit).
// - Registers. A consumer keeps S (64), P (32) and O (40) in registers,
//   within the 168 a thread of a 384-thread block starts with. The
//   warpgroups ask setmaxnreg for 40 and 232, but ptxas allocated no
//   consumer more than 168 here: layouts that need more spilled alike with
//   24 / 240, with no setmaxnreg, and with a producer warp in place of a
//   warpgroup (288 threads still put three warps on one SM sub-partition,
//   so 168 stays the most a thread can have).
// - The exponentials run under the products. Two named barriers hand the
//   tensor cores back and forth between the warpgroups (ping-pong), so
//   one warpgroup's softmax runs while the other's products do. Within a
//   warpgroup, tile j's Q.K^T and tile j-1's P.V are issued together, in
//   one turn; ptxas makes each wgmma wait for the last (below). log2(e) is
//   folded into one FFMA a score ahead of ex2.approx: its error (2 ulp of
//   fp32) is far below the bf16 rounding of P that follows.
//
// Where it is delicate:
// - 160-byte head rows. C = 80 is not a multiple of 64 elements, so the
//   128-byte swizzle does not tile a head. Every operand is cut into
//   CP/16 slabs 16 columns (32 bytes) wide, one TMA box each, 32-byte
//   swizzled. K-major (Q, K): a k-step is one slab, the stride byte offset
//   between 8-row groups 256 B. MN-major (V): the slabs are the swizzle
//   atoms along N (leading byte offset: one slab, BKV * 32 B), 8 keys per
//   256 B along K, and a k-step of 16 keys advances 512 B.
// - The tiny widths. fat_width(7) = 8 and fat_width(16) = 24 are not
//   multiples of 16; a 16-column box at h*C would read the next head's
//   columns. The wrapper (ops/attention.py) copies those geometries to a
//   zero-padded layout of width CP first, so this kernel sees C = CP.
// - The ragged key tail (736 = 5*128 + 96). The maps are 3-D (columns,
//   rows, images): a box past row SP reads zeros, not the next image,
//   and the scores of those keys are set to -inf here. Pad rows 729-735
//   carry -1e30 in k's constant column; -1e30 * log2(e) is finite and
//   ex2.approx of it is 0. Query rows past SP are computed from zeros and
//   not stored.
// - The output. Rows of H*D bf16 with each head at h*D: 144 bytes at a
//   144-byte offset at SO400M, 14 bytes at D = 7, which TMA cannot store.
//   Each thread stores its own pairs of columns from registers.
// - Deadlock. A broken ring would hang the card: every mbarrier wait
//   traps after 2^26 polls (hopper.cuh), so it fails as a launch error.
// - Serialised wgmmas. P_j is computed while P_{j-1}.V still reads P's
//   registers; ptxas gives the two the same registers and then waits for
//   each wgmma before the next (C7513, "wgmma serialized due to non wgmma
//   instructions defining input registers"). Every order that cleared the
//   warning ran slower on an H100 SXM at 700 W (the fat attention bench,
//   B = 128, 1.04-1.07 ms for this one): the softmax after both products,
//   1.15 ms; FlashAttention-3's order (exponentials in place in S, P packed
//   once P.V is done), 1.63-1.73 ms at 128 keys a tile (spilling) and
//   1.10 / 1.13 ms at 96 / 64; and a 64 + 16 column split of each head
//   with a 128-byte swizzle on the 64 (twice the P.V wgmmas), 1.25 ms.
//   Neither the loads nor the exponentials bind: a build that skipped the
//   K/V loads after the first three tiles, and one without ex2, each timed
//   within 5% of this one.

#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 128, BKV = 128, NT = 384, STAGES = 3;
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf2_as_u32(__floats2bfloat162_rn(lo, hi));
}

template <int CP>
struct Layout {
  static constexpr int Q_BYTES = BQ * CP * 2, KV_BYTES = BKV * CP * 2;
  static constexpr int Q_SLAB = BQ * 32, KV_SLAB = BKV * 32;  // one 16-column slab
  static constexpr int BARS = 4 + 4 * STAGES;                  // q full/empty x2, k, v
  static constexpr int BYTES = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = 1024 + BYTES + 8 * BARS;         // 1024: alignment slack
};

// 8 k-steps of O(64 x CP) += P(64 x 128) V(128 x CP), V MN-major in its
// stage: slab j holds columns 16j..16j+15 of 128 keys, 32 bytes a key.
// dv: the descriptor of the stage (v_desc), computed ahead of the fence
template <int CP>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (&p)[8][4], uint64_t dv,
                                         uint32_t accumulate) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    Mma<CP, 1>::rs(o, p[kk], dv + kk * (512 >> 4), kk > 0 ? 1 : accumulate);
}

__device__ __forceinline__ uint64_t v_desc(uint32_t v) {
  return smem_desc(v, BKV * 32, 256, SWIZZLE_32B);
}

// CP/16 k-steps of S(64 x 128) = Q(64 x CP) K^T, both K-major, 32-byte
// swizzled slabs; dq, dk: the descriptors of slab 0 (kmajor_desc)
template <int CP>
__device__ __forceinline__ void issue_s(float* s, uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int sl = 0; sl < CP / 16; ++sl)
    Mma<BKV, 0>::ss(s, dq + sl * (Layout<CP>::Q_SLAB >> 4), dk + sl * (Layout<CP>::KV_SLAB >> 4),
                    sl > 0);
}

__device__ __forceinline__ uint64_t kmajor_desc(uint32_t a) {
  return smem_desc(a, 16, 256, SWIZZLE_32B);
}

// the online softmax of one score tile of this thread's two rows: keys at
// or past SP score -inf; the running row max m grows; p = the bf16 A
// fragments of exp(s - m) (the accumulator layout of S, m64n128, is the
// register A layout of the k-steps of P.V); corr = exp(m_old - m), the
// rescale factor of O (unused on the first tile). MASK: the tile reaches
// past SP (the last), and keys [0, lim) of this thread's columns in it
// are real. s is only read.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(const float (&s)[64], uint32_t (&p)[8][4],
                                             float (&m)[2], float (&corr)[2], int lim,
                                             bool first) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (!MASK || 8 * j + (t & 1) < lim) mx[t >> 1] = fmaxf(mx[t >> 1], s[4 * j + t]);
  float ml[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = first ? mx[hh] : fmaxf(m[hh], mx[hh]);
    corr[hh] = first ? 0.f : ex2((m[hh] - m_new) * LOG2E);
    m[hh] = m_new;
    ml[hh] = m_new * LOG2E;
  }
  // exp(s - m) = 2^(s log2e - m log2e): one FFMA and one ex2 a score
  float e[64];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      e[4 * j + t] =
          !MASK || 8 * j + (t & 1) < lim ? ex2(fmaf(s[4 * j + t], LOG2E, -ml[t >> 1])) : 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* en = e + 4 * (2 * kk + half);
      p[kk][2 * half] = pack_bf16(en[0], en[1]);
      p[kk][2 * half + 1] = pack_bf16(en[2], en[3]);
    }
}

// the softmax of the tile at key kbase, masked where it reaches past SP
__device__ __forceinline__ void softmax(const float (&s)[64], uint32_t (&p)[8][4], float (&m)[2],
                                        float (&corr)[2], int kbase, int SP, int q,
                                        bool first) {
  if (kbase + BKV > SP)
    softmax_tile<true>(s, p, m, corr, SP - kbase - 2 * q, first);
  else
    softmax_tile<false>(s, p, m, corr, 0, first);
}

template <int CP>
__global__ void __launch_bounds__(NT, 1)
fat_attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int B,
                     int SP, int H, int D) {
  using L = Layout<CP>;
  extern __shared__ unsigned char smem_raw[];
  // Q buffers, K stages, V stages (each on a 1024-byte boundary: the
  // 32-byte swizzle repeats every 256 B and TMA and wgmma both read it
  // from the address), then the barriers
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q0 = raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t k0 = q0 + 2 * L::Q_BYTES, v0 = k0 + STAGES * L::KV_BYTES;
  const uint32_t bar0 = v0 + STAGES * L::KV_BYTES;
  const uint32_t q_full = bar0, q_empty = bar0 + 16, k_full = bar0 + 32,
                 k_empty = k_full + 8 * STAGES, v_full = k_empty + 8 * STAGES,
                 v_empty = v_full + 8 * STAGES;

  const int nq = (SP + BQ - 1) / BQ, nkv = (SP + BKV - 1) / BKV, tiles = B * H * nq;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);   // the producer's expect_tx arrival
      mbar_init(q_empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int n = 0, it = 0;  // key tiles and query tiles loaded so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        const int bh = tile / nq, qb = tile % nq, b = bh / H, col = (bh % H) * CP;
        const int qi = it & 1;
        mbar_wait(q_empty + 8 * qi, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qi, L::Q_BYTES);
#pragma unroll
        for (int sl = 0; sl < CP / 16; ++sl)
          tma_load(q0 + qi * L::Q_BYTES + sl * L::Q_SLAB, &tq, col + 16 * sl, qb * BQ, b,
                   q_full + 8 * qi);
        for (int j = 0; j < nkv; ++j, ++n) {
          const int st = n % STAGES;
          const uint32_t ph = ((n / STAGES) & 1) ^ 1;
          mbar_wait(k_empty + 8 * st, ph);
          mbar_expect_tx(k_full + 8 * st, L::KV_BYTES);
#pragma unroll
          for (int sl = 0; sl < CP / 16; ++sl)
            tma_load(k0 + st * L::KV_BYTES + sl * L::KV_SLAB, &tk, col + 16 * sl, j * BKV, b,
                     k_full + 8 * st);
          mbar_wait(v_empty + 8 * st, ph);
          mbar_expect_tx(v_full + 8 * st, L::KV_BYTES);
#pragma unroll
          for (int sl = 0; sl < CP / 16; ++sl)
            tma_load(v0 + st * L::KV_BYTES + sl * L::KV_SLAB, &tv, col + 16 * sl, j * BKV, b,
                     v_full + 8 * st);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const bool leader = tid == 0;
    // the tensor cores' turn: named barrier 1 + w is warpgroup w's; each
    // waits for its own before it issues and then opens the other's
    const int mine = 1 + wg, other = 2 - wg;
    if (wg == 1) bar_arrive<256>(1);  // warpgroup 0 goes first

    int n = 0, it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int bh = tile / nq, qb = tile % nq, b = bh / H, h = bh % H;
      const int qi = it & 1;
      // this warpgroup's rows of the Q buffer
      const uint64_t dq = kmajor_desc(q0 + qi * L::Q_BYTES + wg * 64 * 32);
      float s[64], o[CP / 2], m[2], corr[2];
      uint32_t pc[8][4], pn[8][4];  // P of the tile in P.V, P of the next
      mbar_wait(q_full + 8 * qi, (it >> 1) & 1);

      // key tile 0: S, then its softmax
      int st = n % STAGES;
      uint64_t dk = kmajor_desc(k0 + st * L::KV_BYTES);
      mbar_wait(k_full + 8 * st, (n / STAGES) & 1);
      bar_sync<256>(mine);
      wgmma_fence();
      issue_s<CP>(s, dq, dk);
      wgmma_commit();
      bar_arrive<256>(other);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(s[i]);
      if (leader) {
        mbar_arrive(k_empty + 8 * st);
        if (nkv == 1) mbar_arrive(q_empty + 8 * qi);
      }
      softmax(s, pc, m, corr, 0, SP, q, true);

      // key tile j: S_j and P_{j-1}.V_{j-1} issued together in this
      // warpgroup's turn; the softmax of S_j runs while the other
      // warpgroup's products do
      for (int j = 1; j < nkv; ++j) {
        const int sk = (n + j) % STAGES, sv = (n + j - 1) % STAGES;
        mbar_wait(k_full + 8 * sk, ((n + j) / STAGES) & 1);
        mbar_wait(v_full + 8 * sv, ((n + j - 1) / STAGES) & 1);
        uint32_t acc = j > 1;
        dk = kmajor_desc(k0 + sk * L::KV_BYTES);
        const uint64_t dv = v_desc(v0 + sv * L::KV_BYTES);
        bar_sync<256>(mine);
        // O and the flag in the registers the wgmma reads before the fence:
        // the compiler carries O round the loop in integer registers, and
        // its moves after the fence made ptxas add a fence of its own
        // (C7519)
#pragma unroll
        for (int i = 0; i < CP / 2; ++i) fence_operand(o[i]);
        fence_operand(acc);
        wgmma_fence();
        issue_s<CP>(s, dq, dk);
        wgmma_commit();
        issue_pv<CP>(o, pc, dv, acc);
        wgmma_commit();
        bar_arrive<256>(other);
        wgmma_wait<1>();  // S_j is done
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(s[i]);
        if (leader) {
          mbar_arrive(k_empty + 8 * sk);
          if (j == nkv - 1) mbar_arrive(q_empty + 8 * qi);
        }
        softmax(s, pn, m, corr, j * BKV, SP, q, false);
        wgmma_wait<0>();  // P_{j-1}.V_{j-1} is done
#pragma unroll
        for (int i = 0; i < CP / 2; ++i) fence_operand(o[i]);
        if (leader) mbar_arrive(v_empty + 8 * sv);
#pragma unroll
        for (int i = 0; i < CP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int t = 0; t < 4; ++t) pc[kk][t] = pn[kk][t];
      }

      // the last P.V
      st = (n + nkv - 1) % STAGES;
      const uint64_t dv = v_desc(v0 + st * L::KV_BYTES);
      uint32_t acc = nkv > 1;
      mbar_wait(v_full + 8 * st, ((n + nkv - 1) / STAGES) & 1);
      bar_sync<256>(mine);
#pragma unroll
      for (int i = 0; i < CP / 2; ++i) fence_operand(o[i]);
      fence_operand(acc);
      wgmma_fence();
      issue_pv<CP>(o, pc, dv, acc);
      wgmma_commit();
      bar_arrive<256>(other);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < CP / 2; ++i) fence_operand(o[i]);
      if (leader) mbar_arrive(v_empty + 8 * st);
      n += nkv;

      // l = O[:, D] (v's ones column), held by quad lane (D % 8) / 2
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < CP / 8; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t)
          if (8 * j + t == (D & ~6)) {  // a constant index: o stays in registers
            l[0] = o[4 * j + t];
            l[1] = o[4 * j + 2 + t];
          }
      const int src = (lane & ~3) | ((D & 7) >> 1);
      l[0] = __shfl_sync(0xffffffffu, l[0], src);
      l[1] = __shfl_sync(0xffffffffu, l[1], src);

      // out[:, h*D : (h+1)*D] = O[:, :D] / l, rows past SP not written;
      // pairs of columns as one word where D is even
      const int HD = H * D;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = qb * BQ + wg * 64 + warp * 16 + g + 8 * hh;
        if (row >= SP) continue;
        const float inv_l = 1.0f / l[hh];
        bf16* dst = out + ((long long)b * SP + row) * HD + (long long)h * D;
#pragma unroll
        for (int j = 0; j < CP / 8; ++j) {
          const int col = 8 * j + 2 * q;
          const float a = o[4 * j + 2 * hh] * inv_l, c = o[4 * j + 2 * hh + 1] * inv_l;
          if (!(D & 1)) {
            if (col < D)
              *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(a, c);
          } else {
            if (col < D) dst[col] = __float2bfloat16(a);
            if (col + 1 < D) dst[col + 1] = __float2bfloat16(c);
          }
        }
      }
    }
    if (wg == 0) bar_sync<256>(mine);  // warpgroup 1's last opening of it
  }
}

// a 3-D map over (images, rows, cols) bf16 with the given element strides
// of a row and an image, boxes of 16 columns x 128 rows, 32-byte swizzled;
// reads past the last row give 0
int make_map(CUtensorMap* map, const void* base, int images, int rows, int cols,
             long long row_stride, long long batch_stride) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(images)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {16, BQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int CP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int SP, int H, int D,
           long long q_row, long long k_row, long long v_row, long long q_batch,
           long long k_batch, long long v_batch, cudaStream_t stream) {
  static_assert(Layout<CP>::SMEM <= SMEM_LIMIT, "shared memory");
  if (B == 0 || SP == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (int e = make_map(&tq, q, B, SP, H * CP, q_row, q_batch)) return e;
  if (int e = make_map(&tk, k, B, SP, H * CP, k_row, k_batch)) return e;
  if (int e = make_map(&tv, v, B, SP, H * CP, v_row, v_batch)) return e;
  const int smem = Layout<CP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(fat_attention_kernel<CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)B * H * ((SP + BQ - 1) / BQ);
  fat_attention_kernel<CP><<<tiles < sms ? (int)tiles : sms, NT, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), B, SP, H, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out(B, SP, H*D) from fat-layout q/k/v views with the given element
// strides. Needs C equal to 80 (SO400M, D = 72), 32 or 16 (the wrapper
// pads the tiny test configs' fat widths 24 and 8 to those), D < C, and
// 16-byte aligned bases and strides.
int mse_fat_attention(const void* q, const void* k, const void* v, void* out,
                      int B, int SP, int H, int C, int D, long long q_row,
                      long long k_row, long long v_row, long long q_batch,
                      long long k_batch, long long v_batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D >= C) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 80:
      return launch<80>(q, k, v, out, B, SP, H, D, q_row, k_row, v_row, q_batch, k_batch,
                        v_batch, s);
    case 32:
      return launch<32>(q, k, v, out, B, SP, H, D, q_row, k_row, v_row, q_batch, k_batch,
                        v_batch, s);
    case 16:
      return launch<16>(q, k, v, out, B, SP, H, D, q_row, k_row, v_row, q_batch, k_batch,
                        v_batch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
