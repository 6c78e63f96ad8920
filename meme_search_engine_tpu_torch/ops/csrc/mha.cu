// Fused non-causal self-attention on (B, S, H, Dh) for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/attention.py:_fused_attention_kernel
// behind fused_mha_pallas, which mha() calls for every self-attention
// layer of the text tower (S=64, H=16, Dh=72) and of the image tower's
// attn_impl="xla" route (S=729). Per (batch, head) it computes
//   s = (q @ k^T) in fp32 from bf16 operands, then s *= scale;
//   p = exp(s - M), M one max over the head's whole S x S block
//       ("scalar", what mha() uses), the row max ("row") or 0 ("none");
//   l = sum(p) in fp32 from fp32 p;
//   o = bf16(p) @ v with fp32 accumulation;
//   out = bf16(o * (1 / l)), an exact reciprocal.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at the text
// bucket B=128, S=64, H=16, Dh=72: 75.5 MB of q, k, v in and out against
// 2.4 GFLOP, so bytes bound it (0.023 ms), not operations (0.002 ms).
//
// Two kernels, both with four warps a CTA, each warp owning 16 query rows;
// S = Q.K^T and O += P.V are mma.sync m16n8k16 bf16 products (m16n8k8 for
// a last 8 columns) with fp32 accumulators in registers, and the score
// accumulators become P's A-operand fragments without a trip through
// shared memory. M is fixed before any p is formed, so there is no online
// rescaling.
//
// S <= 64 (the text tower): mha_small_kernel, built to stream. A
// persistent grid (as many CTAs as fit: four an SM, 55 KB each) walks the
// B * H (batch, head) items, each one query block and one key block. One
// thread brings each item's Q, K and V in by three TMA loads (4-D tensor
// maps over the (Dh, H, S, B) views, so any 16-byte strides; rows past S
// arrive as zeros) into a 2-stage mbarrier ring, so the next item's loads
// run under this item's products. Rows land dense, Dh * 2 bytes apart: at
// Dh = 72 a 144-byte pitch, whose eight rows of an ldmatrix fall on eight
// distinct 16-byte bank groups, so no padding is needed. One pass: the
// scores stay in registers and M comes from them (scalar mode: a CTA
// reduction of the warps' maxima). Each warp writes its O rows over its
// own Q rows (their fragments are in registers by then), and the tile
// leaves by one TMA store, clipped at S; the stage's next K and V loads go
// out at once, its next Q load once the store has read the tile. Two CTA
// barriers an item. Measured on an H100 80GB HBM3 at 700 W: 0.034 ms at
// (128, 64, 16, 72), 66% of the byte bound (a tile of its own for O, three
// CTAs an SM: 0.035; O stored from the registers: 0.041; three stages:
// 0.038).
//
// S > 64 (the image tower's xla route, S=729): mha_kernel, a CTA per 64
// query rows of one (batch, head), read in place through the caller's
// strides by cp.async into tiles padded to DP (a multiple of 16) columns
// and DP + 8 in pitch. A first pass over the key tiles finds M, a second
// recomputes the scores and accumulates l and O. In scalar mode the max
// over the whole head comes from a pre-pass launch of the same kernel that
// reduces each block's max into a per-(batch, head) float with atomics.
// Ragged tiles are zero-filled; keys past S are masked out of M and get
// p = 0, and query rows past S are left out of M and never written.

#include "hopper.cuh"

#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64, BKV = 64, NW = 4, NT = NW * 32;
constexpr int MODE_ROW = 0, MODE_SCALAR = 1, MODE_NONE = 2;

struct Operand {
  const bf16* p;
  long long b, s, h;  // element strides of the batch, sequence and head dims
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  ldmatrix_x4(r, smem_addr(p));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  ldmatrix_x4_trans(r, smem_addr(p));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the m16n8k8 product: a[0] rows g, a[1] rows g + 8, columns 2q, 2q + 1
__device__ __forceinline__ void mma_bf16_k8(float* c, const uint32_t* a, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n");
  asm volatile("cp.async.wait_group 0;\n");
}

// ---- S <= 64: the persistent streaming kernel -----------------------------

constexpr int STAGES = 2;  // items in flight a CTA: one computed, one loading

template <int D>
struct Small {
  static constexpr int TILE = BQ * D * 2;  // bytes of one Q, K, V (or O) tile
  static constexpr int STAGE = 3 * TILE;
  // the ring, the barriers, and slack to align the base to 128
  static constexpr int SMEM = STAGES * STAGE + 8 * STAGES + 128;
};

// P = exp(s * scale - M) as the A fragments of P.V, rounded to bf16, and l
// summed from the fp32 values; keys at or past S get p = 0. __fmul_rn
// keeps s * scale rounded on its own, as the reference scales the scores
// before the shift (no FMA).
__device__ __forceinline__ void softmax_frags(uint32_t (*pa)[4], float* l, const float (*s)[4],
                                              const float* m, float scale, int kt, int S,
                                              int qd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 2 * kk + half;
      float p[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool valid = kt * BKV + n * 8 + 2 * qd + (t & 1) < S;
        p[t] = valid ? expf(__fmul_rn(s[n][t], scale) - m[t >> 1]) : 0.f;
        l[t >> 1] += p[t];
      }
      pa[kk][2 * half] = pack_bf16(p[0], p[1]);
      pa[kk][2 * half + 1] = pack_bf16(p[2], p[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 4)
mha_small_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 int S, int H, int items, int mode, float scale) {
  using L = Small<D>;
  // k16 steps and a k8 step of Q.K^T; O's 8-column tiles
  constexpr int K16 = D / 16, K8 = (D % 16) / 8, NTL = D / 8, PITCH = 2 * D;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 127u) & ~127u;
  const uint32_t full = base + STAGES * L::STAGE;
  __shared__ float red[2][NW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;  // accumulator rows g, g+8; cols 2qd, 2qd+1

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 loads the first items' Q, K and V, a (D, 1, 64, 1) box each
  if (tid == 0)
    for (int st = 0; st < STAGES; ++st) {
      const int item = blockIdx.x + st * gridDim.x;
      if (item >= items) break;
      const uint32_t dst = base + st * L::STAGE;
      mbar_expect_tx(full + 8 * st, 3 * L::TILE);
      tma_load(dst, &tq, 0, item % H, 0, item / H, full + 8 * st);
      tma_load(dst + L::TILE, &tk, 0, item % H, 0, item / H, full + 8 * st);
      tma_load(dst + 2 * L::TILE, &tv, 0, item % H, 0, item / H, full + 8 * st);
    }

  const int row0 = warp * 16;  // this warp's first query row
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int st = it % STAGES;
    const uint32_t sq = base + st * L::STAGE, sk = sq + L::TILE, sv = sk + L::TILE;
    mbar_wait(full + 8 * st, (it / STAGES) & 1);

    // s (16 x 64) = Q_w . K^T, unscaled
    uint32_t qf[K16 + K8][4];
#pragma unroll
    for (int ks = 0; ks < K16; ++ks)
      ldmatrix_x4(qf[ks], sq + (row0 + (lane & 15)) * PITCH + (ks * 16 + (lane >> 4) * 8) * 2);
    if (K8) ldmatrix_x2(qf[K16], sq + (row0 + (lane & 15)) * PITCH + K16 * 32);
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int t = 0; t < 4; ++t) s[n][t] = 0.f;
#pragma unroll
    for (int ks = 0; ks < K16; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, sk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * PITCH +
                           (ks * 16 + ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(s[2 * np], qf[ks], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[ks], r[2], r[3]);
      }
    }
    if (K8) {
#pragma unroll
      for (int nq = 0; nq < 2; ++nq) {  // key tiles 4 nq .. 4 nq + 3
        uint32_t r[4];
        ldmatrix_x4(r, sk + (nq * 32 + lane) * PITCH + K16 * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16_k8(s[4 * nq + i], qf[K16], r[i]);
      }
    }

    // the shift M of rows g and g+8, from the scores in registers
    float m[2] = {0.f, 0.f};
    if (mode != MODE_NONE) {
      m[0] = m[1] = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (n * 8 + 2 * qd + (t & 1) < S) m[t >> 1] = fmaxf(m[t >> 1], __fmul_rn(s[n][t], scale));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
        m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
      }
    }
    if (mode == MODE_SCALAR) {
      float wm = -INFINITY;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (row0 + g + hh * 8 < S) wm = fmaxf(wm, m[hh]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, off));
      if (lane == 0) red[it & 1][warp] = wm;
    }
    // [A]: the warps' maxima are in
    __syncthreads();
    if (mode == MODE_SCALAR) {
      const float* r = red[it & 1];
      m[0] = m[1] = fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3]));
    }

    float l[2] = {0.f, 0.f};
    uint32_t pa[4][4];
    softmax_frags(pa, l, s, m, scale, 0, S, qd);

    // O (16 x D) += P (16 x 64) . V (64 x D)
    float o[NTL][4];
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int t = 0; t < 4; ++t) o[n][t] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t vrow = sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH;
#pragma unroll
      for (int np = 0; np < NTL / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vrow + (np * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(o[2 * np], pa[kk], r[0], r[1]);
        mma_bf16(o[2 * np + 1], pa[kk], r[2], r[3]);
      }
      if (NTL % 2) {
        uint32_t r[2];
        ldmatrix_x2_trans(r, vrow + (NTL - 1) * 16);
        mma_bf16(o[NTL - 1], pa[kk], r[0], r[1]);
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
    // O * (1 / l) into this warp's own rows of the Q tile, which no other
    // warp reads (its Q fragments are in registers); the store clips rows
    // past S
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv_l = 1.0f / l[hh];
      const uint32_t dst = sq + (row0 + g + hh * 8) * PITCH + 4 * qd;
#pragma unroll
      for (int n = 0; n < NTL; ++n)
        sts_u32(dst + 16 * n, pack_bf16(o[n][2 * hh] * inv_l, o[n][2 * hh + 1] * inv_l));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // [B]: O is whole, and every warp is done with stage st
    __syncthreads();
    if (tid == 0) {
      tma_store(&to, sq, 0, item % H, 0, item / H);
      bulk_commit();
      const int next = item + STAGES * gridDim.x;
      if (next < items) {  // K and V now, Q once O has left its tile
        const int b = next / H, h = next % H;
        mbar_expect_tx(full + 8 * st, 3 * L::TILE);
        tma_load(sk, &tk, 0, h, 0, b, full + 8 * st);
        tma_load(sv, &tv, 0, h, 0, b, full + 8 * st);
        bulk_wait_read();
        tma_load(sq, &tq, 0, h, 0, b, full + 8 * st);
      }
    }
  }
  if (tid == 0) bulk_wait();
}

// a 4-D map over the (D, H, S, B) view of a (B, S, H, D) operand with the
// given element strides, boxes of (D, 1, 64, 1): one (batch, head)'s rows,
// dense in shared memory; rows past S read as 0 and are not written
int make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, long long sb,
             long long ss, long long sh) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  // a dimension of one element is never stepped along: any legal stride
  if (B == 1) sb = 8;
  if (S == 1) ss = 8;
  if (H == 1) sh = 8;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, BQ, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_small(Operand q, Operand k, Operand v, bf16* out, int B, int S, int H, int mode,
                 float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (int e = make_map(&tq, q.p, B, S, H, D, q.b, q.s, q.h)) return e;
  if (int e = make_map(&tk, k.p, B, S, H, D, k.b, k.s, k.h)) return e;
  if (int e = make_map(&tv, v.p, B, S, H, D, v.b, v.s, v.h)) return e;
  if (int e = make_map(&to, out, B, S, H, D, (long long)S * H * D, (long long)H * D, D))
    return e;
  const int smem = Small<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(mha_small_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mha_small_kernel<D>, NT, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)B * H;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(items < fit ? items : fit);
  mha_small_kernel<D><<<grid, NT, smem, stream>>>(tq, tk, tv, to, S, H, static_cast<int>(items),
                                                  mode, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- S > 64: a CTA per 64 query rows, two passes ---------------------------

// max over floats through integer atomics; *addr starts at -inf
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// rows [r0, r0+64) x columns [0, DP) of one (batch, head) slice into a
// (64, DP+8) tile; rows past S and columns [D, DP) are zero-filled
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int S, int D, int tid) {
  constexpr int CHUNKS = DP / 8, CS = DP + 8;
  for (int id = tid; id < 64 * CHUNKS; id += NT) {
    const int r = id / CHUNKS, c = (id % CHUNKS) * 8;
    const bool p = r0 + r < S && c < D;
    cp_async16(dst + r * CS + c, p ? src + (long long)(r0 + r) * row_stride + c : src, p);
  }
}

// s (16 x 64) = Q_w . K_tile^T for this warp's 16 query rows, unscaled
template <int DP>
__device__ __forceinline__ void warp_scores(float (*s)[4], const uint32_t (*qf)[4],
                                            const bf16* tK, int lane) {
  constexpr int CS = DP + 8, KSTEPS = DP / 16;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int t = 0; t < 4; ++t) s[n][t] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, tK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * CS + ks * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], qf[ks], r[0], r[1]);
      mma_bf16(s[2 * np + 1], qf[ks], r[2], r[3]);
    }
  }
}

// max_only: the scalar-mode pre-pass (block max into gmax[b*H + h])
template <int DP>
__global__ void __launch_bounds__(NT)
mha_kernel(Operand q, Operand k, Operand v, bf16* __restrict__ out, float* __restrict__ gmax,
           int S, int H, int D, int mode, int max_only, float scale) {
  constexpr int CS = DP + 8, KSTEPS = DP / 16, NTILES = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * CS;
  bf16* sV = sK + BKV * CS;
  __shared__ float red[NW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;  // accumulator rows g, g+8; cols 2qd, 2qd+1
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qp = q.p + b * q.b + h * q.h;
  const bf16* kp = k.p + b * k.b + h * k.h;
  const bf16* vp = v.p + b * v.b + h * v.h;
  const int NKT = (S + BKV - 1) / BKV;

  load_tile<DP>(sQ, qp, q.s, q0, S, D, tid);
  int k_tile = -1, v_tile = -1;  // which key tile sK and sV hold
  bool q_ready = false;
  uint32_t qf[KSTEPS][4];
  float s[8][4];

  // ---- pass 1: the fixed shift M of rows g and g+8 ----------------------
  float m[2] = {0.f, 0.f};
  if (mode == MODE_ROW || (mode == MODE_SCALAR && max_only)) {
    m[0] = m[1] = -INFINITY;
    for (int kt = 0; kt < NKT; ++kt) {
      if (kt != k_tile) {
        __syncthreads();  // every warp is done with the previous tile
        load_tile<DP>(sK, kp, k.s, kt * BKV, S, D, tid);
        cp_async_wait_all();
        __syncthreads();
        k_tile = kt;
      }
      if (!q_ready) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * CS + ks * 16 + (lane >> 4) * 8);
        q_ready = true;
      }
      warp_scores<DP>(s, qf, sK, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (kt * BKV + n * 8 + 2 * qd + (t & 1) < S)
            m[t >> 1] = fmaxf(m[t >> 1], __fmul_rn(s[n][t], scale));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
    }
    if (mode == MODE_SCALAR) {
      float wm = -INFINITY;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (q0 + warp * 16 + g + hh * 8 < S) wm = fmaxf(wm, m[hh]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, off));
      if (lane == 0) red[warp] = wm;
      __syncthreads();
      const float bm = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
      if (max_only) {
        if (tid == 0) atomic_max_float(gmax + (long long)b * H + h, bm);
        return;
      }
      m[0] = m[1] = bm;
    }
  } else if (mode == MODE_SCALAR) {
    m[0] = m[1] = gmax[(long long)b * H + h];
  }

  // ---- pass 2: l and O with M fixed ---------------------------------------
  float o[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n)
#pragma unroll
    for (int t = 0; t < 4; ++t) o[n][t] = 0.f;
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < NKT; ++kt) {
    if (kt != k_tile || kt != v_tile) {
      __syncthreads();
      if (kt != k_tile) load_tile<DP>(sK, kp, k.s, kt * BKV, S, D, tid);
      if (kt != v_tile) load_tile<DP>(sV, vp, v.s, kt * BKV, S, D, tid);
      cp_async_wait_all();
      __syncthreads();
      k_tile = v_tile = kt;
    }
    if (!q_ready) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * CS + ks * 16 + (lane >> 4) * 8);
      q_ready = true;
    }
    warp_scores<DP>(s, qf, sK, lane);

    uint32_t pa[4][4];
    softmax_frags(pa, l, s, m, scale, kt, S, qd);

    // O (16 x DP) += P (16 x 64) . V (64 x DP)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * CS +
                                 np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa[kk], r[0], r[1]);
        mma_bf16(o[2 * np + 1], pa[kk], r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }

  // out[b, row, h, :D] = O[:, :D] * (1 / l)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + hh * 8;
    if (row >= S) continue;
    const float inv_l = 1.0f / l[hh];
    bf16* dst = out + ((long long)b * S + row) * (long long)(H * D) + (long long)h * D;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      const int col = n * 8 + 2 * qd;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[n][2 * hh] * inv_l, o[n][2 * hh + 1] * inv_l);
    }
  }
}

template <int DP>
int launch(Operand q, Operand k, Operand v, bf16* out, float* gmax, int B, int S, int H,
           int D, int mode, float scale, cudaStream_t stream) {
  const int bytes = (BQ + 2 * BKV) * (DP + 8) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  if (mode == MODE_SCALAR && grid.x > 1) {
    if (gmax == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    mha_kernel<DP><<<grid, NT, bytes, stream>>>(q, k, v, out, gmax, S, H, D, mode, 1, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mha_kernel<DP><<<grid, NT, bytes, stream>>>(q, k, v, out, gmax, S, H, D, mode, 0, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (B, S, H, D) contiguous from q/k/v views with the given element
// strides (batch, sequence, head; unit stride on D). Needs D % 8 == 0 and,
// for S <= 64, D one of 8, 16, 72 and 80; for S > 64, D padded to 16 equal
// to 80 (SO400M, Dh=72) or 16 (the tiny test configs, Dh=16 and 7 padded
// to 8). 16-byte aligned base pointers and strides that are multiples of 8
// elements. mode: 0 row, 1 scalar, 2 none. In scalar mode with S > 64,
// gmax points at B*H floats set to -inf.
int mse_mha(const void* q, const void* k, const void* v, void* out, void* gmax, int B, int S,
            int H, int D, int mode, float scale, long long q_b, long long q_s, long long q_h,
            long long k_b, long long k_s, long long k_h, long long v_b, long long v_s,
            long long v_h, void* stream) {
  if (D % 8 != 0 || D <= 0 || S <= 0 || mode < MODE_ROW || mode > MODE_NONE)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operand oq{static_cast<const bf16*>(q), q_b, q_s, q_h};
  const Operand ok{static_cast<const bf16*>(k), k_b, k_s, k_h};
  const Operand ov{static_cast<const bf16*>(v), v_b, v_s, v_h};
  bf16* o = static_cast<bf16*>(out);
  float* gm = static_cast<float*>(gmax);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= BQ) {
    switch (D) {
      case 72: return launch_small<72>(oq, ok, ov, o, B, S, H, mode, scale, st);
      case 80: return launch_small<80>(oq, ok, ov, o, B, S, H, mode, scale, st);
      case 16: return launch_small<16>(oq, ok, ov, o, B, S, H, mode, scale, st);
      case 8: return launch_small<8>(oq, ok, ov, o, B, S, H, mode, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch ((D + 15) / 16 * 16) {
    case 80: return launch<80>(oq, ok, ov, o, gm, B, S, H, D, mode, scale, st);
    case 16: return launch<16>(oq, ok, ov, o, gm, B, S, H, D, mode, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
