// Fat-layout ViT self-attention for the SigLIP image tower on Hopper (sm_90a).
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/attention.py:_fat_vit_kernel
// behind both fat_vit_mha (separate q/k/v arrays) and fat_vit_mha_packed
// (one packed [q | k | v] array): this kernel takes base pointers and row
// and batch strides, so one kernel serves both.
//
// Fat layout: each head owns C = fat_width(d) columns, d features plus a
// constant column at index d. q is pre-scaled by 1/sqrt(d) and its
// constant is 1; k's constant is 0 on valid rows and -1e30 on pad rows, so
// Q.K^T yields masked scores directly; v's constant is 1, so column d of
// P.V is the softmax sum l of the bf16-rounded P (attention.py:283-289).
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at B=128,
// SP=736, H=16, C=80: 355 GFLOP against 941 MB of q/k/v in and output out,
// so operations bound it (0.36 ms), not bytes (0.28 ms).
//
// Design: unlike the TPU kernel, which held one image's whole K and V in
// VMEM, K and V of one head at SP=736 take 235 KB, more than a block's
// shared memory. So a CTA owns 64 query rows of one (image, head) and
// streams 64-row key tiles through a two-stage cp.async ring with an
// online softmax (running row max; the fp32 output is rescaled when the
// max grows). Four warps each own 16 query rows, flash-attention style:
// Q fragments stay in registers, S = Q.K^T and O += P.V are mma.sync
// m16n8k16 bf16 products with fp32 accumulators in registers, and the
// score accumulators become P's A-operand fragments without a trip through
// shared memory. P is rounded to bf16 before P.V, as in the reference, and
// l comes out of V's ones column through the same MMA. The ragged last key
// tile (736 = 11*64 + 32) is zero-filled and its scores set to -inf: the
// kernel never reads past row SP-1, where the next image's rows (valid
// keys) begin. C is zero-padded to CP, a multiple of 16, in shared memory
// for the MMA k-steps; the zero columns add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64, BKV = 64, NW = 4, NT = NW * 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0+64) x columns [0, CP) of one head into a (64, CP+8) tile;
// rows past `valid` and columns [C, CP) are zero-filled
template <int CP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int valid, int C, int tid) {
  constexpr int CHUNKS = CP / 8, CS = CP + 8;
  for (int id = tid; id < 64 * CHUNKS; id += NT) {
    const int r = id / CHUNKS, c = (id % CHUNKS) * 8;
    const bool p = r0 + r < valid && c < C;
    cp_async16(dst + r * CS + c, p ? src + (long long)(r0 + r) * row_stride + c : src, p);
  }
}

template <int CP>
__global__ void __launch_bounds__(NT)
fat_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int SP,
                     int H, int C, int D, long long q_row, long long k_row,
                     long long v_row, long long q_batch, long long k_batch,
                     long long v_batch) {
  constexpr int CS = CP + 8, KSTEPS = CP / 16, NTILES = CP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * CS;       // two stages
  bf16* sV = sK + 2 * BKV * CS;  // two stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;  // accumulator row g (and g+8), cols 2qd, 2qd+1
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * q_batch + (long long)h * C;
  const bf16* kb = k + b * k_batch + (long long)h * C;
  const bf16* vb = v + b * v_batch + (long long)h * C;
  const int NKT = (SP + BKV - 1) / BKV;

  load_tile<CP>(sQ, qb, q_row, q0, SP, C, tid);
  load_tile<CP>(sK, kb, k_row, 0, SP, C, tid);
  load_tile<CP>(sV, vb, v_row, 0, SP, C, tid);
  asm volatile("cp.async.commit_group;\n");

  uint32_t qf[KSTEPS][4];
  float o[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n)
#pragma unroll
    for (int t = 0; t < 4; ++t) o[n][t] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};

  for (int kt = 0; kt < NKT; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < NKT) {
      load_tile<CP>(sK + (st ^ 1) * BKV * CS, kb, k_row, (kt + 1) * BKV, SP, C, tid);
      load_tile<CP>(sV + (st ^ 1) * BKV * CS, vb, v_row, (kt + 1) * BKV, SP, C, tid);
    }
    asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n");
    __syncthreads();

    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * CS + ks * 16 + (lane >> 4) * 8);
    }
    const bf16* tK = sK + st * BKV * CS;
    const bf16* tV = sV + st * BKV * CS;

    // S (16 x 64) = Q_w . K^T
    float s[8][4];
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

    // online softmax: mask the ragged tail, new row max, rescale O
    const int kbase = kt * BKV;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (kbase + n * 8 + 2 * qd + (t & 1) >= SP) s[n][t] = -INFINITY;
        mx[t >> 1] = fmaxf(mx[t >> 1], s[n][t]);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m_run[hh], mx[hh]);
      corr[hh] = expf(m_run[hh] - m_new);  // 0 on the first tile
      m_run[hh] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int t = 0; t < 4; ++t) o[n][t] *= corr[t >> 1];

    // P = exp(S - m) rounded to bf16, as A fragments of the P.V product
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sn = s[2 * kk + half];
        pa[kk][2 * half] = pack_bf16(expf(sn[0] - m_run[0]), expf(sn[1] - m_run[0]));
        pa[kk][2 * half + 1] = pack_bf16(expf(sn[2] - m_run[1]), expf(sn[3] - m_run[1]));
      }
    }

    // O (16 x CP) += P (16 x 64) . V (64 x CP)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * CS +
                                 np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa[kk], r[0], r[1]);
        mma_bf16(o[2 * np + 1], pa[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // this stage's K/V may be overwritten next iteration
  }

  // l = O[:, D] (v's ones column), held by quad lane (D % 8) / 2
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NTILES; ++n)
    if (n == (D >> 3)) {
      l[0] = (D & 1) ? o[n][1] : o[n][0];
      l[1] = (D & 1) ? o[n][3] : o[n][2];
    }
  const int src = (lane & ~3) | ((D & 7) >> 1);
  l[0] = __shfl_sync(0xffffffffu, l[0], src);
  l[1] = __shfl_sync(0xffffffffu, l[1], src);

  // out[:, h*D : (h+1)*D] = O[:, :D] / l
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + hh * 8;
    if (row >= SP) continue;
    const float inv_l = 1.0f / l[hh];
    bf16* dst = out + ((long long)b * SP + row) * (long long)(H * D) + (long long)h * D;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      const int col = n * 8 + 2 * qd;
      if (col < D) dst[col] = __float2bfloat16(o[n][2 * hh] * inv_l);
      if (col + 1 < D) dst[col + 1] = __float2bfloat16(o[n][2 * hh + 1] * inv_l);
    }
  }
}

template <int CP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int SP, int H,
           int C, int D, long long q_row, long long k_row, long long v_row,
           long long q_batch, long long k_batch, long long v_batch, cudaStream_t stream) {
  const int bytes = (BQ + 4 * BKV) * (CP + 8) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      fat_attention_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((SP + BQ - 1) / BQ, H, B);
  fat_attention_kernel<CP><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), SP, H, C, D, q_row, k_row,
      v_row, q_batch, k_batch, v_batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out(B, SP, H*D) from fat-layout q/k/v views with the given element strides.
// Needs C % 8 == 0, D < C, 16-byte aligned rows, and C padded to 16 equal to
// 80 (SO400M, d=72) or 16 (the tiny test geometry, d=7).
int mse_fat_attention(const void* q, const void* k, const void* v, void* out,
                      int B, int SP, int H, int C, int D, long long q_row,
                      long long k_row, long long v_row, long long q_batch,
                      long long k_batch, long long v_batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16 * 16) {
    case 80:
      return launch<80>(q, k, v, out, B, SP, H, C, D, q_row, k_row, v_row, q_batch,
                        k_batch, v_batch, s);
    case 16:
      return launch<16>(q, k, v, out, B, SP, H, C, D, q_row, k_row, v_row, q_batch,
                        k_batch, v_batch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
