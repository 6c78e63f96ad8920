// GEMM kernels with fused LayerNorm prologue and bias / gelu / residual /
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
// bound by tensor-core operations, not bytes.
//
// Design: one CTA computes a 128x128 output tile with eight warps, each a
// 64x32 sub-tile of mma.sync m16n8k16 bf16 products with fp32
// accumulators in registers, operands fed by ldmatrix from padded
// (conflict-free) shared tiles. The K loop steps 32 at a time through a
// 4-stage cp.async ring, so three tiles are in flight while the tensor
// cores work on the fourth. The LayerNorm is applied in shared memory to
// each A tile as it lands (fp32 row statistics from a one-warp-per-row
// pre-pass), so the normalised activations never go to device memory. The epilogue
// works from the accumulator registers: bias in fp32, then the optional
// tanh-gelu, the residual and the packed-QKV key mask, one rounding to
// bf16. wgmma, TMA and warp specialisation, the route to the card's full
// tensor-core rate, are later work.
//
// Numerics follow the reference: LN statistics in fp32, LN output rounded
// to bf16 before the MMA (fused.py:39-41), fp32 accumulation, bias (and
// residual) added in fp32, one rounding to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, NT = 256, STAGES = 4;
constexpr int AS = BK + 8;  // shared row stride of an A tile (bf16): 80 B
constexpr int WS = BN + 8;  // shared row stride of a W tile (bf16): 272 B
constexpr int A_TILE = BM * AS, W_TILE = BK * WS;
constexpr int SMEM_BYTES = STAGES * (A_TILE + W_TILE) * 2 + 2 * BM * 4;

struct Epilogue {
  const bf16* bias;  // (N,)
  const bf16* res;   // (M, N) or null
  int act;           // 0: none, 1: tanh-gelu
  // packed fat-QKV key mask: rows with (row % sp) >= n_valid get, in
  // columns [hc, 2hc), 0 everywhere except -1e30 where (col - hc) % c == d.
  int n_valid, sp, hc, c, d;  // c == 0: no mask
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !pred
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

union Pack8 {
  uint4 u;
  bf16 h[8];
};

// fp32 LayerNorm statistics (mean, 1/sqrt(var + 1e-6)) of each row of
// x(M, K), one warp per row, two passes (mean, then centred variance).
// Computed once here rather than in every CTA of a row block: with
// N / 128 CTAs per row block, recomputing them re-read x up to 34 times.
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

template <bool LN>
__global__ void __launch_bounds__(NT, 2)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ gamma,
            const bf16* __restrict__ beta, const float2* __restrict__ stats,
            const bf16* __restrict__ W, bf16* __restrict__ out, int M, int N, int K,
            Epilogue epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sW = sA + STAGES * A_TILE;
  float* sMu = reinterpret_cast<float*>(sW + STAGES * W_TILE);
  float* sRs = sMu + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const int KT = (K + BK - 1) / BK;

  // this thread's two 16-byte chunks of each tile
  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * NT;
      const int r = id >> 2, c = (id & 3) * 8;  // A: 128 rows x 4 chunks
      const int row = m0 + r, k = k0 + c;
      const bool pa = row < M && k < K;
      cp_async16(sA + slot * A_TILE + r * AS + c, pa ? A + (size_t)row * K + k : A, pa);
      const int rr = id >> 4, cc = (id & 15) * 8;  // W: 32 rows x 16 chunks
      const int kr = k0 + rr, col = n0 + cc;
      const bool pw = kr < K && col < N;
      cp_async16(sW + slot * W_TILE + rr * WS + cc, pw ? W + (size_t)kr * N + col : W, pw);
    }
  };

  // the prologue's loads go out before the row statistics are read
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n");
  }

  if (LN) {
    for (int r = tid; r < BM; r += NT) {
      const float2 st = m0 + r < M ? stats[m0 + r] : make_float2(0.f, 0.f);
      sMu[r] = st.x;
      sRs[r] = st.y;
    }
    __syncthreads();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int slot = kt % STAGES;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    if (LN) {
      // normalise the A chunks this thread copied, in place
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int id = tid + i * NT;
        const int r = id >> 2, c = (id & 3) * 8;
        const int k = k0 + c;
        if (k < K) {
          uint4* p4 = reinterpret_cast<uint4*>(sA + slot * A_TILE + r * AS + c);
          Pack8 p;
          p.u = *p4;
          const float mu = sMu[r], rs = sRs[r];
          Pack8 g, b;
          g.u = *reinterpret_cast<const uint4*>(gamma + k);
          b.u = *reinterpret_cast<const uint4*>(beta + k);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float xc = __bfloat162float(p.h[t]) - mu;
            p.h[t] = __float2bfloat16(xc * rs * __bfloat162float(g.h[t]) +
                                      __bfloat162float(b.h[t]));
          }
          *p4 = p.u;
        }
      }
    }
    __syncthreads();  // stage kt visible to all; all warps done with kt-1
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    asm volatile("cp.async.commit_group;\n");

    const bf16* tA = sA + slot * A_TILE;
    const bf16* tW = sW + slot * W_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], tA + (wm * 64 + i * 16 + (lane & 15)) * AS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, tW + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WS + wn * 32 + jp * 16 +
                   (lane >> 4) * 8);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

  // epilogue from the accumulators: thread holds (row g, cols 2q, 2q+1)
  // and (row g+8, same cols) of each 16x8 tile
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * q;
    if (col >= N) continue;
    const __nv_bfloat162 bias2 = *reinterpret_cast<const __nv_bfloat162*>(epi.bias + col);
    const float bias_v[2] = {__low2float(bias2), __high2float(bias2)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 64 + i * 16 + g + hh * 8;
        if (row >= M) continue;
        float v[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          v[t] = acc[i][j][2 * hh + t] + bias_v[t];
          if (epi.act == 1) v[t] = gelu_tanh(v[t]);
        }
        if (epi.res) {
          const __nv_bfloat162 r2 =
              *reinterpret_cast<const __nv_bfloat162*>(epi.res + (size_t)row * N + col);
          v[0] += __low2float(r2);
          v[1] += __high2float(r2);
        }
        if (epi.c > 0 && (row % epi.sp) >= epi.n_valid) {
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int cc = col + t;
            if (cc >= epi.hc && cc < 2 * epi.hc)
              v[t] = ((cc - epi.hc) % epi.c == epi.d) ? -1e30f : 0.f;
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

template <bool LN>
int launch(const bf16* a, const bf16* g, const bf16* b, float2* stats, const bf16* w,
           bf16* out, int M, int N, int K, const Epilogue& epi, cudaStream_t stream) {
  if (LN) {
    ln_stats_kernel<<<(M + 7) / 8, 256, 0, stream>>>(a, stats, M, K);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<LN><<<grid, NT, SMEM_BYTES, stream>>>(a, g, b, stats, w, out, M, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out(M,N) = act(LN(x)(M,K) @ w(K,N) + bias) with the optional key mask.
// Needs K % 8 == 0, N % 8 == 0 and 16-byte aligned, contiguous operands.
// `stats` is (M,) float2 scratch for the row statistics.
int mse_ln_matmul(const void* x, const void* g, const void* b, const void* w,
                  const void* bias, void* out, void* stats, int M, int N, int K, int act,
                  int n_valid, int sp, int hc, int c, int d, void* stream) {
  Epilogue epi{static_cast<const bf16*>(bias), nullptr, act, n_valid, sp, hc, c, d};
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
               0, 1, 0, 0, 0};
  return launch<false>(static_cast<const bf16*>(x), nullptr, nullptr, nullptr,
                       static_cast<const bf16*>(w), static_cast<bf16*>(out), M, N, K,
                       epi, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
