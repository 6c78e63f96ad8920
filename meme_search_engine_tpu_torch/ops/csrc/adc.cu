// Asymmetric distance computation (ADC) over PQ codes for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/adc.py:_adc_gather_kernel
// behind adc_scores_pallas, which ProductQuantizer.asymmetric_dot calls
// through adc_scores to score a query's LUT against every code of a corpus.
// It computes
//   scores[b, n] = sum over m of LUT[b, m, codes[n, m]]
// with codes (N, M) uint8, LUTs (B, M, C <= 256) fp32, the sum taken in fp32
// in m order. A code >= C scores 0: the LUT is zero-padded to 256 entries
// per chunk in shared memory, as the TPU wrapper pads it, so no code can
// read past it.
//
// Bound on an H100 SXM (3.35 TB/s; 32 shared-memory words a clock on each
// of 132 SMs at 1.98 GHz) at N = 1e6, M = 64: at B = 1 the 64 MB of codes
// and 4 MB of scores take 0.020 ms and the 6.4e7 lookups 0.008 ms, so bytes
// bound it; at B = 64 the 4.1e9 lookups (0.49 ms) bound it, not the 324 MB
// (0.097 ms).
//
// Design: a CTA of 256 threads takes one query b and a tile of ROWS rows.
// It first copies that query's LUT into dynamic shared memory, M * 256 fp32
// (64 KB at M = 64, above the 48 KB default, hence the attribute set at
// launch), then each thread walks the tile's rows 256 apart: a warp reads
// 32 neighbouring rows, 2 KB in one stretch, a thread its row's M bytes as
// 16-byte loads where M % 16 == 0 (byte loads otherwise), and sums its M
// lookups in a register. The grid is one dimension of B * tiles CTAs (up to
// 2^31 - 1) with the query fastest, so the CTAs of all queries over one row
// tile run together and read its codes from L2 rather than from device
// memory once per query.
//
// Bank conflicts: a chunk's 256 entries cover the 32 banks eight times, so
// a lookup's bank is its code mod 32, whatever the chunk. The 32 lanes of a
// warp look up 32 random codes, and the most that land on one bank is about
// 3.5 on average, so a lookup costs about 3.5 shared-memory wavefronts.
// Nothing here avoids that: a copy of the LUT per bank group does not fit
// in shared memory at M = 64, and the codes are data. At B = 1 bytes still
// bound the kernel; at B = 64 the conflicts stretch the lookup bound.
//
// Offsets are 64-bit: at N = 1e8 rows N * M and B * N overflow int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads a CTA
constexpr int LUT_WIDTH = 256;   // LUT entries per chunk in shared memory
constexpr long long ROWS = 4096;  // rows a CTA takes (16 a thread)

template <bool VEC>
__global__ void __launch_bounds__(NT) adc_kernel(const uint8_t* __restrict__ codes,
                                                 const float* __restrict__ luts,
                                                 float* __restrict__ out, long long N,
                                                 int M, int C, int B) {
  extern __shared__ float lut[];  // (M, LUT_WIDTH)
  const long long b = blockIdx.x % B;
  const long long row0 = static_cast<long long>(blockIdx.x / B) * ROWS;
  const float* src = luts + b * M * C;
  for (int i = threadIdx.x; i < M * LUT_WIDTH; i += NT) {
    const int m = i / LUT_WIDTH, c = i % LUT_WIDTH;
    lut[i] = c < C ? src[static_cast<long long>(m) * C + c] : 0.f;
  }
  __syncthreads();

  const long long row_end = min(row0 + ROWS, N);
  for (long long n = row0 + threadIdx.x; n < row_end; n += NT) {
    const uint8_t* row = codes + n * M;
    float acc = 0.f;
    if (VEC) {
      for (int m0 = 0; m0 < M; m0 += 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + m0));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t code = (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
          acc += lut[(m0 + j) * LUT_WIDTH + code];
        }
      }
    } else {
      for (int m = 0; m < M; ++m) acc += lut[m * LUT_WIDTH + __ldg(row + m)];
    }
    out[b * N + n] = acc;
  }
}

template <bool VEC>
int launch(const uint8_t* codes, const float* luts, float* out, long long N, int M, int C,
           int B, cudaStream_t stream) {
  const int bytes = M * LUT_WIDTH * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      adc_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = static_cast<long long>(B) * ((N + ROWS - 1) / ROWS);
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  adc_kernel<VEC><<<static_cast<unsigned>(ctas), NT, bytes, stream>>>(codes, luts, out, N, M,
                                                                       C, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out(B, N) fp32 from contiguous codes (N, M) uint8 and LUTs (B, M, C) fp32.
// Needs 1 <= M <= 227 (the LUT's M * 1 KB of shared memory), C <= 256,
// N >= 1, B >= 1 and B * ceil(N / 4096) <= 2^31 - 1 (the grid's CTAs;
// otherwise it returns cudaErrorInvalidConfiguration and launches nothing).
int mse_adc(const void* codes, const void* luts, void* out, long long N, int M, int C,
            int B, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* l = static_cast<const float*>(luts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    return launch<true>(c, l, o, N, M, C, B, s);
  return launch<false>(c, l, o, N, M, C, B, s);
}

}  // extern "C"
