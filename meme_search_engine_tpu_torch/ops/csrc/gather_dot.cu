// Gathered dot products for the Vamana build on Hopper (sm_90a).
//
// Replaces, with gather_gram.cu, the TPU kernel
//   meme_search_engine_tpu/ops/gather.py:_gather_flat
// behind gather_rows, together with the dot the JAX package runs on the
// gathered rows (index/vamana.py: the greedy-search hop's
// einsum("bd,brd->br") and the re-prune's einsum("bd,bcd->bc"), bf16 or
// int8 rows with preferred_element_type=f32). It computes
//   out[b, k] = sum over d of float(V[clamp(idx[b, k])][d]) * q[b][d]
// with V (N, D) bf16, int8 or fp32, idx (B, K) int32, q (B, D) fp32 and the
// sum in fp32. An id out of range is clamped into [0, N - 1], as
// gather_rows clamps it.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At the build's hop, (1024, 128)
// ids into 48,643 x 1152 bf16 rows of 2,304 B, the kernel reads between the
// distinct rows (about 105 MB) and every row (302 MB), and writes 0.5 MB:
// 0.03-0.09 ms. The 0.3 GFLOP of fp32 FMAs are far below the CUDA cores'
// rate, so no tensor core is used: this is a GEMV per query.
//
// Design: the gathered rows never reach device memory again, only the
// (B, K) scores. A CTA of 8 warps takes one query b and up to 64 of its ids;
// each warp scores 8 of them, one row at a time, its lane l taking the
// row's 16-byte words l, l + 32, .... The lane's slice of q[b] is the same
// for every row, so it sits in registers (about 48 floats), loaded once a
// warp. Each lane sums its words in fp32, then a warp shuffle adds the 32
// partial sums and lane 0 stores one float. Two ways to bring a row in:
//   bulk copies (where the rows allow it: a 16-byte aligned base and rows
//   of a multiple of 16 bytes, up to 32 x 16 x U bytes, 3 KB in bf16):
//   lane 0 keeps a ring of 4 row buffers a warp in shared memory full with
//   1-D cp.async.bulk copies of whole rows (2,304 B at D = 1152), each
//   completing an mbarrier; the warp reads a row back once it has landed,
//   so 4 rows a warp (74 KB a CTA) are in flight. At the hop's shape this
//   beat 16-byte plain loads of the same rows by 1.26x (PERF.md, section 6);
//   registers (every other row): the row is read in words of W bytes (the
//   widest of 16, 8, 4, 2, 1 that divides the row's bytes and the corpus
//   base) by plain loads, each lane keeping all its loads of the row in
//   flight before it multiplies; a row longer than 32 x U words is taken
//   in passes, q reloaded each pass from L1.
// Offsets are 64-bit (a 1e6 x 1152 bf16 corpus is 2.3 GB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;             // threads a CTA: 8 warps
constexpr int WARPS = NT / 32;
constexpr int ROWS_PER_WARP = 8;    // ids a warp scores
constexpr int ROWS = WARPS * ROWS_PER_WARP;
constexpr long long MAX_GRID = 2147483647LL;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// T the element type, Word the load (W bytes), U the words a lane holds in
// one pass (U x E floats of q in registers, E = W / sizeof(T))
template <typename T, typename Word, int U>
__global__ void __launch_bounds__(NT) gather_dot_kernel(const Word* __restrict__ vectors,
                                                        const int32_t* __restrict__ idx,
                                                        const float* __restrict__ q,
                                                        float* __restrict__ out,
                                                        long long n_rows, int k, int d) {
  constexpr int E = sizeof(Word) / sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slices = (k + ROWS - 1) / ROWS;
  const long long b = blockIdx.x / slices;
  const int k0 = (blockIdx.x % slices) * ROWS + warp * ROWS_PER_WARP;
  const int k1 = min(k, k0 + ROWS_PER_WARP);
  if (k0 >= k1) return;
  const int words = d / E;  // W divides the row's bytes, so d % E == 0
  const float* qb = q + b * d;
  const bool one_pass = words <= 32 * U;
  float qr[U][E];

  auto load_q = [&](int p0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = p0 + lane + 32 * u;
#pragma unroll
      for (int e = 0; e < E; ++e) qr[u][e] = w < words ? __ldg(qb + w * E + e) : 0.f;
    }
  };
  if (one_pass) load_q(0);

  for (int kk = k0; kk < k1; ++kk) {
    long long id = 0;
    if (lane == 0) id = __ldg(idx + b * k + kk);
    id = __shfl_sync(0xffffffffu, id, 0);
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    const Word* src = vectors + id * words;
    float acc = 0.f;
    for (int p0 = 0; p0 < words; p0 += 32 * U) {
      if (!one_pass) load_q(p0);
      Word v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w = p0 + lane + 32 * u;
        if (w < words) v[u] = __ldg(src + w);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w = p0 + lane + 32 * u;
        if (w < words) {
          T e8[E];
          memcpy(e8, &v[u], sizeof(Word));
#pragma unroll
          for (int e = 0; e < E; ++e) acc = fmaf(to_float(e8[e]), qr[u][e], acc);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[b * k + kk] = acc;
  }
}

// the bulk-copy route: warp w scores the same rows as above, each landing
// whole in slot j % RING of the warp's ring before the warp reads it
constexpr int RING = 4;
constexpr int MAX_BULK_ROW = 3072;  // 8 warps x 4 slots: 96 KB of rows a CTA

template <typename T, int U>
__global__ void __launch_bounds__(NT) gather_dot_bulk_kernel(const unsigned char* __restrict__ vectors,
                                                             const int32_t* __restrict__ idx,
                                                             const float* __restrict__ q,
                                                             float* __restrict__ out,
                                                             long long n_rows, int k, int d) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slices = (k + ROWS - 1) / ROWS;
  const long long b = blockIdx.x / slices;
  const int k0 = (blockIdx.x % slices) * ROWS + warp * ROWS_PER_WARP;
  const int rows = min(k, k0 + ROWS_PER_WARP) - k0;
  if (rows <= 0) return;
  const int words = d / E;
  const uint32_t row_bytes = static_cast<uint32_t>(d) * sizeof(T);
  const uint32_t ring = smem_addr(smem) + warp * RING * row_bytes;
  const uint32_t bars = smem_addr(smem) + WARPS * RING * row_bytes + warp * RING * 8;
  const float* qb = q + b * d;

  auto fetch = [&](int j) {  // lane 0: row j of this warp into slot j % RING
    long long id = __ldg(idx + b * k + k0 + j);
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    const uint32_t bar = bars + 8 * (j % RING);
    mbar_expect_tx(bar, row_bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            ring + (j % RING) * row_bytes),
        "l"(vectors + id * row_bytes), "r"(row_bytes), "r"(bar)
        : "memory");
  };
  if (lane == 0) {
    for (int j = 0; j < RING; ++j) mbar_init(bars + 8 * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < min(rows, RING); ++j) fetch(j);
  }
  float qr[U][E];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int w = lane + 32 * u;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[u][e] = w < words ? __ldg(qb + w * E + e) : 0.f;
  }
  __syncwarp();
  for (int j = 0; j < rows; ++j) {
    mbar_wait(bars + 8 * (j % RING), (j / RING) & 1);
    const uint32_t src = ring + (j % RING) * row_bytes;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = lane + 32 * u;
      if (w < words) {
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(src + 16 * w));
        T e8[E];
        memcpy(e8, &v, 16);
#pragma unroll
        for (int e = 0; e < E; ++e) acc = fmaf(to_float(e8[e]), qr[u][e], acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    __syncwarp();  // every lane has read the slot
    if (lane == 0) {
      out[b * k + k0 + j] = acc;
      if (j + RING < rows) {
        // the slot's reads (generic proxy) before the bulk copy's write
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch(j + RING);
      }
    }
  }
}

// the 16-byte words a lane holds: about 48 floats of q in registers
template <typename T>
constexpr int bulk_words() {
  return (48 * sizeof(T) + 15) / 16;
}

template <typename T>
bool bulk_takes(const void* vectors, int d) {
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  return row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0 &&
         row_bytes <= MAX_BULK_ROW && row_bytes <= 32LL * 16 * bulk_words<T>();
}

template <typename T>
int launch_bulk(const void* vectors, const int32_t* idx, const float* q, float* out,
                long long n_rows, int b, int k, int d, cudaStream_t stream) {
  constexpr int U = bulk_words<T>();
  const long long row_bytes = static_cast<long long>(d) * sizeof(T);
  const long long grid = static_cast<long long>(b) * ((k + ROWS - 1) / ROWS);
  if (grid > MAX_GRID) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(WARPS * RING * (row_bytes + 8));
  cudaError_t err = cudaFuncSetAttribute(gather_dot_bulk_kernel<T, U>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_dot_bulk_kernel<T, U><<<static_cast<unsigned>(grid), NT, smem, stream>>>(
      static_cast<const unsigned char*>(vectors), idx, q, out, n_rows, k, d);
  return static_cast<int>(cudaGetLastError());
}

// about 48 floats of q a lane in registers, whatever the word
template <typename T, typename Word>
int launch(const void* vectors, const int32_t* idx, const float* q, float* out,
           long long n_rows, int b, int k, int d, cudaStream_t stream) {
  constexpr int E = sizeof(Word) / sizeof(T);
  constexpr int U = (48 + E - 1) / E;
  const long long grid = static_cast<long long>(b) * ((k + ROWS - 1) / ROWS);
  if (grid > MAX_GRID) return static_cast<int>(cudaErrorInvalidValue);
  gather_dot_kernel<T, Word, U><<<static_cast<unsigned>(grid), NT, 0, stream>>>(
      static_cast<const Word*>(vectors), idx, q, out, n_rows, k, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* vectors, const int32_t* idx, const float* q, float* out,
             long long n_rows, int b, int k, int d, cudaStream_t stream) {
  if (bulk_takes<T>(vectors, d))
    return launch_bulk<T>(vectors, idx, q, out, n_rows, b, k, d, stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(vectors) | static_cast<uintptr_t>(d * sizeof(T));
  // a word never holds less than one element: an fp32 corpus is 4-byte
  // aligned, a bf16 one 2-byte aligned
  if (align % 16 == 0) return launch<T, uint4>(vectors, idx, q, out, n_rows, b, k, d, stream);
  if (align % 8 == 0) return launch<T, uint2>(vectors, idx, q, out, n_rows, b, k, d, stream);
  if (sizeof(T) == 4 || align % 4 == 0)
    return launch<T, unsigned int>(vectors, idx, q, out, n_rows, b, k, d, stream);
  if constexpr (sizeof(T) == 2) {
    return launch<T, unsigned short>(vectors, idx, q, out, n_rows, b, k, d, stream);
  } else if constexpr (sizeof(T) == 1) {
    if (align % 2 == 0)
      return launch<T, unsigned short>(vectors, idx, q, out, n_rows, b, k, d, stream);
    return launch<T, unsigned char>(vectors, idx, q, out, n_rows, b, k, d, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (B, K) fp32 from contiguous vectors (N, D), idx (B, K) int32 and q
// (B, D) fp32; elem 0 bf16, 1 int8, 2 fp32. Needs N >= 1, B >= 1, K >= 1
// and D >= 1; otherwise, or for an element type it does not know, it
// returns cudaErrorInvalidValue and launches nothing.
int mse_gather_dot(const void* vectors, const void* idx, const void* q, void* out,
                   long long n_rows, int b, int k, int d, int elem, void* stream) {
  if (n_rows < 1 || b < 1 || k < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* ids = static_cast<const int32_t*>(idx);
  const float* qf = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 0) return dispatch<__nv_bfloat16>(vectors, ids, qf, o, n_rows, b, k, d, s);
  if (elem == 1) return dispatch<int8_t>(vectors, ids, qf, o, n_rows, b, k, d, s);
  if (elem == 2) return dispatch<float>(vectors, ids, qf, o, n_rows, b, k, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
