// Row gather for the Vamana build on Hopper (sm_90a).
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/gather.py:_gather_flat
// behind gather_rows, which the build calls at its three row gathers
// (index/vamana.py: each greedy-search hop, the robust prune's candidate
// block, the overflow re-prune). It computes
//   out[m] = vectors[clamp(idx[m], 0, N - 1)]   for m < M
// with vectors (N, row_bytes) and idx (M,) int32, copying each row bit for
// bit whatever its element type (bf16 and int8 in the build). An id out of
// range is clamped, as XLA's gather clamps it; the callers mask invalid ids
// to 0 before the call.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At the build's hop shape
// (M = 1024 x 128 ids, rows of 1152 bf16 = 2,304 B) the output is 302 MB and
// the rows read at most as much again, so 0.09-0.18 ms depending on how
// often ids repeat; at the prune shape (M = 1024 x 750) 1.77 GB each way.
//
// Design: one warp copies one row at a time. Lane 0 reads the row's id once
// and broadcasts it with a shuffle; the 32 lanes then copy the row in words
// of W bytes, W the widest of 16, 8, 4, 2 and 1 that divides the row's bytes
// and both base addresses (so a 2,304 B row is 144 16-byte words, 4.5 a
// lane). Each lane issues up to UNROLL loads before its stores, so a warp
// keeps several of its row's reads in flight. Blocks of 8 warps stride over
// the rows; offsets are 64-bit (a 1e6 x 1152 bf16 corpus is 2.3 GB).
// Nothing is staged through shared memory: a copy gains nothing from it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads a block: 8 warps
constexpr int WARPS = NT / 32;
constexpr int UNROLL = 4;          // words a lane loads before it stores
constexpr long long MAX_BLOCKS = 1 << 20;

template <typename T>
__global__ void __launch_bounds__(NT) gather_kernel(const T* __restrict__ vectors,
                                                    const int32_t* __restrict__ idx,
                                                    T* __restrict__ out, long long n_rows,
                                                    long long m_rows, long long words) {
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long m = warp; m < m_rows; m += stride) {
    long long id = 0;
    if (lane == 0) id = __ldg(idx + m);
    id = __shfl_sync(0xffffffffu, id, 0);
    id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
    const T* src = vectors + id * words;
    T* dst = out + m * words;
    for (long long w0 = lane; w0 < words; w0 += 32 * UNROLL) {
      T v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long w = w0 + 32LL * u;
        if (w < words) v[u] = __ldg(src + w);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long w = w0 + 32LL * u;
        if (w < words) dst[w] = v[u];
      }
    }
  }
}

template <typename T>
int launch(const void* vectors, const int32_t* idx, void* out, long long n_rows,
           long long m_rows, long long row_bytes, cudaStream_t stream) {
  long long blocks = (m_rows + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  gather_kernel<T><<<static_cast<unsigned>(blocks), NT, 0, stream>>>(
      static_cast<const T*>(vectors), idx, static_cast<T*>(out), n_rows, m_rows,
      row_bytes / static_cast<long long>(sizeof(T)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (M, row_bytes) from contiguous vectors (N, row_bytes) and idx (M,)
// int32, ids clamped into [0, N - 1]. Needs N >= 1, M >= 1 and
// row_bytes >= 1; otherwise it returns cudaErrorInvalidValue and launches
// nothing.
int mse_gather_rows(const void* vectors, const void* idx, void* out, long long n_rows,
                    long long m_rows, long long row_bytes, void* stream) {
  if (n_rows < 1 || m_rows < 1 || row_bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* ids = static_cast<const int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(vectors) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(vectors, ids, out, n_rows, m_rows, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(vectors, ids, out, n_rows, m_rows, row_bytes, s);
  if (align % 4 == 0) return launch<unsigned int>(vectors, ids, out, n_rows, m_rows, row_bytes, s);
  if (align % 2 == 0) return launch<unsigned short>(vectors, ids, out, n_rows, m_rows, row_bytes, s);
  return launch<unsigned char>(vectors, ids, out, n_rows, m_rows, row_bytes, s);
}

}  // extern "C"
