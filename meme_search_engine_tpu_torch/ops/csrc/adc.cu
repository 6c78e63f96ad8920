// Asymmetric distance computation (ADC) over PQ codes for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/adc.py:_adc_gather_kernel
// behind adc_scores_pallas, which ProductQuantizer.asymmetric_dot calls
// through adc_scores to score a query's LUT against every code of a corpus.
// It computes
//   scores[b, n] = sum over m of LUT[b, m, codes[n, m]]
// with codes (N, M) uint8, LUTs (B, M, C <= 256) fp32, the sum taken in
// fp32. A code >= C scores 0: the LUT is zero-padded to 256 entries per
// chunk in shared memory, as the TPU wrapper pads it, so no code can read
// past it.
//
// Bound on an H100 SXM (3.35 TB/s; 32 shared-memory words a clock on each
// of 132 SMs at 1.98 GHz) at N = 1e6, M = 64: at B = 1 the 64 MB of codes
// and 4 MB of scores take 0.020 ms and the 6.4e7 lookups 0.008 ms, so bytes
// bound it; at B = 64 the 4.1e9 lookups (0.49 ms) bound it, not the 324 MB
// (0.097 ms).
//
// Bank conflicts set the floor of a plain layout: with a chunk's 256
// entries in a row, a lookup's bank is its code mod 32, whatever the chunk,
// and 32 random codes put about 3.5 lookups on the busiest bank, so a warp's
// lookup costs about 3.5 wavefronts (about 0.027 ms at B = 1 and 1.7 ms at
// B = 64 at the shape above).
//
// M a multiple of 32 up to 128, 16-byte aligned codes: adc_rot_kernel. The
// LUT lies chunk-minor in shared memory, (M/32, 256, 32) fp32, so chunk m's
// entries all sit in bank m mod 32. Each lane owns one row and sums it in a
// register; at step j of a group of 32 chunks, lane l looks up chunk
// 32 g + (l XOR j), so one lookup instruction hits 32 distinct banks: one
// wavefront. The lane reads its row's M bytes as 16-byte loads (a warp's 32
// rows are one stretch of 32 M bytes), permutes each group's 32 bytes once
// (words by l / 4, bytes by l mod 4) so that step j takes byte j, and has
// the next rows' loads in flight while it sums these. A CTA of 16 warps
// holds QPC of the B queries' LUTs (up to three: 192 KB at M = 64), filled
// once, 32 chunks at a time, through a (32, 256) staging tile (coalesced
// reads, then a transpose whose reads and writes both hit 32 banks), so
// each code byte loaded serves QPC queries; the grid is (query groups) x
// (row ranges) with the groups fastest, so the groups over one range run
// together and read its codes from L2. About as many CTAs as SMs, each
// taking its rows in turn: a persistent grid.
//
// Measured at N = 1e6, M = 64 on an H100 80GB HBM3 at 700 W: 0.030 ms at
// B = 1, of which the fill takes about 0.003 and the code stream without
// lookups 0.029 (the loop's instructions and the loads' latency, not the
// 0.020 ms of bytes); 0.774 ms at B = 64, where the loop without lookups
// takes 0.307 and the lookups most of the rest, near their 0.49 ms bound.
//
// Other M (8, 16, 48, ...) or unaligned codes: adc_kernel, one query's LUT
// (M, 256) a CTA of 256 threads and a tile of 4,096 rows, a thread a row,
// 16-byte code loads when M % 16 == 0 (byte loads otherwise), the sum in m
// order; its lookups meet the conflicts above.
//
// Offsets are 64-bit: at N = 1e8 rows N * M and B * N overflow int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads a CTA of adc_kernel
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

// ---- M % 32 == 0: conflict-free lookups ----------------------------------

constexpr int RT = 512;     // threads a CTA of adc_rot_kernel: 16 warps
constexpr int MAX_QPC = 3;  // LUTs a CTA holds
constexpr int MAX_GROUPS = 4;  // M / 32 the rotated kernel is compiled for

// row r's M = 32 G bytes as 2 G 16-byte words; zeros past the range
template <int G>
__device__ __forceinline__ void load_row(uint4* w, const uint8_t* codes, long long r,
                                         long long r_end) {
#pragma unroll
  for (int i = 0; i < 2 * G; ++i)
    w[i] = r < r_end ? __ldg(reinterpret_cast<const uint4*>(codes + r * (32 * G)) + i)
                     : make_uint4(0, 0, 0, 0);
}

template <int G, int QPC>
__global__ void __launch_bounds__(RT, 1)
adc_rot_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ luts,
               float* __restrict__ out, long long N, int C, int B, int groups,
               long long rows_per_cta) {
  constexpr int M = 32 * G, LUT = M * LUT_WIDTH;
  extern __shared__ float lut[];  // QPC x (G, 256, 32): entry (m, c) at (m / 32, c, m % 32)
  const int grp = blockIdx.x % groups;
  const long long r_begin = static_cast<long long>(blockIdx.x / groups) * rows_per_cta;
  const long long r_end = min(N, r_begin + rows_per_cta);
  const int q0 = grp * QPC, nq = min(QPC, B - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the first rows' loads go out before the LUTs are filled
  uint4 cur[2 * G], nxt[2 * G];
  long long rb = r_begin + warp * 32;  // this warp's 32 rows
  load_row<G>(cur, codes, rb + lane, r_end);

  // fill, a group of 32 chunks at a time: the group's (32, C) rows into a
  // (32, 256) staging tile (coalesced, zeros past C), then tile entry
  // (mm, c) to LUT index (c, mm), lane l of step i moving (mm, c) =
  // ((i + l) mod 32, 32 cb + l): reads and writes both hit 32 banks
  float* stage = lut + QPC * LUT;
  constexpr int PER = 32 * LUT_WIDTH / RT;  // staging entries a thread
  float v[PER];
  const int rounds = nq * G;
  auto fetch = [&](int rnd) {
    const float* src = luts + (static_cast<long long>(q0 + rnd / G) * M + (rnd % G) * 32) * C;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * RT, m = i >> 8, c = i & 255;
      v[k] = c < C ? __ldg(src + m * C + c) : 0.f;
    }
  };
  if (rounds > 0) fetch(0);
  for (int rnd = 0; rnd < rounds; ++rnd) {
#pragma unroll
    for (int k = 0; k < PER; ++k) stage[threadIdx.x + k * RT] = v[k];
    __syncthreads();
    if (rnd + 1 < rounds) fetch(rnd + 1);
    float* dst = lut + (rnd / G) * LUT + (rnd % G) * LUT_WIDTH * 32;
#pragma unroll 4
    for (int k = 0; k < LUT_WIDTH / 16; ++k) {  // 256 steps of 32 lanes over 16 warps
      const int step = warp + 16 * k, c = (step >> 5) * 32 + lane, mm = (step + lane) & 31;
      dst[c * 32 + mm] = stage[mm * LUT_WIDTH + c];
    }
    __syncthreads();
  }

  // byte k of a permuted word is byte k XOR (lane mod 4) of the original
  const int y = lane & 3, x = lane >> 2;
  const uint32_t sel = y | ((1 ^ y) << 4) | ((2 ^ y) << 8) | ((3 ^ y) << 12);
  for (; rb < r_end; rb += RT) {
    const long long r = rb + lane;
    load_row<G>(nxt, codes, r + RT, r_end);
    float acc[QPC];
#pragma unroll
    for (int q = 0; q < QPC; ++q) acc[q] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t w[8] = {cur[2 * g].x,     cur[2 * g].y,     cur[2 * g].z,     cur[2 * g].w,
                       cur[2 * g + 1].x, cur[2 * g + 1].y, cur[2 * g + 1].z, cur[2 * g + 1].w};
      // word i takes word i XOR (lane / 4), then the bytes: byte j of the
      // group is now the code of chunk 32 g + (lane XOR j)
#pragma unroll
      for (int bit = 4; bit >= 1; bit >>= 1) {
        const bool f = x & bit;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (!(i & bit)) {
            const uint32_t a = w[i], b = w[i | bit];
            w[i] = f ? b : a;
            w[i | bit] = f ? a : b;
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = __byte_perm(w[i], 0, sel);
      const float* lg = lut + g * LUT_WIDTH * 32;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t code = __byte_perm(w[j >> 2], 0, 0x4440 | (j & 3));
        const float* e = lg + code * 32 + (lane ^ j);  // bank lane XOR j
#pragma unroll
        for (int q = 0; q < QPC; ++q) acc[q] += e[q * LUT];
      }
    }
    if (r < r_end)
#pragma unroll
      for (int q = 0; q < QPC; ++q)
        if (q < nq) out[static_cast<long long>(q0 + q) * N + r] = acc[q];
#pragma unroll
    for (int i = 0; i < 2 * G; ++i) cur[i] = nxt[i];
  }
}

template <int G, int QPC>
int launch_rot_kernel(const uint8_t* codes, const float* luts, float* out, long long N, int C,
                      int B, int groups, long long rows_per_cta, unsigned ctas,
                      cudaStream_t stream) {
  const int bytes = (QPC * 32 * G + 32) * LUT_WIDTH * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      adc_rot_kernel<G, QPC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  adc_rot_kernel<G, QPC><<<ctas, RT, bytes, stream>>>(codes, luts, out, N, C, B, groups,
                                                      rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_rot(const uint8_t* codes, const float* luts, float* out, long long N, int C, int B,
               cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // LUTs a CTA holds: as many of M KB as fit in 227 KB beside the 32 KB
  // staging tile, at most MAX_QPC; as few query groups as that allows, as
  // even as they can be
  constexpr int QMAX = 195 / (32 * G) < MAX_QPC ? 195 / (32 * G) : MAX_QPC;
  const long long groups = (B + QMAX - 1) / QMAX;
  const int qpc = static_cast<int>((B + groups - 1) / groups);
  // at most one CTA an SM while the groups are fewer than the SMs (no
  // second wave), each with at least one pass of its 16 warps
  long long splits = groups < sms ? sms / groups : 1;
  const long long most = (N + RT - 1) / RT;
  if (splits > most) splits = most;
  const long long rows_per_cta = ((N + splits - 1) / splits + 31) / 32 * 32;
  splits = (N + rows_per_cta - 1) / rows_per_cta;
  const long long ctas = groups * splits;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int gr = static_cast<int>(groups);
  const unsigned n_ctas = static_cast<unsigned>(ctas);
  if constexpr (QMAX >= 3)
    if (qpc == 3)
      return launch_rot_kernel<G, 3>(codes, luts, out, N, C, B, gr, rows_per_cta, n_ctas, stream);
  if constexpr (QMAX >= 2)
    if (qpc == 2)
      return launch_rot_kernel<G, 2>(codes, luts, out, N, C, B, gr, rows_per_cta, n_ctas, stream);
  return launch_rot_kernel<G, 1>(codes, luts, out, N, C, B, gr, rows_per_cta, n_ctas, stream);
}

}  // namespace

extern "C" {

// out(B, N) fp32 from contiguous codes (N, M) uint8 and LUTs (B, M, C) fp32:
// adc_rot_kernel for M a multiple of 32 up to 128 and 16-byte aligned
// codes, adc_kernel otherwise. Needs 1 <= M <= 227 (the one-query kernel's
// M * 1 KB of shared memory), C <= 256,
// N >= 1, B >= 1 and B * ceil(N / 4096) <= 2^31 - 1 (the grid's CTAs;
// otherwise it returns cudaErrorInvalidConfiguration and launches nothing).
int mse_adc(const void* codes, const void* luts, void* out, long long N, int M, int C,
            int B, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* l = static_cast<const float*>(luts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  if (aligned && M % 32 == 0 && M <= 32 * MAX_GROUPS) {
    switch (M / 32) {
      case 1: return launch_rot<1>(c, l, o, N, C, B, s);
      case 2: return launch_rot<2>(c, l, o, N, C, B, s);
      case 3: return launch_rot<3>(c, l, o, N, C, B, s);
      default: return launch_rot<4>(c, l, o, N, C, B, s);
    }
  }
  if (aligned && M % 16 == 0) return launch<true>(c, l, o, N, M, C, B, s);
  return launch<false>(c, l, o, N, M, C, B, s);
}

}  // extern "C"
