// Gathered Gram matrices for the Vamana build's robust prune on Hopper
// (sm_90a).
//
// Replaces, with gather_dot.cu, the TPU kernel
//   meme_search_engine_tpu/ops/gather.py:_gather_flat
// behind gather_rows, together with the product the JAX package runs on the
// prune's gathered candidate block (index/vamana.py, _batched_robust_prune:
// einsum("bcd,bed->bce") of bf16 or int8 rows with
// preferred_element_type=f32). It computes
//   pair[b] = float(V[ids[b]]) . float(V[ids[b]])^T      (C, C) fp32
// with V (N, D) bf16 or int8, ids (B, C) int32 clamped into [0, N - 1] as
// gather_rows clamps them. bf16 x bf16 products are exact in fp32, so the
// tensor cores' fp32 accumulation is the reference's arithmetic up to the
// order of the sum; int8 rows multiply as s8 with s32 accumulators, exact,
// converted to fp32 at the end.
//
// Bound on an H100 SXM at the prune's shape (B 1024, C 750, D 1152 bf16):
// the 2.3 GB of fp32 output and the up to 112 MB of distinct rows take
// 0.72 ms at 3.35 TB/s; the B C (C + 1) / 2 dots this kernel computes,
// 0.67 TFLOP, take 0.67 ms at 989 TFLOP/s. So bytes bound it, closely.
//
// Design: the gathered rows go from device memory straight into shared
// memory and from there into wgmma; nothing but the Gram is written out.
//   - One CTA per (b, 128 x 128 tile on or above the diagonal): C = 750 is
//     6 x 6 tiles, of which 21 are computed; each is stored twice, as
//     itself and transposed, so the products are halved. A diagonal tile
//     stores only its upper half and mirrors it, so pair[b] is exactly
//     symmetric. The tiles of one b are adjacent in the grid, so the rows
//     they share are read from L2 (each b's rows about 6 times: 10.6 MB of
//     L2 reads a b at C = 750, against 1.7 MB of distinct rows).
//   - Warps 8 and 9 are the producers. Each reads its half of the tile's
//     2 x 128 ids once (clamped) and gathers, per stage, 128 bytes of each
//     of its rows (64 bf16 or 128 int8 columns) into a three-stage ring of
//     128-byte-swizzled tiles (row r's 16-byte chunk c at
//     r * 128 + 16 (c ^ r % 8)); a diagonal tile loads one operand. TMA
//     has no row gather, so 8 lanes copy a row's 128 bytes as 16-byte
//     cp.async with the XOR in the address, each lane holding its 32 rows'
//     addresses in registers for the tile (one-row TMA boxes also land
//     swizzled, but the TMA unit issues them 2.3x more slowly: PERF.md,
//     section 6); a row that is not a multiple of 16 bytes (int8 D = 72) takes
//     8- or 4-byte cp.async, one of 2 or 1 bytes plain loads; bytes past
//     the row or past C are zero-filled by cp.async's source size. After a
//     stage's copies have landed (cp.async.wait_group, one stage behind),
//     each lane fences them to the async proxy that wgmma reads through and
//     arrives on the stage's full mbarrier.
//   - Warpgroups 0 and 1 each compute 64 rows x 128 columns: 4 wgmma a
//     stage (m64n128k16 bf16, or m64n128k32 s8), both operands K-major from
//     the swizzled ring, 64 fp32 or s32 accumulators a thread; a stage is
//     released on its empty mbarrier once the next stage's products are
//     issued and its own are done.
//   - The epilogue stages the tile in the ring, now idle, as 128 rows of
//     129 floats, then stores it and its transpose row by row: a warp
//     writes 32 neighbouring floats an instruction, and reads its column
//     of the staged tile free of bank conflicts (stores straight from the
//     accumulators touched eight 32-byte sectors an instruction). Offsets
//     are 64-bit (B C^2 passes 2^31).
//   - Two CTAs share an SM (99 KB of shared memory each), so one's stores
//     run under the other's products.
//   - What binds (the kernel timed with parts cut out; PERF.md, section 6):
//     the loads, the 10.9 GB of rows read again from L2 at the prune's
//     shape, then the stores; the products hide under both.
//   - Every mbarrier wait traps after 2^26 polls (hopper.cuh), so a broken
//     ring fails the launch rather than hanging the card.

#include "hopper.cuh"

namespace {

constexpr int BT = 128;             // rows and columns of a Gram tile
constexpr int RB = 128;             // bytes of each row a stage holds
constexpr int STAGES = 3;
constexpr int OPERAND = BT * RB;    // one operand's rows of a stage: 16 KB
constexpr int STAGE = 2 * OPERAND;
constexpr int PRODUCERS = 2;        // producer warps
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int NT = CONSUMERS + 32 * PRODUCERS;
constexpr int PITCH = BT + 1;       // floats a row of the staged tile
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * BT * 8 + 2 * STAGES * 8;
constexpr long long MAX_GRID = 2147483647LL;
static_assert(BT * PITCH * 4 <= STAGES * STAGE, "the staged tile fits in the ring");

// -- copies ------------------------------------------------------------------

template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, uint32_t src_bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(W),
                 "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// order this thread's generic-proxy accesses to shared memory (the landed
// cp.async copies, plain stores) with wgmma's async-proxy ones
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A producer warp's rows of one operand: with pw its index, lane l takes
// rows 8i + 4 pw + l / 8 (i < 16), so the two warps split each operand.
__device__ __forceinline__ int producer_row(int i, int pw, int lane) {
  return 8 * i + 4 * pw + (lane >> 3);
}

// One operand of one stage by cp.async: the producer warp's 64 rows x 128
// bytes from row byte kb0 on, in words of W bytes (W divides the row's
// bytes and the corpus base); lane l copies chunk l % 8 of its rows, chunk
// c of row r landing at r * 128 + 16 (c ^ r % 8), the 128-byte swizzle.
// offs[r] is the row's byte offset in the corpus, -1 for a row past C
// (zero-filled).
template <int W>
__device__ __forceinline__ void copy_rows(uint32_t dst0, unsigned char* dst0_ptr,
                                          const long long* offs, const unsigned char* v,
                                          long long row_bytes, long long kb0, int pw, int lane) {
  const int chunk = lane & 7;
#pragma unroll 4
  for (int i = 0; i < BT / 8; ++i) {
    const int r = producer_row(i, pw, lane);
    const long long off = offs[r];
    const uint32_t at = r * RB + ((chunk ^ (r & 7)) << 4);
#pragma unroll
    for (int p = 0; p < 16 / W; ++p) {
      const long long kb = kb0 + chunk * 16 + p * W;
      const bool in = off >= 0 && kb < row_bytes;  // a word is all in or all out
      const unsigned char* src = in ? v + off + kb : v;
      if constexpr (W >= 4) {
        cp_async<W>(dst0 + at + p * W, src, in ? W : 0);
      } else if constexpr (W == 2) {
        *reinterpret_cast<unsigned short*>(dst0_ptr + at + p * W) =
            in ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
      } else {
        dst0_ptr[at + p] = in ? __ldg(src) : 0;
      }
    }
  }
}

// The producer warp's rows of a tile as 16-byte cp.async (W = 16 and a
// corpus under 64 GB: the build's rows), with the per-row work done once a
// tile: each lane holds its 32 rows' offsets (16 of each block) in
// registers, in 16-byte units, and a mask bit of the rows below C. A stage
// is then, per row, one wide multiply-add, a select and the copy, whose
// destination is an immediate offset of the lane's: lane l's row
// r = 8i + 4 pw + l / 8 lands at r * 128 + 16 (c ^ r % 8) = 1024 i + that
// of i = 0, with c = l % 8.
constexpr long long MAX_FAST_CORPUS = 1LL << 36;

struct Rows16 {
  uint32_t off16[2 * BT / 8];
  uint32_t live;   // bit i: row i lies below C
  uint32_t dst;    // the lane's offset in an operand, row i = 0

  __device__ __forceinline__ Rows16(const long long* offs, int pw, int lane) {
    const int chunk = lane & 7, r0 = producer_row(0, pw, lane);
    dst = r0 * RB + ((chunk ^ (r0 & 7)) << 4);
    live = 0;
#pragma unroll
    for (int i = 0; i < 2 * BT / 8; ++i) {
      const long long off = offs[(i / (BT / 8)) * BT + producer_row(i % (BT / 8), pw, lane)];
      live |= static_cast<uint32_t>(off >= 0) << i;
      off16[i] = static_cast<uint32_t>((off >= 0 ? off : 0) >> 4);
    }
  }

  // row bytes [kb0, kb0 + 128) of the lane's rows of both blocks (of block
  // A alone on a diagonal tile) into the stage at sa
  __device__ __forceinline__ void copy(uint32_t sa, const unsigned char* v, long long kb0,
                                       long long row_bytes, int lane, bool diag) const {
    const unsigned char* base = v + kb0 + (lane & 7) * 16;
    const uint32_t in = kb0 + (lane & 7) * 16 < row_bytes ? 16 : 0;
#pragma unroll
    for (int i = 0; i < 2 * BT / 8; ++i) {
      if (i == BT / 8 && diag) break;
      const uint32_t at = sa + (i / (BT / 8)) * OPERAND + 1024 * (i % (BT / 8)) + dst;
      cp_async<16>(at, base + 16ull * off16[i], ((live >> i) & 1) ? in : 0);
    }
  }
};

__device__ __forceinline__ void copy_operand(int word, uint32_t dst0, unsigned char* dst0_ptr,
                                             const long long* offs, const unsigned char* v,
                                             long long row_bytes, long long kb0, int pw,
                                             int lane) {
  switch (word) {
    case 16: copy_rows<16>(dst0, dst0_ptr, offs, v, row_bytes, kb0, pw, lane); break;
    case 8: copy_rows<8>(dst0, dst0_ptr, offs, v, row_bytes, kb0, pw, lane); break;
    case 4: copy_rows<4>(dst0, dst0_ptr, offs, v, row_bytes, kb0, pw, lane); break;
    case 2: copy_rows<2>(dst0, dst0_ptr, offs, v, row_bytes, kb0, pw, lane); break;
    default: copy_rows<1>(dst0, dst0_ptr, offs, v, row_bytes, kb0, pw, lane); break;
  }
}

// -- products -----------------------------------------------------------------

#define R8(i)                                                                             \
  "+r"(d[i]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), "+r"(d[(i) + 4]), \
      "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])

// D(64 x 128, s32) += A(64 x 32) B(32 x 128), s8 operands from shared
// memory, both K-major (the one layout wgmma takes for 8-bit integers);
// the accumulator layout is Mma's
__device__ __forceinline__ void mma_s8_n128(uint32_t* d, uint64_t da, uint64_t db,
                                            int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef R8

template <bool INT8>
struct Gram;
template <>
struct Gram<false> {  // bf16 rows: 64 columns a stage, 16 a wgmma
  using Acc = float;
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    Mma<128, 0>::ss(d, da, db);
  }
  static __device__ __forceinline__ float value(float a) { return a; }
};
template <>
struct Gram<true> {  // int8 rows: 128 columns a stage, 32 a wgmma
  using Acc = uint32_t;
  static __device__ __forceinline__ void mma(uint32_t* d, uint64_t da, uint64_t db) {
    mma_s8_n128(d, da, db);
  }
  static __device__ __forceinline__ float value(uint32_t a) {
    return __int2float_rn(static_cast<int>(a));
  }
};

template <bool INT8>
__global__ void __launch_bounds__(NT, 2)
gram_kernel(const unsigned char* __restrict__ vectors, const int32_t* __restrict__ ids,
            float* __restrict__ out, long long n_rows, int c, long long row_bytes, int tiles,
            int word) {
  using G = Gram<INT8>;
  extern __shared__ unsigned char smem_raw[];
  // the ring's stages on a 1024-byte boundary (the swizzle repeats every 8
  // rows of 128 B, and wgmma takes it from the address), then the two
  // blocks' rows, then the full and empty barriers
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t s0 = raw + pad;
  unsigned char* s0_ptr = smem_raw + pad;
  long long* offs = reinterpret_cast<long long*>(s0_ptr + STAGES * STAGE);
  const uint32_t full0 = s0 + STAGES * STAGE + 2 * BT * 8, empty0 = full0 + STAGES * 8;

  // this CTA's tile: b, then (ti, tj), ti <= tj, row by row of the upper
  // triangle
  const int pairs = tiles * (tiles + 1) / 2;
  const long long b = blockIdx.x / pairs;
  int p = blockIdx.x % pairs, ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const bool diag = ti == tj;
  const int ks = static_cast<int>((row_bytes + RB - 1) / RB);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32 * PRODUCERS);  // every producer lane
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warp pw: the byte offsets of its rows of both blocks (-1
    // past C), then the ring
    const int lane = threadIdx.x & 31, pw = (threadIdx.x - CONSUMERS) >> 5;
    for (int i = 0; i < 2 * BT / 8; ++i) {
      const int rr = producer_row(i % (BT / 8), pw, lane), blk = i / (BT / 8);
      const int r = (blk ? tj : ti) * BT + rr;
      long long off = -1;
      if (r < c) {
        long long id = __ldg(ids + b * c + r);
        id = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
        off = id * row_bytes;
      }
      if ((lane & 7) == 0) offs[blk * BT + rr] = off;
    }
    __syncwarp();
    const bool fast = word == 16 && n_rows * row_bytes < MAX_FAST_CORPUS;
    const Rows16 rows16(offs, pw, lane);
    for (int s = 0; s < ks; ++s) {
      const int slot = s % STAGES;
      if (s >= STAGES) mbar_wait(empty0 + 8 * slot, (s / STAGES - 1) & 1);
      const uint32_t sa = s0 + slot * STAGE;
      unsigned char* sa_ptr = s0_ptr + slot * STAGE;
      const long long kb0 = static_cast<long long>(s) * RB;
      if (fast) {
        rows16.copy(sa, vectors, kb0, row_bytes, lane, diag);
      } else {
        copy_operand(word, sa, sa_ptr, offs, vectors, row_bytes, kb0, pw, lane);
        if (!diag)
          copy_operand(word, sa + OPERAND, sa_ptr + OPERAND, offs + BT, vectors, row_bytes, kb0,
                       pw, lane);
      }
      cp_async_commit();
      if (s > 0) {  // the stage before this one has landed
        cp_async_wait<1>();
        fence_async_shared();
        mbar_arrive(full0 + 8 * ((s - 1) % STAGES));
      }
    }
    cp_async_wait<0>();
    fence_async_shared();
    mbar_arrive(full0 + 8 * ((ks - 1) % STAGES));
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  typename G::Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
    fence_operand(acc[i]);
  }
  int prev = -1;
  for (int s = 0; s < ks; ++s) {
    const int slot = s % STAGES;
    mbar_wait(full0 + 8 * slot, (s / STAGES) & 1);
    fence_async_shared();
    const uint32_t sa = s0 + slot * STAGE, sb = diag ? sa : sa + OPERAND;
    const uint64_t da = smem_desc(sa + wg * 64 * RB, 16, 1024);
    const uint64_t db = smem_desc(sb, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) G::mma(acc, da + kk * (32 >> 4), db + kk * (32 >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (prev >= 0 && leader) mbar_arrive(empty0 + 8 * prev);
    prev = slot;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(acc[i]);

  // the tile into the idle ring once both warpgroups' products are done:
  // acc[4j + t] is row 16 warp + g (+ 8 for t >= 2) of this warpgroup's 64,
  // column 8j + 2q + (t & 1)
  float* tile = reinterpret_cast<float*>(s0_ptr);
  fence_async_shared();
  bar_sync<CONSUMERS>(1);
  const int lr0 = 64 * wg + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      tile[(lr0 + (t >> 1) * 8) * PITCH + 8 * j + 2 * q + (t & 1)] = G::value(acc[4 * j + t]);
  bar_sync<CONSUMERS>(1);

  // stores: warp cw writes tile rows cw, cw + 8, ... to pair[b] (columns
  // on or above the diagonal on a diagonal tile), then tile columns cw,
  // cw + 8, ... to the rows of the transposed tile (strictly above it)
  float* ob = out + b * c * c;
  const int cw = threadIdx.x >> 5;
  for (int lr = cw; lr < BT && ti * BT + lr < c; lr += CONSUMERS / 32) {
    float* orow = ob + static_cast<long long>(ti * BT + lr) * c + tj * BT;
#pragma unroll
    for (int u = 0; u < BT / 32; ++u) {
      const int lc = lane + 32 * u;
      if (tj * BT + lc < c && (!diag || lr <= lc)) orow[lc] = tile[lr * PITCH + lc];
    }
  }
  for (int lc = cw; lc < BT && tj * BT + lc < c; lc += CONSUMERS / 32) {
    float* orow = ob + static_cast<long long>(tj * BT + lc) * c + ti * BT;
#pragma unroll
    for (int u = 0; u < BT / 32; ++u) {
      const int lr = lane + 32 * u;
      if (ti * BT + lr < c && (!diag || lr < lc)) orow[lr] = tile[lr * PITCH + lc];
    }
  }
}

template <bool INT8>
int launch(const void* vectors, const int32_t* ids, float* out, long long n_rows, int b, int c,
           long long row_bytes, cudaStream_t stream) {
  const int tiles = (c + BT - 1) / BT;
  const long long grid = static_cast<long long>(b) * (tiles * (tiles + 1) / 2);
  if (grid > MAX_GRID) return static_cast<int>(cudaErrorInvalidValue);
  // the widest word that divides the row's bytes and the corpus base
  const uintptr_t align = reinterpret_cast<uintptr_t>(vectors) | static_cast<uintptr_t>(row_bytes);
  const int word = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : align % 2 == 0 ? 2 : 1;
  cudaError_t err = cudaFuncSetAttribute(gram_kernel<INT8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_kernel<INT8><<<static_cast<unsigned>(grid), NT, SMEM, stream>>>(
      static_cast<const unsigned char*>(vectors), ids, out, n_rows, c, row_bytes, tiles, word);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pair (B, C, C) fp32 from contiguous vectors (N, D) and ids (B, C) int32;
// elem 0 bf16, 1 int8; row_bytes = D * element size. Needs N >= 1, B >= 1,
// C >= 1 and row_bytes >= 1; otherwise, or for another element type, it
// returns cudaErrorInvalidValue and launches nothing.
int mse_gather_gram(const void* vectors, const void* ids, void* out, long long n_rows, int b,
                    int c, long long row_bytes, int elem, void* stream) {
  if (n_rows < 1 || b < 1 || c < 1 || row_bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* i = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 0) return launch<false>(vectors, i, o, n_rows, b, c, row_bytes, s);
  if (elem == 1) return launch<true>(vectors, i, o, n_rows, b, c, row_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
