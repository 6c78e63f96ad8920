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

// The producer's loads of a tile and a consumer warpgroup's attention
// over it live in fat_attention.cuh, shared with kernel 8
// (fat_attention_proj.cu); this file holds the loop over tiles and the
// epilogue.

#include "fat_attention.cuh"

namespace {

using namespace fat;

template <int CP>
__global__ void __launch_bounds__(NT, 1)
fat_attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int B,
                     int SP, int H, int D) {
  using L = Layout<CP>;
  extern __shared__ unsigned char smem_raw[];
  // the tile buffers, then their barriers
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t buf = raw + ((1024u - (raw & 1023u)) & 1023u);
  const Tile sm = tile_smem<CP>(buf, buf + L::BYTES);

  const int nq = (SP + BQ - 1) / BQ, nkv = (SP + BKV - 1) / BKV, tiles = B * H * nq;
  if (threadIdx.x == 0) {
    init_tile_barriers(sm);
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
        load_tile<CP>(sm, &tq, &tk, &tv, b, col, qb, nkv, it, n);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    if (wg == 1) bar_arrive<256>(1);  // warpgroup 0 goes first

    int n = 0, it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int bh = tile / nq, qb = tile % nq, b = bh / H, h = bh % H;
      float o[CP / 2], l[2];
      attend_tile<CP>(sm, o, l, it, n, nkv, SP, D, wg);

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
    if (wg == 0) bar_sync<256>(1);  // warpgroup 1's last opening of it
  }
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
