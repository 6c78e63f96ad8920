// Device code of the fat-layout attention on Hopper (sm_90a), shared by
// fat_attention.cu (kernels 6 and 7: the attention alone; its header holds
// the design notes) and fat_attention_proj.cu (kernel 8: the attention
// fused with the o-projection and the residual): the shared-memory layout
// of a (128-row query block, head) tile, the producer's TMA loads of one
// tile, and a consumer warpgroup's attention over its 64 rows of the tile
// up to the unnormalised O and the row sums l. Each kernel writes its own
// epilogue.
//
// Fat layout: each head owns C = fat_width(d) columns, d features plus a
// constant column at index d. q is pre-scaled by 1/sqrt(d) and its
// constant is 1; k's constant is 0 on valid rows and -1e30 on pad rows, so
// Q.K^T yields masked scores directly; v's constant is 1, so column d of
// P.V is the softmax sum l of the bf16-rounded P (attention.py:283-289).

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace {

namespace fat {

typedef __nv_bfloat16 bf16;

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

// the shared-memory addresses of the tile buffers (Q buffers, K stages,
// V stages, each on a 1024-byte boundary: the 32-byte swizzle repeats
// every 256 B and TMA and wgmma both read it from the address) and of
// their barriers
struct Tile {
  uint32_t q0, k0, v0, q_full, q_empty, k_full, k_empty, v_full, v_empty;
};

// buf: 1024-byte aligned, Layout<CP>::BYTES long; bar: Layout<CP>::BARS
// barriers
template <int CP>
__device__ __forceinline__ Tile tile_smem(uint32_t buf, uint32_t bar) {
  using L = Layout<CP>;
  Tile t;
  t.q0 = buf;
  t.k0 = buf + 2 * L::Q_BYTES;
  t.v0 = t.k0 + STAGES * L::KV_BYTES;
  t.q_full = bar;
  t.q_empty = bar + 16;
  t.k_full = bar + 32;
  t.k_empty = t.k_full + 8 * STAGES;
  t.v_full = t.k_empty + 8 * STAGES;
  t.v_empty = t.v_full + 8 * STAGES;
  return t;
}

// by one thread, before the block's first barrier
__device__ __forceinline__ void init_tile_barriers(const Tile& t) {
  for (int i = 0; i < 2; ++i) {
    mbar_init(t.q_full + 8 * i, 1);   // the producer's expect_tx arrival
    mbar_init(t.q_empty + 8 * i, 2);  // one arrival per consumer warpgroup
  }
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(t.k_full + 8 * s, 1);
    mbar_init(t.k_empty + 8 * s, 2);
    mbar_init(t.v_full + 8 * s, 1);
    mbar_init(t.v_empty + 8 * s, 2);
  }
}

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

// a K-major operand of 32-byte swizzled 16-column slabs (rows of 32 B)
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

// The producer's loads of one tile, by one thread: its Q (128 rows at
// query block qb, columns col.. of image b) into buffer it & 1, then its
// nkv key tiles of K and V into the rings. n: key tiles loaded before this
// tile (advanced by nkv); it: tiles loaded before this one.
template <int CP>
__device__ __forceinline__ void load_tile(const Tile& sm, const CUtensorMap* tq,
                                          const CUtensorMap* tk, const CUtensorMap* tv, int b,
                                          int col, int qb, int nkv, int it, int& n) {
  using L = Layout<CP>;
  const int qi = it & 1;
  mbar_wait(sm.q_empty + 8 * qi, ((it >> 1) & 1) ^ 1);
  mbar_expect_tx(sm.q_full + 8 * qi, L::Q_BYTES);
#pragma unroll
  for (int sl = 0; sl < CP / 16; ++sl)
    tma_load(sm.q0 + qi * L::Q_BYTES + sl * L::Q_SLAB, tq, col + 16 * sl, qb * BQ, b,
             sm.q_full + 8 * qi);
  for (int j = 0; j < nkv; ++j, ++n) {
    const int st = n % STAGES;
    const uint32_t ph = ((n / STAGES) & 1) ^ 1;
    mbar_wait(sm.k_empty + 8 * st, ph);
    mbar_expect_tx(sm.k_full + 8 * st, L::KV_BYTES);
#pragma unroll
    for (int sl = 0; sl < CP / 16; ++sl)
      tma_load(sm.k0 + st * L::KV_BYTES + sl * L::KV_SLAB, tk, col + 16 * sl, j * BKV, b,
               sm.k_full + 8 * st);
    mbar_wait(sm.v_empty + 8 * st, ph);
    mbar_expect_tx(sm.v_full + 8 * st, L::KV_BYTES);
#pragma unroll
    for (int sl = 0; sl < CP / 16; ++sl)
      tma_load(sm.v0 + st * L::KV_BYTES + sl * L::KV_SLAB, tv, col + 16 * sl, j * BKV, b,
               sm.v_full + 8 * st);
  }
}

// Consumer warpgroup wg's attention over its 64 rows of one tile: leaves
// the fp32 O (64 x CP, not yet divided by l) in o and each of this
// thread's two rows' l (O[:, D], v's ones column) in l, and releases the
// tile's buffers. it, n: as load_tile's (n advanced by nkv). The two
// consumer warpgroups take turns on the tensor cores through named
// barriers 1 and 2; warpgroup 1 opens warpgroup 0's turn before its first
// tile and warpgroup 0 takes its last opening after its last tile.
// OVERLAP: the softmax of key tile j runs while P_{j-1}.V_{j-1} does
// (ptxas then serialises every wgmma of the kernel, C7513); else after it.
template <int CP, bool OVERLAP = true>
__device__ __forceinline__ void attend_tile(const Tile& sm, float (&o)[CP / 2], float (&l)[2],
                                            int it, int& n, int nkv, int SP, int D, int wg) {
  using L = Layout<CP>;
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int q = lane & 3;
  const bool leader = tid == 0;
  // the tensor cores' turn: named barrier 1 + w is warpgroup w's; each
  // waits for its own before it issues and then opens the other's
  const int mine = 1 + wg, other = 2 - wg;
  const int qi = it & 1;
  // this warpgroup's rows of the Q buffer
  const uint64_t dq = kmajor_desc(sm.q0 + qi * L::Q_BYTES + wg * 64 * 32);
  float s[64], m[2], corr[2];
  uint32_t pc[8][4], pn[8][4];  // P of the tile in P.V, P of the next
  mbar_wait(sm.q_full + 8 * qi, (it >> 1) & 1);

  // key tile 0: S, then its softmax
  int st = n % STAGES;
  uint64_t dk = kmajor_desc(sm.k0 + st * L::KV_BYTES);
  mbar_wait(sm.k_full + 8 * st, (n / STAGES) & 1);
  bar_sync<256>(mine);
  wgmma_fence();
  issue_s<CP>(s, dq, dk);
  wgmma_commit();
  bar_arrive<256>(other);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(s[i]);
  if (leader) {
    mbar_arrive(sm.k_empty + 8 * st);
    if (nkv == 1) mbar_arrive(sm.q_empty + 8 * qi);
  }
  softmax(s, pc, m, corr, 0, SP, q, true);

  // key tile j: S_j and P_{j-1}.V_{j-1} issued together in this
  // warpgroup's turn; the softmax of S_j runs while the other
  // warpgroup's products do
  for (int j = 1; j < nkv; ++j) {
    const int sk = (n + j) % STAGES, sv = (n + j - 1) % STAGES;
    mbar_wait(sm.k_full + 8 * sk, ((n + j) / STAGES) & 1);
    mbar_wait(sm.v_full + 8 * sv, ((n + j - 1) / STAGES) & 1);
    uint32_t acc = j > 1;
    dk = kmajor_desc(sm.k0 + sk * L::KV_BYTES);
    const uint64_t dv = v_desc(sm.v0 + sv * L::KV_BYTES);
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
    if (OVERLAP) {
      wgmma_wait<1>();  // S_j is done
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(s[i]);
      if (leader) {
        mbar_arrive(sm.k_empty + 8 * sk);
        if (j == nkv - 1) mbar_arrive(sm.q_empty + 8 * qi);
      }
      softmax(s, pn, m, corr, j * BKV, SP, q, false);
      wgmma_wait<0>();  // P_{j-1}.V_{j-1} is done
#pragma unroll
      for (int i = 0; i < CP / 2; ++i) fence_operand(o[i]);
      if (leader) mbar_arrive(sm.v_empty + 8 * sv);
#pragma unroll
      for (int i = 0; i < CP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) pc[kk][t] = pn[kk][t];
    } else {
      wgmma_wait<0>();  // S_j and P_{j-1}.V_{j-1} are done
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(s[i]);
#pragma unroll
      for (int i = 0; i < CP / 2; ++i) fence_operand(o[i]);
      if (leader) {
        mbar_arrive(sm.k_empty + 8 * sk);
        if (j == nkv - 1) mbar_arrive(sm.q_empty + 8 * qi);
        mbar_arrive(sm.v_empty + 8 * sv);
      }
      softmax(s, pc, m, corr, j * BKV, SP, q, false);
#pragma unroll
      for (int i = 0; i < CP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    }
  }

  // the last P.V
  st = (n + nkv - 1) % STAGES;
  const uint64_t dv = v_desc(sm.v0 + st * L::KV_BYTES);
  uint32_t acc = nkv > 1;
  mbar_wait(sm.v_full + 8 * st, ((n + nkv - 1) / STAGES) & 1);
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
  if (leader) mbar_arrive(sm.v_empty + 8 * st);
  n += nkv;

  // l = O[:, D] (v's ones column), held by quad lane (D % 8) / 2
  l[0] = 0.f;
  l[1] = 0.f;
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
}

// a 3-D map over (images, rows, cols) bf16 with the given element strides
// of a row and an image, boxes of 16 columns x 128 rows, 32-byte swizzled;
// reads past the last row give 0
int make_map(CUtensorMap* map, const void* base, int images, int rows, int cols,
             long long row_stride, long long batch_stride) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(images)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {16, BQ, 1};
  return tensor_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace fat

}  // namespace
