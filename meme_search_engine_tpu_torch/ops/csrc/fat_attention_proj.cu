// Fat-layout ViT self-attention fused with the o-projection and the
// residual add, for the SigLIP image tower on Hopper (sm_90a):
//   out = res + attention(qkvf) @ Wo + bo
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/attention.py:fat_vit_mha_packed_proj
//   (_fat_vit_proj_kernel)
// as an op: the JAX package keeps it beside kernels 7 + 2 (fat_vit_mha_packed,
// then matmul_residual) and no model path calls it; neither does the port's.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at B=128,
// SP=736, H=16, C=80, H*D = DM = 1152: 355 GFLOP of attention and 250 GFLOP
// of projection (0.61 ms) against 1.09 GB of qkvf, res, Wo and the output
// (0.33 ms), so operations bound it.
//
// Design: one CTA of four warps per (image, 64-row query block). For each
// head in turn it runs fat::attend_head (fat_attention.cuh, the streaming
// attention of kernel 7) and rounds O / l to bf16 into a (64, H*D) scratch
// in shared memory, the cast point of the reference's VMEM scratch
// (attention.py:413-415), so the attention output never goes to device
// memory. Then the block multiplies that scratch by Wo: 128-column output
// passes, each warp a 64x32 tile of mma.sync m16n8k16 products with fp32
// accumulators, A read by ldmatrix straight from the scratch, Wo streamed
// in 32-row K slices through a 4-stage cp.async ring that reuses the
// attention's staging memory. The epilogue adds bo and res in fp32 and
// writes bf16. At SO400M the scratch takes 148 KB and the block 205 KB,
// so one CTA runs per SM, and every CTA reads all of Wo (2.65 MB) from L2.
// wgmma, TMA and more warps per SM are later work.

#include "fat_attention.cuh"

namespace {

using fat::bf16;

constexpr int BN = 128, BK = 32, STAGES = 4;
constexpr int WS = BN + 8;  // shared row stride of a Wo tile (bf16): 272 B
constexpr int W_TILE = BK * WS;
constexpr int W_RING_BYTES = STAGES * W_TILE * static_cast<int>(sizeof(bf16));

template <int CP>
constexpr int staging_bytes() {
  return fat::attention_smem_bytes<CP>() > W_RING_BYTES ? fat::attention_smem_bytes<CP>()
                                                         : W_RING_BYTES;
}

// HD = H*D (a multiple of 16), DM a multiple of 8; the scratch row stride
// HD + 8 keeps its ldmatrix rows on distinct banks.
template <int CP>
__global__ void __launch_bounds__(fat::NT)
fat_attention_proj_kernel(const bf16* __restrict__ qkvf, const bf16* __restrict__ wo,
                          const bf16* __restrict__ bo, const bf16* __restrict__ res,
                          bf16* __restrict__ out, int SP, int H, int C, int D, int DM) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HD = H * D, SS = HD + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem);  // (BQ, SS) attention output
  bf16* stage = sA + fat::BQ * SS;           // attention staging, then the Wo ring

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * fat::BQ, b = blockIdx.y;
  const long long row3 = 3LL * H * C;  // qkvf row stride
  const bf16* base = qkvf + (long long)b * SP * row3;

  for (int h = 0; h < H; ++h) {
    const long long col = (long long)h * C;
    fat::attend_head<CP>(base + col, base + H * C + col, base + 2 * H * C + col, row3, row3,
                         row3, q0, SP, C, D, stage, [&](int r, int c, float val) {
                           sA[r * SS + h * D + c] = __float2bfloat16(val);
                         });
  }

  // out(64, DM) = sA(64, HD) @ Wo(HD, DM) + bo + res, in passes of BN columns
  const int KT = (HD + BK - 1) / BK, NPASS = (DM + BN - 1) / BN, total = KT * NPASS;
  bf16* sW = stage;
  auto load_w = [&](int slot, int t) {
    const int k0 = (t % KT) * BK, n0 = (t / KT) * BN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 32 rows x 16 chunks of 8 over 128 threads
      const int id = tid + i * fat::NT;
      const int r = id >> 4, c = (id & 15) * 8;
      const int kr = k0 + r, n = n0 + c;
      const bool p = kr < HD && n < DM;
      fat::cp_async16(sW + slot * W_TILE + r * WS + c, p ? wo + (long long)kr * DM + n : wo, p);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_w(s, s);
    asm volatile("cp.async.commit_group;\n");
  }

  const int g = lane >> 2, q = lane & 3;
  float acc[4][4][4];
  for (int t = 0; t < total; ++t) {
    const int kt = t % KT, n0 = (t / KT) * BN, k0 = kt * BK;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // tile t visible to all (and, at t = 0, sA complete)
    if (t + STAGES - 1 < total) load_w((t + STAGES - 1) % STAGES, t + STAGES - 1);
    asm volatile("cp.async.commit_group;\n");

    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    const bf16* tW = sW + (t % STAGES) * W_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (k0 + kk >= HD) break;  // HD % 16 == 0: a k-step is all in or all out
      uint32_t a[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        fat::ldmatrix_x4(a[i], sA + (i * 16 + (lane & 15)) * SS + k0 + kk + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        fat::ldmatrix_x4_trans(
            r, tW + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * WS + warp * 32 + jp * 16 +
                   (lane >> 4) * 8);
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) fat::mma_bf16(acc[i][j], a[i], bfr[j][0], bfr[j][1]);
    }

    if (kt == KT - 1) {
      // epilogue of this pass: thread holds (row g, cols 2q, 2q+1) and
      // (row g+8, same cols) of each 16x8 tile
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + warp * 32 + j * 8 + 2 * q;
        if (col >= DM) continue;
        const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bo + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = q0 + i * 16 + g + hh * 8;
            if (row >= SP) continue;
            const long long at = ((long long)b * SP + row) * DM + col;
            const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + at);
            const float v0 = acc[i][j][2 * hh] + __low2float(b2) + __low2float(r2);
            const float v1 = acc[i][j][2 * hh + 1] + __high2float(b2) + __high2float(r2);
            *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n");
}

template <int CP>
int launch(const void* qkvf, const void* wo, const void* bo, const void* res, void* out,
           int B, int SP, int H, int C, int D, int DM, cudaStream_t stream) {
  const int bytes = fat::BQ * (H * D + 8) * static_cast<int>(sizeof(bf16)) + staging_bytes<CP>();
  cudaError_t err = cudaFuncSetAttribute(fat_attention_proj_kernel<CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((SP + fat::BQ - 1) / fat::BQ, B);
  fat_attention_proj_kernel<CP><<<grid, fat::NT, bytes, stream>>>(
      static_cast<const bf16*>(qkvf), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bo), static_cast<const bf16*>(res), static_cast<bf16*>(out), SP,
      H, C, D, DM);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out(B, SP, DM) = res + attention(qkvf) @ wo + bo, bf16, from a contiguous
// packed (B, SP, 3*H*C) qkvf, wo (H*D, DM), bo (DM,) and res (B, SP, DM).
// Needs C % 8 == 0, D < C, (H*D) % 16 == 0, DM % 8 == 0, 16-byte aligned
// operands, and C padded to 16 equal to 80 (SO400M, d=72), 32 (the tiny
// test config, d=16) or 16 (the tiny fat test config, d=7).
int mse_fat_attention_proj(const void* qkvf, const void* wo, const void* bo,
                           const void* res, void* out, int B, int SP, int H, int C,
                           int D, int DM, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16 * 16) {
    case 80:
      return launch<80>(qkvf, wo, bo, res, out, B, SP, H, C, D, DM, s);
    case 32:
      return launch<32>(qkvf, wo, bo, res, out, B, SP, H, C, D, DM, s);
    case 16:
      return launch<16>(qkvf, wo, bo, res, out, B, SP, H, C, D, DM, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
