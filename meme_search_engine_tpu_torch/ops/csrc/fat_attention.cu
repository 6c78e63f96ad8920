// Fat-layout ViT self-attention for the SigLIP image tower on Hopper (sm_90a).
//
// Replaces the TPU kernel
//   meme_search_engine_tpu/ops/attention.py:_fat_vit_kernel
// behind both fat_vit_mha (separate q/k/v arrays) and fat_vit_mha_packed
// (one packed [q | k | v] array): this kernel takes base pointers and row
// and batch strides, so one kernel serves both.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s) at B=128,
// SP=736, H=16, C=80: 355 GFLOP against 941 MB of q/k/v in and output out,
// so operations bound it (0.36 ms), not bytes (0.28 ms).
//
// Design: unlike the TPU kernel, which held one image's whole K and V in
// VMEM, a CTA owns 64 query rows of one (image, head) and streams key
// tiles through shared memory with an online softmax: fat::attend_head
// (fat_attention.cuh), which the fused attention + o-projection kernel
// (fat_attention_proj.cu) shares. Each value goes straight to the output.

#include "fat_attention.cuh"

namespace {

using fat::bf16;

template <int CP>
__global__ void __launch_bounds__(fat::NT)
fat_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int SP,
                     int H, int C, int D, long long q_row, long long k_row,
                     long long v_row, long long q_batch, long long k_batch,
                     long long v_batch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * fat::BQ, h = blockIdx.y, b = blockIdx.z;
  bf16* dst = out + (long long)b * SP * (H * D) + (long long)h * D;
  fat::attend_head<CP>(
      q + b * q_batch + (long long)h * C, k + b * k_batch + (long long)h * C,
      v + b * v_batch + (long long)h * C, q_row, k_row, v_row, q0, SP, C, D,
      reinterpret_cast<bf16*>(smem), [&](int r, int c, float val) {
        // out[:, h*D : (h+1)*D] = O[:, :D] / l
        if (q0 + r < SP) dst[(long long)(q0 + r) * (H * D) + c] = __float2bfloat16(val);
      });
}

template <int CP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int SP, int H,
           int C, int D, long long q_row, long long k_row, long long v_row,
           long long q_batch, long long k_batch, long long v_batch, cudaStream_t stream) {
  const int bytes = fat::attention_smem_bytes<CP>();
  cudaError_t err = cudaFuncSetAttribute(
      fat_attention_kernel<CP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((SP + fat::BQ - 1) / fat::BQ, H, B);
  fat_attention_kernel<CP><<<grid, fat::NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), SP, H, C, D, q_row, k_row,
      v_row, q_batch, k_batch, v_batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out(B, SP, H*D) from fat-layout q/k/v views with the given element strides.
// Needs C % 8 == 0, D < C, 16-byte aligned rows, and C padded to 16 equal to
// 80 (SO400M, d=72), 32 (the tiny test config, d=16) or 16 (the tiny fat
// test config, d=7).
int mse_fat_attention(const void* q, const void* k, const void* v, void* out,
                      int B, int SP, int H, int C, int D, long long q_row,
                      long long k_row, long long v_row, long long q_batch,
                      long long k_batch, long long v_batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 15) / 16 * 16) {
    case 80:
      return launch<80>(q, k, v, out, B, SP, H, C, D, q_row, k_row, v_row, q_batch,
                        k_batch, v_batch, s);
    case 32:
      return launch<32>(q, k, v, out, B, SP, H, C, D, q_row, k_row, v_row, q_batch,
                        k_batch, v_batch, s);
    case 16:
      return launch<16>(q, k, v, out, B, SP, H, C, D, q_row, k_row, v_row, q_batch,
                        k_batch, v_batch, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
