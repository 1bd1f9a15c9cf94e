// Device helpers shared by the kernels (int4_matmul.cu, fused_block_chain.cu,
// fused_head.cu, fused_stage.cu).
//
// Packed layout (the JAX package's, `ops/int4_matmul.py:pack_int4`): an int8
// matrix [K/2, N] whose byte row i holds weight row 2i in its low nibble and
// row 2i+1 in its high nibble; nibbles are signed, in [-8, 7].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vv {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Sign-extended nibbles of one packed byte (no unsigned shift).
__device__ __forceinline__ float lo_nib(uint32_t b) {
  return static_cast<float>(static_cast<int>((b & 0xFu) ^ 8u) - 8);
}
__device__ __forceinline__ float hi_nib(uint32_t b) {
  return static_cast<float>(static_cast<int>(((b >> 4) & 0xFu) ^ 8u) - 8);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- block-wide helpers of the kernels that run THREADS threads per CTA
// (fused_stage.cu) ----

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// rs[r] = 1 / sqrt(mean(buf[r, :]^2) + eps), one warp per row
__device__ inline void row_rsqrt(const float* buf, int rows, int D, float eps, float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += WARPS) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = buf[r * D + d];
      s += v * v;
    }
    s = warp_sum(s);
    if (lane == 0) rs[r] = 1.f / sqrtf(s / D + eps);
  }
}

}  // namespace vv
