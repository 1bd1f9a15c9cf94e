// Device helpers shared by the int4 kernels (int4_matmul.cu,
// fused_block_chain.cu, fused_head.cu).
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

// Four packed bytes of one byte row, columns [col, col + 4); bytes at or past
// `ncols` read as 0 (weights 0).  `aligned`: the row stride is a multiple of 4,
// so a whole in-range word is one 4-byte load.
__device__ __forceinline__ uint32_t load4(const int8_t* row, int col, int ncols, bool aligned) {
  if (aligned && col + 3 < ncols) return __ldg(reinterpret_cast<const unsigned int*>(row + col));
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < ncols)
      w |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + col + j))) << (8 * j);
  return w;
}

constexpr int BATCH = 8;  // packed words a thread has in flight at once

// acc[r][j] += sum over byte rows i = i0, i0 + step, ... < i1 of
//   xs[r * ldx + 2i] * w[2i][col + j] + xs[r * ldx + 2i + 1] * w[2i + 1][col + j]
// for rows r < rows (at most RC) and the 4 columns col..col+3 of the packed
// matrix `w` (row stride `ldw` bytes, `ncols` valid columns).  xs is fp32.
// The words of BATCH byte rows are loaded before any is used, so a thread
// keeps BATCH loads in flight instead of one.
template <int RC>
__device__ __forceinline__ void gemv4(const float* xs, int ldx, int rows, const int8_t* w,
                                      int ldw, int col, int ncols, bool aligned, int i0,
                                      int i1, int step, float (&acc)[RC][4]) {
  for (int ib = i0; ib < i1; ib += BATCH * step) {
    uint32_t words[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = ib + u * step;
      words[u] = i < i1 ? load4(w + static_cast<size_t>(i) * ldw, col, ncols, aligned) : 0u;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = ib + u * step;
      if (i >= i1) break;
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b = (words[u] >> (8 * j)) & 0xFFu;
        lo[j] = lo_nib(b);
        hi[j] = hi_nib(b);
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r < rows) {
          const float x0 = xs[r * ldx + 2 * i], x1 = xs[r * ldx + 2 * i + 1];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(x1, hi[j], fmaf(x0, lo[j], acc[r][j]));
        }
      }
    }
  }
}

// sum over k < n of p[k * stride], added in k order; BATCH loads in flight.
__device__ __forceinline__ float ordered_sum(const float* p, int n, size_t stride) {
  float s = 0.f;
  for (int k0 = 0; k0 < n; k0 += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) v[u] = k0 + u < n ? p[(k0 + u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) s += v[u];
  }
  return s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- block-wide helpers of the cooperative kernels (fused_block_chain.cu,
// fused_head.cu), which run THREADS threads per CTA ----

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RC = 8;                  // rows per register pass
constexpr int RED_FLOATS = 1024 * RC;  // tile_up's lane partials: lanes x RC x columns

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

// out[r * ldo + c] = sum_d xs[r * D + d] * W[d][f0 + c] for r < rows, c < tf;
// W packed [D/2, F].  Block-wide: every thread must call it.
__device__ inline void tile_up(const float* xs, int rows, int D, const int8_t* w, int F, int f0,
                        int tf, float* red, float* out, int ldo) {
  const int cgs = (tf + 3) / 4, lanes = THREADS / cgs;
  const int cgi = threadIdx.x % cgs, lane = threadIdx.x / cgs;
  const int ldr = 4 * cgs;
  const bool aligned = F % 4 == 0;
  for (int m0 = 0; m0 < rows; m0 += RC) {
    const int rr = min(RC, rows - m0);
    if (lane < lanes) {
      float acc[RC][4];
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
      gemv4<RC>(xs + m0 * D, D, rr, w, F, f0 + 4 * cgi, f0 + tf, aligned, lane, D / 2,
                    lanes, acc);
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[(lane * RC + r) * ldr + 4 * cgi + j] = acc[r][j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rr * tf; e += THREADS) {
      const int r = e / tf, c = e % tf;
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[(l * RC + r) * ldr + c];
      out[(m0 + r) * ldo + c] = s;
    }
    __syncthreads();
  }
}

// part[r * D + d] = sum_{c < tf} a[r * lda + c] * W2[c][d] for r < rows;
// w2 points at the tile's first byte row of W2 packed [F/2, D].
__device__ inline void tile_down(const float* a, int lda, int rows, const int8_t* w2, int D, int tf,
                          float* part) {
  const bool aligned = D % 4 == 0;
  for (int cgi = threadIdx.x; 4 * cgi < D; cgi += THREADS) {
    const int col = 4 * cgi;
    for (int m0 = 0; m0 < rows; m0 += RC) {
      const int rr = min(RC, rows - m0);
      float acc[RC][4];
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
      gemv4<RC>(a + m0 * lda, lda, rr, w2, D, col, D, aligned, 0, tf / 2, 1, acc);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r < rr) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < D) part[static_cast<size_t>(m0 + r) * D + col + j] = acc[r][j];
        }
      }
    }
  }
}

// Phase C of the cooperative kernels: out[e] = sum over tiles t (in order) of
// part[t * n_el + e], for every e < n_el, spread over the whole grid.  Each CTA
// takes chunks of 32 consecutive elements; its 8 warps each add every 8th tile
// (coalesced 128-byte rows), and the 8 slices meet in shared memory in a
// fixed order, so the result is the same on every run.  `fn(e, sum)` consumes
// each element's sum.  Block-wide: every thread must call it; `red` holds
// WARPS * 32 floats.
template <typename Fn>
__device__ inline void reduce_tiles(const float* part, int ntiles, size_t n_el, float* red,
                                    Fn fn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t chunks = (n_el + 31) / 32;
  for (size_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const size_t e = c * 32 + lane;
    float s = 0.f;
    if (e < n_el) {
      const int mine = ntiles > warp ? (ntiles - warp + WARPS - 1) / WARPS : 0;
      s = ordered_sum(part + static_cast<size_t>(warp) * n_el + e, mine, WARPS * n_el);
    }
    red[warp * 32 + lane] = s;
    __syncthreads();
    if (warp == 0 && e < n_el) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += red[w * 32 + lane];
      fn(e, t);
    }
    __syncthreads();
  }
}

}  // namespace vv
