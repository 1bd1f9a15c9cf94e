// int4 weight-only matmul y[M, N] = x[M, K] @ (int4[K, N] * scale), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `vibevoice_tpu/ops/int4_matmul.py:int4_matmul`
// (Pallas `_kernel`): the weight is nibble-packed int8 [K/2, N] (see
// int4_common.cuh), with fp32 scales [1, N] (per output channel: applied to
// the fp32 sum) or [K/gs, N] (per group: multiplied into each weight in x's
// dtype before the dot).  Output in x's dtype.
//
// Bound: at decode M = 2B rows (2 at B=1), so the call does 2*M flops per
// weight value while reading half a byte of it: the least time is the packed
// weight bytes (K*N/2 + scales) over 3.35 TB/s.  The TPU grid runs over N
// blocks only; on Hopper that gives a 2048-wide qkv projection 8 blocks of
// 256 columns for 132 SMs.  So this kernel also splits K: grid (N/256,
// splits), each block reads a [KBR, 256] slab of packed bytes (4 bytes =
// 8 weights per thread per load, neighbouring threads on neighbouring
// columns, 8 loads in flight per thread), and writes fp32 partial sums; a
// second small kernel adds the splits in a fixed order (no float atomics:
// the result is the same on every run) and applies the per-channel scale.  x's K slice for the block is staged
// once in shared memory as fp32, for all M <= 128 rows; rows are then taken 8
// at a time (the block re-reads its slab from L1 for each further 8 rows).
// wgmma/TMA are left for a later version.
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16.
// Returns 0, a negative code for arguments it does not take, or the CUDA
// error of a launch.

#include "int4_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CGROUPS = 64;           // column groups of 4 per block
constexpr int COLS = 4 * CGROUPS;     // 256 output columns per block
constexpr int LANES = THREADS / CGROUPS;  // 4 threads split each slab's byte rows
constexpr int RC = 8;                 // rows per pass (registers: RC x 4 sums)
constexpr int XS_FLOATS = 6144;       // staged x slice: M * 2 * KBR fp32 at most

template <typename T, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
               const float* __restrict__ scale, float* __restrict__ part, int M, int K,
               int N, int KBR, int gs) {
  __shared__ float xs[XS_FLOATS];
  __shared__ float red[LANES - 1][RC][COLS];
  const int split = blockIdx.y;
  const int kb0 = split * KBR;                 // first byte row of the slab
  const int nrows = min(KBR, K / 2 - kb0);     // byte rows of the slab (>= 1)
  const int ldx = 2 * KBR;
  const int cg = threadIdx.x % CGROUPS, lane = threadIdx.x / CGROUPS;
  const int col = blockIdx.x * COLS + 4 * cg;
  const bool aligned = (N % 4) == 0;

  for (int e = threadIdx.x; e < M * 2 * nrows; e += THREADS) {
    const int r = e / (2 * nrows), c = e % (2 * nrows);
    xs[r * ldx + c] = vv::to_f(x[static_cast<size_t>(r) * K + 2 * kb0 + c]);
  }
  __syncthreads();

  const int8_t* w = packed + static_cast<size_t>(kb0) * N;
  for (int m0 = 0; m0 < M; m0 += RC) {
    const int rows = min(RC, M - m0);
    float acc[RC][4];
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    if (!GROUPED) {
      vv::gemv4<RC>(xs + m0 * ldx, ldx, rows, w, N, col, N, aligned, lane, nrows, LANES, acc);
    } else {
      for (int ib = lane; ib < nrows; ib += vv::BATCH * LANES) {
        uint32_t words[vv::BATCH];
#pragma unroll
        for (int u = 0; u < vv::BATCH; ++u) {
          const int i = ib + u * LANES;
          words[u] = i < nrows ? vv::load4(w + static_cast<size_t>(i) * N, col, N, aligned) : 0u;
        }
#pragma unroll
        for (int u = 0; u < vv::BATCH; ++u) {
          const int i = ib + u * LANES;
          if (i >= nrows) break;
          const float* srow = scale + static_cast<size_t>(2 * (kb0 + i) / gs) * N;
          float lo[4], hi[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b = (words[u] >> (8 * j)) & 0xFFu;
            // weight * scale rounded to x's dtype, as the TPU kernel does
            const float s = col + j < N ? vv::round_to<T>(__ldg(srow + col + j)) : 0.f;
            lo[j] = vv::round_to<T>(vv::lo_nib(b) * s);
            hi[j] = vv::round_to<T>(vv::hi_nib(b) * s);
          }
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            if (r < rows) {
              const float x0 = xs[(m0 + r) * ldx + 2 * i], x1 = xs[(m0 + r) * ldx + 2 * i + 1];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[r][j] = fmaf(x1, hi[j], fmaf(x0, lo[j], acc[r][j]));
            }
          }
        }
      }
    }
    if (lane > 0) {
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[lane - 1][r][4 * cg + j] = acc[r][j];
    }
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r < rows) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float s = acc[r][j];
#pragma unroll
            for (int l = 0; l < LANES - 1; ++l) s += red[l][r][4 * cg + j];
            if (col + j < N) part[(static_cast<size_t>(split) * M + m0 + r) * N + col + j] = s;
          }
        }
      }
    }
    __syncthreads();
  }
}

// One thread per output: the splits' partials added in split order.
template <typename T, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
              T* __restrict__ out, int M, int N, int ksplit) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= M * N) return;
  float s = vv::ordered_sum(part + e, ksplit, static_cast<size_t>(M) * N);
  if (!GROUPED) s *= scale[e % N];
  out[e] = vv::from_f<T>(s);
}

template <typename T, bool GROUPED>
int launch(const void* x, const int8_t* packed, const float* scale, void* out, float* part,
           int M, int K, int N, int gs, int KBR, int ksplit, cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS, ksplit);
  partial_kernel<T, GROUPED><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), packed, scale, part, M, K, N, KBR, gs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<T, GROUPED><<<(M * N + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      part, scale, static_cast<T*>(out), M, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part is fp32 [ksplit, M, N]; every split must hold at least one byte row:
// (ksplit - 1) * KBR < K / 2 <= ksplit * KBR.  G scale rows: 1 (per channel)
// or K / gs (per group of an even gs).
extern "C" int vv_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                              void* part, int M, int K, int N, int G, int KBR, int ksplit,
                              int dtype, void* stream) {
  if (M <= 0 || M > 128 || K <= 0 || K % 2 || N <= 0 || G <= 0) return -1;
  if (KBR <= 0 || M * 2 * KBR > XS_FLOATS) return -2;
  if ((ksplit - 1) * KBR >= K / 2 || ksplit * KBR < K / 2) return -3;
  const bool grouped = G > 1;
  if (grouped && (K % G || (K / G) % 2)) return -4;
  const int gs = K / G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
#define VV_LAUNCH(T, GR) return launch<T, GR>(x, p, s, out, pt, M, K, N, gs, KBR, ksplit, st)
  if (dtype == 0 && !grouped) VV_LAUNCH(float, false);
  if (dtype == 0 && grouped) VV_LAUNCH(float, true);
  if (dtype == 1 && !grouped) VV_LAUNCH(__nv_bfloat16, false);
  if (dtype == 1 && grouped) VV_LAUNCH(__nv_bfloat16, true);
#undef VV_LAUNCH
  return -5;  // unsupported dtype
}
