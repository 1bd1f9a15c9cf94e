// Fused int4 Block1D chain (one sigma-VAE stage at streaming decode), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `vibevoice_tpu/ops/fused_blocks.py:
// fused_block_chain_batched` (Pallas `_kernel_q`).  For x [B, T <= 8, D] and
// the per-block streaming context ctx [B, N, 6, D], each of the N Block1Ds
// computes, in fp32:
//   h  = rmsnorm(x) * norm_w;  new ctx = last 6 rows of [ctx; h]
//   y  = x + gamma * (causal depthwise conv k=7 over [ctx; h] + mixer_b)
//   hn = rmsnorm(y) * ffn_norm_w
//   a  = gelu_exact((hn @ int4 w1) * s1 + b1)
//   x  = y + ffn_gamma * ((a @ int4 w2) * s2 + b2)
// The pack layout is the JAX package's (`ops/fused_blocks.py:pack_stage_q`).
//
// Bound: the stage's rows are few (B*T), so each weight value feeds 2*B*T
// flops against half a byte: the least time is the packed weight bytes
// (N * D * F, plus the fp32 vectors and scales) over 3.35 TB/s — about 134 MB
// for the 1.5B model's D=2048 stages and 12.6 MB for its D=1024 stages.
//
// Design: the TPU kernel is one pallas_call whose grid runs in order and
// carries the activation in VMEM from block to block.  Hopper runs blocks in
// parallel, so this is ONE cooperative launch (about two CTAs per SM) with
// grid-wide barriers between phases, for every Block1D:
//   A. every CTA recomputes the norm / mixer / second norm for all rows of
//      the row group into shared memory (at most 8*B rows of D fp32 — cheap
//      next to the weights); CTA 0 also writes the new context and y;
//   B. the FFN width F is cut into ~one tile per CTA; a CTA takes whole tiles:
//      gelu((hn @ w1[:, tile]) * s1 + b1) stays in shared memory, and
//      a_tile @ w2[tile, :] is written as an fp32 partial [tiles, rows, D];
//   -- grid barrier --
//   C. the partials are summed in a fixed order (no float atomics, so the
//      result is the same on every run; `vv::reduce_tiles`) into the
//      residual; the last block writes y in x's dtype;
//   -- grid barrier --
// Only weight tiles stream from device memory, each read once per row group.
// Batches whose rows do not fit the shared-memory budget are cut into row
// groups inside the launch (the TPU kernel's _CHAIN_GROUP_BUDGET).  wgmma/TMA
// are left for a later version.
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16
// (x, ctx, y and the new ctx share it).  Returns 0, a negative code for
// arguments or a card it does not take, or the CUDA error of the launch.

#include <cooperative_groups.h>

#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace {

using vv::THREADS;
using vv::RC;
using vv::RED_FLOATS;
constexpr int CTX = 6;

struct ChainArgs {
  const void* x;
  const void* ctx;
  const float* vecs;
  const float* mixw;
  const int8_t* w1q;
  const float* sb1;
  const int8_t* w2q;
  const float* s2;
  void* y;
  void* ctx_out;
  float* xg;    // [B*T, D] running activation between blocks
  float* yg;    // [B*T, D] post-mixer residual of the current block
  float* part;  // [ntiles, bg*T, D] down-projection partials
  int B, T, D, F, NB, bg, TF, ntiles;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) chain_kernel(ChainArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int D = a.D, F = a.F, Tn = a.T, NB = a.NB;
  const int rows_max = a.bg * Tn;
  float* hb = sm;                       // [rows][D]: x, then h, then y, then hn
  float* as = hb + rows_max * D;        // [rows][TF]: the FFN tile's activations
  float* red = as + rows_max * a.TF;    // lane partials of tile_up
  float* rs = red + RED_FLOATS;         // [rows] row statistics
  const T* x_in = static_cast<const T*>(a.x);
  const T* ctx_in = static_cast<const T*>(a.ctx);
  T* y_out = static_cast<T*>(a.y);
  T* ctx_out = static_cast<T*>(a.ctx_out);
  const int tid = threadIdx.x;

  for (int b0 = 0; b0 < a.B; b0 += a.bg) {
    const int nbg = min(a.bg, a.B - b0);
    const int rows = nbg * Tn;
    const size_t base = static_cast<size_t>(b0) * Tn * D;  // first element of the group
    for (int nb = 0; nb < NB; ++nb) {
      const float* vec = a.vecs + static_cast<size_t>(nb) * 8 * D;
      const float* taps = a.mixw + static_cast<size_t>(nb) * 8 * D;
      const float* xprev = a.xg + base;

      // ---- A: norm, context, mixer, second norm (every CTA, all rows) ----
      for (int e = tid; e < rows * D; e += THREADS)
        hb[e] = nb == 0 ? vv::to_f(x_in[base + e]) : xprev[e];
      __syncthreads();
      vv::row_rsqrt(hb, rows, D, a.eps, rs);
      __syncthreads();
      for (int e = tid; e < rows * D; e += THREADS) hb[e] = hb[e] * rs[e / D] * vec[e % D];
      __syncthreads();
      if (blockIdx.x == 0) {  // new context: the last 6 rows of [ctx; h]
        for (int e = tid; e < nbg * CTX * D; e += THREADS) {
          const int bl = e / (CTX * D), j = (e / D) % CTX, d = e % D;
          const int src = j + Tn;
          const size_t cbase = (static_cast<size_t>(b0 + bl) * NB + nb) * CTX;
          const float v = src < CTX ? vv::to_f(ctx_in[(cbase + src) * D + d])
                                    : hb[(bl * Tn + src - CTX) * D + d];
          ctx_out[(cbase + j) * D + d] = vv::from_f<T>(v);
        }
      }
      __syncthreads();
      // y in place: per column, rows from the last frame down, so every row a
      // tap reads (frames <= t) still holds h
      for (int e = tid; e < nbg * D; e += THREADS) {
        const int bl = e / D, d = e % D;
        const T* cb = ctx_in + (static_cast<size_t>(b0 + bl) * NB + nb) * CTX * D + d;
        for (int t = Tn - 1; t >= 0; --t) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < 7; ++k) {
            const int j = t + k;
            const float src = j < CTX ? vv::to_f(cb[static_cast<size_t>(j) * D])
                                      : hb[(bl * Tn + j - CTX) * D + d];
            acc = acc + src * taps[k * D + d];
          }
          const int r = bl * Tn + t;
          const float xv = nb == 0 ? vv::to_f(x_in[base + static_cast<size_t>(r) * D + d])
                                   : xprev[static_cast<size_t>(r) * D + d];
          hb[r * D + d] = xv + vec[2 * D + d] * (acc + vec[D + d]);
        }
      }
      __syncthreads();
      if (blockIdx.x == 0)
        for (int e = tid; e < rows * D; e += THREADS) a.yg[base + e] = hb[e];
      vv::row_rsqrt(hb, rows, D, a.eps, rs);
      __syncthreads();
      for (int e = tid; e < rows * D; e += THREADS)
        hb[e] = hb[e] * rs[e / D] * vec[3 * D + e % D];
      __syncthreads();

      // ---- B: FFN tiles ----
      const int8_t* w1 = a.w1q + static_cast<size_t>(nb) * (D / 2) * F;
      const int8_t* w2 = a.w2q + static_cast<size_t>(nb) * (F / 2) * D;
      const float* s1 = a.sb1 + static_cast<size_t>(nb) * 2 * F;
      const float* b1 = s1 + F;
      for (int tl = blockIdx.x; tl < a.ntiles; tl += gridDim.x) {
        const int f0 = tl * a.TF, tf = min(a.TF, F - f0);
        vv::tile_up(hb, rows, D, w1, F, f0, tf, red, as, a.TF);
        for (int e = tid; e < rows * tf; e += THREADS) {
          const int r = e / tf, c = e % tf;
          const float v = as[r * a.TF + c] * s1[f0 + c] + b1[f0 + c];
          as[r * a.TF + c] = 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
        }
        __syncthreads();
        vv::tile_down(as, a.TF, rows, w2 + static_cast<size_t>(f0 / 2) * D, D, tf,
                  a.part + static_cast<size_t>(tl) * rows * D);
        __syncthreads();
      }
      grid.sync();

      // ---- C: partials in tile order -> residual ----
      const float* g2 = vec + 4 * D;
      const float* bias2 = vec + 5 * D;
      const float* sc2 = a.s2 + static_cast<size_t>(nb) * D;
      const bool last = nb == NB - 1;
      vv::reduce_tiles(a.part, a.ntiles, static_cast<size_t>(rows) * D, red,
                       [&](size_t e, float s) {
                         const int d = static_cast<int>(e % D);
                         const float v = a.yg[base + e] + g2[d] * (s * sc2[d] + bias2[d]);
                         a.xg[base + e] = v;
                         if (last) y_out[base + e] = vv::from_f<T>(v);
                       });
      grid.sync();
    }
  }
}

size_t smem_bytes(const ChainArgs& a) {
  const size_t rows = static_cast<size_t>(a.bg) * a.T;
  return sizeof(float) * (rows * a.D + rows * a.TF + RED_FLOATS + rows);
}

template <typename T>
int launch(ChainArgs a, cudaStream_t stream) {
  void (*kern)(ChainArgs) = chain_kernel<T>;
  const size_t smem = smem_bytes(a);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return -10;   // the card cannot launch cooperatively
  if (per_sm < 1) return -11;  // one CTA does not fit an SM
  const int grid = min(a.ntiles, sms * min(per_sm, 2));
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                                      dim3(grid), dim3(THREADS), args, smem,
                                                      stream));
}

}  // namespace

extern "C" int vv_fused_block_chain(const void* x, const void* ctx, const void* vecs,
                                    const void* mixw, const void* w1q, const void* sb1,
                                    const void* w2q, const void* s2, void* y, void* ctx_out,
                                    void* xg, void* yg, void* part, int B, int T, int D, int F,
                                    int NB, int bg, int TF, int ntiles, float eps, int dtype,
                                    void* stream) {
  if (B <= 0 || T <= 0 || T > 8 || NB <= 0 || D <= 0 || F <= 0 || D % 2 || F % 2) return -1;
  if (bg <= 0 || bg > B || TF <= 0 || TF % 4 || TF > 64) return -2;
  if (ntiles != (F + TF - 1) / TF) return -3;
  ChainArgs a{x, ctx, static_cast<const float*>(vecs), static_cast<const float*>(mixw),
              static_cast<const int8_t*>(w1q), static_cast<const float*>(sb1),
              static_cast<const int8_t*>(w2q), static_cast<const float*>(s2), y, ctx_out,
              static_cast<float*>(xg), static_cast<float*>(yg), static_cast<float*>(part),
              B, T, D, F, NB, bg, TF, ntiles, eps};
  if (smem_bytes(a) > 227 * 1024) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return -5;  // unsupported dtype
}
