// Fused int4 diffusion-head solver step, for Hopper (sm_90a).
//
// Replaces the TPU kernel `vibevoice_tpu/ops/fused_head.py:
// fused_head_solver_step` (Pallas `_kernel`).  One denoising step for N rows
// (the CFG-doubled batch, 2B) over the head's L adaLN layers, in fp32:
//   h = (rmsnorm(x) * norm_w) * (1 + scale) + shift      (mods[l] = shift|scale|gate)
//   a = silu((h @ int4 wg) * sg) * ((h @ int4 wu) * su)
//   x = x + gate * ((a @ int4 wd) * sd)
// then v = (rmsnorm(x) * (1 + fscale) + fshift) @ final_linear.  The pack
// layout is the JAX package's (`ops/fused_head.py:pack_head_solver_q`).
//
// Bound: N is 2 at B=1, so each weight value feeds 2*N flops against half a
// byte: the least time is the packed gate/up/down bytes (3 * L * H * F / 2,
// about 42.5 MB per step for the 1.5B head: L=4, H=1536, F=4608) plus the
// scales, modulations and final linear, over 3.35 TB/s.
//
// Design: as `fused_block_chain.cu` — the TPU kernel walks grid (layer,
// ffn_tile) in order with the activation in VMEM; here ONE cooperative launch
// (about two CTAs per SM) runs, for every layer: (A) every CTA recomputes the
// modulated norm of all rows into shared memory; (B) CTAs take tiles of F
// (about one per CTA), keep silu(g)*u of the tile in shared memory and write
// the tile's fp32 down-projection partial [tiles, rows, H]; grid barrier;
// (C) the partials are summed in a fixed order (no float atomics;
// `vv::reduce_tiles`) into the residual; grid barrier.  After the last layer
// every CTA recomputes the final norm and the [N, latent] outputs are spread
// over the grid's warps.  Rows that do not fit the shared-memory budget are
// cut into row groups inside the launch.  wgmma/TMA are left for a later
// version.
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16
// (x, the modulations, the final linear and the output share it).  Returns 0,
// a negative code for arguments or a card it does not take, or the CUDA error
// of the launch.

#include <cooperative_groups.h>

#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace {

using vv::THREADS;
using vv::WARPS;
using vv::RC;
using vv::RED_FLOATS;

struct HeadArgs {
  const void* x;     // [N, H] (after noisy_proj)
  const void* mods;  // [L, N, 3H]
  const void* fmod;  // [N, 2H]
  const void* fl;    // [H, lat]
  const float* norms;  // [L, 8, H], row 0 = norm_w
  const int8_t* wgq;   // [L, H/2, F]
  const float* sg;     // [L, 1, F]
  const int8_t* wuq;
  const float* su;
  const int8_t* wdq;   // [L, F/2, H]
  const float* sd;     // [L, 1, H]
  void* out;           // [N, lat]
  float* xg;           // [N, H] running activation
  float* part;         // [ntiles, rows_g, H]
  int N, H, F, L, lat, rows_g, TF, ntiles;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) head_kernel(HeadArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  const int H = a.H, F = a.F, TF = a.TF;
  float* hb = sm;                     // [rows][H]
  float* gs = hb + a.rows_g * H;      // [rows][TF]: gate, then silu(gate) * up
  float* us = gs + a.rows_g * TF;     // [rows][TF]: up
  float* red = us + a.rows_g * TF;
  float* rs = red + RED_FLOATS;       // [rows]
  const T* x_in = static_cast<const T*>(a.x);
  const T* mods_all = static_cast<const T*>(a.mods);
  const T* fmod = static_cast<const T*>(a.fmod);
  const T* fl = static_cast<const T*>(a.fl);
  T* out = static_cast<T*>(a.out);
  const int tid = threadIdx.x;

  for (int n0 = 0; n0 < a.N; n0 += a.rows_g) {
    const int rows = min(a.rows_g, a.N - n0);
    const size_t base = static_cast<size_t>(n0) * H;
    const size_t n_el = static_cast<size_t>(rows) * H;
    for (int l = 0; l < a.L; ++l) {
      const T* mods = mods_all + (static_cast<size_t>(l) * a.N + n0) * 3 * H;
      const float* norm_w = a.norms + static_cast<size_t>(l) * 8 * H;

      // ---- A: modulated norm of every row (every CTA) ----
      for (size_t e = tid; e < n_el; e += THREADS)
        hb[e] = l == 0 ? vv::to_f(x_in[base + e]) : a.xg[base + e];
      __syncthreads();
      vv::row_rsqrt(hb, rows, H, a.eps, rs);
      __syncthreads();
      for (size_t e = tid; e < n_el; e += THREADS) {
        const int r = static_cast<int>(e / H), d = static_cast<int>(e % H);
        const float shift = vv::to_f(mods[static_cast<size_t>(r) * 3 * H + d]);
        const float scale = vv::to_f(mods[static_cast<size_t>(r) * 3 * H + H + d]);
        hb[e] = (hb[e] * rs[r] * norm_w[d]) * (1.f + scale) + shift;
      }
      __syncthreads();

      // ---- B: SwiGLU tiles ----
      const int8_t* wg = a.wgq + static_cast<size_t>(l) * (H / 2) * F;
      const int8_t* wu = a.wuq + static_cast<size_t>(l) * (H / 2) * F;
      const int8_t* wd = a.wdq + static_cast<size_t>(l) * (F / 2) * H;
      const float* sgl = a.sg + static_cast<size_t>(l) * F;
      const float* sul = a.su + static_cast<size_t>(l) * F;
      for (int tl = blockIdx.x; tl < a.ntiles; tl += gridDim.x) {
        const int f0 = tl * TF, tf = min(TF, F - f0);
        vv::tile_up(hb, rows, H, wg, F, f0, tf, red, gs, TF);
        vv::tile_up(hb, rows, H, wu, F, f0, tf, red, us, TF);
        for (int e = tid; e < rows * tf; e += THREADS) {
          const int r = e / tf, c = e % tf;
          const float g = gs[r * TF + c] * sgl[f0 + c];
          const float u = us[r * TF + c] * sul[f0 + c];
          gs[r * TF + c] = (g / (1.f + expf(-g))) * u;
        }
        __syncthreads();
        vv::tile_down(gs, TF, rows, wd + static_cast<size_t>(f0 / 2) * H, H, tf,
                  a.part + static_cast<size_t>(tl) * n_el);
        __syncthreads();
      }
      grid.sync();

      // ---- C: partials in a fixed order -> gated residual ----
      const float* sdl = a.sd + static_cast<size_t>(l) * H;
      vv::reduce_tiles(a.part, a.ntiles, n_el, red, [&](size_t e, float s) {
        const int r = static_cast<int>(e / H), d = static_cast<int>(e % H);
        const float xv = l == 0 ? vv::to_f(x_in[base + e]) : a.xg[base + e];
        const float gate = vv::to_f(mods[static_cast<size_t>(r) * 3 * H + 2 * H + d]);
        a.xg[base + e] = xv + gate * (s * sdl[d]);
      });
      grid.sync();
    }

    // ---- final adaLN norm and linear [H, lat] ----
    for (size_t e = tid; e < n_el; e += THREADS) hb[e] = a.xg[base + e];
    __syncthreads();
    vv::row_rsqrt(hb, rows, H, a.eps, rs);
    __syncthreads();
    for (size_t e = tid; e < n_el; e += THREADS) {
      const int r = static_cast<int>(e / H), d = static_cast<int>(e % H);
      const size_t fr = static_cast<size_t>(n0 + r) * 2 * H;
      hb[e] = hb[e] * rs[r] * (1.f + vv::to_f(fmod[fr + H + d])) + vv::to_f(fmod[fr + d]);
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int o = blockIdx.x * WARPS + warp; o < rows * a.lat; o += gridDim.x * WARPS) {
      const int r = o / a.lat, j = o % a.lat;
      float s = 0.f;
      for (int d = lane; d < H; d += 32)
        s += hb[static_cast<size_t>(r) * H + d] * vv::to_f(fl[static_cast<size_t>(d) * a.lat + j]);
      s = vv::warp_sum(s);
      if (lane == 0) out[static_cast<size_t>(n0 + r) * a.lat + j] = vv::from_f<T>(s);
    }
    __syncthreads();
  }
}

size_t smem_bytes(const HeadArgs& a) {
  const size_t rows = a.rows_g;
  return sizeof(float) * (rows * a.H + 2 * rows * a.TF + RED_FLOATS + rows);
}

template <typename T>
int launch(HeadArgs a, cudaStream_t stream) {
  void (*kern)(HeadArgs) = head_kernel<T>;
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
  if (!coop) return -10;
  if (per_sm < 1) return -11;
  const int grid = min(a.ntiles, sms * min(per_sm, 2));
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                                      dim3(grid), dim3(THREADS), args, smem,
                                                      stream));
}

}  // namespace

extern "C" int vv_fused_head(const void* x, const void* mods, const void* fmod, const void* fl,
                             const void* norms, const void* wgq, const void* sg,
                             const void* wuq, const void* su, const void* wdq, const void* sd,
                             void* out, void* xg, void* part, int N, int H, int F, int L,
                             int lat, int rows_g, int TF, int ntiles, float eps, int dtype,
                             void* stream) {
  if (N <= 0 || H <= 0 || F <= 0 || L <= 0 || lat <= 0 || H % 2 || F % 2) return -1;
  if (rows_g <= 0 || rows_g > N || TF <= 0 || TF % 4 || TF > 64) return -2;
  if (ntiles != (F + TF - 1) / TF) return -3;
  HeadArgs a{x, mods, fmod, fl, static_cast<const float*>(norms),
             static_cast<const int8_t*>(wgq), static_cast<const float*>(sg),
             static_cast<const int8_t*>(wuq), static_cast<const float*>(su),
             static_cast<const int8_t*>(wdq), static_cast<const float*>(sd), out,
             static_cast<float*>(xg), static_cast<float*>(part),
             N, H, F, L, lat, rows_g, TF, ntiles, eps};
  if (smem_bytes(a) > 227 * 1024) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, st);
  return -5;
}
