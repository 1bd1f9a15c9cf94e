// Fused Block1D chain (one sigma-VAE stage at streaming decode), for Hopper
// (sm_90a), over int4 packs and over plain bf16/fp32 packs.
//
// Replaces two TPU kernels of `vibevoice_tpu/ops/fused_blocks.py`:
// `fused_block_chain_batched` (Pallas `_kernel_q`, int4 packs) and
// `fused_block_chain` (Pallas `_kernel`, plain packs).  For x [B, T <= 8, D]
// and the per-block streaming context ctx [B, N, 6, D], each of the N
// Block1Ds computes, in fp32:
//   h  = rmsnorm(x) * norm_w;  new ctx = last 6 rows of [ctx; h]
//   y  = x + gamma * (causal depthwise conv k=7 over [ctx; h] + mixer_b)
//   hn = rmsnorm(y) * ffn_norm_w
//   a  = gelu_exact(hn @ W1 + b1)
//   x  = y + ffn_gamma * (a @ W2 + b2)
// The pack layouts are the JAX package's.  int4 (`pack_stage_q`): W1 and W2
// nibble-packed with per-column scales (W1 = q1 * s1, W2 = q2 * s2), b1 in
// sb1 row 1, the vectors fp32.  Plain (`pack_stage`): everything in the pack
// dtype, widened to fp32 on load; W1 is w1 [D + 8, F] with b1 in row D (the
// TPU kernel's all-ones activation column) and zero rows D+1..D+7, which are
// skipped.
//
// Bound: the stage's rows are few (B*T), so each weight value feeds 2*B*T
// flops: the least time is the weight bytes over 3.35 TB/s -- about 134 MB
// (int4) or 538 MB (bf16) for the 1.5B model's D=2048 stages and 12.6 MB /
// 50 MB for its D=1024 stages.
//
// Design: the TPU kernel is one pallas_call whose grid runs in order and
// carries the activation in VMEM from block to block (the plain one once per
// batch row, under vmap).  Hopper runs blocks in parallel, so this is ONE
// cooperative launch (about two CTAs per SM) with grid-wide barriers between
// phases, for every Block1D:
//   A. every CTA recomputes the norm / mixer / second norm for all rows of
//      the row group into shared memory (at most 8*B rows of D fp32 -- cheap
//      next to the weights); CTA 0 also writes the new context and y;
//   B. the FFN width F is cut into ~one tile per CTA; a CTA takes whole tiles:
//      gelu(hn @ W1[:, tile] + b1) stays in shared memory, and
//      a_tile @ W2[tile, :] is written as an fp32 partial [tiles, rows, D];
//   -- grid barrier --
//   C. the partials are summed in a fixed order (no float atomics, so the
//      result is the same on every run; `vv::reduce_tiles`) into the
//      residual; the last block writes y in x's dtype;
//   -- grid barrier --
// Only weight tiles stream from device memory, each read once per row group:
// for all B rows at once, where the TPU's vmapped plain kernel reads them once
// per row.  Batches whose rows do not fit the shared-memory budget are cut
// into row groups inside the launch (the TPU kernel's _CHAIN_GROUP_BUDGET).
// wgmma/TMA are left for a later version.
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16
// (x, ctx, y and the new ctx share one; a plain pack has its own).  Returns
// 0, a negative code for arguments or a card it does not take, or the CUDA
// error of the launch.

#include <cooperative_groups.h>

#include <type_traits>

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
  const void* vecs;  // the pack's vectors and taps: fp32 (int4 pack) or the pack dtype
  const void* mixw;
  const void* w1;    // int4: w1q [N, D/2, F]; plain: w1 [N, D+8, F]
  const float* sb1;  // int4 only: [N, 2, F] (ffn1 scale, bias)
  const void* w2;    // int4: w2q [N, F/2, D]; plain: w2 [N, F, D]
  const float* s2;   // int4 only: [N, 1, D]
  void* y;
  void* ctx_out;
  float* xg;    // [B*T, D] running activation between blocks
  float* yg;    // [B*T, D] post-mixer residual of the current block
  float* part;  // [ntiles, bg*T, D] down-projection partials
  int B, T, D, F, NB, bg, TF, ntiles;
  float eps;
};

// Four consecutive weights of one plain row, columns [col, col + 4), as fp32;
// columns at or past `ncols` read 0.  `aligned`: a whole in-range group is
// one 16-byte (fp32) or 8-byte (bf16) load.
template <typename W>
__device__ __forceinline__ float4 load4w(const W* row, int col, int ncols, bool aligned) {
  if (aligned && col + 3 < ncols) {
    if constexpr (std::is_same<W, float>::value) {
      return __ldg(reinterpret_cast<const float4*>(row + col));
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + col));
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = col + j < ncols ? vv::to_f(row[col + j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The plain counterpart of vv::gemv4: acc[r][j] += sum over weight rows
// i = i0, i0 + step, ... < i1 of xs[r * ldx + i] * w[i][col + j], with
// vv::BATCH rows' loads in flight.
template <typename W>
__device__ __forceinline__ void gemv_plain(const float* xs, int ldx, int rows, const W* w,
                                           int ldw, int col, int ncols, bool aligned, int i0,
                                           int i1, int step, float (&acc)[RC][4]) {
  for (int ib = i0; ib < i1; ib += vv::BATCH * step) {
    float4 wv[vv::BATCH];
#pragma unroll
    for (int u = 0; u < vv::BATCH; ++u) {
      const int i = ib + u * step;
      wv[u] = i < i1 ? load4w(w + static_cast<size_t>(i) * ldw, col, ncols, aligned)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < vv::BATCH; ++u) {
      const int i = ib + u * step;
      if (i >= i1) break;
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r < rows) {
          const float x = xs[r * ldx + i];
          acc[r][0] = fmaf(x, wv[u].x, acc[r][0]);
          acc[r][1] = fmaf(x, wv[u].y, acc[r][1]);
          acc[r][2] = fmaf(x, wv[u].z, acc[r][2]);
          acc[r][3] = fmaf(x, wv[u].w, acc[r][3]);
        }
      }
    }
  }
}

// vv::tile_up over a plain W [D(+8), F]: out[r * ldo + c] = sum_{d < D}
// xs[r * D + d] * W[d][f0 + c].  Block-wide.
template <typename W>
__device__ inline void tile_up_plain(const float* xs, int rows, int D, const W* w, int F, int f0,
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
      gemv_plain(xs + m0 * D, D, rr, w, F, f0 + 4 * cgi, f0 + tf, aligned, lane, D, lanes, acc);
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

// vv::tile_down over a plain W2 [F, D] (w2 points at the tile's first row):
// part[r * D + d] = sum_{c < tf} a[r * lda + c] * W2[c][d].
template <typename W>
__device__ inline void tile_down_plain(const float* a, int lda, int rows, const W* w2, int D,
                                       int tf, float* part) {
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
      gemv_plain(a + m0 * lda, lda, rr, w2, D, col, D, aligned, 0, tf, 1, acc);
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

// W is the pack's weight format: int8_t for an int4 pack (nibbles), float or
// __nv_bfloat16 for a plain pack.
template <typename T, typename W>
__global__ void __launch_bounds__(THREADS) chain_kernel(ChainArgs a) {
  constexpr bool kInt4 = std::is_same<W, int8_t>::value;
  using V = typename std::conditional<kInt4, float, W>::type;  // vectors and taps
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
      const V* vec = static_cast<const V*>(a.vecs) + static_cast<size_t>(nb) * 8 * D;
      const V* taps = static_cast<const V*>(a.mixw) + static_cast<size_t>(nb) * 8 * D;
      const float* xprev = a.xg + base;

      // ---- A: norm, context, mixer, second norm (every CTA, all rows) ----
      for (int e = tid; e < rows * D; e += THREADS)
        hb[e] = nb == 0 ? vv::to_f(x_in[base + e]) : xprev[e];
      __syncthreads();
      vv::row_rsqrt(hb, rows, D, a.eps, rs);
      __syncthreads();
      for (int e = tid; e < rows * D; e += THREADS)
        hb[e] = hb[e] * rs[e / D] * vv::to_f(vec[e % D]);
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
            acc = acc + src * vv::to_f(taps[k * D + d]);
          }
          const int r = bl * Tn + t;
          const float xv = nb == 0 ? vv::to_f(x_in[base + static_cast<size_t>(r) * D + d])
                                   : xprev[static_cast<size_t>(r) * D + d];
          hb[r * D + d] = xv + vv::to_f(vec[2 * D + d]) * (acc + vv::to_f(vec[D + d]));
        }
      }
      __syncthreads();
      if (blockIdx.x == 0)
        for (int e = tid; e < rows * D; e += THREADS) a.yg[base + e] = hb[e];
      vv::row_rsqrt(hb, rows, D, a.eps, rs);
      __syncthreads();
      for (int e = tid; e < rows * D; e += THREADS)
        hb[e] = hb[e] * rs[e / D] * vv::to_f(vec[3 * D + e % D]);
      __syncthreads();

      // ---- B: FFN tiles ----
      for (int tl = blockIdx.x; tl < a.ntiles; tl += gridDim.x) {
        const int f0 = tl * a.TF, tf = min(a.TF, F - f0);
        float* part = a.part + static_cast<size_t>(tl) * rows * D;
        if constexpr (kInt4) {
          const int8_t* w1 =
              static_cast<const int8_t*>(a.w1) + static_cast<size_t>(nb) * (D / 2) * F;
          const float* s1 = a.sb1 + static_cast<size_t>(nb) * 2 * F;
          const float* b1 = s1 + F;
          vv::tile_up(hb, rows, D, w1, F, f0, tf, red, as, a.TF);
          for (int e = tid; e < rows * tf; e += THREADS) {
            const int r = e / tf, c = e % tf;
            const float v = as[r * a.TF + c] * s1[f0 + c] + b1[f0 + c];
            as[r * a.TF + c] = 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
          }
          __syncthreads();
          const int8_t* w2 =
              static_cast<const int8_t*>(a.w2) + static_cast<size_t>(nb) * (F / 2) * D;
          vv::tile_down(as, a.TF, rows, w2 + static_cast<size_t>(f0 / 2) * D, D, tf, part);
        } else {
          // rows 0..D-1 of w1 are W1, row D is b1, rows D+1..D+7 are zero
          const W* w1 = static_cast<const W*>(a.w1) + static_cast<size_t>(nb) * (D + 8) * F;
          const W* b1 = w1 + static_cast<size_t>(D) * F;
          tile_up_plain(hb, rows, D, w1, F, f0, tf, red, as, a.TF);
          for (int e = tid; e < rows * tf; e += THREADS) {
            const int r = e / tf, c = e % tf;
            const float v = as[r * a.TF + c] + vv::to_f(b1[f0 + c]);
            as[r * a.TF + c] = 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
          }
          __syncthreads();
          const W* w2 = static_cast<const W*>(a.w2) + static_cast<size_t>(nb) * F * D;
          tile_down_plain(as, a.TF, rows, w2 + static_cast<size_t>(f0) * D, D, tf, part);
        }
        __syncthreads();
      }
      grid.sync();

      // ---- C: partials in tile order -> residual ----
      const V* g2 = vec + 4 * D;
      const V* bias2 = vec + 5 * D;
      const float* sc2 = kInt4 ? a.s2 + static_cast<size_t>(nb) * D : nullptr;
      const bool last = nb == NB - 1;
      vv::reduce_tiles(a.part, a.ntiles, static_cast<size_t>(rows) * D, red,
                       [&](size_t e, float s) {
                         const int d = static_cast<int>(e % D);
                         const float ffn = kInt4 ? s * sc2[d] : s;
                         const float v = a.yg[base + e] +
                                         vv::to_f(g2[d]) * (ffn + vv::to_f(bias2[d]));
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

template <typename T, typename W>
int launch(ChainArgs a, cudaStream_t stream) {
  void (*kern)(ChainArgs) = chain_kernel<T, W>;
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

int check_sizes(int B, int T, int D, int F, int NB, int bg, int TF, int ntiles) {
  if (B <= 0 || T <= 0 || T > 8 || NB <= 0 || D <= 0 || F <= 0) return -1;
  if (bg <= 0 || bg > B || TF <= 0 || TF % 4 || TF > 64) return -2;
  if (ntiles != (F + TF - 1) / TF) return -3;
  return 0;
}

}  // namespace

extern "C" int vv_fused_block_chain(const void* x, const void* ctx, const void* vecs,
                                    const void* mixw, const void* w1q, const void* sb1,
                                    const void* w2q, const void* s2, void* y, void* ctx_out,
                                    void* xg, void* yg, void* part, int B, int T, int D, int F,
                                    int NB, int bg, int TF, int ntiles, float eps, int dtype,
                                    void* stream) {
  if (const int rc = check_sizes(B, T, D, F, NB, bg, TF, ntiles)) return rc;
  if (D % 2 || F % 2) return -1;
  ChainArgs a{x, ctx, vecs, mixw, w1q, static_cast<const float*>(sb1), w2q,
              static_cast<const float*>(s2), y, ctx_out, static_cast<float*>(xg),
              static_cast<float*>(yg), static_cast<float*>(part), B, T, D, F, NB, bg, TF, ntiles,
              eps};
  if (smem_bytes(a) > 227 * 1024) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, int8_t>(a, st);
  if (dtype == 1) return launch<__nv_bfloat16, int8_t>(a, st);
  return -5;  // unsupported dtype
}

// The plain-pack chain (TPU kernel `fused_block_chain`): vecs/mixw [N, 8, D],
// w1 [N, D+8, F], w2 [N, F, D], all of dtype code `wdtype`.
extern "C" int vv_fused_block_chain_plain(const void* x, const void* ctx, const void* vecs,
                                          const void* mixw, const void* w1, const void* w2,
                                          void* y, void* ctx_out, void* xg, void* yg, void* part,
                                          int B, int T, int D, int F, int NB, int bg, int TF,
                                          int ntiles, float eps, int dtype, int wdtype,
                                          void* stream) {
  if (const int rc = check_sizes(B, T, D, F, NB, bg, TF, ntiles)) return rc;
  ChainArgs a{x, ctx, vecs, mixw, w1, nullptr, w2, nullptr, y, ctx_out, static_cast<float*>(xg),
              static_cast<float*>(yg), static_cast<float*>(part), B, T, D, F, NB, bg, TF, ntiles,
              eps};
  if (smem_bytes(a) > 227 * 1024) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0) return launch<float, float>(a, st);
  if (dtype == 0 && wdtype == 1) return launch<float, __nv_bfloat16>(a, st);
  if (dtype == 1 && wdtype == 0) return launch<__nv_bfloat16, float>(a, st);
  if (dtype == 1 && wdtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, st);
  return -5;  // unsupported dtype
}
