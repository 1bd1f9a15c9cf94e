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
// 50 MB for its D=1024 stages.  At 1-32 rows a block's weights (16.8 MB or
// 4.2 MB int4) take 1-5 us to stream, so the latency of every grid-wide step
// between blocks counts as much as the bytes.
//
// The TPU kernel is one pallas_call whose grid runs in order and carries the
// activation in VMEM from block to block (the plain one once per batch row,
// under vmap).  Hopper runs blocks in parallel, so each pack has one launch
// that keeps the activation on chip and syncs the grid between blocks.
//
// int4 packs (`chain_q_kernel`): one launch of clusters of C = 8 CTAs (the
// portable size; `cudaLaunchKernelEx` with the cluster attribute), one CTA
// per SM, at most as many clusters as the card holds at once (every CTA must
// be resident for the grid barrier).  CTA k owns FFN columns
// [k*TF, (k+1)*TF) of every block (TF a multiple of 16 where D and F are, the
// whole width over the grid); rank q of a cluster owns D/C of the D columns.
// The CTA's slices of W1 ([D/2, TF] bytes, boxes of a 2-D tensor map) and
// W2 ([TF/2, D], one bulk copy) come into shared memory a block ahead, W1
// while the last block's down-projection runs, W2 while its shares are
// summed, the grid syncs and the next mixer runs; the rank's per-block
// vectors and context rows come by bulk copies a step ahead.  A thread that
// issues a copy waits as long as the bytes ahead of it in the engines' queue
// take, so one thread issues each, at a point where the copy's wait costs
// least.  Other widths take cp.async.  Per block:
//   1. mixer on the rank's columns: the rows' sums of squares of x go to
//      every CTA of the cluster (cluster barrier), h = rmsnorm(x) * norm_w,
//      the new context (cluster 0), y = x + gamma * (conv + mixer_b), and
//      y * ffn_norm_w with y's sums of squares stored into every CTA of the
//      cluster (cluster barrier): each CTA holds the whole FFN input and its
//      row scales;
//   2. up-projection of the CTA's columns (fp32 FMAs against nibbles made
//      fp32 exactly by prmt + a float subtract; k split over the threads,
//      the splits added in order), times the row scale, scale, bias, exact
//      GELU, in shared memory; the down-projection gives the CTA's share
//      [rows, D] of the FFN output;
//   3. cluster barrier; rank q adds the C shares of its columns in rank
//      order through distributed shared memory and writes them as the
//      cluster's fp32 partial (buffer n % 2 of the cached workspace);
//   4. the grid barrier (a counter in the workspace), the only one of the
//      block;
//   5. rank q of every cluster adds the clusters' partials of its columns in
//      cluster order and applies scale, bias, layer scale and residual: x of
//      the next block.  Cluster 0 writes y after the last.
// The partials alternate between two buffers: block n+2 writes buffer n % 2
// only after every CTA has passed block n+1's barrier, so none overwrites
// partials a slower CTA still reads.  Every sum runs in a fixed order, so two
// calls give the same bits.  Batches whose rows do not fit shared memory
// (at most 16 rows) run as row groups, one after another, in the launch.
//
// Plain packs (`chain_kernel`): one cooperative launch (about
// two CTAs per SM) with grid-wide barriers between phases, for every Block1D:
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
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16
// (x, ctx, y and the new ctx share one; a plain pack has its own).  Returns
// 0, a negative code for arguments or a card it does not take, or the CUDA
// error of the launch.

#include <cooperative_groups.h>
#include <cuda.h>

#include <cstring>
#include <map>
#include <set>
#include <tuple>
#include <type_traits>

#include "hopper_common.cuh"
#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace {

using vv::THREADS;
using vv::RC;
using vv::RED_FLOATS;
using vv::bulk_copy;
using vv::cp_async;
using vv::cp_commit;
using vv::cp_wait;
using vv::fence_async;
using vv::grid_barrier;
using vv::mbar_expect;
using vv::mbar_init;
using vv::mbar_wait;
using vv::nibbles_f32;
using vv::rank_sumsq;
using vv::row_scales;
using vv::smem_u32;
using vv::tma_box;
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

// ---- the int4 chain: one cluster launch, one grid barrier per block ----

constexpr int NT = 256;       // threads of a CTA of chain_q_kernel
constexpr int NW = NT / 32;
constexpr int RP = 8;         // rows per register pass
constexpr int MAX_C = 8;      // CTAs per cluster: the portable size
constexpr int RED_BATCH = 16; // partials of one element a thread has in flight
// per-block vectors a CTA keeps for its rank's columns: norm_w, mixer_b,
// gamma, ffn_norm_w, ffn_gamma, ffn2_b, the 7 taps, s2
constexpr int NVEC = 14;

struct QArgs {
  const void* x;
  const void* ctx;
  const float* vecs;  // [N, 8, D]
  const float* mixw;  // [N, 8, D]
  const int8_t* w1;   // [N, D/2, F]
  const float* sb1;   // [N, 2, F]
  const int8_t* w2;   // [N, F/2, D]
  const float* s2;    // [N, 1, D]
  void* y;
  void* ctx_out;
  float* part;        // [2][ncl][bg*T][D]: the clusters' partials, by block parity
  unsigned int* bar;  // the grid barrier's counter
  int B, T, D, F, NB, bg, TF, ncl, tiles, C;
  int br;             // W1 rows per tensor-map box; 0: no tensor map (cp.async)
  float eps;
};

// Rank q of a cluster owns the V-wide column groups [q*nv/C, (q+1)*nv/C) of
// nv = D/V (V = 4 where D is a multiple of 4): its mixer columns, and the
// columns whose sums it adds.
__host__ __device__ inline int q_vec(int D) { return D % 4 == 0 ? 4 : 1; }
__host__ __device__ inline int q_wmax(int D, int C) {
  const int V = q_vec(D), nv = D / V;
  return (nv + C - 1) / C * V;
}

// 32-column chunks of a rank's columns
__host__ __device__ inline int q_chunks(int D, int C) { return (q_wmax(D, C) + 31) / 32; }

// Byte offsets of chain_q_kernel's shared memory for row groups of bg items
// of T rows (`ops/fused_blocks.py:chain_smem` mirrors the total).
struct QLayout {
  size_t w1, w2, hb, xs, as, red, nrm, vs, cs, sb, mb, total;
};

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }

__host__ __device__ inline QLayout q_layout(int D, int TF, int bg, int T, int C) {
  QLayout L;
  const size_t rows = static_cast<size_t>(bg) * T, Dp = up16(D), nkl = NT / (TF / 4);
  const size_t rp = rows < RP ? rows : RP, wmax = q_wmax(D, C);
  size_t o = 0;
  L.w1 = o;   o += up16(static_cast<size_t>(D / 2) * TF);  // W1 slice [D/2][TF] bytes
  L.w2 = o;   o += up16(static_cast<size_t>(TF / 2) * Dp); // W2 slice [TF/2][Dp] bytes
  L.hb = o;   o += up16(sizeof(float) * rows * D);         // h, then ffn input, then the share
  L.xs = o;   o += up16(sizeof(float) * rows * wmax);      // x, then y, of the rank's columns
  L.as = o;   o += up16(sizeof(float) * rows * TF);        // gelu activations
  L.red = o;  o += up16(sizeof(float) * nkl * rp * TF);    // up-projection k splits
  // 32-column sums [rows][q_chunks], two exchanges [MAX_C][rows], two row scales
  L.nrm = o;  o += up16(sizeof(float) * (q_chunks(D, C) + 2 * MAX_C + 2) * rows);
  L.vs = o;   o += up16(sizeof(float) * 2 * NVEC * wmax);  // vectors, by step parity
  L.cs = o;   o += up16(sizeof(float) * 2 * bg * 6 * wmax); // ctx rows (x's dtype), by parity
  L.sb = o;   o += up16(sizeof(float) * 2 * 2 * TF);       // ffn1 scale and bias, by parity
  L.mb = o;   o += 4 * sizeof(uint64_t);                   // mbarriers: W1, W2, small x 2
  L.total = o + 128;  // the base is aligned up to 128 bytes (the tensor map's boxes)
  return L;
}


// nrows rows of `bytes` bytes from src (row stride sstride bytes) to dst
// (dstride); bytes at or past `live` of a row read 0.  Block-wide.
__device__ void copy_rows(void* dst_, size_t dstride, const void* src_, size_t sstride, int nrows,
                          int bytes, int live) {
  unsigned char* dst = static_cast<unsigned char*>(dst_);
  const unsigned char* src = static_cast<const unsigned char*>(src_);
  live = max(0, min(live, bytes));
  const size_t al = reinterpret_cast<uintptr_t>(src) | sstride | smem_u32(dst) | dstride |
                    static_cast<size_t>(bytes) | static_cast<size_t>(live);
  int vw = 16;
  while (vw >= 4 && al % vw) vw /= 2;
  if (vw < 4) {
    for (int e = threadIdx.x; e < nrows * bytes; e += NT) {
      const int r = e / bytes, c = e % bytes;
      dst[r * dstride + c] = c < live ? src[r * sstride + c] : 0;
    }
    return;
  }
  const int per = bytes / vw;
  for (int e = threadIdx.x; e < nrows * per; e += NT) {
    const int r = e / per, c = (e % per) * vw;
    cp_async(dst + r * dstride + c, c < live ? src + r * sstride + c : src, vw, c < live);
  }
}

// The CTA's slices of block nb's weights: W1 byte rows [0, D/2) x columns
// [f0, f0 + TF) as [D/2][TF] and W2 byte rows [f0/2, (f0 + TF)/2) as
// [TF/2][Dp], columns or rows past F 0 (W2's past F left as they are where
// the bulk-copy engine copies: the activations that meet them are 0).  With
// a tensor map (a.br > 0: D and TF multiples of 16), thread 0 asks the
// tensor-memory accelerator for W1 in boxes of [br rows][TF] and the
// bulk-copy engine for W2's contiguous run, completing on `bar`.  Otherwise
// cp.async by every thread.
__device__ void fetch_w1(const QArgs& a, const CUtensorMap* map, int nb, int f0,
                         unsigned char* dst, uint32_t bar) {
  const int D2 = a.D / 2, F = a.F, TF = a.TF;
  if (a.br) {
    if (threadIdx.x == 0) {
      fence_async();
      mbar_expect(bar, static_cast<uint32_t>(D2) * TF);
      for (int j = 0; j < D2; j += a.br)
        tma_box(dst + static_cast<size_t>(j) * TF, map, f0, nb * D2 + j, bar);
    }
    return;
  }
  const int8_t* src = a.w1 + static_cast<size_t>(nb) * D2 * F + f0;
  copy_rows(dst, TF, src, F, D2, TF, F - f0);
}

__device__ void fetch_w2(const QArgs& a, int nb, int f0, unsigned char* dst, uint32_t bar) {
  const int D = a.D, F2 = a.F / 2, R = a.TF / 2, r0 = f0 / 2;
  const int8_t* src = a.w2 + (static_cast<size_t>(nb) * F2 + r0) * D;
  const int live = max(0, min(R, F2 - r0));
  if (a.br) {
    if (threadIdx.x == 0) {
      fence_async();
      const uint32_t bytes = static_cast<uint32_t>(live) * D;
      mbar_expect(bar, bytes);
      bulk_copy(dst, src, bytes, bar);
    }
    return;
  }
  const int Dp = static_cast<int>(up16(D));
  for (int i = 0; i < R; ++i)
    copy_rows(dst + static_cast<size_t>(i) * Dp, Dp, src + static_cast<size_t>(i) * D, D, 1, Dp,
              i < live ? D : 0);
}

// The small operands of step `step` (block nb of its row group) into the
// buffers of the step's parity: the rank's columns [c0, c0 + w) of the block's
// vectors (vs [NVEC][wmax]) and of the group's context rows (cs [bg][6][wmax]
// in x's dtype), and the CTA's ffn1 scale and bias (sb [2][TF]).  `bulk`:
// every row is whole 16-byte vectors, and warp 0 hands them to the bulk-copy
// engine, completing on `bar`; otherwise copy_rows.
template <typename T>
__device__ void fetch_small(const QArgs& a, int step, int f0, bool has_tile, int c0, int w,
                            int wmax, float* vs, unsigned char* cs, float* sb, bool bulk,
                            uint32_t bar) {
  const int D = a.D, NB = a.NB, nb = step % NB, b0 = step / NB * a.bg;
  const int nbg = min(a.bg, a.B - b0), par = step % 2;
  const int live = has_tile ? max(0, min(a.TF, a.F - f0)) : 0;
  float* v = vs + par * NVEC * wmax;
  unsigned char* c = cs + par * a.bg * CTX * wmax * sizeof(T);
  float* s = sb + par * 2 * a.TF;
  const T* ctx = static_cast<const T*>(a.ctx);
  // row k: vecs rows 0-5, taps 0-6, s2; then the context rows; then s1, b1
  auto row = [&](int k, void*& dst, const void*& src, int& bytes) {
    if (k < 14) {
      dst = v + k * wmax;
      src = k < 6 ? a.vecs + (static_cast<size_t>(nb) * 8 + k) * D + c0
                  : k < 13 ? a.mixw + (static_cast<size_t>(nb) * 8 + k - 6) * D + c0
                           : a.s2 + static_cast<size_t>(nb) * D + c0;
      bytes = w * 4;
    } else if (k < 14 + CTX * nbg) {
      const int bl = (k - 14) / CTX, j = (k - 14) % CTX;
      dst = c + ((bl * CTX + j) * wmax) * sizeof(T);
      src = ctx + ((static_cast<size_t>(b0 + bl) * NB + nb) * CTX + j) * D + c0;
      bytes = w * sizeof(T);
    } else {
      const int j = k - 14 - CTX * nbg;
      dst = s + j * a.TF;
      src = a.sb1 + (static_cast<size_t>(nb) * 2 + j) * a.F + f0;
      bytes = live * 4;
    }
  };
  const int nrows = 14 + CTX * nbg + (live ? 2 : 0);
  if (bulk) {
    if (threadIdx.x < 32) {
      uint32_t total = 0;
      for (int k = 0; k < nrows; ++k) {
        void* dst;
        const void* src;
        int bytes;
        row(k, dst, src, bytes);
        total += bytes;
      }
      if (threadIdx.x == 0) {
        fence_async();
        mbar_expect(bar, total);
      }
      __syncwarp();
      for (int k = threadIdx.x; k < nrows; k += 32) {
        void* dst;
        const void* src;
        int bytes;
        row(k, dst, src, bytes);
        if (bytes) bulk_copy(dst, src, bytes, bar);
      }
    }
    return;
  }
  for (int k = 0; k < nrows; ++k) {
    void* dst;
    const void* src;
    int bytes;
    row(k, dst, src, bytes);
    copy_rows(dst, 0, src, 0, 1, bytes, bytes);
  }
}

// One register pass of R rows (R <= RP, a compile-time count, so no
// predicated FMAs for absent rows) of the up-projection: thread (cw, kl)'s
// sums over byte rows kl, kl + nkl, ... of packed word cw, into `red`.
template <int R>
__device__ __forceinline__ void up_pass(const unsigned char* w1s, const float* x0, int D, int TF,
                                        int cw, int kl, int nkl, int rp, float* red) {
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  constexpr int U = R > 4 ? 2 : 4;  // byte rows in flight, within the register budget
#pragma unroll U
  for (int i = kl; i < D / 2; i += nkl) {
    float lo[4], hi[4];
    nibbles_f32(*reinterpret_cast<const uint32_t*>(w1s + static_cast<size_t>(i) * TF + 4 * cw), lo,
                hi);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 xv = *reinterpret_cast<const float2*>(x0 + r * D + 2 * i);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv.y, hi[j], fmaf(xv.x, lo[j], acc[r][j]));
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(red + (kl * rp + r) * TF + 4 * cw) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// as[r][c] = gelu((hn[r] @ W1[:, f0 + c]) * rs2[r] * s1 + b1) for r < rows,
// c < TF (0 past F; s1 and b1 in sb [2][TF]): hn is the FFN input before
// its row scale rs2, which multiplies the product instead.  Thread (cw, kl)
// takes packed word cw (4 columns) of byte rows kl, kl + nkl, ...; the nkl k
// splits meet in `red` and are added in order.
__device__ void up_proj(const QArgs& a, int f0, const unsigned char* w1s, const float* hn,
                        const float* rs2, int rows, int rp, const float* sb, float* red,
                        float* as) {
  const int D = a.D, TF = a.TF, cgw = TF / 4, nkl = NT / cgw;
  const int cw = threadIdx.x % cgw, kl = threadIdx.x / cgw;
  for (int m0 = 0; m0 < rows; m0 += RP) {
    const int rr = min(RP, rows - m0);
    if (kl < nkl) {
      const float* x0 = hn + m0 * D;
      switch (rr) {
        case 1: up_pass<1>(w1s, x0, D, TF, cw, kl, nkl, rp, red); break;
        case 2: up_pass<2>(w1s, x0, D, TF, cw, kl, nkl, rp, red); break;
        case 3: up_pass<3>(w1s, x0, D, TF, cw, kl, nkl, rp, red); break;
        case 4: up_pass<4>(w1s, x0, D, TF, cw, kl, nkl, rp, red); break;
        case 5: up_pass<5>(w1s, x0, D, TF, cw, kl, nkl, rp, red); break;
        case 6: up_pass<6>(w1s, x0, D, TF, cw, kl, nkl, rp, red); break;
        case 7: up_pass<7>(w1s, x0, D, TF, cw, kl, nkl, rp, red); break;
        default: up_pass<8>(w1s, x0, D, TF, cw, kl, nkl, rp, red); break;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rr * TF; e += NT) {
      const int r = e / TF, c = e % TF;
      float s = 0.f;
#pragma unroll 8
      for (int l = 0; l < nkl; ++l) s += red[(l * rp + r) * TF + c];
      float v = 0.f;
      if (f0 + c < a.F) {
        v = s * rs2[m0 + r] * sb[c] + sb[TF + c];
        v = 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
      }
      as[(m0 + r) * TF + c] = v;
    }
    __syncthreads();
  }
}

// One register pass of R rows of the down-projection for packed word cw:
// share[r][4cw .. 4cw + 3] over every byte row of the W2 slice.
template <int R>
__device__ __forceinline__ void down_pass(const unsigned char* w2s, const float* a0, int D, int Dp,
                                          int TF, int cw, float* share) {
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  constexpr int U = R > 4 ? 2 : 4;
#pragma unroll U
  for (int i = 0; i < TF / 2; ++i) {
    float lo[4], hi[4];
    nibbles_f32(*reinterpret_cast<const uint32_t*>(w2s + static_cast<size_t>(i) * Dp + 4 * cw), lo,
                hi);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 av = *reinterpret_cast<const float2*>(a0 + r * TF + 2 * i);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av.y, hi[j], fmaf(av.x, lo[j], acc[r][j]));
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* dst = share + r * D + 4 * cw;
    if (D % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * cw + j < D) dst[j] = acc[r][j];
    }
  }
}

// share[r][d] = sum over c < TF of as[r][c] * W2[f0 + c][d] for r < rows,
// d < D; thread cw takes packed word cw (4 columns) over every byte row of
// the slice.
__device__ void down_proj(const QArgs& a, const unsigned char* w2s, const float* as, int rows,
                          float* share) {
  const int D = a.D, TF = a.TF, Dp = static_cast<int>(up16(D));
  for (int cw = threadIdx.x; 4 * cw < D; cw += NT) {
    for (int m0 = 0; m0 < rows; m0 += RP) {
      const float* a0 = as + m0 * TF;
      float* sh = share + m0 * D;
      switch (min(RP, rows - m0)) {
        case 1: down_pass<1>(w2s, a0, D, Dp, TF, cw, sh); break;
        case 2: down_pass<2>(w2s, a0, D, Dp, TF, cw, sh); break;
        case 3: down_pass<3>(w2s, a0, D, Dp, TF, cw, sh); break;
        case 4: down_pass<4>(w2s, a0, D, Dp, TF, cw, sh); break;
        case 5: down_pass<5>(w2s, a0, D, Dp, TF, cw, sh); break;
        case 6: down_pass<6>(w2s, a0, D, Dp, TF, cw, sh); break;
        case 7: down_pass<7>(w2s, a0, D, Dp, TF, cw, sh); break;
        default: down_pass<8>(w2s, a0, D, Dp, TF, cw, sh); break;
      }
    }
  }
}

template <int V>
__device__ __forceinline__ void ld_v(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void ldcg_v(float (&v)[V], const float* p) {  // not through L1
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldcg(p);
  }
}
template <int V>
__device__ __forceinline__ void st_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// Step 3 of a block, for V-wide column groups: rank q of the cluster adds
// its ranks' shares (in `hb`) of the rank's columns in rank order and writes
// them as the cluster's partial.
template <int V>
__device__ void cluster_partial(const QArgs& a, cg::cluster_group& cl, int step, float* hb,
                                int rows, int rows_max) {
  const int D = a.D, C = a.C, rank = static_cast<int>(cl.block_rank());
  const int cid = blockIdx.x / C, nv = D / V;
  const int u0 = rank * nv / C, wu = (rank + 1) * nv / C - u0;
  const size_t slab = static_cast<size_t>(rows_max) * D;
  float* part = a.part + (static_cast<size_t>(step % 2) * a.ncl + cid) * slab;
  cl.sync();  // every rank's share is in its shared memory
  for (int e = threadIdx.x; e < rows * wu; e += NT) {
    const int off = (e / wu) * D + (u0 + e % wu) * V;
    float s[V], v[MAX_C][V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0.f;
#pragma unroll
    for (int p = 0; p < MAX_C; ++p)
      if (p < C && cid * C + p < a.tiles) ld_v<V>(v[p], cl.map_shared_rank(hb, p) + off);
#pragma unroll
    for (int p = 0; p < MAX_C; ++p)
      if (p < C && cid * C + p < a.tiles)
#pragma unroll
        for (int j = 0; j < V; ++j) s[j] += v[p][j];
    st_v<V>(part + off, s);
  }
}

// Step 5 of a block: rank q of every cluster adds the clusters' partials of
// its columns in cluster order and keeps x = y + g2 * (sum * s2 + b2) for
// them in xs ([rows][wmax]); cluster 0 also writes them to y after the
// group's last block.
template <typename T, int V>
__device__ void next_x(const QArgs& a, cg::cluster_group& cl, int step, const float* v, int wmax,
                       float* xs, int rows, int rows_max, size_t base, bool last) {
  const int D = a.D, C = a.C, rank = static_cast<int>(cl.block_rank());
  const int cid = blockIdx.x / C, nv = D / V;
  const int u0 = rank * nv / C, wu = (rank + 1) * nv / C - u0;
  const size_t slab = static_cast<size_t>(rows_max) * D;
  const float* part = a.part + static_cast<size_t>(step % 2) * a.ncl * slab;
  const bool out = last && cid == 0;
  T* y_out = static_cast<T*>(a.y);
  for (int e = threadIdx.x; e < rows * wu; e += NT) {
    const int r = e / wu, c = (e % wu) * V, off = r * D + u0 * V + c;
    float s[V], p[RED_BATCH][V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0.f;
    for (int k0 = 0; k0 < a.ncl; k0 += RED_BATCH) {
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u)
        if (k0 + u < a.ncl) ldcg_v<V>(p[u], part + (k0 + u) * slab + off);
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u)
        if (k0 + u < a.ncl)
#pragma unroll
          for (int j = 0; j < V; ++j) s[j] += p[u][j];
    }
    float x[V];
    float* xr = xs + r * wmax + c;
#pragma unroll
    for (int j = 0; j < V; ++j)
      x[j] = xr[j] + v[4 * wmax + c + j] * (s[j] * v[13 * wmax + c + j] + v[5 * wmax + c + j]);
    st_v<V>(xr, x);
    if (out)
#pragma unroll
      for (int j = 0; j < V; ++j) y_out[base + off + j] = vv::from_f<T>(x[j]);
  }
}

// Step 1 of a block, on the rank's columns [c0, c0 + w) (x and then y in xs
// [rows][wmax], vectors in v, the group's context rows in cs): h =
// rmsnorm(x) * norm_w, the new context (cluster 0), y = x + gamma * (conv +
// mixer_b), and the FFN input y * ffn_norm_w stored into hb of every CTA of
// the cluster with this rank's sums of squares of y, so that after the
// second cluster barrier each CTA holds all of it and its row scales rs2.
template <typename T>
__device__ void mixer(const QArgs& a, cg::cluster_group& cl, int nb, int b0, int nbg, int c0,
                      int w, const float* v, const T* cs, int wmax, float* xs, float* hb,
                      float* nrm, float* xch, float* rs1, float* rs2) {
  const int D = a.D, Tn = a.T, NB = a.NB, C = a.C, rows = nbg * Tn;
  float* xch2 = xch + MAX_C * a.bg * Tn;
  rank_sumsq<NW>(cl, xs, wmax, rows, w, nrm, xch);
  cl.sync();
  row_scales(C, xch, rows, D, a.eps, rs1);
  for (int e = threadIdx.x; e < rows * w; e += NT) {
    const int r = e / w, c = e % w;
    hb[r * D + c0 + c] = xs[r * wmax + c] * rs1[r] * v[c];
  }
  __syncthreads();
  if (blockIdx.x < C) {  // cluster 0: the new context, the last 6 rows of [ctx; h]
    T* ctx_out = static_cast<T*>(a.ctx_out);
    for (int e = threadIdx.x; e < nbg * CTX * w; e += NT) {
      const int bl = e / (CTX * w), j = (e / w) % CTX, c = e % w;
      const int src = j + Tn;
      const size_t cbase = (static_cast<size_t>(b0 + bl) * NB + nb) * CTX;
      const float val = src < CTX ? vv::to_f(cs[(bl * CTX + src) * wmax + c])
                                  : hb[(bl * Tn + src - CTX) * D + c0 + c];
      ctx_out[(cbase + j) * D + c0 + c] = vv::from_f<T>(val);
    }
  }
  for (int e = threadIdx.x; e < rows * w; e += NT) {  // one (frame, column) each
    const int r = e / w, c = e % w, bl = r / Tn, t = r % Tn;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int j = t + k;
      const float src = j < CTX ? vv::to_f(cs[(bl * CTX + j) * wmax + c])
                                : hb[(bl * Tn + j - CTX) * D + c0 + c];
      acc = acc + src * v[(6 + k) * wmax + c];
    }
    xs[r * wmax + c] = xs[r * wmax + c] + v[2 * wmax + c] * (acc + v[wmax + c]);
  }
  __syncthreads();
  rank_sumsq<NW>(cl, xs, wmax, rows, w, nrm, xch2);
  if (w % 4 == 0 && c0 % 4 == 0 && D % 4 == 0) {  // 16-byte stores to the peers
    const int w4 = w / 4;
    for (int e = threadIdx.x; e < rows * w4; e += NT) {
      const int r = e / w4, c = 4 * (e % w4), o = r * D + c0 + c;
      const float4 y = *reinterpret_cast<const float4*>(xs + r * wmax + c);
      const float4 g = *reinterpret_cast<const float4*>(v + 3 * wmax + c);
      const float4 u = make_float4(y.x * g.x, y.y * g.y, y.z * g.z, y.w * g.w);
      for (int p = 0; p < C; ++p) *reinterpret_cast<float4*>(cl.map_shared_rank(hb, p) + o) = u;
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += NT) {
      const int r = e / w, c = e % w;
      const float u = xs[r * wmax + c] * v[3 * wmax + c];
      for (int p = 0; p < C; ++p) cl.map_shared_rank(hb, p)[r * D + c0 + c] = u;
    }
  }
  cl.sync();  // the FFN input is whole in every CTA of the cluster, and the sums of squares
  row_scales(C, xch2, rows, D, a.eps, rs2);
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    chain_q_kernel(const __grid_constant__ CUtensorMap w1map, const QArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smc = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  cg::cluster_group cl = cg::this_cluster();
  const int D = a.D, Tn = a.T, NB = a.NB, C = a.C, rows_max = a.bg * Tn;
  const QLayout L = q_layout(D, a.TF, a.bg, Tn, C);
  unsigned char* w1s = smc + L.w1;
  unsigned char* w2s = smc + L.w2;
  float* hb = reinterpret_cast<float*>(smc + L.hb);
  float* xs = reinterpret_cast<float*>(smc + L.xs);
  float* as = reinterpret_cast<float*>(smc + L.as);
  float* red = reinterpret_cast<float*>(smc + L.red);
  float* nrm = reinterpret_cast<float*>(smc + L.nrm);  // then the exchanges, then rs1, rs2
  float* xch = nrm + q_chunks(D, C) * rows_max;
  float* rs1 = xch + 2 * MAX_C * rows_max;
  float* rs2 = rs1 + rows_max;
  float* vs = reinterpret_cast<float*>(smc + L.vs);
  unsigned char* cs = smc + L.cs;
  float* sb = reinterpret_cast<float*>(smc + L.sb);
  const uint32_t mb = smem_u32(smc + L.mb);  // W1, W2, small (even steps), small (odd)
  const T* x_in = static_cast<const T*>(a.x);
  const int V = q_vec(D), nv = D / V, rank = static_cast<int>(cl.block_rank());
  const int c0 = rank * nv / C * V, w = ((rank + 1) * nv / C) * V - c0, wmax = q_wmax(D, C);
  const bool has_tile = blockIdx.x < a.tiles;
  const int es = static_cast<int>(sizeof(T));
  const bool bulk = a.br && (w * es) % 16 == 0 && (c0 * es) % 16 == 0 && (wmax * es) % 16 == 0 &&
                    (D * es) % 16 == 0 && reinterpret_cast<uintptr_t>(a.ctx) % 16 == 0;
  const int f0 = blockIdx.x * a.TF, rp = min(RP, rows_max);
  const int steps = (a.B + a.bg - 1) / a.bg * NB;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) mbar_init(mb + 8 * k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // copies in flight, in cp.async groups (and on the mbarriers where the
  // engines copy): the small operands of a step one step ahead, W1 and W2 one
  // block ahead
  fetch_small<T>(a, 0, f0, has_tile, c0, w, wmax, vs, cs, sb, bulk, mb + 16);
  cp_commit();
  if (has_tile) fetch_w1(a, &w1map, 0, f0, w1s, mb);
  cp_commit();
  if (has_tile) fetch_w2(a, 0, f0, w2s, mb + 8);
  cp_commit();
  for (int step = 0; step < steps; ++step) {
    const int nb = step % NB, b0 = step / NB * a.bg, par = step % 2;
    const int nbg = min(a.bg, a.B - b0), rows = nbg * Tn;
    const size_t base = static_cast<size_t>(b0) * Tn * D;
    const bool more = step + 1 < steps;
    const float* v = vs + par * NVEC * wmax;
    // every thread is done with the last step (its small operands, which
    // the next copies overwrite, and its columns of xs)
    __syncthreads();
    if (more)
      fetch_small<T>(a, step + 1, f0, has_tile, c0, w, wmax, vs, cs, sb, bulk,
                     mb + 16 + 8 * (1 - par));
    cp_commit();
    cp_wait<3>();  // this step's small operands
    if (bulk) mbar_wait(mb + 16 + 8 * par, (step >> 1) & 1);
    if (nb == 0)
      for (int e = threadIdx.x; e < rows * w; e += NT) {
        const int r = e / w, c = e % w;
        xs[r * wmax + c] = vv::to_f(x_in[base + static_cast<size_t>(r) * D + c0 + c]);
      }
    __syncthreads();
    mixer<T>(a, cl, nb, b0, nbg, c0, w, v,
             reinterpret_cast<const T*>(cs + par * a.bg * CTX * wmax * sizeof(T)), wmax, xs, hb,
             nrm, xch, rs1, rs2);
    cp_wait<2>();  // this block's W1 slice
    if (has_tile && a.br) mbar_wait(mb, step & 1);
    __syncthreads();
    if (has_tile) up_proj(a, f0, w1s, hb, rs2, rows, rp, sb + par * 2 * a.TF, red, as);
    if (more && has_tile) fetch_w1(a, &w1map, (step + 1) % NB, f0, w1s, mb);
    cp_commit();
    cp_wait<2>();  // this block's W2 slice
    if (has_tile && a.br) mbar_wait(mb + 8, step & 1);
    __syncthreads();
    if (has_tile) down_proj(a, w2s, as, rows, hb);
    __syncthreads();
    if (more && has_tile) fetch_w2(a, (step + 1) % NB, f0, w2s, mb + 8);
    cp_commit();
    if (V == 4)
      cluster_partial<4>(a, cl, step, hb, rows, rows_max);
    else
      cluster_partial<1>(a, cl, step, hb, rows, rows_max);
    grid_barrier(a.bar);  // the block's only grid-wide barrier
    if (V == 4)
      next_x<T, 4>(a, cl, step, v, wmax, xs, rows, rows_max, base, nb == NB - 1);
    else
      next_x<T, 1>(a, cl, step, v, wmax, xs, rows, rows_max, base, nb == NB - 1);
  }
  cl.sync();  // no peer reads this CTA's shared memory after it exits
}


// W1 rows per tensor-map box: the most (at most 256, the box limit) that
// divide D/2, so every box lies within one block's W1; 0 where the tensor
// map does not apply (rows of W1 or the slice not whole 16-byte vectors, or
// a slice wider than a box).
int q_box_rows(int D, int F, int TF) {
  if (D % 16 || F % 16 || TF % 16 || TF > 256) return 0;
  int br = D / 2 < 256 ? D / 2 : 256;
  while ((D / 2) % br) --br;
  return br;
}

// w1q [N, D/2, F] as a 2-D map of N*D/2 rows of F bytes, boxes [br][TF];
// columns past F read as zeros.  The map is cached per pack and shape.
int q_w1_map(CUtensorMap* map, const QArgs& a) {
  static std::map<std::tuple<const void*, int, int, int, int, int>, CUtensorMap> maps;
  const auto key = std::make_tuple(static_cast<const void*>(a.w1), a.NB, a.D, a.F, a.TF, a.br);
  auto it = maps.find(key);
  if (it == maps.end()) {
    CUtensorMap m;
    if (const int rc = vv::encode_u8_2d(&m, a.w1, a.F, static_cast<uint64_t>(a.NB) * (a.D / 2),
                                        a.TF, a.br))
      return rc;
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return 0;
}

// Raises chain_q_kernel's shared-memory limit, once per device.
int q_opt_in() {
  static std::set<int> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!opted.count(dev)) {
    void (*kerns[2])(CUtensorMap, QArgs) = {chain_q_kernel<float>, chain_q_kernel<__nv_bfloat16>};
    for (auto k : kerns) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    opted.insert(dev);
  }
  return 0;
}

// chain_q_kernel<T>'s launch configuration: grid `ctas`, clusters of C
cudaLaunchConfig_t q_config(int ctas, int C, size_t smem, cudaStream_t stream,
                            cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of C CTAs of chain_q_kernel<T> that the card holds at once with
// `smem` bytes of shared memory each, into *out (0 if none).
template <typename T>
int q_clusters(size_t smem, int C, int* out) {
  if (const int rc = q_opt_in()) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = q_config(C, C, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, chain_q_kernel<T>, &cfg));
}

template <typename T>
int launch_q(const QArgs& a, size_t smem, cudaStream_t stream) {
  if (const int rc = q_opt_in()) return rc;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.br)
    if (const int rc = q_w1_map(&map, a)) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = q_config(a.ncl * a.C, a.C, smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, chain_q_kernel<T>, map, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The int4 chain's clusters of C CTAs that the card holds at once with
// `smem` bytes of shared memory per CTA, into *out (the launch's grid may not
// exceed them: its grid barrier needs every CTA resident).
extern "C" int vv_fused_block_chain_clusters(long long smem, int C, int dtype, int* out) {
  if (C < 1 || C > MAX_C || smem <= 0 || smem > 227 * 1024) return -4;
  if (dtype == 0) return q_clusters<float>(static_cast<size_t>(smem), C, out);
  if (dtype == 1) return q_clusters<__nv_bfloat16>(static_cast<size_t>(smem), C, out);
  return -5;  // unsupported dtype
}

// The int4 chain (TPU kernel `fused_block_chain_batched`): ncl clusters of C
// CTAs, CTA k on FFN columns [k*TF, (k+1)*TF); bg batch items per row group;
// `part` the workspace of 2 * ncl * bg * T * D floats, `bar` the barrier's
// counter (0 before the first launch; every launch leaves its low bits 0).
extern "C" int vv_fused_block_chain(const void* x, const void* ctx, const void* vecs,
                                    const void* mixw, const void* w1q, const void* sb1,
                                    const void* w2q, const void* s2, void* y, void* ctx_out,
                                    void* part, void* bar, int B, int T, int D, int F, int NB,
                                    int bg, int TF, int ncl, int C, float eps, int dtype,
                                    void* stream) {
  if (B <= 0 || T <= 0 || T > 8 || NB <= 0 || D <= 0 || F <= 0 || D % 2 || F % 2) return -1;
  if (bg <= 0 || bg > B || TF <= 0 || TF % 4 || TF > 4 * NT || C < 1 || C > MAX_C ||
      part == nullptr || bar == nullptr)
    return -2;
  const int tiles = (F + TF - 1) / TF;
  if (ncl != (tiles + C - 1) / C) return -3;
  const size_t smem = q_layout(D, TF, bg, T, C).total;
  if (smem > 227 * 1024) return -4;
  QArgs a{x, ctx, static_cast<const float*>(vecs), static_cast<const float*>(mixw),
          static_cast<const int8_t*>(w1q), static_cast<const float*>(sb1),
          static_cast<const int8_t*>(w2q), static_cast<const float*>(s2), y, ctx_out,
          static_cast<float*>(part), static_cast<unsigned int*>(bar), B, T, D, F, NB, bg, TF,
          ncl, tiles, C, q_box_rows(D, F, TF), eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_q<float>(a, smem, st);
  if (dtype == 1) return launch_q<__nv_bfloat16>(a, smem, st);
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
