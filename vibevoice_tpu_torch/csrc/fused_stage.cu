// Fused large-T sigma-VAE stage (N Block1Ds over T rows, with optional folded
// transition conv and decoder tail), for Hopper (sm_90a).
//
// Replaces the TPU kernels `vibevoice_tpu/ops/fused_stage.py:fused_stage_chain`
// (Pallas `_make_kernel`) and `_fused_stage_chain_rowlane` (`_make_kernel_rowlane`).
// For x [B, T, W] (the row-lane form is the same call on [G, T, R*D], with
// block-diagonal FFN weights, a separate ffn1 bias and RMSNorm group means
// through `avg` [W, W]) and per-block contexts ctx [B, N, 6, W], each block:
//   h  = rmsnorm(x) * norm_w;  new ctx = last 6 rows of [ctx; h]
//   x  = x + gamma * (mixer_b + causal depthwise conv k=7 over [ctx; h])
//   hn = round(rmsnorm(x) * ffn_norm_w)
//   a  = round(gelu_exact(b1 + hn @ w1))
//   x  = x + ffn_gamma * (a @ w2 + ffn2_b)
// fp32 throughout; round() = to the pack dtype, as the matmul inputs of the
// TPU kernel.  Folds (conv_kind): 1 = transposed "up" conv (k = 2s) from
// x_in [B, T/s, Cin], out[i*s+j] = x[i] @ Wc[j] + x[i-1] @ Wc[s+j] + b, the
// carried tail being the bias-free x[last] @ Wc[s+j]; 2 = strided "down" conv
// from [context (k-s rows); x_in [B, T*s, Cin]], out[t] = sum_tau
// full[t*s+tau] @ Wc[tau] + b.  hk > 0 folds the tail: hh = rmsnorm(x) *
// head_w[0] over [head ctx (hk-1 rows); x], y[t] = sum_tap hh[t-hk+1+tap] .
// head_w[1+tap] -> y [B, T, 1].
//
// Bound: a stage moves a few MB at most (decoder stage 3 at 1.5B: 3.2 MB of
// block weights and 2.6 MB of up-conv weight in bf16) and computes 0.2-0.7
// GFLOP, so on this card the least time is 0.2-2 us: the kernel is bound by
// latency and parallelism, not by bytes or the tensor cores.
//
// Design: the TPU grid walks T-tiles in order and carries every block's conv
// context in VMEM.  On Hopper, in order, one CTA would own the stage at B=1.
// Here ONE cooperative launch spreads each phase over the grid, with grid
// barriers between phases:
//   P. (folded conv) the conv as a tiled product into `xg`: "up" x_in @ every
//      tap's weight ([Ti, 2s*W], the overlap-add is left to phase A), "down"
//      the strided windows of [context; x_in] @ the flattened [k*Cin, W]
//      weight; CTA 0 copies the new down-conv context;
//   then per block:
//   A. items of RT rows: the block input of the rows and of the 6 rows
//      before them (`xb`; block 0: x, or the conv's product plus bias and
//      overlap) is normed, convolved with [ctx; h], and written as the
//      residual to `yg` and the rounded FFN input to `hng`; the last item
//      writes the new context (and, block 0, the new transposed-conv tail);
//   -- grid barrier --
//   B. items of RB rows x FT FFN columns: gelu(hn @ w1[:, tile] + b1) stays
//      in shared memory; a @ w2[tile, :] goes to the fp32 partials `part`;
//   -- grid barrier --
//   C. the whole grid adds the partials in tile order (no float atomics, the
//      same result on every run) into the next block's input `xb`;
//   -- grid barrier --
//   O. items of RT rows write y in the activation dtype, or, with the folded
//      tail, the waveform rows (one warp per row) and the new head context.
// So results do not depend on the grid or on the JAX package's `tile_want`.
// The products run as fp32 FMAs on the CUDA cores from 4x4 (conv: 1x4)
// register tiles; every weight tile is staged through shared memory in
// chunks of KC rows with 16-byte loads, so a thread waits for one load
// latency per chunk rather than per row.  mma/wgmma are left for later.
//
// Plain C interface, loaded with ctypes (`StageParams` mirrors the ctypes
// structure in ops/fused_stage.py).  dtype codes: 0 float32, 1 bfloat16 (x,
// ctx, the states, the pack and the conv pack share it; avg and head_w are
// fp32).  Returns 0, a negative code for arguments or a card it does not
// take, or the CUDA error of the launch.

#include <cooperative_groups.h>

#include <algorithm>

#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace {

using vv::THREADS;
using vv::WARPS;
constexpr int CTX = 6;
constexpr int RT = 32;   // rows per mixer / output item
constexpr int RB = 64;   // rows per FFN item (16 row groups of 4)
constexpr int FT = 64;   // FFN columns per item (16 column groups of 4)
constexpr int RP = 16;   // output rows per conv item (16 row groups of 1)
constexpr int NT = 64;   // columns per product tile
constexpr int KC = 128;  // weight rows per shared-memory chunk
constexpr int LB = 8;    // independent loads a thread has in flight before using them

struct StageParams {
  const void* x;
  const void* ctx;
  const void* conv_state;
  const void* head_state;
  const void* vecs;
  const void* mixw;
  const void* w1;
  const void* b1;
  const void* w2;
  const float* avg;     // row-lane group means, or null
  const void* conv_w;   // [k, cin, W]
  const void* conv_b;   // [1, W]
  const float* head_w;  // [hk + 1, W]
  void* y;
  void* ctx_out;
  void* conv_out;
  void* head_out;
  float* xg;    // folded conv product: up [B*T/s, 2s*W], down [B*T, W]
  float* yg;    // [B*T, W] post-mixer residual
  float* xb;    // [B*T, W] input of the next block
  float* hng;   // [B*T, W] rounded FFN input
  float* part;  // [nF][B*T, W] FFN partials
  int B, T, W, F, NB, w1_stride, b1_stride, conv_kind, cs, ck, cin, hk, hnorm, dtype;
  float eps;
};

__device__ __forceinline__ float gelu(float a) {
  return 0.5f * a * (1.f + erff(a * 0.7071067811865476f));
}

// four consecutive values at p in shared memory (16-byte aligned for float,
// 8 for bf16)
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc[i][j] += sum_{k < K} A[(RR*rg + i) * lda + k] * B[k][4*cg + j] for the
// thread's RR rows (rg = tid / 16) and 4 columns (cg = tid % 16).  A is fp32
// in shared memory; B (K x ncols, row stride ldb, 16-byte aligned rows,
// ncols <= NT a multiple of the 16-byte vector) is in device memory and goes
// through the shared buffer `bs` (KC x NT) a chunk at a time.  Block-wide.
template <typename T, int RR>
__device__ void gemm_tile(const float* A, int lda, int K, const T* b, size_t ldb, int ncols,
                          T* bs, float (&acc)[RR][4]) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int vpr = ncols / V;
  const int cg = threadIdx.x % 16, rg = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0), nv = kc * vpr;
    __syncthreads();  // the previous chunk is consumed
    for (int v0 = threadIdx.x; v0 < nv; v0 += LB * THREADS) {
      uint4 u[LB];
#pragma unroll
      for (int q = 0; q < LB; ++q) {
        const int v = v0 + q * THREADS;
        if (v < nv)
          u[q] = __ldg(reinterpret_cast<const uint4*>(b + (k0 + v / vpr) * ldb + v % vpr * V));
      }
#pragma unroll
      for (int q = 0; q < LB; ++q) {
        const int v = v0 + q * THREADS;
        if (v < nv) *reinterpret_cast<uint4*>(bs + v / vpr * NT + v % vpr * V) = u[q];
      }
    }
    __syncthreads();
    if (4 * cg < ncols) {
      const float* a0 = A + RR * rg * lda + k0;
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        const float4 w = lds4(bs + k * NT + 4 * cg);
#pragma unroll
        for (int i = 0; i < RR; ++i) {
          const float a = a0[i * lda + k];
          acc[i][0] += a * w.x;
          acc[i][1] += a * w.y;
          acc[i][2] += a * w.z;
          acc[i][3] += a * w.w;
        }
      }
    }
  }
  __syncthreads();
}

// dst[e] = e < n ? src[e] : 0 for e < total (both multiples of 4, src 16-byte
// aligned): LB float4 loads in flight per thread
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n, int total) {
  for (int e0 = 4 * threadIdx.x; e0 < total; e0 += 4 * THREADS * LB) {
    float4 v[LB];
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int e = e0 + 4 * THREADS * u;
      v[u] = e < n ? *reinterpret_cast<const float4*>(src + e) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int e = e0 + 4 * THREADS * u;
      if (e < total) *reinterpret_cast<float4*>(dst + e) = v[u];
    }
  }
}

// The input of block 0 at (row, d): x, or the folded conv's output (its
// product plus the overlap of the previous input frame, or the carried tail,
// plus bias).
template <typename T>
__device__ __forceinline__ float stage_input(const StageParams& p, size_t row, int d) {
  const int W = p.W;
  if (p.conv_kind == 0) return vv::to_f(static_cast<const T*>(p.x)[row * W + d]);
  const float b = vv::to_f(static_cast<const T*>(p.conv_b)[d]);
  if (p.conv_kind == 2) return p.xg[row * W + d] + b;
  const int s = p.cs, tin = p.T / s;
  const size_t bb = row / p.T;
  const int t = static_cast<int>(row % p.T), i = t / s, j = t % s;
  const float* yi = p.xg + (bb * tin + i) * 2 * s * W;
  const float prev = i > 0 ? yi[(s + j) * W + d - 2 * s * W]
                           : vv::to_f(static_cast<const T*>(p.conv_state)[(bb * s + j) * W + d]);
  return (yi[j * W + d] + prev) + b;
}

// ---- C: xb = residual + ffn_gamma * (FFN partials, in tile order, + ffn2_b)
// over the whole grid; 4 elements per thread and LB partials each in flight
template <typename T>
__device__ void phase_sum(const StageParams& p, int nb) {
  const int W = p.W, nf = (p.F + FT - 1) / FT;
  const T* vec = static_cast<const T*>(p.vecs) + static_cast<size_t>(nb) * 8 * W;
  const size_t n_el = static_cast<size_t>(p.B) * p.T * W;
  const size_t step = static_cast<size_t>(gridDim.x) * THREADS;
  for (size_t e0 = blockIdx.x * THREADS + threadIdx.x; e0 < n_el; e0 += 4 * step) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int f0 = 0; f0 < nf; f0 += LB / 2) {
      float v[4][LB / 2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < LB / 2; ++q)
          v[u][q] = e0 + u * step < n_el && f0 + q < nf ? p.part[(f0 + q) * n_el + e0 + u * step]
                                                        : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < LB / 2; ++q) s[u] += v[u][q];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t e = e0 + u * step;
      if (e < n_el) {
        const int d = static_cast<int>(e % W);
        p.xb[e] = p.yg[e] + vv::to_f(vec[4 * W + d]) * (s[u] + vv::to_f(vec[5 * W + d]));
      }
    }
  }
}

// xs[j * W + d] = the input of block nb (`stage_input`, or `xb` of phase C)
// at row lo + j of the batch row that starts at row0 (0 before the
// sequence), for j < nrow
template <typename T>
__device__ void load_rows(const StageParams& p, int nb, size_t row0, int lo, int nrow, float* xs) {
  const int W = p.W, n = nrow * W;
  if (nb > 0) {  // a plain copy of `xb`, 16-byte vectors
    const int skip = max(0, -lo);
    for (int e = threadIdx.x; e < skip * W; e += THREADS) xs[e] = 0.f;
    copy_rows(xs + skip * W, p.xb + (row0 + lo + skip) * W, n - skip * W, n - skip * W);
    return;
  }
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * THREADS) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS, t = lo + e / W;
      v[u] = e < n && t >= 0 ? stage_input<T>(p, row0 + t, e % W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * THREADS < n) xs[e0 + u * THREADS] = v[u];
  }
}

// sc = 1 / sqrt(mean-square + eps) of buf's nrow (<= RB) rows: per row
// (sc[j]) or, with the row-lane `avg`, per element: sc[j * W + d] from the
// product (buf * buf) @ avg, tiled through `sq` ([RB][W]) and the chunk
// buffer `bsf` (KC x NT fp32).  Block-wide.
__device__ void inv_rms(const StageParams& p, const float* buf, int nrow, float* sc, float* sq,
                        float* bsf) {
  const int W = p.W;
  if (p.avg == nullptr) {
    vv::row_rsqrt(buf, nrow, W, p.eps, sc);
    return;
  }
  for (int e = threadIdx.x; e < RB * W; e += THREADS) {
    const float v = e < nrow * W ? buf[e] : 0.f;
    sq[e] = v * v;
  }
  const int c0 = 4 * (threadIdx.x % 16), rg = threadIdx.x / 16;
  for (int d0 = 0; d0 < W; d0 += NT) {
    const int nc = min(NT, W - d0);
    float acc[4][4] = {};
    gemm_tile<float, 4>(sq, W, W, p.avg + d0, W, nc, bsf, acc);  // syncs before reading sq
    if (c0 < nc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rg + i;
        if (r < nrow) {
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[r * W + d0 + c0 + j] = 1.f / sqrtf(acc[i][j] + p.eps);
        }
      }
    }
  }
}

__device__ __forceinline__ float sc_at(const StageParams& p, const float* sc, int j, int d) {
  return p.avg ? sc[j * p.W + d] : sc[j];
}

// ---- P: the folded transition conv's product ----
template <typename T>
__device__ void phase_conv(const StageParams& p, float* sm) {
  const T* x = static_cast<const T*>(p.x);
  const T* cw = static_cast<const T*>(p.conv_w);
  const T* st = static_cast<const T*>(p.conv_state);
  const int W = p.W, Tn = p.T, s = p.cs, k = p.ck, cin = p.cin;
  const bool up = p.conv_kind == 1;
  const int ctxlen = k - s;
  const int tin = up ? Tn / s : Tn * s;
  // up: rows are input frames, columns every tap's channels; down: rows are
  // output rows, columns the channels
  const int mrows = up ? tin : Tn, ncol = up ? 2 * s * W : W;
  const int dtiles = (W + NT - 1) / NT, ntiles = (up ? 2 * s : 1) * dtiles;
  const int mtiles = (mrows + RP - 1) / RP;
  // A rows in shared memory: up x_in[m0 + r], down full[m0*s .. (m0+RP-1)*s + k)
  const int arows = up ? RP : (RP - 1) * s + k, lda = up ? cin : s * cin;
  float* As = sm;
  T* bs = reinterpret_cast<T*>(As + (arows * cin + 3) / 4 * 4);
  for (int it = blockIdx.x; it < p.B * mtiles * ntiles; it += gridDim.x) {
    const int bb = it / (mtiles * ntiles), mt = (it / ntiles) % mtiles, nt = it % ntiles;
    const int m0 = mt * RP, mr = min(RP, mrows - m0);
    // a tile is NT channels of one tap
    const int tap = nt / dtiles, d0 = (nt % dtiles) * NT, n0 = tap * W + d0;
    const int nc = min(NT, W - d0);
    const int f_lo = up ? m0 : m0 * s;
    const int nin = arows * cin;
    for (int e0 = threadIdx.x; e0 < nin; e0 += LB * THREADS) {
      float v[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int e = e0 + u * THREADS, f = f_lo + e / cin, c = e % cin;
        v[u] = 0.f;
        if (e >= nin) continue;
        if (up) {
          if (f < tin) v[u] = vv::to_f(x[(static_cast<size_t>(bb) * tin + f) * cin + c]);
        } else if (f < ctxlen) {
          v[u] = vv::to_f(st[(static_cast<size_t>(bb) * ctxlen + f) * cin + c]);
        } else if (f - ctxlen < tin) {
          v[u] = vv::to_f(x[(static_cast<size_t>(bb) * tin + f - ctxlen) * cin + c]);
        }
      }
#pragma unroll
      for (int u = 0; u < LB; ++u)
        if (e0 + u * THREADS < nin) As[e0 + u * THREADS] = v[u];
    }
    float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    gemm_tile<T, 1>(As, lda, up ? cin : k * cin, cw + static_cast<size_t>(tap) * cin * W + d0, W,
                    nc, bs, acc);
    const int r = threadIdx.x / 16, c0 = 4 * (threadIdx.x % 16);
    if (r < mr && c0 < nc) {
      float* out = p.xg + (static_cast<size_t>(bb) * mrows + m0 + r) * ncol + n0 + c0;
      *reinterpret_cast<float4*>(out) = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    }
  }
  if (!up && blockIdx.x == 0) {  // new context: the last k-s rows of [context; x_in]
    T* out = static_cast<T*>(p.conv_out);
    for (int e = threadIdx.x; e < p.B * ctxlen * cin; e += THREADS) {
      const int bb = e / (ctxlen * cin), j = (e / cin) % ctxlen, c = e % cin;
      const int f = tin + j;
      out[e] = f < ctxlen ? st[(static_cast<size_t>(bb) * ctxlen + f) * cin + c]
                          : x[(static_cast<size_t>(bb) * tin + f - ctxlen) * cin + c];
    }
  }
}

// ---- A: norm, context, mixer, second norm ----
template <typename T>
__device__ void phase_mixer(const StageParams& p, int nb, float* sm) {
  const int W = p.W, Tn = p.T, NB = p.NB;
  const T* vec = static_cast<const T*>(p.vecs) + static_cast<size_t>(nb) * 8 * W;
  const T* taps = static_cast<const T*>(p.mixw) + static_cast<size_t>(nb) * 8 * W;
  const T* ctx_in = static_cast<const T*>(p.ctx);
  T* ctx_out = static_cast<T*>(p.ctx_out);
  float* vs = sm;                     // [11][W]: norm_w, mixer_b, gamma, ffn_norm_w, 7 taps
  float* xs = vs + 11 * W;            // [RT + 6][W] block input, then residual
  float* hs = xs + (RT + CTX) * W;    // [RT + 6][W] normed rows over [ctx; h]
  float* sc = hs + (RT + CTX) * W;    // inverse RMS: [RT + 6] or, row-lane, [RT + 6][W]
  float* sq = sc + (RT + CTX) * W;    // row-lane: [RB][W] squares
  float* bsf = sq + RB * W;           // row-lane: [KC][NT] avg chunk
  for (int e = threadIdx.x; e < 11 * W; e += THREADS)
    vs[e] = vv::to_f(e < 4 * W ? vec[e] : taps[e - 4 * W]);
  const int tiles = (Tn + RT - 1) / RT;
  for (int it = blockIdx.x; it < p.B * tiles; it += gridDim.x) {
    const int bb = it / tiles, t0 = (it % tiles) * RT, t1 = min(Tn, t0 + RT);
    const int lo = t0 - CTX, nrow = t1 - lo;
    const size_t row0 = static_cast<size_t>(bb) * Tn;
    load_rows<T>(p, nb, row0, lo, nrow, xs);
    __syncthreads();
    inv_rms(p, xs, nrow, sc, sq, bsf);
    __syncthreads();
    const T* c_in = ctx_in + (static_cast<size_t>(bb) * NB + nb) * CTX * W;
    for (int e = threadIdx.x; e < nrow * W; e += THREADS) {
      const int j = e / W, d = e % W, t = lo + j;
      hs[e] = t >= 0 ? xs[e] * sc_at(p, sc, j, d) * vs[d] : vv::to_f(c_in[(t + CTX) * W + d]);
    }
    __syncthreads();
    if (t1 == Tn) {
      T* c_out = ctx_out + (static_cast<size_t>(bb) * NB + nb) * CTX * W;
      for (int e = threadIdx.x; e < CTX * W; e += THREADS)
        c_out[e] = vv::from_f<T>(hs[(Tn - CTX - lo) * W + e]);
      if (nb == 0 && p.conv_kind == 1) {  // new transposed-conv tail: x[last] @ Wc[s+j]
        const int s = p.cs, tin = Tn / s;
        const float* yl = p.xg + (static_cast<size_t>(bb) * tin + tin - 1) * 2 * s * W;
        T* tail = static_cast<T*>(p.conv_out) + static_cast<size_t>(bb) * s * W;
        for (int e = threadIdx.x; e < s * W; e += THREADS) tail[e] = vv::from_f<T>(yl[s * W + e]);
      }
    }
    float* ycur = p.yg + (row0 + t0) * W;
    for (int e = threadIdx.x; e < (t1 - t0) * W; e += THREADS) {
      const int r = e / W, d = e % W;
      float m = vs[W + d];
#pragma unroll
      for (int k = 0; k < 7; ++k) m += hs[(r + k) * W + d] * vs[(4 + k) * W + d];
      const float yv = xs[(r + CTX) * W + d] + vs[2 * W + d] * m;
      xs[(r + CTX) * W + d] = yv;
      ycur[e] = yv;
    }
    __syncthreads();
    inv_rms(p, xs + CTX * W, t1 - t0, sc, sq, bsf);
    __syncthreads();
    float* hn = p.hng + (row0 + t0) * W;
    for (int e = threadIdx.x; e < (t1 - t0) * W; e += THREADS) {
      const int r = e / W, d = e % W;
      hn[e] = vv::round_to<T>(xs[(r + CTX) * W + d] * sc_at(p, sc, r, d) * vs[3 * W + d]);
    }
    __syncthreads();
  }
}

// ---- B: FFN items ----
template <typename T>
__device__ void phase_ffn(const StageParams& p, int nb, float* sm) {
  const int W = p.W, F = p.F, Tn = p.T;
  const int nf_tiles = (F + FT - 1) / FT, rtiles = (Tn + RB - 1) / RB;
  const T* w1 = static_cast<const T*>(p.w1) + static_cast<size_t>(nb) * p.w1_stride;
  const T* b1 = static_cast<const T*>(p.b1) + static_cast<size_t>(nb) * p.b1_stride;
  const T* w2 = static_cast<const T*>(p.w2) + static_cast<size_t>(nb) * F * W;
  const size_t n_el = static_cast<size_t>(p.B) * Tn * W;
  float* hb = sm;             // [RB][W]
  float* as = hb + RB * W;    // [RB][FT]
  T* bs = reinterpret_cast<T*>(as + RB * FT);  // [KC][NT] weight chunk
  const int cg = threadIdx.x % 16, rg = threadIdx.x / 16, c0 = 4 * cg;
  for (int it = blockIdx.x; it < p.B * rtiles * nf_tiles; it += gridDim.x) {
    const int bb = it / (rtiles * nf_tiles), rt = (it / nf_tiles) % rtiles, ft = it % nf_tiles;
    const int r0 = rt * RB, nr = min(RB, Tn - r0), f0 = ft * FT, nf = min(FT, F - f0);
    const size_t row0 = static_cast<size_t>(bb) * Tn + r0;
    copy_rows(hb, p.hng + row0 * W, nr * W, RB * W);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b = c0 + j < nf ? vv::to_f(b1[f0 + c0 + j]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = b;
    }
    // a = gelu(b1 + hn @ w1[:, f0:f0+nf])  (gemm_tile syncs before reading hb)
    gemm_tile<T, 4>(hb, W, W, w1 + f0, F, nf, bs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        as[(4 * rg + i) * FT + c0 + j] = c0 + j < nf ? vv::round_to<T>(gelu(acc[i][j])) : 0.f;
    // part[ft][row][d0 + c] = a @ w2[f0:f0+nf, d0 + c], NT channels at a time
    float* out = p.part + ft * n_el + row0 * W;
    for (int d0 = 0; d0 < W; d0 += NT) {
      const int nc = min(NT, W - d0);
      float acc2[4][4] = {};
      gemm_tile<T, 4>(as, FT, nf, w2 + static_cast<size_t>(f0) * W + d0, W, nc, bs, acc2);
      if (c0 < nc) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * rg + i;
          if (r < nr)
            *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * W + d0 + c0) =
                make_float4(acc2[i][0], acc2[i][1], acc2[i][2], acc2[i][3]);
        }
      }
    }
  }
}

// ---- O: the stage output, or the folded tail ----
template <typename T>
__device__ void phase_out(const StageParams& p, float* sm) {
  const int W = p.W, Tn = p.T, NB = p.NB, hk = p.hk, hc = hk ? hk - 1 : 0;
  T* y = static_cast<T*>(p.y);
  const int tiles = (Tn + RT - 1) / RT;
  float* xs = sm;                    // [RT + hc][W]
  float* sc = xs + (RT + hc) * W;    // inverse RMS per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int it = blockIdx.x; it < p.B * tiles; it += gridDim.x) {
    const int bb = it / tiles, t0 = (it % tiles) * RT, t1 = min(Tn, t0 + RT);
    const size_t row0 = static_cast<size_t>(bb) * Tn;
    const int lo = t0 - hc, nrow = t1 - lo;
    load_rows<T>(p, NB, row0, lo, nrow, xs);
    __syncthreads();
    if (!hk) {
      for (int e = threadIdx.x; e < (t1 - t0) * W; e += THREADS)
        y[(row0 + t0) * W + e] = vv::from_f<T>(xs[e]);
      __syncthreads();
      continue;
    }
    if (p.hnorm) vv::row_rsqrt(xs, nrow, W, p.eps, sc);
    __syncthreads();
    const T* hst = static_cast<const T*>(p.head_state) + static_cast<size_t>(bb) * hc * W;
    for (int e = threadIdx.x; e < nrow * W; e += THREADS) {
      const int j = e / W, d = e % W, t = lo + j;
      xs[e] = t < 0 ? vv::to_f(hst[(t + hc) * W + d])
                    : (p.hnorm ? xs[e] * sc[j] * p.head_w[d] : xs[e]);
    }
    __syncthreads();
    if (t1 == Tn) {
      T* hout = static_cast<T*>(p.head_out) + static_cast<size_t>(bb) * hc * W;
      for (int e = threadIdx.x; e < hc * W; e += THREADS)
        hout[e] = vv::from_f<T>(xs[(Tn - hc - lo) * W + e]);
    }
    for (int r = warp; r < t1 - t0; r += WARPS) {
      float s = 0.f;
      for (int d = lane; d < W; d += 32) {
        float m = 0.f;
        for (int tap = 0; tap < hk; ++tap) m += xs[(r + tap) * W + d] * p.head_w[(1 + tap) * W + d];
        s += m;
      }
      s = vv::warp_sum(s);
      if (lane == 0) y[row0 + t0 + r] = vv::from_f<T>(s);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) stage_kernel(StageParams p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sm[];
  if (p.conv_kind) {
    phase_conv<T>(p, sm);
    grid.sync();
  }
  for (int nb = 0; nb < p.NB; ++nb) {
    phase_mixer<T>(p, nb, sm);
    grid.sync();
    phase_ffn<T>(p, nb, sm);
    grid.sync();
    phase_sum<T>(p, nb);
    grid.sync();
  }
  phase_out<T>(p, sm);
}

template <typename T>
size_t smem_bytes(const StageParams& p) {
  const size_t W = p.W, chunk = KC * NT * sizeof(T);
  size_t f = (11 + 2 * (RT + CTX)) * W + (p.avg ? (RT + CTX + RB) * W + KC * NT : RT + CTX);
  size_t b = std::max(f * sizeof(float), (RB * W + RB * FT) * sizeof(float) + chunk);
  if (p.conv_kind) {
    const size_t rows = p.conv_kind == 1 ? RP : (RP - 1) * p.cs + p.ck;
    b = std::max(b, (rows * p.cin + 3) / 4 * 4 * sizeof(float) + chunk);
  }
  if (p.hk) b = std::max(b, (RT + p.hk - 1) * (W + 1) * sizeof(float));
  return b;
}

int max_items(const StageParams& p) {
  const int tiles = p.B * ((p.T + RT - 1) / RT);
  int n = std::max(tiles, p.B * ((p.T + RB - 1) / RB) * ((p.F + FT - 1) / FT));
  const int dtiles = (p.W + NT - 1) / NT;
  if (p.conv_kind == 1)
    n = std::max(n, p.B * ((p.T / p.cs + RP - 1) / RP) * 2 * p.cs * dtiles);
  if (p.conv_kind == 2) n = std::max(n, p.B * ((p.T + RP - 1) / RP) * dtiles);
  return n;
}

template <typename T>
int launch(StageParams p, cudaStream_t stream) {
  void (*kern)(StageParams) = stage_kernel<T>;
  // every row of a weight chunk, a conv tile and the partials is whole
  // 16-byte vectors
  if ((p.W * sizeof(T)) % 16 || (p.F * sizeof(T)) % 16) return -2;
  const size_t smem = smem_bytes<T>(p);
  if (smem > 227 * 1024) return -5;
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
  if (!coop) return -10;       // the card cannot launch cooperatively
  if (per_sm < 1) return -11;  // one CTA does not fit an SM
  const int grid = std::max(1, std::min(max_items(p), sms * per_sm));
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(grid),
                                                      dim3(THREADS), args, smem, stream));
}

}  // namespace

// `params` points at a StageParams (a parameter of that internal type would
// give the function internal linkage)
extern "C" int vv_fused_stage(const void* params, void* stream) {
  StageParams p = *static_cast<const StageParams*>(params);
  if (p.B <= 0 || p.T <= CTX || p.W <= 0 || p.F <= 0 || p.NB <= 0) return -1;
  if (p.conv_kind == 1 && (p.cs <= 0 || p.ck != 2 * p.cs || p.T % p.cs || p.cin <= 0)) return -3;
  if (p.conv_kind == 2 && (p.cs <= 0 || p.ck <= p.cs || p.T * p.cs < p.ck - p.cs || p.cin <= 0))
    return -3;
  if (p.hk && (p.hk < 2 || p.hk - 1 > 8 || p.T < p.hk)) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0) return launch<float>(p, st);
  if (p.dtype == 1) return launch<__nv_bfloat16>(p, st);
  return -6;  // unsupported dtype
}
