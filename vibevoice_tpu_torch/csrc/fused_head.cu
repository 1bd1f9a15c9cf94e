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
// scales, modulations and final linear, over 3.35 TB/s (12.9 us).  A layer's
// 10.6 MB takes ~3 us of HBM, so the latency of every step between layers
// counts as much as the bytes.
//
// The TPU kernel walks grid (layer, ffn_tile) in order with the activation in
// VMEM.  Here ONE launch of clusters of C = 8 CTAs (`cudaLaunchKernelEx` with
// the cluster attribute; one CTA per SM, at most as many clusters as the card
// holds at once, since the grid barrier needs every CTA resident).  CTA k
// owns the F columns [k*TF, (k+1)*TF) of gate/up and the matching packed rows
// of wd (TF a multiple of 8: whole packed words and whole wd byte rows; 40 on
// 116 CTAs at the 1.5B shape); rank q of a cluster owns H/8 of the H columns
// of x, which stay in its shared memory across the layers.  Weight slices
// stream through two rings, one thread issuing each copy: gate and up in
// boxes of [kb packed rows][box_w(TF) bytes] of two 2-D tensor maps (cached
// per pack; a box starts on a 16-byte unit), wd in runs of r2 whole packed
// rows by the bulk-copy engine, both under an L2 evict-first policy (read
// once per call, they would otherwise push out of L2 what is read again: the
// partials, the final linear, the kernel's code); a stage is refilled with
// the next chunk (of this layer or the next) as soon as it is consumed.
// `ops/fused_head.head_plan` sizes the rings so that at the 1.5B shape a
// whole layer's slice is in flight; a slice that does not fit streams
// through them.  Each rank's modulations, norm weight and wd scale (and the
// CTA's gate/up scales) come by bulk copies a layer ahead, in two buffers by
// step parity, queued ahead of the first weights.  Per layer:
//   1. norm: rank q's sums of squares of its columns of x go to every CTA of
//      the cluster (cluster barrier); h of its columns goes to every CTA's
//      shared memory (cluster barrier): each CTA holds h [rows, H];
//   2. up-projection of the CTA's columns for gate and up (fp32 FMAs against
//      nibbles made fp32 exactly by prmt + a float subtract; K split over the
//      threads, the splits added in order), scales, silu(g) * u;
//   3. down-projection: the CTA's share [rows, H] of the layer's output;
//   4. cluster barrier; rank q adds the 8 shares of its columns in rank
//      order and writes one fp32 partial per cluster (buffer l % 2 of the
//      cached workspace);
//   5. the grid barrier, the layer's only one;
//   6. rank q of every cluster adds the clusters' partials of its columns in
//      cluster order: x += gate * (sum * sd), so every CTA holds the same
//      bits (no float atomics; two calls give equal bits).
// After the last layer cluster 0 alone runs the final norm and the
// [H, latent] product with one cluster barrier (`final_layer`); no grid
// barrier follows.  Rows beyond a row group (at most 8, as shared memory
// allows) run as further row groups inside the launch.
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16
// (x, the modulations, the final linear and the output share it).  Returns 0,
// a negative code for arguments or a card it does not take, or the CUDA error
// of the launch.

#include <cooperative_groups.h>
#include <cuda.h>

#include <map>
#include <set>
#include <tuple>
#include <type_traits>

#include "hopper_common.cuh"
#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace {

using vv::bulk_copy;
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

constexpr int NT = 256;        // threads of a CTA
constexpr int NW = NT / 32;
constexpr int MAX_ROWS = 8;    // rows of a row group: one register pass
constexpr int C = 8;           // CTAs per cluster: the portable size
constexpr int RED_BATCH = 16;  // partials of one element a thread has in flight
constexpr int ISSUER = NT - 1; // the thread that issues the weight copies

struct HArgs {
  const void* x;       // [N, H] (after noisy_proj)
  const void* mods;    // [L, N, 3H]
  const void* fmod;    // [N, 2H]
  const void* fl;      // [H, lat]
  const float* norms;  // [L, 8, H], row 0 = norm_w
  const float* sg;     // [L, 1, F]
  const float* su;
  const int8_t* wdq;   // [L, F/2, H]
  const float* sd;     // [L, 1, H]
  void* out;           // [N, lat]
  float* part;         // [2][ncl][rows][H]: the clusters' partials, by layer parity
  unsigned int* bar;   // the grid barrier's counter
  int N, H, F, L, lat, rows, TF, tiles, ncl;
  int kb, ring;        // gate/up: packed rows per box, ring stages
  int r2, ring2;       // wd: packed rows per chunk, ring stages
  float eps;
};

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline size_t up128(size_t v) { return (v + 127) & ~static_cast<size_t>(127); }

// Bytes of a gate/up box row.  A box starts at the 16-byte unit that holds
// the CTA's first column f0 = k * TF (f0 % 16 is 0 or 8) and covers its TF
// columns in whole 16-byte units (the tensor map's); the other columns go
// unused.
__host__ __device__ inline int box_w(int TF) { return TF % 16 ? (TF + 8 + 15) / 16 * 16 : TF; }

// the most columns of x a rank owns: H/4 groups of 4 spread over the ranks
__host__ __device__ inline int h_wmax(int H) { return (H / 4 + C - 1) / C * 4; }

// Byte offsets of the kernel's shared memory (`ops/fused_head.py:head_smem`
// mirrors the total).
struct HLayout {
  size_t gu, gu_half, w2, w2_stage, hb, xs, sh, as, red, nrm, sm, sm_stride, mb, total;
};

__host__ __device__ inline HLayout h_layout(int H, int TF, int rows, int kb, int ring, int r2,
                                            int ring2, int lat) {
  HLayout L;
  const size_t wmax = h_wmax(H), nkl = NT / (TF / 4), items = static_cast<size_t>(rows) * lat;
  const size_t red_w = nkl * TF > 2 * static_cast<size_t>(NW) * lat
                           ? nkl * TF : 2 * static_cast<size_t>(NW) * lat;
  const size_t fo = 2 * C * items + C * static_cast<size_t>(rows);
  const size_t hb = rows * static_cast<size_t>(H) > fo ? rows * static_cast<size_t>(H) : fo;
  size_t o = 0;
  L.gu_half = up128(static_cast<size_t>(kb) * box_w(TF));
  L.gu = o;   o += ring * 2 * L.gu_half;                  // gate | up boxes [kb][box_w] bytes
  L.w2_stage = up128(static_cast<size_t>(r2) * H);
  L.w2 = o;   o += ring2 * L.w2_stage;                    // wd runs [r2][H] bytes
  L.hb = o;   o += up16(sizeof(float) * hb);              // h, then the share; rank 0's final sums
  L.xs = o;   o += up16(sizeof(float) * rows * wmax);     // x of the rank's columns
  L.sh = o;   o += up16(sizeof(float) * rows * wmax);     // the final layer's shift
  L.as = o;   o += up16(sizeof(float) * rows * TF);       // gate sums, then silu(g) * u
  // the up-projection's K splits, then the final products' warp sums
  L.red = o;  o += up16(sizeof(float) * rows * red_w);
  // 32-column sums [rows][chunks], the exchange [C][rows], the row scales
  L.nrm = o;  o += up16(sizeof(float) * ((wmax + 31) / 32 + C + 1) * rows);
  // per step parity: mods [rows][3][wmax] (x's dtype, 4 bytes a slot), norm_w,
  // sd [wmax], sg, su [TF]
  L.sm_stride = up16(sizeof(float) * (3 * rows * wmax + 2 * wmax + 2 * TF));
  L.sm = o;   o += 2 * L.sm_stride;
  L.mb = o;   o += 8 * static_cast<size_t>(ring + ring2 + 2);  // mbarriers
  L.total = o + 128;  // the base is aligned up to 128 bytes (the tensor maps' boxes)
  return L;
}

// Gate/up chunk c (step c / nk, box c % nk of the layer's H/2 packed rows)
// into ring stage c % ring; called by one thread.
__device__ void issue_gu(const HArgs& a, const CUtensorMap* gm, const CUtensorMap* um, int c,
                         int nk, int f0, unsigned char* gu, size_t half, uint32_t mb) {
  const int stage = c % a.ring, l = (c / nk) % a.L;
  const int y = l * (a.H / 2) + (c % nk) * a.kb;
  unsigned char* dst = gu + stage * 2 * half;
  const uint32_t bar = mb + 8 * stage;
  fence_async();
  mbar_expect(bar, static_cast<uint32_t>(2 * a.kb * box_w(a.TF)));
  const uint64_t pol = vv::evict_first_policy();  // read once per call
  tma_box(dst, gm, f0 & ~15, y, bar, pol);
  tma_box(dst + half, um, f0 & ~15, y, bar, pol);
}

// wd chunk c (step c / n2, run c % n2 of the CTA's TF/2 packed rows) into ring
// stage c % ring2, one bulk copy of its rows inside F; called by one thread.
__device__ void issue_w2(const HArgs& a, int c, int n2, int f0, unsigned char* w2, size_t stage_b,
                         uint32_t mb) {
  const int stage = c % a.ring2, l = (c / n2) % a.L;
  const int r0 = f0 / 2 + (c % n2) * a.r2, live = max(0, min(a.r2, a.F / 2 - r0));
  const uint32_t bar = mb + 8 * stage, bytes = static_cast<uint32_t>(live) * a.H;
  fence_async();
  mbar_expect(bar, bytes);
  if (bytes)
    bulk_copy(w2 + stage * stage_b, a.wdq + (static_cast<size_t>(l) * (a.F / 2) + r0) * a.H,
              bytes, bar, vv::evict_first_policy());
}

// The small operands of step `step` (layer l of its row group) into the
// buffer of the step's parity: the group's modulation rows of the rank's
// columns [c0, c0 + w) as [rows][3][wmax] in x's dtype, norm_w and sd of
// those columns, and the CTA's gate/up scales.  `bulk`: warp 0 hands the rows
// to the bulk-copy engine, completing on `bar`; otherwise every thread copies
// (the caller syncs).
template <typename T>
__device__ void fetch_small(const HArgs& a, int step, int c0, int w, int wmax, int f0,
                            bool has_tile, unsigned char* sm, bool bulk, uint32_t bar) {
  const int H = a.H, l = step % a.L, n0 = step / a.L * a.rows;
  const int nr = min(a.rows, a.N - n0), live = has_tile ? max(0, min(a.TF, a.F - f0)) : 0;
  T* md = reinterpret_cast<T*>(sm);
  float* fv = reinterpret_cast<float*>(sm + sizeof(float) * 3 * a.rows * wmax);
  const T* mods = static_cast<const T*>(a.mods);
  // row k: the modulation rows (row, segment), then norm_w, sd, sg, su
  auto row = [&](int k, void*& dst, const void*& src, int& bytes) {
    if (k < 3 * nr) {
      const int r = k / 3, seg = k % 3;
      dst = md + (r * 3 + seg) * wmax;
      src = mods + (static_cast<size_t>(l) * a.N + n0 + r) * 3 * H + seg * H + c0;
      bytes = w * static_cast<int>(sizeof(T));
    } else if (k < 3 * nr + 2) {
      const int j = k - 3 * nr;
      dst = fv + j * wmax;
      src = j == 0 ? a.norms + static_cast<size_t>(l) * 8 * H + c0
                   : a.sd + static_cast<size_t>(l) * H + c0;
      bytes = w * 4;
    } else {
      const int j = k - 3 * nr - 2;
      dst = fv + 2 * wmax + j * a.TF;
      src = (j == 0 ? a.sg : a.su) + static_cast<size_t>(l) * a.F + f0;
      bytes = live * 4;
    }
  };
  const int nrows = 3 * nr + 2 + (live ? 2 : 0);
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
    if (k < 3 * nr) {
      for (int e = threadIdx.x; e < w; e += NT)
        static_cast<T*>(dst)[e] = static_cast<const T*>(src)[e];
    } else {
      for (int e = threadIdx.x; e < bytes / 4; e += NT)
        static_cast<float*>(dst)[e] = static_cast<const float*>(src)[e];
    }
  }
}

// fn(std::integral_constant<int, nr>) for a row count nr in [1, MAX_ROWS]:
// the FMA loops see the rows as a compile-time count.
template <typename Fn>
__device__ __forceinline__ void with_rows(int nr, Fn fn) {
  switch (nr) {
    case 1: fn(std::integral_constant<int, 1>()); break;
    case 2: fn(std::integral_constant<int, 2>()); break;
    case 3: fn(std::integral_constant<int, 3>()); break;
    case 4: fn(std::integral_constant<int, 4>()); break;
    case 5: fn(std::integral_constant<int, 5>()); break;
    case 6: fn(std::integral_constant<int, 6>()); break;
    case 7: fn(std::integral_constant<int, 7>()); break;
    default: fn(std::integral_constant<int, 8>()); break;
  }
}

// two neighbouring values (4- or 8-byte aligned) as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 1. h = (rmsnorm(x) * norm_w) * (1 + scale) + shift of the rank's columns
// [c0, c0 + w) (x in xs [rows][wmax]), stored into hb [rows][H] of every CTA
// of the cluster: after the second cluster barrier each CTA holds all of h.
template <typename T>
__device__ void norm_h(const HArgs& a, cg::cluster_group& cl, int nr, int c0, int w, int wmax,
                       const float* xs, const T* md, const float* nw, float* nrm, float* xch,
                       float* rs, float* hb) {
  const int H = a.H, w4 = w / 4;
  rank_sumsq<NW>(cl, xs, wmax, nr, w, nrm, xch);
  cl.sync();
  row_scales(C, xch, nr, H, a.eps, rs);
  for (int e = threadIdx.x; e < nr * w4; e += NT) {
    const int r = e / w4, c = 4 * (e % w4);
    const float4 x = *reinterpret_cast<const float4*>(xs + r * wmax + c);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    float h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float shift = vv::to_f(md[(r * 3) * wmax + c + j]);
      const float scale = vv::to_f(md[(r * 3 + 1) * wmax + c + j]);
      h[j] = (xv[j] * rs[r] * nw[c + j]) * (1.f + scale) + shift;
    }
    const float4 hv = make_float4(h[0], h[1], h[2], h[3]);
    for (int p = 0; p < C; ++p)
      *reinterpret_cast<float4*>(cl.map_shared_rank(hb, p) + r * H + c0 + c) = hv;
  }
  cl.sync();  // h is whole in every CTA of the cluster
}

// 2. The up-projection of the CTA's columns for R rows: thread (cw, kl) takes
// packed word cw (4 columns) of byte rows kl, kl + nkl, ... of each gate/up
// chunk of the step, waiting for it on its stage's mbarrier; after every
// thread is done with a stage, the issuer refills it with chunk c + ring.
// The K splits meet in `red` and are added in order: as = silu(g) * u (0 past
// F).
template <int R>
__device__ void up_proj(const HArgs& a, const CUtensorMap* gm, const CUtensorMap* um, int step,
                        int steps, int f0, unsigned char* gu, size_t half, uint32_t mb,
                        const float* hb, const float* sgv, const float* suv, float* red,
                        float* as) {
  const int H = a.H, TF = a.TF, BW = box_w(TF), kb = a.kb, nk = H / 2 / kb, cgw = TF / 4,
            nkl = NT / cgw;
  const int cw = threadIdx.x % cgw, kl = threadIdx.x / cgw;
  float ag[R][4], au[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) ag[r][j] = au[r][j] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int c = step * nk + k, stage = c % a.ring;
    mbar_wait(mb + 8 * stage, (c / a.ring) & 1);
    if (kl < nkl) {
      const unsigned char* gs = gu + stage * 2 * half + (f0 & 15) + 4 * cw;
      const unsigned char* us = gs + half;
      const float* x0 = hb + 2 * k * kb;
      constexpr int U = R > 4 ? 2 : 4;
#pragma unroll U
      for (int i = kl; i < kb; i += nkl) {
        float gl[4], gh[4], ul[4], uh[4];
        nibbles_f32(*reinterpret_cast<const uint32_t*>(gs + static_cast<size_t>(i) * BW), gl, gh);
        nibbles_f32(*reinterpret_cast<const uint32_t*>(us + static_cast<size_t>(i) * BW), ul, uh);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 xv = *reinterpret_cast<const float2*>(x0 + r * H + 2 * i);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ag[r][j] = fmaf(xv.y, gh[j], fmaf(xv.x, gl[j], ag[r][j]));
            au[r][j] = fmaf(xv.y, uh[j], fmaf(xv.x, ul[j], au[r][j]));
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == ISSUER && c + a.ring < steps * nk)
      issue_gu(a, gm, um, c + a.ring, nk, f0, gu, half, mb);
  }
  // gate sums into as, then up: silu(g * sg) * (u * su)
  for (int pass = 0; pass < 2; ++pass) {
    if (kl < nkl)
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float4*>(red + (kl * R + r) * TF + 4 * cw) =
            pass ? make_float4(au[r][0], au[r][1], au[r][2], au[r][3])
                 : make_float4(ag[r][0], ag[r][1], ag[r][2], ag[r][3]);
    __syncthreads();
    for (int e = threadIdx.x; e < R * TF; e += NT) {
      const int r = e / TF, c = e % TF;
      float s = 0.f;
#pragma unroll 8
      for (int l = 0; l < nkl; ++l) s += red[(l * R + r) * TF + c];
      if (pass == 0) {
        as[e] = s * sgv[c];
      } else {
        const float g = as[e], u = s * suv[c];
        as[e] = f0 + c < a.F ? (g / (1.f + expf(-g))) * u : 0.f;
      }
    }
    __syncthreads();
  }
}

// 3. The down-projection for R rows: share [R][H] (in hb) = as @ the CTA's wd
// rows, chunk by chunk of the wd ring; thread cw takes packed word cw (4
// columns) of every byte row of a chunk, its sums carried in the share.
template <int R>
__device__ void down_proj(const HArgs& a, int step, int steps, int f0, unsigned char* w2,
                          size_t stage_b, uint32_t mb, const float* as, float* share) {
  const int H = a.H, TF = a.TF, r2 = a.r2, n2 = TF / 2 / r2;
  for (int j = 0; j < n2; ++j) {
    const int c = step * n2 + j, stage = c % a.ring2;
    mbar_wait(mb + 8 * stage, (c / a.ring2) & 1);
    const unsigned char* ws = w2 + stage * stage_b;
    const float* a0 = as + 2 * j * r2;
    for (int cw = threadIdx.x; 4 * cw < H; cw += NT) {
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = j ? *reinterpret_cast<const float4*>(share + r * H + 4 * cw)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[r][0] = v.x, acc[r][1] = v.y, acc[r][2] = v.z, acc[r][3] = v.w;
      }
      constexpr int U = R > 4 ? 2 : 4;
#pragma unroll U
      for (int i = 0; i < r2; ++i) {
        float lo[4], hi[4];
        nibbles_f32(*reinterpret_cast<const uint32_t*>(ws + static_cast<size_t>(i) * H + 4 * cw),
                    lo, hi);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 av = *reinterpret_cast<const float2*>(a0 + r * TF + 2 * i);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av.y, hi[q], fmaf(av.x, lo[q], acc[r][q]));
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float4*>(share + r * H + 4 * cw) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    if (threadIdx.x == ISSUER && c + a.ring2 < steps * n2)
      issue_w2(a, c + a.ring2, n2, f0, w2, stage_b, mb);
  }
}

// 4. Rank q adds the cluster's shares (in hb) of its columns in rank order
// and writes them as the cluster's partial.
__device__ void cluster_partial(const HArgs& a, cg::cluster_group& cl, int step, const float* hb,
                                int nr, int c0, int w) {
  const int H = a.H, cid = blockIdx.x / C, w4 = w / 4;
  float* part = a.part + (static_cast<size_t>(step % 2) * a.ncl + cid) * a.rows * H;
  cl.sync();  // every rank's share is in its shared memory
  for (int e = threadIdx.x; e < nr * w4; e += NT) {
    const int off = (e / w4) * H + c0 + 4 * (e % w4);
    float4 v[C];
#pragma unroll
    for (int p = 0; p < C; ++p)
      if (cid * C + p < a.tiles)
        v[p] = *reinterpret_cast<const float4*>(cl.map_shared_rank(hb, p) + off);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < C; ++p)
      if (cid * C + p < a.tiles) s.x += v[p].x, s.y += v[p].y, s.z += v[p].z, s.w += v[p].w;
    *reinterpret_cast<float4*>(part + off) = s;
  }
}

// 6. Rank q of a cluster adds the clusters' partials of its columns in
// cluster order: x += gate * (sum * sd), in xs.
template <typename T>
__device__ void next_x(const HArgs& a, int step, int nr, int c0, int w, int wmax, const T* md,
                       const float* sdv, float* xs) {
  const int H = a.H, w4 = w / 4;
  const size_t slab = static_cast<size_t>(a.rows) * H;
  const float* part = a.part + static_cast<size_t>(step % 2) * a.ncl * slab;
  for (int e = threadIdx.x; e < nr * w4; e += NT) {
    const int r = e / w4, c = 4 * (e % w4), off = r * H + c0 + c;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), p[RED_BATCH];
    for (int k0 = 0; k0 < a.ncl; k0 += RED_BATCH) {
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u)
        if (k0 + u < a.ncl)
          p[u] = __ldcg(reinterpret_cast<const float4*>(part + (k0 + u) * slab + off));
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u)
        if (k0 + u < a.ncl) s.x += p[u].x, s.y += p[u].y, s.z += p[u].z, s.w += p[u].w;
    }
    const float sv[4] = {s.x, s.y, s.z, s.w};
    float* xr = xs + r * wmax + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xr[j] = xr[j] + vv::to_f(md[(r * 3 + 2) * wmax + c + j]) * (sv[j] * sdv[c + j]);
  }
}

// The final layer, in cluster 0, with one cluster barrier.  Since
//   xn @ fl = rs * ((x * (1 + fscale)) @ fl) + fshift @ fl
// for the row scale rs = 1 / sqrt(mean(x^2) + eps), each rank sends rank 0
// its columns' sums of squares and both products over its columns (x * (1 +
// fscale) in place in xs, fshift in sh; warp wp
// takes the rows wp, wp + NW, ... of its fl slice, each lane two neighbouring
// columns of a 64-column group; the warps' sums meet in `red`, added in warp
// order); rank 0 adds the ranks' in rank order and writes the group's
// outputs.  `fo` (rank 0's hb) holds [C][items] of each product and [C][rows]
// of the sums of squares.
template <typename T>
__device__ void final_layer(const HArgs& a, cg::cluster_group& cl, int n0, int nr, int w,
                            int c0, int wmax, float* xs, float* sh, float* nrm, float* red,
                            float* fo) {
  const int H = a.H, lat = a.lat, items = nr * lat, per = (w + 31) / 32;
  const T* fl = static_cast<const T*>(a.fl) + static_cast<size_t>(c0) * lat;
  const T* fm = static_cast<const T*>(a.fmod) + static_cast<size_t>(n0) * 2 * H + c0;
  const int rank = static_cast<int>(cl.block_rank()), warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  float* peer = cl.map_shared_rank(fo, 0);
  __syncthreads();
  for (int k = warp; k < nr * per; k += NW) {  // 32-column sums, as rank_sumsq
    const int r = k / per, c = (k % per) * 32 + lane;
    const float v = c < w ? xs[r * wmax + c] : 0.f;
    const float s = vv::warp_sum(v * v);
    if (lane == 0) nrm[k] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * w; e += NT) {  // u = x * (1 + fscale) in xs; fshift
    const int r = e / w, c = e % w;
    xs[r * wmax + c] *= 1.f + vv::to_f(fm[r * 2 * H + H + c]);
    sh[r * wmax + c] = vv::to_f(fm[r * 2 * H + c]);
  }
  __syncthreads();
  // load(row, j): columns j, j + 1 of a row of fl (0 past lat); FB rows of
  // fl a warp has in flight before it uses them
  constexpr int FB = 8;
  auto product = [&](auto load, auto R) {
    constexpr int NR = decltype(R)::value;
    for (int j0 = 0; j0 < lat; j0 += 64) {
      const int ja = j0 + 2 * lane;  // the lane's two columns
      float p1[NR][2], p2[NR][2];
#pragma unroll
      for (int r = 0; r < NR; ++r) p1[r][0] = p1[r][1] = p2[r][0] = p2[r][1] = 0.f;
      for (int d0 = warp; d0 < w; d0 += FB * NW) {
        float2 fv[FB];
#pragma unroll
        for (int u = 0; u < FB; ++u) {
          const int d = d0 + u * NW;
          fv[u] = d < w ? load(fl + static_cast<size_t>(d) * lat, ja) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < FB; ++u) {
          const int d = min(d0 + u * NW, w - 1);  // past w: fv is 0
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float uu = xs[r * wmax + d], v = sh[r * wmax + d];
            p1[r][0] = fmaf(uu, fv[u].x, p1[r][0]);
            p1[r][1] = fmaf(uu, fv[u].y, p1[r][1]);
            p2[r][0] = fmaf(v, fv[u].x, p2[r][0]);
            p2[r][1] = fmaf(v, fv[u].y, p2[r][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (ja + q < lat) {
            red[(warp * nr + r) * lat + ja + q] = p1[r][q];
            red[((NW + warp) * nr + r) * lat + ja + q] = p2[r][q];
          }
    }
  };
  const bool pairs = lat % 2 == 0 && reinterpret_cast<uintptr_t>(fl) % (2 * sizeof(T)) == 0;
  with_rows(nr, [&](auto R) {
    if (pairs)
      product([&](const T* row, int j) { return j < lat ? load2(row + j) : make_float2(0.f, 0.f); },
              R);
    else
      product(
          [&](const T* row, int j) {
            return make_float2(j < lat ? vv::to_f(row[j]) : 0.f,
                               j + 1 < lat ? vv::to_f(row[j + 1]) : 0.f);
          },
          R);
  });
  __syncthreads();
  for (int it = threadIdx.x; it < items; it += NT) {
    float t1 = 0.f, t2 = 0.f;
    for (int wp = 0; wp < NW; ++wp) {
      t1 += red[wp * items + it];
      t2 += red[(NW + wp) * items + it];
    }
    peer[rank * items + it] = t1;
    peer[(C + rank) * items + it] = t2;
  }
  if (threadIdx.x < nr) {
    float t = 0.f;
    for (int k = 0; k < per; ++k) t += nrm[threadIdx.x * per + k];
    peer[2 * C * items + rank * nr + threadIdx.x] = t;
  }
  cl.sync();  // every rank's sums are in rank 0
  if (rank == 0) {
    T* out = static_cast<T*>(a.out);
    for (int it = threadIdx.x; it < items; it += NT) {
      const int r = it / lat;
      float ss = 0.f, t1 = 0.f, t2 = 0.f;
      for (int p = 0; p < C; ++p) {
        ss += fo[2 * C * items + p * nr + r];
        t1 += fo[p * items + it];
        t2 += fo[(C + p) * items + it];
      }
      const float rs = 1.f / sqrtf(ss / a.H + a.eps);
      out[static_cast<size_t>(n0) * lat + it] = vv::from_f<T>(rs * t1 + t2);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
    head_q_kernel(const __grid_constant__ CUtensorMap gmap,
                  const __grid_constant__ CUtensorMap umap, const HArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smc = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  cg::cluster_group cl = cg::this_cluster();
  const int H = a.H, L = a.L;
  const HLayout lo = h_layout(H, a.TF, a.rows, a.kb, a.ring, a.r2, a.ring2, a.lat);
  unsigned char* gu = smc + lo.gu;
  unsigned char* w2 = smc + lo.w2;
  float* hb = reinterpret_cast<float*>(smc + lo.hb);
  float* xs = reinterpret_cast<float*>(smc + lo.xs);
  float* sh = reinterpret_cast<float*>(smc + lo.sh);
  float* as = reinterpret_cast<float*>(smc + lo.as);
  float* red = reinterpret_cast<float*>(smc + lo.red);
  const int wmax = h_wmax(H);
  float* nrm = reinterpret_cast<float*>(smc + lo.nrm);  // then the exchange, the row scales
  float* xch = nrm + (wmax + 31) / 32 * a.rows;
  float* rs = xch + C * a.rows;
  const uint32_t mb_gu = smem_u32(smc + lo.mb), mb_w2 = mb_gu + 8 * a.ring;
  const uint32_t mb_sm = mb_w2 + 8 * a.ring2;  // small copies, by step parity
  const T* x_in = static_cast<const T*>(a.x);
  const int rank = static_cast<int>(cl.block_rank()), cid = blockIdx.x / C, nv = H / 4;
  const int c0 = rank * nv / C * 4, w = (rank + 1) * nv / C * 4 - c0;
  const bool has_tile = blockIdx.x < a.tiles;
  const int f0 = blockIdx.x * a.TF, nk = H / 2 / a.kb, n2 = a.TF / 2 / a.r2;
  const int steps = (a.N + a.rows - 1) / a.rows * L;
  const int es = static_cast<int>(sizeof(T));
  const bool bulk = (w * es) % 16 == 0 && (c0 * es) % 16 == 0 && (wmax * es) % 16 == 0 &&
                    (H * es) % 16 == 0 && reinterpret_cast<uintptr_t>(a.mods) % 16 == 0;
  if (threadIdx.x == 0) {
    for (int k = 0; k < a.ring + a.ring2 + 2; ++k) mbar_init(mb_gu + 8 * k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (bulk) fetch_small<T>(a, 0, c0, w, wmax, f0, has_tile, smc + lo.sm, true, mb_sm);
  __syncthreads();  // the small copies queue ahead of the weights
  if (has_tile && threadIdx.x == ISSUER) {
    for (int c = 0; c < a.ring; ++c) issue_gu(a, &gmap, &umap, c, nk, f0, gu, lo.gu_half, mb_gu);
    for (int c = 0; c < a.ring2; ++c) issue_w2(a, c, n2, f0, w2, lo.w2_stage, mb_w2);
  }
  for (int step = 0; step < steps; ++step) {
    const int l = step % L, n0 = step / L * a.rows, nr = min(a.rows, a.N - n0), par = step % 2;
    unsigned char* sm = smc + lo.sm + par * lo.sm_stride;
    const T* md = reinterpret_cast<const T*>(sm);
    const float* fv = reinterpret_cast<const float*>(sm + sizeof(float) * 3 * a.rows * wmax);
    // every thread is done with the last step's small operands, which the
    // next copies overwrite
    __syncthreads();
    if (l == 0)
      for (int e = threadIdx.x; e < nr * w; e += NT) {
        const int r = e / w, c = e % w;
        xs[r * wmax + c] = vv::to_f(x_in[static_cast<size_t>(n0 + r) * H + c0 + c]);
      }
    if (bulk) {
      if (step + 1 < steps)
        fetch_small<T>(a, step + 1, c0, w, wmax, f0, has_tile,
                       smc + lo.sm + (1 - par) * lo.sm_stride, true, mb_sm + 8 * (1 - par));
      mbar_wait(mb_sm + 8 * par, (step >> 1) & 1);
    } else {
      fetch_small<T>(a, step, c0, w, wmax, f0, has_tile, sm, false, 0);
    }
    __syncthreads();
    norm_h<T>(a, cl, nr, c0, w, wmax, xs, md, fv, nrm, xch, rs, hb);
    const float *sgv = fv + 2 * wmax, *suv = sgv + a.TF;
    if (has_tile)
      with_rows(nr, [&](auto R) {
        up_proj<decltype(R)::value>(a, &gmap, &umap, step, steps, f0, gu, lo.gu_half, mb_gu, hb,
                                    sgv, suv, red, as);
      });
    if (has_tile)
      with_rows(nr, [&](auto R) {
        down_proj<decltype(R)::value>(a, step, steps, f0, w2, lo.w2_stage, mb_w2, as, hb);
      });
    cluster_partial(a, cl, step, hb, nr, c0, w);
    grid_barrier(a.bar);  // the layer's only grid-wide barrier
    if (l < L - 1 || cid == 0) next_x<T>(a, step, nr, c0, w, wmax, md, fv + wmax, xs);
    if (l == L - 1 && cid == 0)
      final_layer<T>(a, cl, n0, nr, w, c0, wmax, xs, sh, nrm, red, hb);
  }
  cl.sync();  // no peer reads this CTA's shared memory after it exits
}

// gate and up [L, H/2, F] as 2-D maps of L*H/2 rows of F bytes, boxes
// [kb][box_w(TF)]; columns past F read as zeros.  Cached per pack and shape.
int head_map(CUtensorMap* map, const void* w, const HArgs& a) {
  static std::map<std::tuple<const void*, int, int, int, int, int>, CUtensorMap> maps;
  const auto key = std::make_tuple(w, a.L, a.H, a.F, a.TF, a.kb);
  auto it = maps.find(key);
  if (it == maps.end()) {
    CUtensorMap m;
    if (const int rc = vv::encode_u8_2d(&m, w, a.F, static_cast<uint64_t>(a.L) * (a.H / 2),
                                        box_w(a.TF), a.kb))
      return rc;
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return 0;
}

// Raises head_q_kernel's shared-memory limit, once per device.
int opt_in() {
  static std::set<int> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!opted.count(dev)) {
    void (*kerns[2])(CUtensorMap, CUtensorMap, HArgs) = {head_q_kernel<float>,
                                                          head_q_kernel<__nv_bfloat16>};
    for (auto k : kerns) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    opted.insert(dev);
  }
  return 0;
}

cudaLaunchConfig_t config(int ctas, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
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

template <typename T>
int clusters(size_t smem, int* out) {
  if (const int rc = opt_in()) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(C, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, head_q_kernel<T>, &cfg));
}

template <typename T>
int launch(const HArgs& a, const void* wgq, const void* wuq, size_t smem, cudaStream_t stream) {
  if (const int rc = opt_in()) return rc;
  CUtensorMap gmap, umap;
  if (const int rc = head_map(&gmap, wgq, a)) return rc;
  if (const int rc = head_map(&umap, wuq, a)) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(a.ncl * C, smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, head_q_kernel<T>, gmap, umap, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Clusters of 8 CTAs of the head kernel that the card holds at once with
// `smem` bytes of shared memory per CTA, into *out (the launch's grid may not
// exceed them: its grid barrier needs every CTA resident).
extern "C" int vv_fused_head_clusters(long long smem, int dtype, int* out) {
  if (smem <= 0 || smem > 227 * 1024) return -4;
  if (dtype == 0) return clusters<float>(static_cast<size_t>(smem), out);
  if (dtype == 1) return clusters<__nv_bfloat16>(static_cast<size_t>(smem), out);
  return -5;
}

// One solver step (TPU kernel `fused_head_solver_step`): ncl clusters of 8
// CTAs, CTA k on F columns [k*TF, (k+1)*TF); row groups of `rows`; gate/up in
// boxes of kb packed rows through a ring of `ring` stages, wd in runs of r2
// packed rows through `ring2`; `part` the workspace of 2 * ncl * rows * H
// floats, `bar` the barrier's counter (0 before the first launch; every
// launch leaves its low bits 0).
extern "C" int vv_fused_head(const void* x, const void* mods, const void* fmod, const void* fl,
                             const void* norms, const void* wgq, const void* sg,
                             const void* wuq, const void* su, const void* wdq, const void* sd,
                             void* out, void* part, void* bar, int N, int H, int F, int L,
                             int lat, int rows, int TF, int ncl, int kb, int ring, int r2,
                             int ring2, float eps, int dtype, void* stream) {
  if (N <= 0 || H <= 0 || F <= 0 || L <= 0 || lat <= 0 || H % 16 || F % 16) return -1;
  if (rows <= 0 || rows > MAX_ROWS || TF <= 0 || TF % 8 || TF > 256 || part == nullptr ||
      bar == nullptr)
    return -2;
  const int tiles = (F + TF - 1) / TF;
  if (ncl != (tiles + C - 1) / C) return -3;
  if (kb <= 0 || kb > 256 || (H / 2) % kb || ring < 1 || ring > (H / 2) / kb || r2 <= 0 ||
      (TF / 2) % r2 || ring2 < 1 || ring2 > (TF / 2) / r2)
    return -8;
  const size_t smem = h_layout(H, TF, rows, kb, ring, r2, ring2, lat).total;
  if (smem > 227 * 1024) return -4;
  HArgs a{x, mods, fmod, fl, static_cast<const float*>(norms), static_cast<const float*>(sg),
          static_cast<const float*>(su), static_cast<const int8_t*>(wdq),
          static_cast<const float*>(sd), out, static_cast<float*>(part),
          static_cast<unsigned int*>(bar), N, H, F, L, lat, rows, TF, tiles, ncl,
          kb, ring, r2, ring2, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, wgq, wuq, smem, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, wgq, wuq, smem, st);
  return -5;
}
