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
// never read.
//
// Bound: the stage's rows are few (B*T), so each weight value feeds 2*B*T
// flops: the least time is the weight bytes over 3.35 TB/s -- about 134 MB
// (int4) or 538 MB (bf16) for the 1.5B model's D=2048 stages and 12.6 MB /
// 50 MB for its D=1024 stages.  A block's weights take 1-5 us (int4) or
// 5-20 us (bf16) to stream, so the latency of every grid-wide step between
// blocks counts as much as the bytes.
//
// The TPU kernel is one pallas_call whose grid runs in order and carries the
// activation in VMEM from block to block (the plain one once per batch row,
// under vmap).  Hopper runs blocks in parallel, so each pack has one launch
// that keeps the activation on chip, reads the weights once for all rows and
// syncs the grid once between blocks: clusters of C = 8 CTAs (the portable
// size; `cudaLaunchKernelEx` with the cluster attribute), one CTA per SM, at
// most as many clusters as the card holds at once (every CTA must be
// resident for the grid barrier).  CTA k owns FFN columns [k*TF, (k+1)*TF)
// of every block (the width spread over the whole grid in 16-byte units of
// W1 where the widths allow); rank q of a cluster owns D/C of the D columns.
// The rank's per-block vectors and context rows (and the CTA's ffn1 rows)
// come by bulk copies a step ahead.  A thread that issues a copy waits as
// long as the bytes ahead of it in the engines' queue take, so one thread
// issues each, at a point where the copy's wait costs least.  Per block:
//   1. mixer on the rank's columns: the rows' sums of squares of x go to
//      every CTA of the cluster (cluster barrier), h = rmsnorm(x) * norm_w,
//      the new context (cluster 0), y = x + gamma * (conv + mixer_b), and
//      y * ffn_norm_w with y's sums of squares stored into every CTA of the
//      cluster (cluster barrier): each CTA holds the whole FFN input and its
//      row scales;
//   2. up-projection of the CTA's columns in fp32 FMAs (k split over the
//      threads, the splits added in order), times the row scale, (scale,)
//      bias, exact GELU, in shared memory; the down-projection gives the
//      CTA's share [rows, D] of the FFN output;
//   3. cluster barrier; rank q adds the C shares of its columns in rank
//      order through distributed shared memory and writes them as the
//      cluster's fp32 partial (buffer n % 2 of the cached workspace);
//   4. the grid barrier (a counter in the workspace), the only one of the
//      block;
//   5. rank q of every cluster adds the clusters' partials of its columns in
//      cluster order and applies (scale,) bias, layer scale and residual: x
//      of the next block.  Cluster 0 writes y after the last.
// The partials alternate between two buffers: block n+2 writes buffer n % 2
// only after every CTA has passed block n+1's barrier, so none overwrites
// partials a slower CTA still reads.  Every sum runs in a fixed order, so two
// calls give the same bits.  Batches whose rows do not fit shared memory
// (at most 16 rows) run as row groups, one after another, in the launch.
//
// int4 packs (`chain_q_kernel`): the CTA's slices of W1 ([D/2, TF] bytes,
// boxes of a 2-D tensor map) and W2 ([TF/2, D], one bulk copy) fit shared
// memory whole and come a block ahead, W1 while the last block's
// down-projection runs, W2 while its shares are summed, the grid syncs and
// the next mixer runs.  The FMAs take nibbles made fp32 exactly by prmt + a
// float subtract.  Other widths take cp.async.
//
// Plain packs (`chain_p_kernel`): a block's slices are 4x (bf16) or 8x
// (fp32) larger -- at D=2048 in bf16, 295 KB of W1 and 295 KB of W2 for 72
// columns -- and do not fit, so they stream through two rings, as in
// fused_head.cu: W1 rows 0..D-1 in boxes of kb rows of a 2-D tensor map over
// w1 viewed as [N*(D+8), F] in the pack's element type (a box starts on a
// 16-byte column boundary: k*TF is a whole number of 16-byte units), W2 in
// runs of r2 of the CTA's contiguous rows by the bulk-copy engine, every
// copy under an L2 evict-first policy (read once per call).  One thread
// refills a stage as soon as every thread is done with it, with the next
// chunk of this block or of the next, so the next block's first weights
// land during this block's partial, grid barrier and mixer
// (`ops/fused_blocks.plain_plan` sizes kb, r2 and the rings).  b1 (row D of
// w1) comes with the small operands.  The FMAs take the pack dtype widened
// exactly (a bf16 is the top half of its fp32), four rows and four columns a
// thread at a time; a row group's rows are rounded up to a power of two for
// the register passes.  Widths that are not whole 16-byte vectors take
// cp.async by every thread (in the widest of 16, 8, 4 or 1 bytes that the
// rows allow), completing on the same mbarriers; a D that is not a multiple
// of 4 is padded to Dp = D rounded up to 4 in shared memory (the FFN input's
// and W2's rows, zeros past D, and W1's rows past D read 0), and FFN rows
// past F read 0, so the 4-wide FMAs take any width.
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

// ---- the cluster chains: int4 (chain_q_kernel), plain (chain_p_kernel) ----

constexpr int NT = 256;       // threads of a CTA
constexpr int NW = NT / 32;
constexpr int RP = 8;         // rows per register pass
constexpr int MAX_C = 8;      // CTAs per cluster: the portable size
constexpr int RED_BATCH = 16; // partials of one element a thread has in flight
// per-block vectors a CTA keeps for its rank's columns: norm_w, mixer_b,
// gamma, ffn_norm_w, ffn_gamma, ffn2_b, the 7 taps, s2 (int4 packs)
constexpr int NVEC = 14;
constexpr int ISSUER = NT - 1;  // the thread that issues the plain chain's weight copies

// A pack's formats: W is int8_t for an int4 pack (nibbles; its vectors, ffn1
// scale and bias and W2 scale fp32), float or __nv_bfloat16 for a plain pack
// (everything in W).  V: the type of the vectors and of the CTA's ffn1 rows.
template <typename W>
struct Fmt {
  static constexpr bool kInt4 = std::is_same<W, int8_t>::value;
  using V = typename std::conditional<kInt4, float, W>::type;
  static constexpr int NV = kInt4 ? 14 : 13;  // vector rows: vecs 0-5, the 7 taps(, s2)
  static constexpr int NCOL = kInt4 ? 2 : 1;  // the CTA's ffn1 rows: (scale,) bias
};

struct QArgs {
  const void* x;
  const void* ctx;
  const void* vecs;   // [N, 8, D]: fp32 (int4 pack) or the pack dtype
  const void* mixw;   // [N, 8, D]
  const void* w1;     // int4: w1q [N, D/2, F] int8; plain: w1 [N, D+8, F]
  const float* sb1;   // int4 only: [N, 2, F]
  const void* w2;     // int4: w2q [N, F/2, D] int8; plain: w2 [N, F, D]
  const float* s2;    // int4 only: [N, 1, D]
  void* y;
  void* ctx_out;
  float* part;        // [2][ncl][bg*T][D]: the clusters' partials, by block parity
  unsigned int* bar;  // the grid barrier's counter
  int B, T, D, F, NB, bg, TF, ncl, tiles, C;
  int br;             // int4: W1 rows per tensor-map box; 0: no tensor map (cp.async)
  int kb, ring;       // plain: W1 rows per box (a ring stage), W1 ring stages
  int r2, ring2;      // plain: W2 rows per run (a ring stage), W2 ring stages
  int maps;           // plain: W1 by tensor map, W2 by bulk copy (else cp.async)
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
  const int8_t* src = static_cast<const int8_t*>(a.w1) + static_cast<size_t>(nb) * D2 * F + f0;
  copy_rows(dst, TF, src, F, D2, TF, F - f0);
}

__device__ void fetch_w2(const QArgs& a, int nb, int f0, unsigned char* dst, uint32_t bar) {
  const int D = a.D, F2 = a.F / 2, R = a.TF / 2, r0 = f0 / 2;
  const int8_t* src = static_cast<const int8_t*>(a.w2) + (static_cast<size_t>(nb) * F2 + r0) * D;
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
// vectors (vs [NVEC][wmax] of V) and of the group's context rows (cs
// [bg][6][wmax] in x's dtype), and the CTA's ffn1 rows (sb [NCOL][TF] of V:
// int4 the scale and bias of sb1, plain the bias, row D of w1).  `bulk`:
// every row is whole 16-byte vectors, and warp 0 hands them to the bulk-copy
// engine, completing on `bar`; otherwise copy_rows.
template <typename T, typename W>
__device__ void fetch_small(const QArgs& a, int step, int f0, bool has_tile, int c0, int w,
                            int wmax, typename Fmt<W>::V* vs, unsigned char* cs,
                            typename Fmt<W>::V* sb, bool bulk, uint32_t bar) {
  using V = typename Fmt<W>::V;
  constexpr int NV = Fmt<W>::NV, NCOL = Fmt<W>::NCOL;
  const int D = a.D, NB = a.NB, nb = step % NB, b0 = step / NB * a.bg;
  const int nbg = min(a.bg, a.B - b0), par = step % 2;
  const int live = has_tile ? max(0, min(a.TF, a.F - f0)) : 0;
  V* v = vs + par * NVEC * wmax;
  unsigned char* c = cs + par * a.bg * CTX * wmax * sizeof(T);
  V* s = sb + par * NCOL * a.TF;
  const T* ctx = static_cast<const T*>(a.ctx);
  const V* vecs = static_cast<const V*>(a.vecs);
  const V* mixw = static_cast<const V*>(a.mixw);
  // row k: vecs rows 0-5, taps 0-6(, s2); then the context rows; then the ffn1 rows
  auto row = [&](int k, void*& dst, const void*& src, int& bytes) {
    if (k < NV) {
      dst = v + k * wmax;
      if (k < 6)
        src = vecs + (static_cast<size_t>(nb) * 8 + k) * D + c0;
      else if (k < 13)
        src = mixw + (static_cast<size_t>(nb) * 8 + k - 6) * D + c0;
      else
        src = a.s2 + static_cast<size_t>(nb) * D + c0;
      bytes = w * static_cast<int>(sizeof(V));
    } else if (k < NV + CTX * nbg) {
      const int bl = (k - NV) / CTX, j = (k - NV) % CTX;
      dst = c + ((bl * CTX + j) * wmax) * sizeof(T);
      src = ctx + ((static_cast<size_t>(b0 + bl) * NB + nb) * CTX + j) * D + c0;
      bytes = w * static_cast<int>(sizeof(T));
    } else {
      const int j = k - NV - CTX * nbg;
      dst = s + j * a.TF;
      if constexpr (Fmt<W>::kInt4)
        src = a.sb1 + (static_cast<size_t>(nb) * 2 + j) * a.F + f0;
      else
        src = static_cast<const W*>(a.w1) + (static_cast<size_t>(nb) * (D + 8) + D) * a.F + f0;
      bytes = live * static_cast<int>(sizeof(V));
    }
  };
  const int nrows = NV + CTX * nbg + (live ? NCOL : 0);
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

// four consecutive values (16-byte aligned fp32, 8-byte aligned bf16) as fp32;
// a bf16 is the top half of its fp32
__device__ __forceinline__ float4 ld4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4f(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
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
// its ranks' shares (in `hb`, row stride hd) of the rank's columns in rank
// order and writes them as the cluster's partial.
template <int V>
__device__ void cluster_partial(const QArgs& a, cg::cluster_group& cl, int step, float* hb,
                                int hd, int rows, int rows_max) {
  const int D = a.D, C = a.C, rank = static_cast<int>(cl.block_rank());
  const int cid = blockIdx.x / C, nv = D / V;
  const int u0 = rank * nv / C, wu = (rank + 1) * nv / C - u0;
  const size_t slab = static_cast<size_t>(rows_max) * D;
  float* part = a.part + (static_cast<size_t>(step % 2) * a.ncl + cid) * slab;
  cl.sync();  // every rank's share is in its shared memory
  for (int e = threadIdx.x; e < rows * wu; e += NT) {
    const int off = (e / wu) * D + (u0 + e % wu) * V, hoff = (e / wu) * hd + (u0 + e % wu) * V;
    float s[V], v[MAX_C][V];
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0.f;
#pragma unroll
    for (int p = 0; p < MAX_C; ++p)
      if (p < C && cid * C + p < a.tiles) ld_v<V>(v[p], cl.map_shared_rank(hb, p) + hoff);
#pragma unroll
    for (int p = 0; p < MAX_C; ++p)
      if (p < C && cid * C + p < a.tiles)
#pragma unroll
        for (int j = 0; j < V; ++j) s[j] += v[p][j];
    st_v<V>(part + off, s);
  }
}

// Step 5 of a block: rank q of every cluster adds the clusters' partials of
// its columns in cluster order and keeps x = y + g2 * (sum * s2 + b2) (plain:
// y + g2 * (sum + b2)) for them in xs ([rows][wmax]); cluster 0 also writes
// them to y after the group's last block.
template <typename T, typename W, int V>
__device__ void next_x(const QArgs& a, cg::cluster_group& cl, int step,
                       const typename Fmt<W>::V* v, int wmax,
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
    for (int j = 0; j < V; ++j) {
      if constexpr (Fmt<W>::kInt4)
        x[j] = xr[j] + v[4 * wmax + c + j] * (s[j] * v[13 * wmax + c + j] + v[5 * wmax + c + j]);
      else
        x[j] = xr[j] + vv::to_f(v[4 * wmax + c + j]) * (s[j] + vv::to_f(v[5 * wmax + c + j]));
    }
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
// The vectors are V: fp32 (int4 pack) or the plain pack's dtype; hb's rows
// are hd >= D floats apart.
template <typename T, typename V>
__device__ void mixer(const QArgs& a, cg::cluster_group& cl, int nb, int b0, int nbg, int c0,
                      int w, const V* v, const T* cs, int wmax, float* xs, float* hb,
                      float* nrm, float* xch, float* rs1, float* rs2, int hd) {
  const int D = a.D, Tn = a.T, NB = a.NB, C = a.C, rows = nbg * Tn;
  float* xch2 = xch + MAX_C * a.bg * Tn;
  rank_sumsq<NW>(cl, xs, wmax, rows, w, nrm, xch);
  cl.sync();
  row_scales(C, xch, rows, D, a.eps, rs1);
  for (int e = threadIdx.x; e < rows * w; e += NT) {
    const int r = e / w, c = e % w;
    hb[r * hd + c0 + c] = xs[r * wmax + c] * rs1[r] * vv::to_f(v[c]);
  }
  __syncthreads();
  if (blockIdx.x < C) {  // cluster 0: the new context, the last 6 rows of [ctx; h]
    T* ctx_out = static_cast<T*>(a.ctx_out);
    for (int e = threadIdx.x; e < nbg * CTX * w; e += NT) {
      const int bl = e / (CTX * w), j = (e / w) % CTX, c = e % w;
      const int src = j + Tn;
      const size_t cbase = (static_cast<size_t>(b0 + bl) * NB + nb) * CTX;
      const float val = src < CTX ? vv::to_f(cs[(bl * CTX + src) * wmax + c])
                                  : hb[(bl * Tn + src - CTX) * hd + c0 + c];
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
                                : hb[(bl * Tn + j - CTX) * hd + c0 + c];
      acc = acc + src * vv::to_f(v[(6 + k) * wmax + c]);
    }
    xs[r * wmax + c] =
        xs[r * wmax + c] + vv::to_f(v[2 * wmax + c]) * (acc + vv::to_f(v[wmax + c]));
  }
  __syncthreads();
  rank_sumsq<NW>(cl, xs, wmax, rows, w, nrm, xch2);
  if (w % 4 == 0 && c0 % 4 == 0 && D % 4 == 0) {  // 16-byte stores to the peers
    const int w4 = w / 4;
    for (int e = threadIdx.x; e < rows * w4; e += NT) {
      const int r = e / w4, c = 4 * (e % w4), o = r * hd + c0 + c;
      const float4 y = *reinterpret_cast<const float4*>(xs + r * wmax + c);
      const float4 g = ld4f(v + 3 * wmax + c);
      const float4 u = make_float4(y.x * g.x, y.y * g.y, y.z * g.z, y.w * g.w);
      for (int p = 0; p < C; ++p) *reinterpret_cast<float4*>(cl.map_shared_rank(hb, p) + o) = u;
    }
  } else {
    for (int e = threadIdx.x; e < rows * w; e += NT) {
      const int r = e / w, c = e % w;
      const float u = xs[r * wmax + c] * vv::to_f(v[3 * wmax + c]);
      for (int p = 0; p < C; ++p) cl.map_shared_rank(hb, p)[r * hd + c0 + c] = u;
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
  fetch_small<T, int8_t>(a, 0, f0, has_tile, c0, w, wmax, vs, cs, sb, bulk, mb + 16);
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
      fetch_small<T, int8_t>(a, step + 1, f0, has_tile, c0, w, wmax, vs, cs, sb, bulk,
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
    mixer<T, float>(a, cl, nb, b0, nbg, c0, w, v,
             reinterpret_cast<const T*>(cs + par * a.bg * CTX * wmax * sizeof(T)), wmax, xs, hb,
             nrm, xch, rs1, rs2, D);
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
      cluster_partial<4>(a, cl, step, hb, D, rows, rows_max);
    else
      cluster_partial<1>(a, cl, step, hb, D, rows, rows_max);
    grid_barrier(a.bar);  // the block's only grid-wide barrier
    if (V == 4)
      next_x<T, int8_t, 4>(a, cl, step, v, wmax, xs, rows, rows_max, base, nb == NB - 1);
    else
      next_x<T, int8_t, 1>(a, cl, step, v, wmax, xs, rows, rows_max, base, nb == NB - 1);
  }
  cl.sync();  // no peer reads this CTA's shared memory after it exits
}


// ---- the plain-pack chain: weight slices streamed through two rings ----

__host__ __device__ inline size_t up128(size_t v) { return (v + 127) & ~static_cast<size_t>(127); }

// Rows of the plain chain's register passes for a row group of `rows` rows:
// the next power of two (rows <= 16)
__host__ __device__ inline int p_rows(int rows) {
  int r = 1;
  while (r < rows) r *= 2;
  return r;
}

// The plain chain's padded depth: D rounded up to a multiple of 4 (the FMAs'
// width), the row length of the FFN input, the share and the W2 ring
__host__ __device__ inline int p_depth(int D) { return (D + 3) & ~3; }

// Byte offsets of chain_p_kernel's shared memory for row groups of bg items
// of T rows, pack elements of `es` bytes (`ops/fused_blocks.py:plain_smem`
// mirrors the total).
struct PLayout {
  size_t w1, w1_stage, w2, w2_stage, hb, xs, as, red, nrm, vs, cs, sb, mb, total;
};

__host__ __device__ inline PLayout p_layout(int D, int TF, int bg, int T, int C, int es, int kb,
                                            int ring, int r2, int ring2) {
  PLayout L;
  const size_t rows = static_cast<size_t>(bg) * T, R = p_rows(static_cast<int>(rows));
  const size_t wmax = q_wmax(D, C), nkl = NT / (TF / 4), rp = R < RP ? R : RP, Dp = p_depth(D);
  size_t o = 0;
  L.w1_stage = up128(static_cast<size_t>(kb) * TF * es);
  L.w1 = o;   o += ring * L.w1_stage;                     // W1 boxes [kb][TF]
  L.w2_stage = up128(static_cast<size_t>(r2) * Dp * es);
  L.w2 = o;   o += ring2 * L.w2_stage;                    // W2 runs [r2][Dp]
  L.hb = o;   o += up16(sizeof(float) * R * Dp);          // h, then ffn input, then the share
  L.xs = o;   o += up16(sizeof(float) * rows * wmax);     // x, then y, of the rank's columns
  L.as = o;   o += up16(sizeof(float) * R * TF);          // gelu activations
  L.red = o;  o += up16(sizeof(float) * nkl * rp * TF);   // up-projection k splits
  L.nrm = o;  o += up16(sizeof(float) * (q_chunks(D, C) + 2 * MAX_C + 2) * rows);
  L.vs = o;   o += up16(static_cast<size_t>(es) * 2 * NVEC * wmax);  // vectors, by step parity
  L.cs = o;   o += up16(sizeof(float) * 2 * bg * 6 * wmax);          // ctx rows, by parity
  L.sb = o;   o += up16(static_cast<size_t>(es) * 2 * TF);           // b1, by parity
  L.mb = o;   o += 8 * static_cast<size_t>(ring + ring2 + 2);        // mbarriers
  L.total = o + 128;  // the base is aligned up to 128 bytes (the tensor map's boxes)
  return L;
}

// W1 chunk c (step c / nk, box c % nk of the block's Dp rows) of the CTA's
// columns into stage c % ring: with the tensor map, one box [kb][TF] asked
// for by the calling thread; otherwise cp.async by every thread, each
// arriving on the stage's mbarrier once its copies land.  Columns past F and
// rows past D read 0.
template <typename W>
__device__ void issue_w1(const QArgs& a, const CUtensorMap* map, int c, int nk, int f0,
                         unsigned char* ring, size_t stage_b, uint32_t mb) {
  const int k0 = c % nk * a.kb, y = (c / nk) % a.NB * (a.D + 8) + k0, stage = c % a.ring;
  unsigned char* dst = ring + stage * stage_b;
  const uint32_t bar = mb + 8 * stage;
  const int rb = a.TF * static_cast<int>(sizeof(W));
  if (a.maps) {
    fence_async();
    mbar_expect(bar, static_cast<uint32_t>(a.kb) * rb);
    tma_box(dst, map, f0, y, bar, vv::evict_first_policy());  // read once per call
    return;
  }
  const int rows = min(a.kb, a.D - k0);  // the rest are Dp's padding: zeros
  const W* src = static_cast<const W*>(a.w1) + static_cast<size_t>(y) * a.F + f0;
  copy_rows(dst, rb, src, static_cast<size_t>(a.F) * sizeof(W), rows, rb,
            max(0, a.F - f0) * static_cast<int>(sizeof(W)));
  copy_rows(dst + static_cast<size_t>(rows) * rb, rb, src, 0, a.kb - rows, rb, 0);
  vv::cp_async_arrive(bar);
}

// W2 chunk c (step c / n2, run c % n2 of the CTA's TF rows) into stage
// c % ring2 as rows of Dp: its rows inside F, contiguous, by one bulk copy
// asked for by the calling thread, or by cp.async as issue_w1 (columns past
// D, and rows past F up to the next multiple of 4, read 0).  Other rows past
// F are not copied (nor read).
template <typename W>
__device__ void issue_w2(const QArgs& a, int c, int n2, int f0, unsigned char* ring,
                         size_t stage_b, uint32_t mb) {
  const int stage = c % a.ring2, nb = (c / n2) % a.NB, r0 = f0 + c % n2 * a.r2;
  const int live = max(0, min(a.r2, a.F - r0));
  const W* src = static_cast<const W*>(a.w2) + (static_cast<size_t>(nb) * a.F + r0) * a.D;
  unsigned char* dst = ring + stage * stage_b;
  const uint32_t bar = mb + 8 * stage;
  if (a.maps) {
    const uint32_t bytes = static_cast<uint32_t>(live) * a.D * sizeof(W);
    fence_async();
    mbar_expect(bar, bytes);
    if (bytes) bulk_copy(dst, src, bytes, bar, vv::evict_first_policy());
    return;
  }
  const int es = static_cast<int>(sizeof(W)), rb = p_depth(a.D) * es;
  if (rb == a.D * es)  // the run's rows back to back, as one
    copy_rows(dst, 0, src, 0, 1, live * rb, live * rb);
  else
    copy_rows(dst, rb, src, static_cast<size_t>(a.D) * es, live, rb, a.D * es);
  copy_rows(dst + static_cast<size_t>(live) * rb, rb, src, 0, min(a.r2, (live + 3) & ~3) - live,
            rb, 0);
  vv::cp_async_arrive(bar);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4& w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

// fn(std::integral_constant<int, R>) for the register-pass rows R =
// p_rows(nr) of a row group of nr <= 16 rows
template <typename Fn>
__device__ __forceinline__ void with_p_rows(int nr, Fn fn) {
  if (nr <= 1)
    fn(std::integral_constant<int, 1>());
  else if (nr <= 2)
    fn(std::integral_constant<int, 2>());
  else if (nr <= 4)
    fn(std::integral_constant<int, 4>());
  else if (nr <= 8)
    fn(std::integral_constant<int, 8>());
  else
    fn(std::integral_constant<int, 16>());
}

// as[r][c] = gelu((hn[r] @ W1[:, f0 + c]) * rs2[r] + b1[c]) for r < nr, c < TF
// (0 past F): hn ([R][Dp], zeros past D) is the FFN input before its row
// scale rs2, which multiplies the product instead.  Thread (cw, kl) takes columns 4cw..4cw+3 of the rows
// 4kl..4kl+3, 4(kl + nkl).., of each W1 box of the step, waiting for it on
// its stage's mbarrier; after every thread is done with a stage, the issuer
// refills it with chunk c + ring.  R register rows (rows past nr are
// computed and dropped); the nkl k splits meet in `red`, RP rows at a time,
// and are added in order.
template <int R, typename W>
__device__ void up_proj_p(const QArgs& a, const CUtensorMap* map, int step, int steps, int f0,
                          unsigned char* ring, size_t stage_b, uint32_t mb, const float* hb,
                          const float* rs2, const W* b1, int nr, float* red, float* as) {
  const int D = p_depth(a.D), TF = a.TF, kb = a.kb, nk = D / kb, cgw = TF / 4, nkl = NT / cgw;
  const int cw = threadIdx.x % cgw, kl = threadIdx.x / cgw;
  const bool issuer = !a.maps || threadIdx.x == ISSUER;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int c = step * nk + k, stage = c % a.ring;
    mbar_wait(mb + 8 * stage, (c / a.ring) & 1);
    if (kl < nkl) {
      const W* ws = reinterpret_cast<const W*>(ring + stage * stage_b) + 4 * cw;
      const float* x0 = hb + k * kb;
#pragma unroll 2
      for (int i = 4 * kl; i < kb; i += 4 * nkl) {
        float4 wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) wv[g] = ld4f(ws + static_cast<size_t>(i + g) * TF);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(x0 + r * D + i);
          fma4(acc[r], xv.x, wv[0]);
          fma4(acc[r], xv.y, wv[1]);
          fma4(acc[r], xv.z, wv[2]);
          fma4(acc[r], xv.w, wv[3]);
        }
      }
    }
    __syncthreads();
    if (issuer && c + a.ring < steps * nk)
      issue_w1<W>(a, map, c + a.ring, nk, f0, ring, stage_b, mb);
  }
  constexpr int rp = R < RP ? R : RP;
  for (int m0 = 0; m0 < nr; m0 += rp) {
    if (kl < nkl)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r >= m0 && r < m0 + rp)
          *reinterpret_cast<float4*>(red + (kl * rp + r - m0) * TF + 4 * cw) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    const int rr = min(rp, nr - m0);
    for (int e = threadIdx.x; e < rr * TF; e += NT) {
      const int r = e / TF, c = e % TF;
      float s = 0.f;
#pragma unroll 8
      for (int l = 0; l < nkl; ++l) s += red[(l * rp + r) * TF + c];
      float v = 0.f;
      if (f0 + c < a.F) {
        v = s * rs2[m0 + r] + vv::to_f(b1[c]);
        v = 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
      }
      as[(m0 + r) * TF + c] = v;
    }
    __syncthreads();
  }
}

// share [R][Dp] (in hb) = as @ the CTA's W2 rows, run by run of the W2 ring:
// thread cw takes columns 4cw..4cw+3 of every row of a run, four rows at a
// time, its sums carried in the share; after every thread is done with a
// stage, the issuer refills it with chunk c + ring2.
template <int R, typename W>
__device__ void down_proj_p(const QArgs& a, int step, int steps, int f0, unsigned char* ring,
                            size_t stage_b, uint32_t mb, const float* as, float* share) {
  const int D = p_depth(a.D), TF = a.TF, r2 = a.r2, n2 = TF / r2;
  const bool issuer = !a.maps || threadIdx.x == ISSUER;
  for (int j = 0; j < n2; ++j) {
    const int c = step * n2 + j, stage = c % a.ring2;
    // the run's rows inside F, up to a multiple of 4 (rows past F: zeros)
    const int live = (max(0, min(r2, a.F - (f0 + j * r2))) + 3) & ~3;
    mbar_wait(mb + 8 * stage, (c / a.ring2) & 1);
    const W* ws = reinterpret_cast<const W*>(ring + stage * stage_b);
    const float* a0 = as + j * r2;
    for (int cw = threadIdx.x; 4 * cw < D; cw += NT) {
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 v = j ? *reinterpret_cast<const float4*>(share + r * D + 4 * cw)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[r][0] = v.x, acc[r][1] = v.y, acc[r][2] = v.z, acc[r][3] = v.w;
      }
#pragma unroll 2
      for (int i = 0; i < live; i += 4) {
        float4 wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) wv[g] = ld4f(ws + static_cast<size_t>(i + g) * D + 4 * cw);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(a0 + r * TF + i);
          fma4(acc[r], av.x, wv[0]);
          fma4(acc[r], av.y, wv[1]);
          fma4(acc[r], av.z, wv[2]);
          fma4(acc[r], av.w, wv[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float4*>(share + r * D + 4 * cw) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    if (issuer && c + a.ring2 < steps * n2) issue_w2<W>(a, c + a.ring2, n2, f0, ring, stage_b, mb);
  }
}

// T: x's dtype; W: the plain pack's (float or __nv_bfloat16).
template <typename T, typename W>
__global__ void __launch_bounds__(NT, 1)
    chain_p_kernel(const __grid_constant__ CUtensorMap w1map, const QArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smc = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  cg::cluster_group cl = cg::this_cluster();
  const int D = a.D, Tn = a.T, NB = a.NB, C = a.C, rows_max = a.bg * Tn;
  const PLayout L = p_layout(D, a.TF, a.bg, Tn, C, sizeof(W), a.kb, a.ring, a.r2, a.ring2);
  unsigned char* w1r = smc + L.w1;
  unsigned char* w2r = smc + L.w2;
  float* hb = reinterpret_cast<float*>(smc + L.hb);
  float* xs = reinterpret_cast<float*>(smc + L.xs);
  float* as = reinterpret_cast<float*>(smc + L.as);
  float* red = reinterpret_cast<float*>(smc + L.red);
  float* nrm = reinterpret_cast<float*>(smc + L.nrm);  // then the exchanges, then rs1, rs2
  float* xch = nrm + q_chunks(D, C) * rows_max;
  float* rs1 = xch + 2 * MAX_C * rows_max;
  float* rs2 = rs1 + rows_max;
  W* vs = reinterpret_cast<W*>(smc + L.vs);
  unsigned char* cs = smc + L.cs;
  W* sb = reinterpret_cast<W*>(smc + L.sb);
  // mbarriers: the W1 ring's, the W2 ring's, the small copies' (by step parity)
  const uint32_t mb1 = smem_u32(smc + L.mb), mb2 = mb1 + 8 * a.ring, mbs = mb2 + 8 * a.ring2;
  const T* x_in = static_cast<const T*>(a.x);
  const int V = q_vec(D), nv = D / V, rank = static_cast<int>(cl.block_rank());
  const int c0 = rank * nv / C * V, w = ((rank + 1) * nv / C) * V - c0, wmax = q_wmax(D, C);
  const bool has_tile = blockIdx.x < a.tiles;
  const int es = static_cast<int>(sizeof(T) < sizeof(W) ? sizeof(T) : sizeof(W));
  const bool bulk = a.maps && (w * es) % 16 == 0 && (c0 * es) % 16 == 0 &&
                    (wmax * es) % 16 == 0 && (D * es) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.ctx) % 16 == 0;
  const int Dp = p_depth(D), f0 = blockIdx.x * a.TF, nk = Dp / a.kb, n2 = a.TF / a.r2;
  const int steps = (a.B + a.bg - 1) / a.bg * NB;
  if (threadIdx.x == 0) {
    // a ring stage completes on one arrival with the bytes of its copy, or
    // on every thread's arrival after its cp.async copies
    for (int k = 0; k < a.ring + a.ring2; ++k) mbar_init(mb1 + 8 * k, a.maps ? 1 : NT);
    mbar_init(mbs);
    mbar_init(mbs + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (Dp != D)  // the FFN input's padding columns stay 0
    for (int e = threadIdx.x; e < p_rows(rows_max) * Dp; e += NT) hb[e] = 0.f;
  __syncthreads();
  if (bulk) fetch_small<T, W>(a, 0, f0, has_tile, c0, w, wmax, vs, cs, sb, true, mbs);
  __syncthreads();  // the small copies queue ahead of the weights
  if (has_tile && (!a.maps || threadIdx.x == ISSUER)) {
    for (int c = 0; c < a.ring && c < steps * nk; ++c)
      issue_w1<W>(a, &w1map, c, nk, f0, w1r, L.w1_stage, mb1);
    for (int c = 0; c < a.ring2 && c < steps * n2; ++c)
      issue_w2<W>(a, c, n2, f0, w2r, L.w2_stage, mb2);
  }
  for (int step = 0; step < steps; ++step) {
    const int nb = step % NB, b0 = step / NB * a.bg, par = step % 2;
    const int nbg = min(a.bg, a.B - b0), rows = nbg * Tn;
    const size_t base = static_cast<size_t>(b0) * Tn * D;
    const W* v = vs + par * NVEC * wmax;
    // every thread is done with the last step (its small operands, which
    // the next copies overwrite, and its columns of xs)
    __syncthreads();
    if (nb == 0)
      for (int e = threadIdx.x; e < rows * w; e += NT) {
        const int r = e / w, c = e % w;
        xs[r * wmax + c] = vv::to_f(x_in[base + static_cast<size_t>(r) * D + c0 + c]);
      }
    if (bulk) {
      if (step + 1 < steps)
        fetch_small<T, W>(a, step + 1, f0, has_tile, c0, w, wmax, vs, cs, sb, true,
                          mbs + 8 * (1 - par));
      mbar_wait(mbs + 8 * par, (step >> 1) & 1);
    } else {
      fetch_small<T, W>(a, step, f0, has_tile, c0, w, wmax, vs, cs, sb, false, 0);
      cp_commit();
      cp_wait<0>();
    }
    __syncthreads();
    mixer<T, W>(a, cl, nb, b0, nbg, c0, w, v,
                reinterpret_cast<const T*>(cs + par * a.bg * CTX * wmax * sizeof(T)), wmax, xs, hb,
                nrm, xch, rs1, rs2, Dp);
    if (has_tile)
      with_p_rows(rows, [&](auto R) {
        constexpr int NR = decltype(R)::value;
        up_proj_p<NR, W>(a, &w1map, step, steps, f0, w1r, L.w1_stage, mb1, hb, rs2,
                         sb + par * a.TF, rows, red, as);
        down_proj_p<NR, W>(a, step, steps, f0, w2r, L.w2_stage, mb2, as, hb);
      });
    if (V == 4)
      cluster_partial<4>(a, cl, step, hb, Dp, rows, rows_max);
    else
      cluster_partial<1>(a, cl, step, hb, Dp, rows, rows_max);
    grid_barrier(a.bar);  // the block's only grid-wide barrier
    if (V == 4)
      next_x<T, W, 4>(a, cl, step, v, wmax, xs, rows, rows_max, base, nb == NB - 1);
    else
      next_x<T, W, 1>(a, cl, step, v, wmax, xs, rows, rows_max, base, nb == NB - 1);
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


// w1 [N, D+8, F] as a 2-D map of N*(D+8) rows of F elements of the pack's
// type, boxes [kb][TF]; columns past F read as zeros.  The map is cached per
// pack and shape.
template <typename W>
int p_w1_map(CUtensorMap* map, const QArgs& a) {
  static std::map<std::tuple<const void*, int, int, int, int, int>, CUtensorMap> maps;
  const auto key = std::make_tuple(a.w1, a.NB, a.D, a.F, a.TF, a.kb);
  auto it = maps.find(key);
  if (it == maps.end()) {
    CUtensorMap m;
    const CUtensorMapDataType type = std::is_same<W, float>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (const int rc = vv::encode_2d(&m, type, sizeof(W), a.w1, a.F,
                                     static_cast<uint64_t>(a.NB) * (a.D + 8), a.TF, a.kb))
      return rc;
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return 0;
}

// Raises chain_p_kernel's shared-memory limit, once per device.
int p_opt_in() {
  static std::set<int> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!opted.count(dev)) {
    void (*kerns[4])(CUtensorMap, QArgs) = {
        chain_p_kernel<float, float>, chain_p_kernel<float, __nv_bfloat16>,
        chain_p_kernel<__nv_bfloat16, float>, chain_p_kernel<__nv_bfloat16, __nv_bfloat16>};
    for (auto k : kerns) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    opted.insert(dev);
  }
  return 0;
}

template <typename T, typename W>
int p_clusters(size_t smem, int* out) {
  if (const int rc = p_opt_in()) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = q_config(MAX_C, MAX_C, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, chain_p_kernel<T, W>, &cfg));
}

template <typename T, typename W>
int launch_p(const QArgs& a, size_t smem, cudaStream_t stream) {
  if (const int rc = p_opt_in()) return rc;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.maps)
    if (const int rc = p_w1_map<W>(&map, a)) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = q_config(a.ncl * a.C, a.C, smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, chain_p_kernel<T, W>, map, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// fn(T(), W()) for the dtype codes of x (T) and of the plain pack (W)
template <typename Fn>
int with_plain_types(int dtype, int wdtype, Fn fn) {
  if (dtype == 0 && wdtype == 0) return fn(float(), float());
  if (dtype == 0 && wdtype == 1) return fn(float(), __nv_bfloat16());
  if (dtype == 1 && wdtype == 0) return fn(__nv_bfloat16(), float());
  if (dtype == 1 && wdtype == 1) return fn(__nv_bfloat16(), __nv_bfloat16());
  return -5;  // unsupported dtype
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
  QArgs a{x, ctx, vecs, mixw, w1q, static_cast<const float*>(sb1), w2q,
          static_cast<const float*>(s2), y, ctx_out, static_cast<float*>(part),
          static_cast<unsigned int*>(bar), B, T, D, F, NB, bg, TF, ncl, tiles, C,
          q_box_rows(D, F, TF), 0, 0, 0, 0, 0, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_q<float>(a, smem, st);
  if (dtype == 1) return launch_q<__nv_bfloat16>(a, smem, st);
  return -5;  // unsupported dtype
}

// The plain chain's clusters of 8 CTAs that the card holds at once with
// `smem` bytes of shared memory per CTA, into *out (the launch's grid may not
// exceed them: its grid barrier needs every CTA resident).
extern "C" int vv_fused_block_chain_plain_clusters(long long smem, int dtype, int wdtype,
                                                   int* out) {
  if (smem <= 0 || smem > 227 * 1024) return -4;
  return with_plain_types(dtype, wdtype, [&](auto t, auto w) {
    return p_clusters<decltype(t), decltype(w)>(static_cast<size_t>(smem), out);
  });
}

// The plain-pack chain (TPU kernel `fused_block_chain`): vecs/mixw [N, 8, D],
// w1 [N, D+8, F], w2 [N, F, D], all of dtype code `wdtype`; ncl clusters of 8 CTAs, CTA k on FFN columns [k*TF, (k+1)*TF); bg
// batch items per row group; W1 in boxes of kb rows through a ring of `ring`
// stages, W2 in runs of r2 rows through `ring2`; `part` and `bar` the
// workspace, as for vv_fused_block_chain.  The weights come by tensor map and
// bulk copy where every row and slice is whole 16-byte vectors, else by
// cp.async.
extern "C" int vv_fused_block_chain_plain(const void* x, const void* ctx, const void* vecs,
                                          const void* mixw, const void* w1, const void* w2,
                                          void* y, void* ctx_out, void* part, void* bar, int B,
                                          int T, int D, int F, int NB, int bg, int TF, int ncl,
                                          int kb, int ring, int r2, int ring2, float eps,
                                          int dtype, int wdtype, void* stream) {
  if (B <= 0 || T <= 0 || T > 8 || NB <= 0 || D <= 0 || F <= 0) return -1;
  if (bg <= 0 || bg > B || bg * T > 16 || TF <= 0 || TF % 4 || TF > 4 * NT || part == nullptr ||
      bar == nullptr)
    return -2;
  const int tiles = (F + TF - 1) / TF;
  if (ncl != (tiles + MAX_C - 1) / MAX_C) return -3;
  if (kb <= 0 || kb % 4 || p_depth(D) % kb || r2 <= 0 || r2 % 4 || TF % r2 || ring < 1 ||
      ring2 < 1)
    return -8;
  const int es = wdtype == 0 ? 4 : 2;
  const size_t smem = p_layout(D, TF, bg, T, MAX_C, es, kb, ring, r2, ring2).total;
  if (smem > 227 * 1024) return -4;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(vecs) | reinterpret_cast<uintptr_t>(mixw) |
                         reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2);
  const int maps = (D * es) % 16 == 0 && (F * es) % 16 == 0 && (TF * es) % 16 == 0 &&
                   TF <= 256 && kb <= 256 && ptrs % 16 == 0;
  QArgs a{x, ctx, vecs, mixw, w1, nullptr, w2, nullptr, y, ctx_out, static_cast<float*>(part),
          static_cast<unsigned int*>(bar), B, T, D, F, NB, bg, TF, ncl, tiles, MAX_C,
          0, kb, ring, r2, ring2, maps, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_plain_types(dtype, wdtype, [&](auto t, auto w) {
    return launch_p<decltype(t), decltype(w)>(a, smem, st);
  });
}
