// Fused large-T sigma-VAE stage (N Block1Ds over T rows, with optional folded
// transition conv and decoder tail), for Hopper (sm_90a).
//
// Replaces the TPU kernels `vibevoice_tpu/ops/fused_stage.py:fused_stage_chain`
// (Pallas `_make_kernel`) and `_fused_stage_chain_rowlane`
// (`_make_kernel_rowlane`).  For x [B, T, W] and per-block contexts ctx [B, N,
// 6, W], each block:
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
// The row-lane form (TPU kernel #7) computes the same blocks from a row-lane
// pack (vecs/mixw [N, 8, R*W], w1 kron(I_R, W1) [N, R*W, R*F], b1 [N, 1,
// R*F], w2 kron(I_R, W2) [N, R*F, R*W]).  The TPU kernel lays R batch rows
// side by side in its 128 vector lanes ([G, T, R*W], relayouts outside its
// pallas_call) and takes the norms' group means through an `avg` product; a
// Hopper SM has no lanes to fill, so here batch item bb reads x, ctx, y and
// the new ctx in their own [B, ...] layouts and only lane group r = bb % R of
// the pack: its vectors and the diagonal blocks of w1, b1 and w2 (the pack's
// strides and per-lane offsets `*_ld`, `*_lane`, from the wrapper; the
// off-diagonal blocks are zeros and never read), with each row's mean over
// its own W channels.  So a row-lane call is the stage kernel below on the
// diagonal blocks: the same products and sums in the same order, bit-equal to
// it on the pack without its row-lane entry.
//
// Bound: a stage moves a few MB at most (decoder stage 3 at 1.5B: 3.2 MB of
// block weights and 2.6 MB of up-conv weight in bf16) and computes 0.2-0.7
// GFLOP, so on this card the least time is 0.2-2 us: the kernel is bound by
// latency and parallelism, not by bytes or the tensor cores.
//
// Design: the TPU grid walks T-tiles in order and carries every block's conv
// context in VMEM.  On Hopper, in order, one CTA would own the stage at B=1.
// Here ONE launch spreads the stage over the card, and a grid barrier stands
// only where a row tile needs rows of the tile before it.  Each row tile of
// R = 32 rows is owned by one thread-block cluster of C <= 8 CTAs (C from the
// wrapper: F / C FFN columns per CTA):
//   P. (folded conv) the conv as a tiled product into `xg` over the whole
//      grid: "up" x_in @ every tap's weight ([Ti, 2s*W], the overlap-add is
//      left to the first block's mixer), "down" the strided windows of
//      [context; x_in] @ the flattened [k*Cin, W] weight; CTA 0 copies the
//      new down-conv context;
//   -- grid barrier --
//   then per block and row tile, inside its cluster:
//   A. CTA `rank` takes R / C of the tile's rows: their block input and that
//      of the 6 rows before them (x, the conv's product plus bias and
//      overlap, or the previous block's output) is normed, convolved with
//      [ctx; h], and kept as the residual; the rounded FFN input goes to its
//      shared memory; the CTA of the last row writes the new context (and,
//      block 0, the new transposed-conv tail);
//   -- cluster barrier: each CTA gathers the tile's FFN input from its peers
//      through distributed shared memory --
//   B. each CTA's F / C FFN columns: gelu(hn @ w1[:, cols] + b1) stays in
//      shared memory, a @ w2[cols, :] is its share of the output, in shared
//      memory too;
//   -- cluster barrier --
//   C. CTA `rank` adds its rows' C shares in rank order through distributed
//      shared memory (no float atomics and no partials in device memory: the
//      same result on every run) and writes the block's output rows (fp32,
//      alternating between two buffers), or, for the last block, y;
//   -- grid barrier between blocks: the next block's mixer reads the 6 rows
//      before its tile from another cluster --
//   O. only with the folded tail (which needs the hk - 1 rows before each
//      tile): after one more grid barrier, items of RT rows write the
//      waveform rows (one warp per row) and the new head context.
// So a call makes N - 1 grid barriers, plus one for a folded conv and one for
// the folded tail, and its results depend on C (a function of the shape) but
// not on the grid or on the JAX package's `tile_want`.  The products (`gemm`)
// stream their weights in chunks of GKC rows through a ring of NSTAGE
// cp.async buffers (`Ring`), which starts loading a tile's FFN weights before
// its mixer runs.  In bf16 they run on mma.sync m16n8k16 (fp32 sums) where
// every depth is whole k16 steps; the stem conv (cin = 1), fp32 packs and
// other widths take exact fp32 FMAs.  Rows, FFN slices and per-lane weight
// offsets that are whole 16-byte vectors move as 16-byte vectors; otherwise
// (`NARROW`: e.g. bf16 W = 4, fp32 W = 6) the same kernel copies weights by
// cp.async of 8 or 4 bytes (bf16 rows of an odd length: 2-byte loads) and
// moves rows element by element.  The grid barrier is a counter in device
// memory (the clusters are launched with cudaLaunchKernelEx, never more than
// the card holds at once, which the occupancy query gives).
//
// Plain C interface, loaded with ctypes (`StageParams` mirrors the ctypes
// structure in ops/fused_stage.py).  dtype codes: 0 float32, 1 bfloat16 (x,
// ctx, the states, the pack and the conv pack share it; head_w is fp32).
// Returns 0, a negative code for arguments or a card it does not take, or
// the CUDA error of the launch.

#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <tuple>

#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace {

using vv::THREADS;
using vv::WARPS;
constexpr int CTX = 6;
constexpr int RT = 32;   // rows per output item of the folded tail
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
  const void* conv_w;   // [k, cin, W]
  const void* conv_b;   // [1, W]
  const float* head_w;  // [hk + 1, W]
  void* y;
  void* ctx_out;
  void* conv_out;
  void* head_out;
  float* xg;    // folded conv product: up [B*T/s, 2s*W], down [B*T, W]
  float* yg;    // [B*T, W] block outputs, alternating with xb
  float* xb;    // [B*T, W]
  unsigned int* bar;  // the grid barrier's counter (0 before the first call)
  int B, T, W, F, NB, conv_kind, cs, ck, cin, hk, hnorm, dtype;
  int C;  // CTAs per cluster: FFN column slices of a row tile
  // The pack's layout (elements): block strides of w1, b1 and w2; row strides
  // of vecs/mixw, w1 and w2; batch item bb reads lane group bb % lanes, at
  // these offsets times the lane (a plain pack: 1 lane)
  int w1_stride, b1_stride, w2_stride, vec_ld, w1_ld, w2_ld;
  int lanes, vec_lane, w1_lane, b1_lane, w2_lane;
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

// dst[e] = src[e] for e < n, from L2 (src was written in this launch by other
// CTAs), LB loads in flight per thread: float4 (n a multiple of 4, src
// 16-byte aligned), or (NARROW) one float each
template <bool NARROW>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n) {
  constexpr int V = NARROW ? 1 : 4;
  for (int e0 = V * threadIdx.x; e0 < n; e0 += V * THREADS * LB) {
    if constexpr (NARROW) {
      float v[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int e = e0 + THREADS * u;
        v[u] = e < n ? __ldcg(src + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LB; ++u)
        if (e0 + THREADS * u < n) dst[e0 + THREADS * u] = v[u];
    } else {
      float4 v[LB];
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int e = e0 + 4 * THREADS * u;
        v[u] = e < n ? __ldcg(reinterpret_cast<const float4*>(src + e))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < LB; ++u) {
        const int e = e0 + 4 * THREADS * u;
        if (e < n) *reinterpret_cast<float4*>(dst + e) = v[u];
      }
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
  if (p.conv_kind == 2) return __ldcg(p.xg + row * W + d) + b;
  const int s = p.cs, tin = p.T / s;
  const size_t bb = row / p.T;
  const int t = static_cast<int>(row % p.T), i = t / s, j = t % s;
  const float* yi = p.xg + (bb * tin + i) * 2 * s * W;
  const float prev = i > 0 ? __ldcg(yi + (s + j) * W + d - 2 * s * W)
                           : vv::to_f(static_cast<const T*>(p.conv_state)[(bb * s + j) * W + d]);
  return (__ldcg(yi + j * W + d) + prev) + b;
}

// xs[j * W + d] = the input of block nb (`stage_input`, or the previous
// block's output `src`) at row lo + j of the batch row that starts at row0 (0
// before the sequence), for j < nrow
template <typename T, bool NARROW>
__device__ void load_rows(const StageParams& p, const float* src, int nb, size_t row0, int lo,
                          int nrow, float* xs) {
  const int W = p.W, n = nrow * W;
  if (nb > 0) {  // a plain copy of the previous block's output
    const int skip = max(0, -lo);
    for (int e = threadIdx.x; e < skip * W; e += THREADS) xs[e] = 0.f;
    copy_rows<NARROW>(xs + skip * W, src + (row0 + lo + skip) * W, n - skip * W);
    return;
  }
  for (int e0 = threadIdx.x; e0 < n; e0 += LB * THREADS) {
    float v[LB];
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int e = e0 + u * THREADS, t = lo + e / W;
      v[u] = e < n && t >= 0 ? stage_input<T>(p, row0 + t, e % W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LB; ++u)
      if (e0 + u * THREADS < n) xs[e0 + u * THREADS] = v[u];
  }
}

// ---- O: the folded tail ----
template <typename T, bool NARROW>
__device__ void phase_out(const StageParams& p, const float* src, float* sm) {
  const int W = p.W, Tn = p.T, NB = p.NB, hk = p.hk, hc = hk - 1;
  T* y = static_cast<T*>(p.y);
  const int tiles = (Tn + RT - 1) / RT;
  float* xs = sm;                    // [RT + hc][W]
  float* sc = xs + (RT + hc) * W;    // inverse RMS per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int it = blockIdx.x; it < p.B * tiles; it += gridDim.x) {
    const int bb = it / tiles, t0 = (it % tiles) * RT, t1 = min(Tn, t0 + RT);
    const size_t row0 = static_cast<size_t>(bb) * Tn;
    const int lo = t0 - hc, nrow = t1 - lo;
    load_rows<T, NARROW>(p, src, NB, row0, lo, nrow, xs);
    __syncthreads();
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

// ======================================================================
// The stage kernel proper (packs without a row-lane entry): one launch,
// thread-block clusters over row tiles, one grid barrier per block.
// ======================================================================

constexpr int R = 32;          // rows per cluster tile (two m16 tiles)
constexpr int GKC = 128;       // weight rows per cp.async chunk of a `Ring`
constexpr int NSTAGE = 3;      // chunks in a `Ring`: two load while one is consumed
constexpr int GNT = 64;        // columns per product tile
constexpr int GNTP = GNT + 8;  // chunk row stride (elements): ldmatrix.trans without conflicts
constexpr int MAX_C = 8;       // CTAs per cluster: the portable size

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; with pred false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
// 8 or 4 bytes global -> shared (`bytes`), zero-filled where pred is false
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, int bytes, bool pred) {
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(pred ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a b for one 16x8 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid-wide barrier on a counter in device memory (the algorithm of
// cooperative groups' grid.sync: block 0 adds 2^31 - (n - 1), the others 1,
// so the counter's top bit flips once all have arrived and its low bits are
// back to 0).  Every CTA of the grid is resident: the host sizes the grid by
// the occupancy of the cluster launch.  A barrier that is not reached within
// seconds traps rather than hanging the card.
__device__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(bar, add);
    unsigned int cur;
    long long spins = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(cur) : "l"(bar) : "memory");
      if ((old ^ cur) & 0x80000000u) break;
      if (++spins > (1LL << 26)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The weight chunks of up to two products (B_p: K_p x N_p, row stride ld_p),
// streamed in order, GKC rows x GNT columns at a time, through a ring of
// NSTAGE cp.async buffers in shared memory: the ring runs NSTAGE - 1 chunks
// ahead of the product that consumes them, so the first chunks load before
// (or while) the product's A is made, and each chunk waits behind NSTAGE - 2
// others rather than on its own load.  Copies of 16 bytes, or (NARROW) of
// `unit` bytes: 8 or 4 by cp.async, 2 (bf16 rows of an odd length) by plain
// loads and stores; every row, row stride and column count of B is whole
// copies.
template <typename T, bool NARROW>
struct Ring {
  const T* b0;
  const T* b1;
  size_t ld0, ld1;
  int k0, k1, n0, n1, nk0, nk1, cnt0, cnt1;
  T* bs;
  int issued, unit;

  __device__ Ring(T* buf, int unit_bytes, const T* B0, size_t ldb0, int K0, int N0,
                  const T* B1 = nullptr, size_t ldb1 = 0, int K1 = 0, int N1 = 0)
      : b0(B0), b1(B1), ld0(ldb0), ld1(ldb1), k0(K0), k1(K1), n0(N0), n1(N1),
        nk0((K0 + GKC - 1) / GKC), nk1((K1 + GKC - 1) / GKC),
        cnt0(nk0 * ((N0 + GNT - 1) / GNT)), cnt1(B1 ? nk1 * ((N1 + GNT - 1) / GNT) : 0),
        bs(buf), issued(0), unit(NARROW ? unit_bytes : 16) {
    for (int i = 0; i < NSTAGE - 1; ++i) issue();
  }

  __device__ T* slot(int q) const { return bs + (q % NSTAGE) * GKC * GNTP; }

  // the next chunk's loads (none past the last chunk), committed as a group
  __device__ void issue() {
    const int q = issued++;
    if (q < cnt0 + cnt1) {
      const bool second = q >= cnt0;
      const int r = second ? q - cnt0 : q, nk = second ? nk1 : nk0;
      const int K = second ? k1 : k0, N = second ? n1 : n0;
      const T* B = second ? b1 : b0;
      const size_t ldb = second ? ld1 : ld0;
      const int kb = (r % nk) * GKC, nb = (r / nk) * GNT;
      T* buf = slot(q);
      const int V = NARROW ? unit / static_cast<int>(sizeof(T)) : 16 / sizeof(T);
      const int per = GNT / V;  // copies per chunk row
      for (int i = threadIdx.x; i < GKC * per; i += THREADS) {
        const int row = i / per, c = i % per, k = kb + row, n = nb + c * V;
        const bool live = k < K && n < N;
        T* dst = buf + row * GNTP + c * V;
        const T* src = live ? B + k * ldb + n : B;
        if constexpr (!NARROW)
          cp_async16(dst, src, live);
        else if (V * sizeof(T) >= 4)
          cp_async_small(dst, src, unit, live);
        else
          *dst = live ? *src : vv::from_f<T>(0.f);
      }
    }
    cp_commit();
  }
};

// Block-wide product of a 32-row tile with the ring's product `second`: for
// every column tile of GNT columns of B, epi(r, c, sum_k A[r * lda + k] *
// B[k][c]) for r < 32, c < N.  A (32 x K, type T) is in shared memory.  MMA:
// bf16 mma.sync m16n8k16, fp32 sums (K a multiple of 16, A's rows 16-byte
// aligned); warp w takes rows 16 (w / 4) .. +16 and columns 16 (w % 4) .. +16
// of the tile.  Else exact fp32 FMAs: thread t takes rows 2 (t / 16) + {0, 1}
// and columns 4 (t % 16) .. +4.
template <typename T, bool MMA, typename RingT, typename Epi>
__device__ void gemm(RingT& ring, bool second, const T* A, int lda, Epi epi) {
  const int K = second ? ring.k1 : ring.k0, N = second ? ring.n1 : ring.n0;
  const int nk = second ? ring.nk1 : ring.nk0, cnt = second ? ring.cnt1 : ring.cnt0;
  const int base = second ? ring.cnt0 : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r = 0; r < cnt; ++r) {
    const int kc = r % nk, k0 = kc * GKC, kn = min(GKC, K - k0), n0 = (r / nk) * GNT;
    cp_wait<NSTAGE - 2>();  // this chunk has landed
    __syncthreads();        // ... for every thread; the previous chunk is consumed
    ring.issue();           // into the previous chunk's buffer
    const T* buf = ring.slot(base + r);
    if constexpr (MMA) {
      const int mi = warp >> 2, nj = warp & 3;
      for (int kk = 0; kk < kn; kk += 16) {
        uint32_t a[4], b[4];
        ldsm4(a, A + (16 * mi + (lane & 15)) * lda + k0 + kk + 8 * (lane >> 4));
        ldsm4t(b, buf + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * GNTP + 16 * nj +
                      8 * (lane >> 4));
        mma_bf16(acc[0], a, b[0], b[1]);
        mma_bf16(acc[1], a, b[2], b[3]);
      }
    } else {
      const int cgi = tid % 16, rg = tid / 16;
      const T* a0 = A + 2 * rg * lda + k0;
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float4 w = lds4(buf + k * GNTP + 4 * cgi);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a = vv::to_f(a0[i * lda + k]);
          acc[i][0] += a * w.x;
          acc[i][1] += a * w.y;
          acc[i][2] += a * w.z;
          acc[i][3] += a * w.w;
        }
      }
    }
    if (kc == nk - 1) {
      if constexpr (MMA) {
        const int mi = warp >> 2, nj = warp & 3, g = lane / 4, t4 = lane % 4;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n0 + 16 * nj + 8 * j + 2 * t4 + (e & 1);
            if (c < N) epi(16 * mi + g + 8 * (e >> 1), c, acc[j][e]);
            acc[j][e] = 0.f;
          }
      } else {
        const int cgi = tid % 16, rg = tid / 16;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = n0 + 4 * cgi + j;
            if (c < N) epi(2 * rg + i, c, acc[i][j]);
            acc[i][j] = 0.f;
          }
      }
    }
  }
  __syncthreads();  // the epilogue's writes are visible; the last buffer is consumed
}

// bytes of the conv phase's A tile (16-byte multiple): up R rows of cin + 8,
// down the windows of R output rows back to back
__host__ __device__ inline size_t conv_a_bytes(const StageParams& p, size_t tsize) {
  const size_t n = p.conv_kind == 1 ? static_cast<size_t>(R) * (p.cin + 8)
                                    : static_cast<size_t>((R - 1) * p.cs + p.ck) * p.cin;
  return (n * tsize + 15) / 16 * 16;
}

// ---- the folded transition conv's product, over the whole grid ----
template <typename T, bool MMA, bool NARROW>
__device__ void conv_phase(const StageParams& p, unsigned char* sm, int unit) {
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
  const int dtiles = (W + GNT - 1) / GNT, ntiles = (up ? 2 * s : 1) * dtiles;
  const int mtiles = (mrows + R - 1) / R;
  // A in shared memory: up x_in[m0 + r] (row stride cin + 8), down the
  // windows full[m0*s .. (m0+R-1)*s + k) back to back (row r at r*s*cin)
  const int arows = up ? R : (R - 1) * s + k, lda = up ? cin + 8 : s * cin;
  const int nin = arows * cin;
  T* As = reinterpret_cast<T*>(sm);
  T* bs = reinterpret_cast<T*>(sm + conv_a_bytes(p, sizeof(T)));
  for (int it = blockIdx.x; it < p.B * mtiles * ntiles; it += gridDim.x) {
    const int bb = it / (mtiles * ntiles), mt = (it / ntiles) % mtiles, nt = it % ntiles;
    const int m0 = mt * R, mr = min(R, mrows - m0);
    const int tap = nt / dtiles, d0 = (nt % dtiles) * GNT, n0 = tap * W + d0;
    const int f_lo = up ? m0 : m0 * s;
    // the weight chunks start loading before A is staged
    Ring<T, NARROW> ring(bs, unit, cw + static_cast<size_t>(up ? tap : 0) * cin * W + d0, W,
                         up ? cin : k * cin, min(GNT, W - d0));
    // A's frame r: x_in[m0 + r] (up), full[f_lo + r] = [context; x_in] (down);
    // null past the input (zeros)
    auto frame = [&](int r) -> const T* {
      const int f = f_lo + r;
      if (up) return f < tin ? x + (static_cast<size_t>(bb) * tin + f) * cin : nullptr;
      if (f < ctxlen) return st + (static_cast<size_t>(bb) * ctxlen + f) * cin;
      return f - ctxlen < tin ? x + (static_cast<size_t>(bb) * tin + f - ctxlen) * cin : nullptr;
    };
    constexpr int VE = 16 / sizeof(T);
    if (cin % VE == 0) {  // 16-byte vectors, LB in flight per thread
      const int vpr = cin / VE, nv = arows * vpr;
      for (int e0 = threadIdx.x; e0 < nv; e0 += LB * THREADS) {
        uint4 v[LB];
#pragma unroll
        for (int u = 0; u < LB; ++u) {
          const int e = e0 + u * THREADS;
          const T* src = e < nv ? frame(e / vpr) : nullptr;
          v[u] = src ? __ldg(reinterpret_cast<const uint4*>(src + e % vpr * VE))
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < LB; ++u) {
          const int e = e0 + u * THREADS, r = e / vpr;
          if (e < nv) *reinterpret_cast<uint4*>(As + r * (up ? lda : cin) + e % vpr * VE) = v[u];
        }
      }
    } else {  // the stem (cin = 1): one element at a time
      for (int e0 = threadIdx.x; e0 < nin; e0 += LB * THREADS) {
        T v[LB];
#pragma unroll
        for (int u = 0; u < LB; ++u) {
          const int e = e0 + u * THREADS;
          const T* src = e < nin ? frame(e / cin) : nullptr;
          v[u] = src ? src[e % cin] : vv::from_f<T>(0.f);
        }
#pragma unroll
        for (int u = 0; u < LB; ++u) {
          const int e = e0 + u * THREADS;
          if (e < nin) As[up ? e / cin * lda + e % cin : e] = v[u];
        }
      }
    }
    __syncthreads();
    float* out = p.xg + (static_cast<size_t>(bb) * mrows + m0) * ncol + n0;
    gemm<T, MMA>(ring, false, As, lda, [&](int r, int c, float v) {
      if (r < mr) out[static_cast<size_t>(r) * ncol + c] = v;
    });
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

// Shared memory of a cluster tile (byte offsets); the same in every CTA, so a
// peer's buffer is this CTA's pointer mapped to the peer's rank.
struct TileSmem {
  int rpc;  // mixer rows per CTA: R / C
  size_t vs, xs, hs, ys, sc, hn, A, a, part, bs, total;
};

__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o += (bytes + 15) / 16 * 16;
  return at;
}

__host__ __device__ inline TileSmem tile_smem(int W, int F, int C, int tsize, int lanes) {
  TileSmem L;
  L.rpc = R / C;
  size_t o = 0;
  // per lane group: norm_w, mixer_b, gamma, ffn_norm_w, ffn_gamma, ffn2_b, 7 taps
  L.vs = take(o, 13 * W * lanes * sizeof(float));
  L.xs = take(o, (L.rpc + CTX) * W * sizeof(float));  // block input rows (6 before mine)
  L.hs = take(o, (L.rpc + CTX) * W * sizeof(float));  // normed rows over [ctx; h]
  L.ys = take(o, L.rpc * W * sizeof(float));          // post-mixer residual of my rows
  L.sc = take(o, (L.rpc + CTX) * sizeof(float));
  L.hn = take(o, L.rpc * W * tsize);                   // my rows' FFN input (read by the peers)
  L.A = take(o, R * (W + 8) * tsize);                  // the tile's FFN input
  L.a = take(o, R * (F / C + 8) * tsize);              // gelu(...) of my FFN columns
  L.part = take(o, R * W * sizeof(float));             // my FFN columns' share of the output (read by the peers)
  L.bs = take(o, NSTAGE * GKC * GNTP * tsize);         // the weight ring
  L.total = o;
  return L;
}

// One block over one row tile [t0, t0 + R) of batch row bb, by the cluster.
// CTA `rank` runs the mixer of rows [t0 + rank*rpc, +rpc) (the block input of
// those rows and the 6 before them: x, the folded conv's product, or the
// previous block's output `src`), the cluster gathers the tile's FFN input
// through distributed shared memory, each CTA takes F / C FFN columns (both
// products), and CTA `rank` adds its rows' C partials in rank order through
// distributed shared memory: the block's output rows, written to `dst` (fp32)
// or, for the last block without the folded tail, to y.  The weights and
// vectors are those of the batch row's lane group (`lanes`).
// NARROW: rows that are not whole 16-byte vectors move element by element.
template <typename T, bool MMA, bool NARROW>
__device__ void block_tile(const StageParams& p, int nb, int tile, const float* src, float* dst,
                           bool to_y, bool peers_wait, unsigned char* sm, const TileSmem& L,
                           cg::cluster_group& cl, int unit) {
  constexpr int V = 16 / sizeof(T);
  const int W = p.W, Tn = p.T, NB = p.NB, C = p.C, FC = p.F / C;
  const int rank = static_cast<int>(cl.block_rank()), rpc = L.rpc;
  const int tiles = (Tn + R - 1) / R;
  const int bb = tile / tiles, t0 = (tile % tiles) * R, t1 = min(Tn, t0 + R);
  const size_t row0 = static_cast<size_t>(bb) * Tn;
  const int lane = bb % p.lanes;
  const float* vs = reinterpret_cast<float*>(sm + L.vs) + lane * 13 * W;
  float* xs = reinterpret_cast<float*>(sm + L.xs);
  float* hs = reinterpret_cast<float*>(sm + L.hs);
  float* ys = reinterpret_cast<float*>(sm + L.ys);
  float* sc = reinterpret_cast<float*>(sm + L.sc);
  T* hn = reinterpret_cast<T*>(sm + L.hn);
  T* As = reinterpret_cast<T*>(sm + L.A);
  T* as = reinterpret_cast<T*>(sm + L.a);
  float* part = reinterpret_cast<float*>(sm + L.part);
  T* bs = reinterpret_cast<T*>(sm + L.bs);
  const int r0 = t0 + rank * rpc, r1 = min(t1, r0 + rpc), mine = max(0, r1 - r0);
  // this CTA's FFN columns of the row's lane group: both products' weight
  // chunks start loading now, under the mixer
  const int f0 = rank * FC;
  const T* w1 = static_cast<const T*>(p.w1) + static_cast<size_t>(nb) * p.w1_stride +
                static_cast<size_t>(lane) * p.w1_lane + f0;
  const T* b1 = static_cast<const T*>(p.b1) + static_cast<size_t>(nb) * p.b1_stride +
                static_cast<size_t>(lane) * p.b1_lane + f0;
  const T* w2 = static_cast<const T*>(p.w2) + static_cast<size_t>(nb) * p.w2_stride +
                static_cast<size_t>(lane) * p.w2_lane + static_cast<size_t>(f0) * p.w2_ld;
  Ring<T, NARROW> ring(bs, unit, w1, p.w1_ld, W, FC, w2, p.w2_ld, FC, W);

  if (mine > 0) {  // the mixer and the second norm of my rows
    const int lo = r0 - CTX, nrow = r1 - lo, nctx = max(0, -lo);
    load_rows<T, NARROW>(p, src, nb, row0, lo, nrow, xs);
    // the carried context stands for the rows before the sequence: loaded
    // in the same round trip as the block input
    const T* c_in = static_cast<const T*>(p.ctx) + (static_cast<size_t>(bb) * NB + nb) * CTX * W;
    for (int e = threadIdx.x; e < nctx * W; e += THREADS) hs[e] = vv::to_f(c_in[(CTX - nctx) * W + e]);
    __syncthreads();
    vv::row_rsqrt(xs, nrow, W, p.eps, sc);
    __syncthreads();
    for (int e = nctx * W + threadIdx.x; e < nrow * W; e += THREADS)
      hs[e] = xs[e] * sc[e / W] * vs[e % W];
    __syncthreads();
    if (r1 == Tn) {
      T* c_out = static_cast<T*>(p.ctx_out) + (static_cast<size_t>(bb) * NB + nb) * CTX * W;
      for (int e = threadIdx.x; e < CTX * W; e += THREADS)
        c_out[e] = vv::from_f<T>(hs[(Tn - CTX - lo) * W + e]);
      if (nb == 0 && p.conv_kind == 1) {  // new transposed-conv tail: x[last] @ Wc[s+j]
        const int s = p.cs, tin = Tn / s;
        const float* yl = p.xg + (static_cast<size_t>(bb) * tin + tin - 1) * 2 * s * W;
        T* tail = static_cast<T*>(p.conv_out) + static_cast<size_t>(bb) * s * W;
        for (int e = threadIdx.x; e < s * W; e += THREADS) tail[e] = vv::from_f<T>(yl[s * W + e]);
      }
    }
    for (int e = threadIdx.x; e < mine * W; e += THREADS) {
      const int r = e / W, d = e % W;
      float m = vs[W + d];
#pragma unroll
      for (int k = 0; k < 7; ++k) m += hs[(r + k) * W + d] * vs[(6 + k) * W + d];
      ys[e] = xs[(r + CTX) * W + d] + vs[2 * W + d] * m;
    }
    __syncthreads();
    vv::row_rsqrt(ys, mine, W, p.eps, sc);
    __syncthreads();
    for (int e = threadIdx.x; e < mine * W; e += THREADS)
      hn[e] = vv::from_f<T>(ys[e] * sc[e / W] * vs[3 * W + e % W]);
  }
  cl.sync();  // every rank's FFN input rows are ready
  if constexpr (NARROW) {
    for (int e = threadIdx.x; e < R * W; e += THREADS) {
      const int i = e / W, c = e % W;
      As[i * (W + 8) + c] = t0 + i < t1 ? cl.map_shared_rank(hn, i / rpc)[(i % rpc) * W + c]
                                        : vv::from_f<T>(0.f);
    }
  } else {
    for (int e = threadIdx.x; e < R * W / V; e += THREADS) {
      const int i = e / (W / V), c = e % (W / V);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + i < t1)
        v = *reinterpret_cast<const uint4*>(cl.map_shared_rank(hn, i / rpc) + (i % rpc) * W +
                                            c * V);
      *reinterpret_cast<uint4*>(As + i * (W + 8) + c * V) = v;
    }
  }
  __syncthreads();
  // a = round(gelu(b1 + hn @ w1[:, f0:f0+FC]))
  gemm<T, MMA>(ring, false, As, W + 8, [&](int r, int c, float v) {
    as[r * (FC + 8) + c] = vv::from_f<T>(gelu(v + vv::to_f(b1[c])));
  });
  // part = a @ w2[f0:f0+FC, :]
  gemm<T, MMA>(ring, true, as, FC + 8, [&](int r, int c, float v) { part[r * W + c] = v; });
  cl.sync();  // every rank's partial is ready
  if (mine > 0) {
    // U consecutive channels a thread: 4 as one float4, or (NARROW) 1
    constexpr int U = NARROW ? 1 : 4;
    const float* peer[MAX_C];
#pragma unroll
    for (int q = 0; q < MAX_C; ++q) peer[q] = q < C ? cl.map_shared_rank(part, q) : part;
    for (int e = threadIdx.x; e < mine * W / U; e += THREADS) {
      const int r = e / (W / U), d = U * (e % (W / U)), i = rank * rpc + r;
      float v[MAX_C][U];
#pragma unroll
      for (int q = 0; q < MAX_C; ++q) {
        if constexpr (NARROW) {
          v[q][0] = q < C ? peer[q][i * W + d] : 0.f;
        } else {
          const float4 t = q < C ? *reinterpret_cast<const float4*>(peer[q] + i * W + d)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          v[q][0] = t.x, v[q][1] = t.y, v[q][2] = t.z, v[q][3] = t.w;
        }
      }
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_C; ++q)  // rank order: the same sums on every run
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] += v[q][u];
      const size_t o = (row0 + r0 + r) * W + d;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float x = ys[r * W + d + u] + vs[4 * W + d + u] * (s[u] + vs[5 * W + d + u]);
        if (to_y)
          static_cast<T*>(p.y)[o + u] = vv::from_f<T>(x);
        else
          dst[o + u] = x;
      }
    }
  }
  // the peers have read this CTA's partial and FFN input rows before the
  // next tile overwrites them or the CTA exits (a grid barrier next does it)
  if (peers_wait) cl.sync();
}

// vs[lane][13][W] = the block's vectors (rows 0-5 of vecs) and taps (rows 0-6
// of mixw) of every lane group, fp32: 16-byte loads (NARROW: one element
// each), one round trip for most shapes
template <typename T, bool NARROW>
__device__ void load_vecs(const StageParams& p, int nb, float* vs) {
  constexpr int V = NARROW ? 1 : 16 / sizeof(T);  // elements a load
  const int W = p.W, wv = W / V, n = 13 * p.lanes * wv;
  const T* vec = static_cast<const T*>(p.vecs) + static_cast<size_t>(nb) * 8 * p.vec_ld;
  const T* taps = static_cast<const T*>(p.mixw) + static_cast<size_t>(nb) * 8 * p.vec_ld;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int row = e / wv, c = e % wv * V, lane = row / 13, k = row % 13;
    const T* src = (k < 6 ? vec + k * p.vec_ld : taps + (k - 6) * p.vec_ld) + lane * p.vec_lane + c;
    float* dst = vs + row * W + c;
    if constexpr (NARROW) {
      *dst = vv::to_f(*src);
    } else {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = vv::to_f(t[j]);
    }
  }
}

// A multiple of the byte alignment that every row, row stride, block and
// lane offset and column slice of the weights shares (the pack's tensors are
// 16-byte aligned): 16-byte copies where it is a multiple of 16, else
// (NARROW) copies of the largest of 8, 4 and 2 bytes that divides it
__host__ __device__ inline int weight_bytes(const StageParams& p, int es) {
  return (p.W | p.F / p.C | p.w1_ld | p.w2_ld | p.w1_stride | p.w2_stride | p.w1_lane |
          p.w2_lane) * es;
}

template <typename T, bool MMA, bool NARROW>
__global__ void __launch_bounds__(THREADS) cluster_kernel(StageParams p) {
  extern __shared__ __align__(16) unsigned char smc[];
  cg::cluster_group cl = cg::this_cluster();
  const TileSmem L = tile_smem(p.W, p.F, p.C, sizeof(T), p.lanes);
  const int bytes = weight_bytes(p, sizeof(T));
  const int unit = NARROW ? (bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2) : 16;
  if (p.conv_kind) {
    conv_phase<T, MMA, NARROW>(p, smc, unit);
    grid_barrier(p.bar);
  }
  const int ncl = gridDim.x / p.C, cid = blockIdx.x / p.C;
  const int tiles = p.B * ((p.T + R - 1) / R);
  float* vs = reinterpret_cast<float*>(smc + L.vs);
  for (int nb = 0; nb < p.NB; ++nb) {
    load_vecs<T, NARROW>(p, nb, vs);
    __syncthreads();
    // block outputs alternate between xb and yg: a tile's mixer reads the 6
    // rows before it from the previous block's output while other clusters
    // already write this block's
    const float* src = nb % 2 ? p.xb : p.yg;
    float* dst = nb % 2 ? p.yg : p.xb;
    const bool last = nb + 1 == p.NB;
    for (int tile = cid; tile < tiles; tile += ncl)
      block_tile<T, MMA, NARROW>(p, nb, tile, src, dst, last && !p.hk,
                                 tile + ncl < tiles || (last && !p.hk), smc, L, cl, unit);
    if (!last || p.hk) grid_barrier(p.bar);
  }
  if (p.hk) phase_out<T, NARROW>(p, p.NB % 2 ? p.xb : p.yg, reinterpret_cast<float*>(smc));
}

template <typename T>
size_t cluster_smem_bytes(const StageParams& p) {
  size_t b = tile_smem(p.W, p.F, p.C, sizeof(T), p.lanes).total;
  if (p.conv_kind) b = std::max(b, conv_a_bytes(p, sizeof(T)) + NSTAGE * GKC * GNTP * sizeof(T));
  if (p.hk) b = std::max(b, (RT + p.hk - 1) * (p.W + 1) * sizeof(float));
  return b;
}

// The stage kernel: clusters of C CTAs, as many clusters as there are row
// tiles (or conv items over C), at most as many as the card holds at once
// (every CTA must be resident for the grid barriers); the occupancy is asked
// once per device, shared-memory size and cluster size.
template <typename T, bool MMA, bool NARROW>
int launch_cluster(StageParams p, cudaStream_t stream) {
  void (*kern)(StageParams) = cluster_kernel<T, MMA, NARROW>;
  const size_t smem = cluster_smem_bytes<T>(p);
  if (smem > 227 * 1024) return -5;
  static std::map<std::tuple<int, size_t, int>, int> clusters;  // -> clusters on the card
  static size_t opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto it = clusters.find({dev, smem, p.C});
  if (it == clusters.end()) {
    if (smem > opted) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted = smem;
    }
    int n = 0;
    cfg.gridDim = dim3(p.C);
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return -11;  // one cluster does not fit the card
    it = clusters.emplace(std::make_tuple(dev, smem, p.C), n).first;
  }
  // as many clusters as row tiles, or more where the folded conv has more
  // work items than those clusters have CTAs
  int want = p.B * ((p.T + R - 1) / R);
  if (p.conv_kind) {
    const bool up = p.conv_kind == 1;
    const int mrows = up ? p.T / p.cs : p.T;
    const int items = p.B * ((mrows + R - 1) / R) * (up ? 2 * p.cs : 1) * ((p.W + GNT - 1) / GNT);
    want = std::max(want, (items + p.C - 1) / p.C);
  }
  cfg.gridDim = dim3(std::min(want, it->second) * p.C);
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  // a row-lane pack (lanes > 1) folds nothing; C FFN column slices of a tile
  if (p.lanes < 1 || (p.lanes > 1 && (p.conv_kind || p.hk))) return -3;
  if (p.C < 1 || p.C > MAX_C || R % p.C || p.F % p.C || p.bar == nullptr) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int es = p.dtype == 0 ? 4 : 2;
  // rows, FFN slices, strides and lane offsets of whole 16-byte vectors, or
  // the narrow copies
  const bool wide = weight_bytes(p, es) % 16 == 0;
  if (p.dtype == 0)
    return wide ? launch_cluster<float, false, false>(p, st) : launch_cluster<float, false, true>(p, st);
  if (p.dtype != 1) return -6;  // unsupported dtype
  if (!wide) return launch_cluster<__nv_bfloat16, false, true>(p, st);
  // tensor cores where every depth is whole k16 steps with 16-byte aligned A
  // rows (every bf16 stage of the 1.5B stacks but the stem conv, cin = 1)
  bool mma = p.W % 16 == 0 && (p.F / p.C) % 16 == 0;
  if (p.conv_kind == 1) mma = mma && p.cin % 16 == 0;
  if (p.conv_kind == 2) mma = mma && (p.ck * p.cin) % 16 == 0 && (p.cs * p.cin) % 8 == 0;
  return mma ? launch_cluster<__nv_bfloat16, true, false>(p, st)
             : launch_cluster<__nv_bfloat16, false, false>(p, st);
}
