// Fused bf16 diffusion-head solver step, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the bf16 head to XLA
// (`vibevoice_tpu/models/diffusion_head.py:apply_with_modulations`), and the
// port ran it as ~85 cuBLAS and elementwise nodes a solver step.  One launch
// runs one denoising step of the bf16 head for N rows (the CFG-doubled
// batch, 2B) over its L adaLN layers:
//   h = (rmsnorm(x) * norm_w) * (1 + scale) + shift      (mods[l] = shift|scale|gate)
//   a = silu(h @ gate) * (h @ up)
//   x = x + gate_mod * (a @ down)
// then v = (rmsnorm(x) * (1 + fscale) + fshift) @ final_linear.  x stays fp32
// across the layers; h and a are rounded to bf16 once, where they enter the
// tensor cores; every weight stays bf16 (the plain path rounds after every
// op, so this is the same work with fewer roundings).
//
// Bound: at N <= 16 each weight element feeds 2N flops against 2 bytes, 16
// ops a byte against the card's ~295, so the least time is the bytes: every
// solver step re-reads 3 * L * H * F * 2 bytes (170 MB for the 1.5B head,
// 925 MB for Large: both far above the 50 MB L2) over 3.35 TB/s, 51 / 276 us.
// The design keeps HBM streaming.
//
// One launch of clusters of C = 8 CTAs (`cudaLaunchKernelEx` with the
// cluster attribute; one CTA per SM, at most as many clusters as the card
// holds at once, since the grid barrier needs every CTA resident).  CTA k
// owns the TF columns [k*TF, (k+1)*TF) of gate's and up's maps (TF a
// multiple of 8; F + 8 columns in all, below), cluster c thus [c*8TF,
// (c+1)*8TF), and rank q of a cluster the H/8 columns [q*H/8, (q+1)*H/8) of
// x, which stay fp32 in its registers across the layers.  Weights stream
// through ONE ring of shared memory stages in the order they are used, by
// TMA under an L2 evict-first policy: gate and up in boxes [ku rows][TF
// columns] of each layer's two 2-D tensor maps, then the cluster's rows of
// down in boxes [kd rows][wb columns] that cover the rank's H/8 columns + 8,
// and after the last layer the rank's rows of final_linear.  A weight may
// start inside a 16-byte unit (a view into a larger buffer, as the
// benchmark's weights are): its map starts on the unit, sh elements before
// it (a TMA box must start on a 16-byte unit of its row too).  Tiled in the
// maps' columns, gate's and up's B fragments load by ldmatrix (map column v
// is F column v - sh, so a layer's gate and up must share sh; down's rows
// come sh rows earlier to match, and columns outside F give a = 0).  Down's
// B fragments load by ldmatrix where down starts on a unit; elsewhere its
// columns land sh elements into its boxes and are read two bytes at a time
// (`lds_pair`).  Nothing is copied or repacked.  A producer warp (warp 8)
// issues every copy and refills a stage with the next chunk (of this layer
// or the next) as soon as the eight consumer warps are done with it (the
// stage's empty mbarrier); the consumers sync only among themselves (a named
// CTA barrier, a cluster barrier on mbarriers, the grid barrier), so the
// producer keeps HBM busy across every barrier.  The tensor maps are over
// the original tensors (cached per tensor; no copy of the weights).
// Per layer:
//   1. norm: rank q's sums of squares of its columns go to every CTA of the
//      cluster (cluster barrier); h of its columns, in bf16, goes to every
//      CTA's shared memory (cluster barrier): each CTA holds h [rows, H];
//   2. up-projection on mma.sync m16n8k16 (bf16 in, fp32 sums; the 16 rows
//      fill m16; warp w takes gate tile j and up tile j for j = w, w + 8, ...;
//      A and B by ldmatrix); a = silu(g) * u in registers,
//      rounded to bf16, goes to every CTA of the cluster (cluster barrier):
//      each CTA holds the cluster's activations [rows, 8TF];
//   3. down-projection, split over the cluster by H: rank q computes the
//      cluster's share of its H/8 columns over the cluster's 8TF rows of down
//      on mma.sync (so no [rows, H] share is ever added in shared memory,
//      which at Large would not fit) and writes it as the cluster's fp32
//      partial (buffer l % 2 of the cached workspace);
//   4. the grid barrier, the layer's only one;
//   5. rank q of every cluster adds the clusters' partials of its columns in
//      cluster order: x += gate * sum, so every CTA holds the same bits (no
//      float atomics; two calls give equal bits).
// After the last layer cluster c finishes the rows r with r % ncl == c: the
// final norm and the [H, latent] product split over the ranks' columns
// (rs * ((x * (1 + fscale)) @ fl) + fshift @ fl), added in rank order in rank
// 0 after one cluster barrier.  Rows beyond a row group (8 or 16 rows) run as
// further row groups inside the launch.  `ops/fused_head_bf16.head_plan`
// sizes the launch and the ring.
//
// Plain C interface, loaded with ctypes.  Returns 0, a negative code for
// arguments or a card it does not take, or the CUDA error of the launch.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>

#include <map>
#include <set>
#include <tuple>

#include "hopper_common.cuh"
#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using vv::fence_async;
using vv::grid_barrier;
using vv::mbar_expect;
using vv::mbar_init;
using vv::smem_u32;
using vv::tma_box;
using vv::warp_sum;

// 288 threads leave a thread 168 registers (some spill); seven consumer warps
// in 256 threads, with 255 and no spill, measured slower on the H100
constexpr int NC = 256;         // consumer threads of a CTA (warps 0-7)
constexpr int NW = NC / 32;     // consumer warps; warp NW is the producer
constexpr int NT = NC + 32;     // threads of a CTA
constexpr int C = 8;            // CTAs per cluster: the portable size
constexpr int MAX_L = 8;        // layers, at most (three tensor maps each)
constexpr int MAX_HQ = 512;     // columns of x a rank owns, at most (H <= 4096)
constexpr int GPL = MAX_HQ / 4 / 32;  // 4-column groups of a row a lane owns, at most
constexpr int MAX_TP = 256 / 8 / NW;  // gate/up tile pairs a warp takes, at most (TF <= 256)
constexpr int MAX_B16 = MAX_HQ / 16 / NW;  // 16-column blocks of down a warp takes, at most
constexpr int KB = 2;           // clusters' partials a thread has in flight per group

struct Args {
  const bf16* x;     // [N, H] (after noisy_proj)
  const bf16* mods;  // [L, N, 3H]
  const bf16* fmod;  // [N, 2H]
  const bf16* norm_w[MAX_L];  // [H] each
  // each weight's offset from the 16-byte unit it starts in, in elements:
  // gate, up, down of each layer, then final_linear (see `Maps`)
  int sh[3 * MAX_L + 1];
  bf16* out;         // [N, lat]
  float* part;       // [2][ncl][rg][H]: the clusters' partials, by layer parity
  unsigned int* bar; // the grid barrier's counter
  int N, H, F, L, lat, rg, tf, ncl, ku, kd, wb, nbd, stages, stage_bytes, nrc;
  float eps;
};

// gate, up and down of each layer ([H rows][F cols], [H][F], [F][H]), then
// final_linear [H][lat].  A weight may start anywhere (a view into a larger
// buffer): its map starts at the 16-byte unit that holds its first element,
// `sh` elements before it (inside the weight's allocation, which starts on
// a unit), with the weight's own row stride and cols + sh columns, so that a
// box that starts on a 16-byte unit of a row covers the columns it needs (a
// row's first sh columns are the previous row's last elements) and the map
// ends where the weight does; the columns land in shared memory sh elements
// in, and columns past the weight read as zeros.
struct Maps {
  CUtensorMap m[3 * MAX_L + 1];
};

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline size_t up128(size_t v) { return (v + 127) & ~static_cast<size_t>(127); }
__host__ __device__ inline size_t smax(size_t a, size_t b) { return a > b ? a : b; }

// A gate/up chunk is two boxes [ku][tf] (the second 128-aligned), in the
// maps' columns; a down chunk nbd boxes [kd][wb], wb = the rank's H/8 + 8
// columns split into boxes of at most 256 (the rank's columns start sh < 8
// columns into the first; wb / 8 odd, so the eight rows an ldmatrix reads
// fall in distinct banks); a final_linear chunk one box [fr][lat + 8].
__host__ __device__ inline size_t gu_half(int ku, int tf) {
  return up128(static_cast<size_t>(ku) * tf * 2);
}
__host__ __device__ inline size_t wd_box(int kd, int wb) { return up128(static_cast<size_t>(kd) * wb * 2); }
// Rows of final_linear a chunk holds (a multiple of 8 that fits a stage, at
// most the rank's H/8).
__host__ __device__ inline int fl_rows(int H, int lat, int stage_bytes) {
  const int r = stage_bytes / (2 * (lat + 8)) / 8 * 8;
  return r < H / C ? r : H / C;
}

// Byte offsets of the kernel's shared memory (`ops/fused_head_bf16.py:
// head_smem` mirrors the total): the ring, h [rg][H+8] bf16 (or the final
// layer's u, shift and warp sums), the activations [rg][8TF+8] bf16 (or rank
// 0's final sums), the norms' exchange [C][rg], the mbarriers (each stage's
// full and empty, the consumers' cluster barrier), and 1024 bytes to align the
// base (the tensor maps' boxes land on 128-byte units).
struct Layout {
  size_t hb, ab, xch, mb, total;
};

__host__ __device__ inline Layout layout(int H, int tf, int rg, int lat, int nrc, int stages,
                                         int stage_bytes) {
  Layout L;
  const size_t hq = H / C, cf = static_cast<size_t>(C) * tf;
  const size_t hb = smax(static_cast<size_t>(rg) * (H + 8) * 2,
                         4 * nrc * (2 * hq + static_cast<size_t>(NW) * 2 * lat));
  const size_t ab = smax(static_cast<size_t>(rg) * (cf + 8) * 2,
                         4 * static_cast<size_t>(C) * nrc * (2 * lat + 1));
  size_t o = static_cast<size_t>(stages) * stage_bytes;
  L.hb = o;   o += up16(hb);
  L.ab = o;   o += up16(ab);
  L.xch = o;  o += up16(4 * static_cast<size_t>(C) * rg);
  L.mb = o;   o += 8 * (2 * static_cast<size_t>(stages) + 1);
  L.total = o + 1024;
  return L;
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// The bf16 at shared addresses p and p + step as one bf16x2 (p's low): a B
// fragment register from a weight box whose columns do not sit on 16-byte
// units (ldmatrix needs them there).
__device__ __forceinline__ uint32_t lds_pair(uint32_t p, uint32_t step) {
  uint16_t lo, hi;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(lo) : "r"(p));
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(hi) : "r"(p + step));
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}
// 4 bf16 at any 2-byte aligned address as fp32
__device__ __forceinline__ float4 load4u(const bf16* p) {
  return make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]), __bfloat162float(p[2]),
                     __bfloat162float(p[3]));
}

// c += a b for one 16x8 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c fp32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 4 neighbouring bf16 (8-byte aligned) as fp32
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// The barrier of the CTA's consumer threads (the producer warp keeps
// streaming).
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory"); }

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for phase `parity` of an mbarrier (with acquire at cluster scope
// where `cluster`); a wait not done within seconds traps rather than hanging
// the card.
template <bool cluster = false>
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spins = 0;; ++spins) {
    if (cluster)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; "
          "selp.u32 %0, 1, 0, p; }\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
          "selp.u32 %0, 1, 0, p; }\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1LL << 24)) __trap();
  }
}

// Rows r < nr of a group with r % ncl == cid: the rows cluster cid finishes.
__device__ __forceinline__ int r_count(int nr, int ncl, int cid) {
  return cid < nr ? (nr - cid + ncl - 1) / ncl : 0;
}

// What a CTA needs of the launch, worked out once.
struct Ctx {
  int rank, cid, warp, lane, hq, c0, cf, f0, nku, nkd, nfl, rpw;
  unsigned char* rp;  // the ring
  uint32_t ring;   // its shared address
  uint32_t full;   // of stage 0's full mbarrier (stage s: + 8 s)
  uint32_t empty;  // of stage 0's empty mbarrier
  uint32_t cbar;   // of the consumers' cluster barrier
  uint32_t cpar;   // its phase parity
};

// The barrier of every consumer thread of the cluster: each CTA's consumers
// meet (CTA barrier), then thread p arrives (release, cluster scope) on rank
// p's barrier, which completes once all C CTAs have arrived; every consumer
// waits for it (acquire, cluster scope).  The producer warps are not held.
__device__ __forceinline__ void cluster_csync(Ctx& x) {
  csync();
  if (threadIdx.x < C) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(x.cbar), "r"(threadIdx.x));
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
                 : "memory");
  }
  mbar_wait_bounded<true>(x.cbar, x.cpar);
  x.cpar ^= 1;
}

// The kinds of chunk in the CTA's stream: gate/up rows, the cluster's rows of
// down, rows of final_linear.  A step (row group, layer) takes nku gate/up
// chunks (none without F columns) and then nkd chunks of down; after its
// last layer a group whose rows this cluster finishes takes nfl chunks of
// final_linear (the rank's H/8 rows).
enum Kind { GU, WD, FL };

// Chunk j of `kind` (of layer l) into ring stage c % stages, completing on
// its full mbarrier; called by the producer's lane 0.
__device__ void issue(const Maps& maps, const Args& a, const Ctx& x, int c, Kind kind, int l,
                      int j, unsigned char* ring) {
  const int stage = c % a.stages;
  unsigned char* dst = ring + static_cast<size_t>(stage) * a.stage_bytes;
  const uint32_t bar = x.full + 8 * stage;
  const uint64_t pol = vv::evict_first_policy();  // weights: read once per call
  fence_async();
  if (kind == GU) {
    mbar_expect(bar, static_cast<uint32_t>(2 * a.ku * a.tf * 2));
    tma_box(dst, &maps.m[3 * l], x.f0, j * a.ku, bar, pol);
    tma_box(dst + gu_half(a.ku, a.tf), &maps.m[3 * l + 1], x.f0, j * a.ku, bar, pol);
  } else if (kind == WD) {
    // down's row f holds F column f of gate/up, map column f + sh (`up_proj`)
    const int y = x.cid * x.cf + j * a.kd - a.sh[3 * l];
    mbar_expect(bar, static_cast<uint32_t>(a.nbd * a.kd * a.wb * 2));
    for (int b = 0; b < a.nbd; ++b)
      tma_box(dst + b * wd_box(a.kd, a.wb), &maps.m[3 * l + 2], x.c0 + b * a.wb, y, bar, pol);
  } else {
    const int fr = fl_rows(a.H, a.lat, a.stage_bytes);
    mbar_expect(bar, static_cast<uint32_t>(fr * (a.lat + 8) * 2));
    tma_box(dst, &maps.m[3 * MAX_L], 0, x.c0 + j * fr, bar);  // read by every cluster
  }
}

// The producer warp: the chunks in the order the consumers take them, each
// once the consumers are done with the chunk `stages` before it, which held
// its stage.
__device__ void produce(const Maps& maps, const Args& a, const Ctx& x, unsigned char* ring) {
  int c = 0;
  auto put = [&](Kind kind, int l, int j) {
    const int stage = c % a.stages;
    if (c >= a.stages) mbar_wait_bounded(x.empty + 8 * stage, (c / a.stages - 1) & 1);
    if (x.lane == 0) issue(maps, a, x, c, kind, l, j, ring);
    __syncwarp();
    ++c;
  };
  for (int n0 = 0; n0 < a.N; n0 += a.rg) {
    for (int l = 0; l < a.L; ++l) {
      for (int j = 0; j < x.nku; ++j) put(GU, l, j);
      for (int j = 0; j < x.nkd; ++j) put(WD, l, j);
    }
    if (x.cid < min(a.rg, a.N - n0))
      for (int j = 0; j < x.nfl; ++j) put(FL, 0, j);
  }
}

// A consumer warp waits for chunk c; once done with its stage, lane 0 tells
// the producer (the stage's empty barrier counts the NW warps).
__device__ __forceinline__ uint32_t wait_chunk(const Args& a, const Ctx& x, int c) {
  const int stage = c % a.stages;
  mbar_wait_bounded(x.full + 8 * stage, (c / a.stages) & 1);
  return x.ring + stage * a.stage_bytes;
}
__device__ __forceinline__ void done_chunk(const Args& a, const Ctx& x, int c) {
  __syncwarp();
  if (x.lane == 0) mbar_arrive(x.empty + 8 * (c % a.stages));
}

// The lanes' x: row r = warp * rpw + rr (rr < rpw), columns c0 + 4 * (lane
// + 32 * g) (g < GPL, inside the rank's hq).
#define FOR_OWNED(...)                                               \
  _Pragma("unroll") for (int rr = 0; rr < 2; ++rr) {                 \
    const int r = x.warp * x.rpw + rr;                               \
    _Pragma("unroll") for (int g = 0; g < GPL; ++g) {                \
      const int col = 4 * (x.lane + 32 * g);                         \
      if (rr < x.rpw && r < nr && col < x.hq) { __VA_ARGS__ }        \
    }                                                                \
  }

// 1. h = (rmsnorm(x) * norm_w) * (1 + scale) + shift of the rank's columns,
// in bf16, into hb [rg][H+8] of every CTA of the cluster; after the second
// cluster barrier each CTA holds all of h.
__device__ void norm_h(const Args& a, Ctx& x, cg::cluster_group& cl, int l, int nr,
                       const bf16* mods, const float4 (&xr)[2][GPL], float* xch, bf16* hb) {
  const int H = a.H;
  float ss[2] = {0.f, 0.f};
  FOR_OWNED({
    const float4 v = xr[rr][g];
    ss[rr] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  })
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = x.warp * x.rpw + rr;
    const float t = warp_sum(ss[rr]);
    if (x.lane == 0 && rr < x.rpw && r < nr)
      for (int p = 0; p < C; ++p) cl.map_shared_rank(xch, p)[x.rank * a.rg + r] = t;
  }
  cluster_csync(x);
  const bf16* nw = a.norm_w[l] + x.c0;
  FOR_OWNED({
    float t = 0.f;
    for (int p = 0; p < C; ++p) t += xch[p * a.rg + r];  // rank order: the same bits everywhere
    const float rs = 1.f / sqrtf(t / H + a.eps);
    const float4 v = xr[rr][g], w = load4u(nw + col);
    const float4 sh = load4(mods + static_cast<size_t>(r) * 3 * H + x.c0 + col);
    const float4 sc = load4(mods + static_cast<size_t>(r) * 3 * H + H + x.c0 + col);
    uint2 hv;
    hv.x = pack2((v.x * rs * w.x) * (1.f + sc.x) + sh.x, (v.y * rs * w.y) * (1.f + sc.y) + sh.y);
    hv.y = pack2((v.z * rs * w.z) * (1.f + sc.z) + sh.z, (v.w * rs * w.w) * (1.f + sc.w) + sh.w);
#pragma unroll 1
    for (int p = 0; p < C; ++p)
      *reinterpret_cast<uint2*>(cl.map_shared_rank(hb, p) + static_cast<size_t>(r) * (H + 8) +
                                x.c0 + col) = hv;
  })
  cluster_csync(x);  // h is whole in every CTA of the cluster
}

// 2. The up-projection of the CTA's F columns: gate tile j and up tile j
// (8 columns each) in warp j % 8, K over the layer's chunks; a = silu(g) * u,
// in bf16, into ab [rg][8TF+8] of every CTA of the cluster at the rank's
// columns.
__device__ void up_proj(const Args& a, const Ctx& x, cg::cluster_group& cl, int& c, int l,
                        const bf16* hb, bf16* ab) {
  const int tp = a.tf / 8, lane = x.lane;
  float g[MAX_TP][4], u[MAX_TP][4];
#pragma unroll
  for (int p = 0; p < MAX_TP; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[p][e] = u[p][e] = 0.f;
  // A (h, 16 rows; rows past rg alias): matrix lane / 8 of x4 is rows
  // (0-7 | 8-15) x k (0-7 | 8-15)
  const int arow = ((lane & 7) + ((lane >> 3) & 1) * 8) & (a.rg - 1);
  const uint32_t a_base = smem_u32(hb) + arow * (a.H + 8) * 2 + (lane >> 4) * 16;
  // B (x4.trans): matrices gate k0-7, gate k8-15, up k0-7, up k8-15 of a
  // tile.  The CTA's columns are the maps' (which start on a 16-byte unit, so
  // ldmatrix reads them): map column v is F column v - sh, the columns
  // outside [sh, F + sh) give a = 0
  const int m = lane >> 3;
  const uint32_t b_off = static_cast<uint32_t>(((m & 1) * 8 + (lane & 7)) * a.tf * 2 +
                                               (m >> 1) * gu_half(a.ku, a.tf));
  for (int kc = 0; kc < x.nku; ++kc, ++c) {
    const uint32_t st = wait_chunk(a, x, c) + b_off;
    for (int ks = 0; ks < a.ku; ks += 16) {
      uint32_t af[4];
      ldsm4(af, a_base + (kc * a.ku + ks) * 2);
#pragma unroll
      for (int p = 0; p < MAX_TP; ++p) {
        const int j = x.warp + NW * p;
        if (j < tp) {
          uint32_t bf[4];
          ldsm4t(bf, st + ks * a.tf * 2 + j * 16);
          mma(g[p], af, bf[0], bf[1]);
          mma(u[p], af, bf[2], bf[3]);
        }
      }
    }
    done_chunk(a, x, c);
  }
  const int row0 = lane >> 2, cfp = x.cf + 8, sh = a.sh[3 * l];
#pragma unroll
  for (int p = 0; p < MAX_TP; ++p) {
    const int j = x.warp + NW * p;
    if (j < tp) {
      const int col = x.rank * a.tf + 8 * j + 2 * (lane & 3), v = x.f0 + 8 * j + 2 * (lane & 3);
      const bool in0 = v >= sh && v < a.F + sh, in1 = v + 1 >= sh && v + 1 < a.F + sh;
      const uint32_t v0 = pack2(in0 ? silu(g[p][0]) * u[p][0] : 0.f,
                                in1 ? silu(g[p][1]) * u[p][1] : 0.f);
      const uint32_t v1 = pack2(in0 ? silu(g[p][2]) * u[p][2] : 0.f,
                                in1 ? silu(g[p][3]) * u[p][3] : 0.f);
#pragma unroll 1
      for (int q = 0; q < C; ++q) {
        bf16* peer = cl.map_shared_rank(ab, q);
        if (row0 < a.rg) *reinterpret_cast<uint32_t*>(peer + row0 * cfp + col) = v0;
        if (row0 + 8 < a.rg) *reinterpret_cast<uint32_t*>(peer + (row0 + 8) * cfp + col) = v1;
      }
    }
  }
}

// 3. The down-projection of the rank's H/8 columns over the cluster's rows
// (the activations in ab): 16-column blocks b = w, w + 8, ... of warp w, K
// over the chunks; written as the cluster's fp32 partial of those columns.
// LDSM: down starts on a 16-byte unit (sh = 0), so its B fragments load by
// ldmatrix.
template <bool LDSM>
__device__ void down_proj(const Args& a, const Ctx& x, int& c, int l, const bf16* ab, int nr,
                          float* part) {
  const int lane = x.lane, nb16 = x.hq / 16;
  float acc[MAX_B16][2][4];
#pragma unroll
  for (int p = 0; p < MAX_B16; ++p)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][t][e] = 0.f;
  const int arow = ((lane & 7) + ((lane >> 3) & 1) * 8) & (a.rg - 1);
  const uint32_t a_base = smem_u32(ab) + arow * (x.cf + 8) * 2 + (lane >> 4) * 16;
  // B: lane (g, t) takes column 16b + 8 tile + g, rows 2t, 2t + 1 and 2t + 8,
  // 2t + 9 of a k16 step: column m = that + sh of the rank's H/8 + 8 lies in
  // box m / wb at m % wb; a box row is wb columns.  With LDSM, x4.trans
  // matrices k0-7 and k8-15 of the block's columns 0-7, then of its columns
  // 8-15, lane i giving row i % 8 of matrix i / 8 (8-column groups never
  // straddle two boxes)
  const uint32_t ws = a.wb * 2, row = 2 * (lane & 3) * ws;
  uint32_t boff[MAX_B16][2];
#pragma unroll
  for (int p = 0; p < MAX_B16; ++p)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int mt = lane >> 3;
      const int m = LDSM ? 16 * (x.warp + NW * p) + 8 * (mt >> 1)
                         : 16 * (x.warp + NW * p) + 8 * t + (lane >> 2) + a.sh[3 * l + 2];
      boff[p][t] = static_cast<uint32_t>((m / a.wb) * wd_box(a.kd, a.wb) + (m % a.wb) * 2) +
                   (LDSM ? ((mt & 1) * 8 + (lane & 7)) * ws : row);
    }
  for (int kc = 0; kc < x.nkd; ++kc, ++c) {
    const uint32_t st = wait_chunk(a, x, c);
    for (int ks = 0; ks < a.kd; ks += 16) {
      uint32_t af[4];
      ldsm4(af, a_base + (kc * a.kd + ks) * 2);
#pragma unroll
      for (int p = 0; p < MAX_B16; ++p) {
        const int b = x.warp + NW * p;
        if (b < nb16) {
          if (LDSM) {
            uint32_t bf[4];
            ldsm4t(bf, st + ks * ws + boff[p][0]);
            mma(acc[p][0], af, bf[0], bf[1]);
            mma(acc[p][1], af, bf[2], bf[3]);
          } else {
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const uint32_t q = st + ks * ws + boff[p][t];
              mma(acc[p][t], af, lds_pair(q, ws), lds_pair(q + 8 * ws, ws));
            }
          }
        }
      }
    }
    done_chunk(a, x, c);
  }
  const int row0 = lane >> 2;
#pragma unroll
  for (int p = 0; p < MAX_B16; ++p) {
    const int b = x.warp + NW * p;
    if (b < nb16)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = x.c0 + 16 * b + 8 * t + 2 * (lane & 3);
        if (row0 < nr)
          __stcg(reinterpret_cast<float2*>(part + static_cast<size_t>(row0) * a.H + col),
                 make_float2(acc[p][t][0], acc[p][t][1]));
        if (row0 + 8 < nr)
          __stcg(reinterpret_cast<float2*>(part + static_cast<size_t>(row0 + 8) * a.H + col),
                 make_float2(acc[p][t][2], acc[p][t][3]));
      }
  }
}

// 5. x += gate * (the clusters' partials of the rank's columns, added in
// cluster order), for the owned rows.
__device__ void next_x(const Args& a, const Ctx& x, int nr, const bf16* mods, const float* part,
                       float4 (&xr)[2][GPL]) {
  const int H = a.H;
  const size_t slab = static_cast<size_t>(a.rg) * H;
  float4 s[2][GPL];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int g = 0; g < GPL; ++g) s[rr][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < a.ncl; k0 += KB) {
    float4 v[KB][2][GPL];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      FOR_OWNED({
        if (k0 + kk < a.ncl)
          v[kk][rr][g] = __ldcg(reinterpret_cast<const float4*>(
              part + (k0 + kk) * slab + static_cast<size_t>(r) * H + x.c0 + col));
      })
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      FOR_OWNED({
        if (k0 + kk < a.ncl) {
          float4& t = s[rr][g];
          const float4 w = v[kk][rr][g];
          t.x += w.x, t.y += w.y, t.z += w.z, t.w += w.w;
        }
      })
    }
  }
  FOR_OWNED({
    const float4 gt = load4(mods + static_cast<size_t>(r) * 3 * H + 2 * H + x.c0 + col);
    float4& v = xr[rr][g];
    const float4 t = s[rr][g];
    v.x += gt.x * t.x, v.y += gt.y * t.y, v.z += gt.z * t.z, v.w += gt.w * t.w;
  })
}

// The final layer of the group's rows r with r % ncl == cid (the i-th of
// them, i = r / ncl), after the last layer's sums.  Since
//   xn @ fl = rs * ((x * (1 + fscale)) @ fl) + fshift @ fl
// for the row scale rs = 1 / sqrt(mean(x^2) + eps), each rank sends rank 0
// its columns' sums of squares and both products over its columns: u = x *
// (1 + fscale) and fshift in `uh`, the rank's rows of fl in the ring's final
// chunks (the producer queued them behind the last layer's weights); warp w
// takes the rows d = w, w + 8, ... of a chunk, lane l the columns 2l, 2l + 1
// of each 64-column group, its sums carried in `red` [NW][nrc][2][lat]
// across the chunks and added in warp order.  Rank 0 adds the ranks' sums in
// rank order and writes the outputs.  `fo` (rank 0's ab) holds [C][nrc][2 lat]
// products and [C][nrc] sums of squares.
__device__ void final_layer(const Args& a, Ctx& x, cg::cluster_group& cl, int n0, int nr,
                            const float4 (&xr)[2][GPL], int& c, float* uh, float* fo) {
  const int H = a.H, lat = a.lat, hq = x.hq, nrc = a.nrc, rows = r_count(nr, a.ncl, x.cid);
  float* red = uh + 2 * nrc * hq;
  auto mine = [&](int r) { return r % a.ncl == x.cid; };
  const bf16* fm = a.fmod + static_cast<size_t>(n0) * 2 * H + x.c0;
  float* peer = cl.map_shared_rank(fo, 0);
  float ss[2] = {0.f, 0.f};
  FOR_OWNED({
    if (mine(r)) {
      const int i = r / a.ncl;
      const float4 v = xr[rr][g];
      ss[rr] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      const float4 sh = load4(fm + static_cast<size_t>(r) * 2 * H + col);
      const float4 sc = load4(fm + static_cast<size_t>(r) * 2 * H + H + col);
      float* u = uh + i * hq + col;
      float* f = uh + (nrc + i) * hq + col;
      u[0] = v.x * (1.f + sc.x), u[1] = v.y * (1.f + sc.y);
      u[2] = v.z * (1.f + sc.z), u[3] = v.w * (1.f + sc.w);
      f[0] = sh.x, f[1] = sh.y, f[2] = sh.z, f[3] = sh.w;
    }
  })
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = x.warp * x.rpw + rr;
    const float t = warp_sum(ss[rr]);
    if (x.lane == 0 && rr < x.rpw && r < nr && mine(r))
      peer[2 * C * nrc * lat + x.rank * nrc + r / a.ncl] = t;
  }
  // this thread's sums start at 0: red[w][i][k][j] of its warp w, columns j
  for (int i = 0; i < rows; ++i)
    for (int j = 2 * x.lane; j < lat; j += 64) {
      float* t = red + ((x.warp * nrc + i) * 2) * lat + j;
      t[0] = t[lat] = 0.f;
      if (j + 1 < lat) t[1] = t[lat + 1] = 0.f;
    }
  csync();  // u and the shift are whole
  const int fr = fl_rows(H, lat, a.stage_bytes);
  for (int d0 = 0; d0 < hq; d0 += fr, ++c) {
    wait_chunk(a, x, c);
    const bf16* fls = reinterpret_cast<const bf16*>(x.rp + (c % a.stages) * a.stage_bytes) +
                      a.sh[3 * MAX_L];
    for (int i = 0; i < rows; ++i)
      for (int j = 2 * x.lane; j < lat; j += 64) {
        float* t = red + ((x.warp * nrc + i) * 2) * lat + j;
        float p1a = t[0], p2a = t[lat], p1b = 0.f, p2b = 0.f;
        if (j + 1 < lat) p1b = t[1], p2b = t[lat + 1];
        for (int d = x.warp; d < min(fr, hq - d0); d += NW) {
          const bf16* row = fls + d * (lat + 8);
          const float fa = __bfloat162float(row[j]);
          const float fb = j + 1 < lat ? __bfloat162float(row[j + 1]) : 0.f;
          const float uu = uh[i * hq + d0 + d], vv = uh[(nrc + i) * hq + d0 + d];
          p1a = fmaf(uu, fa, p1a), p1b = fmaf(uu, fb, p1b);
          p2a = fmaf(vv, fa, p2a), p2b = fmaf(vv, fb, p2b);
        }
        t[0] = p1a, t[lat] = p2a;
        if (j + 1 < lat) t[1] = p1b, t[lat + 1] = p2b;
      }
    done_chunk(a, x, c);
  }
  csync();
  for (int it = threadIdx.x; it < rows * 2 * lat; it += NC) {
    const int i = it / (2 * lat), kj = it % (2 * lat);
    float t = 0.f;
    for (int w = 0; w < NW; ++w) t += red[(w * nrc + i) * 2 * lat + kj];
    peer[(x.rank * nrc + i) * 2 * lat + kj] = t;
  }
  cluster_csync(x);  // every rank's sums are in rank 0
  if (x.rank == 0)
    for (int it = threadIdx.x; it < rows * lat; it += NC) {
      const int i = it / lat, j = it % lat;
      float ss2 = 0.f, t1 = 0.f, t2 = 0.f;
      for (int p = 0; p < C; ++p) {
        ss2 += fo[2 * C * nrc * lat + p * nrc + i];
        t1 += fo[(p * nrc + i) * 2 * lat + j];
        t2 += fo[(p * nrc + i) * 2 * lat + lat + j];
      }
      const float rs = 1.f / sqrtf(ss2 / H + a.eps);
      a.out[static_cast<size_t>(n0 + x.cid + i * a.ncl) * lat + j] = __float2bfloat16(rs * t1 + t2);
    }
}

__global__ void __launch_bounds__(NT, 1)
    head_bf16_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cl = cg::this_cluster();
  const Layout lo = layout(a.H, a.tf, a.rg, a.lat, a.nrc, a.stages, a.stage_bytes);
  bf16* hb = reinterpret_cast<bf16*>(sm + lo.hb);
  bf16* ab = reinterpret_cast<bf16*>(sm + lo.ab);
  float* xch = reinterpret_cast<float*>(sm + lo.xch);
  Ctx x;
  x.rank = static_cast<int>(cl.block_rank());
  x.cid = blockIdx.x / C;
  x.warp = threadIdx.x / 32;
  x.lane = threadIdx.x % 32;
  x.hq = a.H / C;
  x.c0 = x.rank * x.hq;
  x.cf = C * a.tf;
  x.f0 = blockIdx.x * a.tf;
  x.nku = x.f0 < a.F + 8 ? (a.H + a.ku - 1) / a.ku : 0;
  x.nkd = (min(x.cf, a.F + 8 - x.cid * x.cf) + a.kd - 1) / a.kd;
  x.nfl = (x.hq + fl_rows(a.H, a.lat, a.stage_bytes) - 1) / fl_rows(a.H, a.lat, a.stage_bytes);
  const int steps = (a.N + a.rg - 1) / a.rg * a.L;
  x.rpw = a.rg / NW;
  x.rp = sm;
  x.ring = smem_u32(sm);
  x.full = smem_u32(sm + lo.mb);
  x.empty = x.full + 8 * a.stages;
  x.cbar = x.empty + 8 * a.stages;
  x.cpar = 0;

  // zeros in the activations: their F columns past F meet down's rows past F,
  // which read as 0, and must not be NaN (rows of h and the activations past
  // N only make outputs that are never kept)
  {
    const size_t n16 = (lo.xch - lo.ab) / 16;
    uint4* z = reinterpret_cast<uint4*>(sm + lo.ab);
    for (size_t i = threadIdx.x; i < n16; i += NT) z[i] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < a.stages; ++k) {
      mbar_init(x.full + 8 * k);
      mbar_init(x.empty + 8 * k, NW);
    }
    mbar_init(x.cbar, C);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cl.sync();  // every CTA of the cluster is zeroed and its barriers made before any peer uses them

  if (x.warp == NW) {
    produce(maps, a, x, sm);
  } else {
    float4 xr[2][GPL];
    int c = 0;
    for (int s = 0; s < steps; ++s) {
      const int l = s % a.L, n0 = s / a.L * a.rg, nr = min(a.rg, a.N - n0);
      const bf16* mods = a.mods + (static_cast<size_t>(l) * a.N + n0) * 3 * a.H;
      if (l == 0) {
        const bf16* xin = a.x + static_cast<size_t>(n0) * a.H + x.c0;
        FOR_OWNED({ xr[rr][g] = load4(xin + static_cast<size_t>(r) * a.H + col); })
      }
      norm_h(a, x, cl, l, nr, mods, xr, xch, hb);
      up_proj(a, x, cl, c, l, hb, ab);
      cluster_csync(x);  // the cluster's activations are whole in every CTA
      float* part = a.part + (static_cast<size_t>(s & 1) * a.ncl + x.cid) * a.rg * a.H;
      if (a.sh[3 * l + 2] == 0)
        down_proj<true>(a, x, c, l, ab, nr, part);
      else
        down_proj<false>(a, x, c, l, ab, nr, part);
      grid_barrier(a.bar, [] { csync(); });  // the layer's only grid-wide barrier
      next_x(a, x, nr, mods, a.part + static_cast<size_t>(s & 1) * a.ncl * a.rg * a.H, xr);
      if (l == a.L - 1 && x.cid < nr)
        final_layer(a, x, cl, n0, nr, xr, c, reinterpret_cast<float*>(hb),
                    reinterpret_cast<float*>(ab));
    }
  }
  cl.sync();  // no peer reads this CTA's shared memory after it exits
}

// The 2-D bf16 tensor map of a weight [rows][cols] at `w` (`Maps`): from the
// 16-byte unit that holds w, rows of cols + sh elements at its row stride,
// boxes [box_rows][box_cols]; reads past the edges give zeros.  Cached per
// weight, shape and box.  *sh gets the weight's offset into that unit.
// Returns 0, -6 if the CUDA driver has no encoder, -7 if it refuses.
int weight_map(CUtensorMap* map, int* sh, const void* w, uint64_t cols, uint64_t rows,
               uint32_t box_cols, uint32_t box_rows) {
  static std::map<std::tuple<const void*, uint64_t, uint64_t, uint32_t, uint32_t>, CUtensorMap>
      maps;
  *sh = static_cast<int>(reinterpret_cast<uintptr_t>(w) % 16 / 2);
  const auto key = std::make_tuple(w, cols, rows, box_cols, box_rows);
  auto it = maps.find(key);
  if (it == maps.end()) {
    vv::EncodeTiled enc = vv::encode_fn();
    if (enc == nullptr) return -6;
    const cuuint64_t dims[2] = {cols + static_cast<uint64_t>(*sh), rows};
    const cuuint64_t strides[1] = {cols * 2};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t estr[2] = {1, 1};
    CUtensorMap m;
    if (enc(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<char*>(static_cast<const char*>(w)) - 2 * *sh, dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return -7;
    it = maps.emplace(key, m).first;
  }
  *map = it->second;
  return 0;
}

// Raises the kernel's shared-memory limit, once per device.
int opt_in() {
  static std::set<int> opted;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!opted.count(dev)) {
    err = cudaFuncSetAttribute(head_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               227 * 1024);
    if (err != cudaSuccess) return static_cast<int>(err);
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

}  // namespace

// Clusters of 8 CTAs of the kernel that the card holds at once with `smem`
// bytes of shared memory per CTA, into *out (the launch's grid may not exceed
// them: its grid barrier needs every CTA resident).
extern "C" int vv_head_bf16_clusters(long long smem, int* out) {
  if (smem <= 0 || smem > 227 * 1024) return -4;
  if (const int rc = opt_in()) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(C, static_cast<size_t>(smem), nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, head_bf16_kernel, &cfg));
}

// One solver step: ncl clusters of 8 CTAs, CTA k on F columns [k*tf,
// (k+1)*tf); row groups of rg (8 or 16) rows; gate/up in chunks of ku rows,
// down in chunks of kd rows (nbd boxes of wb columns), final_linear in
// chunks that fill a stage, through a ring of `stages` stages of
// `stage_bytes`; nrc the most rows a cluster finishes in a group; `part` the
// workspace of 2 * ncl * rg * H floats, `bar` the barrier's counter (0 before
// the first launch; every launch leaves its low bits 0).  gate, up, down and
// norm_w are arrays of L pointers (the layers' own contiguous tensors), and
// fl a contiguous [H, lat], each starting on any 2-byte unit, a layer's gate
// and up at the same offset into a 16-byte unit (else -9).  x, mods, fmod
// and out start on 16-byte units.
extern "C" int vv_head_bf16(const void* x, const void* mods, const void* fmod, const void* fl,
                            const void* const* gate, const void* const* up,
                            const void* const* down, const void* const* norm_w, void* out,
                            void* part, void* bar, int N, int H, int F, int L, int lat, int rg,
                            int tf, int ncl, int ku, int kd, int wb, int nbd, int stages,
                            int stage_bytes, int nrc, float eps, void* stream) {
  if (N <= 0 || H <= 0 || H % 128 || H / C > MAX_HQ || F <= 0 || F % 8 || L < 1 || L > MAX_L ||
      lat <= 0 || lat % 8)
    return -1;
  if ((rg != 8 && rg != 16) || tf < 8 || tf % 8 || tf > 256 || part == nullptr || bar == nullptr)
    return -2;
  const int tiles = (F + 8 + tf - 1) / tf;  // the maps' columns: F + 8
  if (ncl != (tiles + C - 1) / C || nrc != (rg + ncl - 1) / ncl) return -3;
  if (ku < 16 || ku % 16 || ku > 256 || kd < 16 || kd % 16 || kd > 256 || (C * tf) % kd ||
      wb % 8 || wb > 256 || nbd < 1 || nbd * wb < H / C + 8 || stages < 2 || stage_bytes % 1024 ||
      static_cast<size_t>(stage_bytes) < 2 * gu_half(ku, tf) ||
      static_cast<size_t>(stage_bytes) < nbd * wd_box(kd, wb) ||
      fl_rows(H, lat, stage_bytes) < 8 || lat + 8 > 256)
    return -8;
  const size_t smem = layout(H, tf, rg, lat, nrc, stages, stage_bytes).total;
  if (smem > 227 * 1024) return -4;
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(mods),
         static_cast<const bf16*>(fmod), {}, {}, static_cast<bf16*>(out),
         static_cast<float*>(part), static_cast<unsigned int*>(bar), N, H, F, L, lat, rg, tf, ncl,
         ku, kd, wb, nbd, stages, stage_bytes, nrc, eps};
  Maps maps;
  for (int l = 0; l < L; ++l) {
    a.norm_w[l] = static_cast<const bf16*>(norm_w[l]);
    if (const int rc = weight_map(&maps.m[3 * l], &a.sh[3 * l], gate[l], F, H, tf, ku))
      return rc;
    if (const int rc = weight_map(&maps.m[3 * l + 1], &a.sh[3 * l + 1], up[l], F, H, tf, ku))
      return rc;
    if (a.sh[3 * l + 1] != a.sh[3 * l]) return -9;  // gate and up share the maps' columns
    if (const int rc = weight_map(&maps.m[3 * l + 2], &a.sh[3 * l + 2], down[l], H, F, wb, kd))
      return rc;
  }
  if (const int rc = weight_map(&maps.m[3 * MAX_L], &a.sh[3 * MAX_L], fl, lat, H, lat + 8,
                                fl_rows(H, lat, stage_bytes)))
    return rc;
  if (const int rc = opt_in()) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(ncl * C, smem, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, head_bf16_kernel, maps, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
