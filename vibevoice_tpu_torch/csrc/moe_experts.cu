// Grouped routed experts of a DeepSeek-V2 decode call, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts.  It is
// the routed-expert sum of the port's DeepSeek-V2 decoder
// (`models/deepseek_v2._experts_dense`) for a call of at most 256 tokens:
//   out[n, :] = sum_e w[n, e] * (silu(h[n] @ G_e) * (h[n] @ U_e)) @ D_e
// with h [N, H] bf16, w [N, E] fp32 (zero outside each row's top k), G_e / U_e
// [H, F] and D_e [F, H] the bf16 slices of experts_gate / experts_up /
// experts_down ([E, H, F], [E, H, F], [E, F, H]), out [N, H] fp32.  The plain
// path computes every expert as batched matmuls and weighs them by the zero
// gate; this launch reads only the experts some row of the call was routed
// to (w[:, e] not all 0: an expert whose weight underflowed to 0 adds 0
// either way).  It finds them itself, on the device, so a captured step
// reads nothing of the routing on the host.
//
// Bound: at N <= 16 each weight element feeds 2N flops against 2 bytes, 16
// ops a byte against the card's ~295, so the least time is the bytes: the
// K experts hit, 3 * H * F * 2 bytes each (17.3 MB at DeepSeek-V2-Lite's H
// 2 048, F 1 408), plus h, w and the output, over 3.35 TB/s: ~125 us at the
// 45k cell's ~24 experts a layer.  The design keeps HBM streaming.
//
// ONE launch of one CTA an SM (all resident: the grid barrier waits for every
// CTA), 8 consumer warps and a producer warp.  Every CTA reads w and builds
// the ascending list of the hit experts and its length K in shared memory.
// A unit (i, j) is hit expert i's F columns [64j, 64j + 64); CTA c takes the
// units c, c + G, c + 2G, ... of the K * ceil(F / 64), expert-major (so
// neighbouring CTAs read neighbouring columns of the same rows), and:
//   1. for each of its units, a = silu(h G_e[:, tile]) * (h U_e[:, tile]) over
//      all H rows on mma.sync m16n8k16 (the rows are m16, 8 or 16 of them;
//      warp w takes the tile's 8 columns 8w.. of G and U), fp32 sums, a
//      rounded to bf16 once into shared memory;
//   2. its share of the output: P_c = sum over its units of w[:, e] * (a
//      D_e[tile rows, :]), 512 columns at a time (warp w the 64 columns
//      64w..), each unit's product y kept in fp32 and weighed in fp32, the
//      units added in order in registers; P_c [rows, H] fp32 goes to the
//      workspace once;
//   the grid barrier;
//   3. out = sum_c P_c in CTA order (each output element's G partials split
//      over a fixed group of lanes, combined by a fixed shuffle tree), so two
//      calls give the same bits (no float atomics).
// Weights stream by TMA (3-D maps [E][rows][cols], so a box never reads the
// next expert; 64-column boxes of 128-byte rows under the 128-byte swizzle,
// so ldmatrix reads 8 rows without bank conflicts) through ONE ring of
// shared-memory stages in the order the consumers take them, under an L2
// evict-first policy: gate and up as [ku rows][64] boxes, then down as 8
// side-by-side [32 rows][64] boxes (1 KB of each row).  The producer warp
// issues every copy and refills a stage as soon as the 8 consumer warps are
// done with it (its empty mbarrier); nothing in a CTA's stream waits for
// another CTA.  Rows past N, columns past F or H and rows past H or F read
// as zeros.  `ops/moe_experts.plan` sizes the launch.
//
// Plain C interface, loaded with ctypes.  Returns 0, a negative code for
// arguments it does not take, or the CUDA error of the launch.

#include <cuda.h>
#include <cuda_bf16.h>

#include <map>
#include <set>
#include <tuple>

#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vv::fence_async;
using vv::grid_barrier;
using vv::mbar_expect;
using vv::mbar_init;
using vv::smem_u32;

constexpr int NC = 256;      // consumer threads (warps 0-7)
constexpr int NW = NC / 32;  // consumer warps; warp NW is the producer
constexpr int NT = NC + 32;  // threads of a CTA
constexpr int TC = 64;       // columns of a weight box (one 128-byte swizzled row) and of a unit
constexpr int KR = 32;       // rows of down in a chunk
constexpr int QC = NW * TC;  // columns of down in a chunk: box w for warp w
constexpr int MAX_E = NC;    // experts, at most (one consumer thread each)
constexpr int SMEM_MAX = 227 * 1024;

struct Args {
  const bf16* h;       // [nr, H]
  const float* w;      // [nr, E]
  float* out;          // [nr, H]
  float* part;         // [ctas][rg][H]: each CTA's share of the output
  unsigned int* bar;   // the grid barrier's counter
  int nr, H, F, E, rg, ku, stages, umax;
};

struct Maps {
  CUtensorMap gate, up, down;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets of the kernel's shared memory (`ops/moe_experts.moe_smem`
// mirrors the total): the ring (stages of 2 ku or KR rows of 128-byte box
// rows, on 1024-byte units for the swizzle), h [rg][Hp + 8] (Hp: H padded to
// whole chunks), the units' a [umax][rg][TC + 8], the list of hit experts,
// its length and the warps' counts of hits, the mbarriers (each stage's full
// and empty), and 1024 bytes to align the base.
struct Layout {
  int stage_bytes;
  size_t hb, ab, list, mb, total;
};

__host__ __device__ inline Layout layout(int H, int E, int rg, int ku, int stages, int umax) {
  Layout L;
  L.stage_bytes = imax(2 * ku * TC * 2, KR * QC * 2);
  size_t o = static_cast<size_t>(stages) * L.stage_bytes;
  L.hb = o;    o += static_cast<size_t>(rg) * (cdiv(H, ku) * ku + 8) * 2;
  L.ab = o;    o += static_cast<size_t>(umax) * rg * (TC + 8) * 2;
  L.list = o;  o += (4 * (E + 1 + NW) + 15) / 16 * 16;
  L.mb = o;    o += 16 * static_cast<size_t>(stages);
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
__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// The barrier of the CTA's consumer threads (the producer warp keeps
// streaming).
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory"); }

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits for phase `parity` of an mbarrier; a wait not done within seconds
// traps rather than hanging the card.
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spins = 0;; ++spins) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1LL << 24)) __trap();
  }
}
// A box of the 3-D tensor map at (column x, row y, expert z) -> shared,
// completing on `bar`, under an L2 policy
__device__ __forceinline__ void tma_box3(void* dst, const CUtensorMap* map, int x, int y, int z,
                                         uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar), "l"(policy)
      : "memory");
}

struct Ctx {
  int warp, lane, K, nft, nku, nq, units, stage_bytes;
  const int* list;             // the hit experts, ascending
  unsigned char* ring;
  uint32_t ring_s;             // the ring's shared address
  uint32_t full, empty;        // stage 0's full and empty mbarriers (stage s: + 8 s)
};

// The CTA's s-th unit: its expert and first F column
__device__ __forceinline__ void unit(const Ctx& x, int s, int& e, int& col) {
  const int u = blockIdx.x + s * gridDim.x;
  e = x.list[u / x.nft];
  col = (u % x.nft) * TC;
}

// The producer (lane 0 of warp NW): every chunk of the CTA's units in the
// order the consumers take them, each once the consumers are done with the
// chunk `stages` before it, which held its stage.
__device__ void produce(const Maps& maps, const Args& a, const Ctx& x) {
  const uint64_t pol = vv::evict_first_policy();  // weights: read once per call
  const uint32_t box_gu = static_cast<uint32_t>(a.ku) * TC * 2, box_d = KR * TC * 2;
  int c = 0;
  // chunk c's stage, once free, expecting `bytes` on its full barrier `bar`
  auto next = [&](uint32_t bytes, uint32_t& bar) {
    const int stage = c % a.stages;
    if (c >= a.stages) mbar_wait_bounded(x.empty + 8 * stage, (c / a.stages - 1) & 1);
    ++c;
    bar = x.full + 8 * stage;
    fence_async();
    mbar_expect(bar, bytes);
    return x.ring + static_cast<size_t>(stage) * x.stage_bytes;
  };
  uint32_t bar;
  int e, col;
  for (int s = 0; s < x.units; ++s) {
    unit(x, s, e, col);
    for (int k = 0; k < x.nku; ++k) {
      unsigned char* dst = next(2 * box_gu, bar);
      tma_box3(dst, &maps.gate, col, k * a.ku, e, bar, pol);
      tma_box3(dst + box_gu, &maps.up, col, k * a.ku, e, bar, pol);
    }
  }
  for (int q = 0; q < x.nq; ++q)
    for (int s = 0; s < x.units; ++s) {
      unit(x, s, e, col);
      for (int k = 0; k < TC / KR; ++k) {
        unsigned char* dst = next(NW * box_d, bar);
        for (int b = 0; b < NW; ++b)
          tma_box3(dst + b * box_d, &maps.down, q * QC + b * TC, col + k * KR, e, bar, pol);
      }
    }
}

// A consumer warp waits for chunk c; once done with its stage, lane 0 tells
// the producer (the stage's empty barrier counts the NW warps).
__device__ __forceinline__ uint32_t wait_chunk(const Args& a, const Ctx& x, int c) {
  const int stage = c % a.stages;
  mbar_wait_bounded(x.full + 8 * stage, (c / a.stages) & 1);
  return x.ring_s + stage * x.stage_bytes;
}
__device__ __forceinline__ void done_chunk(const Args& a, const Ctx& x, int c) {
  __syncwarp();
  if (x.lane == 0) mbar_arrive(x.empty + 8 * (c % a.stages));
}

// The A operand's ldmatrix.x4 address of this lane for a [rg][ld] bf16
// buffer at k = 0: matrices rows 0-7 | 8-15 by k 0-7 | 8-15 (rows past rg
// alias rows below it: their outputs are never kept).
__device__ __forceinline__ uint32_t a_base(const void* buf, int ld, int rg, int lane) {
  const int arow = ((lane & 7) + ((lane >> 3) & 1) * 8) & (rg - 1);
  return smem_u32(buf) + arow * ld * 2 + (lane >> 4) * 16;
}

// 1. The unit's gate and up over its chunks of ku rows, warp w on the tile's
// columns 8w..8w+7; a = silu(g) * u into `ab` [rg][TC + 8].
__device__ void gate_up(const Args& a, const Ctx& x, int& c, uint32_t hbase, bf16* ab) {
  const int lane = x.lane;
  float g[4] = {0.f, 0.f, 0.f, 0.f}, v[4] = {0.f, 0.f, 0.f, 0.f};
  // B (x4.trans): gate rows k0-7, gate k8-15, up k0-7, up k8-15 of the
  // warp's 16-byte column chunk, swizzled by the row (r & 7 = lane & 7)
  const int m = lane >> 3;
  const uint32_t boff = static_cast<uint32_t>((m >> 1) * a.ku * TC * 2 +
                                              ((m & 1) * 8 + (lane & 7)) * TC * 2 +
                                              ((x.warp ^ (lane & 7)) << 4));
  for (int kc = 0; kc < x.nku; ++kc, ++c) {
    const uint32_t st = wait_chunk(a, x, c) + boff;
    const uint32_t hb = hbase + kc * a.ku * 2;
#pragma unroll 4
    for (int ks = 0; ks < a.ku; ks += 16) {
      uint32_t af[4], bf[4];
      ldsm4(af, hb + ks * 2);
      ldsm4t(bf, st + ks * TC * 2);
      mma(g, af, bf[0], bf[1]);
      mma(v, af, bf[2], bf[3]);
    }
    done_chunk(a, x, c);
  }
  const int row = lane >> 2, col = 8 * x.warp + 2 * (lane & 3);
  *reinterpret_cast<uint32_t*>(ab + row * (TC + 8) + col) =
      pack2(silu(g[0]) * v[0], silu(g[1]) * v[1]);
  if (row + 8 < a.rg)
    *reinterpret_cast<uint32_t*>(ab + (row + 8) * (TC + 8) + col) =
        pack2(silu(g[2]) * v[2], silu(g[3]) * v[3]);
}

// 2. The CTA's share of output columns [q * QC, (q + 1) * QC): warp w's 64
// columns q * QC + 64w.. (box w of each chunk, 8 tiles of 8) over the units,
// each unit's y = a D_e[tile rows, columns] in fp32 (two chunks of KR rows),
// weighed by its expert's w in fp32 and added in unit order; written to the
// CTA's partial.
__device__ void down(const Args& a, const Ctx& x, int& c, int q, const bf16* ab, float* part) {
  const int lane = x.lane, row = lane >> 2;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  // B (x4.trans): rows k0-7 and k8-15 of the box's 16-byte chunks 2p and
  // 2p + 1, swizzled by the row (r & 7 = lane & 7)
  const uint32_t boff = static_cast<uint32_t>(x.warp * KR * TC * 2 +
                                              (((lane >> 3) & 1) * 8 + (lane & 7)) * TC * 2);
  const int chunk = lane >> 4;
  for (int s = 0; s < x.units; ++s) {
    int e, col;
    unit(x, s, e, col);
    float y[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) y[n][r] = 0.f;
    const uint32_t abase = a_base(ab + s * a.rg * (TC + 8), TC + 8, a.rg, lane);
#pragma unroll
    for (int kc = 0; kc < TC / KR; ++kc, ++c) {
      const uint32_t st = wait_chunk(a, x, c) + boff;
#pragma unroll
      for (int ks = 0; ks < KR; ks += 16) {
        uint32_t af[4];
        ldsm4(af, abase + (kc * KR + ks) * 2);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t bf[4];
          ldsm4t(bf, st + ks * TC * 2 + (((2 * p + chunk) ^ (lane & 7)) << 4));
          mma(y[2 * p], af, bf[0], bf[1]);
          mma(y[2 * p + 1], af, bf[2], bf[3]);
        }
      }
      done_chunk(a, x, c);
    }
    const float w0 = row < a.nr ? __ldg(a.w + static_cast<size_t>(row) * a.E + e) : 0.f;
    const float w1 = row + 8 < a.nr ? __ldg(a.w + static_cast<size_t>(row + 8) * a.E + e) : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] += w0 * y[n][0], acc[n][1] += w0 * y[n][1];
      acc[n][2] += w1 * y[n][2], acc[n][3] += w1 * y[n][3];
    }
  }
  const int col0 = q * QC + x.warp * TC + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = col0 + 8 * n;
    if (col < a.H) {
      if (row < a.nr)
        __stcg(reinterpret_cast<float2*>(part + static_cast<size_t>(row) * a.H + col),
               make_float2(acc[n][0], acc[n][1]));
      if (row + 8 < a.nr)
        __stcg(reinterpret_cast<float2*>(part + static_cast<size_t>(row + 8) * a.H + col),
               make_float2(acc[n][2], acc[n][3]));
    }
  }
}

// 3. out = the CTAs' partials added in CTA order: each group of S lanes (S a
// power of two, at most 32) takes one 4-column item, lane p of it the
// partials p, p + S, ..., in order, then the group's S sums meet by a fixed
// shuffle tree; every warp of the grid takes items in turn.
__device__ void reduce(const Args& a, int warp, int lane) {
  const int items = a.nr * a.H / 4, warps = gridDim.x * NW;
  int S = 32;
  while (S > 1 && static_cast<long long>(items) * S > static_cast<long long>(warps) * 32) S /= 2;
  const int per = 32 / S, p = lane % S;
  const size_t slab = static_cast<size_t>(a.rg) * a.H;
  for (int base = (blockIdx.x * NW + warp) * per; base < items; base += warps * per) {
    const int item = base + lane / S;
    const bool live = item < items;
    const size_t off = live ? static_cast<size_t>(item / (a.H / 4)) * a.H + 4 * (item % (a.H / 4))
                            : 0;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
#pragma unroll 4
      for (int cta = p; cta < static_cast<int>(gridDim.x); cta += S) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(a.part + cta * slab + off));
        t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
      }
    for (int d = 1; d < S; d *= 2) {
      t.x += __shfl_xor_sync(0xffffffffu, t.x, d);
      t.y += __shfl_xor_sync(0xffffffffu, t.y, d);
      t.z += __shfl_xor_sync(0xffffffffu, t.z, d);
      t.w += __shfl_xor_sync(0xffffffffu, t.w, d);
    }
    if (live && p == 0) *reinterpret_cast<float4*>(a.out + off) = t;
  }
}

// Rows [0, nr) of `src` ([nr][cols] bf16, cols a multiple of 8) into `dst`
// ([..][ld]), by 16-byte vectors.
__device__ void stage_rows(bf16* dst, int ld, const bf16* src, int nr, int cols) {
  const int per = cols / 8;
  for (int q = threadIdx.x; q < nr * per; q += NC) {
    const int r = q / per, v = q % per;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * ld + 8 * v) =
        __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * cols) + v);
  }
}

__global__ void __launch_bounds__(NT, 1)
    moe_experts_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout lo = layout(a.H, a.E, a.rg, a.ku, a.stages, a.umax);
  int* list = reinterpret_cast<int*>(sm + lo.list);
  int* count = list + a.E;  // K
  int* per_warp = count + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the hit experts, ascending: consumer thread e tests column e of w
  {
    bool hit = false;
    if (tid < a.E)
      for (int r = 0; r < a.nr; ++r) hit |= a.w[static_cast<size_t>(r) * a.E + tid] != 0.f;
    unsigned int mask = 0;
    if (warp < NW) {
      mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) per_warp[warp] = __popc(mask);
    }
    if (tid == 0) {
      for (int k = 0; k < a.stages; ++k) {
        mbar_init(smem_u32(sm + lo.mb) + 8 * k);
        mbar_init(smem_u32(sm + lo.mb) + 8 * (a.stages + k), NW);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (hit) {
      int base = 0;
      for (int q = 0; q < warp; ++q) base += per_warp[q];
      list[base + __popc(mask & ((1u << lane) - 1))] = tid;
    }
    if (tid == 0) {
      int k = 0;
      for (int q = 0; q < NW; ++q) k += per_warp[q];
      *count = k;
    }
    __syncthreads();
  }
  Ctx x;
  x.warp = warp;
  x.lane = lane;
  x.K = *count;
  if (x.K == 0) {  // no expert hit: the sum is 0
    for (int q = blockIdx.x * NT + tid; q < a.nr * a.H; q += gridDim.x * NT) a.out[q] = 0.f;
    return;
  }
  x.nft = cdiv(a.F, TC);
  x.nku = cdiv(a.H, a.ku);
  x.nq = cdiv(a.H, QC);
  x.units = cdiv(x.K * x.nft - static_cast<int>(blockIdx.x), gridDim.x);
  x.stage_bytes = lo.stage_bytes;
  x.list = list;
  x.ring = sm;
  x.ring_s = smem_u32(sm);
  x.full = smem_u32(sm + lo.mb);
  x.empty = x.full + 8 * a.stages;

  if (warp == NW) {
    if (lane == 0) produce(maps, a, x);
    return;
  }
  bf16* hb = reinterpret_cast<bf16*>(sm + lo.hb);
  bf16* ab = reinterpret_cast<bf16*>(sm + lo.ab);
  // h [rg][Hp + 8]: rows past nr and columns past H zero
  const int hld = x.nku * a.ku + 8;
  for (size_t q = tid; q < (lo.ab - lo.hb) / 16; q += NC)
    reinterpret_cast<uint4*>(sm + lo.hb)[q] = make_uint4(0, 0, 0, 0);
  csync();
  stage_rows(hb, hld, a.h, a.nr, a.H);
  csync();
  int c = 0;
  const uint32_t hbase = a_base(hb, hld, a.rg, lane);
  for (int s = 0; s < x.units; ++s) gate_up(a, x, c, hbase, ab + s * a.rg * (TC + 8));
  csync();  // every warp's columns of a are in shared memory
  float* part = a.part + static_cast<size_t>(blockIdx.x) * a.rg * a.H;
  for (int q = 0; q < x.nq; ++q) down(a, x, c, q, ab, part);
  grid_barrier(a.bar, [] { csync(); });  // every CTA's partial is in the workspace
  reduce(a, warp, lane);
}

// The bf16 3-D tensor map of a weight [depth][rows][cols] at `w`, boxes of
// [1][box_rows][TC] under the 128-byte swizzle; reads past the edges give
// zeros.  Cached per weight, shape and box.  Returns 0, -6 if the CUDA driver
// has no encoder, -7 if it refuses.
int weight_map(CUtensorMap* map, const void* w, uint64_t cols, uint64_t rows, uint64_t depth,
               uint32_t box_rows) {
  static std::map<std::tuple<const void*, uint64_t, uint64_t, uint64_t, uint32_t>, CUtensorMap>
      maps;
  const auto key = std::make_tuple(w, cols, rows, depth, box_rows);
  auto it = maps.find(key);
  if (it == maps.end()) {
    vv::EncodeTiled enc = vv::encode_fn();
    if (enc == nullptr) return -6;
    const cuuint64_t dims[3] = {cols, rows, depth};
    const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(TC), box_rows, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    CUtensorMap m;
    // no L2 promotion: a 128-byte box row promoted to 256 bytes brings in
    // the neighbouring tile's half line, evicted first before its own CTA
    // reads it (measured on the H100 with an earlier two-phase form of this
    // kernel: a layer 216 -> 169 us)
    if (enc(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
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
    err = cudaFuncSetAttribute(moe_experts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.insert(dev);
  }
  return 0;
}

}  // namespace

// CTAs of the kernel one SM holds at once with `smem` bytes of shared memory
// each, into *out (the launch's grid may not exceed the card's SMs times
// this: its grid barrier needs every CTA resident).
extern "C" int vv_moe_experts_ctas(long long smem, int* out) {
  if (smem <= 0 || smem > SMEM_MAX) return -4;
  if (const int rc = opt_in()) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, moe_experts_kernel, NT, static_cast<size_t>(smem)));
}

// The routed-expert sum of nr <= rg rows: `ctas` CTAs (all resident), each
// taking at most `umax` units; row group rg (8 or 16); gate/up in chunks of
// ku rows through a ring of `stages` stages.  gate, up [E][H][F] and down
// [E][F][H] contiguous bf16; h [nr][H] bf16; w [nr][E] fp32; out [nr][H]
// fp32; part [ctas][rg][H] fp32 the workspace, bar the grid barrier's counter
// (0 before the first launch; every launch leaves its low bits 0).  Every
// pointer starts on a 16-byte unit (else -5).
extern "C" int vv_moe_experts(const void* h, const void* w, const void* gate, const void* up,
                              const void* down, void* out, void* part, void* bar, int nr, int H,
                              int F, int E, int rg, int ku, int stages, int umax, int ctas,
                              void* stream) {
  if (H < TC || H % TC || F < 8 || F % 8 || E < 1 || E > MAX_E) return -1;
  if ((rg != 8 && rg != 16) || nr < 1 || nr > rg || ctas < 1) return -2;
  if (ku < 16 || ku % 16 || ku > 256 || stages < 2 ||
      static_cast<long long>(umax) * ctas < static_cast<long long>(E) * cdiv(F, TC))
    return -3;
  for (const void* p : {h, static_cast<const void*>(w), gate, up, down,
                        static_cast<const void*>(out), static_cast<const void*>(part),
                        static_cast<const void*>(bar)})
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return -5;
  const Layout lo = layout(H, E, rg, ku, stages, umax);
  if (lo.total > SMEM_MAX) return -4;
  Maps maps;
  if (const int rc = weight_map(&maps.gate, gate, F, H, E, ku)) return rc;
  if (const int rc = weight_map(&maps.up, up, F, H, E, ku)) return rc;
  if (const int rc = weight_map(&maps.down, down, H, F, E, KR)) return rc;
  if (const int rc = opt_in()) return rc;
  Args a{static_cast<const bf16*>(h), static_cast<const float*>(w), static_cast<float*>(out),
         static_cast<float*>(part), static_cast<unsigned int*>(bar), nr, H, F, E, rg, ku, stages,
         umax};
  moe_experts_kernel<<<ctas, NT, lo.total, static_cast<cudaStream_t>(stream)>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}
