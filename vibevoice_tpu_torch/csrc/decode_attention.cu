// Decode attention over the stacked KV cache, one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel `vibevoice_tpu/ops/decode_attention.py:decode_attention`
// (Pallas body `_kernel`): one query per row, q [B, H, D], attends over layer
// `layer` of the full stacked cache k/v [L, B, S, KVH*D] with GQA (G = H/KVH
// query heads per KV head), masked by visible [B, S]; slots at or past
// lengths[b] are never read.  Softmax in fp32.  With an int8 cache the
// per-slot scales k_scale/v_scale [L, B, 8, S] (row 0 is read) multiply the
// logits and the probabilities, as on the TPU.  A row that sees no slot
// returns zeros.
//
// Bound: decode reads every live K/V row of the layer once and does ~4*G flops
// per cache element, far below the card's ~295 flop/byte ridge, so the least
// time is the bytes of the live prefix, 2 * B * lengths * KVH*D * elem (+ the
// 2-byte scales per slot when int8), over 3.35 TB/s: 24.5 us at 40 000 live
// slots of the 1.5B cache (B=2, KVH*D=256, bf16).  At the engine's usual
// operands (a few hundred live slots) the bytes are ~0.2 us and the call is
// bound by its latency: launch, one load round trip, the merge.
//
// Design.  ONE launch of grid (KVH, n_splits, B): the KV heads of a split
// are neighbours in launch order, so they read the same cache rows (whose
// KV heads lie side by side) at about the same time.  CTA (hk, c, b) reads
// lengths[b] and sizes its split on the device: the live prefix is cut into
// n_active <= n_splits splits of a whole number of 64-slot tiles (so a short
// prefix still spreads over several CTAs and the host never reads lengths);
// CTAs past n_active exit at once.  A CTA runs its split for the G query
// heads of KV head hk:
//   * K/V tiles of 64 slots go through shared memory by cp.async (16-byte
//     coalesced loads, zero-filled past the split: nothing past it is read)
//     in a ring (bf16: 3 tiles, two loading while one is consumed; int8: 2,
//     with three CTAs an SM), with the tile's
//     visibility and scales beside them; an
//     int8 tile is turned into bf16 (exact) in registers on its way to the
//     tile that the products read;
//   * each of the 4 warps takes 16 slots of a tile: Q.K^T on mma.sync
//     m16n8k16 bf16 (the G <= 8 heads are rows 0-7 of A, rows 8-15 zero; K
//     in its [slot, D] layout is the column-major B operand, by ldmatrix),
//     the online softmax in registers (fp32, quad shuffles), then P.V on
//     mma.sync (the score fragments are P's A fragments, split into bf16
//     high and low parts; V by ldmatrix.trans), with fp32 sums;
//   * the 4 warps' (m, l, acc) meet in shared memory in warp order and the
//     split's partial goes to the workspace;
//   * after __threadfence, the CTA draws a ticket from its group's counter
//     (groups of 8 splits); the one that draws the last merges the group's
//     partials in split order, then draws a ticket from the (row, KV head)
//     counter, and the last group merges the groups in order (the same
//     result on every run), writes the output and puts the counters back
//     to 0 for the next call.
// P goes into P.V as two bf16 A operands, its bf16 rounding and the bf16
// remainder: their sum holds P to 16 bits (a relative 2^-17), where P in
// bf16 alone would move each weight by up to 2^-9 and, at the engine's
// operands, outputs near 1 by a whole bf16 step against the fp32 plain
// version; the normaliser sums fp32 P.
// fp32 q (the small fp32 references) keeps exact fp32 FMAs on the CUDA cores:
// one 128-slot split per CTA, three passes (one slot per thread for the
// logits, one warp per head for the softmax, slots across warps for P.V),
// then the same ticket merge.
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16,
// 2 int8 (cache only).  Returns 0, a negative code for arguments it does not
// take, or the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;    // query heads per KV head (1.5B: 6, 7B: 7)
constexpr int TILE = 64;    // slots per staged tile of the tensor-core path: 16 per warp
// tiles in the cp.async ring (bf16: two load while one is consumed; int8,
// whose tiles are half the bytes: one), and CTAs an SM holds at once (int8:
// its smaller ring and 170 registers a thread leave room for a third)
template <bool INT8>
struct Ring {
  static constexpr int STAGES = INT8 ? 2 : 3;
  static constexpr int MIN_CTAS = INT8 ? 3 : 2;
};
constexpr int CHUNK = 128;  // slots per CTA of the fp32 path: one per thread
constexpr int GROUP = 8;    // splits merged together before their groups are

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---- PTX helpers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; with pred false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
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
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Bytes 2h and 2h + 1 of w (int8) as an exact bf16x2, without a type
// conversion instruction (those run at a quarter of the integer rate): each
// byte b goes to the low byte of its half, and (0x4300 | b & 0x7F) - (0x4300
// | b & 0x80), as bf16, is 128 + (b & 127) - (b < 0 ? 256 : 128) = b.
__device__ __forceinline__ uint32_t int8x2_bf16(uint32_t w, int h) {
  uint32_t p;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(p) : "r"(w), "r"(h ? 0x7372u : 0x7170u));
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u, c = (p & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the split's geometry and the ticket merge, shared by both paths ----

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int* visible;
  const int* lengths;
  void* out;
  float* part_acc;  // [B*KVH][n_splits + groups][G][D]: the splits', then the groups' partials
  float* part_ml;   // [B*KVH][n_splits + groups][G][2]
  int* counters;    // [B*KVH] pairs, then [B*KVH][groups]; 0 between calls
  int B, H, KVH, S, layer, n_splits;
  float scale;
};

// This CTA's split [s0, s1) of row b's live prefix and the number of splits
// that have work (at least 1, so a row with no live slot still writes zeros).
// `per` > 0 fixes the split length (the fp32 path); else it is the live
// length over n_splits, rounded up to whole tiles.
__device__ __forceinline__ void split_range(const Args& a, int per, int& s0, int& s1,
                                            int& n_active) {
  const int len = min(max(a.lengths[blockIdx.z], 0), a.S);
  if (per <= 0) per = max(TILE, (len + a.n_splits * TILE - 1) / (a.n_splits * TILE) * TILE);
  n_active = max(1, (len + per - 1) / per);
  s0 = blockIdx.y * per;
  s1 = min(len, s0 + per);
}

// Merges the n partials (m, l, acc) at ml ([n][G][2]) and acc ([n][G][D])
// in their order: into `out` (normalised, TO) when FINAL, else into one
// partial of the same form at oml / oacc.  Block-wide; `sm` holds at least
// 2 * n * MAX_G floats.
template <typename TO, int D, bool FINAL>
__device__ void merge(const float* ml, const float* acc, int n, int G, float* sm, TO* out,
                      float* oml, float* oacc) {
  const int t = threadIdx.x;
  float* wgt = sm;              // [n][MAX_G]: m, then the merge weight
  float* ls = sm + n * MAX_G;   // [n][MAX_G]: l
  __shared__ float mx_s[MAX_G], inv_s[MAX_G];
  for (int i = t; i < n * G; i += THREADS) {
    const int c = i / G, g = i % G;
    const float2 v = __ldcg(reinterpret_cast<const float2*>(ml) + i);
    wgt[c * MAX_G + g] = v.x;
    ls[c * MAX_G + g] = v.y;
  }
  __syncthreads();
  if (t < G) {
    float m = NEG_INF;
    for (int c = 0; c < n; ++c) m = fmaxf(m, wgt[c * MAX_G + t]);
    float l = 0.f;
    for (int c = 0; c < n; ++c) l += expf(wgt[c * MAX_G + t] - m) * ls[c * MAX_G + t];
    mx_s[t] = m;
    inv_s[t] = FINAL ? 1.f / fmaxf(l, 1e-30f) : 1.f;
    if (!FINAL) {
      oml[2 * t] = m;
      oml[2 * t + 1] = l;
    }
  }
  __syncthreads();
  for (int i = t; i < n * G; i += THREADS) {
    const int c = i / G, g = i % G;
    wgt[c * MAX_G + g] = expf(wgt[c * MAX_G + g] - mx_s[g]) * inv_s[g];
  }
  __syncthreads();
  const float4* acc4 = reinterpret_cast<const float4*>(acc);
  for (int i = t; i < G * D / 4; i += THREADS) {
    const int g = 4 * i / D;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    constexpr int U = 8;  // partials whose loads are in flight together
    for (int c0 = 0; c0 < n; c0 += U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = c0 + u < n ? __ldcg(acc4 + static_cast<size_t>(c0 + u) * G * D / 4 + i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float w = c0 + u < n ? wgt[(c0 + u) * MAX_G + g] : 0.f;
        s.x += w * v[u].x;
        s.y += w * v[u].y;
        s.z += w * v[u].z;
        s.w += w * v[u].w;
      }
    }
    if (FINAL) {
      out[4 * i] = from_f<TO>(s.x);
      out[4 * i + 1] = from_f<TO>(s.y);
      out[4 * i + 2] = from_f<TO>(s.z);
      out[4 * i + 3] = from_f<TO>(s.w);
    } else {
      reinterpret_cast<float4*>(oacc)[i] = s;
    }
  }
}

// Draws the ticket of `counter` after this CTA's writes (every thread
// calls it); true in the CTA that draws the n-th, which then sees every
// other CTA's writes.
__device__ __forceinline__ bool last_of(int* counter, int n) {
  __shared__ int last;
  __threadfence();  // this CTA's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// Called by every thread of the CTA after it wrote its split's partial.  The
// splits merge in two levels, each in a fixed order (the same result on
// every run): the last CTA of each group of GROUP splits merges the group's
// partials into a group partial, and the last group to finish merges the
// groups into `out`; a row with one group merges once.  The counters are put
// back to 0 for the next call.  `sm` holds at least 2 * n_splits * MAX_G
// floats.
template <typename TO, int D>
__device__ void ticket_merge(const Args& a, int n_active, float* sm) {
  const int hk = blockIdx.x, b = blockIdx.z, c = blockIdx.y;
  const int G = a.H / a.KVH, pair = b * a.KVH + hk;
  const int n_groups = (n_active + GROUP - 1) / GROUP, grp = c / GROUP;
  const int max_groups = (a.n_splits + GROUP - 1) / GROUP;
  const int in_group = min(GROUP, n_active - grp * GROUP);
  int* gcount = a.counters + a.B * a.KVH + pair * max_groups + grp;
  if (!last_of(gcount, in_group)) return;
  // partials of this pair: the splits', then the groups' at n_splits + grp
  const size_t base = static_cast<size_t>(pair) * (a.n_splits + max_groups);
  float* ml = a.part_ml + base * G * 2;
  float* acc = a.part_acc + base * G * D;
  TO* out = static_cast<TO*>(a.out) + (static_cast<size_t>(b) * a.H + hk * G) * D;
  const size_t first = static_cast<size_t>(grp) * GROUP;
  if (n_groups == 1) {
    merge<TO, D, true>(ml, acc, in_group, G, sm, out, nullptr, nullptr);
    if (threadIdx.x == 0) *gcount = 0;
    return;
  }
  const size_t gi = a.n_splits + grp;
  merge<TO, D, false>(ml + first * G * 2, acc + first * G * D, in_group, G, sm, out,
                      ml + gi * G * 2, acc + gi * G * D);
  if (threadIdx.x == 0) *gcount = 0;
  if (!last_of(a.counters + pair, n_groups)) return;
  merge<TO, D, true>(ml + a.n_splits * G * 2, acc + a.n_splits * G * D, n_groups, G, sm, out,
                     nullptr, nullptr);
  if (threadIdx.x == 0) a.counters[pair] = 0;  // ready for the next call on the stream
}

// ---- tensor-core path: bf16 q, bf16 or int8 cache ----

template <int D>
struct Layout {
  static constexpr int LDS = D + 8;  // bf16 row stride of a compute tile: ldmatrix without conflicts
};

template <bool INT8, int D>
__host__ __device__ constexpr size_t tile_bytes() {
  constexpr int STAGES = Ring<INT8>::STAGES;
  // compute tiles (K, V) per stage for bf16; for int8 the raw int8 stages
  // plus one bf16 compute tile pair; then visibility and scales per stage
  return INT8 ? STAGES * 2 * TILE * D + 2 * TILE * Layout<D>::LDS * 2 + STAGES * TILE * 4 +
                    STAGES * 2 * TILE * 2
              : STAGES * 2 * TILE * Layout<D>::LDS * 2 + STAGES * TILE * 4;
}

template <bool INT8, int D>
__global__ void __launch_bounds__(THREADS, Ring<INT8>::MIN_CTAS) mma_kernel(const Args a) {
  using TKV = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  constexpr int STAGES = Ring<INT8>::STAGES;
  constexpr int LDS = Layout<D>::LDS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.x, b = blockIdx.z;
  int s0, s1, n_active;
  split_range(a, 0, s0, s1, n_active);
  if (static_cast<int>(blockIdx.y) >= n_active) return;
  const int G = a.H / a.KVH;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row (query head) and column pair
  const size_t F = static_cast<size_t>(a.KVH) * D;
  const size_t slot0 = (static_cast<size_t>(a.layer) * a.B + b) * a.S;
  const TKV* kb = static_cast<const TKV*>(a.k) + slot0 * F + hk * D;
  const TKV* vb = static_cast<const TKV*>(a.v) + slot0 * F + hk * D;
  const size_t sc0 = (static_cast<size_t>(a.layer) * a.B + b) * 8 * a.S;
  const int* vis = a.visible + static_cast<size_t>(b) * a.S;

  // shared memory: [stage][K|V] tiles, then visibility and scales per stage
  __nv_bfloat16* ct = reinterpret_cast<__nv_bfloat16*>(smem);  // bf16 compute tiles
  int8_t* raw = reinterpret_cast<int8_t*>(smem + 2 * TILE * LDS * 2);  // int8: [stage][K|V]
  unsigned char* tail = smem + (INT8 ? 2 * TILE * LDS * 2 + STAGES * 2 * TILE * D
                                     : STAGES * 2 * TILE * LDS * 2);
  int* vis_s = reinterpret_cast<int*>(tail);  // [stage][TILE]
  __nv_bfloat16* sc_s = reinterpret_cast<__nv_bfloat16*>(tail + STAGES * TILE * 4);  // [stage][K|V][TILE]

  const int ntiles = (max(s1 - s0, 0) + TILE - 1) / TILE;
  auto load_tile = [&](int st, int ts) {
    constexpr int CPR = D * static_cast<int>(sizeof(TKV)) / 16;  // 16-byte chunks per row
    for (int i = t; i < 2 * TILE * CPR; i += THREADS) {
      const int kv = i / (TILE * CPR), r = (i / CPR) % TILE, c = i % CPR;
      const int slot = ts + r;
      const bool live = slot < s1;
      const TKV* src = (kv ? vb : kb) + static_cast<size_t>(live ? slot : s0) * F + c * 16 / sizeof(TKV);
      void* dst = INT8 ? static_cast<void*>(raw + ((st * 2 + kv) * TILE + r) * D + 16 * c)
                       : static_cast<void*>(ct + ((st * 2 + kv) * TILE + r) * LDS + 8 * c);
      cp_async16(dst, src, live);
    }
    if (t < TILE) cp_async4(vis_s + st * TILE + t, vis + (ts + t < s1 ? ts + t : s0), ts + t < s1);
    if (INT8 && t < TILE) {  // slot pairs of both scale rows; the pair that straddles s1 by hand
      const int kv = t / (TILE / 2), j = 2 * (t % (TILE / 2)), slot = ts + j;
      const __nv_bfloat16* src = (kv ? a.vs : a.ks) + sc0 + slot;
      __nv_bfloat16* dst = sc_s + (st * 2 + kv) * TILE + j;
      if (slot + 1 < s1 || slot >= s1) {
        cp_async4(dst, slot < s1 ? src : a.ks, slot < s1);
      } else {
        dst[0] = src[0];
        dst[1] = __float2bfloat16(0.f);
      }
    }
  };

  for (int i = 0; i < STAGES - 1; ++i) {  // the ring runs STAGES - 1 tiles ahead
    if (i < ntiles) load_tile(i, s0 + i * TILE);
    cp_commit();
  }

  // Q's A fragments: row g is query head hk*G + g (rows >= G and 8-15 zero)
  uint32_t qa[D / 16][2];
  {
    const __nv_bfloat16* qr =
        static_cast<const __nv_bfloat16*>(a.q) + (static_cast<size_t>(b) * a.H + hk * G + g) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 2 * tq) : 0u;
      qa[kk][1] = g < G ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8 + 2 * tq) : 0u;
    }
  }

  float m_run = NEG_INF, l_run = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    cp_wait<STAGES - 2>();  // tile `it` has landed
    __syncthreads();        // ... for every thread, and tile it - 1 is consumed
    const __nv_bfloat16* kt = ct + (INT8 ? 0 : st * 2) * TILE * LDS;
    const __nv_bfloat16* vt = kt + TILE * LDS;
    if (INT8) {  // int8 -> bf16, exact, 16 values per step
      for (int i = t; i < 2 * TILE * D / 16; i += THREADS) {
        const int kv = i / (TILE * D / 16), r = (i / (D / 16)) % TILE, c = i % (D / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(raw + ((st * 2 + kv) * TILE + r) * D + 16 * c);
        const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = int8x2_bf16(wv[j / 2], j % 2);
        uint4* dst = reinterpret_cast<uint4*>(ct + (kv * TILE + r) * LDS + 16 * c);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncthreads();
    }
    // the slot of tile it - 1 takes tile it + STAGES - 1
    if (it + STAGES - 1 < ntiles) load_tile((it + STAGES - 1) % STAGES, s0 + (it + STAGES - 1) * TILE);
    cp_commit();

    // S = Q K^T for this warp's 16 slots: two n8 tiles of 8 slots
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t bk[4];
        ldsm4(bk, kt + (16 * warp + 8 * nt + (lane & 7)) * LDS + 16 * kk + 8 * (lane >> 3));
        mma_bf16(s[nt], qa[kk][0], 0u, qa[kk][1], 0u, bk[0], bk[1]);
        mma_bf16(s[nt], qa[kk + 1][0], 0u, qa[kk + 1][1], 0u, bk[2], bk[3]);
      }
    }
    // online softmax over row g's 4 values (slots 16w + 8nt + 2tq + e)
    const int* vt_s = vis_s + st * TILE;
    const __nv_bfloat16* kss = sc_s + st * 2 * TILE;
    float x[2][2];
    float mt = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 16 * warp + 8 * nt + 2 * tq + e;
        float v = s[nt][e] * a.scale;
        if (INT8) v *= __bfloat162float(kss[j]);
        x[nt][e] = vt_s[j] != 0 ? v : NEG_INF;
        mt = fmaxf(mt, x[nt][e]);
      }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_run, mt);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    float p[2][2], psum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = x[nt][e] > 0.5f * NEG_INF ? expf(x[nt][e] - m_new) : 0.f;
        psum += p[nt][e];
        if (INT8) p[nt][e] *= __bfloat162float(kss[TILE + 16 * warp + 8 * nt + 2 * tq + e]);
      }
    l_run = l_run * alpha + psum;
    // P as bf16 high parts and bf16 remainders: the two products sum P to
    // 16 bits, as exact as the fp32 P of the plain version for the output
    uint32_t ph[2], pl[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(p[nt][0], p[nt][1]);
      const float2 hf = __bfloat1622float2(h);
      ph[nt] = *reinterpret_cast<const uint32_t*>(&h);
      pl[nt] = pack_bf16(p[nt][0] - hf.x, p[nt][1] - hf.y);
    }
    // acc = alpha acc + P V: V's 16 slots x D, two n8 dim tiles per
    // ldmatrix; once a split's maximum has settled alpha is 1 in every row
    // of the warp and the rescale is skipped (a product by 1 changes nothing)
    if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha;
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      uint32_t bv[4];
      ldsm4t(bv, vt + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * nd +
                     8 * (lane >> 4));
      mma_bf16(acc[nd], ph[0], 0u, ph[1], 0u, bv[0], bv[1]);
      mma_bf16(acc[nd + 1], ph[0], 0u, ph[1], 0u, bv[2], bv[3]);
      mma_bf16(acc[nd], pl[0], 0u, pl[1], 0u, bv[0], bv[1]);
      mma_bf16(acc[nd + 1], pl[0], 0u, pl[1], 0u, bv[2], bv[3]);
    }
  }
  cp_wait<0>();
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);

  // the warps' states meet in shared memory (the tiles are free) in warp order
  float* wacc = reinterpret_cast<float*>(smem);  // [WARPS][MAX_G][D]
  float* wm = wacc + WARPS * MAX_G * D;          // [WARPS][MAX_G]
  float* wl = wm + WARPS * MAX_G;
  __syncthreads();
  if (g < G) {
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      wacc[(warp * MAX_G + g) * D + 8 * nd + 2 * tq] = acc[nd][0];
      wacc[(warp * MAX_G + g) * D + 8 * nd + 2 * tq + 1] = acc[nd][1];
    }
    if (tq == 0) {
      wm[warp * MAX_G + g] = m_run;
      wl[warp * MAX_G + g] = l_run;
    }
  }
  __syncthreads();
  const size_t o = (static_cast<size_t>(b) * a.KVH + hk) *
                       (a.n_splits + (a.n_splits + GROUP - 1) / GROUP) + blockIdx.y;
  for (int i = t; i < G * D; i += THREADS) {
    const int gg = i / D, d = i % D;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, wm[w * MAX_G + gg]);
    float sa = 0.f, sl = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(wm[w * MAX_G + gg] - m);
      sa += e * wacc[(w * MAX_G + gg) * D + d];
      sl += e * wl[w * MAX_G + gg];
    }
    a.part_acc[(o * G + gg) * D + d] = sa;
    if (d == 0) {
      a.part_ml[(o * G + gg) * 2] = m;
      a.part_ml[(o * G + gg) * 2 + 1] = sl;
    }
  }
  __syncthreads();  // the merge below reuses the shared memory
  ticket_merge<__nv_bfloat16, D>(a, n_active, reinterpret_cast<float*>(smem));
}

// ---- fp32 path: exact fp32 FMAs, one 128-slot split per CTA ----

template <typename TKV, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS) f32_kernel(const Args a) {
  constexpr int KV8 = 8;       // cache elements per vector load in pass 1
  constexpr int VEC = D / 32;  // head-dim elements per lane in pass 3
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.x, b = blockIdx.z;
  int s0, s1, n_active;
  split_range(a, CHUNK, s0, s1, n_active);
  if (static_cast<int>(blockIdx.y) >= n_active) return;
  const int G = a.H / a.KVH, S = a.S;
  const int n = max(s1 - s0, 0);  // live slots of this split
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const size_t F = static_cast<size_t>(a.KVH) * D;
  const float* q = static_cast<const float*>(a.q);

  __shared__ float q_s[MAX_G][D];      // q of this KV head's G query heads, scaled
  __shared__ float p_s[MAX_G][CHUNK];  // logits, then probabilities (times v's scale)
  __shared__ float m_s[MAX_G], l_s[MAX_G];
  float* acc_s = reinterpret_cast<float*>(smem);  // [WARPS][MAX_G][D], then the merge

  for (int i = t; i < G * D; i += THREADS)
    q_s[i / D][i % D] = q[(static_cast<size_t>(b) * a.H + hk * G) * D + i] * a.scale;

  const size_t slot0 = (static_cast<size_t>(a.layer) * a.B + b) * S + s0;
  const TKV* kb = static_cast<const TKV*>(a.k) + slot0 * F + hk * D;
  const TKV* vb = static_cast<const TKV*>(a.v) + slot0 * F + hk * D;
  const size_t scale0 = (static_cast<size_t>(a.layer) * a.B + b) * 8 * S + s0;
  __syncthreads();

  // pass 1: thread t takes slot s0 + t
  {
    float dot[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) dot[g] = 0.f;
    const bool live = t < n && a.visible[static_cast<size_t>(b) * S + s0 + t] != 0;
    if (t < n) {
      const TKV* kr = kb + static_cast<size_t>(t) * F;
#pragma unroll
      for (int i = 0; i < D; i += KV8) {
#pragma unroll
        for (int j = 0; j < KV8; ++j) {
          const float kv = to_f(kr[i + j]);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) dot[g] += q_s[g][i + j] * kv;
        }
      }
    }
    const float ksc = (QUANT && t < n) ? __bfloat162float(a.ks[scale0 + t]) : 1.f;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) p_s[g][t] = live ? dot[g] * ksc : NEG_INF;
  }
  __syncthreads();

  // pass 2: warp w takes heads w, w + WARPS, ...
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG_INF;
    for (int s = lane; s < CHUNK; s += 32) mx = fmaxf(mx, p_s[g][s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < CHUNK; s += 32) {
      const float x = p_s[g][s];
      const float p = x > 0.5f * NEG_INF ? expf(x - mx) : 0.f;
      sum += p;
      p_s[g][s] = (QUANT && s < n) ? p * __bfloat162float(a.vs[scale0 + s]) : p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // pass 3: warp w takes slots [w*CHUNK/WARPS, (w+1)*CHUNK/WARPS), lane the
  // head-dim elements [lane*VEC, (lane+1)*VEC)
  {
    float acc[MAX_G][VEC];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
    const int s_lo = warp * (CHUNK / WARPS);
    const int s_hi = min(s_lo + CHUNK / WARPS, n);
    for (int s = s_lo; s < s_hi; ++s) {
      float vr[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) vr[i] = to_f(vb[static_cast<size_t>(s) * F + lane * VEC + i]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) {
          const float p = p_s[g][s];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] += p * vr[i];
        }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc_s[(warp * MAX_G + g) * D + lane * VEC + i] = acc[g][i];
  }
  __syncthreads();

  const size_t o = (static_cast<size_t>(b) * a.KVH + hk) *
                       (a.n_splits + (a.n_splits + GROUP - 1) / GROUP) + blockIdx.y;
  for (int idx = t; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += acc_s[(w * MAX_G + g) * D + d];
    a.part_acc[(o * G + g) * D + d] = s;
    if (d == 0) {
      a.part_ml[(o * G + g) * 2] = m_s[g];
      a.part_ml[(o * G + g) * 2 + 1] = l_s[g];
    }
  }
  __syncthreads();
  ticket_merge<float, D>(a, n_active, acc_s);
}

size_t merge_bytes(int n_splits) { return 2 * sizeof(float) * n_splits * MAX_G; }

// `opted`: the dynamic shared memory this kernel may already take (each
// instantiation raises its limit once, not on every call)
template <typename K>
int launch(K kern, const Args& a, size_t smem, size_t& opted, cudaStream_t stream) {
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  kern<<<dim3(a.KVH, a.n_splits, a.B), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8, int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  const size_t smem = std::max(std::max(tile_bytes<INT8, D>(),
                                        sizeof(float) * WARPS * MAX_G * (D + 2)),
                               merge_bytes(a.n_splits));
  return launch(mma_kernel<INT8, D>, a, smem, opted, stream);
}

template <typename TKV, int D, bool QUANT>
int launch_f32(const Args& a, cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  const size_t smem = std::max(sizeof(float) * WARPS * MAX_G * D, merge_bytes(a.n_splits));
  return launch(f32_kernel<TKV, D, QUANT>, a, smem, opted, stream);
}

template <int D>
int dispatch(int q_dtype, int kv_dtype, const Args& a, cudaStream_t st) {
  if (q_dtype == 1 && kv_dtype == 1) return launch_mma<false, D>(a, st);
  if (q_dtype == 1 && kv_dtype == 2) return launch_mma<true, D>(a, st);
  if (q_dtype == 0 && kv_dtype == 0) return launch_f32<float, D, false>(a, st);
  if (q_dtype == 0 && kv_dtype == 2) return launch_f32<int8_t, D, true>(a, st);
  return -3;  // unsupported dtype pair
}

}  // namespace

// n_splits: the grid's splits per (row, KV head); bf16 q: 1 <= n_splits <=
// ceil(S / 64); fp32 q: exactly ceil(S / 128).  With groups = ceil(n_splits
// / 8), the workspace: part_acc [B*KVH, n_splits + groups, G, D] and part_ml
// [B*KVH, n_splits + groups, G, 2] fp32, counters [B*KVH * (1 + groups)]
// int32, all 0 before the first call (each call leaves them 0).
extern "C" int vv_decode_attention(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const int* visible,
                                   const int* lengths, void* out, float* part_acc,
                                   float* part_ml, int* counters, int B, int H, int KVH, int D,
                                   int S, int L, int layer, int n_splits, int q_dtype,
                                   int kv_dtype, void* stream) {
  if (B <= 0 || KVH <= 0 || S <= 0 || H % KVH != 0 || H / KVH > MAX_G) return -1;
  if (layer < 0 || layer >= L) return -2;
  const int max_splits = q_dtype == 1 ? (S + TILE - 1) / TILE : (S + CHUNK - 1) / CHUNK;
  if (n_splits < 1 || n_splits > max_splits || (q_dtype == 0 && n_splits != max_splits))
    return -2;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) return -4;
  Args a{q, k, v, static_cast<const __nv_bfloat16*>(k_scale),
         static_cast<const __nv_bfloat16*>(v_scale), visible, lengths, out, part_acc, part_ml,
         counters, B, H, KVH, S, layer, n_splits, 1.0f / sqrtf(static_cast<float>(D))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return dispatch<64>(q_dtype, kv_dtype, a, st);
  if (D == 128) return dispatch<128>(q_dtype, kv_dtype, a, st);
  return -5;  // unsupported head dim
}
