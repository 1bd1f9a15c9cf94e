// Absorbed multi-head latent attention (DeepSeek-V2 MLA) for one decode
// token per row, over the stacked latent cache, one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no latent attention.  It is the
// decode attention of the port's DeepSeek-V2 decoder (`models/deepseek_v2.py`).
// Row b's query q [B, H=16, C=576] (per head the absorbed W_kv_b^K q_nope,
// 512, then the roped q_pe, 64) attends over layer `layer` of the latent cache
// [L, B, S, 576] (per slot the normed c_kv, 512, then the roped k_pe, 64): the
// 16 heads share every slot.  score_h(s) = scale * q_h . lat(s) over all 576
// dims; out_h = sum_s softmax(score_h)(s) * lat(s)[:512], in fp32, returned in
// bf16 [B, 16, 512].  Only the slots with visible[b][s] != 0 and s <
// lengths[b] are read.
//
// Bound: each visible slot is read once for all 16 heads (1 152 bytes) and
// costs 16 * (576 + 512) * 2 = 34 816 operations: ~30 operations a byte, far
// below the card's ~295, so the least time is the visible slots' bytes (plus
// q, out and the mask up to each row's length) over 3.35 TB/s: at the 45k
// podcast cell's ~195k visible slot-rows a layer, ~67 us.
//
// Design.  ONE launch of grid (n_splits, B), 4 warps a CTA.  CTA (c, b) sizes
// its split of row b's prefix [0, lengths[b]) on the device (n_splits ranges
// of whole 32-slot tiles, at most MAX_SPLIT slots each; CTAs past the last
// one with work exit), then:
//   * reads the split's visibility (coalesced int32 loads, 16 in flight a
//     thread) and compacts the visible slots into a list in shared memory
//     (warp ballots and a prefix over the warps), so that tiles are dense in
//     visible slots and nothing invisible is read;
//   * stages q [16, 576] and 32-slot tiles of the listed slots by cp.async
//     (16-byte chunks, rows padded to 1 168 bytes so that ldmatrix reads 8
//     rows without bank conflicts) through a 2-deep ring: one tile loads
//     while the other is computed;
//   * S = Q L^T on mma.sync m16n8k16 (the 16 heads are the 16 rows of A; warp
//     w takes slots 8w..8w+7 of the tile over the 36 k-steps of 576; the
//     tile's rows are the column-major B operand, by ldmatrix), scaled into
//     the exp2 domain and written to shared memory; the online softmax runs
//     8 threads a head (fp32, the running max and sum in shared memory);
//   * O += P V on mma.sync with P in bf16 as A (from shared memory) and the
//     tile's first 512 columns as B (ldmatrix.trans); warp w owns output
//     columns 128w..128w+127 (16 n8 accumulators, 64 fp32 registers a
//     thread), rescaled by the heads' alpha at every tile;
//   * the split's (m, l, O) go to the workspace; after __threadfence the CTA
//     draws a ticket of its group (groups of 8 splits), the last of a group
//     merges the group's partials in split order, then draws a ticket of the
//     row, and the last group merges the groups in order (the same result on
//     every run), writes the output and puts the counters back to 0.
//
// Plain C interface, loaded with ctypes.  Returns 0, a negative code for
// arguments it does not take, or the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int H = 16;              // query heads sharing a slot
constexpr int C = 576;             // latent slot width: 512 of c_kv, 64 of k_pe
constexpr int DV = 512;            // output width: the latent's c_kv part
constexpr int LDC = C + 8;         // bf16 row stride in shared memory (1 168 bytes)
constexpr int TILE = 32;           // slots a tile
constexpr int STAGES = 2;          // tiles in the cp.async ring
constexpr int MIN_CTAS = 2;        // CTAs an SM holds at once (the shared memory allows)
constexpr int LDP = TILE + 8;      // bf16 row stride of P
constexpr int MAX_SPLIT = 2048;    // slots a split at most (the visible list)
constexpr int PER_THREAD = MAX_SPLIT / THREADS;
constexpr int GROUP = 8;           // splits merged together before their groups are
constexpr int CHUNKS = C * 2 / 16; // 16-byte chunks a slot (72)

// ---- shared memory layout (bytes) ----
constexpr int Q_BYTES = H * LDC * 2;
constexpr int TILE_BYTES = TILE * LDC * 2;
constexpr int S_BYTES = H * TILE * 4;
constexpr int P_BYTES = H * LDP * 2;
constexpr int LIST_BYTES = MAX_SPLIT * 4;
constexpr int OFF_Q = 0;
constexpr int OFF_KV = OFF_Q + Q_BYTES;
constexpr int OFF_S = OFF_KV + STAGES * TILE_BYTES;
constexpr int OFF_P = OFF_S + S_BYTES;
constexpr int OFF_LIST = OFF_P + P_BYTES;
constexpr int OFF_STAT = OFF_LIST + LIST_BYTES;  // m, l, alpha [H] fp32; counts
constexpr int SMEM_BYTES = OFF_STAT + 3 * H * 4 + (PER_THREAD * WARPS + 8) * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
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

struct Args {
  const __nv_bfloat16* q;      // [B, H, C]
  const __nv_bfloat16* cache;  // [L, B, S, C]
  const int* visible;          // [B, S]
  const int* lengths;          // [B]
  __nv_bfloat16* out;          // [B, H, DV]
  float* part_acc;             // [B][n_splits + groups][H][DV]
  float* part_ml;              // [B][n_splits + groups][H][2]
  int* counters;               // [B], then [B][groups]; 0 between calls
  int B, S, layer, n_splits;
  float scale;                 // the softmax scale, times log2(e) here
};

// This CTA's split [s0, s1) of row b's prefix and the number of splits with
// work (at least 1, so that a row with no live slot still writes zeros).
__device__ __forceinline__ void split_range(const Args& a, int& s0, int& s1, int& n_active) {
  const int len = min(max(a.lengths[blockIdx.y], 0), a.S);
  const int per = max(TILE, (len + a.n_splits * TILE - 1) / (a.n_splits * TILE) * TILE);
  n_active = max(1, (len + per - 1) / per);
  s0 = blockIdx.x * per;
  s1 = min(len, s0 + per);
}

// Merges the n partials at ml ([n][H][2]) and acc ([n][H][DV]) in order:
// into `out` (normalised, bf16) when FINAL, else into one partial at oml /
// oacc.  Block-wide; `sm` holds at least 2 * n * H floats.
template <bool FINAL>
__device__ void merge(const float* ml, const float* acc, int n, float* sm, __nv_bfloat16* out,
                      float* oml, float* oacc) {
  const int t = threadIdx.x;
  float* wgt = sm;         // [n][H]: m, then the merge weight
  float* ls = sm + n * H;  // [n][H]: l
  __shared__ float mx_s[H], inv_s[H];
  for (int i = t; i < n * H; i += THREADS) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(ml) + i);
    wgt[i] = v.x;
    ls[i] = v.y;
  }
  __syncthreads();
  if (t < H) {
    float m = NEG_INF;
    for (int c = 0; c < n; ++c) m = fmaxf(m, wgt[c * H + t]);
    float l = 0.f;
    for (int c = 0; c < n; ++c) l += exp2f(wgt[c * H + t] - m) * ls[c * H + t];
    mx_s[t] = m;
    inv_s[t] = FINAL ? 1.f / fmaxf(l, 1e-30f) : 1.f;
    if (!FINAL) {
      oml[2 * t] = m;
      oml[2 * t + 1] = l;
    }
  }
  __syncthreads();
  for (int i = t; i < n * H; i += THREADS) wgt[i] = exp2f(wgt[i] - mx_s[i % H]) * inv_s[i % H];
  __syncthreads();
  const float4* acc4 = reinterpret_cast<const float4*>(acc);
  for (int i = t; i < H * DV / 4; i += THREADS) {
    const int h = 4 * i / DV;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    constexpr int U = 8;  // partials whose loads are in flight together
    for (int c0 = 0; c0 < n; c0 += U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = c0 + u < n ? __ldcg(acc4 + static_cast<size_t>(c0 + u) * H * DV / 4 + i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float w = c0 + u < n ? wgt[(c0 + u) * H + h] : 0.f;
        s.x += w * v[u].x;
        s.y += w * v[u].y;
        s.z += w * v[u].z;
        s.w += w * v[u].w;
      }
    }
    if (FINAL) {
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + 4 * i);
      o2[0] = __floats2bfloat162_rn(s.x, s.y);
      o2[1] = __floats2bfloat162_rn(s.z, s.w);
    } else {
      reinterpret_cast<float4*>(oacc)[i] = s;
    }
  }
}

// Draws the ticket of `counter` after this CTA's writes (every thread calls
// it); true in the CTA that draws the n-th, which then sees every other's.
__device__ __forceinline__ bool last_of(int* counter, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// The two-level merge by tickets (decode_attention.cu's, for one row).
__device__ void ticket_merge(const Args& a, int n_active, float* sm) {
  const int b = blockIdx.y, c = blockIdx.x;
  const int n_groups = (n_active + GROUP - 1) / GROUP, grp = c / GROUP;
  const int max_groups = (a.n_splits + GROUP - 1) / GROUP;
  const int in_group = min(GROUP, n_active - grp * GROUP);
  int* gcount = a.counters + a.B + b * max_groups + grp;
  if (!last_of(gcount, in_group)) return;
  const size_t base = static_cast<size_t>(b) * (a.n_splits + max_groups);
  float* ml = a.part_ml + base * H * 2;
  float* acc = a.part_acc + base * H * DV;
  __nv_bfloat16* out = a.out + static_cast<size_t>(b) * H * DV;
  const size_t first = static_cast<size_t>(grp) * GROUP;
  if (n_groups == 1) {
    merge<true>(ml, acc, in_group, sm, out, nullptr, nullptr);
    if (threadIdx.x == 0) *gcount = 0;
    return;
  }
  const size_t gi = a.n_splits + grp;
  merge<false>(ml + first * H * 2, acc + first * H * DV, in_group, sm, out, ml + gi * H * 2,
               acc + gi * H * DV);
  if (threadIdx.x == 0) *gcount = 0;
  if (!last_of(a.counters + b, n_groups)) return;
  merge<true>(ml + a.n_splits * H * 2, acc + a.n_splits * H * DV, n_groups, sm, out, nullptr,
              nullptr);
  if (threadIdx.x == 0) a.counters[b] = 0;  // ready for the next call on the stream
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS) mla_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int s0, s1, n_active;
  split_range(a, s0, s1, n_active);
  if (static_cast<int>(blockIdx.x) >= n_active) return;
  const int b = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;

  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + OFF_Q);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem + OFF_KV);
  float* s_s = reinterpret_cast<float*>(smem + OFF_S);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + OFF_P);
  int* list = reinterpret_cast<int*>(smem + OFF_LIST);
  float* m_s = reinterpret_cast<float*>(smem + OFF_STAT);
  float* l_s = m_s + H;
  float* alpha_s = l_s + H;
  int* cnt_s = reinterpret_cast<int*>(alpha_s + H);  // [PER_THREAD][WARPS], then the total

  const __nv_bfloat16* lat =
      a.cache + (static_cast<size_t>(a.layer) * a.B + b) * static_cast<size_t>(a.S) * C;
  const int* vis = a.visible + static_cast<size_t>(b) * a.S;

  // q: 16 rows of 72 chunks, in the ring's first commit group
  const __nv_bfloat16* qb = a.q + static_cast<size_t>(b) * H * C;
  for (int i = t; i < H * CHUNKS; i += THREADS)
    cp_async16(q_s + (i / CHUNKS) * LDC + 8 * (i % CHUNKS), qb + (i / CHUNKS) * C + 8 * (i % CHUNKS),
               true);

  // the split's visible slots, compacted in order: slot s0 + t + THREADS * j
  {
    int v[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int s = s0 + t + THREADS * j;
      v[j] = s < s1 ? __ldg(vis + s) : 0;
    }
    unsigned bal[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      bal[j] = __ballot_sync(0xffffffffu, v[j] != 0);
      if (lane == 0) cnt_s[j * WARPS + warp] = __popc(bal[j]);
    }
    __syncthreads();
    if (t == 0) {  // each (round, warp)'s first place in the list, in order
      int run = 0;
      for (int i = 0; i < PER_THREAD * WARPS; ++i) {
        const int n = cnt_s[i];
        cnt_s[i] = run;
        run += n;
      }
      cnt_s[PER_THREAD * WARPS] = run;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (v[j] != 0)
        list[cnt_s[j * WARPS + warp] + __popc(bal[j] & ((1u << lane) - 1u))] =
            s0 + t + THREADS * j;
  }
  __syncthreads();
  const int n_vis = cnt_s[PER_THREAD * WARPS];
  const int n_tiles = (n_vis + TILE - 1) / TILE;

  auto load_tile = [&](int st, int it) {
    __nv_bfloat16* dst = kv_s + st * TILE * LDC;
    const int first = it * TILE, valid = min(TILE, n_vis - first);
    for (int i = t; i < TILE * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool live = r < valid;
      const int slot = live ? list[first + r] : s0;
      cp_async16(dst + r * LDC + 8 * c, lat + static_cast<size_t>(slot) * C + 8 * c, live);
    }
  };

  if (t < H) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  for (int i = 0; i < STAGES - 1; ++i) {  // the ring runs STAGES - 1 tiles ahead (q in the first)
    if (i < n_tiles) load_tile(i, i);
    cp_commit();
  }

  float o[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile it (and q) landed for every thread, tile it - 1 is consumed
    if (it + STAGES - 1 < n_tiles) load_tile((it + STAGES - 1) % STAGES, it + STAGES - 1);
    cp_commit();
    const __nv_bfloat16* kt = kv_s + (it % STAGES) * TILE * LDC;
    const int valid = min(TILE, n_vis - it * TILE);

    // S = Q L^T for this warp's 8 slots
    {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* qa = q_s + (lane % 16) * LDC + (lane / 16) * 8;
      const __nv_bfloat16* kr = kt + (8 * warp + (lane & 7)) * LDC + 8 * (lane >> 3);
#pragma unroll 6
      for (int k0 = 0; k0 < C; k0 += 32) {
        uint32_t bk[4], a0[4], a1[4];
        ldsm4(bk, kr + k0);
        ldsm4(a0, qa + k0);
        ldsm4(a1, qa + k0 + 16);
        mma_bf16(s, a0, bk[0], bk[1]);
        mma_bf16(s, a1, bk[2], bk[3]);
      }
      const int c0 = 8 * warp + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = g + 8 * (e / 2), col = c0 + (e % 2);
        s_s[h * TILE + col] = col < valid ? s[e] * a.scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: 8 threads a head, 4 slots each
    {
      const int h = t / 8, j = t % 8;
      float x[4];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x[u] = s_s[h * TILE + 4 * j + u];
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = x[u] > 0.5f * NEG_INF ? exp2f(x[u] - m_new) : 0.f;
        sum += p;
        p_s[h * LDP + 4 * j + u] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (j == 0) {
        const float alpha = exp2f(m_old - m_new);
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + sum;
        alpha_s[h] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V for this warp's 128 columns
    {
      const float al0 = alpha_s[g], al1 = alpha_s[g + 8];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        o[nt][0] *= al0;
        o[nt][1] *= al0;
        o[nt][2] *= al1;
        o[nt][3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 16) {
        uint32_t pa[4];
        ldsm4(pa, p_s + (lane % 16) * LDP + kk + (lane / 16) * 8);
        const __nv_bfloat16* vr =
            kt + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDC + 128 * warp + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t bv[4];
          ldsm4t(bv, vr + 16 * np);
          mma_bf16(o[2 * np], pa, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // this split's partial
  const int max_groups = (a.n_splits + GROUP - 1) / GROUP;
  const size_t pi = static_cast<size_t>(b) * (a.n_splits + max_groups) + blockIdx.x;
  float* pacc = a.part_acc + pi * H * DV;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = 128 * warp + 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(pacc + g * DV + col) = make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(pacc + (g + 8) * DV + col) = make_float2(o[nt][2], o[nt][3]);
  }
  __syncthreads();
  if (t < H) {
    a.part_ml[pi * H * 2 + 2 * t] = m_s[t];
    a.part_ml[pi * H * 2 + 2 * t + 1] = l_s[t];
  }
  ticket_merge(a, n_active, reinterpret_cast<float*>(smem + OFF_KV));
}

}  // namespace

// q [B, 16, 576] bf16, cache [L, B, S, 576] bf16, visible [B, S] int32,
// lengths [B] int32, out [B, 16, 512] bf16; n_splits: the grid's splits per
// row, with n_splits * 2048 >= S.  With groups = ceil(n_splits / 8) the
// workspace: part_acc [B, n_splits + groups, 16, 512] and part_ml [B,
// n_splits + groups, 16, 2] fp32, counters [B * (1 + groups)] int32, all 0
// before the first call (each call leaves them 0).
extern "C" int vv_mla_decode_attention(const void* q, const void* cache, const int* visible,
                                       const int* lengths, void* out, float* part_acc,
                                       float* part_ml, int* counters, int B, int S, int L,
                                       int layer, int n_splits, float scale, void* stream) {
  if (B <= 0 || S <= 0) return -1;
  if (layer < 0 || layer >= L) return -2;
  if (n_splits < 1 || static_cast<long long>(n_splits) * MAX_SPLIT < S ||
      n_splits > (S + TILE - 1) / TILE)
    return -3;
  static bool opted = false;
  if (!opted) {
    cudaError_t err = cudaFuncSetAttribute(mla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache), visible,
         lengths, static_cast<__nv_bfloat16*>(out), part_acc, part_ml, counters, B, S, layer,
         n_splits, scale * LOG2E};
  mla_kernel<<<dim3(n_splits, B), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vv_mla_smem_bytes() { return SMEM_BYTES; }
