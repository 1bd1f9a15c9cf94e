// Flash prefill attention (causal GQA over a left-padded prompt), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `vibevoice_tpu/ops/flash_attention.py:
// flash_attention_prefill` (Pallas `_flash_kernel`).  For q [B, T, H, D],
// k/v [B, S, KVH, D] and the key mask pad [B, S] (int32, > 0 = real key):
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
// over the keys j with pad[b, j] > 0 and, when causal, j <= row_off + i
// (G = H / KVH query heads share one KV head).  Scores sum in fp32; the
// probabilities are rounded to v's dtype before P.V and the normalizer sums
// the unrounded ones, as the TPU kernel does.  Masked probabilities are set
// to exactly 0 and l = 0 is guarded, so a row that sees no key (a left pad)
// comes out zero and every row is finite.
//
// Bound: at a 4096-token prompt the causal products are ~51.5 GFLOP against
// ~29 MB of q, k, v and out, so the least time is the operations over the
// tensor cores' 989 TFLOP/s (~52 us per layer at B=1).
//
// Design (bf16).  The TPU kernel's grid walks (row, head, query block, key
// block) in order and carries the softmax state in VMEM from one key block to
// the next.  Here one CTA owns one (batch row, KV head, tile of 128 query
// rows, or of 64 where 128-row tiles would leave SMs without a CTA) and
// loops over the key tiles itself.  A query row is a (position, head of the
// KV head's group) pair, rows ordered position-major, so the G heads of a
// position sit side by side and every K/V tile in shared memory serves all
// G of them.  The CTA is warp-specialised:
//   * warpgroup 0, the producer, gives its registers up (setmaxnreg) and one
//     warp keeps 128-key K and V tiles in flight with TMA
//     (cp.async.bulk.tensor, a 4-D map (D, KVH, S, B), 128-byte swizzle) in a
//     ring of two stages, completion on an mbarrier; with each tile it
//     stages that tile's pad mask (and whether every key of it is real);
//   * warpgroups 1 and 2 (1 alone in a 64-row tile), the consumers, each own
//     64 query rows.  Q is copied once with cp.async into the same swizzled
//     layout (its rows are not one strided box: a position's heads are
//     contiguous, positions H*D apart).
//     Per key tile: S = Q K^T by wgmma m64n128k16 (both from shared memory),
//     the masks and the fp32 online softmax in registers (exp2, masked
//     scores -inf against a finite running max, so they give exactly 0),
//     P rounded to bf16 in registers, O += P V by wgmma with A from
//     registers and V as the MN-major B operand; O stays in registers.  Each
//     consumer thread arrives on the stage's `empty` barrier when its
//     products are done, which frees the stage for the producer.
// The pad mask is applied only in tiles that hold a masked key and the
// causal mask only in the tiles that cross a row's position; key tiles past
// the CTA's last causal position are never loaded, and the longest query
// tiles start first.
//
// fp32 inputs (only the tiny card-vs-CPU references use them) take a
// CUDA-core kernel: 4 warps, 16 rows each, a 64-key tile copied with plain
// 16-byte loads, FMAs in the m16n8 fragment layout.
//
// The tensor maps are encoded with `cuTensorMapEncodeTiled`, reached through
// the runtime's driver entry point, so the library links no -lcuda.
//
// Plain C interface, loaded with ctypes; dtype code 0 float32, 1 bfloat16 (q,
// k, v and out share it).  Returns 0, a negative code for arguments it does
// not take, or the CUDA error of the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pad;
  void* out;
  int B, T, S, H, KVH, row_off, causal;
  float scale;
};

// ===========================================================================
// bf16: wgmma + TMA
// ===========================================================================

// NC consumer warpgroups (1 or 2) per CTA: 64 * NC query rows (position, head)
constexpr int BN_W = 128;                // keys per tile
constexpr int STAGES = 2;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int NC>
struct Layout {
  static constexpr int Q = 0;                               // [NC][D/64][64 rows][128 B]
  static constexpr int K = Q + NC * 64 * D * 2;             // [STAGES][D/64][BN rows][128 B]
  static constexpr int V = K + STAGES * BN_W * D * 2;
  static constexpr int PAD = V + STAGES * BN_W * D * 2;     // int [STAGES][BN]
  static constexpr int FLAG = PAD + STAGES * BN_W * 4;      // int [STAGES]: every key real
  static constexpr int BAR = FLAG + 16;                     // u64 full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 2 * STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;                // the base is aligned up to 1024
  static constexpr uint32_t TX = 2 * BN_W * D * 2;          // K + V bytes per stage
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, zero-filled where `n` (0 or 16) is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

#define VV_F8(d, i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A[64x16] B[16x128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : VV_F8(d, 0), VV_F8(d, 8), VV_F8(d, 16), VV_F8(d, 24), VV_F8(d, 32), VV_F8(d, 40),
        VV_F8(d, 48), VV_F8(d, 56)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64] += A[64x16] (registers) B[16x128], B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : VV_F8(d, 0), VV_F8(d, 8), VV_F8(d, 16), VV_F8(d, 24), VV_F8(d, 32), VV_F8(d, 40),
        VV_F8(d, 48), VV_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64x16] (registers) B[16x64], B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : VV_F8(d, 0), VV_F8(d, 8), VV_F8(d, 16), VV_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef VV_F8

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Query tile `tile` of (b, kvh), the longest (last) tiles of every (b, kvh)
// first: the tile index is the slowest-varying part of the block index.
__device__ __forceinline__ void cta_coords(int& tile, int& kvh, int& b, int KVH, int B) {
  const int bh = blockIdx.x % (B * KVH);
  tile = gridDim.x / (B * KVH) - 1 - blockIdx.x / (B * KVH);
  kvh = bh % KVH;
  b = bh / KVH;
}

template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = Layout<D, NC>;
  constexpr int BM_W = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  int* pads = reinterpret_cast<int*>(sm + L::PAD);
  int* flags = reinterpret_cast<int*>(sm + L::FLAG);
  const uint32_t full0 = base + L::BAR, empty0 = base + L::BAR + 8 * STAGES;

  int tile, kvh, b;
  cta_coords(tile, kvh, b, a.KVH, a.B);
  const int G = a.H / a.KVH;
  const long long row0 = static_cast<long long>(tile) * BM_W;
  const long long pos_last = min(static_cast<long long>(a.T) - 1, (row0 + BM_W - 1) / G);
  long long kend = a.S;
  if (a.causal) kend = min(kend, a.row_off + pos_last + 1);
  const int ntiles = kend > 0 ? static_cast<int>((kend + BN_W - 1) / BN_W) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int* padrow = a.pad + static_cast<size_t>(b) * a.S;
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = i * BN_W;
      int p[BN_W / 32];
#pragma unroll
      for (int u = 0; u < BN_W / 32; ++u) {
        const int key = k0 + u * 32 + lane;
        p[u] = key < a.S ? __ldg(padrow + key) : 0;
      }
      mbar_wait(empty0 + 8 * st, ph ^ 1);
      bool real = true;
#pragma unroll
      for (int u = 0; u < BN_W / 32; ++u) {
        pads[st * BN_W + u * 32 + lane] = p[u];
        real = real && p[u] > 0;
      }
      real = __all_sync(0xffffffffu, real);
      if (lane == 0) flags[st] = real ? 1 : 0;
      __syncwarp();
      if (lane == 0) {
        const uint32_t full = full0 + 8 * st;
        mbar_arrive_tx(full, L::TX);
#pragma unroll
        for (int r = 0; r < D / 64; ++r) {
          tma_load_4d(base + L::K + (st * (D / 64) + r) * BN_W * 128, &kmap, full, 64 * r, kvh,
                      k0, b);
          tma_load_4d(base + L::V + (st * (D / 64) + r) * BN_W * 128, &vmap, full, 64 * r, kvh,
                      k0, b);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq = lane % 4;
    const long long wrow0 = row0 + 64 * cw;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    const uint32_t qbase = base + L::Q + cw * 64 * D * 2;

    // Q: 64 rows x D, 16-byte chunks into the 128-byte-swizzled layout
    constexpr int CPR = D / 8;  // chunks per row
#pragma unroll
    for (int i = 0; i < 64 * CPR / 128; ++i) {
      const int e = t + 128 * i;
      const int r = e / CPR, cc = e % CPR;
      const long long R = wrow0 + r, pos = R / G;
      const bool in = pos < a.T;
      const __nv_bfloat16* src =
          in ? q + ((static_cast<size_t>(b) * a.T + pos) * a.H + static_cast<size_t>(kvh) * G +
                    R % G) * D + cc * 8
             : q;
      const uint32_t dst = qbase + (cc / 8) * 64 * 128 + r * 128 + (((cc % 8) ^ (r & 7)) * 16);
      cp_async16(dst, src, in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

    // this thread's two rows (g and g + 8 of its warp's 16)
    long long pos[2];
    for (int r = 0; r < 2; ++r) pos[r] = (wrow0 + warp * 16 + g + 8 * r) / G;
    const long long pos_min = wrow0 / G;
    const float sl = a.scale * LOG2E;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int i = 0; i < ntiles; ++i) {
      const int st = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int k0 = i * BN_W;
      mbar_wait(full0 + 8 * st, ph);
      const uint32_t kbase = base + L::K + st * (D / 64) * BN_W * 128;
      const uint32_t vbase = base + L::V + st * (D / 64) * BN_W * 128;

      // ---- S = Q K^T ----
      float s[BN_W / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t dq = gmma_desc(qbase + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t dk = gmma_desc(kbase + (kk / 4) * BN_W * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_ss_n128(s, dq, dk, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // ---- masks and the online softmax (log2 domain) ----
      const bool need_causal = a.causal && static_cast<long long>(k0) + BN_W - 1 >
                                               static_cast<long long>(a.row_off) + pos_min;
      const bool need = need_causal || flags[st] == 0;
      float mx[2] = {NEG_INF, NEG_INF};
      if (need) {
        long long lim[2];
        for (int r = 0; r < 2; ++r) lim[r] = a.causal ? a.row_off + pos[r] - k0 : BN_W;
        const int* pt = pads + st * BN_W;
#pragma unroll
        for (int j = 0; j < BN_W / 8; ++j) {
          const int2 pp = *reinterpret_cast<const int2*>(pt + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * tq + (e & 1);
            const bool ok = ((e & 1) ? pp.y : pp.x) > 0 && col <= lim[e >> 1];
            const float x = ok ? s[4 * j + e] * sl : -INFINITY;
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN_W / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[4 * j + e] * sl;
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t pa[BN_W / 16][4];
#pragma unroll
      for (int j = 0; j < BN_W / 8; ++j) {
        // a masked score is -inf against a finite max: exactly 0
        const float p0 = ex2(s[4 * j] - m[0]), p1 = ex2(s[4 * j + 1] - m[0]);
        const float p2 = ex2(s[4 * j + 2] - m[1]), p3 = ex2(s[4 * j + 3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // ---- O += P V ----
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN_W / 16; ++kk)
        wgmma_pv<D>(o, pa[kk], gmma_desc(vbase + kk * 16 * 128, BN_W * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      mbar_arrive(empty0 + 8 * st);
    }

    // ---- out = O / l ----
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (pos[r] >= a.T) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      const long long R = wrow0 + warp * 16 + g + 8 * r;
      __nv_bfloat16* dst = out + ((static_cast<size_t>(b) * a.T + pos[r]) * a.H +
                                  static_cast<size_t>(kvh) * G + R % G) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// k or v [B, S, KVH, D] as a 4-D map (D, KVH, S, B); boxes of 64 x 1 x BN x 1,
// 128-byte swizzle; keys past S read as zeros
int make_kv_map(CUtensorMap* map, const void* ptr, int B, int S, int KVH, int D) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return -6;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(KVH),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(KVH) * D * 2,
                                 static_cast<cuuint64_t>(S) * KVH * D * 2};
  const cuuint32_t box[4] = {64, 1, BN_W, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                   box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -7;
}

template <int D, int NC>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  int rc = make_kv_map(&kmap, a.k, a.B, a.S, a.KVH, D);
  if (rc == 0) rc = make_kv_map(&vmap, a.v, a.B, a.S, a.KVH, D);
  if (rc != 0) return rc;
  void (*kern)(CUtensorMap, CUtensorMap, Args) = flash_wgmma_kernel<D, NC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<D, NC>::ALLOC);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.T) * (a.H / a.KVH);
  const long long tiles = (rows + 64 * NC - 1) / (64 * NC);
  const dim3 grid(static_cast<unsigned>(tiles * a.KVH * a.B));
  kern<<<grid, 128 * (NC + 1), Layout<D, NC>::ALLOC, stream>>>(kmap, vmap, a);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// fp32: CUDA-core kernel
// ===========================================================================

constexpr int WARPS_F = 4;
constexpr int THREADS_F = WARPS_F * 32;
constexpr int BM_F = WARPS_F * 16;  // query rows per CTA
constexpr int BK_F = 64;            // keys per tile
constexpr int NT_F = BK_F / 8;      // 8-key column tiles of S
constexpr int LDP = BK_F + 4;       // row stride of the P tile

template <int D>
__host__ __device__ constexpr int ld_f() {
  return D + 4;  // +16 bytes: conflict-free fragment reads
}

template <int D>
size_t smem_f() {
  return sizeof(float) * (static_cast<size_t>(BM_F + 2 * BK_F) * ld_f<D>() + WARPS_F * 16 * LDP) +
         sizeof(int) * BK_F;
}

// Copy `rows` rows of D floats into shared memory (row stride ld_f<D>()); row
// r comes from `src_of(r)`, or is zero where that is null.
template <int D, typename Src>
__device__ __forceinline__ void load_rows_f(float* dst, int rows, Src src_of) {
  constexpr int CH = D / 4;
  for (int e = threadIdx.x; e < rows * CH; e += THREADS_F) {
    const int r = e / CH, c = e % CH;
    const float* src = src_of(r);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (src != nullptr) val = __ldg(reinterpret_cast<const float4*>(src) + c);
    reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * ld_f<D>())[c] = val;
  }
}

// Fragment layout of an m16n8 fp32 tile: lane (g = lane / 4, t = lane % 4)
// owns rows g (elements 0, 1) and g + 8 (2, 3) at columns 2t and 2t + 1 of
// every 8-column tile.
template <int D>
__global__ void __launch_bounds__(THREADS_F) flash_f32_kernel(Args a) {
  constexpr int LD = ld_f<D>();
  constexpr int DT = D / 8;  // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BM_F * LD;
  float* Vs = Ks + BK_F * LD;
  float* Ps = Vs + BK_F * LD;  // [WARPS][16][LDP]
  int* pads = reinterpret_cast<int*>(Ps + WARPS_F * 16 * LDP);

  const int G = a.H / a.KVH;
  int tile, kvh, b;
  cta_coords(tile, kvh, b, a.KVH, a.B);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const long long row0 = static_cast<long long>(tile) * BM_F;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  const int rloc[2] = {warp * 16 + g, warp * 16 + g + 8};
  long long pos[2];
  for (int i = 0; i < 2; ++i) pos[i] = (row0 + rloc[i]) / G;

  load_rows_f<D>(Qs, BM_F, [&](int r) -> const float* {
    const long long R = row0 + r, p = R / G;
    if (p >= a.T) return nullptr;
    const size_t head = static_cast<size_t>(kvh) * G + R % G;
    return q + ((static_cast<size_t>(b) * a.T + p) * a.H + head) * D;
  });
  const long long pos_last = min(static_cast<long long>(a.T) - 1, (row0 + BM_F - 1) / G);
  long long kend = a.S;
  if (a.causal) kend = min(kend, a.row_off + pos_last + 1);

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (long long k0 = 0; k0 < kend; k0 += BK_F) {
    __syncthreads();  // every warp is done with the previous tile (and Q is in)
    auto kv_row = [&](const float* base, int j) -> const float* {
      const long long key = k0 + j;
      if (key >= a.S) return nullptr;
      return base + (static_cast<size_t>(b) * a.S + key) * a.KVH * D + static_cast<size_t>(kvh) * D;
    };
    load_rows_f<D>(Ks, BK_F, [&](int j) { return kv_row(k, j); });
    load_rows_f<D>(Vs, BK_F, [&](int j) { return kv_row(v, j); });
    for (int j = threadIdx.x; j < BK_F; j += THREADS_F)
      pads[j] = k0 + j < a.S ? a.pad[static_cast<size_t>(b) * a.S + k0 + j] : 0;
    __syncthreads();

    // ---- S = Q K^T ----
    float s[NT_F][4];
#pragma unroll
    for (int nt = 0; nt < NT_F; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const float* q0 = Qs + rloc[0] * LD;
    const float* q1 = Qs + rloc[1] * LD;
    for (int d = 0; d < D; ++d) {
      const float x0 = q0[d], x1 = q1[d];
#pragma unroll
      for (int nt = 0; nt < NT_F; ++nt) {
        const float ka = Ks[(nt * 8 + 2 * tq) * LD + d];
        const float kb = Ks[(nt * 8 + 2 * tq + 1) * LD + d];
        s[nt][0] = fmaf(x0, ka, s[nt][0]);
        s[nt][1] = fmaf(x0, kb, s[nt][1]);
        s[nt][2] = fmaf(x1, ka, s[nt][2]);
        s[nt][3] = fmaf(x1, kb, s[nt][3]);
      }
    }

    // ---- masks and the online softmax ----
    uint32_t ok = 0u;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT_F; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * tq + (e & 1);
        const int r = e >> 1;
        const bool valid = pads[j] > 0 && (!a.causal || k0 + j <= a.row_off + pos[r]);
        s[nt][e] = valid ? s[nt][e] * a.scale : NEG_INF;
        ok |= static_cast<uint32_t>(valid) << (nt * 4 + e);
        mx[r] = fmaxf(mx[r], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT_F; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok >> (nt * 4 + e)) & 1u ? expf(s[nt][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[nt][e] = p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];

    // ---- O += P V ----
    float* pw = Ps + warp * 16 * LDP;
#pragma unroll
    for (int nt = 0; nt < NT_F; ++nt) {
      pw[g * LDP + nt * 8 + 2 * tq] = s[nt][0];
      pw[g * LDP + nt * 8 + 2 * tq + 1] = s[nt][1];
      pw[(g + 8) * LDP + nt * 8 + 2 * tq] = s[nt][2];
      pw[(g + 8) * LDP + nt * 8 + 2 * tq + 1] = s[nt][3];
    }
    __syncwarp();
    for (int j = 0; j < BK_F; ++j) {
      const float p0 = pw[g * LDP + j], p1 = pw[(g + 8) * LDP + j];
      const float* vr = Vs + j * LD + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const float va = vr[dt * 8], vb = vr[dt * 8 + 1];
        o[dt][0] = fmaf(p0, va, o[dt][0]);
        o[dt][1] = fmaf(p0, vb, o[dt][1]);
        o[dt][2] = fmaf(p1, va, o[dt][2]);
        o[dt][3] = fmaf(p1, vb, o[dt][3]);
      }
    }
    __syncwarp();
  }

  // ---- out = O / l ----
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (pos[r] >= a.T) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const long long R = row0 + rloc[r];
    float* dst = out + ((static_cast<size_t>(b) * a.T + pos[r]) * a.H + static_cast<size_t>(kvh) * G +
                        R % G) * D + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(dst + dt * 8) = make_float2(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
  }
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  void (*kern)(Args) = flash_f32_kernel<D>;
  const size_t smem = smem_f<D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.T) * (a.H / a.KVH);
  const long long tiles = (rows + BM_F - 1) / BM_F;
  kern<<<static_cast<unsigned>(tiles * a.KVH * a.B), THREADS_F, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `rows`: query rows per CTA of the bf16 kernel, 64 (one consumer
// warpgroup) or 128 (two); the fp32 kernel takes 64 whatever it is.
extern "C" int vv_flash_prefill(const void* q, const void* k, const void* v, const void* pad,
                                void* out, int B, int T, int S, int H, int KVH, int D,
                                int row_off, int causal, int rows, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH || row_off < 0) return -1;
  if (D != 64 && D != 128) return -2;  // head dim not taken
  if (rows != 64 && rows != 128) return -4;
  // the grid is one dimension of (query tile, KV head, row) CTAs
  if (static_cast<long long>(T) * (H / KVH) / BM_F * KVH * B >= (1LL << 31)) return -3;
  // the scale as the plain version has it: 1/sqrt(D) in double, rounded once
  Args a{q, k, v, static_cast<const int*>(pad), out, B, T, S, H, KVH, row_off, causal,
         static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return D == 64 ? launch_f32<64>(a, st) : launch_f32<128>(a, st);
  if (dtype == 1) {
    if (rows == 64) return D == 64 ? launch_wgmma<64, 1>(a, st) : launch_wgmma<128, 1>(a, st);
    return D == 64 ? launch_wgmma<64, 2>(a, st) : launch_wgmma<128, 2>(a, st);
  }
  return -5;  // unsupported dtype
}
