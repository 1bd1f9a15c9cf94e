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
// the unrounded ones, as the TPU kernel does.
//
// Bound: at a 4096-token prompt the causal products are ~51.5 GFLOP against
// ~29 MB of q, k, v and out, so the least time is the operations over the
// tensor cores' 989 TFLOP/s (~52 us per layer at B=1).
//
// Design.  The TPU kernel's grid walks (row, head, query block, key block)
// in order and carries the running max, normalizer and accumulator in VMEM
// from one key block to the next.  Here one CTA of 4 warps owns one
// (batch row, KV head, tile of 64 query rows) and loops over the key tiles
// itself, keeping that state in registers.  A query row of the tile is a
// (position, head of the KV head's group) pair, rows ordered position-major,
// so the G = 6 heads of a position sit side by side and every K/V tile
// loaded into shared memory serves all six.  Each warp owns 16 rows:
//   S = Q K^T  for a 64-key tile (bf16: mma.sync m16n8k16, fp32 accumulate;
//              fp32 inputs: FMAs on the CUDA cores, same fragment layout),
//   masks (pad, causal) and an fp32 online softmax; masked probabilities
//   are set to 0 (not exp(-inf - -inf)), so a row that has seen no key keeps
//   l = 0 and writes zeros, and every output is finite;
//   O += P V   (P rounded to bf16 straight from the S fragments).
// Key tiles past the tile's last causal position are skipped; CTAs start
// with the longest (last) query tiles.  Loads are plain 16-byte copies into
// padded shared-memory rows (no bank conflicts on the fragment reads);
// cp.async/TMA double buffering and wgmma are left for a later version.
//
// Plain C interface, loaded with ctypes; dtype code 0 float32, 1 bfloat16 (q,
// k, v and out share it).  Returns 0, a negative code for arguments it does
// not take, or the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16;  // query rows (position, head) per CTA
constexpr int BK = 64;          // keys per tile
constexpr int NT = BK / 8;      // 8-key column tiles of S
constexpr int LDP = BK + 4;     // row stride of the fp32 path's P tile
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

template <typename E>
__host__ __device__ constexpr int row_stride(int d) {
  return d + 16 / static_cast<int>(sizeof(E));  // +16 bytes: conflict-free fragment reads
}

template <typename E, int D>
size_t smem_bytes() {
  constexpr int LD = row_stride<E>(D);
  size_t n = sizeof(E) * static_cast<size_t>(BM + 2 * BK) * LD + sizeof(int) * BK;
  if (std::is_same<E, float>::value) n += sizeof(float) * WARPS * 16 * LDP;
  return n;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
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

// Copy `rows` rows of D elements into shared memory (row stride LD); row r
// comes from `src_of(r)`, or is zero where that is null.  16-byte copies.
template <typename E, int D, typename Src>
__device__ __forceinline__ void load_rows(E* dst, int rows, Src src_of) {
  constexpr int LD = row_stride<E>(D);
  constexpr int CH = D * static_cast<int>(sizeof(E)) / 16;
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const E* src = src_of(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = __ldg(reinterpret_cast<const uint4*>(src) + c);
    reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * LD)[c] = val;
  }
}

// The fragment layout of an m16n8 fp32 tile, used by both paths: lane
// (g = lane / 4, t = lane % 4) owns rows g (elements 0, 1) and g + 8 (2, 3)
// at columns 2t and 2t + 1 of every 8-column tile.

template <typename E, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
  constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  constexpr int LD = row_stride<E>(D);
  constexpr int DT = D / 8;  // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem);
  E* Ks = Qs + BM * LD;
  E* Vs = Ks + BK * LD;
  int* pads = reinterpret_cast<int*>(Vs + BK * LD);
  float* Ps = reinterpret_cast<float*>(pads + BK);  // fp32 path: [WARPS][16][LDP]

  const int G = a.H / a.KVH;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest (last) tiles first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const long long row0 = static_cast<long long>(tile) * BM;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);

  // this thread's two rows: positions and the head offsets within the group
  const int rloc[2] = {warp * 16 + g, warp * 16 + g + 8};
  long long pos[2];
  for (int i = 0; i < 2; ++i) pos[i] = (row0 + rloc[i]) / G;

  load_rows<E, D>(Qs, BM, [&](int r) -> const E* {
    const long long R = row0 + r, p = R / G;
    if (p >= a.T) return nullptr;
    const size_t head = static_cast<size_t>(kvh) * G + R % G;
    return q + ((static_cast<size_t>(b) * a.T + p) * a.H + head) * D;
  });
  const long long pos_last = min(static_cast<long long>(a.T) - 1, (row0 + BM - 1) / G);
  long long kend = a.S;
  if (a.causal) kend = min(kend, a.row_off + pos_last + 1);

  uint32_t qf[kBf16 ? D / 16 : 1][4];
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  __syncthreads();
  if constexpr (kBf16) {
    const __nv_bfloat16* q0 = Qs + rloc[0] * LD;
    const __nv_bfloat16* q1 = Qs + rloc[1] * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = lds32(q0 + kk * 16 + 2 * tq);
      qf[kk][1] = lds32(q1 + kk * 16 + 2 * tq);
      qf[kk][2] = lds32(q0 + kk * 16 + 8 + 2 * tq);
      qf[kk][3] = lds32(q1 + kk * 16 + 8 + 2 * tq);
    }
  }

  for (long long k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    auto kv_row = [&](const E* base, int j) -> const E* {
      const long long key = k0 + j;
      if (key >= a.S) return nullptr;
      return base + (static_cast<size_t>(b) * a.S + key) * a.KVH * D + static_cast<size_t>(kvh) * D;
    };
    load_rows<E, D>(Ks, BK, [&](int j) { return kv_row(k, j); });
    load_rows<E, D>(Vs, BK, [&](int j) { return kv_row(v, j); });
    for (int j = threadIdx.x; j < BK; j += THREADS)
      pads[j] = k0 + j < a.S ? a.pad[static_cast<size_t>(b) * a.S + k0 + j] : 0;
    __syncthreads();

    // ---- S = Q K^T ----
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LD + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16(s[nt], qf[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
      }
    } else {
      const float* q0 = Qs + rloc[0] * LD;
      const float* q1 = Qs + rloc[1] * LD;
      for (int d = 0; d < D; ++d) {
        const float x0 = q0[d], x1 = q1[d];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float ka = Ks[(nt * 8 + 2 * tq) * LD + d];
          const float kb = Ks[(nt * 8 + 2 * tq + 1) * LD + d];
          s[nt][0] = fmaf(x0, ka, s[nt][0]);
          s[nt][1] = fmaf(x0, kb, s[nt][1]);
          s[nt][2] = fmaf(x1, ka, s[nt][2]);
          s[nt][3] = fmaf(x1, kb, s[nt][3]);
        }
      }
    }

    // ---- masks and the online softmax ----
    uint32_t ok = 0u;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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
    for (int nt = 0; nt < NT; ++nt) {
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
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const __nv_bfloat16* v0 = Vs + (kk * 16 + 2 * tq) * LD + g;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const __nv_bfloat16* vc = v0 + dt * 8;
          mma_bf16(o[dt], pa, pack2(vc, vc + LD), pack2(vc + 8 * LD, vc + 9 * LD));
        }
      }
    } else {
      float* pw = Ps + warp * 16 * LDP;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        pw[g * LDP + nt * 8 + 2 * tq] = s[nt][0];
        pw[g * LDP + nt * 8 + 2 * tq + 1] = s[nt][1];
        pw[(g + 8) * LDP + nt * 8 + 2 * tq] = s[nt][2];
        pw[(g + 8) * LDP + nt * 8 + 2 * tq + 1] = s[nt][3];
      }
      __syncwarp();
      for (int j = 0; j < BK; ++j) {
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
  }

  // ---- out = O / l ----
  E* out = static_cast<E*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (pos[r] >= a.T) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const long long R = row0 + rloc[r];
    E* dst = out + ((static_cast<size_t>(b) * a.T + pos[r]) * a.H + static_cast<size_t>(kvh) * G +
                    R % G) * D + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const float x0 = o[dt][2 * r] * inv, x1 = o[dt][2 * r + 1] * inv;
      if constexpr (kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) = __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(dst + dt * 8) = make_float2(x0, x1);
      }
    }
  }
}

template <typename E, int D>
int launch(const Args& a, cudaStream_t stream) {
  void (*kern)(Args) = flash_kernel<E, D>;
  const size_t smem = smem_bytes<E, D>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.T) * (a.H / a.KVH);
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM), a.KVH, a.B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_d(const Args& a, int d, cudaStream_t stream) {
  if (d == 64) return launch<E, 64>(a, stream);
  if (d == 128) return launch<E, 128>(a, stream);
  return -2;  // head dim not taken
}

}  // namespace

extern "C" int vv_flash_prefill(const void* q, const void* k, const void* v, const void* pad,
                                void* out, int B, int T, int S, int H, int KVH, int D,
                                int row_off, int causal, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH) return -1;
  if (KVH > 65535 || B > 65535) return -3;
  if (static_cast<long long>(T) * (H / KVH) / BM >= (1LL << 31)) return -3;
  // the scale as the plain version has it: 1/sqrt(D) in double, rounded once
  Args a{q, k, v, static_cast<const int*>(pad), out, B, T, S, H, KVH, row_off, causal,
         static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, D, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, D, st);
  return -5;  // unsupported dtype
}
