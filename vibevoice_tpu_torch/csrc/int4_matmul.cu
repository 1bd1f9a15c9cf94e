// int4 weight-only matmul y[M, N] = x[M, K] @ (int4[K, N] * scale), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `vibevoice_tpu/ops/int4_matmul.py:int4_matmul`
// (Pallas `_kernel`): the weight is nibble-packed int8 [K/2, N] (see
// int4_common.cuh), with fp32 scales [1, N] (per output channel: applied to
// the fp32 sum) or [K/gs, N] (per group: multiplied into each weight in x's
// dtype before the dot).  Output in x's dtype.
//
// Bound: at decode M = 2B rows (2 at B=1), so the call does 2*M flops per
// weight value while reading half a byte of it: the least time is the packed
// weight bytes (K*N/2 + scales) over 3.35 TB/s, 0.5-4 us at the 1.5B shapes,
// where one launch's own latency is already a few microseconds.
//
// Design.  One launch per call.  A CTA of 4 warps owns 128 output columns and
// a slab of the packed rows (whole k16 steps of 8 byte rows); the warps take
// the slab's steps in turn.  In a step, lane (g = lane / 4, t = lane % 4)
// loads 16 bytes (32 weights) of byte rows t and t + 4 at columns 16g..16g+15:
// neighbouring lanes read neighbouring 16-byte chunks, and a warp keeps four
// steps' loads in flight.  The interleaved nibble layout puts weight rows 2i
// and 2i+1 in one byte, which is exactly the k pair a lane holds in a B
// fragment of `mma.sync` m16n8k16, so each loaded byte becomes one bf16x2
// register (nibble ^ 8 into the mantissa of 128 with `prmt`, minus 136; per
// group times the column's bf16 scale, rounded once as the TPU kernel rounds)
// and byte j of the chunk feeds n8 tile j: 16 tensor-core products per step,
// A = x's k16 slice from shared memory, fp32 accumulate.  Each 16 rows of x
// (M <= 128) are CTAs of their own, which read the slab again from L2.  fp32
// x (the tiny references) takes CUDA-core FMAs over the same loads, 4 rows per
// CTA.
// The splits along K meet in the same launch: the splits of one column tile
// (and pass of rows) are one thread-block cluster of at most 8, the portable
// size (cudaLaunchKernelEx with the cluster attribute).  The
// 4 warps' sums are added in shared memory in warp order; after a cluster
// barrier each CTA adds, for its share of the tile's outputs, every split's
// sums read from that CTA's shared memory (distributed shared memory) in
// split order, applies the per-channel scale and writes y; a second barrier
// keeps every CTA's shared memory alive until the others are done.  No float
// atomics and no workspace: two calls give the same bits.
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16.
// Returns 0, a negative code for arguments it does not take, or the CUDA
// error of the launch.

#include <cooperative_groups.h>

#include <type_traits>

#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int COLS = 128;        // output columns per CTA: 8 lane groups x 16, one per thread
constexpr int BATCH = 4;         // steps whose loads a warp keeps in flight
constexpr int XS_BYTES = 98304;  // the staged x slice (one pass's rows), at most
constexpr int MAX_SPLITS = 8;    // K splits of a column tile: one portable cluster

struct Args {
  const void* x;
  const int8_t* packed;
  const float* scale;
  void* out;
  int M, K, N, G, KBR, ksplit;
};

template <typename T>
struct Tile;  // rows per pass and x's staged row stride
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int MT = 16;
  static __host__ __device__ int ldx(int nsteps) { return 16 * nsteps + 8; }  // 16-byte rows
};
template <>
struct Tile<float> {
  static constexpr int MT = 4;
  static __host__ __device__ int ldx(int nsteps) { return 16 * nsteps + 4; }
};

template <typename T>
__host__ __device__ size_t xs_bytes(int M, int KBR) {
  const size_t rows = M < Tile<T>::MT ? M : Tile<T>::MT;
  return (rows * Tile<T>::ldx((KBR + 7) / 8) * sizeof(T) + 15) & ~static_cast<size_t>(15);
}

template <typename T>
__host__ __device__ size_t smem_bytes(int M, int KBR) {
  return xs_bytes<T>(M, KBR) + sizeof(float) * NWARPS * (M < Tile<T>::MT ? M : Tile<T>::MT) * COLS;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// 16 packed bytes of byte row `row` (of `w`) at columns [col, col + 16);
// bytes past the slab (row >= nrows) or the row's end (columns >= N) read as
// 0, i.e. weights 0.
__device__ __forceinline__ uint4 load16(const int8_t* w, int row, int nrows, int col, int N,
                                        bool aligned) {
  if (row >= nrows || col >= N) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = w + static_cast<size_t>(row) * N + col;
  if (aligned && col + 16 <= N) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < 16 && col + j < N; ++j)
    v[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + j))) << (8 * (j % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The 4 bytes of `w` as bf16x2 (low half: low nibble, high half: high
// nibble), each 128 + (nibble ^ 8), i.e. the int4 value + 136.
__device__ __forceinline__ void nibbles_bf16(uint32_t w, uint32_t (&r)[4]) {
  const uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t lh01 = prmt(lo, hi, 0x5140), lh23 = prmt(lo, hi, 0x7362);
  r[0] = prmt(lh01, 0x43434343u, 0x4140);
  r[1] = prmt(lh01, 0x43434343u, 0x4342);
  r[2] = prmt(lh23, 0x43434343u, 0x4140);
  r[3] = prmt(lh23, 0x43434343u, 0x4342);
}

__device__ __forceinline__ uint32_t bf2_sub136(uint32_t v) {
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  b = __hsub2(b, __floats2bfloat162_rn(136.f, 136.f));  // exact: the int4 value
  return *reinterpret_cast<uint32_t*>(&b);
}

__device__ __forceinline__ uint32_t bf2_mul(uint32_t v, uint32_t s) {
  __nv_bfloat162 b = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<__nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&b);
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

// The scales of 16 columns for the group that holds byte row `row`, in x's
// dtype (bf16: both halves of a bf16x2; fp32: as stored), reloaded only when
// the group changes.
template <typename T>
struct GroupScales {
  int group = -1;
  uint32_t s[16];
  __device__ __forceinline__ void at(const Args& a, int row, int col) {
    const int grp = min(2 * row / (a.K / a.G), a.G - 1);  // rows past K hold weights 0
    if (grp == group) return;
    group = grp;
    const float* srow = a.scale + static_cast<size_t>(grp) * a.N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float v = col + j < a.N ? __ldg(srow + col + j) : 0.f;
      if constexpr (std::is_same<T, float>::value) {
        s[j] = __float_as_uint(v);
      } else {
        __nv_bfloat162 b = __float2bfloat162_rn(v);
        s[j] = *reinterpret_cast<uint32_t*>(&b);
      }
    }
  }
};

// This warp's loads of the steps sb, sb + NWARPS, ... (BATCH of them)
__device__ __forceinline__ void load_batch(const int8_t* w, int sb, int nsteps, int nrows, int col,
                                           int N, bool aligned, uint4 (&raw)[BATCH][2]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int s = sb + u * NWARPS;
    const int lim = s < nsteps ? nrows : 0;
    raw[u][0] = load16(w, 8 * s + t, lim, col, N, aligned);
    raw[u][1] = load16(w, 8 * s + t + 4, lim, col, N, aligned);
  }
}

// One warp's share of the slab for the rows [m0, m0 + 16), bf16 x: its sums
// in the m16n8 fragment layout of n8 tile j, whose column g is the CTA's
// column 16g + j (`acc[j]`: rows g, g + 8; columns 2t, 2t + 1).
template <bool GROUPED>
__device__ __forceinline__ void slab_bf16(const Args& a, const __nv_bfloat16* xs, int ldx, int m0,
                                          int kb0, int nrows, int nsteps, int col, bool aligned,
                                          uint4 (&raw)[BATCH][2],
                                          float (&acc)[16][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int8_t* w = a.packed + static_cast<size_t>(kb0) * a.N;
  GroupScales<__nv_bfloat16> sc;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bool r0 = m0 + g < a.M, r1 = m0 + g + 8 < a.M;
  const __nv_bfloat16* x0 = xs + g * ldx + 2 * t;
  const __nv_bfloat16* x1 = x0 + 8 * ldx;
  for (int sb = warp; sb < nsteps; sb += NWARPS * BATCH) {
    uint4 nxt[BATCH][2];  // the next batch's loads go out before this one is used
    if (sb + NWARPS * BATCH < nsteps)
      load_batch(w, sb + NWARPS * BATCH, nsteps, nrows, col, a.N, aligned, nxt);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int s = sb + u * NWARPS;
      if (s >= nsteps) break;
      uint32_t af[4];
      af[0] = r0 ? *reinterpret_cast<const uint32_t*>(x0 + 16 * s) : 0u;
      af[1] = r1 ? *reinterpret_cast<const uint32_t*>(x1 + 16 * s) : 0u;
      af[2] = r0 ? *reinterpret_cast<const uint32_t*>(x0 + 16 * s + 8) : 0u;
      af[3] = r1 ? *reinterpret_cast<const uint32_t*>(x1 + 16 * s + 8) : 0u;
      uint32_t b[2][16];  // b[h][j]: column 16g + j, byte row t + 4h of the step
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t wv[4] = {raw[u][h].x, raw[u][h].y, raw[u][h].z, raw[u][h].w};
        if (GROUPED) sc.at(a, kb0 + 8 * s + t + 4 * h, col);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t r[4];
          nibbles_bf16(wv[q], r);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t v = bf2_sub136(r[e]);
            if (GROUPED) v = bf2_mul(v, sc.s[4 * q + e]);
            b[h][4 * q + e] = v;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) mma_bf16(acc[j], af, b[0][j], b[1][j]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) raw[u][0] = nxt[u][0], raw[u][1] = nxt[u][1];
  }
}

// The same for fp32 x and the rows [m0, m0 + 4): acc[r][j] sums row m0 + r,
// column 16g + j over this lane's byte rows (t, t + 4 of every step).
template <bool GROUPED>
__device__ __forceinline__ void slab_f32(const Args& a, const float* xs, int ldx, int m0, int kb0,
                                         int nrows, int nsteps, int col, bool aligned,
                                         uint4 (&raw)[BATCH][2],
                                         float (&acc)[4][16]) {
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const int8_t* w = a.packed + static_cast<size_t>(kb0) * a.N;
  GroupScales<float> sc;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  const int rows = min(4, a.M - m0);
  for (int sb = warp; sb < nsteps; sb += NWARPS * BATCH) {
    uint4 nxt[BATCH][2];  // the next batch's loads go out before this one is used
    if (sb + NWARPS * BATCH < nsteps)
      load_batch(w, sb + NWARPS * BATCH, nsteps, nrows, col, a.N, aligned, nxt);
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int s = sb + u * NWARPS;
      if (s >= nsteps) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int br = 8 * s + t + 4 * h;  // byte row within the slab
        if (GROUPED) sc.at(a, kb0 + br, col);
        const uint32_t wv[4] = {raw[u][h].x, raw[u][h].y, raw[u][h].z, raw[u][h].w};
        float lo[16], hi[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t byte = (wv[j / 4] >> (8 * (j % 4))) & 0xFFu;
          lo[j] = vv::lo_nib(byte);
          hi[j] = vv::hi_nib(byte);
          if (GROUPED) {
            lo[j] *= __uint_as_float(sc.s[j]);
            hi[j] *= __uint_as_float(sc.s[j]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r < rows) {
            const float2 xv = *reinterpret_cast<const float2*>(xs + r * ldx + 2 * br);
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(xv.y, hi[j], fmaf(xv.x, lo[j], acc[r][j]));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) raw[u][0] = nxt[u][0], raw[u][1] = nxt[u][1];
  }
}

// y[m, c] from its fp32 sum and the column's per-channel scale (1 per group)
template <typename T>
__device__ __forceinline__ void finish(const Args& a, int m, int c, float s, float col_scale) {
  static_cast<T*>(a.out)[static_cast<size_t>(m) * a.N + c] = vv::from_f<T>(s * col_scale);
}

template <typename T, bool GROUPED>
__global__ void __launch_bounds__(THREADS) int4_matmul_kernel(const Args a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int MT = Tile<T>::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, split = blockIdx.y;
  const int c0 = tile * COLS;
  const int kb0 = split * a.KBR;
  const int nrows = min(a.KBR, a.K / 2 - kb0);  // byte rows of the slab (>= 1)
  const int nsteps = (nrows + 7) / 8;
  const int ldx = Tile<T>::ldx((a.KBR + 7) / 8);
  const int mtr = min(MT, a.M);
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + xs_bytes<T>(a.M, a.KBR));  // [NWARPS][mtr][COLS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int col = c0 + 16 * g;
  const bool aligned = a.N % 16 == 0;
  static_assert(COLS == THREADS, "thread i finishes column i of the tile");
  const int cfin = c0 + threadIdx.x;  // the column this thread finishes
  const float col_scale = a.G == 1 && cfin < a.N ? __ldg(a.scale + cfin) : 1.f;

  // the first loads go out before x is staged
  uint4 raw[BATCH][2];
  load_batch(a.packed + static_cast<size_t>(kb0) * a.N, warp, nsteps, nrows, col, a.N, aligned,
             raw);
  const T* x = static_cast<const T*>(a.x);
  const int kw = 16 * nsteps;

  const int m0 = blockIdx.z * MT, rows = min(MT, a.M - m0);
  {
    // x's slice of this pass: rows [m0, m0 + rows), the slab's k range, in
    // 16-byte chunks (all of a thread's loads before its stores) where x's
    // rows are 16-byte aligned
    constexpr int V = 16 / sizeof(T);  // elements per chunk
    if (a.K % V == 0) {
      constexpr int PER = 4;  // chunks a thread has in flight
      const int chunks = rows * kw / V;
      for (int e0 = threadIdx.x; e0 < chunks; e0 += PER * THREADS) {
        uint4 v[PER];
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int e = e0 + u * THREADS, r = e / (kw / V), c = (e % (kw / V)) * V;
          v[u] = e < chunks && c < 2 * nrows
                     ? __ldg(reinterpret_cast<const uint4*>(
                           x + static_cast<size_t>(m0 + r) * a.K + 2 * kb0 + c))
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int e = e0 + u * THREADS, r = e / (kw / V), c = (e % (kw / V)) * V;
          if (e < chunks) *reinterpret_cast<uint4*>(xs + r * ldx + c) = v[u];
        }
      }
    } else {
      for (int e = threadIdx.x; e < rows * kw; e += THREADS) {
        const int r = e / kw, c = e % kw;
        xs[r * ldx + c] = c < 2 * nrows ? x[static_cast<size_t>(m0 + r) * a.K + 2 * kb0 + c]
                                        : vv::from_f<T>(0.f);
      }
    }
    __syncthreads();
    if constexpr (kBf16) {
      float acc[16][4];
      slab_bf16<GROUPED>(a, xs, ldx, m0, kb0, nrows, nsteps, col, aligned, raw, acc);
      float* rw = red + warp * mtr * COLS;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), c = 16 * (2 * t + (e & 1)) + j;
          if (r < rows) rw[r * COLS + c] = acc[j][e];
        }
      }
    } else {
      float acc[4][16];
      slab_f32<GROUPED>(a, xs, ldx, m0, kb0, nrows, nsteps, col, aligned, raw, acc);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 1);
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 2);
        }
      if (t == 0) {
        float* rw = red + warp * mtr * COLS;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r < rows)
#pragma unroll
            for (int j = 0; j < 16; ++j) rw[r * COLS + 16 * g + j] = acc[r][j];
      }
    }
    __syncthreads();
    // the 4 warps' sums, in warp order, into warp 0's slot
    for (int e = threadIdx.x; e < rows * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[(w * mtr + r) * COLS + c];
      if (a.ksplit == 1) {
        if (c0 + c < a.N) finish<T>(a, m0 + r, c0 + c, s, col_scale);
      } else {
        red[r * COLS + c] = s;
      }
    }
  }
  if (a.ksplit == 1) return;

  // the splits of a (column tile, row pass) are one cluster: each CTA adds
  // every split's sums (read from their shared memory, in split order) for
  // its share of the outputs, then waits until no CTA reads its own
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* peer[MAX_SPLITS];
#pragma unroll
  for (int q = 0; q < MAX_SPLITS; ++q)
    peer[q] = q < a.ksplit ? cluster.map_shared_rank(red, q) : red;
  for (int e = split * THREADS + threadIdx.x; e < rows * COLS; e += a.ksplit * THREADS) {
    const int r = e / COLS, c = c0 + e % COLS;  // e % COLS == threadIdx.x
    if (c >= a.N) continue;
    float v[MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) v[q] = q < a.ksplit ? peer[q][e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) sum += v[q];
    finish<T>(a, m0 + r, c, sum, col_scale);
  }
  cluster.sync();
}

template <typename T, bool GROUPED>
int launch(const Args& a, cudaStream_t stream) {
  void (*kern)(Args) = int4_matmul_kernel<T, GROUPED>;
  const size_t smem = smem_bytes<T>(a.M, a.KBR);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + COLS - 1) / COLS, a.ksplit, (a.M + Tile<T>::MT - 1) / Tile<T>::MT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.ksplit;  // the K splits of a tile: one cluster
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// KBR is a multiple of 8 and every split holds at least one byte row:
// (ksplit - 1) * KBR < K / 2 <= ksplit * KBR, with at most 8 splits (one
// portable cluster).  G scale rows: 1 (per channel) or K / gs (per group of an even gs).
extern "C" int vv_int4_matmul(const void* x, const void* packed, const void* scale, void* out,
                              int M, int K, int N, int G, int KBR, int ksplit, int dtype,
                              void* stream) {
  if (M <= 0 || M > 128 || K <= 0 || K % 2 || N <= 0 || G <= 0) return -1;
  if (KBR <= 0 || KBR % 8) return -2;
  if (ksplit < 1 || ksplit > MAX_SPLITS || (ksplit - 1) * KBR >= K / 2 || ksplit * KBR < K / 2) return -3;
  const bool grouped = G > 1;
  if (grouped && (K % G || (K / G) % 2)) return -4;
  const size_t xs = dtype == 0 ? xs_bytes<float>(M, KBR) : xs_bytes<__nv_bfloat16>(M, KBR);
  if (xs > XS_BYTES) return -2;
  Args a{x, static_cast<const int8_t*>(packed), static_cast<const float*>(scale), out,
         M, K, N, G, KBR, ksplit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return grouped ? launch<float, true>(a, st) : launch<float, false>(a, st);
  if (dtype == 1) {
    return grouped ? launch<__nv_bfloat16, true>(a, st) : launch<__nv_bfloat16, false>(a, st);
  }
  return -5;  // unsupported dtype
}
