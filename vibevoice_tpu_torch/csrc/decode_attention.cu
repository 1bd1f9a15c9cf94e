// Split-K decode attention over the stacked KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `vibevoice_tpu/ops/decode_attention.py:decode_attention`
// (Pallas body `_kernel`): one query per row, q [B, H, D], attends over layer
// `layer` of the full stacked cache k/v [L, B, S, KVH*D] with GQA (G = H/KVH
// query heads per KV head), masked by visible [B, S]; slots at or past
// lengths[b] are never read.  Softmax in fp32.  With an int8 cache the
// per-slot scales k_scale/v_scale [L, B, 8, S] (row 0 is read) multiply the
// logits and the probabilities, as on the TPU.
//
// Bound: decode reads every live K/V row of the layer once and does ~4*G flops
// per cache element, far below the card's ~295 flop/byte ridge, so the least
// time is the bytes of the live prefix, 2 * B * lengths * KVH*D * elem (+ the
// 2-byte scales per slot when int8), over 3.35 TB/s.  At decode B*KVH is only
// 2-16, so the TPU's grid (B, S/2048) would occupy a handful of the 132 SMs.
// This kernel instead splits the live prefix into CHUNK-slot chunks: each
// block runs one (row, kv-head, chunk) for its G query heads, and a second
// small kernel merges the chunks' partial softmaxes.  Blocks whose chunk
// starts at or past lengths[b] exit at once, so reads follow the live length,
// not S.  The layer is read in place through its offset in the stacked cache:
// no per-layer slice copy.
//
// Inside a block, three passes over the chunk, none of which reduces across a
// warp per slot: (1) one slot per thread computes its G logits from its K row
// (vector loads, q in shared memory); (2) one warp per head takes the chunk's
// max and sum of exponentials; (3) each warp accumulates P.V over a quarter of
// the slots with the head dim across its lanes, and the warps' sums meet in
// shared memory.  All loads of a pass are independent of its arithmetic, so
// they are in flight together.  wgmma/TMA are left for a later version.
//
// Plain C interface, loaded with ctypes; dtype codes: 0 float32, 1 bfloat16,
// 2 int8 (cache only).  Returns 0, a negative code for arguments it does not
// take, or the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS;  // cache slots per block: one per thread in pass 1
constexpr int MAX_G = 8;        // query heads per KV head (1.5B: 6, 7B: 7)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// One vector load of VEC consecutive elements, converted to fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(pk.v[i]);
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

// grid (n_chunks, KVH, B), THREADS threads; writes one partial (m, l, acc)
// per query head for this chunk.
template <typename TQ, typename TKV, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS)
split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const __nv_bfloat16* __restrict__ ks,
             const __nv_bfloat16* __restrict__ vs, const int* __restrict__ visible,
             const int* __restrict__ lengths, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int B, int H, int KVH, int S, int layer,
             int n_chunks, float scale) {
  constexpr int KV8 = 8;      // cache elements per vector load in pass 1
  constexpr int VEC = D / 32;  // head-dim elements per lane in pass 3
  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int len = min(max(lengths[b], 0), S);
  const int start = c * CHUNK;
  if (start >= len) return;  // past the live prefix: nothing to read or write
  const int n = min(CHUNK, len - start);  // live slots of this chunk
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const size_t F = static_cast<size_t>(KVH) * D;

  __shared__ float q_s[MAX_G][D];       // q of this KV head's G query heads, scaled
  __shared__ float p_s[MAX_G][CHUNK];   // logits, then probabilities (times v's scale)
  __shared__ float m_s[MAX_G], l_s[MAX_G];
  __shared__ float acc_s[WARPS][MAX_G][D];

  for (int i = t; i < G * D; i += THREADS)
    q_s[i / D][i % D] = to_f(q[(static_cast<size_t>(b) * H + hk * G) * D + i]) * scale;

  const size_t slot0 = (static_cast<size_t>(layer) * B + b) * S + start;
  const TKV* kb = k + slot0 * F + hk * D;
  const TKV* vb = v + slot0 * F + hk * D;
  const size_t scale0 = (static_cast<size_t>(layer) * B + b) * 8 * S + start;
  __syncthreads();

  // pass 1: thread t takes slot start + t
  {
    float dot[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) dot[g] = 0.f;
    const bool live = t < n && visible[static_cast<size_t>(b) * S + start + t] != 0;
    if (t < n) {
      const TKV* kr = kb + static_cast<size_t>(t) * F;
#pragma unroll
      for (int i = 0; i < D; i += KV8) {
        float kv[KV8];
        load_vec<TKV, KV8>(kr + i, kv);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
#pragma unroll
            for (int j = 0; j < KV8; ++j) dot[g] += q_s[g][i + j] * kv[j];
          }
        }
      }
    }
    const float ksc = (QUANT && t < n) ? __bfloat162float(ks[scale0 + t]) : 1.f;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) p_s[g][t] = live ? dot[g] * ksc : NEG_INF;
    }
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
      p_s[g][s] = (QUANT && s < n) ? p * __bfloat162float(vs[scale0 + s]) : p;
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
    for (int g = 0; g < MAX_G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
    }
    const int s_lo = warp * (CHUNK / WARPS);
    const int s_hi = min(s_lo + CHUNK / WARPS, n);
#pragma unroll 8
    for (int s = s_lo; s < s_hi; ++s) {
      float vr[VEC];
      load_vec<TKV, VEC>(vb + static_cast<size_t>(s) * F + lane * VEC, vr);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float p = p_s[g][s];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] += p * vr[i];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc_s[warp][g][lane * VEC + i] = acc[g][i];
      }
    }
  }
  __syncthreads();

  for (int idx = t; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += acc_s[w][g][d];
    const size_t o = (static_cast<size_t>(b) * H + hk * G + g) * n_chunks + c;
    part_acc[o * D + d] = a;
    if (d == 0) {
      part_ml[o * 2] = m_s[g];
      part_ml[o * 2 + 1] = l_s[g];
    }
  }
}

// grid (H, B), D threads: merge the live chunks' partials of one (row, head).
template <typename TO, int D>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               const int* __restrict__ lengths, TO* __restrict__ out, int H, int S,
               int n_chunks) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(max(lengths[b], 0), S);
  const int nc = min((len + CHUNK - 1) / CHUNK, n_chunks);
  const size_t base = (static_cast<size_t>(b) * H + h) * n_chunks;
  // two passes (the maximum, then the weighted sums), so that no load waits
  // on the arithmetic of the chunk before it
  float mx = NEG_INF;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) mx = fmaxf(mx, part_ml[(base + c) * 2]);
  float ls = 0.f, a = 0.f;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) {
    const float e = expf(part_ml[(base + c) * 2] - mx);
    a += e * part_acc[(base + c) * D + d];
    ls += e * part_ml[(base + c) * 2 + 1];
  }
  out[(static_cast<size_t>(b) * H + h) * D + d] = from_f<TO>(a / fmaxf(ls, 1e-30f));
}

template <typename TQ, typename TKV, int D, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const int* visible, const int* lengths, void* out, float* part_acc,
           float* part_ml, int B, int H, int KVH, int S, int layer, int n_chunks,
           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  split_kernel<TQ, TKV, D, QUANT><<<dim3(n_chunks, KVH, B), THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const __nv_bfloat16*>(ks), static_cast<const __nv_bfloat16*>(vs),
      visible, lengths, part_acc, part_ml, B, H, KVH, S, layer, n_chunks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<TQ, D><<<dim3(H, B), D, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<TQ*>(out), H, S, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_types(int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const int* visible, const int* lengths,
                   void* out, float* part_acc, float* part_ml, int B, int H, int KVH,
                   int S, int layer, int n_chunks, cudaStream_t stream) {
#define VV_LAUNCH(TQ, TKV, QUANT)                                                  \
  return launch<TQ, TKV, D, QUANT>(q, k, v, ks, vs, visible, lengths, out, part_acc, \
                                   part_ml, B, H, KVH, S, layer, n_chunks, stream)
  if (q_dtype == 0 && kv_dtype == 0) VV_LAUNCH(float, float, false);
  if (q_dtype == 1 && kv_dtype == 1) VV_LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
  if (q_dtype == 0 && kv_dtype == 2) VV_LAUNCH(float, int8_t, true);
  if (q_dtype == 1 && kv_dtype == 2) VV_LAUNCH(__nv_bfloat16, int8_t, true);
#undef VV_LAUNCH
  return -3;  // unsupported dtype pair
}

}  // namespace

// n_chunks must be ceil(S / 128): the partial buffers are [B, H, n_chunks, D]
// and [B, H, n_chunks, 2] fp32.
extern "C" int vv_decode_attention(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const int* visible, const int* lengths, void* out,
                                   float* part_acc, float* part_ml, int B, int H, int KVH,
                                   int D, int S, int L, int layer, int n_chunks,
                                   int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || H / KVH > MAX_G) return -1;
  if (layer < 0 || layer >= L || n_chunks != (S + CHUNK - 1) / CHUNK) return -2;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) return -4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dispatch_types<64>(q_dtype, kv_dtype, q, k, v, k_scale, v_scale, visible,
                              lengths, out, part_acc, part_ml, B, H, KVH, S, layer,
                              n_chunks, st);
  if (D == 128)
    return dispatch_types<128>(q_dtype, kv_dtype, q, k, v, k_scale, v_scale, visible,
                               lengths, out, part_acc, part_ml, B, H, KVH, S, layer,
                               n_chunks, st);
  return -5;  // unsupported head dim
}
