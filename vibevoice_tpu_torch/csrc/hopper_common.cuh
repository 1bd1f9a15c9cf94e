// Hopper helpers shared by the cluster kernels (fused_block_chain.cu's
// chain_q_kernel and chain_p_kernel, fused_head.cu): mbarriers, the bulk-copy
// engine, boxes of a 2-D tensor map, cp.async (also completing on an
// mbarrier), a grid-wide barrier inside a cluster launch, the exact fp32
// nibbles of packed int4 bytes, rows' RMS scales summed over a cluster's
// ranks, and the tensor-map encoder reached through the runtime (no -lcuda).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_common.cuh"

namespace cg = cooperative_groups;

namespace vv {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// all but the newest N groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an mbarrier whose phase completes after `count` arrivals (and the bytes
// they expect)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
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
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// shared-memory reads of the generic proxy before the async proxy's writes
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// `bytes` (a multiple of 16) global -> shared by the bulk-copy engine,
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// a box of the 2-D tensor map at (column x, row y) -> shared, completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// An L2 policy under which the lines a copy brings in are evicted first:
// for bytes read once per call (streamed weights), so that they do not push
// out of L2 what is read again.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// bulk_copy and tma_box under an L2 policy
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// The 8 signed nibbles of 4 packed bytes as fp32, exactly: byte j gives
// lo[j] (weight row 2i) and hi[j] (row 2i + 1).  nibble ^ 8 (its value + 8)
// goes into the low byte of 2^23 (prmt), and 2^23 + 8 is subtracted: no
// int-to-float conversion (quarter rate).
__device__ __forceinline__ void nibbles_f32(uint32_t w, float (&lo)[4], float (&hi)[4]) {
  const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = __uint_as_float(prmt(l, 0x4B000000u, 0x7540u + j)) - 8388616.f;
    hi[j] = __uint_as_float(prmt(h, 0x4B000000u, 0x7540u + j)) - 8388616.f;
  }
}

// Grid-wide barrier on a counter in device memory (the algorithm of
// cooperative groups' grid.sync: block 0 adds 2^31 - (n - 1), the others 1,
// so the counter's top bit flips once all have arrived and its low bits are
// back to 0).  Every CTA of the grid is resident: the grid is sized by the
// occupancy of the cluster launch.  A barrier that is not reached within
// seconds traps rather than hanging the card.  `sync()` is the barrier of
// the CTA's threads that take part (thread 0 among them): all of them unless
// given.
template <typename Sync>
__device__ inline void grid_barrier(unsigned int* bar, Sync sync) {
  sync();
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
  sync();
}
__device__ inline void grid_barrier(unsigned int* bar) {
  grid_barrier(bar, [] { __syncthreads(); });
}

// Global -> shared copies of the widths the tensor map and the bulk-copy
// engine do not take: cp.async (committed by the caller) in vectors of 16, 8
// or 4 bytes, the widest the addresses and sizes allow, plain byte copies
// otherwise.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int vw, bool live) {
  const uint32_t d = smem_u32(dst), n = live ? vw : 0;  // n = 0: zeros
  if (vw == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (vw == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued so far has
// landed (the mbarrier counts one arrival per thread that calls this).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// (Block-wide, NW warps.)  This rank's sum of squares over its columns of each row r < rows of `buf`
// ([rows][ld]; sums over 32 columns, added in column order), into slot `rank` of
// every cluster peer's exchange `xch`.  The caller syncs the cluster, then
// calls row_scales.
template <int NW>
__device__ inline void rank_sumsq(cg::cluster_group& cl, const float* buf, int ld, int rows,
                                  int w, float* nrm, float* xch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  // the warps take chunks of 32 columns of one row (the last of a row
  // short), every row's chunks in order; nrm holds one sum per chunk
  const int per = (w + 31) / 32;
  for (int k = warp; k < rows * per; k += NW) {
    const int r = k / per, c = (k % per) * 32 + lane;
    const float v = c < w ? buf[r * ld + c] : 0.f;
    const float s = warp_sum(v * v);
    if (lane == 0) nrm[k] = s;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    float t = 0.f;
    for (int k = 0; k < per; ++k) t += nrm[threadIdx.x * per + k];
    for (int p = 0; p < C; ++p) cl.map_shared_rank(xch, p)[rank * rows + threadIdx.x] = t;
  }
}

// rs[r] = 1 / sqrt(mean over the row + eps), the C ranks' sums added in rank
// order, so every CTA of the grid gets the same bits.
__device__ inline void row_scales(int C, const float* xch, int rows, int D, float eps, float* rs) {
  if (threadIdx.x < rows) {
    float t = 0.f;
    for (int p = 0; p < C; ++p) t += xch[p * rows + threadIdx.x];
    rs[threadIdx.x] = 1.f / sqrtf(t / D + eps);
  }
  __syncthreads();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
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

// A 2-D tensor map over `base`: [rows][cols] elements of `type` (`esize`
// bytes each), row stride `cols` elements, boxes of [box_rows][box_cols]
// elements; reads past the edges give zeros.  Returns 0, -6 if the driver has
// no encoder, -7 if it refuses the map.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, uint32_t esize, const void* base,
                     uint64_t cols, uint64_t rows, uint32_t box_cols, uint32_t box_rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return -6;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -7;
}

// encode_2d over bytes ([rows][cols] of uint8)
inline int encode_u8_2d(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                        uint32_t box_cols, uint32_t box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, cols, rows, box_cols, box_rows);
}

}  // namespace vv
