// Shared helpers of the port's warp-a-row kernels (sm_90a): K2
// (adaln_norm.cu) and K4 (qk_norm_rope.cu). A warp takes a row of W-element
// chunks, 16-byte vectors where the row is aligned; lane l takes chunks
// l + 32 i. Everything sits in an anonymous namespace, so each translation
// unit keeps its own copy and the library exports none of it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int SMEM_BYTES = 232448;  // an H100 block's shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// fp32 rounded once to T
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same_v<T, __half>) {
    return __float2half_rn(v);
  } else {
    return v;
  }
}

// W consecutive elements of a row: one or more 16-byte vectors, or fewer
// bytes on an unaligned path
template <typename T, int W>
struct alignas(sizeof(T) * W) Chunk {
  T v[W];
};

template <typename T, int W>
__device__ __forceinline__ Chunk<T, W> load_chunk(const T* p) {
  Chunk<T, W> c;
  if constexpr (sizeof(Chunk<T, W>) == 16) {
    *reinterpret_cast<uint4*>(&c) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) c.v[e] = p[e];
  }
  return c;
}

template <typename T, int W>
__device__ __forceinline__ void store_chunk(T* p, const Chunk<T, W>& c) {
  if constexpr (sizeof(Chunk<T, W>) % 16 == 0) {
    // written once: evict first
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(Chunk<T, W>) / 16); ++i)
      __stcs(reinterpret_cast<uint4*>(p) + i, reinterpret_cast<const uint4*>(&c)[i]);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) p[e] = c.v[e];
  }
}

// N consecutive fp32 values, as float4 / float2 loads where N allows (the
// caller keeps p aligned to 4 N bytes, at most 16)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + e);
      out[e] = f.x, out[e + 1] = f.y, out[e + 2] = f.z, out[e + 3] = f.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + e);
      out[e] = f.x, out[e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = p[e];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// Launch `kernel` on `rows` rows, a warp a row, with `threads` threads and
// `smem` bytes a CTA: at most as many CTAs as fit on the SMs
// (`ctas_per_sm`; 0: ask the occupancy calculator) and no more than the
// rows need
template <typename K, typename P>
cudaError_t launch_rows(K kernel, const P& p, long long rows, int threads, int smem,
                        int ctas_per_sm, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && ctas_per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas_per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (ctas_per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long needed = (rows + threads / 32 - 1) / (threads / 32);
  const long long fit = static_cast<long long>(sms) * ctas_per_sm;
  kernel<<<static_cast<int>(needed < fit ? needed : fit), threads, smem, s>>>(p);
  return cudaGetLastError();
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace
