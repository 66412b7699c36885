// Fused bias + activation + gain + clamp for Hopper (sm_90a): kernel K10.
//
// Replaces the Pallas TPU kernel yume_tpu/ops/bias_act.py::_kernel (launched
// by _forward_pallas). Same math as the plain version
// (ops/bias_act.py::bias_act_plain), in fp32 with one cast at the end:
//   y = clamp(act(float(x) + b[c], alpha) * gain, -clamp, clamp)
// where c is the channel of the element, b is fp32, and clamp < 0 means no
// clamp. The activations follow the JAX package's formulas: softplus as
// max(x, 0) + log1p(exp(-|x|)) (jax.nn.softplus is logaddexp(x, 0)), elu and
// selu through expm1, sigmoid as 1 / (1 + exp(-x)); elu ignores alpha and
// selu has fixed constants, as there. No fast-math intrinsics.
//
// Layout: x is contiguous and viewed as [outer, C, inner], so the channel of
// flat index i is (i / inner) % C. The channels-last case (dim = -1, inner =
// 1: the discriminator's [B, L, 384]) and NCHW with dim = 1 (inner = H * W:
// filtered_lrelu) both run without a permute copy; the TPU kernel instead
// transposed every input to [rows, C].
//
// What bounds it on the H100: one read of x and one write of y, a few
// operations per element: HBM bandwidth. Design: a grid-stride loop over
// 16-byte vectors (4 fp32 or 8 bf16/fp16 values) when x and y are 16-byte
// aligned, with one integer division per vector for the channel of its first
// element and a carry from there; the elements past the last whole vector,
// or all of them when x is not aligned, take a scalar loop. The activation
// is a template parameter (9 instantiations per dtype, chosen on the host);
// alpha, gain and clamp are run-time values.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the order of ACT_CODES in ops/bias_act.py
enum Act { LINEAR, RELU, LRELU, TANH, SIGMOID, ELU, SELU, SOFTPLUS, SWISH };

constexpr float SELU_L = 1.0507009873554805f;
constexpr float SELU_A = 1.6732632423543772f;
constexpr int THREADS = 256;

template <int A>
__device__ __forceinline__ float activate(float x, float alpha) {
  if constexpr (A == LINEAR) return x;
  if constexpr (A == RELU) return fmaxf(x, 0.0f);
  if constexpr (A == LRELU) return x >= 0.0f ? x : alpha * x;
  if constexpr (A == TANH) return tanhf(x);
  if constexpr (A == SIGMOID) return 1.0f / (1.0f + expf(-x));
  if constexpr (A == ELU) return x >= 0.0f ? x : expm1f(x);
  if constexpr (A == SELU) return SELU_L * (x >= 0.0f ? x : SELU_A * expm1f(x));
  if constexpr (A == SOFTPLUS) return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  if constexpr (A == SWISH) return 1.0f / (1.0f + expf(-x)) * x;
  return x;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T, int A>
__device__ __forceinline__ T apply(T v, const float* __restrict__ b, int c, float alpha,
                                   float gain, float clamp) {
  float x = to_f32(v);
  if (b != nullptr) x += b[c];
  float y = activate<A>(x, alpha) * gain;
  if (clamp >= 0.0f) y = fminf(fmaxf(y, -clamp), clamp);
  return from_f32<T>(y);
}

template <typename T, int A>
__global__ void __launch_bounds__(THREADS)
bias_act_kernel(const T* __restrict__ x, const float* __restrict__ b, T* __restrict__ y,
                long long n, long long C, long long inner, float alpha, float gain,
                float clamp, int vectorized) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long scalar_from = 0;
  if (vectorized) {
    const long long nvec = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long i = tid; i < nvec; i += stride) {
      const long long i0 = i * V;
      long long r = i0 % inner;  // position within the inner run
      int c = static_cast<int>((i0 / inner) % C);
      uint4 raw = xv[i];
      T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        vals[j] = apply<T, A>(vals[j], b, c, alpha, gain, clamp);
        if (++r == inner) {  // the next element starts the next channel
          r = 0;
          if (++c == C) c = 0;
        }
      }
      yv[i] = raw;
    }
    scalar_from = nvec * V;
  }
  for (long long i = scalar_from + tid; i < n; i += stride) {
    const int c = static_cast<int>((i / inner) % C);
    y[i] = apply<T, A>(x[i], b, c, alpha, gain, clamp);
  }
}

template <typename T>
cudaError_t launch(int act, const void* x, const float* b, void* y, long long n,
                   long long C, long long inner, float alpha, float gain, float clamp,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vectorized = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long work = vectorized ? n / V + V : n;  // vectors plus the scalar tail
  // enough blocks to fill 132 SMs at 8 blocks each; the loop covers the rest
  const long long blocks_needed = (work + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(blocks_needed < 132 * 8 ? blocks_needed : 132 * 8);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (act) {
#define YUME_ACT(A)                                                                \
  case A:                                                                          \
    bias_act_kernel<T, A><<<blocks, THREADS, 0, s>>>(xt, b, yt, n, C, inner, alpha, \
                                                     gain, clamp, vectorized);     \
    break;
    YUME_ACT(LINEAR)
    YUME_ACT(RELU)
    YUME_ACT(LRELU)
    YUME_ACT(TANH)
    YUME_ACT(SIGMOID)
    YUME_ACT(ELU)
    YUME_ACT(SELU)
    YUME_ACT(SOFTPLUS)
    YUME_ACT(SWISH)
#undef YUME_ACT
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x and y contiguous with n elements, viewed as [n / (C * inner), C, inner];
// b fp32 [C] or null; dtype 0 fp32, 1 bf16, 2 fp16; act as enum Act; clamp
// < 0 for none.
extern "C" int yume_bias_act(const void* x, const void* b, void* y, long long n,
                             long long C, long long inner, int dtype, int act,
                             float alpha, float gain, float clamp, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (C <= 0 || inner <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  switch (dtype) {
    case 0:
      return launch<float>(act, x, bf, y, n, C, inner, alpha, gain, clamp, s);
    case 1:
      return launch<__nv_bfloat16>(act, x, bf, y, n, C, inner, alpha, gain, clamp, s);
    case 2:
      return launch<__half>(act, x, bf, y, n, C, inner, alpha, gain, clamp, s);
    default:
      return cudaErrorInvalidValue;
  }
}
