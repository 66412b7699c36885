// RMSNorm of q and k over the model dim, then RoPE, for Hopper (sm_90a):
// kernel K4.
//
// Replaces the Pallas TPU kernel
// yume_tpu/ops/fused_adaln.py::_qk_norm_rope_kernel (launched by
// _qk_norm_rope_p). Same math as the plain version
// (ops/fused_adaln.py::_qk_norm_rope_ref), for each token row x of q and of
// k, with w = w_q or w_k (fp32 [D]) and half = head_dim / 2:
//   n  = x * rsqrt(sum(x^2) / D + eps) * w            fp32
//   n  = float(T(n))                                  the RMSNorm output's
//                                                     rounding to x's dtype
//   re = n[2p] * c - n[2p+1] * s                      fp32, rounded once
//   im = n[2p] * s + n[2p+1] * c                      to x's dtype
// where c, s = cos, sin[(b,) pos, p mod half]. Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn: no contraction into an FMA),
// as the plain version's separate elementwise operations are; only the
// order of the sum of squares differs. The TPU kernel's head-tiled tables
// and lane rolls (_pair_swap) were Mosaic workarounds and are not carried
// over.
//
// What bounds it on the H100: each element of q and k is read once and
// each output element written once, with a few fp32 operations an element:
// HBM bandwidth. At the 5B segment's [1, 12095, 3072] bf16 that is 4 x 74.3
// MB plus the RoPE tables, 0.091 ms at 3.35 TB/s. Design:
//  * A row is read in 16-byte vectors (8 bf16 or fp16 values, 4 fp32:
//    whole (even, odd) pairs, so the rotation needs no shuffle); lane l of
//    a warp takes vectors l + 32 i. Its sum of squares is reduced across
//    the warp with __shfl_xor_sync: no barrier on the row path.
//  * Staged kernel (every aligned call whose rows fit): one persistent CTA
//    on each SM, as many warps as its shared memory holds (16 at the 5B
//    width). w_q and w_k are staged in shared memory once a CTA. Each warp
//    walks its rows with two buffers: while it normalises and rotates one
//    row out of shared memory, cp.async brings its next row in, so loads
//    stay in flight through the arithmetic and a thread holds no row in
//    registers. A lane copies and reads only its own vectors, so it waits
//    for its own copies alone. Token t's q and k rows go to neighbouring
//    warps, which share its cos/sin through L1 (a warp that took both
//    rows, with half as many warps, was slower on the H100).
//  * When half divides 16 W (W elements a vector) and W / 2 divides half,
//    every vector of lane l starts at the same pair index within its head,
//    so the lane loads its W / 2 cos and sin values once a row (5B and 14B:
//    head_dim 128, half 64). Other head dims look each pair's value up.
//  * q and k are read through a batch and a row stride, the last axis
//    contiguous: the W8A8 block passes the q and k column blocks of its
//    fused qkv output in place. The outputs are contiguous [B, L, D].
//  * Row kernel (the rest: a pointer, a stride or D that does not keep
//    every vector 16-byte aligned, or rows too wide to stage): a warp a
//    row, read twice from device memory (the second time from the cache),
//    in vectors, or one pair at a time when unaligned.

#include "rows.cuh"

namespace {

constexpr int STAGES = 2;            // row buffers a warp (staged kernel)
constexpr int MAX_WARPS = 16;        // a staged CTA
constexpr int MIN_STAGED_WARPS = 4;  // fewer fit: the row kernel
constexpr int ROW_WARPS = 8;         // a row-kernel CTA

// Two values rounded to T, written as one pair (bf16 and fp16: one packed
// conversion)
template <typename T>
__device__ __forceinline__ void put_pair(T* out, float a, float b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
  } else if constexpr (std::is_same_v<T, __half>) {
    *reinterpret_cast<__half2*>(out) = __floats2half2_rn(a, b);
  } else {
    out[0] = a, out[1] = b;
  }
}

template <typename T, int W>
__device__ __forceinline__ float sum_sq(const Chunk<T, W>& c) {
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const float f = to_f32(c.v[e]);
    s += f * f;
  }
  return s;
}

struct Params {
  const void* q;
  const void* k;
  const float* w_q;
  const float* w_k;
  const float* cos;
  const float* sin;
  void* oq;
  void* ok;
  long long tokens;                     // B * L
  int L, D, half;
  long long q_b, q_l, k_b, k_l, tab_b;  // strides in elements
  float eps;
  int hoist;                            // cos/sin index constant per lane
};

// Row r of the work: token r / 2's q row (r even) or k row (r odd), so
// neighbouring warps share the token's cos/sin
struct Row {
  long long t, b, pos;
  int k;  // 0 q, 1 k
};

__device__ __forceinline__ Row row_at(const Params& p, long long r) {
  Row row;
  row.t = r >> 1;
  row.b = row.t / p.L;
  row.pos = row.t - row.b * p.L;
  row.k = static_cast<int>(r & 1);
  return row;
}

template <typename T>
__device__ __forceinline__ const T* row_in(const Params& p, const Row& row) {
  return static_cast<const T*>(row.k ? p.k : p.q) + row.b * (row.k ? p.k_b : p.q_b) +
         row.pos * (row.k ? p.k_l : p.q_l);
}

// Normalised and rotated chunk j of a row (r: the row's rsqrt; w_row: its
// weight in shared memory; ct/st: the token's cos/sin rows; ch/sh: the
// lane's hoisted values when p.hoist)
template <typename T, int W>
__device__ __forceinline__ Chunk<T, W> rotate(const Chunk<T, W>& x, int j, float r,
                                              const float* w_row, const float* ct,
                                              const float* st, const float (&ch)[W / 2],
                                              const float (&sh)[W / 2], const Params& p) {
  float w[W];
  load_f32<W>(w_row + j * W, w);
  Chunk<T, W> y;
#pragma unroll
  for (int e = 0; e < W / 2; ++e) {
    // the RMSNorm output, rounded to T as the plain version's is
    alignas(2 * sizeof(T)) T n[2];
    put_pair(n, __fmul_rn(__fmul_rn(to_f32(x.v[2 * e]), r), w[2 * e]),
             __fmul_rn(__fmul_rn(to_f32(x.v[2 * e + 1]), r), w[2 * e + 1]));
    const float ne = to_f32(n[0]), no = to_f32(n[1]);
    float c, s;
    if (p.hoist) {
      c = ch[e], s = sh[e];
    } else {
      const int i = (j * (W / 2) + e) % p.half;
      c = __ldg(ct + i), s = __ldg(st + i);
    }
    put_pair(y.v + 2 * e, __fsub_rn(__fmul_rn(ne, c), __fmul_rn(no, s)),
             __fadd_rn(__fmul_rn(ne, s), __fmul_rn(no, c)));
  }
  return y;
}

// w_q and w_k into shared memory, once a CTA
__device__ __forceinline__ const float* stage_weights(const Params& p, float* w_s) {
  for (int i = threadIdx.x; i < p.D; i += blockDim.x) {
    w_s[i] = p.w_q[i];
    w_s[p.D + i] = p.w_k[i];
  }
  __syncthreads();
  return w_s;
}

// One row, read through chunk(j) twice: its sum of squares, then each
// chunk normalised, rotated and written
template <typename T, int W, typename ChunkAt>
__device__ __forceinline__ void do_row(const Params& p, const Row& row, ChunkAt chunk,
                                       const float* w_s, int lane) {
  constexpr int P = W / 2;  // pairs a chunk
  // the token's cos/sin rows, and the lane's own values when they are hoisted
  const float* ct = p.cos + row.b * p.tab_b + row.pos * p.half;
  const float* st = p.sin + row.b * p.tab_b + row.pos * p.half;
  float ch[P] = {}, sh[P] = {};
  if (p.hoist) {
    load_f32<P>(ct + (lane * P) % p.half, ch);
    load_f32<P>(st + (lane * P) % p.half, sh);
  }
  T* o = static_cast<T*>(row.k ? p.ok : p.oq) + row.t * p.D;
  const float* w_row = w_s + row.k * p.D;
  const int n_chunks = p.D / W;
  float ss = 0.0f;
  for (int j = lane; j < n_chunks; j += 32) ss += sum_sq(chunk(j));
  const float r = rsqrtf(warp_sum(ss) / static_cast<float>(p.D) + p.eps);
  for (int j = lane; j < n_chunks; j += 32)
    store_chunk(o + j * W, rotate(chunk(j), j, r, w_row, ct, st, ch, sh, p));
}

template <typename T, int W>
__global__ void __launch_bounds__(32 * MAX_WARPS) qk_norm_rope_staged(const Params p) {
  extern __shared__ float4 smem[];
  float* w_base = reinterpret_cast<float*>(smem);
  const float* w_s = stage_weights(p, w_base);  // w_q [D], then w_k [D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int n_chunks = p.D / W;
  // then this warp's STAGES row buffers
  T* buf = reinterpret_cast<T*>(w_base + 2 * p.D) + static_cast<long long>(warp) * STAGES * p.D;
  const long long rows = 2 * p.tokens;
  const long long n_warps = static_cast<long long>(gridDim.x) * warps;
  // cp.async of a row into a buffer; one commit group a row, empty past
  // the last, so that the group count stays in step
  const auto fetch = [&](long long r, int stage) {
    if (r < rows) {
      const T* x = row_in<T>(p, row_at(p, r));
      T* d = buf + stage * p.D;
      for (int j = lane; j < n_chunks; j += 32) cp_async16(d + j * W, x + j * W);
    }
    cp_async_commit();
  };
  long long r = static_cast<long long>(blockIdx.x) * warps + warp;
  fetch(r, 0);
  for (int stage = 0; r < rows; r += n_warps, stage ^= 1) {
    fetch(r + n_warps, stage ^ 1);  // in flight while this row is computed
    cp_async_wait<1>();             // this lane's copies of this row have landed
    const T* x = buf + stage * p.D;
    do_row<T, W>(p, row_at(p, r),
                 [&](int j) { return *reinterpret_cast<const Chunk<T, W>*>(x + j * W); }, w_s,
                 lane);
  }
  cp_async_wait<0>();
}

template <typename T, int W>
__global__ void __launch_bounds__(32 * ROW_WARPS) qk_norm_rope_rows(const Params p) {
  extern __shared__ float4 smem[];
  const float* w_s = stage_weights(p, reinterpret_cast<float*>(smem));  // w_q, then w_k
  const int lane = threadIdx.x & 31;
  const long long rows = 2 * p.tokens;
  const long long n_warps = static_cast<long long>(gridDim.x) * ROW_WARPS;
  for (long long r = static_cast<long long>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
       r < rows; r += n_warps) {
    const Row row = row_at(p, r);
    const T* x = row_in<T>(p, row);
    do_row<T, W>(p, row, [&](int j) { return load_chunk<T, W>(x + j * W); }, w_s, lane);
  }
}

// The staged kernel where W is a 16-byte vector and enough warps fit, else
// the row kernel
template <typename T, int W>
cudaError_t run(Params p, cudaStream_t s) {
  constexpr int P = W / 2;
  const auto aligned = [](const void* ptr, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(ptr) % n == 0;
  };
  p.hoist = p.half % P == 0 && (16 * W) % p.half == 0 && aligned(p.cos, 4 * P) &&
            aligned(p.sin, 4 * P);
  const long long weights = 8LL * p.D;  // w_q and w_k, fp32
  if constexpr (W * sizeof(T) == 16) {
    const long long per_warp = static_cast<long long>(STAGES) * p.D * sizeof(T);
    long long warps = (SMEM_BYTES - weights) / per_warp;
    warps = warps < MAX_WARPS ? warps : MAX_WARPS;
    if (warps >= MIN_STAGED_WARPS)
      return launch_rows(qk_norm_rope_staged<T, W>, p, 2 * p.tokens,
                         static_cast<int>(32 * warps),
                         static_cast<int>(weights + warps * per_warp), 1, s);
  }
  if (weights > SMEM_BYTES) return cudaErrorInvalidValue;
  return launch_rows(qk_norm_rope_rows<T, W>, p, 2 * p.tokens, 32 * ROW_WARPS,
                     static_cast<int>(weights), 0, s);
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  const bool vectors = aligned16(p.q) && aligned16(p.k) && aligned16(p.oq) && aligned16(p.ok) &&
                       p.D % W == 0 && p.q_b % W == 0 && p.q_l % W == 0 && p.k_b % W == 0 &&
                       p.k_l % W == 0;
  return vectors ? run<T, W>(p, s) : run<T, 2>(p, s);
}

}  // namespace

// q, k: [B, L, D] of dtype 0 fp32, 1 bf16, 2 fp16, last axis contiguous,
// strides in elements; w_q, w_k fp32 [D]; cos, sin fp32 [L, half]
// (tab_bstride 0) or [B, L, half] (tab_bstride L * half), contiguous; oq, ok
// contiguous [B, L, D] of q's dtype. D = heads * 2 * half.
extern "C" int yume_qk_norm_rope(const void* q, const void* k, const void* w_q, const void* w_k,
                                 const void* cos, const void* sin, void* oq, void* ok, int B,
                                 int L, int D, int half, long long q_bstride,
                                 long long q_lstride, long long k_bstride, long long k_lstride,
                                 long long tab_bstride, int dtype, float eps, void* stream) {
  if (B < 0 || L < 0 || D <= 0 || half <= 0 || D % (2 * half) != 0) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * L == 0) return cudaSuccess;
  // a stride of an axis of size 1 is never used: drop it from the alignment test
  Params p{q, k, static_cast<const float*>(w_q), static_cast<const float*>(w_k),
           static_cast<const float*>(cos), static_cast<const float*>(sin), oq, ok,
           static_cast<long long>(B) * L, L, D, half,
           B > 1 ? q_bstride : 0, L > 1 ? q_lstride : 0,
           B > 1 ? k_bstride : 0, L > 1 ? k_lstride : 0,
           B > 1 ? tab_bstride : 0, eps, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(p, s);
    case 1:
      return dispatch<__nv_bfloat16>(p, s);
    case 2:
      return dispatch<__half>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}
