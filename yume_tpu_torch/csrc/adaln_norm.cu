// AdaLN LayerNorm for Hopper (sm_90a): kernel K2.
//
// Replaces the Pallas TPU kernel yume_tpu/ops/fused_adaln.py::
// _adaln_norm_kernel (launched by _adaln_norm_p). Same math as the plain
// version (ops/fused_adaln.py::_adaln_norm_ref), for each token row x of
// length D, with k = idx[b, l] (0 without idx) and s, t the fp32 scale and
// shift tables [B or 1, K, D]:
//   mu  = sum(x) / D
//   var = sum((x - mu)^2) / D                two passes over the row
//   n   = (x - mu) * rsqrt(var + eps)
//   out = n * (gate + s[b, k]) + t[b, k]     fp32, rounded once to out's dtype
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into an FMA), as the plain version's separate elementwise
// operations are; only the order of the two sums differs. gate + s is
// formed once a staged table row, which rounds the same. The TPU kernel's
// one-hot dot that picks a row out of the table was a Mosaic workaround and
// is not carried over.
//
// What bounds it on the H100: each element of x is read once and each
// output element written once, with a few fp32 operations an element: HBM
// bandwidth. At the 5B segment's [1, 12095, 3072] bf16 with K = 2 that is
// 2 x 74.3 MB plus the tables once, 0.044 ms at 3.35 TB/s. A kernel that
// reads both table rows of its token for every token (the Triton kernel
// it replaces) also pulls 2 x 12,288 bytes a row out of L2, ~297 MB a call,
// twice the traffic that sets the bound. Design:
//  * Staged kernel (every aligned call whose tables and rows fit): one
//    persistent CTA on each SM. The (gate + scale) and shift rows of every
//    table row its tokens can use (K rows, or B x K for per-batch tables)
//    are staged in shared memory once a CTA, so the table traffic is 132
//    reads of 2 K D fp32 values from L2 whatever the token count. Within a
//    staged row the values are laid out so that the float4 a lane reads
//    for its chunk sits next to its neighbour's (no bank conflict).
//  * As many warps as the shared memory left holds (14 at the 5B width
//    with K = 2, bf16), a warp a row: each warp walks its rows with two
//    buffers, so cp.async brings its next row (and a plain load the row's
//    idx) in while it reduces and writes the current one out of shared
//    memory; a thread holds no row in registers. A lane copies and reads
//    only its own 16-byte vectors, so it waits for its own copies alone,
//    and the sums are reduced across the warp by __shfl_xor_sync: no
//    barrier on the row path. Outputs leave by streaming stores.
//  * Row kernel (the rest: a pointer or D that does not keep every vector
//    16-byte aligned, tables too large to stage, or rows too wide): a warp
//    a row, read three times from device memory (twice from the cache), in
//    vectors or one element at a time, its table rows read from device
//    memory.
// An idx outside [0, K) is clamped into it, so no read leaves the tables.

#include "rows.cuh"

namespace {

constexpr int STAGES = 2;            // row buffers a warp (staged kernel)
constexpr int MAX_WARPS = 16;        // a staged CTA
constexpr int MIN_STAGED_WARPS = 4;  // fewer fit: the row kernel
constexpr int ROW_WARPS = 8;         // a row-kernel CTA

struct Params {
  const void* x;
  const int* idx;  // [B, L], or null: row 0 everywhere
  const float* s;  // [B or 1, K, D]
  const float* t;
  void* out;
  long long tokens;  // B * L
  int L, D, K;
  long long tab_b;   // the tables' batch stride in elements (0: shared)
  float eps, gate;
};

// Row r's idx as loaded, and clamped into [0, K) where it is used (the
// staged kernel loads it a row ahead)
__device__ __forceinline__ int load_index(const Params& p, long long r) {
  return p.idx ? p.idx[r] : 0;
}

__device__ __forceinline__ int clamp_index(const Params& p, int k) {
  return k < 0 ? 0 : (k < p.K ? k : p.K - 1);
}

// One row, read through chunk(j) three times: its sum, its sum of squared
// deviations, then each chunk normalised, modulated through mod(j, g, t)
// (gate + scale and shift of chunk j) and written
template <typename T, typename O, int W, typename ChunkAt, typename ModAt>
__device__ __forceinline__ void do_row(const Params& p, long long r, ChunkAt chunk, ModAt mod,
                                       int lane) {
  const int n_chunks = p.D / W;
  const float d = static_cast<float>(p.D);
  float sum = 0.0f;
  for (int j = lane; j < n_chunks; j += 32) {
    const Chunk<T, W> x = chunk(j);
#pragma unroll
    for (int e = 0; e < W; ++e) sum = __fadd_rn(sum, to_f32(x.v[e]));
  }
  const float mu = __fdiv_rn(warp_sum(sum), d);
  float sq = 0.0f;
  for (int j = lane; j < n_chunks; j += 32) {
    const Chunk<T, W> x = chunk(j);
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float c = __fsub_rn(to_f32(x.v[e]), mu);
      sq = __fadd_rn(sq, __fmul_rn(c, c));
    }
  }
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), d), p.eps));
  O* o = static_cast<O*>(p.out) + r * p.D;
  for (int j = lane; j < n_chunks; j += 32) {
    const Chunk<T, W> x = chunk(j);
    float g[W], t[W];
    mod(j, g, t);
    Chunk<O, W> y;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float n = __fmul_rn(__fsub_rn(to_f32(x.v[e]), mu), rs);
      y.v[e] = from_f32<O>(__fadd_rn(__fmul_rn(n, g[e]), t[e]));
    }
    store_chunk(o + j * W, y);
  }
}

// Shared-memory offset, in floats within a staged table row, of the float4
// that holds elements 4h .. 4h + 3 of chunk j: the h-th float4s of all
// chunks lie together, so neighbouring lanes read neighbouring float4s
template <int W>
__device__ __forceinline__ int staged_at(int D, int j, int h) {
  return h * (4 * D / W) + 4 * j;
}

template <typename T, typename O, int W>
__global__ void __launch_bounds__(32 * MAX_WARPS) adaln_norm_staged(const Params p) {
  static_assert(W * sizeof(T) == 16 && W % 4 == 0, "a chunk is one 16-byte vector");
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int n_chunks = p.D / W;
  // (gate + scale) rows, then shift rows, then this warp's STAGES row buffers
  const long long tab_rows = p.tab_b ? p.tokens / p.L * p.K : p.K;
  float* g_s = reinterpret_cast<float*>(smem);
  float* t_s = g_s + tab_rows * p.D;
  T* buf = reinterpret_cast<T*>(t_s + tab_rows * p.D) +
           static_cast<long long>(warp) * STAGES * p.D;
  const long long n_warps = static_cast<long long>(gridDim.x) * warps;
  // cp.async of a row into a buffer; one commit group a row, empty past
  // the last, so that the group count stays in step. Returns the row's
  // idx, loaded now and clamped and used a row later, so that no row waits
  // for its load.
  const auto fetch = [&](long long r, int stage) {
    int k = 0;
    if (r < p.tokens) {
      const T* x = static_cast<const T*>(p.x) + r * p.D;
      T* dst = buf + stage * p.D;
      for (int j = lane; j < n_chunks; j += 32) cp_async16(dst + j * W, x + j * W);
      k = load_index(p, r);
    }
    cp_async_commit();
    return k;
  };
  long long r = static_cast<long long>(blockIdx.x) * warps + warp;
  int k = fetch(r, 0);  // in flight while the tables are staged
  // stage the tables: float4 q of a row holds elements 4q .. 4q + 3, in
  // chunk 4q / W at float4 h = (4q mod W) / 4 of it (they fit in shared
  // memory, so an int counts their float4s)
  const int row_f4 = p.D / 4;
  const int tab_f4 = static_cast<int>(tab_rows) * row_f4;
  for (int i = threadIdx.x; i < tab_f4; i += blockDim.x) {
    const int row = i / row_f4;
    const int q = i - row * row_f4;
    const float4 s = reinterpret_cast<const float4*>(p.s)[i];
    const float4 t = reinterpret_cast<const float4*>(p.t)[i];
    const long long at = row * p.D + staged_at<W>(p.D, 4 * q / W, (4 * q % W) / 4);
    *reinterpret_cast<float4*>(g_s + at) =
        make_float4(__fadd_rn(p.gate, s.x), __fadd_rn(p.gate, s.y), __fadd_rn(p.gate, s.z),
                    __fadd_rn(p.gate, s.w));
    *reinterpret_cast<float4*>(t_s + at) = t;
  }
  __syncthreads();
  for (int stage = 0; r < p.tokens; r += n_warps, stage ^= 1) {
    const int k_next = fetch(r + n_warps, stage ^ 1);  // in flight during this row
    cp_async_wait<1>();  // this lane's copies of this row have landed
    const T* x = buf + stage * p.D;
    const long long row = (p.tab_b ? r / p.L * p.K : 0) + clamp_index(p, k);
    const float* g_row = g_s + row * p.D;
    const float* t_row = t_s + row * p.D;
    do_row<T, O, W>(
        p, r, [&](int j) { return *reinterpret_cast<const Chunk<T, W>*>(x + j * W); },
        [&](int j, float (&g)[W], float (&t)[W]) {
#pragma unroll
          for (int h = 0; h < W / 4; ++h) {
            const float4 gv = *reinterpret_cast<const float4*>(g_row + staged_at<W>(p.D, j, h));
            const float4 tv = *reinterpret_cast<const float4*>(t_row + staged_at<W>(p.D, j, h));
            g[4 * h] = gv.x, g[4 * h + 1] = gv.y, g[4 * h + 2] = gv.z, g[4 * h + 3] = gv.w;
            t[4 * h] = tv.x, t[4 * h + 1] = tv.y, t[4 * h + 2] = tv.z, t[4 * h + 3] = tv.w;
          }
        },
        lane);
    k = k_next;
  }
  cp_async_wait<0>();
}

template <typename T, typename O, int W>
__global__ void __launch_bounds__(32 * ROW_WARPS) adaln_norm_rows(const Params p) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * ROW_WARPS;
  for (long long r = static_cast<long long>(blockIdx.x) * ROW_WARPS + (threadIdx.x >> 5);
       r < p.tokens; r += n_warps) {
    const T* x = static_cast<const T*>(p.x) + r * p.D;
    const long long tab = (p.tab_b ? r / p.L * p.tab_b : 0) +
                          static_cast<long long>(clamp_index(p, load_index(p, r))) * p.D;
    const float* s = p.s + tab;
    const float* t_row = p.t + tab;
    do_row<T, O, W>(
        p, r, [&](int j) { return load_chunk<T, W>(x + j * W); },
        [&](int j, float (&g)[W], float (&t)[W]) {
          load_f32<W>(s + j * W, g);
          load_f32<W>(t_row + j * W, t);
#pragma unroll
          for (int e = 0; e < W; ++e) g[e] = __fadd_rn(p.gate, g[e]);
        },
        lane);
  }
}

// The staged kernel where every chunk is a 16-byte vector and the tables
// leave room for enough warps, else the row kernel
template <typename T, typename O>
cudaError_t dispatch(const Params& p, cudaStream_t s) {
  constexpr int W = 16 / sizeof(T);
  const bool vectors = aligned16(p.x) && aligned16(p.out) && aligned16(p.s) &&
                       aligned16(p.t) && p.D % W == 0;
  if (!vectors)
    return launch_rows(adaln_norm_rows<T, O, 1>, p, p.tokens, 32 * ROW_WARPS, 0, 0, s);
  const long long tab_rows = p.tab_b ? p.tokens / p.L * p.K : p.K;
  const long long tables = 2 * tab_rows * p.D * 4;  // (gate + scale) and shift, fp32
  const long long per_warp = static_cast<long long>(STAGES) * p.D * sizeof(T);
  long long warps = tables < SMEM_BYTES ? (SMEM_BYTES - tables) / per_warp : 0;
  warps = warps < MAX_WARPS ? warps : MAX_WARPS;
  if (warps >= MIN_STAGED_WARPS)
    return launch_rows(adaln_norm_staged<T, O, W>, p, p.tokens, static_cast<int>(32 * warps),
                       static_cast<int>(tables + warps * per_warp), 1, s);
  return launch_rows(adaln_norm_rows<T, O, W>, p, p.tokens, 32 * ROW_WARPS, 0, 0, s);
}

}  // namespace

// x: [B, L, D] contiguous of dtype 0 fp32, 1 bf16, 2 fp16; idx: int32 [B, L]
// or null (row 0 everywhere); s, t: fp32 [B or 1, K, D] contiguous
// (tab_bstride K * D or 0); out: [B, L, D] contiguous of out_dtype, which is
// x's dtype or fp32 (0).
extern "C" int yume_adaln_norm(const void* x, const void* idx, const void* s, const void* t,
                               void* out, int B, int L, int D, int K, long long tab_bstride,
                               int dtype, int out_dtype, float eps, float gate, void* stream) {
  if (B < 0 || L < 0 || D <= 0 || K <= 0) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * L == 0) return cudaSuccess;
  const Params p{x, static_cast<const int*>(idx), static_cast<const float*>(s),
                 static_cast<const float*>(t), out, static_cast<long long>(B) * L, L, D, K,
                 B > 1 ? tab_bstride : 0, eps, gate};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 3 + out_dtype) {
    case 0 * 3 + 0:
      return dispatch<float, float>(p, st);
    case 1 * 3 + 1:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(p, st);
    case 1 * 3 + 0:
      return dispatch<__nv_bfloat16, float>(p, st);
    case 2 * 3 + 2:
      return dispatch<__half, __half>(p, st);
    case 2 * 3 + 0:
      return dispatch<__half, float>(p, st);
    default:
      return cudaErrorInvalidValue;
  }
}
