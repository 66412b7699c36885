// Flash-attention backward for Hopper (sm_90a): K8 (dQ) and K9 (dK, dV),
// bf16 in / bf16 out, fp32 accumulation.
//
// Replaces the Pallas TPU kernels yume_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (reached through _bwd_impl). Same
// split and the same math: two kernels and no atomics, each recomputes
//   S = Q K^T, P = exp(S*scale - lse) (masked keys 0), dP = dO V^T,
//   dS = P * (dP - delta) * scale
// from the forward's saved lse and delta = sum_d O*dO, then
//   K8: dQ = sum over kv tiles of dS K
//   K9: dV = sum over q tiles of P^T dO, dK = sum over q tiles of dS^T Q.
// Both are deterministic: every output element is summed by one warp in a
// fixed order.
//
// Differences from the TPU kernels, on purpose:
//  * The scale multiplies the fp32 scores S, as the forward kernel K1
//    (csrc/flash_attention.cu) does, so P is exactly the softmax the forward
//    normalised (the TPU backward recomputes from the unscaled q while its
//    forward used a bf16-rounded scaled q).
//  * P and dS are rounded to bf16 before their products on the tensor cores
//    (the TPU dQ kernel rounds dS too; its dK/dV kernel keeps fp32).
//  * q, k, v, dO and the outputs are read and written through their
//    [B, L, N, D] strides; ragged q and kv edges are masked here. Key rows
//    at or past kv_len get zero dK/dV, and a query row with no live key gets
//    zero dQ. K9 blocks whose whole kv tile lies past kv_len write zeros and
//    stop.
//
// What bounds them on the H100: at the 5B trainer shape (2,805 tokens, 24
// heads, D = 128) K8 does 3 and K9 4 matrix products of 2*Lq*Lk*D FLOP per
// head (1.45e11 and 1.93e11 FLOP) against ~0.1 GB of traffic: tensor-core
// bound. Design: one block of 4 warps per (batch*head, 64-row tile of the
// held operand: q rows in K8, kv rows in K9); each warp owns 16 rows. The
// other operand streams through shared memory in 64-row tiles. S and dP go
// through shared memory in fp32 (nvcuda::wmma bf16 16x16x16 fragments,
// mma.sync); the elementwise pass writes bf16 P and dS in place over them
// (each warp only touches its own 16 rows), so a block needs 102.5 KB and
// two blocks fit on an SM. The accumulators (dQ; dK and dV) stay in wmma
// fragments in registers. wgmma, TMA and double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BR = 64;          // rows of the held operand per block
constexpr int BC = 64;          // rows of the streamed operand per tile
constexpr int THREADS = 128;    // 4 warps, 16 held rows each
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int LDH = D + 8;   // bf16 tile pitch
  static constexpr int LDS = BC + 4;  // fp32 score pitch
  static constexpr int LDP = BC + 8;  // bf16 pitch of P / dS written over S / dP
  static constexpr size_t held0 = 0;                            // K8: Q,  K9: K
  static constexpr size_t held1 = held0 + size_t(BR) * LDH * 2;  // K8: dO, K9: V
  static constexpr size_t str0 = held1 + size_t(BR) * LDH * 2;   // K8: K,  K9: Q
  static constexpr size_t str1 = str0 + size_t(BC) * LDH * 2;    // K8: V,  K9: dO
  static constexpr size_t s = str1 + size_t(BC) * LDH * 2;       // S, then P
  static constexpr size_t dp = s + size_t(BR) * LDS * 4;         // dP, then dS
  static constexpr size_t stats = dp + size_t(BR) * LDS * 4;     // lse*log2e, delta
  static constexpr size_t bytes = stats + 2 * 64 * 4;
};

// Copy `rows_valid` rows of a [64, D] bf16 tile (row stride in elements,
// unit stride inside a row) into shared memory; zero the remaining rows.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int rows_valid,
                                          int tid) {
  constexpr int VEC = 8;  // 8 bf16 = 16 bytes per load
  constexpr int PER_ROW = D / VEC;
  constexpr int LDH = Smem<D>::LDH;
  for (int i = tid; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) {
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// dst[16, 64] (fp32, pitch LDS) = a[16, D] . b[64, D]^T for one warp: a and b
// are row-major bf16 tiles of pitch LDH.
template <int D>
__device__ __forceinline__ void warp_abt(float* dst, const bf16* a, const bf16* b) {
  constexpr int LDH = Smem<D>::LDH, LDS = Smem<D>::LDS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BC / 16];
#pragma unroll
  for (int j = 0; j < BC / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, LDH);
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      // b^T as a column-major operand: (d, row) at b[row*LDH + d]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + (j * 16) * LDH + kk, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BC / 16; ++j) {
    wmma::store_matrix_sync(dst + j * 16, acc[j], LDS, wmma::mem_row_major);
  }
}

// acc[16, D] += a[16, 64] . b[64, D]: a is the warp's bf16 P or dS (pitch
// LDP), b a row-major bf16 tile (pitch LDH).
template <int D>
__device__ __forceinline__ void warp_ab_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    const bf16* a, const bf16* b) {
  constexpr int LDH = Smem<D>::LDH, LDP = Smem<D>::LDP;
#pragma unroll
  for (int kk = 0; kk < BC; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// The elementwise pass over one warp's 16 rows of S and dP (fp32, pitch
// LDS, starting at the warp's first row): P = exp2(S*scale_log2 - lse2) and
// dS = P*(dP - delta)*scale, written as bf16 (pitch LDP) over the same
// rows. Row r's bf16 bytes overlap only fp32 rows <= r, which are already
// in registers. lse2/delta come per row (ROW_STATS, K8) or per column (K9);
// live(r, c) says whether the (row, column) pair is a live query and key.
template <bool ROW_STATS, typename Live>
__device__ __forceinline__ void warp_softmax_grad(float* s, float* dp,
                                                  const float* lse2,
                                                  const float* delta,
                                                  float scale_log2, float scale,
                                                  int lane, Live live) {
  constexpr int LDS = BC + 4, LDP = BC + 8;
  bf16* pb = reinterpret_cast<bf16*>(s);
  bf16* dsb = reinterpret_cast<bf16*>(dp);
  for (int r = 0; r < 16; ++r) {
    float sv[2], dv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sv[h] = s[r * LDS + lane + 32 * h];
      dv[h] = dp[r * LDS + lane + 32 * h];
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const float l2 = ROW_STATS ? lse2[r] : lse2[c];
      const float de = ROW_STATS ? delta[r] : delta[c];
      const float p = live(r, c) ? exp2f(sv[h] * scale_log2 - l2) : 0.f;
      pb[r * LDP + c] = __float2bfloat16(p);
      dsb[r * LDP + c] = __float2bfloat16(p * (dv[h] - de) * scale);
    }
    __syncwarp();
  }
}

// Write a warp's [16, D] fp32 accumulator as bf16 rows row_first.. of an
// [*, D] output (row stride `row_stride`), rows >= row_end skipped; staged
// through the warp's 16 rows of `stage` (fp32, pitch LDS), 64 columns at a
// time.
template <int D>
__device__ __forceinline__ void warp_store(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    float* stage, bf16* out, long long row_stride, int row_first, int row_end,
    int lane) {
  constexpr int LDS = Smem<D>::LDS;
  constexpr int CH = D < 64 ? D : 64;
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += CH) {
#pragma unroll
    for (int j = 0; j < CH / 16; ++j) {
      wmma::store_matrix_sync(stage + j * 16, acc[c0 / 16 + j], LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH;
      const int c = i % CH;
      if (row_first + r < row_end) {
        out[(row_first + r) * row_stride + c0 + c] = __float2bfloat16(stage[r * LDS + c]);
      }
    }
    __syncwarp();
  }
}

struct Strides {
  long long b, l, n;
};

// K8: one block per (batch*head, 64 q rows); loops over the kv tiles.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_len, bf16* __restrict__ dq,
                    int N, int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dqs, float scale) {
  using L = Smem<D>;
  constexpr int LDH = L::LDH, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + L::held0);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L::held1);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::str0);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::str1);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* sdp = reinterpret_cast<float*>(smem + L::dp);
  float* lse2_s = reinterpret_cast<float*>(smem + L::stats);
  float* delta_s = lse2_s + 64;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int q0 = blockIdx.x * BR;
  int klen = kv_len != nullptr ? min(kv_len[b], Lk) : Lk;
  klen = max(klen, 0);
  const int q_rows = min(BR, Lq - q0);

  load_tile<D>(sq, q + b * qs.b + n * qs.n + q0 * qs.l, qs.l, q_rows, tid);
  load_tile<D>(sdo, dout + b * dos.b + n * dos.n + q0 * dos.l, dos.l, q_rows, tid);
  if (tid < BR) {
    const bool ok = tid < q_rows;
    lse2_s[tid] = ok ? lse[static_cast<long long>(bn) * Lq + q0 + tid] * LOG2E : 0.f;
    delta_s[tid] = ok ? delta[static_cast<long long>(bn) * Lq + q0 + tid] : 0.f;
  }

  const int row0 = warp * 16;
  const float scale_log2 = scale * LOG2E;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int kv0 = 0; kv0 < klen; kv0 += BC) {
    const int kv_rows = min(BC, klen - kv0);
    load_tile<D>(sk, k + b * ks.b + n * ks.n + kv0 * ks.l, ks.l, kv_rows, tid);
    load_tile<D>(sv, v + b * vs.b + n * vs.n + kv0 * vs.l, vs.l, kv_rows, tid);
    __syncthreads();
    warp_abt<D>(ss + row0 * LDS, sq + row0 * LDH, sk);   // S  = Q K^T
    warp_abt<D>(sdp + row0 * LDS, sdo + row0 * LDH, sv); // dP = dO V^T
    __syncwarp();
    warp_softmax_grad<true>(ss + row0 * LDS, sdp + row0 * LDS, lse2_s + row0,
                            delta_s + row0, scale_log2, scale, lane,
                            [&](int, int c) { return c < kv_rows; });
    warp_ab_acc<D>(acc, reinterpret_cast<const bf16*>(sdp + row0 * LDS), sk);  // dQ += dS K
    __syncthreads();  // K/V are overwritten by the next tile
  }
  warp_store<D>(acc, ss + row0 * LDS, dq + b * dqs.b + n * dqs.n, dqs.l,
                q0 + row0, Lq, lane);
}

// K9: one block per (batch*head, 64 kv rows); loops over the q tiles.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_len, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int N, int Lq, int Lk, Strides qs,
                     Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                     float scale) {
  using L = Smem<D>;
  constexpr int LDH = L::LDH, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem + L::held0);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::held1);
  bf16* sq = reinterpret_cast<bf16*>(smem + L::str0);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L::str1);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* sdp = reinterpret_cast<float*>(smem + L::dp);
  float* lse2_s = reinterpret_cast<float*>(smem + L::stats);
  float* delta_s = lse2_s + 64;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int kv0 = blockIdx.x * BR;
  int klen = kv_len != nullptr ? min(kv_len[b], Lk) : Lk;
  klen = max(klen, 0);
  const int row0 = warp * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[D / 16], acc_v[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(acc_k[j], 0.f);
    wmma::fill_fragment(acc_v[j], 0.f);
  }

  if (kv0 < klen) {  // a tile wholly past kv_len keeps zero gradients
    const int kv_rows = min(BR, klen - kv0);
    load_tile<D>(sk, k + b * ks.b + n * ks.n + kv0 * ks.l, ks.l, kv_rows, tid);
    load_tile<D>(sv, v + b * vs.b + n * vs.n + kv0 * vs.l, vs.l, kv_rows, tid);
    const float scale_log2 = scale * LOG2E;
    for (int q0 = 0; q0 < Lq; q0 += BC) {
      const int q_rows = min(BC, Lq - q0);
      load_tile<D>(sq, q + b * qs.b + n * qs.n + q0 * qs.l, qs.l, q_rows, tid);
      load_tile<D>(sdo, dout + b * dos.b + n * dos.n + q0 * dos.l, dos.l, q_rows, tid);
      if (tid < BC) {
        const bool ok = tid < q_rows;
        lse2_s[tid] = ok ? lse[static_cast<long long>(bn) * Lq + q0 + tid] * LOG2E : 0.f;
        delta_s[tid] = ok ? delta[static_cast<long long>(bn) * Lq + q0 + tid] : 0.f;
      }
      __syncthreads();
      warp_abt<D>(ss + row0 * LDS, sk + row0 * LDH, sq);   // S^T  = K Q^T
      warp_abt<D>(sdp + row0 * LDS, sv + row0 * LDH, sdo); // dP^T = V dO^T
      __syncwarp();
      const int live_rows = kv_rows - row0;
      warp_softmax_grad<false>(ss + row0 * LDS, sdp + row0 * LDS, lse2_s, delta_s,
                               scale_log2, scale, lane,
                               [&](int r, int c) { return r < live_rows && c < q_rows; });
      warp_ab_acc<D>(acc_v, reinterpret_cast<const bf16*>(ss + row0 * LDS), sdo);  // dV += P^T dO
      warp_ab_acc<D>(acc_k, reinterpret_cast<const bf16*>(sdp + row0 * LDS), sq);  // dK += dS^T Q
      __syncthreads();  // Q/dO and the stats are overwritten by the next tile
    }
  }
  warp_store<D>(acc_k, ss + row0 * LDS, dk + b * dks.b + n * dks.n, dks.l,
                kv0 + row0, Lk, lane);
  warp_store<D>(acc_v, ss + row0 * LDS, dv + b * dvs.b + n * dvs.n, dvs.l,
                kv0 + row0, Lk, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* kv_len,
                      void* dq, int B, int Lq, int Lk, int N, Strides qs, Strides ks,
                      Strides vs, Strides dos, Strides dqs, float scale,
                      cudaStream_t stream) {
  constexpr size_t bytes = Smem<D>::bytes;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BR - 1) / BR, B * N);
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dq), N, Lq, Lk, qs, ks,
      vs, dos, dqs, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* kv_len,
                       void* dk, void* dv, int B, int Lq, int Lk, int N, Strides qs,
                       Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                       float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<D>::bytes;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Lk + BR - 1) / BR, B * N);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), N, Lq, Lk, qs, ks, vs, dos, dks, dvs, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int yume_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dq, int B, int Lq, int Lk, int N,
    int D, long long qsb, long long qsl, long long qsn, long long ksb, long long ksl,
    long long ksn, long long vsb, long long vsl, long long vsn, long long dosb,
    long long dosl, long long dosn, long long dqsb, long long dqsl, long long dqsn,
    float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsl, qsn}, ks{ksb, ksl, ksn}, vs{vsb, vsl, vsn},
      dos{dosb, dosl, dosn}, dqs{dqsb, dqsl, dqsn};
  switch (D) {
#define YUME_DQ(DIM) \
  case DIM:          \
    return launch_dq<DIM>(q, k, v, dout, lse, delta, kv_len, dq, B, Lq, Lk, N, qs, ks, vs, dos, dqs, scale, s);
    YUME_DQ(16)
    YUME_DQ(64)
    YUME_DQ(128)
#undef YUME_DQ
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int yume_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_len, void* dk, void* dv, int B, int Lq, int Lk,
    int N, int D, long long qsb, long long qsl, long long qsn, long long ksb,
    long long ksl, long long ksn, long long vsb, long long vsl, long long vsn,
    long long dosb, long long dosl, long long dosn, long long dksb, long long dksl,
    long long dksn, long long dvsb, long long dvsl, long long dvsn, float scale,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsl, qsn}, ks{ksb, ksl, ksn}, vs{vsb, vsl, vsn},
      dos{dosb, dosl, dosn}, dks{dksb, dksl, dksn}, dvs{dvsb, dvsl, dvsn};
  switch (D) {
#define YUME_DKV(DIM) \
  case DIM:           \
    return launch_dkv<DIM>(q, k, v, dout, lse, delta, kv_len, dk, dv, B, Lq, Lk, N, qs, ks, vs, dos, dks, dvs, scale, s);
    YUME_DKV(16)
    YUME_DKV(64)
    YUME_DKV(128)
#undef YUME_DKV
    default:
      return cudaErrorInvalidValue;
  }
}
