// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel yume_tpu/ops/flash_attention.py::_fwd_kernel
// (reached through _fwd by flash_attention, K1, and by
// flash_attention_partial, K7). Same math: flash-v2 online softmax with fp32
// running max, sum and accumulator, per-batch kv_len masking, rows whose keys
// are all masked yield 0, and the logsumexp is written beside the output, so
// ring attention (K7, one launch per kv block) merges blocks exactly. A
// ring hop's kv block may be ragged (Lq 3,024 or 6,048), partly live
// (kv_len 3,023) or all pad (kv_len 0: output 0, lse MASKED_LSE).
//
// Differences from the TPU kernel, on purpose:
//  * The softmax scale multiplies the fp32 scores (the TPU wrapper folds it
//    into q in fp32 and rounds q back to bf16 first). This is the plain
//    reference's arithmetic (ops/attention.py::plain_attention).
//  * q, k, v and out are read and written through their [B, L, N, D]
//    strides: no fold/transpose to [B*N, L, D] and no padding to a block
//    multiple. The ragged q and kv edges are handled here (rows past the end
//    are zero-filled in shared memory and masked).
//  * Key tiles past kv_len are skipped instead of masked.
//
// What bounds it on the H100: at the 5B self-attention shape (L = 12,095,
// 24 heads, D = 128) the two matrix products are ~1.8e12 FLOP per layer
// against ~0.2 GB of q/k/v/out traffic, so it is compute bound: the tensor
// cores must do the products. Design: one block of 4 warps per
// (batch*head, 64-row q tile); each warp owns 16 q rows. K/V tiles of 64 rows
// are staged in shared memory; S = Q K^T and O += P V run on the tensor
// cores as nvcuda::wmma bf16 16x16x16 fragments (mma.sync) with fp32
// accumulation. The online softmax is warp-local (a warp owns whole rows),
// so only the K/V staging needs block barriers. The fp32 accumulator lives
// in shared memory and is rescaled in place each tile. wgmma, TMA and
// double-buffered loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int THREADS = 128;    // 4 warps, 16 q rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// lse of a row with no live key (the TPU kernel's masked value)
constexpr float MASKED_LSE = -0.7f * FLT_MAX;

// Shared-memory carve-up. Row pitches are padded against bank conflicts;
// every wmma fragment pointer stays 32-byte aligned.
template <int D>
struct Smem {
  static constexpr int LDH = D + 8;   // bf16 Q/K/V pitch
  static constexpr int LDS = BK + 4;  // fp32 S pitch
  static constexpr int LDP = BK + 8;  // bf16 P pitch
  static constexpr int LDO = D + 4;   // fp32 O pitch
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(BQ) * LDH * 2;
  static constexpr size_t v = k + size_t(BK) * LDH * 2;
  static constexpr size_t s = v + size_t(BK) * LDH * 2;
  static constexpr size_t p = s + size_t(BQ) * LDS * 4;
  static constexpr size_t o = p + size_t(BQ) * LDP * 2;
  static constexpr size_t stats = o + size_t(BQ) * LDO * 4;
  static constexpr size_t bytes = stats + 3 * BQ * 4;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ kv_len,
                 int N, int Lq, int Lk,
                 long long qsb, long long qsl, long long qsn,
                 long long ksb, long long ksl, long long ksn,
                 long long vsb, long long vsl, long long vsn,
                 long long osb, long long osl, long long osn,
                 float scale_log2) {
  using L = Smem<D>;
  constexpr int LDH = L::LDH, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  bf16* sp = reinterpret_cast<bf16*>(smem + L::p);
  float* so = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::stats);  // running max (log2 units)
  float* l_s = m_s + BQ;                                   // running sum
  float* a_s = l_s + BQ;                                   // this tile's rescale

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int q0 = blockIdx.x * BQ;
  int klen = kv_len != nullptr ? min(kv_len[b], Lk) : Lk;
  klen = max(klen, 0);

  const bf16* qb = q + b * qsb + n * qsn + q0 * qsl;
  const bf16* kb = k + b * ksb + n * ksn;
  const bf16* vb = v + b * vsb + n * vsn;

  load_tile<D>(sq, qb, qsl, min(BQ, Lq - q0), tid);
  for (int i = tid; i < BQ * LDO; i += THREADS) so[i] = 0.f;
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int row0 = warp * 16;
  for (int kv0 = 0; kv0 < klen; kv0 += BK) {
    const int kv_rows = min(BK, klen - kv0);
    load_tile<D>(sk, kb + kv0 * ksl, ksl, kv_rows, tid);
    load_tile<D>(sv, vb + kv0 * vsl, vsl, kv_rows, tid);
    __syncthreads();

    // S[row0:row0+16, :] = Q K^T on the tensor cores
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sq + row0 * LDH + kk, LDH);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          // K^T as a column-major 16x16 operand: (d, key) at sk[key*LDH + d]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, sk + (j * 16) * LDH + kk, LDH);
          wmma::mma_sync(acc[j], a, bk, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        wmma::store_matrix_sync(ss + row0 * LDS + j * 16, acc[j], LDS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax over this warp's 16 rows; each lane holds 2 columns
    for (int r = row0; r < row0 + 16; ++r) {
      const float s0 = lane < kv_rows ? ss[r * LDS + lane] * scale_log2 : -INFINITY;
      const float s1 = lane + 32 < kv_rows ? ss[r * LDS + lane + 32] * scale_log2 : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f(s0 - m_use);
      const float p1 = exp2f(s1 - m_use);
      const float sum = warp_sum(p0 + p1);
      sp[r * LDP + lane] = __float2bfloat16(p0);
      sp[r * LDP + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncwarp();

    // rescale this warp's accumulator rows by the tile's alpha
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = row0 + i / D;
      so[r * LDO + (i % D)] *= a_s[r];
    }
    __syncwarp();

    // O[row0:row0+16, :] += P V on the tensor cores
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, so + row0 * LDO + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sp + row0 * LDP + kk, LDP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, sv + kk * LDH + j * 16, LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(so + row0 * LDO + j * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncthreads();  // K/V are overwritten by the next tile
  }
  __syncwarp();

  // epilogue: normalise, write bf16 out and the fp32 lse
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = row0 + i / D;
    const int c = i % D;
    const int qi = q0 + r;
    if (qi < Lq) {
      const float l = l_s[r];
      const float inv = l == 0.f ? 0.f : 1.f / l;
      out[b * osb + n * osn + qi * osl + c] = __float2bfloat16(so[r * LDO + c] * inv);
    }
  }
  if (lane < 16) {
    const int r = row0 + lane;
    const int qi = q0 + r;
    if (qi < Lq) {
      const float l = l_s[r];
      lse[static_cast<long long>(bn) * Lq + qi] =
          l == 0.f ? MASKED_LSE : m_s[r] * LN2 + logf(l);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* kv_len, int B, int Lq, int Lk, int N,
                   long long qsb, long long qsl, long long qsn,
                   long long ksb, long long ksl, long long ksn,
                   long long vsb, long long vsl, long long vsn,
                   long long osb, long long osl, long long osn, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, B * N);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), static_cast<const int*>(kv_len), N, Lq, Lk,
      qsb, qsl, qsn, ksb, ksl, ksn, vsb, vsl, vsn, osb, osl, osn,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" int yume_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* kv_len, int B, int Lq, int Lk, int N, int D,
    long long qsb, long long qsl, long long qsn,
    long long ksb, long long ksl, long long ksn,
    long long vsb, long long vsl, long long vsn,
    long long osb, long long osl, long long osn, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define YUME_FWD(DIM)                                                          \
  case DIM:                                                                    \
    return launch<DIM>(q, k, v, out, lse, kv_len, B, Lq, Lk, N, qsb, qsl, qsn, \
                       ksb, ksl, ksn, vsb, vsl, vsn, osb, osl, osn, scale, s);
    YUME_FWD(16)
    YUME_FWD(64)
    YUME_FWD(128)
#undef YUME_FWD
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* yume_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
