// W8A8 int8 matmul for Hopper (sm_90a): kernel K6, bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel yume_tpu/ops/quant_matmul.py::_fused_kernel
// (reached through _fused_q8_matmul_2d from q8_dot and int8_dot_general).
// Same math, bit for bit with the plain version
// (ops/quant_matmul.py::_q8_matmul_ref):
//   a_scale[m] = max(max_k |x[m,k]|, 1e-8) / 127            (fp32)
//   xq[m,k]    = clip(rint(x[m,k] / a_scale[m]), -127, 127)  (IEEE division,
//                round half to even)
//   acc[m,n]   = sum_k xq[m,k] * qw[n,k]                     (exact in s32:
//                127^2 * 14336 < 2^31)
//   out[m,n]   = bf16((float)acc * a_scale[m] * w_scale[n])  (left to right)
// The weight is in torch Linear layout [N, K] (K contiguous per output
// channel), which is the .col B operand of the int8 mma as it lies.
//
// Differences from the TPU kernel, on purpose:
//  * The per-row scales come from a small kernel here (row_scale_kernel)
//    instead of an XLA reduction before the Pallas call.
//  * Every K is served (the TPU routed only K >= 8192 here, a TPU
//    measurement); the ragged M edge (12,095 tokens) is masked in the
//    kernel instead of padded. K % 32 == 0 and N % 8 == 0 are required.
//
// What bounds it on the H100: at the 5B projections (M = 12,095,
// K x N in {3072 x 9216, 3072 x 3072, 3072 x 14336, 14336 x 3072}) the
// products are ~2.3e11 to 1.1e12 int8 operations against at most ~0.5 GB
// of traffic, so it is bound by the tensor cores' int8 rate.
// Design: one block of 8 warps per 128 x 128 output tile, two blocks per
// SM, stepping K by 64. A three-stage cp.async ring brings the raw bf16
// activation tile and the int8 weight tile of the next K steps into shared
// memory while the current step computes. Each bf16 activation tile is then
// quantized from shared memory into an int8 tile (double-buffered), so the
// int8 activations never reach device memory. The quantizer multiplies by
// the row's reciprocal scale and takes the IEEE division only for the rare
// values within 1e-4 of a rounding boundary, where the product (within two
// ulps of the quotient) could round the other way: the result is the
// division's, bit for bit. Each warp computes a 64 x 32 sub-tile with
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32; every fragment register
// is one aligned 32-bit shared-memory load, with int8 row pitches padded to
// 80 bytes so a warp's loads hit 32 distinct banks. The epilogue rescales
// the s32 accumulators in fp32 and writes bf16 pairs. wgmma, TMA, a
// persistent schedule and quantizing each activation tile once per block
// row (not once per output tile) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BKT = 64;        // K step (int8 elements)
constexpr int LDS = BKT + 16;  // int8 shared-memory row pitch in bytes (80)
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;         // warp tile rows
constexpr int WN = 32;         // warp tile columns
constexpr int MT = WM / 16;    // m16 tiles per warp
constexpr int NT = WN / 8;     // n8 tiles per warp
constexpr int STAGES = 3;      // cp.async ring depth
constexpr int A_CHUNKS = BM * BKT / 8 / THREADS;   // 16-byte bf16 chunks per thread: 4
constexpr int B_CHUNKS = BN * BKT / 16 / THREADS;  // 16-byte int8 chunks per thread: 2
constexpr int A_STAGE = BM * BKT * 2;              // raw bf16 tile bytes (128-byte rows)
constexpr int B_STAGE = BN * LDS;                  // int8 weight tile bytes
constexpr int AQ_TILE = BM * LDS;                  // int8 activation tile bytes
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) + 2 * AQ_TILE;  // 100,352
constexpr int SCALE_THREADS = 128;

__device__ __forceinline__ float bf16_at(const uint32_t word, int hi) {
  // bf16 -> fp32 is a 16-bit shift, exact
  return __uint_as_float(hi ? (word & 0xffff0000u) : (word << 16));
}

// clip(rint(v / s), -127, 127) with the IEEE quotient; r = 1/s rounded.
// v * r is within two ulps (< 2e-5 for |v / s| <= 128) of the quotient, so
// both round to the same integer unless v * r lies within 1e-4 of a
// half-integer: only there is the division done.
__device__ __forceinline__ float quant1(float v, float s, float r) {
  const float y = v * r;
  float q = rintf(y);
  if (fabsf(fabsf(y - q) - 0.5f) <= 1e-4f) q = rintf(__fdiv_rn(v, s));
  return fminf(fmaxf(q, -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t quant4(uint32_t w0, uint32_t w1, float s, float r) {
  // four bf16 (two words) -> four int8 packed low byte first
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float q = quant1(bf16_at(j < 2 ? w0 : w1, j & 1), s, r);
    packed |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * j);
  }
  return packed;
}

// 16-byte global -> shared copy; zero-fills (reads nothing) when !pred
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a_scale[m] = max(max_k |x[m, k]|, 1e-8) / 127; one block per row.
__global__ void __launch_bounds__(SCALE_THREADS)
row_scale_kernel(const bf16* __restrict__ x, float* __restrict__ a_scale,
                 int K, long long ldx) {
  const uint4* row = reinterpret_cast<const uint4*>(x + blockIdx.x * ldx);
  float m = 0.0f;
  for (int c = threadIdx.x; c < K / 8; c += SCALE_THREADS) {
    const uint4 v = row[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(bf16_at(w[j >> 1], j & 1)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[SCALE_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < SCALE_THREADS / 32; ++i) m = fmaxf(m, warp_max[i]);
    a_scale[blockIdx.x] = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
q8_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ qw,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ a_scale, bf16* __restrict__ out,
                 int M, int N, int K, long long ldx) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_raw = smem;                                   // [STAGES][BM][BKT] bf16
  int8_t* b_st = reinterpret_cast<int8_t*>(smem + STAGES * A_STAGE);  // [STAGES][BN][LDS]
  int8_t* a_q = b_st + STAGES * B_STAGE;                         // [2][BM][LDS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int warp_m = warp & 1;
  const int warp_n = warp >> 1;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // this thread's activation rows (fixed over K), their scales and reciprocals
  const int a_row = tid >> 3;        // + 32 * i
  const int a_col = (tid & 7) * 8;   // bf16 column within the K step
  float s_row[A_CHUNKS], r_row[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int r = m0 + a_row + 32 * i;
    s_row[i] = r < M ? a_scale[r] : 1.0f;
    r_row[i] = __frcp_rn(s_row[i]);
  }
  const int b_row = tid >> 2;        // + 64 * i
  const int b_col = (tid & 3) * 16;  // int8 column within the K step

  auto issue = [&](int kt) {  // K step kt -> ring stage kt % STAGES
    const int k0 = kt * BKT;
    unsigned char* a_dst = a_raw + (kt % STAGES) * A_STAGE;
    int8_t* b_dst = b_st + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int r = m0 + a_row + 32 * i;
      const int k = k0 + a_col;
      const bool ok = r < M && k < K;
      cp_async16(a_dst + ((a_row + 32 * i) * BKT + a_col) * 2,
                 ok ? x + r * ldx + k : x, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int n = n0 + b_row + 64 * i;
      const int k = k0 + b_col;
      const bool ok = n < N && k < K;
      cp_async16(b_dst + (b_row + 64 * i) * LDS + b_col,
                 ok ? qw + static_cast<long long>(n) * K + k : qw, ok);
    }
  };
  auto quantize = [&](int kt) {  // raw stage of K step kt -> int8 tile kt & 1
    const unsigned char* src = a_raw + (kt % STAGES) * A_STAGE;
    int8_t* dst = a_q + (kt & 1) * AQ_TILE;
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int row = a_row + 32 * i;
      const uint4 v = *reinterpret_cast<const uint4*>(src + (row * BKT + a_col) * 2);
      uint2 q;
      q.x = quant4(v.x, v.y, s_row[i], r_row[i]);
      q.y = quant4(v.z, v.w, s_row[i], r_row[i]);
      *reinterpret_cast<uint2*>(dst + row * LDS + a_col) = q;
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int nk = (K + BKT - 1) / BKT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();  // one group per K step, empty past the end
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  quantize(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    // the stage refilled here was last read before the previous barrier
    if (kt + STAGES - 1 < nk) issue(kt + STAGES - 1);
    cp_async_commit();

    const int8_t* a_s = a_q + (kt & 1) * AQ_TILE;
    const int8_t* b_s = b_st + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 32) {
      uint32_t af[MT][4];
      uint32_t bfr[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r = warp_m * WM + mi * 16 + g;
        const int c = kk + t * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(a_s + r * LDS + c);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(a_s + (r + 8) * LDS + c);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(a_s + r * LDS + c + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(a_s + (r + 8) * LDS + c + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = warp_n * WN + ni * 8 + g;
        const int c = kk + t * 4;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(b_s + n * LDS + c);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(b_s + n * LDS + c + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }

    if (kt + 1 < nk) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of step kt + 1 landed
      __syncthreads();              // everyone's
      quantize(kt + 1);             // into the tile the previous step read
    }
    __syncthreads();
  }

  // epilogue: (float)acc * a_scale[m] * w_scale[n], left to right, to bf16
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int n = n0 + warp_n * WN + ni * 8 + t * 2;
    if (n >= N) continue;  // N % 8 == 0: a column pair is all in or all out
    const float ws0 = w_scale[n];
    const float ws1 = w_scale[n + 1];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + warp_m * WM + mi * 16 + g + 8 * h;
        if (m >= M) continue;
        const float as = a_scale[m];
        const float v0 = static_cast<float>(acc[mi][ni][2 * h]) * as * ws0;
        const float v1 = static_cast<float>(acc[mi][ni][2 * h + 1]) * as * ws1;
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(m) * N + n) =
            __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      }
    }
  }
}

}  // namespace

// x bf16 [M, K] (row stride ldx elements, 16-byte aligned rows), qw int8
// [N, K] contiguous, w_scale fp32 [N], a_scale fp32 [M] (written here),
// out bf16 [M, N] contiguous. Requires K % 32 == 0 and N % 8 == 0.
extern "C" int yume_q8_matmul(const void* x, const void* qw, const void* w_scale,
                              void* a_scale, void* out, int M, int N, int K,
                              long long ldx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return cudaSuccess;
  row_scale_kernel<<<M, SCALE_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<float*>(a_scale), K, ldx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q8_matmul_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)  // room for two blocks per SM
    err = cudaFuncSetAttribute(q8_matmul_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q8_matmul_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(w_scale), static_cast<const float*>(a_scale),
      static_cast<bf16*>(out), M, N, K, ldx);
  return cudaGetLastError();
}
