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
// The weight is in torch Linear layout [N, K] and the int8 activations are
// written [M, K]: both K-major, the only layout int8 wgmma takes.
//
// Differences from the TPU kernel, on purpose:
//  * The activations are quantized once, by a pre-pass kernel that writes
//    the per-row scales and the int8 rows to device memory
//    (quantize_rows_kernel); the TPU kernel quantized each activation block
//    in VMEM and took its scales from an XLA reduction.
//  * Every K is served (the TPU routed only K >= 8192 here, a TPU
//    measurement); the ragged M edge (12,095 tokens) is zero-filled by
//    TMA's loads and skipped by its stores instead of padded. K % 32 == 0
//    and N % 8 == 0 are required.
//
// What bounds it on the H100: at the 5B projections (M = 12,095,
// K x N in {3072 x 9216, 3072 x 3072, 3072 x 14336, 14336 x 3072}) the
// products are ~2.3e11 to 1.1e12 int8 operations against at most ~0.5 GB
// of traffic, so it is bound by the tensor cores' int8 rate. The design:
//  * Pre-pass (bound by bytes): one block of 128 threads a row reads the
//    bf16 row through its stride in 16-byte vectors, takes its absmax, then
//    reads it again (from the cache) and writes a_scale[m] and the int8 row,
//    each value the IEEE quotient __fdiv_rn rounded by rint and clipped.
//  * GEMM: persistent, one CTA of three warpgroups on each SM, walking
//    128 x 256 output tiles GROUP_M tile rows at a time, so that the
//    weight's column blocks are read by many tile rows while they sit in
//    L2 (a static stride over the tiles: at N = 3,072, 1,140 tiles leave
//    the last of 9 rounds 64% full on 132 SMs). Warpgroup 0 is the
//    producer: it gives up registers (setmaxnreg) and one thread issues
//    TMA loads of [128 rows x 128 bytes] of xq and [256 rows x 128 bytes]
//    of qw (128-byte swizzle; zero-filled past M, N and K, and zeros add
//    nothing to the sum) into a ring of STAGES stages
//    with full (TMA byte count) and empty (one arrival per consumer
//    warpgroup) mbarriers. It runs ahead across tiles, so the next tile's
//    loads overlap this tile's epilogue.
//  * Warpgroups 1 and 2 are the consumers, 64 rows each: per 128-deep K
//    step four wgmma m64n256k32 s32.s8.s8 with both operands in shared
//    memory; one step's products stay in flight while the next stage is
//    awaited, and the stage before is released when they complete. The
//    128 s32 accumulators a thread stay in registers for the whole K loop.
//  * Epilogue: (float)acc * a_scale[m] * w_scale[n] in fp32, left to right,
//    rounded to bf16 into a shared-memory buffer (half a consumer's tile at
//    a time, in TMA's 128-byte swizzle), which TMA stores to out, skipping
//    rows >= M and columns >= N, while the next tile's products run (4-byte
//    stores straight from the registers, 16 bytes a row a warp, kept the
//    tensor cores idle for the whole epilogue).
// The tensor maps are encoded on the host for each launch (hopper.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 128;         // output rows a tile: two consumer warpgroups of 64
constexpr int BN = 256;         // output columns a tile: one m64n256 accumulator
constexpr int BK = 128;         // K step: one 128-byte swizzle row of int8
constexpr int STAGES = 4;       // ring depth
constexpr int GROUP_M = 16;     // tile rows walked together (L2 reuse of the weight)
constexpr int THREADS = 384;    // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int OUT_BOX = 64;     // output box: 64 rows x 64 bf16 columns (128 bytes)
constexpr uint32_t A_BYTES = BM * BK;                       // 16 KB a stage
constexpr uint32_t B_BYTES = BN * BK;                       // 32 KB a stage
constexpr uint32_t C_BYTES = 64 * (BN / 2) * 2;             // 16 KB: half a consumer's tile
constexpr uint32_t SMEM_B = STAGES * A_BYTES;               // A stages first
constexpr uint32_t SMEM_C = SMEM_B + STAGES * B_BYTES;      // C_BYTES a consumer
constexpr uint32_t SMEM_BARS = SMEM_C + 2 * C_BYTES;        // full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = SMEM_BARS + 16 * STAGES + 1024;  // + alignment: 230,464
constexpr uint64_t SWIZZLE_128B = 1;                        // wgmma descriptor layout type
constexpr int QUANT_THREADS = 128;

__device__ __forceinline__ float bf16_at(const uint32_t word, int hi) {
  // bf16 -> fp32 is a 16-bit shift, exact
  return __uint_as_float(hi ? (word & 0xffff0000u) : (word << 16));
}

__device__ __forceinline__ uint32_t quant4(uint32_t w0, uint32_t w1, float s) {
  // four bf16 (two words) -> four int8 packed low byte first
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float q = rintf(__fdiv_rn(bf16_at(j < 2 ? w0 : w1, j & 1), s));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    packed |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * j);
  }
  return packed;
}

// a_scale[m] and xq[m, :] for one row m a block.
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_rows_kernel(const bf16* __restrict__ x, float* __restrict__ a_scale,
                     int8_t* __restrict__ xq, int K, long long ldx) {
  const uint4* row = reinterpret_cast<const uint4*>(x + blockIdx.x * ldx);
  float m = 0.0f;
  for (int c = threadIdx.x; c < K / 8; c += QUANT_THREADS) {
    const uint4 v = row[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(bf16_at(w[j >> 1], j & 1)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[QUANT_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < QUANT_THREADS / 32; ++i) m = fmaxf(m, warp_max[i]);
  const float s = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  if (threadIdx.x == 0) a_scale[blockIdx.x] = s;
  uint2* dst = reinterpret_cast<uint2*>(xq + static_cast<long long>(blockIdx.x) * K);
  for (int c = threadIdx.x; c < K / 8; c += QUANT_THREADS) {
    const uint4 v = row[c];
    dst[c] = make_uint2(quant4(v.x, v.y, s), quant4(v.z, v.w, s));
  }
}

// D[64 x 256] (+)= A[64 x 32] B[32 x 256] in s32, A and B int8 K-major in
// shared memory; acc = 0 overwrites D
__device__ __forceinline__ void wgmma_s8_m64n256(uint32_t* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, __nv_bfloat162 v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<uint32_t*>(&v)) : "memory");
}

// Output tile `tile` -> its first row and column: GROUP_M tile rows at a
// time, tile rows fastest inside a group.
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int& m0,
                                            int& n0) {
  const int per_group = GROUP_M * tiles_n;
  const int group = tile / per_group;
  const int first = group * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_group = tile - group * per_group;
  m0 = (first + in_group % rows) * BM;
  n0 = (in_group / rows) * BN;
}

__global__ void __launch_bounds__(THREADS, 1)
q8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_out,
               const float* __restrict__ a_scale, const float* __restrict__ w_scale, int M,
               int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u)
                        & ~1023u;
  const uint32_t bar_full = base + SMEM_BARS;         // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // + 8 s
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int ntiles = tiles_m * tiles_n;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int it = 0;  // K steps issued so far, over all of this CTA's tiles
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, tiles_m, tiles_n, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // the stage is free
          mbar_expect_tx(bar_full + 8 * s, A_BYTES + B_BYTES);
          tma_load_2d(base + s * A_BYTES, &tm_x, bar_full + 8 * s, kt * BK, m0);
          tma_load_2d(base + SMEM_B + s * B_BYTES, &tm_w, bar_full + 8 * s, kt * BK, n0);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows x 256 columns each ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    uint32_t acc[BN / 2];  // the m64n256 s32 accumulator
    int it = 0;            // K steps consumed so far
    const uint32_t cbuf = base + SMEM_C + cw * C_BYTES;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, tiles_m, tiles_n, m0, n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
        const uint32_t sa = base + s * A_BYTES + cw * 64 * BK;
        const uint32_t sb = base + SMEM_B + s * B_BYTES;
        fence_regs<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8_m64n256(acc, smem_desc(sa + kk * 32, 16, 8 * BK, SWIZZLE_128B),
                           smem_desc(sb + kk * 32, 16, 8 * BK, SWIZZLE_128B), kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: free its stage
        fence_regs<BN / 2>(acc);
        if (kt > 0 && tid == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));
      }
      // epilogue: rows r0 and r0 + 8, columns 8i + 2 (lane % 4) + {0, 1}.
      // Their scales are loaded while the last products run (a row or
      // column past the edge loads the last one's; TMA stores none of it).
      const int row = 16 * warp + lane / 4;  // and row + 8, of this consumer's 64
      const int r0 = m0 + 64 * cw + row;
      const float as0 = a_scale[min(r0, M - 1)];
      const float as1 = a_scale[min(r0 + 8, M - 1)];
      float ws[BN / 4];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int n = min(n0 + 8 * i + 2 * (lane % 4), N - 2);
        ws[2 * i] = w_scale[n];
        ws[2 * i + 1] = w_scale[n + 1];
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (tid == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % STAGES));

      // The bf16 tile goes out through shared memory and TMA stores, 128
      // columns at a time (two 64 x 64 boxes in TMA's 128-byte swizzle:
      // the 16-byte chunk j of row r sits at chunk j ^ (r % 8), so a warp's
      // writes hit 32 distinct banks), while the next tile's products run.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (tid == 0) bulk_wait_read<0>();  // the previous stores have read the buffer
        named_barrier(1 + cw, 128);
#pragma unroll
        for (int i = 16 * h; i < 16 * h + 16; ++i) {
          const uint32_t box = cbuf + ((i / 8) % 2) * (OUT_BOX * 128) + 4 * (lane % 4);
          const uint32_t chunk = ((i % 8) ^ (row % 8)) * 16;
          const __nv_bfloat162 v0 = __floats2bfloat162_rn(
              static_cast<float>(static_cast<int>(acc[4 * i])) * as0 * ws[2 * i],
              static_cast<float>(static_cast<int>(acc[4 * i + 1])) * as0 * ws[2 * i + 1]);
          const __nv_bfloat162 v1 = __floats2bfloat162_rn(
              static_cast<float>(static_cast<int>(acc[4 * i + 2])) * as1 * ws[2 * i],
              static_cast<float>(static_cast<int>(acc[4 * i + 3])) * as1 * ws[2 * i + 1]);
          st_shared_b32(box + row * 128 + chunk, v0);
          st_shared_b32(box + (row + 8) * 128 + chunk, v1);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_barrier(1 + cw, 128);
        if (tid == 0) {
          const int c0 = n0 + (BN / 2) * h;
          tma_store_2d(&tm_out, cbuf, c0, m0 + 64 * cw);
          tma_store_2d(&tm_out, cbuf + OUT_BOX * 128, c0 + OUT_BOX, m0 + 64 * cw);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait<0>();  // the stores are done before the CTA exits
  }
}

// A row-major [rows, cols] matrix of `elem_bytes` elements as a 2-D map
// over (cols, rows), in boxes of [box_rows x 128 bytes] with 128-byte
// swizzle: loads zero-fill past either extent, stores skip it.
bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                 int elem_bytes, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t quantize_rows(const void* x, void* a_scale, void* xq, int M, int K, long long ldx,
                          cudaStream_t s) {
  quantize_rows_kernel<<<M, QUANT_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<float*>(a_scale), static_cast<int8_t*>(xq), K,
      ldx);
  return cudaGetLastError();
}

}  // namespace

// The pre-pass alone: x bf16 [M, K] (row stride ldx elements, 16-byte
// aligned rows) -> a_scale fp32 [M], xq int8 [M, K] contiguous.
extern "C" int yume_q8_quantize(const void* x, void* a_scale, void* xq, int M, int K,
                                long long ldx, void* stream) {
  if (M <= 0) return cudaSuccess;
  return quantize_rows(x, a_scale, xq, M, K, ldx, static_cast<cudaStream_t>(stream));
}

// x bf16 [M, K] (row stride ldx elements, 16-byte aligned rows), qw int8
// [N, K] contiguous (16-byte aligned), w_scale fp32 [N], a_scale fp32 [M]
// and xq int8 [M, K] (scratch, written here), out bf16 [M, N] contiguous.
// Requires K % 32 == 0 and N % 8 == 0.
extern "C" int yume_q8_matmul(const void* x, const void* qw, const void* w_scale,
                              void* a_scale, void* xq, void* out, int M, int N, int K,
                              long long ldx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return cudaSuccess;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = quantize_rows(x, a_scale, xq, M, K, ldx, s);
  if (err != cudaSuccess) return err;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_x{}, tm_w{}, tm_out{};
  constexpr CUtensorMapDataType I8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!encode_rows(fn, &tm_x, xq, I8, 1, M, K, BM) ||
      !encode_rows(fn, &tm_w, qw, I8, 1, N, K, BN) ||
      !encode_rows(fn, &tm_out, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, N, OUT_BOX))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(q8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // persistent: one CTA an SM
  q8_gemm_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      tm_x, tm_w, tm_out, static_cast<const float*>(a_scale),
      static_cast<const float*>(w_scale), M, N, K);
  return cudaGetLastError();
}
