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
//    reference's arithmetic (ops/attention.py::plain_attention); it is
//    folded into the exp2 as one FFMA, s·scale·log2(e) − m.
//  * q, k and v are read through their [B, L, N, D] strides by TMA tensor
//    maps over (D, L, N, B): no fold/transpose to [B*N, L, D] and no padding
//    to a block multiple. TMA zero-fills rows past Lq and Lk; keys at or
//    past min(kv_len, Lk) are masked to -inf inside the last tile.
//  * Key tiles past kv_len are skipped instead of masked.
//
// What bounds it on the H100: at the 5B self-attention shape (L = 12,095,
// 24 heads, D = 128) the two matrix products are ~1.8e12 FLOP per layer
// against ~0.2 GB of q/k/v/out traffic, so it is bound by tensor-core FLOPs
// (1.8 ms at 989 TFLOP/s). The design keeps the tensor cores fed:
//  * One CTA of three warpgroups per (128 q rows, batch·head), q blocks
//    fastest so one head's K/V stays in L2. Warpgroup 0 is the producer: it
//    gives up registers (setmaxnreg 24) and one thread issues TMA loads.
//    Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 q rows each.
//  * Q is loaded once; K and V go through a ring of STAGES 128-key tiles
//    with mbarriers: full barriers (TMA byte counts; K and V apart) and
//    empty barriers (one arrival per consumer warpgroup, after the P·V that
//    read the stage has completed). At D = 128 the ring and Q take 230 KB,
//    one CTA an SM.
//  * S = Q·Kᵀ is wgmma m64n128k16 with Q and K K-major in shared memory;
//    the fp32 scores stay in registers. The online softmax runs on them in
//    place: a thread holds parts of two rows, so a row's max takes two quad
//    shuffles and its sum is reduced once, at the end.
//  * O += P·V is wgmma m64nDk16 with P converted to bf16 in registers as
//    the A operand (the m64n128 accumulator layout, 16 keys at a time, is
//    the register A layout) and V read MN-major (transposed) from shared
//    memory. O lives in registers for the whole kv loop and is rescaled
//    there. P·V of one tile and Q·Kᵀ of the next are issued together. The
//    two consumers run unsynchronised with each other: an explicit
//    ping-pong (FA3's, one's softmax under the other's products) measured
//    within noise of this on the H100 and was removed.
//  * Shared memory holds TMA's 128-byte-swizzled tiles (64-column boxes; a
//    D = 128 row is two boxes, D = 16 uses 32-byte swizzle), which the
//    wgmma descriptors read without bank conflicts.
//  * The epilogue normalises O in registers and writes bf16 out
//    ([B, Lq, N, D], contiguous) and the fp32 natural-log lse ([B, N, Lq]),
//    skipping rows >= Lq.
// The tensor maps are encoded on the host for each launch by
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint so that the
// library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 128;        // q rows per CTA: two consumer warpgroups of 64
constexpr int BK = 128;        // keys per K/V tile
constexpr int STAGES = 3;      // K/V ring depth
constexpr int THREADS = 384;   // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// lse of a row with no live key (the TPU kernel's masked value)
constexpr float MASKED_LSE = -0.7f * FLT_MAX;

// Shared-memory carve-up for head dim D. A tile of R rows is stored as
// D·2/SW boxes of [R rows × SW bytes], each swizzled by TMA in SW-byte rows
// (SW = 128, or 32 for D = 16); every box starts on 1024 bytes. The swizzle
// constants are hopper.cuh's, which the tensor maps are encoded with.
template <int D>
struct Layout {
  static constexpr int SW = Swizzle<D>::SW;        // swizzle span, bytes
  static constexpr int SWE = Swizzle<D>::SWE;      // box width, elements
  static constexpr int BOXES = Swizzle<D>::BOXES;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = Q_BYTES;                         // + s * KV_BYTES
  static constexpr uint32_t v = k + STAGES * KV_BYTES;           // + s * KV_BYTES
  static constexpr uint32_t bars = v + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr uint32_t bytes = bars + 8 * (1 + 3 * STAGES) + 1024;  // + alignment
  static constexpr uint64_t LAYOUT_TYPE = Swizzle<D>::LAYOUT_TYPE;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "box alignment");
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t b) {
  if constexpr (D == 128) wgmma_rs_m64n128(o, a, b);
  else if constexpr (D == 64) wgmma_rs_m64n64(o, a, b);
  else wgmma_rs_m64n16(o, a, b);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 bf16* __restrict__ out, float* __restrict__ lse,
                 const int* __restrict__ kv_len, int N, int Lq, int Lk,
                 long long osb, long long osl, long long osn, float scale_log2) {
  using L = Layout<D>;
  constexpr int SW = L::SW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u)
                        & ~1023u;
  const uint32_t sq = base + L::q;
  const uint32_t bar_q = base + L::bars;
  const uint32_t bar_k = bar_q + 8;                 // + 8 s
  const uint32_t bar_v = bar_k + 8 * STAGES;        // + 8 s
  const uint32_t bar_e = bar_v + 8 * STAGES;        // + 8 s

  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int q0 = blockIdx.x * BQ;
  int klen = kv_len != nullptr ? min(kv_len[b], Lk) : Lk;
  klen = max(klen, 0);
  const int ntiles = (klen + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0 && ntiles > 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::BOXES; ++c)
        tma_load(sq + c * BQ * SW, &tm_q, bar_q, c * L::SWE, q0, n, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const uint32_t ph = (t / STAGES) & 1;
        mbar_wait(bar_e + 8 * s, ph ^ 1);  // the stage's previous tile is consumed
        const uint32_t sk = base + L::k + s * L::KV_BYTES;
        const uint32_t sv = base + L::v + s * L::KV_BYTES;
        mbar_expect_tx(bar_k + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c)
          tma_load(sk + c * BK * SW, &tm_k, bar_k + 8 * s, c * L::SWE, t * BK, n, b);
        mbar_expect_tx(bar_v + 8 * s, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::BOXES; ++c)
          tma_load(sv + c * BK * SW, &tm_v, bar_v + 8 * s, c * L::SWE, t * BK, n, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad_col = 2 * (lane % 4);   // first of this thread's 2 columns in each 8
    const int row = 16 * warp + lane / 4;  // this thread's rows: row and row + 8

    float sacc[BK / 2];   // S: m64n128 accumulator
    float o[D / 2];       // O: m64nD accumulator
    uint32_t p[BK / 4];   // P in bf16: the A operand of BK/16 k16 steps
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running row max of the raw scores
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

    // S = Q Kᵀ for the tile in stage s: D/16 k16 steps
    auto issue_s = [&](int s) {
      const uint32_t sk = base + L::k + s * L::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = (kk * 32) / SW, off = (kk * 32) % SW;
        const uint64_t da = smem_desc(sq + box * BQ * SW + cw * 64 * SW + off, 16, 8 * SW,
                                      L::LAYOUT_TYPE);
        const uint64_t db = smem_desc(sk + box * BK * SW + off, 16, 8 * SW, L::LAYOUT_TYPE);
        wgmma_ss_m64n128(sacc, da, db, kk > 0);
      }
    };

    // O += P V for the tile in stage s: BK/16 k16 steps
    auto issue_pv = [&](int s) {
      const uint32_t sv = base + L::v + s * L::KV_BYTES;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint64_t dv = smem_desc(sv + j * 16 * SW, BK * SW, 8 * SW, L::LAYOUT_TYPE);
        wgmma_pv<D>(o, p + 4 * j, dv);
      }
    };

    // Mask tile t's scores at keys >= klen, update the running max and sums,
    // write P, and rescale O's two rows by exp2(old max − new max).
    auto softmax = [&](int t) {
      const int live = klen - t * BK;  // only the last tile can hold dead keys
      if (live < BK) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * i + quad_col + e >= live) {
              sacc[4 * i + e] = -INFINITY;
              sacc[4 * i + 2 + e] = -INFINITY;
            }
          }
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
      const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
      const float alpha0 = ex2(m0 * scale_log2 - ms0);
      const float alpha1 = ex2(m1 * scale_log2 - ms1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float p0 = ex2(fmaf(sacc[4 * i], scale_log2, -ms0));
        const float p1 = ex2(fmaf(sacc[4 * i + 1], scale_log2, -ms0));
        const float p2 = ex2(fmaf(sacc[4 * i + 2], scale_log2, -ms1));
        const float p3 = ex2(fmaf(sacc[4 * i + 3], scale_log2, -ms1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        // keys 8i..8i+7 are half of the k16 step i/2, whose A registers
        // are (row, first 8), (row + 8, first 8), (row, last 8), (row + 8,
        // last 8): so register 2i holds row's pair and 2i + 1 row + 8's
        p[2 * i] = pack_bf16(p0, p1);
        p[2 * i + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }
    };

    if (ntiles > 0) {
      mbar_wait(bar_q, 0);
      mbar_wait(bar_k, 0);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(sacc);
    }
    // Tile t: softmax, then P·V of t and Q Kᵀ of t + 1 go out together. The
    // last tile is peeled off, so no product is issued under a condition.
    auto tile = [&](int t, bool more) {
      const int s = t % STAGES;
      softmax(t);
      mbar_wait(bar_v + 8 * s, (t / STAGES) & 1);
      if (more) mbar_wait(bar_k + 8 * ((t + 1) % STAGES), ((t + 1) / STAGES) & 1);
      fence_regs<D / 2>(o);
      wgmma_fence();
      issue_pv(s);
      if (more) issue_s((t + 1) % STAGES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      fence_regs<BK / 2>(sacc);
      if (tid == 0) mbar_arrive(bar_e + 8 * s);  // K and V of stage s are consumed
    };
    for (int t = 0; t + 1 < ntiles; ++t) tile(t, true);
    if (ntiles > 0) tile(ntiles - 1, false);

    // epilogue: normalise, write bf16 out and the fp32 lse
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    const int r0 = q0 + 64 * cw + row;
    const int r1 = r0 + 8;
    bf16* ob = out + b * osb + n * osn;
    if (r0 < Lq) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(ob + r0 * osl + quad_col);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) dst[4 * i] = pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    }
    if (r1 < Lq) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(ob + r1 * osl + quad_col);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        dst[4 * i] = pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
    if (lane % 4 == 0) {
      float* lb = lse + static_cast<long long>(bn) * Lq;
      if (r0 < Lq) lb[r0] = l0 == 0.f ? MASKED_LSE : m0 * scale_log2 * LN2 + logf(l0);
      if (r1 < Lq) lb[r1] = l1 == 0.f ? MASKED_LSE : m1 * scale_log2 * LN2 + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* kv_len, int B, int Lq, int Lk, int N,
                   long long qsb, long long qsl, long long qsn,
                   long long ksb, long long ksl, long long ksn,
                   long long vsb, long long vsl, long long vsn,
                   long long osb, long long osl, long long osn, float scale,
                   cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q{}, tm_k{}, tm_v{};  // k and v stay unused (zero) when Lk = 0
  if (!encode<D>(fn, &tm_q, q, B, Lq, N, qsb, qsl, qsn, BQ)) return cudaErrorInvalidValue;
  if (Lk > 0 && !(encode<D>(fn, &tm_k, k, B, Lk, N, ksb, ksl, ksn, BK) &&
                  encode<D>(fn, &tm_v, v, B, Lk, N, vsb, vsl, vsn, BK)))
    return cudaErrorInvalidValue;
  constexpr int bytes = static_cast<int>(Layout<D>::bytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, B * N);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<const int*>(kv_len), N, Lq, Lk, osb, osl, osn, scale * LOG2E);
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
