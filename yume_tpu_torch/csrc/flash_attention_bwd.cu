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
// Both are deterministic: every output element is summed by one thread in a
// fixed order, so a repeat run is bit-identical.
//
// Differences from the TPU kernels, on purpose:
//  * The scale multiplies the fp32 scores S, as the forward kernel K1
//    (csrc/flash_attention.cu) does, so P is exactly the softmax the forward
//    normalised: P = exp2(S*scale*log2(e) - lse*log2(e)), one FFMA and ex2.
//  * P and dS are rounded to bf16 before their products on the tensor cores
//    (the TPU dQ kernel rounds dS too; its dK/dV kernel keeps fp32).
//  * q, k, v and dO are read through their [B, L, N, D] strides by TMA
//    tensor maps over (D, L, N, B); ragged q and kv edges are masked here,
//    not by TMA's zero fill alone (lse and delta past Lq are not zero).
//    Keys at or past kv_len get zero dK/dV; K8 skips kv tiles past kv_len,
//    so a query row with no live key gets zero dQ; a K9 CTA whose kv rows
//    all lie past kv_len writes zeros without loading anything.
//
// What bounds them on the H100: at the 5B trainer shape (2,805 tokens, 24
// heads, D = 128) K8 does 3 and K9 4 matrix products of 2*Lq*Lk*D FLOP per
// head (1.45e11 and 1.93e11 FLOP) against ~0.1 GB of traffic: tensor-core
// bound (0.147 and 0.196 ms at 989 TFLOP/s). The design is K1's:
//  * One CTA of three warpgroups. Warpgroup 0 is the producer: it gives up
//    registers (setmaxnreg 24) and issues TMA loads into a four-stage
//    mbarrier ring (full barriers count TMA bytes, empty barriers one
//    arrival per consumer warpgroup after the last wgmma that read the
//    stage has been waited). The two consumers (setmaxnreg 240) own 64 rows
//    of the held operand each.
//  * K8: one CTA per (128 q rows, batch*head). Q and dO are loaded once, K
//    and V stream through a ring of 64-key tiles. S = Q K^T and dP = dO V^T
//    are SS wgmma (m64n64k16, K-major operands as they lie, like K1's
//    Q K^T); P and dS are formed in registers with the row's lse and delta
//    in registers; dS goes to bf16 in registers as the A operand of
//    dQ += dS K (RS wgmma m64nDk16, K read MN-major, like K1's V).
//  * K9: one CTA per (128 kv rows, batch*head). K and V are loaded
//    once; Q and dO stream through the ring in 64-row q tiles. The
//    consumers compute the transposed products S^T = K Q^T and
//    dP^T = V dO^T (SS m64n64k16), form P^T and dS^T in registers with
//    lse and delta per column, and feed them as bf16 A operands to
//    dV += P^T dO and dK += dS^T Q (RS m64nDk16, dO and Q read MN-major
//    from the same swizzled tiles). dK and dV stay in registers for the
//    whole q loop and are written once.
//  * lse and delta ([B, N, Lq] fp32; a row of 2,805 is 11,220 bytes, not a
//    multiple of 16, so TMA cannot map it) are loaded by the producer warp
//    with plain loads, lse pre-multiplied by log2(e), into the stage beside
//    its Q and dO tiles; all 32 lanes arrive on the stage's full barrier
//    after their stores (lane 0 with the TMA byte count), so the consumers'
//    wait orders them. Past Lq the producer writes lse = +inf and
//    delta = 0: P is 0 there.
//  * In both kernels the products of tile t + 1's scores are issued with
//    tile t's accumulating products, and the last tile is peeled off, so
//    no wgmma is issued under a condition (that serialised every wgmma in
//    K1, ptxas C7515).
//  * Tiles: K8's 64-key K/V tiles beat 128-key ones (two stages fit) and
//    K9's 128-row CTAs beat 64-row ones (one consumer, two CTAs an SM) at
//    the trainer's self, cross and MVDT shapes on the H100 (PERF.md). An
//    FA3-style ping-pong of the two consumers, Q and dO held as K8's
//    register A operands, and a double-buffered S/dP in K8 were each slower
//    or within noise.
// The tensor maps are encoded on the host for each launch by
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint so that the
// library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

// Each CTA: two consumer warpgroups of 64 rows of the held operand.
constexpr int BQ = 128;        // K8: q rows per CTA
constexpr int BK = 64;         // K8: keys per streamed K/V tile
constexpr int BKV = 128;       // K9: kv rows per CTA
constexpr int BQT = 64;        // K9: q rows per streamed tile
constexpr int STAGES = 4;      // ring depth of both kernels
constexpr int PRODUCER_REGS = 24;
constexpr int SMEM_MAX = 232448;  // a CTA's dynamic shared memory on the H100
constexpr float LOG2E = 1.4426950408889634f;

// K8's shared memory: Q and dO (BQ rows, loaded once), then STAGES K and V
// tiles of BK rows, then the barriers q_full, full[STAGES], empty[STAGES].
template <int D>
struct DqLayout {
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = Q_BYTES;
  static constexpr uint32_t k = 2 * Q_BYTES;                      // + s * KV_BYTES
  static constexpr uint32_t v = k + STAGES * KV_BYTES;            // + s * KV_BYTES
  static constexpr uint32_t bars = v + STAGES * KV_BYTES;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "box alignment");
  static_assert(bytes <= SMEM_MAX, "shared memory");
};

// K9's shared memory: K and V (BKV rows, loaded once), then STAGES Q and dO
// tiles of BQT rows, the stages' lse·log2(e) and delta (BQT floats each),
// then the barriers kv_full, full[STAGES], empty[STAGES].
template <int D>
struct DkvLayout {
  static constexpr uint32_t KV_BYTES = BKV * D * 2;
  static constexpr uint32_t QT_BYTES = BQT * D * 2;
  static constexpr uint32_t STATS_BYTES = 2 * BQT * 4;
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = KV_BYTES;
  static constexpr uint32_t q = 2 * KV_BYTES;                     // + s * QT_BYTES
  static constexpr uint32_t dout = q + STAGES * QT_BYTES;         // + s * QT_BYTES
  static constexpr uint32_t stats = dout + STAGES * QT_BYTES;     // + s * STATS_BYTES
  static constexpr uint32_t bars = stats + STAGES * STATS_BYTES;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * STAGES) + 1024;  // + alignment
  static_assert(KV_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0, "box alignment");
  static_assert(bytes <= SMEM_MAX, "shared memory");
};

// D[64 x N] += A B, A in registers, B MN-major in shared memory (N = D)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (N == 128) wgmma_rs_m64n128(d, a, b);
  else if constexpr (N == 64) wgmma_rs_m64n64(d, a, b);
  else wgmma_rs_m64n16(d, a, b);
}

__device__ __forceinline__ uint32_t align_smem(const unsigned char* raw) {
  return (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) + 1023u) & ~1023u;
}

// Write a consumer's two rows (row, row + 8 of its 64) of an m64nD fp32
// accumulator as bf16 to out (rows r0 and r0 + 8 at element stride sl),
// skipping rows >= rows.
template <int D>
__device__ __forceinline__ void store_rows(const float* acc, bf16* out, long long sl, int r0,
                                           int rows, int quad_col) {
  if (r0 < rows) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + r0 * sl + quad_col);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) dst[4 * i] = pack_bf16(acc[4 * i], acc[4 * i + 1]);
  }
  if (r0 + 8 < rows) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (r0 + 8) * sl + quad_col);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) dst[4 * i] = pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// ---------------------------------------------------------------------------
// K8: dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kv_len, bf16* __restrict__ dq, int N, int Lq,
                    int Lk, long long osb, long long osl, long long osn, float scale) {
  using L = DqLayout<D>;
  using S = Swizzle<D>;
  constexpr int SW = S::SW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align_smem(smem_raw);
  const uint32_t sq = base + L::q;
  const uint32_t sdo = base + L::dout;
  const uint32_t bar_q = base + L::bars;
  const uint32_t bar_f = bar_q + 8;               // + 8 s
  const uint32_t bar_e = bar_f + 8 * STAGES;      // + 8 s

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
      mbar_init(bar_f + 8 * s, 1);
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
      mbar_expect_tx(bar_q, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < S::BOXES; ++c) {
        tma_load(sq + c * BQ * SW, &tm_q, bar_q, c * S::SWE, q0, n, b);
        tma_load(sdo + c * BQ * SW, &tm_do, bar_q, c * S::SWE, q0, n, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);  // the stage's last tile is consumed
        const uint32_t sk = base + L::k + s * L::KV_BYTES;
        const uint32_t sv = base + L::v + s * L::KV_BYTES;
        mbar_expect_tx(bar_f + 8 * s, 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < S::BOXES; ++c) {
          tma_load(sk + c * BK * SW, &tm_k, bar_f + 8 * s, c * S::SWE, t * BK, n, b);
          tma_load(sv + c * BK * SW, &tm_v, bar_f + 8 * s, c * S::SWE, t * BK, n, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad_col = 2 * (lane % 4);   // first of this thread's 2 columns in each 8
    const int row = 16 * warp + lane / 4;  // this thread's rows: row and row + 8
    const int r0 = q0 + 64 * cw + row;
    const float scale_log2 = scale * LOG2E;
    // the rows' lse·log2(e) and delta; past Lq, lse = +inf makes P 0
    const float* lb = lse + static_cast<long long>(bn) * Lq;
    const float* db = delta + static_cast<long long>(bn) * Lq;
    const float l2_0 = r0 < Lq ? lb[r0] * LOG2E : INFINITY;
    const float l2_1 = r0 + 8 < Lq ? lb[r0 + 8] * LOG2E : INFINITY;
    const float de0 = r0 < Lq ? db[r0] : 0.f;
    const float de1 = r0 + 8 < Lq ? db[r0 + 8] : 0.f;

    float sacc[BK / 2];   // S: m64n64 accumulator
    float dpacc[BK / 2];  // dP
    float dqacc[D / 2];    // dQ: m64nD accumulator
    uint32_t ds[BK / 4];  // dS in bf16: the A operand of BK/16 k16 steps
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;

    // S = Q K^T and dP = dO V^T for the tile in stage s: D/16 k16 steps each
    auto issue_sdp = [&](int s) {
      const uint32_t sk = base + L::k + s * L::KV_BYTES;
      const uint32_t sv = base + L::v + s * L::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = (kk * 32) / SW, off = (kk * 32) % SW;
        const uint32_t a_off = box * BQ * SW + cw * 64 * SW + off;
        const uint32_t b_off = box * BK * SW + off;
        wgmma_ss_m64n64(sacc, smem_desc(sq + a_off, 16, 8 * SW, S::LAYOUT_TYPE),
                      smem_desc(sk + b_off, 16, 8 * SW, S::LAYOUT_TYPE), kk > 0);
        wgmma_ss_m64n64(dpacc, smem_desc(sdo + a_off, 16, 8 * SW, S::LAYOUT_TYPE),
                      smem_desc(sv + b_off, 16, 8 * SW, S::LAYOUT_TYPE), kk > 0);
      }
    };

    // dQ += dS K for the tile in stage s: BK/16 k16 steps
    auto issue_dq = [&](int s) {
      const uint32_t sk = base + L::k + s * L::KV_BYTES;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs<D>(dqacc, ds + 4 * j,
                    smem_desc(sk + j * 16 * SW, BK * SW, 8 * SW, S::LAYOUT_TYPE));
    };

    // P = exp2(S·scale·log2(e) − lse·log2(e)), 0 at keys >= klen;
    // dS = P∘(dP − delta)·scale, rounded to bf16
    auto grad = [&](int t) {
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
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float p0 = ex2(fmaf(sacc[4 * i], scale_log2, -l2_0));
        const float p1 = ex2(fmaf(sacc[4 * i + 1], scale_log2, -l2_0));
        const float p2 = ex2(fmaf(sacc[4 * i + 2], scale_log2, -l2_1));
        const float p3 = ex2(fmaf(sacc[4 * i + 3], scale_log2, -l2_1));
        // keys 8i..8i+7 are half of the k16 step i/2 (see K1's P)
        ds[2 * i] = pack_bf16(p0 * (dpacc[4 * i] - de0) * scale,
                              p1 * (dpacc[4 * i + 1] - de0) * scale);
        ds[2 * i + 1] = pack_bf16(p2 * (dpacc[4 * i + 2] - de1) * scale,
                                  p3 * (dpacc[4 * i + 3] - de1) * scale);
      }
    };

    if (ntiles > 0) {
      mbar_wait(bar_q, 0);
      mbar_wait(bar_f, 0);
      wgmma_fence();
      issue_sdp(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(sacc);
      fence_regs<BK / 2>(dpacc);
    }
    // Tile t: dS, then dQ += dS K of t and S, dP of t + 1 go out together.
    // The last tile is peeled off, so no product is issued under a condition.
    auto tile = [&](int t, bool more) {
      const int s = t % STAGES;
      grad(t);
      if (more) mbar_wait(bar_f + 8 * ((t + 1) % STAGES), ((t + 1) / STAGES) & 1);
      fence_regs<D / 2>(dqacc);
      wgmma_fence();
      issue_dq(s);
      if (more) issue_sdp((t + 1) % STAGES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dqacc);
      fence_regs<BK / 2>(sacc);
      fence_regs<BK / 2>(dpacc);
      if (tid == 0) mbar_arrive(bar_e + 8 * s);  // K and V of stage s are consumed
    };
    for (int t = 0; t + 1 < ntiles; ++t) tile(t, true);
    if (ntiles > 0) tile(ntiles - 1, false);

    store_rows<D>(dqacc, dq + b * osb + n * osn, osl, r0, Lq, quad_col);
  }
}

// ---------------------------------------------------------------------------
// K9: dK and dV
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_len, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int N, int Lq, int Lk, long long dksb,
                     long long dksl, long long dksn, long long dvsb, long long dvsl,
                     long long dvsn, float scale) {
  using L = DkvLayout<D>;
  using S = Swizzle<D>;
  constexpr int SW = S::SW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = align_smem(smem_raw);
  float* const stats = reinterpret_cast<float*>(
      smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw))) +
      L::stats);  // + s * 2 * BQT: lse·log2(e), then delta
  const uint32_t sk = base + L::k;
  const uint32_t sv = base + L::v;
  const uint32_t bar_kv = base + L::bars;
  const uint32_t bar_f = bar_kv + 8;              // + 8 s
  const uint32_t bar_e = bar_f + 8 * STAGES;      // + 8 s

  const int bn = blockIdx.y;
  const int b = bn / N;
  const int n = bn % N;
  const int kv0 = blockIdx.x * BKV;
  int klen = kv_len != nullptr ? min(kv_len[b], Lk) : Lk;
  klen = max(klen, 0);
  // a CTA whose kv rows all lie past kv_len loads nothing and writes zeros
  const int nq = kv0 < klen ? (Lq + BQT - 1) / BQT : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f + 8 * s, 32);  // the producer warp: TMA bytes and the stats
      mbar_init(bar_e + 8 * s, 2);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: warp 0; lane 0 issues the TMA loads -------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lane = threadIdx.x;
    if (threadIdx.x < 32 && nq > 0) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < S::BOXES; ++c) {
          tma_load(sk + c * BKV * SW, &tm_k, bar_kv, c * S::SWE, kv0, n, b);
          tma_load(sv + c * BKV * SW, &tm_v, bar_kv, c * S::SWE, kv0, n, b);
        }
      }
      const float* lb = lse + static_cast<long long>(bn) * Lq;
      const float* db = delta + static_cast<long long>(bn) * Lq;
      for (int t = 0; t < nq; ++t) {
        const int s = t % STAGES;
        mbar_wait(bar_e + 8 * s, ((t / STAGES) & 1) ^ 1);  // the stage's last tile is consumed
        float* st = stats + s * 2 * BQT;
#pragma unroll
        for (int h = 0; h < BQT / 32; ++h) {
          const int j = lane + 32 * h;
          const int r = t * BQT + j;
          st[j] = r < Lq ? lb[r] * LOG2E : INFINITY;  // P is 0 past Lq
          st[BQT + j] = r < Lq ? db[r] : 0.f;
        }
        if (lane == 0) {
          const uint32_t sq = base + L::q + s * L::QT_BYTES;
          const uint32_t sdo = base + L::dout + s * L::QT_BYTES;
          mbar_expect_tx(bar_f + 8 * s, 2 * L::QT_BYTES);
#pragma unroll
          for (int c = 0; c < S::BOXES; ++c) {
            tma_load(sq + c * BQT * SW, &tm_q, bar_f + 8 * s, c * S::SWE, t * BQT, n, b);
            tma_load(sdo + c * BQT * SW, &tm_do, bar_f + 8 * s, c * S::SWE, t * BQT, n, b);
          }
        } else {
          mbar_arrive(bar_f + 8 * s);  // releases this lane's stats
        }
      }
    }
  } else {
    // ---- consumers: 64 kv rows each --------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(240));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int quad_col = 2 * (lane % 4);   // first of this thread's 2 columns in each 8
    const int row = 16 * warp + lane / 4;  // this thread's rows: row and row + 8
    const int r0 = kv0 + 64 * cw + row;
    const bool live0 = r0 < klen, live1 = r0 + 8 < klen;  // keys past kv_len: P = 0
    const float scale_log2 = scale * LOG2E;

    float dkacc[D / 2], dvacc[D / 2];  // m64nD accumulators
    float sacc[BQT / 2];               // S^T: m64n64
    float dpacc[BQT / 2];              // dP^T
    uint32_t pt[BQT / 4], dst[BQT / 4];  // P^T and dS^T in bf16: A operands
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dkacc[i] = 0.f;
      dvacc[i] = 0.f;
    }

    // S^T = K Q^T and dP^T = V dO^T for the q tile in stage s: D/16 k16 steps
    auto issue_sdp = [&](int s) {
      const uint32_t sq = base + L::q + s * L::QT_BYTES;
      const uint32_t sdo = base + L::dout + s * L::QT_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t box = (kk * 32) / SW, off = (kk * 32) % SW;
        const uint32_t a_off = box * BKV * SW + cw * 64 * SW + off;
        const uint32_t b_off = box * BQT * SW + off;
        wgmma_ss_m64n64(sacc, smem_desc(sk + a_off, 16, 8 * SW, S::LAYOUT_TYPE),
                      smem_desc(sq + b_off, 16, 8 * SW, S::LAYOUT_TYPE), kk > 0);
        wgmma_ss_m64n64(dpacc, smem_desc(sv + a_off, 16, 8 * SW, S::LAYOUT_TYPE),
                      smem_desc(sdo + b_off, 16, 8 * SW, S::LAYOUT_TYPE), kk > 0);
      }
    };

    // dV += P^T dO and dK += dS^T Q for the q tile in stage s: BQT/16 k16 steps
    auto issue_dkv = [&](int s) {
      const uint32_t sq = base + L::q + s * L::QT_BYTES;
      const uint32_t sdo = base + L::dout + s * L::QT_BYTES;
#pragma unroll
      for (int j = 0; j < BQT / 16; ++j) {
        wgmma_rs<D>(dvacc, pt + 4 * j,
                    smem_desc(sdo + j * 16 * SW, BQT * SW, 8 * SW, S::LAYOUT_TYPE));
        wgmma_rs<D>(dkacc, dst + 4 * j,
                    smem_desc(sq + j * 16 * SW, BQT * SW, 8 * SW, S::LAYOUT_TYPE));
      }
    };

    // P^T and dS^T in bf16 from S^T, dP^T and the columns' lse and delta
    auto grad = [&](int s) {
      const float* l2 = stats + s * 2 * BQT;
      const float* de = l2 + BQT;
#pragma unroll
      for (int i = 0; i < BQT / 8; ++i) {
        const float2 lc = *reinterpret_cast<const float2*>(l2 + 8 * i + quad_col);
        const float2 dc = *reinterpret_cast<const float2*>(de + 8 * i + quad_col);
        const float p0 = live0 ? ex2(fmaf(sacc[4 * i], scale_log2, -lc.x)) : 0.f;
        const float p1 = live0 ? ex2(fmaf(sacc[4 * i + 1], scale_log2, -lc.y)) : 0.f;
        const float p2 = live1 ? ex2(fmaf(sacc[4 * i + 2], scale_log2, -lc.x)) : 0.f;
        const float p3 = live1 ? ex2(fmaf(sacc[4 * i + 3], scale_log2, -lc.y)) : 0.f;
        pt[2 * i] = pack_bf16(p0, p1);
        pt[2 * i + 1] = pack_bf16(p2, p3);
        dst[2 * i] = pack_bf16(p0 * (dpacc[4 * i] - dc.x) * scale,
                               p1 * (dpacc[4 * i + 1] - dc.y) * scale);
        dst[2 * i + 1] = pack_bf16(p2 * (dpacc[4 * i + 2] - dc.x) * scale,
                                   p3 * (dpacc[4 * i + 3] - dc.y) * scale);
      }
    };

    if (nq > 0) {
      mbar_wait(bar_kv, 0);
      mbar_wait(bar_f, 0);
      wgmma_fence();
      issue_sdp(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BQT / 2>(sacc);
      fence_regs<BQT / 2>(dpacc);
    }
    // Tile t: P^T and dS^T, then dV and dK of t and S^T, dP^T of t + 1 go
    // out together; the last tile is peeled off. Stage t is released after
    // the wait that covers its last product (Q and dO are each read twice).
    auto tile = [&](int t, bool more) {
      const int s = t % STAGES;
      grad(s);
      if (more) mbar_wait(bar_f + 8 * ((t + 1) % STAGES), ((t + 1) / STAGES) & 1);
      fence_regs<D / 2>(dvacc);
      fence_regs<D / 2>(dkacc);
      wgmma_fence();
      issue_dkv(s);
      if (more) issue_sdp((t + 1) % STAGES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dvacc);
      fence_regs<D / 2>(dkacc);
      fence_regs<BQT / 2>(sacc);
      fence_regs<BQT / 2>(dpacc);
      if (tid == 0) mbar_arrive(bar_e + 8 * s);  // Q, dO and the stats of stage s are consumed
    };
    for (int t = 0; t + 1 < nq; ++t) tile(t, true);
    if (nq > 0) tile(nq - 1, false);

    store_rows<D>(dkacc, dk + b * dksb + n * dksn, dksl, r0, Lk, quad_col);
    store_rows<D>(dvacc, dv + b * dvsb + n * dvsn, dvsl, r0, Lk, quad_col);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launch
// ---------------------------------------------------------------------------

struct Strides {
  long long b, l, n;
};

struct Inputs {
  const void *q, *k, *v, *dout, *lse, *delta, *kv_len;
  int B, Lq, Lk, N;
  Strides qs, ks, vs, dos;
  float scale;
};

// The four input maps: q and dO in boxes of q_rows, k and v of kv_rows; a
// map over an empty length stays zero (the kernel issues no load from it).
template <int D>
cudaError_t encode_inputs(const Inputs& in, int q_rows, int kv_rows, CUtensorMap* tm) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const bool ok =
      (in.Lq == 0 ||
       (encode<D>(fn, &tm[0], in.q, in.B, in.Lq, in.N, in.qs.b, in.qs.l, in.qs.n, q_rows) &&
        encode<D>(fn, &tm[1], in.dout, in.B, in.Lq, in.N, in.dos.b, in.dos.l, in.dos.n,
                  q_rows))) &&
      (in.Lk == 0 ||
       (encode<D>(fn, &tm[2], in.k, in.B, in.Lk, in.N, in.ks.b, in.ks.l, in.ks.n, kv_rows) &&
        encode<D>(fn, &tm[3], in.v, in.B, in.Lk, in.N, in.vs.b, in.vs.l, in.vs.n, kv_rows)));
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_dq(const Inputs& in, void* dq, Strides dqs, cudaStream_t stream) {
  CUtensorMap tm[4] = {};
  cudaError_t err = encode_inputs<D>(in, BQ, BK, tm);
  if (err != cudaSuccess) return err;
  constexpr int bytes = static_cast<int>(DqLayout<D>::bytes);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((in.Lq + BQ - 1) / BQ, in.B * in.N);
  flash_bwd_dq_kernel<D><<<grid, 384, bytes, stream>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(in.lse),
      static_cast<const float*>(in.delta), static_cast<const int*>(in.kv_len),
      static_cast<bf16*>(dq), in.N, in.Lq, in.Lk, dqs.b, dqs.l, dqs.n, in.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Inputs& in, void* dk, void* dv, Strides dks, Strides dvs,
                       cudaStream_t stream) {
  CUtensorMap tm[4] = {};
  cudaError_t err = encode_inputs<D>(in, BQT, BKV, tm);
  if (err != cudaSuccess) return err;
  constexpr int bytes = static_cast<int>(DkvLayout<D>::bytes);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((in.Lk + BKV - 1) / BKV, in.B * in.N);
  flash_bwd_dkv_kernel<D><<<grid, 384, bytes, stream>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(in.lse),
      static_cast<const float*>(in.delta), static_cast<const int*>(in.kv_len),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), in.N, in.Lq, in.Lk, dks.b, dks.l,
      dks.n, dvs.b, dvs.l, dvs.n, in.scale);
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
  const Inputs in{q, k, v, dout, lse, delta, kv_len, B, Lq, Lk, N,
                  {qsb, qsl, qsn}, {ksb, ksl, ksn}, {vsb, vsl, vsn}, {dosb, dosl, dosn},
                  scale};
  const Strides dqs{dqsb, dqsl, dqsn};
  if (D == 16) return launch_dq<16>(in, dq, dqs, s);
  if (D == 64) return launch_dq<64>(in, dq, dqs, s);
  if (D == 128) return launch_dq<128>(in, dq, dqs, s);
  return cudaErrorInvalidValue;
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
  const Inputs in{q, k, v, dout, lse, delta, kv_len, B, Lq, Lk, N,
                  {qsb, qsl, qsn}, {ksb, ksl, ksn}, {vsb, vsl, vsn}, {dosb, dosl, dosn},
                  scale};
  const Strides dks{dksb, dksl, dksn}, dvs{dvsb, dvsl, dvsn};
  if (D == 16) return launch_dkv<16>(in, dk, dv, dks, dvs, s);
  if (D == 64) return launch_dkv<64>(in, dk, dv, dks, dvs, s);
  if (D == 128) return launch_dkv<128>(in, dk, dv, dks, dvs, s);
  return cudaErrorInvalidValue;
}
