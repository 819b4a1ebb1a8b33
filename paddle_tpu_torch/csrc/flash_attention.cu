// Flash attention, forward and backward (dQ; dK and dV), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` (:41, launched by `_flash_call` at :176), `_bwd_dq_kernel`
// (:81, launched at :220) and `_bwd_dkv_kernel` (:112, launched at :238),
// and computes what they compute, over q (BH, Lq, D) and k, v (BH, Lk, D):
//
//   S   = (q * scale) k^T, in float32, plus -1e30 where a causal key lies
//         past its query (query row r sees key c when r + Lk - Lq >= c)
//   fwd O = softmax(S) v in q's type, lse = rowmax + log(rowsum) float32
//   dQ  = (P o (dO v^T - delta)) k * scale,  P = exp(S - lse)
//   dK  = (P o (dO v^T - delta))^T (q * scale),  dV = P^T dO
//
// with delta = rowsum(dO o O) computed by the caller from the stored O.
// q, k, v, O, dO, dQ, dK and dV are all float32, all bfloat16 or all
// float16 (the TPU kernel computes in float32 whatever the type and rounds
// only its stores, flash_attention.py:44-146); every
// sum is float32, and P and dS hold float32 accuracy (to ~16 bits in
// the tensor-core kernels below), as on the TPU.
//
// Two designs, chosen by a static dispatch on (dtype, D) and never as a
// fallback:
//
//   bfloat16 and float16, D = 64 and 128: the forward, dQ and dK/dV on
//   the tensor
//     cores (flash_fwd_tc_kernel, flash_bwd_dq_tc_kernel,
//     flash_bwd_dkv_tc_kernel, "Tensor-core kernels" below);
//   everything else (float32 at every D; bfloat16 and float16 at D = 192
//   and 256):
//     the CUDA-core kernels, as follows.
//
// Float32 stays on the CUDA cores: no main path runs flash in float32
// (gpt_small's dropout 0.1 gates it off), and the float32 tolerance
// (1e-5) is beyond TF32's ten-bit mantissa.
//
// CUDA-core design. The TPU kernels carry the online-softmax state (m, l,
// acc) in VMEM across a sequential grid axis and hold a whole (L, D) K or
// V block in VMEM. Here blocks run in no order and a CTA has at most
// 227 KB of shared memory, so each CTA owns one tile of B rows (B = 64
// for D <= 128, 32 above) and loops over the tiles of the other side
// itself, staging each in shared memory as float32 (row stride D + 1, so
// the 16 threads that read 16 different rows of a tile hit 16 banks):
//
//   forward  one CTA per (bh, q-tile): loops over the k-tiles up to the
//            diagonal with (m, l, acc) in registers;
//   dQ       one CTA per (bh, q-tile): the same loop, dQ in registers;
//   dK/dV    one CTA per (bh, k-tile): loops over the q-tiles from the
//            first one that sees the tile, dK and dV in registers.
//
// No CTA writes what another writes, so there are no atomics: every
// output is the same bits on every run. 256 threads form a 16 x 16 grid;
// thread (ty, tx) computes the scores of rows ty + 16i and columns
// tx + 16j of a B x B tile, reduces a row's max and sum across its 16
// threads with shuffles, and passes P (or dS) to the product with the
// next operand through shared memory. Rows and columns past Lq or Lk
// are masked, so any L is taken; causal q-tiles are scheduled heaviest
// first. The products run on the CUDA cores in float32 (67 TFLOP/s on an
// H100 SXM): q is scaled before QK^T, and P and dS stay float32.
//
// Tensor-core design (bfloat16 and float16, D = 64 and 128; the kernels
// are templates on the 16-bit type T, written below for bfloat16). 128
// threads, 4 warps; every product is mma.sync.m16n8k16 on T operands
// (.bf16 or .f16) with float32
// sums (mma_bf16.cuh), fed by ldmatrix from shared memory, with rows
// D + 8 bfloat16 apart (16 bytes of skew a row, so the 8 rows of one
// ldmatrix hit 8 different bank groups). Tiles of the side a CTA loops
// over come through a two-stage ring filled by cp.async one tile ahead.
//
//   operands  q, k, v and dO exactly as stored: a product of two
//             bfloat16 is exact in float32, so S and dP are the plain
//             version's up to the order of the float32 sum;
//   scale     applied in float32 after the product, S = (q k^T) scale
//             and dK = (dS^T q) scale, never by rounding q * scale to
//             bfloat16 (1/sqrt(D) is not a power of two at D = 128);
//   P and dS  float32 in registers; where one is the A operand of the
//             next product it is split into hi = bf16(x) and lo =
//             bf16(x - hi), and both halves go into the same float32
//             accumulator. Rounded once to bfloat16, P and dS miss the
//             tolerance against the float32 plain version (one bfloat16
//             step of O, dK and dV): tests/test_torch_smoke_checks.py
//             emulates both on the CPU.
//
//   forward  one CTA per (bh, 64-row q-tile), each warp 16 query rows;
//            Q's A fragments stay in registers for the whole loop. Per
//            64-key tile: S = Q K^T (K's B fragments by ldmatrix), the
//            row max and sum close across the 4 lanes that share a row
//            (two xor shuffles), P = exp(S - m) turns into A fragments
//            from the S accumulator registers with no shared-memory
//            trip, and O += P_hi V + P_lo V (V by ldmatrix.trans). The
//            loop stops at `last`; heavy causal q-tiles go first.
//   dQ       one CTA per (bh, 64-row q-tile), each warp 16 query rows,
//            the lane's two lse and delta values in registers, K and V
//            through the ring. Per 64-key tile: S = Q K^T and dP = dO
//            V^T (K and V as B operands), P = exp(S scale - lse) masked
//            as in the forward, dS = P o (dP - delta) in dP's
//            accumulator registers, dQ += dS_hi K + dS_lo K (K by
//            ldmatrix.trans), times scale at the end: 4 MMA units a
//            (q, k) tile pair. Q's and dO's A fragments stay in registers
//            at D = 64; at D = 128 they are read again from shared memory
//            every k-tile, which keeps dQ (64 registers), S and dP (64)
//            clear of spills. The loop stops at `last`; heavy causal
//            q-tiles go first. One CTA writes each dQ row, with no
//            atomics (FlashAttention-2 adds dQ from the dK/dV CTAs with
//            float32 atomics, which would change its bits run to run).
//   dK/dV    one CTA per (bh, 64-key tile), each warp 16 keys, in the
//            transposed form so that every intermediate stays in
//            registers: S^T = K Q^T, P^T = exp(S^T scale - lse_col),
//            dV += P^T dO, dP^T = V dO^T, dS^T = P^T o (dP^T -
//            delta_col), dK += dS^T Q, times scale at the end. K and V
//            stay in shared memory for the CTA; Q, dO, lse and delta come
//            through the ring, one q-tile (64 queries at D = 64, 32 at
//            D = 128, for the registers of dK and dV) at a time from
//            `first`. One CTA writes each dK and dV row, with no atomics:
//            the same bits on every run.
//
// D = 192 and 256 stay on the CUDA-core kernels: dK and dV of 16 keys x
// D float32 per warp would not fit in a thread's 255 registers without
// splitting D.
//
// Bound on an H100 SXM at the bench_gpt shape (BH = 192, L = 1024,
// D = 64, causal, bfloat16): counted at the bfloat16 tensor-core rate
// (989 TFLOP/s) against 3.35 TB/s, the forward is bound by its bytes
// (~0.030 ms), dQ by its operations (~0.039 ms) and dK/dV by its
// operations (~0.052 ms). The split doubles the MMAs of P V, dS K, P^T dO
// and dS^T Q: 1.5x the products of the forward and of dK/dV, 4/3 of dQ's.
// mma.sync reaches only part of the card's 989 TFLOP/s (wgmma, fed by
// TMA, is the full path), so the tensor-core kernels aim at a few times
// that bound, not at the bound.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr float kMaskAdd = -1e30f;  // the TPU kernel's additive causal mask

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// max and sum over the 16 lanes that share a row (xor offsets below 16
// stay inside a half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
struct Cfg {
  static constexpr int B = D <= 128 ? 64 : 32;  // tile rows
  static constexpr int R = B / 16;   // rows (and columns) of S a thread owns
  static constexpr int DC = D / 16;  // output columns a thread owns
  static constexpr int S = D + 1;    // shared-memory row stride (floats)
  static constexpr int PS = B + 1;   // row stride of the P / dS tile
};

// rows [row0, row0 + B) of src (L, D) into dst (B, D + 1) as float32
// times `mul`; rows at or past L are 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int L, float mul) {
  constexpr int B = Cfg<D>::B, S = Cfg<D>::S;
  for (int idx = threadIdx.x; idx < B * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float v = 0.f;
    if (row0 + r < L) v = to_float(src[(size_t)(row0 + r) * D + c]) * mul;
    dst[r * S + c] = v;
  }
}

// the additive causal mask of query row `qrow` and key `kcol`
__device__ __forceinline__ float masked(float s, int qrow, int kcol,
                                        int offset, int causal) {
  return (causal && qrow + offset < kcol) ? s + kMaskAdd : s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, float scale,
                 int causal) {
  constexpr int B = Cfg<D>::B, R = Cfg<D>::R, DC = Cfg<D>::DC;
  constexpr int S = Cfg<D>::S, PS = Cfg<D>::PS;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + B * S;
  float* vs = ks + B * S;
  float* ps = vs + B * S;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (Lq + B - 1) / B, nk = (Lk + B - 1) / B;
  const int qi = nq - 1 - blockIdx.x;  // the longest causal loops first
  const int bh = blockIdx.y;
  const int q0 = qi * B, offset = Lk - Lq;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  load_tile<T, D>(qs, q + (size_t)bh * Lq * D, q0, Lq, scale);

  float acc[R][DC], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMaskAdd;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  // skip the k-tiles past the diagonal (flash_attention.py:69-70)
  const int last = causal ? min(nk, (q0 + 2 * B - 1 + offset) / B) : nk;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * B;
    __syncthreads();  // the last tile's readers are done with ks, vs, ps
    load_tile<T, D>(ks, kb, k0, Lk, 1.f);
    load_tile<T, D>(vs, vb, k0, Lk, 1.f);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[R], b[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = qs[(ty + 16 * i) * S + d];
#pragma unroll
      for (int j = 0; j < R; ++j) b[j] = ks[(tx + 16 * j) * S + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qrow = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kcol = k0 + tx + 16 * j;
        // a column past Lk has no weight at all
        s[i][j] = kcol < Lk ? masked(s[i][j], qrow, kcol, offset, causal)
                            : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = row_max(mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float p[R], vv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= Lq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * Lq + qrow) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_float<T>(acc[i][c] / li);
    if (tx == 0) lse[(size_t)bh * Lq + qrow] = m[i] + logf(li);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Lq, int Lk, float scale, int causal) {
  constexpr int B = Cfg<D>::B, R = Cfg<D>::R, DC = Cfg<D>::DC;
  constexpr int S = Cfg<D>::S, PS = Cfg<D>::PS;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + B * S;
  float* ks = dos + B * S;
  float* vs = ks + B * S;
  float* dss = vs + B * S;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (Lq + B - 1) / B, nk = (Lk + B - 1) / B;
  const int qi = nq - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qi * B, offset = Lk - Lq;
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  load_tile<T, D>(qs, q + (size_t)bh * Lq * D, q0, Lq, scale);
  load_tile<T, D>(dos, dout + (size_t)bh * Lq * D, q0, Lq, 1.f);
  float lse_r[R], delta_r[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qrow = q0 + ty + 16 * i;
    lse_r[i] = qrow < Lq ? lse[(size_t)bh * Lq + qrow] : 0.f;
    delta_r[i] = qrow < Lq ? delta[(size_t)bh * Lq + qrow] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  // (flash_attention.py:104-105)
  const int last = causal ? min(nk, (q0 + 2 * B - 1 + offset) / B) : nk;
  for (int kt = 0; kt < last; ++kt) {
    const int k0 = kt * B;
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, Lk, 1.f);
    load_tile<T, D>(vs, vb, k0, Lk, 1.f);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], g[R], b[R], w[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = qs[(ty + 16 * i) * S + d];
        g[i] = dos[(ty + 16 * i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        b[j] = ks[(tx + 16 * j) * S + d];
        w[j] = vs[(tx + 16 * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qrow = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kcol = k0 + tx + 16 * j;
        const float p =
            kcol < Lk
                ? expf(masked(s[i][j], qrow, kcol, offset, causal) - lse_r[i])
                : 0.f;
        dss[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < B; ++kk) {
      float ds[R], kv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dss[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[kk * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= Lq) continue;
    T* row = dq + ((size_t)bh * Lq + qrow) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = from_float<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Lq, int Lk, float scale,
                     int causal) {
  constexpr int B = Cfg<D>::B, R = Cfg<D>::R, DC = Cfg<D>::DC;
  constexpr int S = Cfg<D>::S, PS = Cfg<D>::PS;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + B * S;
  float* qs = vs + B * S;
  float* dos = qs + B * S;
  float* ps = dos + B * S;
  float* dss = ps + B * PS;
  float* lse_s = dss + B * PS;
  float* delta_s = lse_s + B;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (Lq + B - 1) / B;
  const int ki = blockIdx.x;  // low k-tiles see the most q-tiles: first
  const int bh = blockIdx.y;
  const int k0 = ki * B, offset = Lk - Lq;
  const T* qb = q + (size_t)bh * Lq * D;
  const T* ob = dout + (size_t)bh * Lq * D;
  load_tile<T, D>(ks, k + (size_t)bh * Lk * D, k0, Lk, 1.f);
  load_tile<T, D>(vs, v + (size_t)bh * Lk * D, k0, Lk, 1.f);
  float dk_acc[R][DC], dv_acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // q-tiles before the diagonal never see this k-tile
  // (flash_attention.py:141)
  const int first = (causal && k0 > offset) ? (k0 - offset) / B : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * B;
    __syncthreads();
    load_tile<T, D>(qs, qb, q0, Lq, scale);
    load_tile<T, D>(dos, ob, q0, Lq, 1.f);
    for (int r = threadIdx.x; r < B; r += kThreads) {
      const bool in = q0 + r < Lq;
      lse_s[r] = in ? lse[(size_t)bh * Lq + q0 + r] : 0.f;
      delta_s[r] = in ? delta[(size_t)bh * Lq + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    // rows of S are queries (ty + 16i), columns keys (tx + 16j)
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], g[R], b[R], w[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = qs[(ty + 16 * i) * S + d];
        g[i] = dos[(ty + 16 * i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        b[j] = ks[(tx + 16 * j) * S + d];
        w[j] = vs[(tx + 16 * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i, qrow = q0 + r;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kcol = k0 + tx + 16 * j;
        const float p =
            (qrow < Lq && kcol < Lk)
                ? expf(masked(s[i][j], qrow, kcol, offset, causal) - lse_s[r])
                : 0.f;
        ps[r * PS + tx + 16 * j] = p;
        dss[r * PS + tx + 16 * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    // this thread's accumulator rows are keys ty + 16i
#pragma unroll 4
    for (int qq = 0; qq < B; ++qq) {
      float p[R], ds[R], gv[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        p[i] = ps[qq * PS + ty + 16 * i];
        ds[i] = dss[qq * PS + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gv[c] = dos[qq * S + tx + 16 * c];
        qv[c] = qs[qq * S + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(p[i], gv[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds[i], qv[c], dk_acc[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int krow = k0 + ty + 16 * i;
    if (krow >= Lk) continue;
    T* dkr = dk + ((size_t)bh * Lk + krow) * D;
    T* dvr = dv + ((size_t)bh * Lk + krow) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkr[tx + 16 * c] = from_float<T>(dk_acc[i][c]);
      dvr[tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// -- tensor-core kernels (bfloat16 and float16, D = 64 and 128) -------------
//
// float16 differs from bfloat16 in its range: 65504 at most, subnormal
// below 2^-14. P (in [0, 1]) and the stored operands fit it. dS does not:
// under the dynamic loss scaler dO arrives multiplied by up to 2^15, and
// dP = dO V^T, a float32 sum of D products, can then pass 65504, so a
// dS rounded as it is would turn into inf where the TPU kernel's float32
// dS (flash_attention.py:92-96) stays finite, and the scaler would skip
// a step the reference takes. So in float16 each row of dS is multiplied
// by an exact power of two before its split (fit_rows), and the
// accumulator is brought back by the inverse power at the end: the
// halves hold what float32 held, and no rounding to inf can happen where
// the float32 value is finite. In bfloat16 (float32's range) the kernels
// skip this and keep the bits they had.

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcCfg {
  static constexpr int BM = 64;                  // forward: queries a CTA
  static constexpr int BN = 64;                  // keys a tile / a dK/dV CTA
  static constexpr int BQ = D <= 64 ? 64 : 32;   // dK/dV: queries a tile
  static constexpr int LD = D + 8;               // smem row stride (bf16)
  static constexpr int KC = D / 16;              // 16-wide chunks of D
};

// rows [row0, row0 + R) of src (L, D) into dst (R, LD) by cp.async; rows
// at or past L are zeros
template <int D, int R, typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src,
                                           int row0, int L) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  static_assert(R * CH % kTcThreads == 0, "a tile is whole chunks a thread");
#pragma unroll
  for (int i = 0; i < R * CH / kTcThreads; ++i) {
    const int c = threadIdx.x + i * kTcThreads;
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = row0 + r < L;
    tc::cp_async_16(dst + r * TcCfg<D>::LD + col,
                    src + (size_t)(ok ? row0 + r : 0) * D + col, ok);
  }
}

// entries [row0, row0 + R) of the float32 vector src (L) into dst (R)
template <int R>
__device__ __forceinline__ void rows_async(float* dst, const float* src,
                                           int row0, int L) {
  for (int r = threadIdx.x; r < R; r += kTcThreads) {
    const bool ok = row0 + r < L;
    tc::cp_async_4(dst + r, src + (ok ? row0 + r : 0), ok);
  }
}

// max and sum over the 4 lanes of a quad (the lanes that share a row of
// an mma accumulator)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the B fragments of two n-tiles (16 rows of `tile`, an n-tile 8 of
// them) at k-chunk kc, for a product with tile^T: rows are n, columns k
template <int LD, typename T>
__device__ __forceinline__ void ldsm_nk(uint32_t (&b)[4], const T* tile,
                                        int row0, int kc, int lane) {
  tc::ldsm_x4(b, tile + (row0 + (lane >> 4) * 8 + (lane & 7)) * LD +
                     kc * 16 + ((lane >> 3) & 1) * 8);
}

// the B fragments of two n-tiles (columns c0 .. c0 + 15 of `tile`) at the
// 16 rows from k0, for a product with tile itself: rows are k, columns n
template <int LD, typename T>
__device__ __forceinline__ void ldsm_kn(uint32_t (&b)[4], const T* tile,
                                        int k0, int c0, int lane) {
  tc::ldsm_x4_t(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       c0 + (lane >> 4) * 8);
}

// the A fragment of rows row0 .. row0 + 15 of `tile` at k-chunk kc
template <int LD, typename T>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const T* tile,
                                       int row0, int kc, int lane) {
  tc::ldsm_x4(a, tile + (row0 + (lane & 15)) * LD + kc * 16 +
                     (lane >> 4) * 8);
}

// the A fragments (hi and lo halves) of k-chunk kk of a 16 x 8n float32
// accumulator: its n-tiles 2 kk and 2 kk + 1
template <typename T>
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  tc::split<T>(c0[0], c0[1], hi[0], lo[0]);
  tc::split<T>(c0[2], c0[3], hi[1], lo[1]);
  tc::split<T>(c1[0], c1[1], hi[2], lo[2]);
  tc::split<T>(c1[2], c1[3], hi[3], lo[3]);
}

// c[n] += a b[n] for the two n-tiles of one ldmatrix x4 of B, hi and lo
template <typename T>
__device__ __forceinline__ void mma_split(float (&c0)[4], float (&c1)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          const uint32_t (&b)[4]) {
  tc::mma<T>(c0, hi, b[0], b[1]);
  tc::mma<T>(c0, lo, b[0], b[1]);
  tc::mma<T>(c1, hi, b[2], b[3]);
  tc::mma<T>(c1, lo, b[2], b[3]);
}

// dS is split into float16 halves only after each of this lane's two
// rows (accumulator entries e >> 1 == i) is multiplied by an exact power
// of two, 2^(14 - ex[i]), ex[i] the largest exponent (ilogb) of the row's
// |dS| so far: the row's largest value lands in [2^14, 2^15), below
// float16's 65504, so no finite float32 dS rounds to inf (under a loss
// scale of up to 2^15, dO V^T alone can pass 65504), and small ones keep
// their bits instead of flushing to float16's subnormals. `acc` holds
// the row's sums at the current scale; when a tile raises ex[i], acc's
// row is brought to the new scale by an exact power of two. The caller
// multiplies acc by 2^(ex[i] - 14) at the end. ex starts at kFitMinExp,
// so the scale stays a normal float32. A NaN or all-zero row keeps its
// scale (NaN flows on as it would in float32).
constexpr int kFitMinExp = -112;
constexpr int kFitTop = 14;

template <int NT, int DT>
__device__ __forceinline__ void fit_rows(float (&ds)[NT][4],
                                         float (&acc)[DT][4], int (&ex)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(ds[j][e]));
  float mul[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m = quad_max(mx[i]);
    const int e = m > 0.f ? (isinf(m) ? 127 : ilogbf(m)) : ex[i];
    if (e > ex[i]) {
      const float r = scalbnf(1.f, ex[i] - e);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][2 * i] *= r;
        acc[j][2 * i + 1] *= r;
      }
      ex[i] = e;
    }
    mul[i] = scalbnf(1.f, kFitTop - ex[i]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[j][e] *= mul[e >> 1];
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int Lq, int Lk, float scale,
                    int causal) {
  using C = TcCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, KC = C::KC;
  constexpr int NT = BN / 8;  // n-tiles of S
  constexpr int DT = D / 8;   // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + BM * LD;      // two stages
  T* vs = ks + 2 * BN * LD;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Lq + BM - 1) / BM, nk = (Lk + BN - 1) / BN;
  const int qi = nq - 1 - blockIdx.x;  // the longest causal loops first
  const int bh = blockIdx.y;
  const int q0 = qi * BM, offset = Lk - Lq;
  const int wr = warp * 16;  // the warp's first row in the q-tile
  const int row_a = q0 + wr + g, row_b = row_a + 8;  // this lane's rows
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  // skip the k-tiles past the diagonal (flash_attention.py:69-70)
  const int last = causal ? min(nk, (q0 + BM + BN - 1 + offset) / BN) : nk;

  tile_async<D, BM>(qs, q + (size_t)bh * Lq * D, q0, Lq);
  if (last > 0) {
    tile_async<D, BN>(ks, kb, 0, Lk);
    tile_async<D, BN>(vs, vb, 0, Lk);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) ldsm_a<LD>(qf[kc], qs, wr, kc, lane);

  float acc[DT][4] = {};
  float m[2] = {kMaskAdd, kMaskAdd}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < last; ++kt) {
    if (kt + 1 < last) {  // the next tile into the other stage
      const int st = (kt + 1) & 1;
      tile_async<D, BN>(ks + st * BN * LD, kb, (kt + 1) * BN, Lk);
      tile_async<D, BN>(vs + st * BN * LD, vb, (kt + 1) * BN, Lk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const T* kst = ks + (kt & 1) * BN * LD;
    const T* vst = vs + (kt & 1) * BN * LD;
    const int k0 = kt * BN;

    float s[NT][4] = {};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_nk<LD>(b, kst, np * 16, kc, lane);
        tc::mma<T>(s[2 * np], qf[kc], b[0], b[1]);
        tc::mma<T>(s[2 * np + 1], qf[kc], b[2], b[3]);
      }

    // scale, mask, and the online softmax of this lane's two rows
    const bool edge =
        k0 + BN > Lk || (causal && q0 + wr + offset < k0 + BN - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          x = masked(x, e < 2 ? row_a : row_b, col, offset, causal);
          if (col >= Lk) x = -INFINITY;  // no weight at all
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
      l[i] *= alpha[i];  // a lane's partial sum; the quad's closes at the end
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V, P in two halves of T straight from the registers of S
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a<T>(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_kn<LD>(b, vst, kk * 16, dp * 16, lane);
        mma_split<T>(acc[2 * dp], acc[2 * dp + 1], hi, lo, b);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
    if (rows[i] >= Lq) continue;
    T* orow = o + ((size_t)bh * Lq + rows[i]) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          tc::pack2<T>(acc[j][2 * i] / li, acc[j][2 * i + 1] / li);
    if (t == 0) lse[(size_t)bh * Lq + rows[i]] = m[i] + logf(li);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv,
                        int Lq, int Lk, float scale, int causal) {
  using C = TcCfg<D>;
  constexpr int BN = C::BN, BQ = C::BQ, LD = C::LD, KC = C::KC;
  constexpr int NT = BQ / 8;  // n-tiles of S^T (queries)
  constexpr int DT = D / 8;   // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BN * LD;
  T* qs = vs + BN * LD;        // two stages
  T* dos = qs + 2 * BQ * LD;   // two stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // two
  float* dlt_s = lse_s + 2 * BQ;                               // two
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Lq + BQ - 1) / BQ;
  const int ki = blockIdx.x;  // low k-tiles see the most q-tiles: first
  const int bh = blockIdx.y;
  const int k0 = ki * BN, offset = Lk - Lq;
  const int wk = warp * 16;  // the warp's first key in the k-tile
  const int key_a = k0 + wk + g, key_b = key_a + 8;  // this lane's keys
  const T* qb = q + (size_t)bh * Lq * D;
  const T* ob = dout + (size_t)bh * Lq * D;
  const float* lb = lse + (size_t)bh * Lq;
  const float* db = delta + (size_t)bh * Lq;
  // q-tiles before the diagonal never see this k-tile
  // (flash_attention.py:141)
  const int first = (causal && k0 > offset) ? (k0 - offset) / BQ : 0;

  tile_async<D, BN>(ks, k + (size_t)bh * Lk * D, k0, Lk);
  tile_async<D, BN>(vs, v + (size_t)bh * Lk * D, k0, Lk);
  auto load_q = [&](int qt, int st) {
    tile_async<D, BQ>(qs + st * BQ * LD, qb, qt * BQ, Lq);
    tile_async<D, BQ>(dos + st * BQ * LD, ob, qt * BQ, Lq);
    rows_async<BQ>(lse_s + st * BQ, lb, qt * BQ, Lq);
    rows_async<BQ>(dlt_s + st * BQ, db, qt * BQ, Lq);
  };
  if (first < nq) load_q(first, 0);
  tc::cp_async_commit();

  float dka[DT][4] = {}, dva[DT][4] = {};
  // float16: dS^T's rows (keys) are fitted to its range (fit_rows)
  constexpr bool kFit = std::is_same<T, __half>::value;
  int ex[2] = {kFitMinExp, kFitMinExp};
  for (int qt = first; qt < nq; ++qt) {
    const int st = (qt - first) & 1;
    if (qt + 1 < nq) load_q(qt + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this q-tile (and K, V) have landed
    __syncthreads();
    const T* qst = qs + st * BQ * LD;
    const T* dost = dos + st * BQ * LD;
    const float* lst = lse_s + st * BQ;
    const float* dlst = dlt_s + st * BQ;
    const int q0 = qt * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries a warp
    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t kf[4], vf[4];
      ldsm_a<LD>(kf, ks, wk, kc, lane);
      ldsm_a<LD>(vf, vs, wk, kc, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_nk<LD>(b, qst, np * 16, kc, lane);
        tc::mma<T>(s[2 * np], kf, b[0], b[1]);
        tc::mma<T>(s[2 * np + 1], kf, b[2], b[3]);
        ldsm_nk<LD>(b, dost, np * 16, kc, lane);
        tc::mma<T>(dp[2 * np], vf, b[0], b[1]);
        tc::mma<T>(dp[2 * np + 1], vf, b[2], b[3]);
      }
    }

    // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta), the
    // columns being queries; P is 0 past Lq or Lk
    const bool edge = q0 + BQ > Lq || k0 + wk + 16 > Lk ||
                      (causal && q0 + offset < k0 + wk + 15);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;  // this lane's first query column
      const float2 ls = *reinterpret_cast<const float2*>(lst + c);
      const float2 dl = *reinterpret_cast<const float2*>(dlst + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        bool zero = false;
        if (edge) {
          const int qrow = q0 + c + (e & 1), key = e < 2 ? key_a : key_b;
          x = masked(x, qrow, key, offset, causal);
          zero = qrow >= Lq || key >= Lk;
        }
        const float p =
            zero ? 0.f : exp2f((x - ((e & 1) ? ls.y : ls.x)) * kLog2e);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
      }
    }

    if constexpr (kFit) fit_rows(dp, dka, ex);

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T in two halves of T
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_a<T>(s[2 * kk], s[2 * kk + 1], ph, pl);
      split_a<T>(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        ldsm_kn<LD>(b, dost, kk * 16, dd * 16, lane);
        mma_split<T>(dva[2 * dd], dva[2 * dd + 1], ph, pl, b);
        ldsm_kn<LD>(b, qst, kk * 16, dd * 16, lane);
        mma_split<T>(dka[2 * dd], dka[2 * dd + 1], sh, sl, b);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }
  tc::cp_async_wait<0>();  // no copy outlives the CTA (no q-tile at all)

  const int keys[2] = {key_a, key_b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= Lk) continue;
    const size_t off = ((size_t)bh * Lk + keys[i]) * D + 2 * t;
    const float un = kFit ? scalbnf(1.f, ex[i] - kFitTop) : 1.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
          tc::pack2<T>(dka[j][2 * i] * un * scale,
                       dka[j][2 * i + 1] * un * scale);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
          tc::pack2<T>(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const T* __restrict__ q,
                       const T* __restrict__ k,
                       const T* __restrict__ v,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       T* __restrict__ dq, int Lq, int Lk, float scale,
                       int causal) {
  using C = TcCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD, KC = C::KC;
  constexpr int NT = BN / 8;  // n-tiles of S and dP
  constexpr int DT = D / 8;   // n-tiles of dQ
  // Q's and dO's A fragments live in registers at D = 64; at D = 128 they
  // would take 64 of them beside dQ's 64 and S's and dP's 64, so they are
  // read from shared memory again every k-tile
  constexpr bool kHold = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + BM * LD;
  T* ks = dos + BM * LD;     // two stages
  T* vs = ks + 2 * BN * LD;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Lq + BM - 1) / BM, nk = (Lk + BN - 1) / BN;
  const int qi = nq - 1 - blockIdx.x;  // the longest causal loops first
  const int bh = blockIdx.y;
  const int q0 = qi * BM, offset = Lk - Lq;
  const int wr = warp * 16;  // the warp's first row in the q-tile
  const int row_a = q0 + wr + g, row_b = row_a + 8;  // this lane's rows
  const T* kb = k + (size_t)bh * Lk * D;
  const T* vb = v + (size_t)bh * Lk * D;
  // (flash_attention.py:104-105)
  const int last = causal ? min(nk, (q0 + BM + BN - 1 + offset) / BN) : nk;

  tile_async<D, BM>(qs, q + (size_t)bh * Lq * D, q0, Lq);
  tile_async<D, BM>(dos, dout + (size_t)bh * Lq * D, q0, Lq);
  if (last > 0) {
    tile_async<D, BN>(ks, kb, 0, Lk);
    tile_async<D, BN>(vs, vb, 0, Lk);
  }
  tc::cp_async_commit();
  // rows past Lq get 0 and are never written
  const float lse_r[2] = {row_a < Lq ? lse[(size_t)bh * Lq + row_a] : 0.f,
                          row_b < Lq ? lse[(size_t)bh * Lq + row_b] : 0.f};
  const float dlt_r[2] = {
      row_a < Lq ? delta[(size_t)bh * Lq + row_a] : 0.f,
      row_b < Lq ? delta[(size_t)bh * Lq + row_b] : 0.f};
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kHold ? KC : 1][4], gf[kHold ? KC : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      ldsm_a<LD>(qf[kc], qs, wr, kc, lane);
      ldsm_a<LD>(gf[kc], dos, wr, kc, lane);
    }
  }

  float acc[DT][4] = {};
  // float16: dS's rows are fitted to its range (fit_rows)
  constexpr bool kFit = std::is_same<T, __half>::value;
  int ex[2] = {kFitMinExp, kFitMinExp};
  for (int kt = 0; kt < last; ++kt) {
    if (kt + 1 < last) {  // the next tile into the other stage
      const int st = (kt + 1) & 1;
      tile_async<D, BN>(ks + st * BN * LD, kb, (kt + 1) * BN, Lk);
      tile_async<D, BN>(vs + st * BN * LD, vb, (kt + 1) * BN, Lk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const T* kst = ks + (kt & 1) * BN * LD;
    const T* vst = vs + (kt & 1) * BN * LD;
    const int k0 = kt * BN;

    // S = Q K^T and dP = dO V^T: 16 queries x BN keys a warp
    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[4], ga[4];
      if constexpr (kHold) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qf[kc][i];
          ga[i] = gf[kc][i];
        }
      } else {
        ldsm_a<LD>(qa, qs, wr, kc, lane);
        ldsm_a<LD>(ga, dos, wr, kc, lane);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_nk<LD>(b, kst, np * 16, kc, lane);
        tc::mma<T>(s[2 * np], qa, b[0], b[1]);
        tc::mma<T>(s[2 * np + 1], qa, b[2], b[3]);
        ldsm_nk<LD>(b, vst, np * 16, kc, lane);
        tc::mma<T>(dp[2 * np], ga, b[0], b[1]);
        tc::mma<T>(dp[2 * np + 1], ga, b[2], b[3]);
      }
    }

    // P = exp(S scale - lse), 0 past Lk, and dS = P (dP - delta), in the
    // registers of dP
    const bool edge =
        k0 + BN > Lk || (causal && q0 + wr + offset < k0 + BN - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[j][e] * scale;
        bool zero = false;
        if (edge) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          x = masked(x, i ? row_b : row_a, col, offset, causal);
          zero = col >= Lk;
        }
        const float p = zero ? 0.f : exp2f((x - lse_r[i]) * kLog2e);
        dp[j][e] = p * (dp[j][e] - dlt_r[i]);
      }

    if constexpr (kFit) fit_rows(dp, acc, ex);

    // dQ += dS K, dS in two halves of T straight from the registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_a<T>(dp[2 * kk], dp[2 * kk + 1], hi, lo);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        ldsm_kn<LD>(b, kst, kk * 16, dd * 16, lane);
        mma_split<T>(acc[2 * dd], acc[2 * dd + 1], hi, lo, b);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }
  tc::cp_async_wait<0>();  // no copy outlives the CTA

  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= Lq) continue;
    T* row = dq + ((size_t)bh * Lq + rows[i]) * D + 2 * t;
    const float un = kFit ? scalbnf(1.f, ex[i] - kFitTop) : 1.f;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          tc::pack2<T>(acc[j][2 * i] * un * scale,
                       acc[j][2 * i + 1] * un * scale);
  }
}

template <typename K>
int set_smem(K* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * Cfg<D>::B * Cfg<D>::S + Cfg<D>::B * Cfg<D>::PS);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * Cfg<D>::B * Cfg<D>::S + Cfg<D>::B * Cfg<D>::PS);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * Cfg<D>::B * Cfg<D>::S + 2 * Cfg<D>::B * Cfg<D>::PS + 2 * Cfg<D>::B);
}
template <int D>
constexpr size_t fwd_tc_smem() {
  using C = TcCfg<D>;
  return sizeof(bf16) * (C::BM + 4 * C::BN) * C::LD;
}
template <int D>
constexpr size_t dq_tc_smem() {
  using C = TcCfg<D>;
  return sizeof(bf16) * (2 * C::BM + 4 * C::BN) * C::LD;
}
template <int D>
constexpr size_t dkv_tc_smem() {
  using C = TcCfg<D>;
  return sizeof(bf16) * (2 * C::BN + 4 * C::BQ) * C::LD +
         sizeof(float) * 4 * C::BQ;
}
static_assert(dkv_smem<128>() <= 232448 && dkv_smem<256>() <= 232448 &&
                  fwd_smem<256>() <= 232448 && dq_smem<128>() <= 232448 &&
                  fwd_tc_smem<128>() <= 232448 &&
                  dq_tc_smem<128>() <= 232448 &&
                  dkv_tc_smem<128>() <= 232448,
              "a tile does not fit a CTA's shared memory");

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, int Lq, int Lk, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<D>();
  int err = set_smem(flash_fwd_kernel<T, D>, smem);
  if (err) return err;
  const dim3 grid((Lq + Cfg<D>::B - 1) / Cfg<D>::B, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int BH, int Lq,
           int Lk, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = dq_smem<D>();
  int err = set_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err) return err;
  const dim3 grid((Lq + Cfg<D>::B - 1) / Cfg<D>::B, BH);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int BH,
            int Lq, int Lk, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = dkv_smem<D>();
  int err = set_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err) return err;
  const dim3 grid((Lk + Cfg<D>::B - 1) / Cfg<D>::B, BH);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int Lq, int Lk, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = fwd_tc_smem<D>();
  int err = set_smem(flash_fwd_tc_kernel<T, D>, smem);
  if (err) return err;
  const dim3 grid((Lq + TcCfg<D>::BM - 1) / TcCfg<D>::BM, BH);
  flash_fwd_tc_kernel<T, D><<<grid, kTcThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int BH, int Lq,
              int Lk, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = dq_tc_smem<D>();
  int err = set_smem(flash_bwd_dq_tc_kernel<T, D>, smem);
  if (err) return err;
  const dim3 grid((Lq + TcCfg<D>::BM - 1) / TcCfg<D>::BM, BH);
  flash_bwd_dq_tc_kernel<T, D><<<grid, kTcThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BH,
               int Lq, int Lk, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = dkv_tc_smem<D>();
  int err = set_smem(flash_bwd_dkv_tc_kernel<T, D>, smem);
  if (err) return err;
  const dim3 grid((Lk + TcCfg<D>::BN - 1) / TcCfg<D>::BN, BH);
  flash_bwd_dkv_tc_kernel<T, D><<<grid, kTcThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

// returns CALL(T, D) for the (dtype, D) pair, TC(T, D) for the bfloat16
// and float16 pairs that have a tensor-core kernel, or
// cudaErrorInvalidValue for a pair that is not instantiated
#define DISPATCH(dtype, D, CALL, TC)                              \
  switch ((dtype) * 1000 + (D)) {                                 \
    case 64: return CALL(float, 64);                              \
    case 128: return CALL(float, 128);                            \
    case 192: return CALL(float, 192);                            \
    case 256: return CALL(float, 256);                            \
    case 1064: return TC(__nv_bfloat16, 64);                      \
    case 1128: return TC(__nv_bfloat16, 128);                     \
    case 1192: return CALL(__nv_bfloat16, 192);                   \
    case 1256: return CALL(__nv_bfloat16, 256);                   \
    case 2064: return TC(__half, 64);                             \
    case 2128: return TC(__half, 128);                            \
    case 2192: return CALL(__half, 192);                          \
    case 2256: return CALL(__half, 256);                          \
  }                                                               \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, o, dout, dq,
// dk, dv); D one
// of 64, 128, 192, 256; lse and delta (BH, Lq) float32; all contiguous.
// Each returns the cudaError_t of its launch (0 on success). The caller
// checks shapes, types and contiguity, and launches nothing when BH, Lq
// or Lk is 0.
int flash_attention_fwd_launch(int dtype, int D, const void* q, const void* k,
                               const void* v, void* o, void* lse, int BH,
                               int Lq, int Lk, float scale, int causal,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(T, DD) fwd<T, DD>(q, k, v, o, lse, BH, Lq, Lk, scale, causal, s)
#define FWD_TC(T, DD) fwd_tc<T, DD>(q, k, v, o, lse, BH, Lq, Lk, scale, causal, s)
  DISPATCH(dtype, D, FWD, FWD_TC)
#undef FWD_TC
#undef FWD
}

int flash_attention_bwd_dq_launch(int dtype, int D, const void* q,
                                  const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int BH, int Lq,
                                  int Lk, float scale, int causal,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, DD) \
  bwd_dq<T, DD>(q, k, v, dout, lse, delta, dq, BH, Lq, Lk, scale, causal, s)
#define DQ_TC(T, DD) \
  bwd_dq_tc<T, DD>(q, k, v, dout, lse, delta, dq, BH, Lq, Lk, scale, causal, s)
  DISPATCH(dtype, D, DQ, DQ_TC)
#undef DQ_TC
#undef DQ
}

int flash_attention_bwd_dkv_launch(int dtype, int D, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int BH, int Lq, int Lk, float scale,
                                   int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, DD)                                                          \
  bwd_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, BH, Lq, Lk, scale, causal, \
                 s)
#define DKV_TC(T, DD)                                                      \
  bwd_dkv_tc<T, DD>(q, k, v, dout, lse, delta, dk, dv, BH, Lq, Lk, scale, causal, \
                 s)
  DISPATCH(dtype, D, DKV, DKV_TC)
#undef DKV_TC
#undef DKV
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
