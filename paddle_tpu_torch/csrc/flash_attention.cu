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
// q, k, v, O, dO, dQ, dK and dV are all float32 or all bfloat16; every
// product and sum is float32, P included, as on the TPU.
//
// Design. The TPU kernels carry the online-softmax state (m, l, acc) in
// VMEM across a sequential grid axis and hold a whole (L, D) K or V
// block in VMEM. Here blocks run in no order and a CTA has at most
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
// H100 SXM), not on the tensor cores: P and dS stay float32, as the TPU
// kernel keeps them.
//
// Bound on an H100 SXM at the bench_gpt shape (BH = 192, L = 1024,
// D = 64, causal, bfloat16): counted at the bfloat16 tensor-core rate
// (989 TFLOP/s) against 3.35 TB/s, the forward is bound by its bytes
// (~0.030 ms), dQ by both (~0.039 ms) and dK/dV by its operations
// (~0.052 ms). This kernel runs its ~116 GFLOP at the float32 CUDA-core
// rate at best, so it is far from that bound; the tensor cores (wgmma or
// mma.sync on bfloat16 operands) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr float kMaskAdd = -1e30f;  // the TPU kernel's additive causal mask

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
static_assert(dkv_smem<128>() <= 232448 && dkv_smem<256>() <= 232448 &&
                  fwd_smem<256>() <= 232448 && dq_smem<128>() <= 232448,
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

// returns CALL(T, D) for the (dtype, D) pair, or cudaErrorInvalidValue
// for a pair that is not instantiated
#define DISPATCH(dtype, D, CALL)                                  \
  switch ((dtype) * 1000 + (D)) {                                 \
    case 64: return CALL(float, 64);                              \
    case 128: return CALL(float, 128);                            \
    case 192: return CALL(float, 192);                            \
    case 256: return CALL(float, 256);                            \
    case 1064: return CALL(__nv_bfloat16, 64);                    \
    case 1128: return CALL(__nv_bfloat16, 128);                   \
    case 1192: return CALL(__nv_bfloat16, 192);                   \
    case 1256: return CALL(__nv_bfloat16, 256);                   \
  }                                                               \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv); D one
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
  DISPATCH(dtype, D, FWD)
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
  DISPATCH(dtype, D, DQ)
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
  DISPATCH(dtype, D, DKV)
#undef DKV
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
