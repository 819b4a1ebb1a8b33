// Row LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/layernorm.py:
// `_fwd_kernel` (:20, launched by `_ln_call` at :76) and `_bwd_kernel`
// (:33, launched by `_ln_bwd` at :109), and computes what they compute:
//
//   forward   x (N, D), gamma/beta (D,) -> y (N, D) in x's type,
//             mean and rstd (N, 1) float32;
//             mean = sum(x)/D, var = sum((x-mean)^2)/D (the centred
//             second pass of the TPU kernel), rstd = rsqrt(var + eps),
//             y = (x-mean)*rstd*gamma + beta
//   backward  dx = (g*dy - xhat*mean(g*dy*xhat) - mean(g*dy)) * rstd,
//             dgamma = sum_rows dy*xhat, dbeta = sum_rows dy (float32)
//
// x, dy, y, dx, gamma and beta are all float32, all bfloat16 or all
// float16; all arithmetic is float32 and only what is written is rounded,
// as the TPU kernel rounds only its stores (layernorm.py:28,45). float16
// takes every path below that bfloat16 takes, with the same vector
// widths (both are two bytes).
//
// Forward design. One warp per row at a time, four warps to a CTA of 128
// threads, from a grid of as many CTAs as the card holds at once (the
// kernel's occupancy times the SMs), each warp walking every
// (CTAs * 4)-th row. The row comes in as 16-byte vectors (4 float32 or 8
// bfloat16), vector i * 32 + lane to lane `lane`, all of a lane's loads
// issued before the first add, and stays in registers as it came: at
// D = 768 a lane holds 24 values, 6 vectors in float32 and 3 in
// bfloat16. Both passes run over those registers, each unpacking them to
// float32, closed by shuffles across the warp: the sum for the mean,
// then the centred sum of squares. gamma and beta are loaded once a
// warp, as vectors, and held.
// y leaves as 16-byte vectors. (One row a warp over ceil(N / 4) CTAs,
// gamma and beta read again for every row, ran slower on an H100 in
// both types.) A static dispatch on D (and on the four pointers' 16-byte
// alignment, which torch's allocations give) picks the kernel, and
// nothing is tried and caught:
//
//   D a multiple of the vector width (4 float32, 8 bfloat16) and at most
//     8 vectors a lane (D <= 1024 float32, <= 2048 bfloat16):
//     ln_fwd_vec_kernel<T, NV>, NV = ceil(D / (32 * vector width));
//   any other D up to the wrapper's MAX_D: ln_fwd_kernel, one warp per
//     row with scalar loads, the row staged in shared memory as float32.
//
// The TPU backward carries dgamma/dbeta in one (D,) block revisited
// across its sequential grid; blocks on this card run in no order, so
// the backward is two kernels: the first writes dx and one row of
// dgamma/dbeta partials per CTA into a (G, D) float32 workspace, the
// second sums the G rows. The same static dispatch as the forward's
// picks the first kernel:
//
//   D a multiple of the vector width, at most kBwdMaxNv<T> vectors a
//     lane (8 in float32, 4 in bfloat16: D <= 1024 in both), and x, dy,
//     dx and gamma 16-byte aligned: ln_bwd_vec_kernel<T, NV>. The grid
//     is one wave (occupancy x SMs, found once and kept); each warp
//     walks every (CTAs * 4)-th row. It holds the rows of x and dy in
//     registers as 16-byte vectors, vector i * 32 + lane to lane `lane`,
//     each read from device memory once, with every load of the row
//     issued before the first add; gamma is loaded once a warp and
//     held. Both row means come from those registers, and dx leaves as
//     16-byte vectors. A lane owns the same columns in every row, so
//     its dgamma/dbeta partials accumulate in registers across the
//     warp's rows; at the end the CTA sums its four warps, in order,
//     into its row of the workspace: nothing goes through shared
//     memory per row, and x, dy and gamma are read once.
//   any other D up to the wrapper's MAX_D: ln_bwd_kernel, one warp per
//     row with scalar loads, CTA b over a fixed range of rows, its warps'
//     partials in shared memory.
//
// ln_bwd_reduce_kernel sums the workspace in parallel over both D and
// G: a CTA of 32 columns x 32 row groups, each thread summing its
// group's rows in order, then a fixed tree over the groups. No atomics:
// dx, dgamma and dbeta are the same bits on every run of the same input
// on the same card.
//
// Bound on an H100 SXM: memory. The forward must read x and write y
// (2*N*D elements, plus gamma, beta and the 8 bytes of statistics a row:
// 50.4 MB at (8192, 768) float32 and at (16384, 768) bfloat16, 0.0150
// ms at 3.35 TB/s) and the backward read x and dy and write dx (3*N*D);
// their ~10 float32 operations an element are far below the 67 TFLOP/s
// float32 rate at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceCols = 32;    // columns of a reduce CTA
constexpr int kReduceGroups = 32;  // row groups of a reduce CTA
constexpr int kBwdMaxCtas = 4 * 132;  // the scalar backward's partition

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const T* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int N, int D, float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= N) return;  // whole warps leave; no CTA-wide barrier follows
  float* xs = smem + (size_t)warp * D;
  const T* xr = x + (size_t)row * D;

  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_float(xr[d]);
    xs[d] = v;
    s += v;
  }
  const float mean = warp_sum(s) / D;
  float sq = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = xs[d] - mean;
    sq += c * c;
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
  T* yr = y + (size_t)row * D;
  for (int d = lane; d < D; d += 32) {
    const float xhat = (xs[d] - mean) * rstd;
    yr[d] = from_float<T>(xhat * to_float(gamma[d]) + to_float(beta[d]));
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// 16 bytes of T: 4 float32, or 8 bfloat16 or float16
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[kVec<T>]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) f[i] = to_float(e[i]);
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[kVec<T>]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) e[i] = from_float<T>(f[i]);
  return u;
}

// the row in registers: lane `lane` holds vectors lane, lane + 32, ...,
// of the D / kVec<T> <= 32 * NV vectors of a row
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
ln_fwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int N, int D, float eps) {
  constexpr int V = kVec<T>;
  const int lane = threadIdx.x & 31;
  const int nvec = D / V;
  const uint4* g4 = reinterpret_cast<const uint4*>(gamma);
  const uint4* b4 = reinterpret_cast<const uint4*>(beta);
  uint4 gv[NV], bv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec) {
      gv[i] = g4[c];
      bv[i] = b4[c];
    }
  }
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < N;
       row += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    uint4 xv[NV];  // every load of the row in flight before the first add
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) xv[i] = xr[i * 32 + lane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        float f[V];
        unpack<T>(xv[i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) s += f[e];
      }
    const float mean = warp_sum(s) / D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        float f[V];
        unpack<T>(xv[i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) sq += (f[e] - mean) * (f[e] - mean);
      }
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nvec) {
        float f[V], gf[V], bf[V];
        unpack<T>(xv[i], f);
        unpack<T>(gv[i], gf);
        unpack<T>(bv[i], bf);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = (f[e] - mean) * rstd * gf[e] + bf[e];
        yr[c] = pack<T>(f);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// CTA b handles rows [b * rows_per_cta, min(N, (b + 1) * rows_per_cta)),
// warp w of it every fourth of those rows from the w-th; its dgamma and
// dbeta partials go to row b of dg_ws and db_ws (G, D).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
              const float* __restrict__ mean_in,
              const float* __restrict__ rstd_in, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ dg_ws,
              float* __restrict__ db_ws, int N, int D, int rows_per_cta) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* dg_s = smem + (size_t)warp * D;             // kWarps * D
  float* db_s = smem + (size_t)(kWarps + warp) * D;  // kWarps * D
  for (int d = lane; d < D; d += 32) {
    dg_s[d] = 0.f;
    db_s[d] = 0.f;
  }
  const int first = blockIdx.x * rows_per_cta;
  const int last = min(N, first + rows_per_cta);
  for (int row = first + warp; row < last; row += kWarps) {
    const T* xr = x + (size_t)row * D;
    const T* dyr = dy + (size_t)row * D;
    const float mean = mean_in[row];
    const float rstd = rstd_in[row];
    float c1 = 0.f, c2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float xhat = (to_float(xr[d]) - mean) * rstd;
      const float g = to_float(dyr[d]);
      const float wdy = g * to_float(gamma[d]);
      c1 += wdy * xhat;
      c2 += wdy;
      dg_s[d] += g * xhat;
      db_s[d] += g;
    }
    c1 = warp_sum(c1) / D;
    c2 = warp_sum(c2) / D;
    T* dxr = dx + (size_t)row * D;
    for (int d = lane; d < D; d += 32) {
      const float xhat = (to_float(xr[d]) - mean) * rstd;
      const float wdy = to_float(dyr[d]) * to_float(gamma[d]);
      dxr[d] = from_float<T>((wdy - xhat * c1 - c2) * rstd);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float g = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      g += smem[(size_t)w * D + d];
      b += smem[(size_t)(kWarps + w) * D + d];
    }
    dg_ws[(size_t)blockIdx.x * D + d] = g;
    db_ws[(size_t)blockIdx.x * D + d] = b;
  }
}

// the most 16-byte vectors a lane holds of a row in the backward: two
// rows, gamma and two float32 accumulators must stay in registers
template <typename T>
constexpr int kBwdMaxNv = sizeof(T) == 4 ? 8 : 4;

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
ln_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const float* __restrict__ mean_in,
                  const float* __restrict__ rstd_in,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ dg_ws, float* __restrict__ db_ws,
                  int N, int D) {
  constexpr int V = kVec<T>;
  __shared__ float red[kWarps][NV * 32 * V];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = D / V;
  const uint4* g4 = reinterpret_cast<const uint4*>(gamma);
  uint4 gv[NV];
  float dg[NV][V], db[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < nvec) gv[i] = g4[i * 32 + lane];
#pragma unroll
    for (int e = 0; e < V; ++e) dg[i][e] = db[i][e] = 0.f;
  }
  const int stride = gridDim.x * kWarps;
  for (int row = blockIdx.x * kWarps + warp; row < N; row += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + (size_t)row * D);
    uint4 xv[NV], dyv[NV];  // every load of the row before the first add
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        xv[i] = xr[i * 32 + lane];
        dyv[i] = dyr[i * 32 + lane];
      }
    const float mean = mean_in[row];
    const float rstd = rstd_in[row];
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        float xf[V], gf[V], wf[V];
        unpack<T>(xv[i], xf);
        unpack<T>(dyv[i], gf);
        unpack<T>(gv[i], wf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = (xf[e] - mean) * rstd;
          const float wdy = gf[e] * wf[e];
          c1 += wdy * xhat;
          c2 += wdy;
          dg[i][e] += gf[e] * xhat;
          db[i][e] += gf[e];
        }
      }
    c1 = warp_sum(c1) / D;
    c2 = warp_sum(c2) / D;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * D);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec) {
        float xf[V], gf[V], wf[V];
        unpack<T>(xv[i], xf);
        unpack<T>(dyv[i], gf);
        unpack<T>(gv[i], wf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = (xf[e] - mean) * rstd;
          xf[e] = (gf[e] * wf[e] - xhat * c1 - c2) * rstd;
        }
        dxr[i * 32 + lane] = pack<T>(xf);
      }
  }
  // the CTA's warps summed in order into its row of each workspace
  float* out[2] = {dg_ws + (size_t)blockIdx.x * D,
                   db_ws + (size_t)blockIdx.x * D};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * 32 + lane < nvec)
#pragma unroll
        for (int e = 0; e < V; ++e)
          red[warp][(i * 32 + lane) * V + e] = k ? db[i][e] : dg[i][e];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w][d];
      out[k][d] = t;
    }
    __syncthreads();
  }
}

// dgamma (blockIdx.y 0) or dbeta (1) of kReduceCols columns: thread
// (group, col) sums rows group, group + kReduceGroups, ... in order,
// then the groups are summed by a fixed tree.
__global__ void __launch_bounds__(kReduceCols * kReduceGroups)
ln_bwd_reduce_kernel(const float* __restrict__ dg_ws,
                     const float* __restrict__ db_ws, float* __restrict__ dg,
                     float* __restrict__ db, int G, int D) {
  __shared__ float part[kReduceGroups][kReduceCols + 1];
  const float* ws = blockIdx.y ? db_ws : dg_ws;
  const int c = threadIdx.x % kReduceCols;
  const int grp = threadIdx.x / kReduceCols;
  const int d = blockIdx.x * kReduceCols + c;
  float s = 0.f;
  if (d < D) {
#pragma unroll 4
    for (int g = grp; g < G; g += kReduceGroups) s += ws[(size_t)g * D + d];
  }
  part[grp][c] = s;
  __syncthreads();
#pragma unroll
  for (int n = kReduceGroups / 2; n > 0; n >>= 1) {
    if (grp < n) part[grp][c] += part[grp + n][c];
    __syncthreads();
  }
  if (grp == 0 && d < D) (blockIdx.y ? db : dg)[d] = part[0][c];
}

template <typename K>
int set_smem(K* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// CTAs of `kernel` the card holds at once (occupancy x SMs), found at
// the first call for each kernel and kept in `wave`: a process drives
// one kind of card
template <typename K>
int one_wave(K* kernel, std::atomic<int>& wave, int* ctas) {
  *ctas = wave.load(std::memory_order_relaxed);
  if (*ctas) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
  if (err) return err;
  if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  wave.store(*ctas, std::memory_order_relaxed);
  return 0;
}

template <typename T, int NV>
int fwd_vec(const void* x, const void* gamma, const void* beta, void* y,
            void* mean, void* rstd, int N, int D, float eps,
            cudaStream_t s) {
  static std::atomic<int> wave{0};
  int ctas = 0;
  int err = one_wave(ln_fwd_vec_kernel<T, NV>, wave, &ctas);
  if (err) return err;
  const int grid = std::min((N + kWarps - 1) / kWarps, ctas);
  ln_fwd_vec_kernel<T, NV><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), N, D, eps);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        void* mean, void* rstd, int N, int D, float eps, cudaStream_t s) {
  constexpr int V = kVec<T>;
  if (D % V == 0 && aligned16(x) && aligned16(gamma) && aligned16(beta) &&
      aligned16(y)) {
#define VEC(NV)                                                        \
  case NV:                                                             \
    return fwd_vec<T, NV>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
    switch ((D / V + 31) / 32) {
      VEC(1) VEC(2) VEC(3) VEC(4) VEC(5) VEC(6) VEC(7) VEC(8)
    }
#undef VEC
  }
  const size_t smem = sizeof(float) * kWarps * (size_t)D;
  int err = set_smem(ln_fwd_kernel<T>, smem);
  if (err) return err;
  const int grid = (N + kWarps - 1) / kWarps;
  ln_fwd_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), N, D, eps);
  return (int)cudaGetLastError();
}

// the vectors a lane holds in ln_bwd_vec_kernel, or 0 where the scalar
// ln_bwd_kernel takes the call
template <typename T>
int bwd_vec_nv(int D, const void* x, const void* gamma, const void* dy,
               const void* dx) {
  constexpr int V = kVec<T>;
  if (D % V != 0 || !aligned16(x) || !aligned16(gamma) || !aligned16(dy) ||
      !aligned16(dx))
    return 0;
  const int nv = (D / V + 31) / 32;
  return nv <= kBwdMaxNv<T> ? nv : 0;
}

// rows a CTA of the scalar backward takes: a function of N alone
int scalar_rows_per_cta(int N) {
  const int ctas = std::min((N + kWarps - 1) / kWarps, kBwdMaxCtas);
  return (N + ctas - 1) / ctas;
}

template <typename T, int NV>
int bwd_vec_ctas(int N, int* ctas) {
  static std::atomic<int> wave{0};
  int err = one_wave(ln_bwd_vec_kernel<T, NV>, wave, ctas);
  if (!err) *ctas = std::min((N + kWarps - 1) / kWarps, *ctas);
  return err;
}

#define BWD_NV(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// G, the CTAs of the backward's first kernel and rows of its workspace
template <typename T>
int bwd_ctas(int N, int D, const void* x, const void* gamma, const void* dy,
             const void* dx, int* ctas) {
  switch (bwd_vec_nv<T>(D, x, gamma, dy, dx)) {
#define CTAS(NV) \
  case NV:       \
    if constexpr (NV <= kBwdMaxNv<T>) return bwd_vec_ctas<T, NV>(N, ctas);
    BWD_NV(CTAS)
#undef CTAS
  }
  const int rows = scalar_rows_per_cta(N);
  *ctas = (N + rows - 1) / rows;
  return 0;
}

template <typename T>
int bwd(const void* x, const void* gamma, const void* mean, const void* rstd,
        const void* dy, void* dx, void* dg, void* db, void* dg_ws,
        void* db_ws, int N, int D, int G, cudaStream_t s) {
  int ctas = 0;
  int err = bwd_ctas<T>(N, D, x, gamma, dy, dx, &ctas);
  if (err) return err;
  if (ctas != G) return (int)cudaErrorInvalidValue;  // the workspace's rows
  const int nv = bwd_vec_nv<T>(D, x, gamma, dy, dx);
  switch (nv) {
#define VEC(NV)                                                         \
  case NV:                                                              \
    if constexpr (NV <= kBwdMaxNv<T>)                                   \
      ln_bwd_vec_kernel<T, NV><<<G, kThreads, 0, s>>>(                  \
          static_cast<const T*>(x), static_cast<const T*>(gamma),       \
          static_cast<const float*>(mean), static_cast<const float*>(rstd), \
          static_cast<const T*>(dy), static_cast<T*>(dx),               \
          static_cast<float*>(dg_ws), static_cast<float*>(db_ws), N, D); \
    break;
    BWD_NV(VEC)
#undef VEC
    default: {
      const size_t smem = sizeof(float) * 2 * kWarps * (size_t)D;
      err = set_smem(ln_bwd_kernel<T>, smem);
      if (err) return err;
      ln_bwd_kernel<T><<<G, kThreads, smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(gamma),
          static_cast<const float*>(mean), static_cast<const float*>(rstd),
          static_cast<const T*>(dy), static_cast<T*>(dx),
          static_cast<float*>(dg_ws), static_cast<float*>(db_ws), N, D,
          scalar_rows_per_cta(N));
    }
  }
  err = (int)cudaGetLastError();
  if (err) return err;
  ln_bwd_reduce_kernel<<<dim3((D + kReduceCols - 1) / kReduceCols, 2),
                         kReduceCols * kReduceGroups, 0, s>>>(
      static_cast<const float*>(dg_ws), static_cast<const float*>(db_ws),
      static_cast<float*>(dg), static_cast<float*>(db), G, D);
  return (int)cudaGetLastError();
}

}  // namespace

using bf16 = __nv_bfloat16;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, gamma, beta, y, dy,
// dx). Returns
// the cudaError_t of the launch (0 on success); the caller checks
// shapes, types, contiguity and the shared-memory limit, and launches
// nothing for N == 0.
int layer_norm_fwd_launch(int dtype, const void* x, const void* gamma,
                          const void* beta, void* y, void* mean, void* rstd,
                          int N, int D, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fwd<float>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
    case 1: return fwd<bf16>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
    case 2: return fwd<__half>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// G, the rows of the backward's workspace for these arguments (the
// first kernel's CTAs). Returns a cudaError_t (0 on success).
int layer_norm_bwd_ctas(int dtype, int N, int D, const void* x,
                        const void* gamma, const void* dy, const void* dx,
                        int* ctas) {
  switch (dtype) {
    case 0: return bwd_ctas<float>(N, D, x, gamma, dy, dx, ctas);
    case 1: return bwd_ctas<bf16>(N, D, x, gamma, dy, dx, ctas);
    case 2: return bwd_ctas<__half>(N, D, x, gamma, dy, dx, ctas);
  }
  return (int)cudaErrorInvalidValue;
}

// dg_ws/db_ws: (G, D) float32 scratch, G from layer_norm_bwd_ctas.
int layer_norm_bwd_launch(int dtype, const void* x, const void* gamma,
                          const void* mean, const void* rstd, const void* dy,
                          void* dx, void* dg, void* db, void* dg_ws,
                          void* db_ws, int N, int D, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return bwd<float>(x, gamma, mean, rstd, dy, dx, dg, db, dg_ws, db_ws, N,
                        D, G, s);
    case 1:
      return bwd<bf16>(x, gamma, mean, rstd, dy, dx, dg, db, dg_ws, db_ws, N,
                       D, G, s);
    case 2:
      return bwd<__half>(x, gamma, mean, rstd, dy, dx, dg, db, dg_ws, db_ws,
                         N, D, G, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
