// Softmax cross-entropy over hard labels, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/softmax_ce.py:
// `_fwd_kernel` (:25, launched by `_ce_call` at :92) and `_bwd_kernel`
// (:55, launched by `_ce_bwd` at :129), and computes what they compute:
//
//   forward   logits (N, V), labels (N,) int32 -> per-row loss (N,) and
//             lse (N,), both float32;
//             lse = max + log(max(sum(exp(x - max)), 1e-30)),
//             loss = (lse - x[label]) * valid, valid = label != ignore;
//             a label outside [0, V) picks 0 (the TPU kernel's one-hot
//             matches no column)
//   backward  dlogits = (exp(x - lse) - onehot(label)) * g * valid, in the
//             logits' type, for the per-row loss gradient g (N,) float32
//
// Logits are float32, bfloat16 or float16; all arithmetic is float32,
// and only dx is rounded to the logits' type (softmax_ce.py:66).
//
// Design. The TPU forward walks the vocabulary as a sequential grid axis
// of 2048-wide blocks and carries (max, sum of exp, label logit) in VMEM
// scratch from block to block. Here one CTA of 256 threads takes one
// row: each thread strides the row and keeps its own running (max, sum)
// with one exp per element (rescaling its sum when the max grows); the
// CTA then merges the 256 pairs, by shuffles within each warp and
// through shared memory across warps. The label logit is one read. The
// softmax is never written. The backward is elementwise: a 2-D grid of
// (2048-column tile, row) CTAs, each reading its row's lse, label and g
// once, with the vocabulary's ragged tail masked.
//
// Bound on an H100 SXM: memory. The forward must read the logits once
// (N*V elements) and the backward read them and write their gradient
// (2*N*V); at N = 8192, V = 50304 in float32 that is 1.65 GB and 3.30 GB,
// ~0.49 ms and ~0.98 ms at 3.35 TB/s. The few float32 operations an
// element (one exp, a compare, an add) are far below the compute rates.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kBwdThreads = 256;
constexpr int kBwdTile = 2048;  // columns a backward CTA covers
constexpr int kMaxGridY = 65535;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

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

// (m, s) <- the pair of the union of the elements behind (m, s) and
// (m2, s2); an empty side has m = kNegInf and s = 0.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
ce_fwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
              float* __restrict__ loss, float* __restrict__ lse_out, int V,
              int ignore_index) {
  __shared__ float m_s[kFwdWarps];
  __shared__ float s_s[kFwdWarps];
  const int row = blockIdx.x;
  const T* xr = logits + (size_t)row * V;

  float m = kNegInf, s = 0.f;
  for (int j = threadIdx.x; j < V; j += kFwdThreads) {
    const float v = to_float(xr[j]);
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    m_s[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = m_s[0];
    s = s_s[0];
    for (int w = 1; w < kFwdWarps; ++w) merge(m, s, m_s[w], s_s[w]);
    const float lse = m + logf(fmaxf(s, 1e-30f));
    const int lab = labels[row];
    const float picked = (lab >= 0 && lab < V) ? to_float(xr[lab]) : 0.f;
    loss[row] = lab != ignore_index ? lse - picked : 0.f;
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ce_bwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
              const float* __restrict__ lse_in, const float* __restrict__ g_in,
              T* __restrict__ dx, int N, int V, int ignore_index) {
  const int col0 = blockIdx.x * kBwdTile;
  for (int row = blockIdx.y; row < N; row += gridDim.y) {
    const int lab = labels[row];
    const float lse = lse_in[row];
    const float g = lab != ignore_index ? g_in[row] : 0.f;
    const T* xr = logits + (size_t)row * V;
    T* dxr = dx + (size_t)row * V;
#pragma unroll 4
    for (int k = threadIdx.x; k < kBwdTile; k += kBwdThreads) {
      const int j = col0 + k;
      if (j < V) {
        const float p = expf(to_float(xr[j]) - lse);
        dxr[j] = from_float<T>((p - (j == lab ? 1.f : 0.f)) * g);
      }
    }
  }
}

template <typename T>
int fwd(const void* logits, const void* labels, void* loss, void* lse, int N,
        int V, int ignore_index, cudaStream_t s) {
  ce_fwd_kernel<T><<<N, kFwdThreads, 0, s>>>(
      static_cast<const T*>(logits), static_cast<const int32_t*>(labels),
      static_cast<float*>(loss), static_cast<float*>(lse), V, ignore_index);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* logits, const void* labels, const void* lse,
        const void* g, void* dx, int N, int V, int ignore_index,
        cudaStream_t s) {
  const dim3 grid((V + kBwdTile - 1) / kBwdTile, N < kMaxGridY ? N : kMaxGridY);
  ce_bwd_kernel<T><<<grid, kBwdThreads, 0, s>>>(
      static_cast<const T*>(logits), static_cast<const int32_t*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dx), N, V, ignore_index);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the logits). Returns the
// cudaError_t of the launch (0 on success); the caller checks shapes,
// types and contiguity, and launches nothing for N == 0.
int softmax_ce_fwd_launch(int dtype, const void* logits, const void* labels,
                          void* loss, void* lse, int N, int V,
                          int ignore_index, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(logits, labels, loss, lse, N, V, ignore_index, s);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(logits, labels, loss, lse, N, V, ignore_index, s);
  if (dtype == 2)
    return fwd<__half>(logits, labels, loss, lse, N, V, ignore_index, s);
  return (int)cudaErrorInvalidValue;
}

int softmax_ce_bwd_launch(int dtype, const void* logits, const void* labels,
                          const void* lse, const void* g, void* dx, int N,
                          int V, int ignore_index, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(logits, labels, lse, g, dx, N, V, ignore_index, s);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(logits, labels, lse, g, dx, N, V, ignore_index, s);
  if (dtype == 2)
    return bwd<__half>(logits, labels, lse, g, dx, N, V, ignore_index, s);
  return (int)cudaErrorInvalidValue;
}

const char* softmax_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
