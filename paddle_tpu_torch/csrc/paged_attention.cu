// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` of
// paddle_tpu/ops/pallas/paged_attention.py:46 (launched by
// `paged_decode_attention`, :90-136) and computes exactly what it does:
// one decode query per lane attends over the lane's K/V history, which
// lives in fixed-size pages of one pool and is reached through the
// lane's page table.
//
//   q        (B, H, D)          float32
//   k/v pool (P, page, H, D)    float32 or bfloat16
//   table    (B, W)             int32, entries clamped to [0, P-1]
//   lengths  (B,)               int32, tokens in the cache, query included
//   out      (B, H, D)          float32 (q's dtype)
//
// Pages at or past ceil(len/page) are never read; positions at or past
// len are masked; a lane with len == 0 yields zeros (the max(l, 1e-30)
// guard of the reference). Softmax and accumulation run in float32
// whatever the pool type.
//
// Design. The TPU kernel runs the page axis as a sequential grid
// dimension and carries the online-softmax state (m, l, acc) in VMEM
// from one grid step to the next. Blocks on this card run in no order,
// so that carry becomes a loop over the lane's live pages inside one
// CTA: one CTA per (lane, head), 128 threads. Each iteration stages the
// page's K and V rows of this head in shared memory (converted to
// float32), forms q.k with one warp per key and a shuffle reduction,
// and folds the page into the running (m, l, acc); each thread owns at
// most two of the D <= 256 output columns.
//
// Bound on an H100 SXM: memory. A decode step must read each live K/V
// row once: sum over lanes of ceil(len/page) * page * H * D * bytes * 2,
// at 3.35 TB/s; its 4 * len * H * D float32 operations are two orders
// of magnitude below the 67 TFLOP/s float32 rate. The grid has B * H
// CTAs — 16 lanes * 12 heads = 192 at the serving width, barely more
// than the 132 SMs, and each CTA walks its whole context alone. At
// long contexts that leaves most of the card's bandwidth unused; a
// split-K (flash-decoding) grid over the page axis with a second
// reduction pass is the design that fixes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kColsPerThread = kMaxHeadDim / kThreads;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ out, int H, int D, int P, int page,
                    int W, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;              // D
  float* k_s = q_s + D;           // page * D
  float* v_s = k_s + page * D;    // page * D
  float* s_s = v_s + page * D;    // page scores

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = lengths[b];
  int n_pages = len > 0 ? (len + page - 1) / page : 0;
  n_pages = min(n_pages, W);  // the reference grid has W page steps

  const size_t head_off = ((size_t)b * H + h) * D;
  for (int d = tid; d < D; d += kThreads) q_s[d] = q[head_off + d] * scale;

  float acc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const size_t row_stride = (size_t)H * D;        // one token in a page
  const size_t page_stride = (size_t)page * row_stride;
  for (int p = 0; p < n_pages; ++p) {
    int pid = table[(size_t)b * W + p];
    pid = min(max(pid, 0), P - 1);
    const T* kp = k_pages + (size_t)pid * page_stride + (size_t)h * D;
    const T* vp = v_pages + (size_t)pid * page_stride + (size_t)h * D;
    __syncthreads();  // the previous page's k_s/v_s/s_s are consumed
    for (int i = tid; i < page * D; i += kThreads) {
      const int t = i / D;
      const int d = i - t * D;
      k_s[i] = to_float(kp[t * row_stride + d]);
      v_s[i] = to_float(vp[t * row_stride + d]);
    }
    __syncthreads();

    const int base = p * page;
    for (int t = warp; t < page; t += kWarps) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += q_s[d] * k_s[t * D + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) s_s[t] = (base + t < len) ? dot : kNegInf;
    }
    __syncthreads();

    // every thread folds the page into its own copy of (m, l) and its
    // output columns; page is small, so the redundant max/sum is cheap
    float m_page = kNegInf;
    for (int t = 0; t < page; ++t) m_page = fmaxf(m_page, s_s[t]);
    const float m_new = fmaxf(m, m_page);
    const float alpha = expf(m - m_new);
    const int live = min(page, len - base);  // masked keys: exp(-1e30) = 0
    float l_page = 0.f;
    float pv[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) pv[j] = 0.f;
    for (int t = 0; t < live; ++t) {
      const float pt = expf(s_s[t] - m_new);
      l_page += pt;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int d = tid + j * kThreads;
        if (d < D) pv[j] += pt * v_s[t * D + d];
      }
    }
    l = l * alpha + l_page;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[j] = acc[j] * alpha + pv[j];
    m = m_new;
  }

  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int d = tid + j * kThreads;
    if (d < D) out[head_off + d] = acc[j] / denom;
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, void* out, int B, int H,
           int D, int P, int page, int W, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D + 2 * (size_t)page * D + page);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(H, B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out), H, D, P,
      page, W, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pool_dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 on success); the caller checks shapes, types and limits.
int paged_decode_attention_launch(int pool_dtype, const void* q,
                                  const void* k_pages, const void* v_pages,
                                  const void* table, const void* lengths,
                                  void* out, int B, int H, int D, int P,
                                  int page, int W, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, lengths, out, B, H, D,
                         P, page, W, scale, s);
  if (pool_dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out, B,
                                 H, D, P, page, W, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
