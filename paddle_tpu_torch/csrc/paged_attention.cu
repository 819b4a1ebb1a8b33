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
//   k/v pool (P, page, H, D)    float32, bfloat16 or float16
//   table    (B, W)             int32, entries clamped to [0, P-1]
//   lengths  (B,)               int32, tokens in the cache, query included
//   out      (B, H, D)          float32 (q's dtype)
//
// Pages at or past min(ceil(len/page), W) are never read; positions at
// or past len are masked; a lane with len == 0 yields zeros (the
// max(l, 1e-30) guard of the reference). Softmax and accumulation run in
// float32 whatever the pool type.
//
// Bound on an H100 SXM: memory. A decode step must read each live K/V
// row once: sum over lanes of ceil(len/page) * page * H * D * bytes * 2,
// at 3.35 TB/s; its 4 * len * H * D float32 operations are two orders
// of magnitude below the 67 TFLOP/s float32 rate.
//
// Design: a split over pages (flash-decoding), two kernels.
//
// The TPU kernel runs the page axis as a sequential grid dimension and
// carries the online-softmax state (m, l, acc) in VMEM from one step to
// the next. Blocks on this card run in no order, and one block per
// (lane, head) walking the whole context alone (192 CTAs on 132 SMs at
// the serving width, the longest lanes setting the time) leaves the
// card's bandwidth mostly idle. So each lane's live pages are cut into chunks
// of a fixed number of pages, which depends on the page size alone (the
// wrapper's chunk_pages: 256 tokens), and paged_decode_chunk_kernel
// gives one warp to each (chunk, head, lane): about a thousand warps at
// the serving width, all resident at once. A CTA holds the warps of
// `heads_per_cta` heads of one chunk and lane (4 from the wrapper); a
// token row of a page holds all H heads contiguously, so those warps
// read neighbouring slices of the same rows.
//
// In a warp, LPT lanes share one token (LPT = the head's vectors,
// rounded up to a power of two, at most 32), so 32 / LPT tokens are
// read per load instruction, 16 bytes a lane (4 float32 or 8 bfloat16 or
// float16, which takes bfloat16's path throughout;
// narrower only where D or the pool's alignment forbids). A stage is
// 8 loads a lane of K and of V in float32 and 4 in bfloat16: 16 tokens
// at D = 64 in both. The next stage's loads are issued into a second
// set of registers before the current stage is folded, so a warp
// always has one stage in flight. The chunk's page ids are read once
// into shared memory, and each token's place (page, row) is stepped
// from stage to stage with adds, so the loop has no division and no
// branch. q . k is a shuffle reduction over the LPT lanes; the stage's
// max is one more shuffle across the token slots, once a stage; each
// lane folds its tokens into its own float32 (l, acc) with the rescale
// of the online softmax, in base 2 (q carries the scale and log2(e)),
// and the token slots' partials are summed by shuffles at the end of
// the chunk. The chunk's (acc, m, l) go to a float32 scratch row
// (B, H, chunks, D + 2).
//
// paged_decode_combine_kernel then gives one warp to each (lane, head)
// and folds its chunks' rows in chunk order: out = sum_c acc_c *
// 2^(m_c - M) / max(sum_c l_c * 2^(m_c - M), 1e-30), M the largest
// m_c. Only the lane's live chunks are read. No atomics anywhere: the
// output is the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadsPerCta = 4;
constexpr int kMaxChunkPages = 1024;  // page ids a warp keeps in shared memory
constexpr int kMaxHeadDim = 256;
constexpr int kCombineWarps = 4;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// NE elements of the pool, loaded as one access of NE * sizeof(T) bytes
template <typename T, int NE>
struct alignas(sizeof(T) * NE) Vec {
  T e[NE];
};

// tokens a lane loads of K and of V in one stage: 8 vectors a lane in
// float32 pools, 4 in bfloat16 (which unpacks each to twice the float32
// registers; 8 spilled)
template <typename T, int VPL>
constexpr int kStageTokens = (sizeof(T) == 4 ? 8 : 4) / VPL > 1
                                 ? (sizeof(T) == 4 ? 8 : 4) / VPL
                                 : 1;

// K and V of one stage: U tokens a lane, VPL vectors of each
template <typename T, int NE, int VPL, int U>
struct Stage {
  Vec<T, NE> k[U][VPL], v[U][VPL];
};

// d summed over the `lanes` lanes of a group (a power of two, at most
// 32); the offsets are fixed, so no loop or branch is left
__device__ __forceinline__ float sum_within(float d, int lanes) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < lanes) d += __shfl_xor_sync(0xffffffffu, d, off);
  return d;
}

template <typename T, int NE, int VPL>
__global__ void __launch_bounds__(32 * kMaxHeadsPerCta)
paged_decode_chunk_kernel(const float* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int32_t* __restrict__ table,
                          const int32_t* __restrict__ lengths,
                          float* __restrict__ part, int H, int D, int P,
                          int page, int W, int chunk_pages, int chunks,
                          int heads_per_cta, int lpt, float scale) {
  constexpr int U = kStageTokens<T, VPL>;
  const int h = blockIdx.y * heads_per_cta + (threadIdx.x >> 5);
  if (h >= H) return;  // whole warps leave; the kernel has no barrier
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int n_pages = min(len > 0 ? (len + page - 1) / page : 0, W);
  const int p0 = c * chunk_pages;
  if (p0 >= n_pages) return;  // past the lane's live pages: never read
  const int t0 = p0 * page;
  const int t1 = min(p0 + chunk_pages, n_pages) * page;
  const int live_end = min(len, t1);  // positions at or past it masked

  const int lane = threadIdx.x & 31;
  const int slots = 32 / lpt;       // tokens a load instruction
  const int slot = lane / lpt;
  const int j0 = lane - slot * lpt;  // this lane's first vector of a row
  const int dv = D / NE;
  const int per_stage = slots * U;

  // scores in base 2: q carries the scale and log2(e)
  float qf[VPL][NE];
  int col[VPL];  // element offset of each of the lane's vectors in a row
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = j0 + v * lpt;
    col[v] = (j < dv ? j : 0) * NE;  // idle lanes read column 0, unused
#pragma unroll
    for (int e = 0; e < NE; ++e)
      qf[v][e] = j < dv ? q[((size_t)b * H + h) * D + j * NE + e] * scale *
                              1.4426950408889634f
                        : 0.f;
  }

  // the chunk's page ids, read once and clamped into shared memory
  extern __shared__ int32_t pid_smem[];
  int32_t* pids = pid_smem + (threadIdx.x >> 5) * chunk_pages;
  const int32_t* trow = table + (size_t)b * W + p0;
  for (int i = lane; i < t1 / page - p0; i += 32)
    pids[i] = min(max(trow[i], 0), P - 1);
  __syncwarp();

  // where token u of the next stage lies: its page in the chunk << 16 |
  // its row in the page, stepped by a stage's tokens each stage with no
  // division (page < 2^15)
  int pos[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = u * slots + slot;
    pos[u] = (r / page) << 16 | (r % page);
  }
  const int step = (per_stage / page) << 16 | (per_stage % page);
  const int row_stride = H * D;  // one token in a page
  const size_t page_stride = (size_t)page * row_stride;
  const T* kh = k_pages + h * D;
  const T* vh = v_pages + h * D;

  // a stage's loads; a token past the chunk reads the chunk's first row
  // (its score is masked)
  auto load = [&](Stage<T, NE, VPL, U>& s, int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = base + u * slots + slot < t1;
      const int at = in ? pos[u] : 0;
      const size_t off = (size_t)pids[at >> 16] * page_stride +
                         (size_t)(at & 0xffff) * row_stride;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        s.k[u][v] = *reinterpret_cast<const Vec<T, NE>*>(kh + off + col[v]);
        s.v[u][v] = *reinterpret_cast<const Vec<T, NE>*>(vh + off + col[v]);
      }
      int x = pos[u] + step;
      if ((x & 0xffff) >= page) x += (1 << 16) - page;
      pos[u] = x;
    }
  };

  float m = kNegInf, l = 0.f;
  float acc[VPL][NE];
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[v][e] = 0.f;

  auto fold = [&](const Stage<T, NE, VPL, U>& s, int base) {
    float sc[U];
    bool live[U];
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
#pragma unroll
        for (int e = 0; e < NE; ++e) d += qf[v][e] * to_float(s.k[u][v].e[e]);
      d = sum_within(d, lpt);
      live[u] = base + u * slots + slot < live_end;
      sc[u] = live[u] ? d : kNegInf;
      mx = fmaxf(mx, sc[u]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)  // across the token slots
      if (off >= lpt) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);  // the stage's max, once a stage
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[v][e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // a masked key adds nothing, also while no key of the chunk is live
      const float p = live[u] ? exp2f(sc[u] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[v][e] += p * to_float(s.v[u][v].e[e]);
    }
    m = m_new;
  };

  // two register stages: the next one's loads are in flight while the
  // current one is folded
  Stage<T, NE, VPL, U> sa, sb;
  load(sa, t0);
  for (int base = t0; base < t1; base += 2 * per_stage) {
    const int next = base + per_stage;
    if (next < t1) load(sb, next);
    fold(sa, base);
    if (next >= t1) break;
    if (next + per_stage < t1) load(sa, next + per_stage);
    fold(sb, next);
  }

  // sum the token slots' partials
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off < lpt) continue;
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int e = 0; e < NE; ++e)
        acc[v][e] += __shfl_xor_sync(0xffffffffu, acc[v][e], off);
  }
  float* row = part + (((size_t)b * H + h) * chunks + c) * (D + 2);
  if (slot == 0) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int j = j0 + v * lpt;
      if (j < dv)
#pragma unroll
        for (int e = 0; e < NE; ++e) row[j * NE + e] = acc[v][e];
    }
  }
  if (lane == 0) {
    row[D] = m;
    row[D + 1] = l;
  }
}

// one warp per (lane, head): its live chunks' rows folded in chunk order
__global__ void __launch_bounds__(32 * kCombineWarps)
paged_decode_combine_kernel(const float* __restrict__ part,
                            const int32_t* __restrict__ lengths,
                            float* __restrict__ out, int B, int H, int D,
                            int page, int W, int chunk_pages, int chunks) {
  constexpr int kCols = kMaxHeadDim / 32;
  const int bh = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (bh >= B * H) return;
  const int lane = threadIdx.x & 31;
  const int len = lengths[bh / H];
  const int n_pages = min(len > 0 ? (len + page - 1) / page : 0, W);
  const int live = (n_pages + chunk_pages - 1) / chunk_pages;
  const float* rows = part + (size_t)bh * chunks * (D + 2);

  // the largest m, the lanes reading the chunks' m at once
  float mg = kNegInf;
  for (int c = lane; c < live; c += 32)
    mg = fmaxf(mg, rows[(size_t)c * (D + 2) + D]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, off));
  float l = 0.f, acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int c = 0; c < live; ++c) {
    const float* r = rows + (size_t)c * (D + 2);
    const float w = exp2f(r[D] - mg);  // m in base 2
    l += w * r[D + 1];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] += w * r[d];
    }
  }
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[(size_t)bh * D + d] = acc[i] / denom;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T, int NE, int VPL>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, void* out, void* part,
           int B, int H, int D, int P, int page, int W, int chunk_pages,
           int chunks, int heads_per_cta, int lpt, float scale,
           cudaStream_t stream) {
  const dim3 grid(chunks, (H + heads_per_cta - 1) / heads_per_cta, B);
  const size_t smem = sizeof(int32_t) * heads_per_cta * chunk_pages;
  paged_decode_chunk_kernel<T, NE, VPL><<<grid, 32 * heads_per_cta, smem,
                                          stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<float*>(part), H, D,
      P, page, W, chunk_pages, chunks, heads_per_cta, lpt, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int pairs = B * H;
  paged_decode_combine_kernel<<<(pairs + kCombineWarps - 1) / kCombineWarps,
                                32 * kCombineWarps, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(lengths),
      static_cast<float*>(out), B, H, D, page, W, chunk_pages, chunks);
  return (int)cudaGetLastError();
}

// the widest access (at most 16 bytes) that D and both pools' alignment
// allow, and the vectors a lane holds of each head's row
template <typename T>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* table, const void* lengths, void* out, void* part,
             int B, int H, int D, int P, int page, int W, int chunk_pages,
             int chunks, int heads_per_cta, float scale, cudaStream_t s) {
  int ne = 16 / (int)sizeof(T);
  while (ne > 1 && (D % ne != 0 ||
                    reinterpret_cast<uintptr_t>(k_pages) % (ne * sizeof(T)) ||
                    reinterpret_cast<uintptr_t>(v_pages) % (ne * sizeof(T))))
    ne /= 2;
  const int dv = D / ne;
  const int lpt = dv < 32 ? pow2_at_least(dv) : 32;
  const int vpl = pow2_at_least((dv + 31) / 32);
#define CASE(NE, VPL)                                                       \
  if (ne == NE && vpl == VPL)                                               \
    return launch<T, NE, VPL>(q, k_pages, v_pages, table, lengths, out, part, \
                              B, H, D, P, page, W, chunk_pages, chunks,     \
                              heads_per_cta, lpt, scale, s);
  if constexpr (sizeof(T) == 2) {
    CASE(8, 1)
  }
  CASE(4, 1) CASE(4, 2)
  CASE(2, 1) CASE(2, 2) CASE(2, 4)
  CASE(1, 1) CASE(1, 2) CASE(1, 4) CASE(1, 8)
#undef CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// pool_dtype: 0 = float32, 1 = bfloat16, 2 = float16. part: (B, H, chunks, D + 2)
// float32 scratch, chunks = ceil(W / chunk_pages). Returns the
// cudaError_t of the launches (0 on success); the caller checks shapes,
// types and limits.
int paged_decode_attention_launch(int pool_dtype, const void* q,
                                  const void* k_pages, const void* v_pages,
                                  const void* table, const void* lengths,
                                  void* out, void* part, int B, int H, int D,
                                  int P, int page, int W, int chunk_pages,
                                  int chunks, int heads_per_cta, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > kMaxHeadDim || heads_per_cta < 1 ||
      heads_per_cta > kMaxHeadsPerCta || chunk_pages < 1 ||
      chunk_pages > kMaxChunkPages || chunks * chunk_pages < W ||
      page < 1 || page >= 1 << 15)
    return (int)cudaErrorInvalidValue;
  if (pool_dtype == 0)
    return dispatch<float>(q, k_pages, v_pages, table, lengths, out, part, B,
                           H, D, P, page, W, chunk_pages, chunks,
                           heads_per_cta, scale, s);
  if (pool_dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out,
                                   part, B, H, D, P, page, W, chunk_pages,
                                   chunks, heads_per_cta, scale, s);
  if (pool_dtype == 2)
    return dispatch<__half>(q, k_pages, v_pages, table, lengths, out, part,
                            B, H, D, P, page, W, chunk_pages, chunks,
                            heads_per_cta, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
