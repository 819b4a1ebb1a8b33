// Tensor-core building blocks for Hopper (sm_90a) kernels on bfloat16 or
// float16 operands: cp.async copies into shared memory, ldmatrix fragment
// loads and the warp-level mma.sync m16n8k16 product with float32 sums.
// The functions that depend on the operand type take it as T
// (__nv_bfloat16 or __half); both are 16-bit, so fragments, ldmatrix and
// the layouts below are the same for the two.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + t, g = 0..7,
// t = 0..3), each register two 16-bit values (lower column in the low
// half):
//
//   A 16 x 16, row-major:  a0 (g, 2t..2t+1)    a1 (g+8, 2t..2t+1)
//                          a2 (g, 2t+8..2t+9)  a3 (g+8, 2t+8..2t+9)
//   B 16 x 8 (K x N):      b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C 16 x 8, float32:     c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
//
// so the C fragments of two neighbouring n-tiles are, packed in pairs,
// the A fragment of one 16-wide k-chunk: a product's result feeds the
// next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when
// !valid (src must still be a mapped address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, the same way
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bfloat16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i (row g, columns 2t, 2t+1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed: register i receives (rows 2t, 2t+1,
// column g) of matrix i
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b, a 16 x 16 and b 16 x 8 of T, c 16 x 8 float32
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to two values of T in one register, x in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  const __half2 h = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the two values of T in a register, as float32
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// (x, y) as two halves of T: hi rounds (x, y), lo rounds what hi leaves,
// so hi + lo holds ~16 significant bits in bfloat16 and ~22 in float16
// (where neither is subnormal)
template <typename T>
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack2<T>(x, y);
  const float2 f = unpack2<T>(hi);
  lo = pack2<T>(x - f.x, y - f.y);
}

}  // namespace tc
