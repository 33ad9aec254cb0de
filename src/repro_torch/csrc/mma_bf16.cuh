// Tensor-core helpers shared by the MPO-linear forward (mpo_linear_mma.cu)
// and cores backward (mpo_linear_bwd.cu): 16-byte cp.async copies into
// shared memory, ldmatrix fragment loads, mma.sync.m16n8k16 with bf16 inputs
// and f32 accumulators, and the split of f32 values into bf16 terms.
#pragma once
#include <stdint.h>

#include "common.cuh"

namespace repro {

// 16 bytes from global to shared memory; src_bytes 0 fills the 16 bytes with
// zeros (a row or column past the edge)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// c += a . b, one m16n8k16 tile: bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four f32 values as NT bf16 terms, each bf16 of what the terms before it
// leave (three terms keep ~24 bits: float32's own precision); term t of the
// four goes to dst + t * stride (8-byte aligned).
template <int NT>
__device__ __forceinline__ void split_terms4(float4 v, __nv_bfloat16* dst, int stride) {
  float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    __nv_bfloat162 h[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      const float2 b = __bfloat1622float2(h[k]);
      f[2 * k] -= b.x;
      f[2 * k + 1] -= b.y;
    }
    *reinterpret_cast<uint2*>(dst + t * stride) = *reinterpret_cast<const uint2*>(h);
  }
}

}  // namespace repro
