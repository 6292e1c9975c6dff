// Warp-level tensor-core helpers shared by the bf16 kernels that run on
// mma.sync (flash_prefill.cu, gmm_prefill.cu): ldmatrix loads of four 8 x 8
// bf16 tiles from shared memory, plain or transposed, the m16n8k16 product
// with f32 accumulators, and the packing of two f32 values into a bf16 pair
// (or into a bf16 pair and the bf16 pair of what its rounding left out).
#pragma once
#include "common.cuh"

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// Two f32 values as a bf16 pair, returned, and what that rounding left out,
// as a second bf16 pair in `rest`: (x - bf16(x)) is exact in f32, and its
// bf16 carries x to about 2^-17 of itself.
__device__ __forceinline__ uint32_t pack_bf16_split(float lo, float hi, uint32_t& rest) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 back = __bfloat1622float2(h);
  rest = pack_bf16(lo - back.x, hi - back.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
