// Warp-level tensor-core primitives (mma.sync m16n8k16 bf16 -> f32 and
// ldmatrix), shared by the decode attention (decode_attention.cu) and the
// M-invariant GEMM (matmul_invariant.cu).
#pragma once

#include <stdint.h>

namespace mma {

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 -> f32. Fragments (g = lane / 4,
// t = lane % 4): a0 (row g, k 2t..2t+1), a1 (row g+8), a2 (row g, k
// 2t+8..), a3 (row g+8, k 2t+8..); b0 (k 2t..2t+1, col g), b1 (k 2t+8..);
// d0, d1 (row g, cols 2t, 2t+1), d2, d3 (row g+8). Each element of d is
// its own row's and column's sum: no other row of the tile enters it.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> bf16x2, each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

}  // namespace mma
