// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async staging, ldmatrix, the m16n8k16 bf16 mma and
// the rotate-half RoPE of the TPU kernels' _rot / _rot_inv
// (skypilot_tpu/ops/attention.py:139-167).
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A 16x16: a[0] (row g, cols 2t4..+1), a[1] (row g+8, same cols),
//            a[2] (row g, cols 8+2t4..+1), a[3] (row g+8, same cols);
//   B 16x8 : b0 (k rows 2t4..+1, col g), b1 (k rows 8+2t4..+1, col g);
//   C 16x8 : c[0..1] (row g, cols 2t4..+1), c[2..3] (row g+8, same).
// So an f32 C fragment re-packs as a bf16 A fragment with no shuffle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;  // bf16 of row padding: conflict-free ldmatrix
constexpr float kEmptyLse = 1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 cols at column kk*16) of a row-major [rows][LD]
// smem tile whose first row is `base`.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int kk, int lane) {
  ldmatrix_x4(a, base + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (rows np*16.. of an [n][k] tile: the tile
// stores B transposed, e.g. K rows for S = Q K^T), k-step kk.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const bf16* tile, int np, int kk,
                                          int lane) {
  ldmatrix_x4(b, tile + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles (columns dp*16..) of a [k][n] tile (e.g. V
// rows for O = P V), k-step kk.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const bf16* tile, int kk, int dp,
                                          int lane) {
  ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * LD +
                           dp * 16 + (lane >> 4) * 8);
}

// The f32 score fragments s[2kk], s[2kk+1] re-packed as a bf16 A operand.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s0)[4],
                                       const float (&s1)[4]) {
  a[0] = pack_bf16(s0[0], s0[1]);
  a[1] = pack_bf16(s0[2], s0[3]);
  a[2] = pack_bf16(s1[0], s1[1]);
  a[3] = pack_bf16(s1[2], s1[3]);
}

// Rotate-half RoPE of 8 column pairs (c + j, c + j + D/2), j < 8, in
// place: lo = x[c..c+8), hi = x[c+D/2..c+D/2+8) as packed bf16.
//   lo' = lo cos - hi sin,   hi' = hi cos + lo sin
// in f32, rounded to bf16 (the TPU kernel's _rot: rotate in f32, round to
// the input dtype before the dot). cs/sn point at column c of the
// position's row of the [T, D] tables; the tables are the angles
// duplicated to full width (cos = [c, c]), so one angle serves the pair.
__device__ __forceinline__ void rope8(uint4& lo, uint4& hi, const float* cs,
                                      const float* sn) {
  const float4 c0 = *reinterpret_cast<const float4*>(cs);
  const float4 c1 = *reinterpret_cast<const float4*>(cs + 4);
  const float4 s0 = *reinterpret_cast<const float4*>(sn);
  const float4 s1 = *reinterpret_cast<const float4*>(sn + 4);
  const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  __nv_bfloat162* l2 = reinterpret_cast<__nv_bfloat162*>(&lo);
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 l = __bfloat1622float2(l2[e]);
    const float2 h = __bfloat1622float2(h2[e]);
    const int j = 2 * e;
    l2[e] = __floats2bfloat162_rn(l.x * c[j] - h.x * s[j],
                                  l.y * c[j + 1] - h.y * s[j + 1]);
    h2[e] = __floats2bfloat162_rn(h.x * c[j] + l.x * s[j],
                                  h.y * c[j + 1] + l.y * s[j + 1]);
  }
}

// Multiply 8 packed bf16 by f, rounding back to bf16 (the scale*log2e
// fold of the TPU kernels).
__device__ __forceinline__ void scale8(uint4& x, float f) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(p2[e]);
    p2[e] = __floats2bfloat162_rn(v.x * f, v.y * f);
  }
}

// RoPE of a [rows][LD] smem tile in place; row r holds position
// pos0 + r, rows at or past `limit` are left alone (they are zero).
template <int D, int LD, int THREADS>
__device__ __forceinline__ void rope_tile(bf16* tile, int rows, int pos0,
                                          int limit, const float* cosb,
                                          const float* sinb, int tid) {
  constexpr int HALF = D / 16;  // 8-column chunks per half row
  for (int c = tid; c < rows * HALF; c += THREADS) {
    const int r = c / HALF, col = (c % HALF) * 8;
    const int pos = pos0 + r;
    if (pos >= limit) continue;
    uint4* lo = reinterpret_cast<uint4*>(tile + r * LD + col);
    uint4* hi = reinterpret_cast<uint4*>(tile + r * LD + col + D / 2);
    uint4 l = *lo, h = *hi;
    rope8(l, h, cosb + (long long)pos * D + col,
          sinb + (long long)pos * D + col);
    *lo = l;
    *hi = h;
  }
}

// Pull an f32 accumulator fragment back through the rotation (_rot_inv:
// g' = g cos + swap sin with swap = [g_hi, -g_lo]), in registers: the
// thread holding column j also holds column j + D/2 (n-tile i + NT/2).
// rows: the fragment's two row positions (row0, row0 + 8), or -1 to skip.
template <int NT>
__device__ __forceinline__ void rope_inv_frag(float (&acc)[NT][4],
                                              const int (&pos)[2], int t4,
                                              const float* cosb,
                                              const float* sinb, int D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] < 0) continue;
    const float* cs = cosb + (long long)pos[r] * D;
    const float* sn = sinb + (long long)pos[r] * D;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = i * 8 + 2 * t4 + e;
        const float c = cs[col], s = sn[col];
        const float lo = acc[i][2 * r + e], hi = acc[i + NT / 2][2 * r + e];
        acc[i][2 * r + e] = lo * c + hi * s;
        acc[i + NT / 2][2 * r + e] = hi * c - lo * s;
      }
    }
  }
}

}  // namespace flash
