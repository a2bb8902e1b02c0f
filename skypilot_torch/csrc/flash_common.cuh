// Pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, attention_packed.cu): the bf16 type and packing, the
// empty-row lse, and the rotate-half RoPE of the TPU kernels' _rot /
// _rot_inv (skypilot_tpu/ops/attention.py:139-167): the rotation of
// whole q and k rows that K1's RoPE entry and the backward's pre-pass
// both run (one code, so the backward's rotated operands are the bits
// the forward computed its lse from), and the inverse rotation of a
// wgmma accumulator in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float kEmptyLse = 1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rotate-half RoPE of 8 column pairs (c + j, c + j + D/2), j < 8, in
// place: lo = x[c..c+8), hi = x[c+D/2..c+D/2+8) as packed bf16.
//   lo' = lo cos - hi sin,   hi' = hi cos + lo sin
// in f32, rounded to bf16 (the TPU kernel's _rot: rotate in f32, round to
// the input dtype before the dot). Each product and the sum round in f32
// with no FMA contraction, as the plain version (attention._rot) rounds
// them, so the two give the same bits. cs/sn point at column c of the
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
    l2[e] = __floats2bfloat162_rn(
        __fsub_rn(__fmul_rn(l.x, c[j]), __fmul_rn(h.x, s[j])),
        __fsub_rn(__fmul_rn(l.y, c[j + 1]), __fmul_rn(h.y, s[j + 1])));
    h2[e] = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(h.x, c[j]), __fmul_rn(l.x, s[j])),
        __fadd_rn(__fmul_rn(h.y, c[j + 1]), __fmul_rn(l.y, s[j + 1])));
  }
}

// The rotation pre-pass over every row of q [B,T,H,D] and k [B,T,Hkv,D]
// (T == S), read through strides: q rows go to qr (strides o_*), k rows
// to kr, a contiguous [B,T,Hkv,D] tensor. Work item i (of
// rope_items()) rotates the column pairs (8j + c, 8j + c + D/2), c < 8,
// of one row: q for heads [0, H), k for [H, H + Hkv).
struct RopeArgs {
  const bf16* q;
  const bf16* k;
  const float* cosb;
  const float* sinb;
  bf16* qr;
  bf16* kr;
  int B, T, H, Hkv;
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, o_sb, o_st, o_sh;
};

template <int D>
__host__ __device__ __forceinline__ long long rope_items(const RopeArgs& a) {
  return (long long)a.B * a.T * (a.H + a.Hkv) * (D / 16);
}

template <int D>
__device__ __forceinline__ void rope_item(const RopeArgs& a, long long i) {
  constexpr int HALF = D / 16;  // 8-column chunks per half row
  const int col = int(i % HALF) * 8;
  long long rest = i / HALF;
  const int head = int(rest % (a.H + a.Hkv));
  rest /= a.H + a.Hkv;
  const int pos = int(rest % a.T);
  const int b = int(rest / a.T);
  const bf16* src;
  bf16* dst;
  if (head < a.H) {
    src = a.q + b * a.q_sb + pos * a.q_st + head * a.q_sh;
    dst = a.qr + b * a.o_sb + pos * a.o_st + head * a.o_sh;
  } else {
    const int kh = head - a.H;
    src = a.k + b * a.k_sb + pos * a.k_st + kh * a.k_sh;
    dst = a.kr + (((long long)b * a.T + pos) * a.Hkv + kh) * D;
  }
  uint4 lo = *reinterpret_cast<const uint4*>(src + col);
  uint4 hi = *reinterpret_cast<const uint4*>(src + col + D / 2);
  rope8(lo, hi, a.cosb + (long long)pos * D + col,
        a.sinb + (long long)pos * D + col);
  *reinterpret_cast<uint4*>(dst + col) = lo;
  *reinterpret_cast<uint4*>(dst + col + D / 2) = hi;
}

// Pull an f32 m64nD wgmma accumulator back through the rotation
// (_rot_inv: g' = g cos + swap sin with swap = [g_hi, -g_lo]), in
// registers. acc[4j + e] is row r0 + 8 (e / 2), column 8j + 2 t4 + (e %
// 2), so the thread holding column c also holds c + D/2 (j + D/16).
// pos: the two rows' positions, or -1 to skip a row.
template <int D>
__device__ __forceinline__ void rope_inv_acc(float (&acc)[D / 2],
                                             const int (&pos)[2], int t4,
                                             const float* cosb,
                                             const float* sinb) {
  constexpr int HALF = D / 16;  // 8-column blocks per half row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] < 0) continue;
    const float* cs = cosb + (long long)pos[r] * D;
    const float* sn = sinb + (long long)pos[r] * D;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t4 + e;
        const float c = cs[col], s = sn[col];
        float& lo = acc[4 * j + 2 * r + e];
        float& hi = acc[4 * (j + HALF) + 2 * r + e];
        const float l = lo, h = hi;
        lo = l * c + h * s;
        hi = h * c - l * s;
      }
    }
  }
}

}  // namespace flash
