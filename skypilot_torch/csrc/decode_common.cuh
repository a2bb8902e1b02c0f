// The per-row arithmetic of K4 (decode_attention.cu) and K4-prefill
// (prefill_attention.cu), in one place so that both kernels run the same
// code: a query row's bits are fixed by its keys' order, which is
//
// 1. splits of a constant 256 keys (ops/decode_attention.py
//    decode_split_plan), each in 64-key tiles;
// 2. in each tile, the slice of keys 16w .. 16w + 15 to "warp" w
//    (slice w), with its own online softmax over the split's tiles in
//    order (`attend_slice`, products on mma.sync m16n8k16, f32
//    accumulation, scores scaled by scale*log2e in f32);
// 3. the four slice states of a split merged in slice order
//    (`merge_slices`);
// 4. the splits merged in split order: L an online max and sum
//    (`merge_split_l`), acc weighted by exp2(m_i - M) with the final M and
//    summed (`fold_split`), then scaled by 1/L and rounded once to bf16
//    (`finish4`).
//
// Keys past a row's span are masked and add exactly nothing (p = 0, and
// the state's max and sum do not move), so a tile or split wholly past a
// row may be skipped or run without changing a bit.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace decode_common {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // keys per tile (ops: DECODE_TILE)
constexpr int kSlices = 4;  // 16-key slices of a tile

using mma::ldsm_x4;
using mma::ldsm_x4_t;
using mma::mma16816;
using mma::pack_bf16;

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Byte address of (row, col) in a swizzled bf16 tile of `rows` rows: hd/64
// atoms of [rows][128 B], the 16-byte chunk c of row r at c ^ (r % 8) (the
// layout TMA writes with the 128-byte swizzle). col is a multiple of 8.
template <int ROWS = kTile>
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int row,
                                              int col) {
  return tile + (col >> 6) * (ROWS * 128) + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4);
}

// 4 int8 codes (one word) -> 2 bf16x2 (code * scale, the exact f32
// product rounded once, as _dequant_kv): a code byte c becomes the f32
// 2^23 + (c ^ 0x80), minus 2^23 + 128 gives c exactly; pairs are packed
// to bf16 (exact: |c| <= 128) and multiplied by the bf16 scale pair sc2
// with one rounding.
__device__ __forceinline__ void dequant4(uint32_t w, uint32_t sc2,
                                         uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)) -
           8388736.f;
  lo = mul_bf16x2(pack_bf16(f[0], f[1]), sc2);
  hi = mul_bf16x2(pack_bf16(f[2], f[3]), sc2);
}

// 16 codes (16 bytes) -> 8 bf16x2, in the codes' order.
__device__ __forceinline__ void dequant16(const uint4 raw, uint32_t sc2,
                                          uint32_t (&o)[8]) {
  dequant4(raw.x, sc2, o[0], o[1]);
  dequant4(raw.y, sc2, o[2], o[3]);
  dequant4(raw.z, sc2, o[4], o[5]);
  dequant4(raw.w, sc2, o[6], o[7]);
}

// 16 dequantized values (cols 16 j .. 16 j + 15 of `row`) into a swizzled
// bf16 tile of kTile rows.
__device__ __forceinline__ void store16(uint8_t* tile, int row, int j,
                                        const uint32_t (&d)[8]) {
  uint8_t* dst = tile + (j >> 2) * (kTile * 128) + row * 128;
  const int sw = row & 7;
  *reinterpret_cast<uint4*>(dst + ((((2 * j) & 7) ^ sw) << 4)) =
      make_uint4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<uint4*>(dst + ((((2 * j + 1) & 7) ^ sw) << 4)) =
      make_uint4(d[4], d[5], d[6], d[7]);
}

// The 16-byte chunk c of int8 code row r in a K4 stage: TMA writes code
// rows swizzled, 128-byte rows (hd 128) with the 128-byte pattern and
// 64-byte rows (hd 64) with the 64-byte one.
template <int HD>
__device__ __forceinline__ int code_chunk(int r, int c) {
  return HD == 128 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

// Keys query w of row b attends: K4's clamp to [1, S], widened by w.
__device__ __forceinline__ int span_of(int len, int w, int S) {
  return min(max(len + w, 1), S);
}

// ---------------------------------------------------------------------
// One slice of one tile: the 16 keys at tile row `first`, for the warp's
// 16 query rows (A fragments from `qf(kk, a)`, the same values wherever
// they are held), online softmax state (m_run, l_run per row g, g+8 of
// the m-tile) and accumulator o. The two k-step chains (even, odd)
// summed, the scale, the mask, the slice's max, the rescale, P rounded to
// bf16, P V in one m16n8k16 chain.
// ---------------------------------------------------------------------

// The slice's scores, scaled by scale_log2 in f32, -inf past each row's
// span. DQK: int8 K dequantized straight into the B operands (codes kc,
// scale pairs ks2), in the permuted dim order the A fragments then hold.
template <int HD, bool DQK, typename QF>
__device__ __forceinline__ void slice_scores(
    uint32_t kt, int key0, int first, const QF& qf, float (&s)[2][4],
    const int (&span)[2], float scale_log2, int lane, const uint8_t* kc,
    const uint32_t (&ks2)[2]) {
  const int t = lane & 3;
  // Two accumulator chains (even and odd k-steps), summed after.
  float s2[2][4];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = s2[nb][e] = 0.f;
  const int krow = first + ((lane >> 4) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t b[4];
    if (DQK) {
      // Codes of keys first + g and first + g + 8, dims 16 kk + 4 t .. + 3:
      // the k-step's k = 2t, 2t+1, 2t+8, 2t+9 in the permuted dim order
      // the A fragments were loaded in.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = first + (lane >> 2) + 8 * h;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            kc + r * HD + code_chunk<HD>(r, kk) * 16 + 4 * t);
        dequant4(w, ks2[h], b[2 * h], b[2 * h + 1]);
      }
    } else {
      ldsm_x4(b, tile_addr(kt, krow, kk * 16 + ((lane >> 3) & 1) * 8));
    }
    uint32_t a[4];
    qf(kk, a);
    float(&acc)[2][4] = (kk & 1) ? s2 : s;
    mma16816(acc[0], a, b[0], b[1]);
    mma16816(acc[1], a, b[2], b[3]);
  }
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] += s2[nb][e];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + first + 8 * nb + 2 * t + (e & 1);
      s[nb][e] = key < span[e >> 1] ? s[nb][e] * scale_log2 : -INFINITY;
    }
}

// The row maxima of a slice's scores (the quad's four lanes agree).
__device__ __forceinline__ void slice_max(const float (&s)[2][4],
                                          float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
  }
}

// The online update of a slice's state by its scores: the row max moves
// (alpha = exp2(m_old - m_new) rescales l, and the caller rescales the
// accumulator by it), P = exp2(S - m) is summed into l and rounded to bf16
// as the A fragments pa of P V.
__device__ __forceinline__ void slice_softmax(const float (&s)[2][4],
                                              float (&m_run)[2],
                                              float (&l_run)[2],
                                              float (&alpha)[2],
                                              uint32_t (&pa)[4]) {
  float mx[2];
  slice_max(s, mx);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], mx[r]);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2f(m_run[r] - m_use[r]);
    l_run[r] *= alpha[r];
    m_run[r] = m_new;
  }
  float p[2][4];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[nb][e] = exp2f(s[nb][e] - m_use[e >> 1]);
      l_run[e >> 1] += p[nb][e];
    }
  pa[0] = pack_bf16(p[0][0], p[0][1]);
  pa[1] = pack_bf16(p[0][2], p[0][3]);
  pa[2] = pack_bf16(p[1][0], p[1][1]);
  pa[3] = pack_bf16(p[1][2], p[1][3]);
}

// P V of a slice (its 16 keys at tile row `first`) into the accumulator
// columns of NDN 16-column blocks from block dn0: o[2 j] holds columns
// 16 (dn0 + j) .. + 7, o[2 j + 1] the next 8. A column's sum does not
// depend on which other columns share the call.
template <int NDN>
__device__ __forceinline__ void slice_pv(uint32_t vt, int first, int dn0,
                                         const uint32_t (&pa)[4],
                                         float (&o)[2 * NDN][4], int lane) {
  const int vrow = first + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int j = 0; j < NDN; ++j) {
    uint32_t b[4];
    ldsm_x4_t(b, tile_addr(vt, vrow,
                           (dn0 + j) * 16 + ((lane >> 4) & 1) * 8));
    mma16816(o[2 * j], pa, b[0], b[1]);
    mma16816(o[2 * j + 1], pa, b[2], b[3]);
  }
}

// The online update and P V over every column (K4: a warp owns a slice
// for all of the head's columns). The accumulator is rescaled only when
// some row's max moved (a factor of 1 changes no bit).
template <int HD>
__device__ __forceinline__ void slice_update(
    uint32_t vt, int first, const float (&s)[2][4], float (&o)[HD / 8][4],
    float (&m_run)[2], float (&l_run)[2], int lane) {
  float alpha[2];
  uint32_t pa[4];
  slice_softmax(s, m_run, l_run, alpha, pa);
  if (!__all_sync(0xffffffff, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e >> 1];
  }
  slice_pv<HD / 16>(vt, first, 0, pa, o, lane);
}

template <int HD, bool DQK, typename QF>
__device__ __forceinline__ void attend_slice(
    uint32_t kt, uint32_t vt, int key0, int first, const QF& qf,
    float (&o)[HD / 8][4], float (&m_run)[2], float (&l_run)[2],
    const int (&span)[2], float scale_log2, int lane, const uint8_t* kc,
    const uint32_t (&ks2)[2]) {
  float s[2][4];
  slice_scores<HD, DQK>(kt, key0, first, qf, s, span, scale_log2, lane, kc,
                        ks2);
  slice_update<HD>(vt, first, s, o, m_run, l_run, lane);
}

// A slice's row sum l over its quad: (t0 + t1) + (t2 + t3), in every lane.
__device__ __forceinline__ void quad_sum(float (&l_run)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffff, l_run[r], 2);
  }
}

// ---------------------------------------------------------------------
// The merges
// ---------------------------------------------------------------------

// A row's split partial from its slices' (m_k, l_k), in slice order: M
// their max, the weights wt_k = exp2(m_k - M) (M = -inf: 0 in its place),
// Ls the weighted sum of the l_k.
__device__ __forceinline__ void merge_slices_ml(const float (&m)[kSlices],
                                                const float (&l)[kSlices],
                                                float& M, float& Ls,
                                                float (&wt)[kSlices]) {
  M = -INFINITY;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) M = fmaxf(M, m[k]);
  const float Mu = M == -INFINITY ? 0.f : M;
  Ls = 0.f;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) {
    wt[k] = exp2f(m[k] - Mu);
    Ls += wt[k] * l[k];
  }
}

// One accumulator element of the split partial: the slices' values x_k
// weighted and summed in slice order.
__device__ __forceinline__ float merge_slices_acc(const float (&wt)[kSlices],
                                                  const float (&x)[kSlices]) {
  float A = 0.f;
#pragma unroll
  for (int k = 0; k < kSlices; ++k) A += wt[k] * x[k];
  return A;
}

// One split's partial of one query row at four columns, from the slices'
// states in shared memory (ml[(k * 16 + row) * 2], acc[(k * 16 + row) * ld
// + 4 d4]).
__device__ __forceinline__ void merge_slices(const float* ml,
                                             const float* acc, int ld,
                                             int row, int d4, float& M,
                                             float& Ls, float4& A) {
  float m[kSlices], l[kSlices], wt[kSlices];
#pragma unroll
  for (int k = 0; k < kSlices; ++k) {
    m[k] = ml[(k * 16 + row) * 2];
    l[k] = ml[(k * 16 + row) * 2 + 1];
  }
  merge_slices_ml(m, l, M, Ls, wt);
  float x[4][kSlices];
#pragma unroll
  for (int k = 0; k < kSlices; ++k) {
    const float4 v =
        *reinterpret_cast<const float4*>(&acc[(k * 16 + row) * ld + 4 * d4]);
    x[0][k] = v.x;
    x[1][k] = v.y;
    x[2][k] = v.z;
    x[3][k] = v.w;
  }
  A = make_float4(merge_slices_acc(wt, x[0]), merge_slices_acc(wt, x[1]),
                  merge_slices_acc(wt, x[2]), merge_slices_acc(wt, x[3]));
}

// A row's (M, L) over its splits, one split (m, l) at a time in split
// order; a split with no visible key (m = -inf, l = 0) is passed over.
__device__ __forceinline__ void merge_split_l(float& M, float& Ls, float m,
                                              float l) {
  if (m == -INFINITY) return;
  const float m_new = fmaxf(M, m);
  Ls = Ls * exp2f(M - m_new) + l * exp2f(m - m_new);
  M = m_new;
}

// The weight of a split's partial (its max m) in the row's sum: exp2(m -
// M) with the row's final M.
__device__ __forceinline__ float split_weight(float m, float M) {
  return exp2f(m - M);
}

// One accumulator element of a split's partial x into the row's sum.
__device__ __forceinline__ void fold_elem(float& A, float wt, float x) {
  A += wt * x;
}

__device__ __forceinline__ void fold_split(float4& A, float m, float M,
                                           const float4 x) {
  const float wt = split_weight(m, M);
  fold_elem(A.x, wt, x.x);
  fold_elem(A.y, wt, x.y);
  fold_elem(A.z, wt, x.z);
  fold_elem(A.w, wt, x.w);
}

// Two adjacent output columns: A scaled by inv = 1 / L, each rounded once
// to bf16.
__device__ __forceinline__ uint32_t finish2(float a, float b, float inv) {
  return pack_bf16(a * inv, b * inv);
}

__device__ __forceinline__ uint2 finish4(const float4 A, float inv) {
  return make_uint2(finish2(A.x, A.y, inv), finish2(A.z, A.w, inv));
}

}  // namespace decode_common
