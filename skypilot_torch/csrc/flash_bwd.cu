// K2-cuda and K3-cuda: the flash-attention backward for Hopper (sm_90a).
//
// Replace the TPU kernels skypilot_tpu/ops/attention.py:_bwd_dq_kernel
// (K2) and :_bwd_dkv_kernel (K3), launched by _bwd_pallas. Same contract:
//   q/dO [B,T,H,D], k/v [B,S,Hkv,D] bf16 (read through strides), lse and
//   delta = rowsum(dO * O) f32 [B,H,T] (lse in the log2 domain, +1e30 for
//   a row that sees no key, which makes its P and so its gradients 0),
//   optional f32 [T, D] cos/sin tables (T == S) when RoPE was fused into
//   the forward: q/k are the UN-rotated inputs, rotated here on load, and
//   the gradients are pulled back through the rotation (_rot_inv) before
//   they are written. dq [B,T,H,D], dk/dv [B,S,Hkv,D] bf16.
// P = exp2(S - lse) with S in the log2 domain; dS = P * (dP - delta); the
// softmax scale is applied once to the accumulated dq / dk. As on the TPU,
// K2 folds scale*log2(e) into q (rounded to bf16) and K3 into k.
// Bottom-right causal alignment q_pos + S - T >= k_pos; any T and S: the
// ragged edges are zero-filled and masked in the kernels.
//
// What bounds them on the H100: like the forward, the tensor cores (K2
// runs 3 and K3 4 products of T x S x D per head, halved by the causal
// mask) against a few bytes per row; at T = S = 2048 both are compute-
// bound by ~100x. Design, with mma.sync m16n8k16 bf16 -> f32 and cp.async
// double buffering as in K1:
// - K2: one block of 4 warps per (64-row q tile, head, batch row), each
//   warp 16 q rows. The staged q (rotated, scaled) and dO stay in shared
//   memory; K/V tiles of 64 keys stream through. Per tile: S = q K^T,
//   P = exp2(S - lse), dP = dO V^T, dS = P (dP - delta) in registers, then
//   dQ += dS K with dS re-packed as the A operand. dq is f32 in registers
//   for the whole key loop. With RoPE the K tile is rotated in shared
//   memory once it lands.
// - K3: one block of 4 warps per (64-key tile, kv head, batch row), each
//   warp 16 keys. The block loops over the kv head's H/Hkv query heads and
//   over the 32-row q tiles the causal bound leaves (the sequential grid
//   axis of the TPU kernel becomes this loop), so dK/dV stay f32 in
//   registers for the whole group: no atomics, no repeated K/V, one write.
//   Per q tile, in the transposed frame (rows = keys): S^T = k2 q^T,
//   P^T = exp2(S^T - lse), dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T -
//   delta), dK += dS^T q. q tiles, dO tiles, lse and delta stream through
//   double-buffered shared memory; with RoPE each q tile is rotated once
//   it lands.
// Not yet done (later work): wgmma/TMA, warp specialisation, larger tiles,
// K2/K3 fused into one pass.

#include <math.h>

#include "mma_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;
constexpr int kBQ2 = 64;  // K2: q rows per block
constexpr int kBK2 = 64;  // K2: keys per streamed tile
constexpr int kBK3 = 64;  // K3: keys per block
constexpr int kBQ3 = 32;  // K3: q rows per streamed tile

struct Strides {
  long long q[3], k[3], v[3], o[3], dq[3], dk[3], dv[3];  // (b, t/s, h)
};

// Stage rows [r0, r0 + rows) of one head of a [B,T,H,D] tensor into a
// [rows][LD] smem tile; rows past `limit` become zero. Optionally RoPE
// (table row = position) and a scale fold, both rounded to bf16.
template <int D, int LD, bool ROPE>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long row_stride, int r0,
                                           int rows, int limit,
                                           const float* cosb,
                                           const float* sinb, bool do_scale,
                                           float scale, int tid) {
  constexpr int CPR = D / 8;
  if (ROPE) {
    for (int c = tid; c < rows * (CPR / 2); c += kThreads) {
      const int r = c / (CPR / 2), col = (c % (CPR / 2)) * 8;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (r0 + r < limit) {
        const bf16* row = src + (r0 + r) * row_stride;
        lo = *reinterpret_cast<const uint4*>(row + col);
        hi = *reinterpret_cast<const uint4*>(row + col + D / 2);
        rope8(lo, hi, cosb + (long long)(r0 + r) * D + col,
              sinb + (long long)(r0 + r) * D + col);
      }
      if (do_scale) {
        scale8(lo, scale);
        scale8(hi, scale);
      }
      *reinterpret_cast<uint4*>(dst + r * LD + col) = lo;
      *reinterpret_cast<uint4*>(dst + r * LD + col + D / 2) = hi;
    }
  } else {
    for (int c = tid; c < rows * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r0 + r < limit)
        raw = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride +
                                              col);
      if (do_scale) scale8(raw, scale);
      *reinterpret_cast<uint4*>(dst + r * LD + col) = raw;
    }
  }
}

// Asynchronous copy of rows [r0, r0 + rows) (zero past `limit`).
template <int D, int LD>
__device__ __forceinline__ void copy_rows_async(bf16* dst, const bf16* src,
                                                long long row_stride, int r0,
                                                int rows, int limit,
                                                int tid) {
  constexpr int CPR = D / 8;
  for (int c = tid; c < rows * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * LD + col,
               ok ? src + (r0 + r) * row_stride + col : src, ok);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// ---------------------------------------------------------------------
// K2: dQ
// ---------------------------------------------------------------------

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ cosb,
                        const float* __restrict__ sinb,
                        bf16* __restrict__ dq, int T, int S, int H, int Hkv,
                        Strides st, float scale, float scale_log2,
                        int causal) {
  constexpr int LD = D + kPad;
  constexpr int NT_S = kBK2 / 8;
  constexpr int NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [kBQ2][LD]
  bf16* sdO = sQ + kBQ2 * LD;                     // [kBQ2][LD]
  bf16* sK = sdO + kBQ2 * LD;                     // [2][kBK2][LD]
  bf16* sV = sK + 2 * kBK2 * LD;                  // [2][kBK2][LD]

  const int q0 = blockIdx.x * kBQ2;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int offset = S - T;

  const bf16* qb = q + b * st.q[0] + h * st.q[2];
  const bf16* dob = dO + b * st.o[0] + h * st.o[2];
  const bf16* kb = k + b * st.k[0] + kvh * st.k[2];
  const bf16* vb = v + b * st.v[0] + kvh * st.v[2];

  // The forward's tile classes: [0, n_full) unmasked, [n_full, n_kt)
  // masked (diagonal or ragged end of S), the rest hidden.
  int n_kt = (S + kBK2 - 1) / kBK2;
  int n_full = S / kBK2;
  if (causal) {
    const int last_key = min(q0 + kBQ2, T) - 1 + offset;
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / kBK2 + 1);
    const int first_row_keys = q0 + offset + 1;
    n_full = min(n_full, first_row_keys > 0 ? first_row_keys / kBK2 : 0);
  }
  n_full = min(n_full, n_kt);

  auto load_kv = [&](int kt, int buf) {
    copy_rows_async<D, LD>(sK + buf * kBK2 * LD, kb, st.k[1], kt * kBK2,
                           kBK2, S, tid);
    copy_rows_async<D, LD>(sV + buf * kBK2 * LD, vb, st.v[1], kt * kBK2,
                           kBK2, S, tid);
  };
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();

  stage_rows<D, LD, ROPE>(sQ, qb, st.q[1], q0, kBQ2, T, cosb, sinb, true,
                          scale_log2, tid);
  stage_rows<D, LD, false>(sdO, dob, st.o[1], q0, kBQ2, T, nullptr, nullptr,
                           false, 0.f, tid);

  // This thread's two rows; a row past T gets lse = +1e30 (P = 0).
  const int row0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long i = ((long long)b * H + h) * T + row;
    lse_r[r] = row < T ? lse[i] : kEmptyLse;
    delta_r[r] = row < T ? delta[i] : 0.f;
  }

  float acc[NT_O][4];
  zero(acc);
  uint32_t q_frag[D / 16][4];
  const bf16* wdO = sdO + warp * 16 * LD;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    bf16* tK = sK + (kt & 1) * kBK2 * LD;
    const bf16* tV = sV + (kt & 1) * kBK2 * LD;
    if (ROPE) {
      rope_tile<D, LD, kThreads>(tK, kBK2, kt * kBK2, S, cosb, sinb, tid);
      __syncthreads();
    }
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a<LD>(q_frag[kk], sQ + warp * 16 * LD, kk, lane);
    }

    // S = q2 K^T and dP = dO V^T, 16 rows x 64 keys each.
    float s[NT_S][4], dp[NT_S][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t da[4];
      load_a<LD>(da, wdO, kk, lane);
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk<LD>(bk, tK, np, kk, lane);
        mma_bf16(s[2 * np], q_frag[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], q_frag[kk], bk[2], bk[3]);
        load_b_nk<LD>(bv, tV, np, kk, lane);
        mma_bf16(dp[2 * np], da, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta), P = exp2(S - lse); masked entries give P = 0.
    const bool masked = kt >= n_full;
#pragma unroll
    for (int i = 0; i < NT_S; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(s[i][e] - lse_r[r]);
        if (masked) {
          const int key = kt * kBK2 + i * 8 + 2 * t4 + (e & 1);
          const int row = row0 + 8 * r;
          if (!(key < S && (!causal || key <= row + offset))) p = 0.f;
        }
        s[i][e] = p * (dp[i][e] - delta_r[r]);
      }

    // dQ += dS K.
#pragma unroll
    for (int kk = 0; kk < kBK2 / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < NT_O / 2; ++dn) {
        uint32_t bk[4];
        load_b_kn<LD>(bk, tK, kk, dn, lane);
        mma_bf16(acc[2 * dn], pa, bk[0], bk[1]);
        mma_bf16(acc[2 * dn + 1], pa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < NT_O; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] *= scale;
  if (ROPE) {
    const int pos[2] = {row0 < T ? row0 : -1, row0 + 8 < T ? row0 + 8 : -1};
    rope_inv_frag<NT_O>(acc, pos, t4, cosb, sinb, D);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    bf16* drow = dq + b * st.dq[0] + row * st.dq[1] + h * st.dq[2];
#pragma unroll
    for (int i = 0; i < NT_O; ++i)
      *reinterpret_cast<__nv_bfloat162*>(drow + i * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------
// K3: dK, dV
// ---------------------------------------------------------------------

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ cosb,
                         const float* __restrict__ sinb,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                         int S, int H, int Hkv, Strides st, float scale,
                         float scale_log2, int causal) {
  constexpr int LD = D + kPad;
  constexpr int NT_Q = kBQ3 / 8;  // n-tiles of the S^T block (q columns)
  constexpr int NT_O = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [kBK3][LD], k2
  bf16* sV = sK + kBK3 * LD;                      // [kBK3][LD]
  bf16* sQ = sV + kBK3 * LD;                      // [2][kBQ3][LD]
  bf16* sdO = sQ + 2 * kBQ3 * LD;                 // [2][kBQ3][LD]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kBQ3 * LD);  // [2][kBQ3]
  float* sDelta = sLse + 2 * kBQ3;                               // [2][kBQ3]

  const int k0 = blockIdx.x * kBK3;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int offset = S - T;

  const bf16* kb = k + b * st.k[0] + kvh * st.k[2];
  const bf16* vb = v + b * st.v[0] + kvh * st.v[2];

  // q tiles [qt0, n_qt) hold every row that sees a key of this block; a
  // tile whose first row sees the block's last key needs no mask.
  const int n_qt = (T + kBQ3 - 1) / kBQ3;
  int qt0 = 0;
  if (causal) {
    const int first_row = k0 - offset;  // first q row that sees key k0
    qt0 = first_row <= 0 ? 0 : min(n_qt, first_row / kBQ3);
  }
  const int per_head = n_qt - qt0;
  const int n_it = G * per_head;

  auto load_q = [&](int it, int buf) {
    const int h = kvh * G + it / per_head;
    const int r0 = (qt0 + it % per_head) * kBQ3;
    copy_rows_async<D, LD>(sQ + buf * kBQ3 * LD,
                           q + b * st.q[0] + h * st.q[2], st.q[1], r0, kBQ3,
                           T, tid);
    copy_rows_async<D, LD>(sdO + buf * kBQ3 * LD,
                           dO + b * st.o[0] + h * st.o[2], st.o[1], r0,
                           kBQ3, T, tid);
    if (tid < kBQ3) {
      const int row = r0 + tid;
      const long long i = ((long long)b * H + h) * T + row;
      sLse[buf * kBQ3 + tid] = row < T ? lse[i] : kEmptyLse;
      sDelta[buf * kBQ3 + tid] = row < T ? delta[i] : 0.f;
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  // k2 = bf16(bf16(rot(k)) * scale * log2e): the TPU kernel's fold into
  // k, which stays resident for the whole q loop. Keys past S are zero.
  stage_rows<D, LD, ROPE>(sK, kb, st.k[1], k0, kBK3, S, cosb, sinb, true,
                          scale_log2, tid);
  stage_rows<D, LD, false>(sV, vb, st.v[1], k0, kBK3, S, nullptr, nullptr,
                           false, 0.f, tid);

  float dk_acc[NT_O][4], dv_acc[NT_O][4];
  zero(dk_acc);
  zero(dv_acc);
  const bf16* wK = sK + warp * 16 * LD;
  const bf16* wV = sV + warp * 16 * LD;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys key0, +8

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = it & 1;
    const int r0 = (qt0 + it % per_head) * kBQ3;
    bf16* tQ = sQ + buf * kBQ3 * LD;
    const bf16* tdO = sdO + buf * kBQ3 * LD;
    const float* tLse = sLse + buf * kBQ3;
    const float* tDelta = sDelta + buf * kBQ3;
    if (ROPE) {
      rope_tile<D, LD, kThreads>(tQ, kBQ3, r0, T, cosb, sinb, tid);
      __syncthreads();
    }

    // S^T = k2 q^T and dP^T = V dO^T: 16 keys x 32 q rows each.
    float s[NT_Q][4], dp[NT_Q][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, wK, kk, lane);
      load_a<LD>(va, wV, kk, lane);
#pragma unroll
      for (int np = 0; np < NT_Q / 2; ++np) {
        uint32_t bq[4], bo[4];
        load_b_nk<LD>(bq, tQ, np, kk, lane);
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        load_b_nk<LD>(bo, tdO, np, kk, lane);
        mma_bf16(dp[2 * np], va, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp2(S^T - lse[q]) (0 where masked); s keeps P^T for dV and
    // dp becomes dS^T = P^T (dP^T - delta[q]).
    const bool masked = causal && r0 + offset < k0 + kBK3 - 1;
#pragma unroll
    for (int i = 0; i < NT_Q; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = i * 8 + 2 * t4 + (e & 1);  // q row within the tile
        float p = exp2f(s[i][e] - tLse[qc]);
        if (masked && r0 + qc + offset < key0 + 8 * (e >> 1)) p = 0.f;
        s[i][e] = p;
        dp[i][e] = p * (dp[i][e] - tDelta[qc]);
      }

    // dV += P^T dO and dK += dS^T q, contracting over the 32 q rows.
#pragma unroll
    for (int kk = 0; kk < kBQ3 / 16; ++kk) {
      uint32_t pa[4], da[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < NT_O / 2; ++dn) {
        uint32_t bo[4], bq[4];
        load_b_kn<LD>(bo, tdO, kk, dn, lane);
        mma_bf16(dv_acc[2 * dn], pa, bo[0], bo[1]);
        mma_bf16(dv_acc[2 * dn + 1], pa, bo[2], bo[3]);
        load_b_kn<LD>(bq, tQ, kk, dn, lane);
        mma_bf16(dk_acc[2 * dn], da, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * dn + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < NT_O; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] *= scale;
  if (ROPE) {
    const int pos[2] = {key0 < S ? key0 : -1, key0 + 8 < S ? key0 + 8 : -1};
    rope_inv_frag<NT_O>(dk_acc, pos, t4, cosb, sinb, D);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
    bf16* krow = dk + b * st.dk[0] + key * st.dk[1] + kvh * st.dk[2];
    bf16* vrow = dv + b * st.dv[0] + key * st.dv[1] + kvh * st.dv[2];
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(krow + i * 8 + 2 * t4) =
          __floats2bfloat162_rn(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + i * 8 + 2 * t4) =
          __floats2bfloat162_rn(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(smem));
}

template <int D, bool ROPE>
cudaError_t launch_dq(const void* const* p, int B, int T, int S, int H,
                      int Hkv, const Strides& st, float scale,
                      float scale_log2, int causal, cudaStream_t stream) {
  const size_t smem = size_t(2 * kBQ2 + 4 * kBK2) * (D + kPad) * sizeof(bf16);
  cudaError_t err = set_smem(flash_bwd_dq_kernel<D, ROPE>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kBQ2 - 1) / kBQ2, H, B);
  flash_bwd_dq_kernel<D, ROPE><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const bf16*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const float*>(p[7]),
      static_cast<bf16*>(const_cast<void*>(p[8])), T, S, H, Hkv, st, scale,
      scale_log2, causal);
  return cudaGetLastError();
}

template <int D, bool ROPE>
cudaError_t launch_dkv(const void* const* p, int B, int T, int S, int H,
                       int Hkv, const Strides& st, float scale,
                       float scale_log2, int causal, cudaStream_t stream) {
  const size_t smem =
      size_t(2 * kBK3 + 4 * kBQ3) * (D + kPad) * sizeof(bf16) +
      4 * kBQ3 * sizeof(float);
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<D, ROPE>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBK3 - 1) / kBK3, Hkv, B);
  flash_bwd_dkv_kernel<D, ROPE><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const bf16*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const float*>(p[7]),
      static_cast<bf16*>(const_cast<void*>(p[8])),
      static_cast<bf16*>(const_cast<void*>(p[9])), T, S, H, Hkv, st, scale,
      scale_log2, causal);
  return cudaGetLastError();
}

Strides make_strides(const long long* s) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];   // dO
    st.dq[i] = s[12 + i];
    st.dk[i] = s[12 + i];
    st.dv[i] = s[15 + i];
  }
  return st;
}

}  // namespace

// ptrs: q, k, v, dO, lse, delta, cos, sin, dq (cos = sin = NULL: no RoPE).
// strides: 18 = the (b, t, h) element strides of q, k, v, dO, dq, then
// three unused.
extern "C" int skypilot_flash_bwd_dq(const void* const* ptrs, int B, int T,
                                     int S, int H, int Hkv, int D,
                                     const long long* strides, float scale,
                                     float scale_log2, int causal,
                                     void* stream) {
  const Strides st = make_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rope = ptrs[6] != nullptr;
  if (D == 64)
    return rope ? launch_dq<64, true>(ptrs, B, T, S, H, Hkv, st, scale,
                                      scale_log2, causal, s)
                : launch_dq<64, false>(ptrs, B, T, S, H, Hkv, st, scale,
                                       scale_log2, causal, s);
  if (D == 128)
    return rope ? launch_dq<128, true>(ptrs, B, T, S, H, Hkv, st, scale,
                                       scale_log2, causal, s)
                : launch_dq<128, false>(ptrs, B, T, S, H, Hkv, st, scale,
                                        scale_log2, causal, s);
  return cudaErrorInvalidValue;
}

// ptrs: q, k, v, dO, lse, delta, cos, sin, dk, dv.
// strides: (b, t/s, h) element strides of q, k, v, dO, dk, dv.
extern "C" int skypilot_flash_bwd_dkv(const void* const* ptrs, int B, int T,
                                      int S, int H, int Hkv, int D,
                                      const long long* strides, float scale,
                                      float scale_log2, int causal,
                                      void* stream) {
  const Strides st = make_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rope = ptrs[6] != nullptr;
  if (D == 64)
    return rope ? launch_dkv<64, true>(ptrs, B, T, S, H, Hkv, st, scale,
                                       scale_log2, causal, s)
                : launch_dkv<64, false>(ptrs, B, T, S, H, Hkv, st, scale,
                                        scale_log2, causal, s);
  if (D == 128)
    return rope ? launch_dkv<128, true>(ptrs, B, T, S, H, Hkv, st, scale,
                                        scale_log2, causal, s)
                : launch_dkv<128, false>(ptrs, B, T, S, H, Hkv, st, scale,
                                         scale_log2, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
