// K1-cuda: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel skypilot_tpu/ops/attention.py:_fwd_kernel
// (launched by _fwd_pallas). Same contract:
//   q [B,T,H,D], k/v [B,S,Hkv,D] bf16 (read through strides, so the
//   model's [B,T,H,D] layout needs no transpose copy), out in q's layout
//   and dtype, lse f32 [B,H,T] in the log2 domain (no TPU sublane pad);
//   native GQA (head h reads KV head h / (H/Hkv), K/V never repeated);
//   bottom-right causal alignment q_pos + S - T >= k_pos; a row that sees
//   no key (T > S) gets out = 0 and lse = +1e30.
// Unlike the TPU kernel it takes any T and S: the ragged edge of the last
// q tile and the last K/V tile is masked in the kernel.
//
// Fused RoPE (skypilot_flash_fwd_rope, the TPU kernel's fuse_rope): q and
// k arrive UN-rotated with f32 [T, D] cos/sin tables (T == S); q rows are
// rotated as they are staged and each K tile in shared memory right after
// its copy lands, in f32, rounded to bf16 before the dot (_rot), then q is
// scaled as below. The entry without tables (skypilot_flash_fwd) is the
// serving path's and runs no rotation code.
//
// What bounds it on the H100: at prefill lengths (T = S >= 1k) the two
// matmuls per tile make it compute-bound (4*D FLOPs per visible q/k pair
// against ~2*D bytes per key row reused by the 64 rows of a q tile).
// Design: one block of 4 warps per (q tile of 64 rows, head, batch row);
// each warp owns 16 q rows. K/V tiles of 64 keys stream through shared
// memory with cp.async, double-buffered so the next tile's copy overlaps
// this tile's math. Both matmuls run on the tensor cores as mma.sync
// m16n8k16 bf16 -> f32; the probabilities stay in registers between the
// two (the S accumulator fragment is re-packed as the A operand of P.V).
// scale*log2(e) is folded into q once as it is staged, so the softmax
// runs in exp2 with f32 statistics and accumulators. Causal structure:
// tiles fully visible to every row of the q tile run without a mask,
// tiles that straddle the diagonal (or the ragged end of S) are masked,
// and hidden tiles are never loaded. Shared memory (87 KB at D = 128) is
// dynamic, above the 48 KB static limit, set with cudaFuncSetAttribute.
// Not yet done (later work): wgmma/TMA, warp specialisation, 128-row
// tiles; with RoPE, every (q tile, head) block re-rotates the K tiles it
// reads (K is rotated once per use, not once per kv head).

#include <math.h>

#include "mma_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;       // q rows per block (16 per warp)
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 128;

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ cosb,
                     const float* __restrict__ sinb, bf16* __restrict__ out,
                     float* __restrict__ lse, int T, int S, int H, int Hkv,
                     long long q_sb, long long q_st, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_st, long long o_sh,
                     float scale_log2, int causal) {
  constexpr int LD = D + kPad;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int NT_S = kBK / 8;  // n-tiles of the score block
  constexpr int NT_O = D / 8;    // n-tiles of the output block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * LD;      // [2][kBK][LD]
  bf16* sV = sK + 2 * kBK * LD;  // [2][kBK][LD]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int offset = S - T;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  // Tiles [0, n_full) are visible to every row; [n_full, n_kt) are
  // masked; tiles from n_kt on are hidden (causal) or past S.
  int n_kt = (S + kBK - 1) / kBK;
  int n_full = S / kBK;
  if (causal) {
    const int last_key = min(q0 + kBQ, T) - 1 + offset;
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / kBK + 1);
    const int first_row_keys = q0 + offset + 1;  // keys row q0 sees
    n_full = min(n_full, first_row_keys > 0 ? first_row_keys / kBK : 0);
  }
  n_full = min(n_full, n_kt);

  auto load_kv = [&](int kt, int buf) {
    bf16* dk = sK + buf * kBK * LD;
    bf16* dv = sV + buf * kBK * LD;
    for (int c = tid; c < kBK * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const int key = kt * kBK + r;
      const bool ok = key < S;
      cp_async16(dk + r * LD + col, ok ? kb + key * k_ss + col : kb, ok);
      cp_async16(dv + r * LD + col, ok ? vb + key * v_ss + col : vb, ok);
    }
  };

  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();

  // Stage q, folding scale*log2(e) in once (rounded back to bf16, as the
  // TPU kernel does). Rows past T are zero and never stored. With RoPE a
  // thread takes a column pair (c, c + D/2) and rotates it first.
  if (ROPE) {
    for (int c = tid; c < kBQ * (CPR / 2); c += kThreads) {
      const int r = c / (CPR / 2), col = (c % (CPR / 2)) * 8;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (q0 + r < T) {
        const bf16* row = qb + (q0 + r) * q_st;
        lo = *reinterpret_cast<const uint4*>(row + col);
        hi = *reinterpret_cast<const uint4*>(row + col + D / 2);
        rope8(lo, hi, cosb + (long long)(q0 + r) * D + col,
              sinb + (long long)(q0 + r) * D + col);
      }
      scale8(lo, scale_log2);
      scale8(hi, scale_log2);
      *reinterpret_cast<uint4*>(sQ + r * LD + col) = lo;
      *reinterpret_cast<uint4*>(sQ + r * LD + col + D / 2) = hi;
    }
  } else {
    for (int c = tid; c < kBQ * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (q0 + r < T)
        raw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_st + col);
      scale8(raw, scale_log2);
      *reinterpret_cast<uint4*>(sQ + r * LD + col) = raw;
    }
  }

  float o_acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums
  uint32_t q_frag[D / 16][4];

  const int g = lane >> 2;  // row within the 8-row half of the fragment
  const int t4 = lane & 3;  // column pair within the fragment
  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    bf16* tK = sK + (kt & 1) * kBK * LD;
    const bf16* tV = sV + (kt & 1) * kBK * LD;
    if (ROPE) {
      rope_tile<D, LD, kThreads>(tK, kBK, kt * kBK, S, cosb, sinb, tid);
      __syncthreads();
    }
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a<LD>(q_frag[kk], sQ + warp * 16 * LD, kk, lane);
    }

    // S = (q * scale * log2e) K^T for this warp's 16 rows x 64 keys.
    float s[NT_S][4];
#pragma unroll
    for (int i = 0; i < NT_S; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t bk[4];
        load_b_nk<LD>(bk, tK, np, kk, lane);
        mma_bf16(s[2 * np], q_frag[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], q_frag[kk], bk[2], bk[3]);
      }
    }

    if (kt >= n_full) {
#pragma unroll
      for (int i = 0; i < NT_S; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt * kBK + i * 8 + 2 * t4 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool ok = key < S && (!causal || key <= row + offset);
          if (!ok) s[i][e] = -INFINITY;
        }
    }

    // Online softmax in the log2 domain; rows r = 0 (row0), 1 (row0 + 8).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NT_S; ++i)
        mx = fmaxf(mx, fmaxf(s[i][2 * r], s[i][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      // A row that has seen no key yet keeps m = -inf; subtract 0 then
      // so exp2(-inf - m) is 0, never NaN.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NT_S; ++i) {
        s[i][2 * r] = exp2f(s[i][2 * r] - m_use);
        s[i][2 * r + 1] = exp2f(s[i][2 * r + 1] - m_use);
        sum += s[i][2 * r] + s[i][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < NT_O; ++i) {
        o_acc[i][2 * r] *= alpha;
        o_acc[i][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the score fragments re-packed as bf16 A operands.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < NT_O / 2; ++dp) {
        uint32_t bv[4];
        load_b_kn<LD>(bv, tV, kk, dp, lane);
        mma_bf16(o_acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o_acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    const int row = row0 + r * 8;
    if (row >= T) continue;
    // l == 0 exactly when the row saw no key (its own max contributes
    // exp2(0) = 1 otherwise).
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = out + b * o_sb + row * o_st + h * o_sh;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + 2 * t4) =
          __floats2bfloat162_rn(o_acc[i][2 * r] * inv,
                                o_acc[i][2 * r + 1] * inv);
    }
    if (t4 == 0)
      lse[((long long)b * H + h) * T + row] =
          l > 0.f ? m_run[r] + log2f(l) : kEmptyLse;
  }
}

template <int D, bool ROPE>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* cosb, const void* sinb, void* out, void* lse,
                   int B, int T, int S, int H, int Hkv, const long long* st,
                   float scale_log2, int causal, cudaStream_t stream) {
  const size_t smem = size_t(kBQ + 4 * kBK) * (D + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, ROPE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D, ROPE><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<bf16*>(out),
      static_cast<float*>(lse), T, S, H, Hkv, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2,
      causal);
  return cudaGetLastError();
}

template <bool ROPE>
int dispatch(const void* q, const void* k, const void* v, const void* cosb,
             const void* sinb, void* out, void* lse, int B, int T, int S,
             int H, int Hkv, int D, const long long* st, float scale_log2,
             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, ROPE>(q, k, v, cosb, sinb, out, lse, B, T, S, H, Hkv,
                            st, scale_log2, causal, s);
  if (D == 128)
    return launch<128, ROPE>(q, k, v, cosb, sinb, out, lse, B, T, S, H, Hkv,
                             st, scale_log2, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int skypilot_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int T, int S, int H, int Hkv, int D, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale_log2,
    int causal, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_st, o_sh};
  return dispatch<false>(q, k, v, nullptr, nullptr, out, lse, B, T, S, H,
                         Hkv, D, st, scale_log2, causal, stream);
}

// The same with fused RoPE: cos/sin are f32 [T, D] row-major, T == S.
extern "C" int skypilot_flash_fwd_rope(
    const void* q, const void* k, const void* v, const void* cosb,
    const void* sinb, void* out, void* lse, int B, int T, int S, int H,
    int Hkv, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, float scale_log2, int causal, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_st, o_sh};
  return dispatch<true>(q, k, v, cosb, sinb, out, lse, B, T, S, H, Hkv, D,
                        st, scale_log2, causal, stream);
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
