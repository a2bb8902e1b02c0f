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
// tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBQ = 64;       // q rows per block (16 per warp)
constexpr int kBK = 64;       // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 of row padding: conflict-free ldmatrix
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
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
  // TPU kernel does). Rows past T are zero and never stored.
  for (int c = tid; c < kBQ * CPR; c += kThreads) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < T)
      raw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_st + col);
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(p2[e]);
      p2[e] = __floats2bfloat162_rn(f.x * scale_log2, f.y * scale_log2);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = raw;
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
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(q_frag[kk], sQ + (warp * 16 + (lane & 15)) * LD +
                                    kk * 16 + (lane >> 4) * 8);
    }
    const bf16* tK = sK + (kt & 1) * kBK * LD;
    const bf16* tV = sV + (kt & 1) * kBK * LD;

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
        ldmatrix_x4(bk, tK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
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
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < NT_O / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tV + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int T, int S, int H, int Hkv,
                   const long long* st, float scale_log2, int causal,
                   cudaStream_t stream) {
  const size_t smem = size_t(kBQ + 4 * kBK) * (D + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), T, S, H, Hkv, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2,
      causal);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, out, lse, B, T, S, H, Hkv, st, scale_log2,
                      causal, s);
  if (D == 128)
    return launch<128>(q, k, v, out, lse, B, T, S, H, Hkv, st, scale_log2,
                       causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
