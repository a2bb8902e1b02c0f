// K6-cuda: the head-paired flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel skypilot_tpu/ops/attention_packed.py:
// _packed_fwd_kernel (launched by packed_flash_attention_fwd). Contract,
// as the port's wrapper (ops/attention_packed.py) holds it:
//   q [B,H,T,D] bf16 with H even, k/v [B,Hkv,S,D] bf16 (read through
//   strides), out [B,H,T,D] bf16 and lse f32 [B,H,T] in the log2 domain
//   (the TPU's 8-sublane lse axis is not carried over); causal masking is
//   bottom-right aligned (q_pos + S - T >= k_pos) or off; no RoPE. Head h
//   reads KV head h / (H/Hkv). The wrapper refuses what the reference
//   computes wrongly (odd GQA groups above 1, causal T > S, T or S not a
//   multiple of its block), so every row sees at least one key; the kernel
//   itself still masks a ragged last tile.
//
// The TPU kernel packs two heads into a block-diagonal [2Bq, 2D] query so
// each dot fills the 128-wide MXU contraction at head_dim 64. On Hopper
// mma.sync m16n8k16 is already full at D = 64 and the zero blocks would
// double the tensor-core work, so the packing is not carried over. What is
// kept is the pairing itself: one block serves both heads of a pair.
//
// What bounds it on the H100: at T = S = 2048 the two matmuls per tile make
// it compute-bound, as K1. Design: one block of 8 warps per (q tile of 64
// rows, head pair, batch row); warps 0-3 take the pair's first head, 4-7
// its second, 16 q rows each. When the pair shares its KV head (GQA groups
// even) each K/V tile is copied into shared memory once and both heads'
// warps read it, which halves the K/V fill traffic per head against K1;
// when groups == 1 the block stages the two heads' own tiles side by side.
// K/V tiles of 64 keys stream through shared memory with cp.async, double
// buffered; the math per warp is K1's (flash_fwd.cu): scale*log2(e) folded
// into q as it is staged (rounded to bf16, as the TPU kernel rounds it),
// both products on mma.sync bf16 -> f32, the probabilities kept in
// registers, an online softmax in exp2 with f32 statistics, causal tiles
// that straddle the diagonal masked and hidden ones never loaded. Not yet
// done (later work): wgmma/TMA and larger tiles.

#include <math.h>

#include "mma_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;        // q rows per head per block (16 per warp)
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 256;  // 8 warps: 4 per head of the pair

struct PackedArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;
  int T, S, H, Hkv;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_st;
  float scale_log2;
  int causal;
};

// NKV: K/V tiles staged per block, 1 when the pair shares its KV head,
// 2 when each head has its own (groups == 1).
template <int D, int NKV>
__global__ void __launch_bounds__(kThreads)
    packed_fwd_kernel(const PackedArgs a) {
  constexpr int LD = D + kPad;
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  constexpr int NT_S = kBK / 8;  // n-tiles of the score block
  constexpr int NT_O = D / 8;    // n-tiles of the output block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [2][kBQ][LD]
  bf16* sK = sQ + 2 * kBQ * LD;                  // [2 buf][NKV][kBK][LD]
  bf16* sV = sK + 2 * NKV * kBK * LD;            // [2 buf][NKV][kBK][LD]

  const int q0 = blockIdx.x * kBQ;
  const int hp = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = a.H / a.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hw = warp >> 2;   // which head of the pair this warp serves
  const int wq = warp & 3;    // the warp's 16-row slice of the q tile
  const int h = 2 * hp + hw;
  const int offset = a.S - a.T;

  // Tiles [0, n_full) are visible to every row of the tile; [n_full, n_kt)
  // are masked; tiles from n_kt on are hidden (causal) or past S.
  int n_kt = (a.S + kBK - 1) / kBK;
  int n_full = a.S / kBK;
  if (a.causal) {
    const int last_key = min(q0 + kBQ, a.T) - 1 + offset;
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / kBK + 1);
    const int first_row_keys = q0 + offset + 1;
    n_full = min(n_full, first_row_keys > 0 ? first_row_keys / kBK : 0);
  }
  n_full = min(n_full, n_kt);

  auto load_kv = [&](int kt, int buf) {
    for (int c = tid; c < NKV * kBK * CPR; c += kThreads) {
      const int j = c / (kBK * CPR);  // which staged KV head
      const int rc = c % (kBK * CPR);
      const int r = rc / CPR, col = (rc % CPR) * 8;
      const int kvh = (2 * hp + j) / groups;
      const bf16* kb = a.k + b * a.k_sb + kvh * a.k_sh;
      const bf16* vb = a.v + b * a.v_sb + kvh * a.v_sh;
      bf16* dk = sK + ((buf * NKV + j) * kBK + r) * LD + col;
      bf16* dv = sV + ((buf * NKV + j) * kBK + r) * LD + col;
      const int key = kt * kBK + r;
      const bool ok = key < a.S;
      cp_async16(dk, ok ? kb + key * a.k_ss + col : kb, ok);
      cp_async16(dv, ok ? vb + key * a.v_ss + col : vb, ok);
    }
  };

  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();

  // Stage both heads' q rows, scale*log2(e) folded in and rounded to bf16
  // (the TPU kernel's fold). Rows past T are zero and never stored.
  for (int c = tid; c < 2 * kBQ * CPR; c += kThreads) {
    const int j = c / (kBQ * CPR);
    const int rc = c % (kBQ * CPR);
    const int r = rc / CPR, col = (rc % CPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < a.T)
      raw = *reinterpret_cast<const uint4*>(
          a.q + b * a.q_sb + (2 * hp + j) * a.q_sh + (q0 + r) * a.q_st + col);
    scale8(raw, a.scale_log2);
    *reinterpret_cast<uint4*>(sQ + (j * kBQ + r) * LD + col) = raw;
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
  const int row0 = q0 + wq * 16 + g;  // rows row0 and row0 + 8
  const int kv_slot = NKV == 1 ? 0 : hw;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tK = sK + ((kt & 1) * NKV + kv_slot) * kBK * LD;
    const bf16* tV = sV + ((kt & 1) * NKV + kv_slot) * kBK * LD;
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a<LD>(q_frag[kk], sQ + (hw * kBQ + wq * 16) * LD, kk, lane);
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
          const bool ok = key < a.S && (!a.causal || key <= row + offset);
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
    if (row >= a.T) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = a.out + b * a.o_sb + h * a.o_sh + row * a.o_st;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + 2 * t4) =
          __floats2bfloat162_rn(o_acc[i][2 * r] * inv,
                                o_acc[i][2 * r + 1] * inv);
    }
    if (t4 == 0)
      a.lse[((long long)b * a.H + h) * a.T + row] =
          l > 0.f ? m_run[r] + log2f(l) : kEmptyLse;
  }
}

template <int D, int NKV>
cudaError_t launch(const PackedArgs& a, int B, cudaStream_t stream) {
  const size_t smem =
      size_t(2 * kBQ + 4 * NKV * kBK) * (D + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      packed_fwd_kernel<D, NKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + kBQ - 1) / kBQ, a.H / 2, B);
  packed_fwd_kernel<D, NKV><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int skypilot_packed_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int T, int S, int H, int Hkv, int D, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_st, float scale_log2, int causal,
    void* stream) {
  if (H % 2 != 0 || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int groups = H / Hkv;
  if (groups % 2 != 0 && groups != 1) return cudaErrorInvalidValue;
  PackedArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.q_st = q_st;
  a.k_sb = k_sb;
  a.k_sh = k_sh;
  a.k_ss = k_ss;
  a.v_sb = v_sb;
  a.v_sh = v_sh;
  a.v_ss = v_ss;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.o_st = o_st;
  a.scale_log2 = scale_log2;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool shared = groups % 2 == 0;
  if (D == 64) return shared ? launch<64, 1>(a, B, s) : launch<64, 2>(a, B, s);
  if (D == 128)
    return shared ? launch<128, 1>(a, B, s) : launch<128, 2>(a, B, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
