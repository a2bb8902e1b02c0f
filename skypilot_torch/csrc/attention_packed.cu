// K6-cuda: the head-paired flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel skypilot_tpu/ops/attention_packed.py:38
// _packed_fwd_kernel (entry packed_flash_attention_fwd :125, pallas_call
// :160). Contract, as the port's wrapper (ops/attention_packed.py) holds
// it:
//   q [B,H,T,D] bf16 with H even, k/v [B,Hkv,S,D] bf16 (read through
//   strides), out [B,H,T,D] bf16 and lse f32 [B,H,T] in the log2 domain
//   (the TPU's 8-sublane lse axis is not carried over); causal masking is
//   bottom-right aligned (q_pos + S - T >= k_pos) or off; no RoPE. Head h
//   reads KV head h / (H/Hkv). The wrapper refuses what the reference
//   computes wrongly (odd GQA groups above 1, causal T > S, T or S not a
//   multiple of the reference's block), so every row sees at least one
//   key; the kernel itself still masks a ragged last tile of its own.
//
// The TPU kernel packs two heads into a block-diagonal [2Bq, 2D] query so
// each dot fills the 128-wide MXU contraction at head_dim 64. On Hopper a
// wgmma is full at D = 64 and the zero blocks would double the tensor-core
// work, so the packing is not carried over. What is kept is the pairing:
// one block serves both heads of a pair.
//
// What bounds it on the H100: at T = S = 2048 the two products per tile
// make it compute-bound, as K1. Design: K1's sm_90a mainloop
// (flash_fwd_sm90.cuh) with its two consumer warpgroups mapped to the two
// heads of a pair, 64 q rows each: grid (ceil(T / 64), H / 2, B). When the
// pair shares its KV head (GQA groups even) each K/V tile is loaded by TMA
// once and feeds both heads' products, which halves the K/V traffic per
// head against K1; when groups == 1 a stage holds the two heads' own
// tiles side by side (64-key tiles at D 128, so three stages still fit).

#include "flash_fwd_sm90.cuh"

namespace {

using flash_sm90::bf16;

// NKV: kv heads staged per block, 1 when the pair shares its KV head, 2
// when each head has its own (groups == 1).
template <int D, int NKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int T, int S, int H, int Hkv,
                   const long long* st, float scale_log2, int causal,
                   cudaStream_t stream) {
  // (keys per tile, stages): 225 KB of shared memory at D 128, 144 KB
  // (one kv head) or 208 KB (two) at D 64.
  constexpr int BK = (D == 128 && NKV == 2) ? 64 : 128;
  constexpr int STAGES = (D == 64 && NKV == 1) ? 4 : 3;
  // st: q (sb, sh, st), k (sb, sh, ss), v (sb, sh, ss), out (sb, sh, st).
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = sm90::make_map(&qm, q, D, T, H, B, st[2], st[1], st[0],
                            flash_sm90::kConsumerRows)) != cudaSuccess ||
      (err = sm90::make_map(&km, k, D, S, Hkv, B, st[5], st[4], st[3],
                            BK)) != cudaSuccess ||
      (err = sm90::make_map(&vm, v, D, S, Hkv, B, st[8], st[7], st[6],
                            BK)) != cudaSuccess)
    return err;
  flash_sm90::FwdParams p{};
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_st = st[11];
  p.T = T;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  const dim3 grid((T + flash_sm90::kConsumerRows - 1) /
                      flash_sm90::kConsumerRows,
                  H / 2, B);
  return flash_sm90::launch_fwd<D, BK, STAGES, NKV, true>(qm, km, vm, p,
                                                          grid, stream);
}

}  // namespace

extern "C" int skypilot_packed_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int T, int S, int H, int Hkv, int D, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_st, float scale_log2, int causal,
    void* stream) {
  if (T < 1 || S < 1 || H % 2 != 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int groups = H / Hkv;
  if (groups % 2 != 0 && groups != 1) return cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool shared = groups % 2 == 0;
  if (D == 64)
    return shared ? launch<64, 1>(q, k, v, out, lse, B, T, S, H, Hkv, st,
                                  scale_log2, causal, s)
                  : launch<64, 2>(q, k, v, out, lse, B, T, S, H, Hkv, st,
                                  scale_log2, causal, s);
  if (D == 128)
    return shared ? launch<128, 1>(q, k, v, out, lse, B, T, S, H, Hkv, st,
                                   scale_log2, causal, s)
                  : launch<128, 2>(q, k, v, out, lse, B, T, S, H, Hkv, st,
                                   scale_log2, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
