// K1-cuda: flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel skypilot_tpu/ops/attention.py:170 _fwd_kernel
// (built by _fwd_pallas :444, pallas_call :472). Same contract:
//   q [B,T,H,D], k/v [B,S,Hkv,D] bf16 (read through strides, so the
//   model's [B,T,H,D] layout needs no transpose copy), out in q's layout
//   and dtype, lse f32 [B,H,T] in the log2 domain (no TPU sublane pad);
//   native GQA (head h reads KV head h / (H/Hkv), K/V never repeated);
//   bottom-right causal alignment q_pos + S - T >= k_pos; a row that sees
//   no key (T > S) gets out = 0 and lse = +1e30.
// Unlike the TPU kernel it takes any T and S: the ragged edge of the last
// q tile and the last key tile is masked in the kernel. D is 64 or 128.
//
// What bounds it on the H100: at prefill lengths (T = S >= 1k) the two
// products per tile make it compute-bound (4 D FLOPs per visible (q, k)
// pair). The design is the shared sm_90a mainloop (flash_fwd_sm90.cuh):
// TMA loads issued by a producer warpgroup into a ring of 128-key K/V
// tiles, two consumer warpgroups of 64 q rows each running both products
// on wgmma, so one block covers 128 q rows of one (head, batch row); grid
// (ceil(T / 128), H, B), heaviest causal tiles first.
//
// Fused RoPE (skypilot_flash_fwd_rope, the TPU kernel's fuse_rope): q and
// k arrive UN-rotated with f32 [T, D] cos/sin tables (T == S). A pre-pass
// kernel rotates every q and k row once (flash_common.cuh's rope_item, f32
// math rounded to bf16, the TPU kernel's _rot; the backward's pre-pass runs
// the same code): q into `out` (each block of the mainloop reads
// its own q rows from there before it overwrites the same rows with its
// result) and k into `krot`, a [B,S,Hkv,D] scratch the wrapper allocates.
// The mainloop then reads the rotated tensors by TMA with no rotation of
// its own, so a K row is rotated once, not once for every (q tile, head)
// block that reads it. The entry without tables (skypilot_flash_fwd) is
// the serving path's and runs no rotation.

#include "flash_fwd_sm90.cuh"  // and flash_common.cuh: the RoPE pre-pass

namespace {

using flash_sm90::bf16;

constexpr int kBK = 128;  // keys per K/V tile
constexpr int kRopeThreads = 256;

template <int D>
__global__ void __launch_bounds__(kRopeThreads)
    rope_prepass(const flash::RopeArgs a) {
  const long long n = flash::rope_items<D>(a);
  for (long long i = blockIdx.x * (long long)kRopeThreads + threadIdx.x;
       i < n; i += (long long)gridDim.x * kRopeThreads)
    flash::rope_item<D>(a, i);
}

// The mainloop over q [B,T,H,D] and k/v [B,S,Hkv,D] views with the given
// element strides (batch, position, head).
template <int D>
cudaError_t attend(const void* q, const long long* qs, const void* k,
                   const long long* ks, const void* v, const long long* vs,
                   void* out, const long long* os, void* lse, int B, int T,
                   int S, int H, int Hkv, float scale_log2, int causal,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = sm90::make_map(&qm, q, D, T, H, B, qs[1], qs[2], qs[0],
                            flash_sm90::kConsumerRows)) != cudaSuccess ||
      (err = sm90::make_map(&km, k, D, S, Hkv, B, ks[1], ks[2], ks[0],
                            kBK)) != cudaSuccess ||
      (err = sm90::make_map(&vm, v, D, S, Hkv, B, vs[1], vs[2], vs[0],
                            kBK)) != cudaSuccess)
    return err;
  flash_sm90::FwdParams p{};
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_sb = os[0];
  p.o_st = os[1];
  p.o_sh = os[2];
  p.T = T;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  const dim3 grid((T + 2 * flash_sm90::kConsumerRows - 1) /
                      (2 * flash_sm90::kConsumerRows),
                  H, B);
  // D 64 tiles are half as large: four stages fit where D 128 takes
  // three (225 KB of shared memory).
  constexpr int STAGES = D == 64 ? 4 : 3;
  return flash_sm90::launch_fwd<D, kBK, STAGES, 1, false>(qm, km, vm, p,
                                                          grid, stream);
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* cosb, const void* sinb, void* krot, void* out,
                void* lse, int B, int T, int S, int H, int Hkv,
                const long long* st, float scale_log2, int causal,
                cudaStream_t stream) {
  const long long* qs = st;
  const long long* ks = st + 3;
  const long long* vs = st + 6;
  const long long* os = st + 9;
  if (cosb == nullptr)
    return attend<D>(q, qs, k, ks, v, vs, out, os, lse, B, T, S, H, Hkv,
                     scale_log2, causal, stream);
  const flash::RopeArgs ra{static_cast<const bf16*>(q),
                           static_cast<const bf16*>(k),
                           static_cast<const float*>(cosb),
                           static_cast<const float*>(sinb),
                           static_cast<bf16*>(out), static_cast<bf16*>(krot),
                           B, T, H, Hkv, qs[0], qs[1], qs[2], ks[0], ks[1],
                           ks[2], os[0], os[1], os[2]};
  const long long want =
      (flash::rope_items<D>(ra) + kRopeThreads - 1) / kRopeThreads;
  const int blocks = int(want < 65535 ? want : 65535);  // grid-stride
  rope_prepass<D><<<blocks, kRopeThreads, 0, stream>>>(ra);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long krs[3] = {(long long)S * Hkv * D, (long long)Hkv * D, D};
  return attend<D>(out, os, krot, krs, v, vs, out, os, lse, B, T, S, H, Hkv,
                   scale_log2, causal, stream);
}

int dispatch(const void* q, const void* k, const void* v, const void* cosb,
             const void* sinb, void* krot, void* out, void* lse, int B,
             int T, int S, int H, int Hkv, int D, const long long* st,
             float scale_log2, int causal, void* stream) {
  if (T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return run<64>(q, k, v, cosb, sinb, krot, out, lse, B, T, S, H, Hkv, st,
                   scale_log2, causal, s);
  if (D == 128)
    return run<128>(q, k, v, cosb, sinb, krot, out, lse, B, T, S, H, Hkv,
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
  return dispatch(q, k, v, nullptr, nullptr, nullptr, out, lse, B, T, S, H,
                  Hkv, D, st, scale_log2, causal, stream);
}

// The same with fused RoPE: cos/sin are f32 [T, D] row-major, T == S;
// krot is a contiguous [B,S,Hkv,D] bf16 scratch for the rotated k.
extern "C" int skypilot_flash_fwd_rope(
    const void* q, const void* k, const void* v, const void* cosb,
    const void* sinb, void* krot, void* out, void* lse, int B, int T, int S,
    int H, int Hkv, int D, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, float scale_log2, int causal, void* stream) {
  if (T != S || cosb == nullptr || sinb == nullptr || krot == nullptr)
    return cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_st, o_sh};
  return dispatch(q, k, v, cosb, sinb, krot, out, lse, B, T, S, H, Hkv, D,
                  st, scale_log2, causal, stream);
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
