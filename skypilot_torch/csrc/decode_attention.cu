// K4-cuda: single-position decode attention over each row's valid cache
// prefix, for Hopper (sm_90a).
//
// Replaces the TPU kernel skypilot_tpu/ops/decode_attention.py:
// _decode_attn_kernel (launched by _decode_attention_pallas). Same
// contract: q [B,Hq,hd], one layer's dense cache k/v [B,S,Hkv,hd], lengths
// [B] int32 on the device; row b attends keys [0, max(lengths[b], 1)) and
// the output is [B,Hq,hd] in q's dtype. The TPU kernel's block-diagonal q
// over a flattened [S, Hkv*hd] cache exists only for TPU lane alignment
// and is not carried over.
//
// What bounds it on the H100: memory. Each visible key is 2*Hkv*hd bf16
// bytes of K and V used for G = Hq/Hkv dot products and G axpys, far
// below the card's ~295 FLOP/byte balance point, and at batch 1 there is
// too little work per row to fill 132 SMs with one block per head.
// Design (split-K flash-decoding): grid (split, kv head, batch row); each
// block owns one chunk of kChunk keys and loads every K/V row of it once
// for all G query heads of its group. Blocks whose chunk starts at or past
// lengths[b] exit at once, so bytes read scale with the actual length, not
// with S, and the splits put enough blocks in flight at batch 1. Inside a
// block, hd/8 lanes share one key (16-byte loads, 8 dims per lane), and
// each lane group keeps an online softmax in the exp2 domain (f32). The
// block merges its lane groups through shared memory and writes (m, l,
// acc) partials to f32 scratch that the wrapper allocates; a second kernel
// merges the valid splits of each (row, head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // key steps whose loads are issued together

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 x = __bfloat1622float2(h2[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}

template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int S, int Hkv,
                        int n_split, int chunk, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, float scale_log2) {
  constexpr int LPK = HD / 8;         // lanes per key
  constexpr int KPW = 32 / LPK;       // keys per warp step
  constexpr int NGROUPS = kWarps * KPW;
  __shared__ float sm_m[NGROUPS][G];
  __shared__ float sm_l[NGROUPS][G];
  __shared__ __align__(16) float sm_acc[NGROUPS][G][HD];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 1), S);
  const int start = split * chunk;
  if (start >= len) return;  // the merge reads only the valid splits
  const int end = min(start + chunk, len);
  const int Hq = Hkv * G;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPK;  // key slot within the warp step
  const int dl = lane % LPK;   // this lane's 8 dims: [8*dl, 8*dl + 8)
  const int group = warp * KPW + sub;

  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + ((long long)b * Hq + kvh * G + g) * HD + dl * 8, qr[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[g][e] *= scale_log2;
  }
  float m_run[G], l_run[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const bf16* kb = k + b * k_sb + kvh * HD + dl * 8;
  const bf16* vb = v + b * v_sb + kvh * HD + dl * 8;
  // Trip counts are uniform across the warp (the shuffles below need
  // every lane); keys past `end` are masked, not skipped.
  for (int base = start + warp * KPW; base < end;
       base += NGROUPS * kUnroll) {
    float kf[kUnroll][8], vf[kUnroll][8];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + u * NGROUPS + sub;
      ok[u] = key < end;
      if (ok[u]) {
        load8(kb + key * k_ss, kf[u]);
        load8(vb + key * v_ss, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kUnroll];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[g][e], kf[u][e], d);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffff, d, off);
        s[u] = ok[u] ? d : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m_run[g], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[g] - m_use);
      l_run[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = exp2f(s[u] - m_use);
        l_run[g] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
      }
      m_run[g] = m_new;
    }
  }

  // Merge the block's lane groups.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (dl == 0) {
      sm_m[group][g] = m_run[g];
      sm_l[group][g] = l_run[g];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sm_acc[group][g][dl * 8 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < NGROUPS; ++i) M = fmaxf(M, sm_m[i][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int i = 0; i < NGROUPS; ++i) {
      const float w = exp2f(sm_m[i][g] - M);  // empty groups: exp2(-inf) = 0
      L += w * sm_l[i][g];
      A += w * sm_acc[i][g][d];
    }
    const long long row = ((long long)b * Hq + kvh * G + g) * n_split + split;
    part_acc[row * HD + d] = A;
    if (d == 0) {
      part_m[row] = M;
      part_l[row] = L;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(HD)
    decode_merge_kernel(const float* __restrict__ part_m,
                        const float* __restrict__ part_l,
                        const float* __restrict__ part_acc,
                        const int* __restrict__ lengths, bf16* __restrict__ out,
                        int S, int Hq, int n_split, int chunk) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(max(lengths[b], 1), S);
  const int n = (len + chunk - 1) / chunk;
  const long long row0 = ((long long)b * Hq + h) * n_split;
  float M = -INFINITY;
  for (int i = 0; i < n; ++i) M = fmaxf(M, part_m[row0 + i]);
  float L = 0.f, A = 0.f;
  for (int i = 0; i < n; ++i) {
    const float w = exp2f(part_m[row0 + i] - M);
    L += w * part_l[row0 + i];
    A += w * part_acc[(row0 + i) * HD + d];
  }
  out[((long long)b * Hq + h) * HD + d] = __float2bfloat16(A / L);
}

template <int HD, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, void* pm, void* pl,
                   void* pacc, int B, int S, int Hkv, long long k_sb,
                   long long k_ss, long long v_sb, long long v_ss, int chunk,
                   float scale_log2, cudaStream_t stream) {
  const int n_split = (S + chunk - 1) / chunk;
  decode_split_kernel<HD, G><<<dim3(n_split, Hkv, B), kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<float*>(pacc), S, Hkv, n_split, chunk, k_sb, k_ss, v_sb,
      v_ss, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<HD><<<dim3(Hkv * G, B), HD, 0, stream>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(pacc), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), S, Hkv * G, n_split, chunk);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const void* lengths, void* out, void* pm, void* pl,
                       void* pacc, int B, int S, int Hkv, long long k_sb,
                       long long k_ss, long long v_sb, long long v_ss,
                       int chunk, float scale_log2, cudaStream_t s) {
  switch (G) {
    case 1:
      return launch<HD, 1>(q, k, v, lengths, out, pm, pl, pacc, B, S, Hkv,
                           k_sb, k_ss, v_sb, v_ss, chunk, scale_log2, s);
    case 2:
      return launch<HD, 2>(q, k, v, lengths, out, pm, pl, pacc, B, S, Hkv,
                           k_sb, k_ss, v_sb, v_ss, chunk, scale_log2, s);
    case 4:
      return launch<HD, 4>(q, k, v, lengths, out, pm, pl, pacc, B, S, Hkv,
                           k_sb, k_ss, v_sb, v_ss, chunk, scale_log2, s);
    case 8:
      return launch<HD, 8>(q, k, v, lengths, out, pm, pl, pacc, B, S, Hkv,
                           k_sb, k_ss, v_sb, v_ss, chunk, scale_log2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int skypilot_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_m, void* part_l, void* part_acc, int B, int S,
    int Hq, int Hkv, int HD, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, int chunk, float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  if (HD == 64)
    return dispatch_g<64>(G, q, k, v, lengths, out, part_m, part_l, part_acc,
                          B, S, Hkv, k_sb, k_ss, v_sb, v_ss, chunk,
                          scale_log2, s);
  if (HD == 128)
    return dispatch_g<128>(G, q, k, v, lengths, out, part_m, part_l,
                           part_acc, B, S, Hkv, k_sb, k_ss, v_sb, v_ss,
                           chunk, scale_log2, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
