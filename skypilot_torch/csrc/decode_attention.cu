// Decode-side kernels for Hopper (sm_90a): K4-cuda (decode attention,
// dense and paged/verify) and K5-cuda (the per-row KV-cache write).
//
// K4 replaces the TPU kernel skypilot_tpu/ops/decode_attention.py:
// _decode_attn_kernel (launched by _decode_attention_pallas). Same
// contract: q [B,Hq,hd], one layer's dense cache k/v [B,S,Hkv,hd], lengths
// [B] int32 on the device; row b attends keys [0, max(lengths[b], 1)) and
// the output is [B,Hq,hd] in q's dtype. The TPU kernel's block-diagonal q
// over a flattened [S, Hkv*hd] cache exists only for TPU lane alignment
// and is not carried over.
//
// K4-paged is the same kernel reading the block table directly, which the
// JAX package does as a gather into a contiguous view followed by K4
// (paged_decode_attention) or a plain einsum (paged_verify_attention):
// q [B,W,Hq,hd], one layer's flat pool k/v [NB*bs,Hkv,hd], block_tables
// [B,MB] int32; query j of row b attends logical positions
// [0, min(max(lengths[b] + j, 1), MB*bs)), and logical position p is pool
// row table[b][p / bs] * bs + p % bs. W = 1 is decode, W = draft_k + 1 the
// speculative verify. Only the row address differs from dense K4, so with
// a table that lays rows out contiguously W = 1 is bit-equal to it: same
// chunks, same lanes, same order of operations. The gathered view is never
// built, and no row past a query's span is loaded.
//
// What bounds K4 on the H100: memory. Each visible key is 2*Hkv*hd bf16
// bytes of K and V used for G = Hq/Hkv dot products and G axpys (W*G in
// verify), far below the card's ~295 FLOP/byte balance point, and at batch
// 1 there is too little work per row to fill 132 SMs with one block per
// head. Design (split-K flash-decoding): grid (split, kv head, batch row);
// each block owns one chunk of kChunk keys and loads every K/V row of it
// for all G query heads of its group. Blocks whose chunk starts at or past
// the row's span exit at once, so bytes read scale with the actual length,
// not with S, and the splits put enough blocks in flight at batch 1.
// Inside a block, hd/8 lanes share one key (16-byte loads, 8 dims per
// lane), and each lane group keeps an online softmax in the exp2 domain
// (f32). The block merges its lane groups through shared memory and
// writes (m, l, acc) partials to f32 scratch that the wrapper allocates; a
// second kernel merges the valid splits of each (row, query, head). In
// verify, a block walks its W query positions one after the other over
// the same chunk: the first pass reads the chunk from device memory, the
// later ones find it in L1/L2 (a first kernel; keeping the chunk in
// shared memory is later work).
//
// int8 KV (the *_q8 entries, the same template with a KV element type):
// k/v hold int8 codes with one bf16 scale per (row, kv head) beside them,
// as the JAX package's int8 caches and pools do. Each lane loads its 8
// codes as one 8-byte load; the key's scale is loaded once, by the key's
// first lane, and shuffled to the others. A code is dequantized as the JAX
// package's _dequant_kv does in the model dtype (code * scale, exact in
// f32, rounded once to bf16), then the same f32 softmax runs. An int8 key
// is 2*hd + 4 bytes of K and V with scales (260 at hd 128) against 4*hd
// (512) in bf16, so the bound halves.
//
// K5 replaces the TPU kernel skypilot_tpu/ops/decode_attention.py:
// _cache_write_kernel (launched by _cache_write_pallas): write R new rows
// k_new/v_new [R, Hkv, hd] into a flat row view k/v [N, Hkv, hd] at rows
// dst [R], in place; K and V in one launch. The rows form of the TPU
// kernel is dst = b * S + pos[b] over [B*S, Hkv, hd]; the paged engine
// passes flat pool indices. A dst outside [0, N) writes nothing. Rows
// that share a dst (padded lanes all aimed at the scratch block) race and
// any one may win, as in XLA's scatter. The TPU kernel's aligned 8-row
// read-modify-write window and masked-reduction row extraction are TPU
// layout details and are not carried over. Bound: bytes (each new row is
// read once and written once); one block per (row, array), copying with
// the widest word (16 bytes at llama3-8b) the row's width and alignment
// allow. Its int8 form writes the code rows (Hkv*hd bytes) and the scale
// rows (Hkv*2 bytes) of K and V in the same one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // key steps whose loads are issued together

struct DecodeArgs {
  const void* k;     // bf16, or int8 codes with the Q8 entries
  const void* v;
  const bf16* k_scale;  // Q8: one bf16 scale per (row, kv head)
  const bf16* v_scale;
  const bf16* q;
  const int* lengths;
  const int* table;  // [B, MB] for the paged form, unused when dense
  float* part_m;
  float* part_l;
  float* part_acc;
  bf16* out;
  int S;  // keys a row can hold: the dense S, or MB * bs
  int Hkv;
  int W;  // query positions per row (1 when dense)
  int MB;
  int bs;
  int n_split;
  int chunk;
  // Batch (dense only) and row strides, in elements, of K/V and (Q8)
  // of their scales.
  long long k_sb, k_ss, v_sb, v_ss;
  long long ks_sb, ks_ss, vs_sb, vs_ss;
  float scale_log2;
};

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

// 8 int8 codes (one 8-byte load) dequantized as the JAX package's
// _dequant_kv does in the model dtype: code * scale, exact in f32, rounded
// once to bf16.
__device__ __forceinline__ void load8(const int8_t* p, float sc,
                                      float (&f)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = __bfloat162float(__float2bfloat16_rn(float(c[e]) * sc));
}

// Keys query w of row b attends: K4's clamp to [1, S], widened by w.
__device__ __forceinline__ int span_of(const DecodeArgs& a, int b, int w) {
  return min(max(a.lengths[b] + w, 1), a.S);
}

template <bool PAGED>
__device__ __forceinline__ long long key_row(const DecodeArgs& a, int b,
                                             int key) {
  if (!PAGED) return key;
  const int blk = a.table[(long long)b * a.MB + key / a.bs];
  return (long long)blk * a.bs + key % a.bs;
}

template <int HD, int G, bool PAGED, bool Q8>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const DecodeArgs a) {
  using KV = typename std::conditional<Q8, int8_t, bf16>::type;
  constexpr int LPK = HD / 8;         // lanes per key
  constexpr int KPW = 32 / LPK;       // keys per warp step
  constexpr int NGROUPS = kWarps * KPW;
  __shared__ float sm_m[NGROUPS][G];
  __shared__ float sm_l[NGROUPS][G];
  __shared__ __align__(16) float sm_acc[NGROUPS][G][HD];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nw = PAGED ? a.W : 1;
  const int start = split * a.chunk;
  if (start >= span_of(a, b, nw - 1)) return;  // the merge skips it
  const int Hq = a.Hkv * G;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LPK;  // key slot within the warp step
  const int dl = lane % LPK;   // this lane's 8 dims: [8*dl, 8*dl + 8)
  const int group = warp * KPW + sub;
  const KV* kb = static_cast<const KV*>(a.k) + b * a.k_sb + kvh * HD + dl * 8;
  const KV* vb = static_cast<const KV*>(a.v) + b * a.v_sb + kvh * HD + dl * 8;
  // Q8: the scales of this row and kv head, one bf16 per key.
  const bf16* ksb = Q8 ? a.k_scale + b * a.ks_sb + kvh : nullptr;
  const bf16* vsb = Q8 ? a.v_scale + b * a.vs_sb + kvh : nullptr;

  for (int w = 0; w < nw; ++w) {
    const int len = span_of(a, b, w);
    if (start >= len) continue;  // uniform across the block
    const int end = min(start + a.chunk, len);
    const long long qrow0 = ((long long)b * nw + w) * Hq + kvh * G;

    float qr[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load8(a.q + (qrow0 + g) * HD + dl * 8, qr[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] *= a.scale_log2;
    }
    float m_run[G], l_run[G], acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_run[g] = -INFINITY;
      l_run[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }

    // Trip counts are uniform across the warp (the shuffles below need
    // every lane); keys past `end` are masked, not loaded.
    for (int base = start + warp * KPW; base < end;
         base += NGROUPS * kUnroll) {
      float kf[kUnroll][8], vf[kUnroll][8];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = base + u * NGROUPS + sub;
        ok[u] = key < end;
        if constexpr (Q8) {
          const long long row = ok[u] ? key_row<PAGED>(a, b, key) : 0;
          // One load of each scale per key (the key's first lane), handed
          // to the key's other lanes by a shuffle.
          float ksc = 0.f, vsc = 0.f;
          if (ok[u] && dl == 0) {
            ksc = __bfloat162float(ksb[row * a.ks_ss]);
            vsc = __bfloat162float(vsb[row * a.vs_ss]);
          }
          ksc = __shfl_sync(0xffffffff, ksc, lane - dl);
          vsc = __shfl_sync(0xffffffff, vsc, lane - dl);
          if (ok[u]) {
            load8(kb + row * a.k_ss, ksc, kf[u]);
            load8(vb + row * a.v_ss, vsc, vf[u]);
          }
        } else if (ok[u]) {
          const long long row = key_row<PAGED>(a, b, key);
          load8(kb + row * a.k_ss, kf[u]);
          load8(vb + row * a.v_ss, vf[u]);
        }
        if (!ok[u]) {
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
          for (int e = 0; e < 8; ++e)
            acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
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
        const float wt = exp2f(sm_m[i][g] - M);  // empty groups: 0
        L += wt * sm_l[i][g];
        A += wt * sm_acc[i][g][d];
      }
      const long long row = (qrow0 + g) * a.n_split + split;
      a.part_acc[row * HD + d] = A;
      if (d == 0) {
        a.part_m[row] = M;
        a.part_l[row] = L;
      }
    }
    __syncthreads();  // the next query position reuses the shared arrays
  }
}

template <int HD>
__global__ void __launch_bounds__(HD) decode_merge_kernel(const DecodeArgs a) {
  const int h = blockIdx.x, w = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int Hq = gridDim.x;
  const int n = (span_of(a, b, w) + a.chunk - 1) / a.chunk;
  const long long qrow = ((long long)b * gridDim.y + w) * Hq + h;
  const long long row0 = qrow * a.n_split;
  float M = -INFINITY;
  for (int i = 0; i < n; ++i) M = fmaxf(M, a.part_m[row0 + i]);
  float L = 0.f, A = 0.f;
  for (int i = 0; i < n; ++i) {
    const float wt = exp2f(a.part_m[row0 + i] - M);
    L += wt * a.part_l[row0 + i];
    A += wt * a.part_acc[(row0 + i) * HD + d];
  }
  a.out[qrow * HD + d] = __float2bfloat16(A / L);
}

template <int HD, int G, bool PAGED, bool Q8>
cudaError_t launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  decode_split_kernel<HD, G, PAGED, Q8>
      <<<dim3(a.n_split, a.Hkv, B), kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<HD><<<dim3(a.Hkv * G, PAGED ? a.W : 1, B), HD, 0,
                            stream>>>(a);
  return cudaGetLastError();
}

template <bool PAGED, bool Q8>
cudaError_t dispatch(const DecodeArgs& a, int B, int Hq, int HD,
                     cudaStream_t s) {
  if (a.Hkv <= 0 || Hq % a.Hkv != 0) return cudaErrorInvalidValue;
  const int G = Hq / a.Hkv;
#define SKYPILOT_DECODE_CASE(hd, g)                 \
  if (HD == hd && G == g) return launch<hd, g, PAGED, Q8>(a, B, s);
  SKYPILOT_DECODE_CASE(64, 1)
  SKYPILOT_DECODE_CASE(64, 2)
  SKYPILOT_DECODE_CASE(64, 4)
  SKYPILOT_DECODE_CASE(64, 8)
  SKYPILOT_DECODE_CASE(128, 1)
  SKYPILOT_DECODE_CASE(128, 2)
  SKYPILOT_DECODE_CASE(128, 4)
  SKYPILOT_DECODE_CASE(128, 8)
#undef SKYPILOT_DECODE_CASE
  return cudaErrorInvalidValue;
}

// K5: one block per (row r, array j). The bf16 form copies 2 arrays (K and
// V rows), the int8 form 4 (y = 0, 1 the K/V codes, y = 2, 3 their bf16
// scales: Hkv * 2 bytes, 16 at llama3-8b). A row whose width and bases
// allow it moves as 16-byte vectors, else as 4-, 2- or 1-byte words, so
// any width is taken.
struct CacheWriteArgs {
  uint8_t* dst_base[4];
  const uint8_t* src_base[4];
  int width[4];  // bytes per row of each array
  const int* dst;
  long long n_rows;
};

template <typename V>
__device__ __forceinline__ void copy_words(uint8_t* to, const uint8_t* from,
                                           int nbytes) {
  V* t = reinterpret_cast<V*>(to);
  const V* f = reinterpret_cast<const V*>(from);
  for (int i = threadIdx.x; i < nbytes / int(sizeof(V)); i += kThreads)
    t[i] = f[i];
}

__global__ void __launch_bounds__(kThreads)
    cache_write_kernel(const CacheWriteArgs a) {
  const int r = blockIdx.x, j = blockIdx.y;
  const long long d = a.dst[r];
  if (d < 0 || d >= a.n_rows) return;
  // Constant indices only: indexing the parameter arrays by blockIdx.y
  // would copy them to local memory in every block.
  uint8_t* base = a.dst_base[0];
  const uint8_t* src = a.src_base[0];
  int w = a.width[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (j == i) {
      base = a.dst_base[i];
      src = a.src_base[i];
      w = a.width[i];
    }
  }
  uint8_t* to = base + d * w;
  const uint8_t* from = src + (long long)r * w;
  const uintptr_t align = reinterpret_cast<uintptr_t>(to) |
                          reinterpret_cast<uintptr_t>(from) | uintptr_t(w);
  if (align % 16 == 0)
    copy_words<uint4>(to, from, w);
  else if (align % 4 == 0)
    copy_words<uint32_t>(to, from, w);
  else if (align % 2 == 0)
    copy_words<uint16_t>(to, from, w);
  else
    copy_words<uint8_t>(to, from, w);
}

}  // namespace

namespace {

DecodeArgs dense_args(const void* q, const void* k, const void* v,
                      const void* lengths, void* out, void* part_m,
                      void* part_l, void* part_acc, int S, int Hkv,
                      long long k_sb, long long k_ss, long long v_sb,
                      long long v_ss, int chunk, float scale_log2) {
  DecodeArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.table = nullptr;
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.out = static_cast<bf16*>(out);
  a.S = S;
  a.Hkv = Hkv;
  a.W = 1;
  a.MB = 0;
  a.bs = 1;
  a.chunk = chunk;
  a.n_split = (S + chunk - 1) / chunk;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.scale_log2 = scale_log2;
  return a;
}

DecodeArgs paged_args(const void* q, const void* k, const void* v,
                      const void* table, const void* lengths, void* out,
                      void* part_m, void* part_l, void* part_acc, int W,
                      int MB, int bs, int Hkv, long long k_ss,
                      long long v_ss, int chunk, float scale_log2) {
  DecodeArgs a = dense_args(q, k, v, lengths, out, part_m, part_l, part_acc,
                            MB * bs, Hkv, 0, k_ss, 0, v_ss, chunk,
                            scale_log2);
  a.table = static_cast<const int*>(table);
  a.W = W;
  a.MB = MB;
  a.bs = bs;
  return a;
}

}  // namespace

extern "C" int skypilot_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_m, void* part_l, void* part_acc, int B, int S,
    int Hq, int Hkv, int HD, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, int chunk, float scale_log2, void* stream) {
  const DecodeArgs a =
      dense_args(q, k, v, lengths, out, part_m, part_l, part_acc, S, Hkv,
                 k_sb, k_ss, v_sb, v_ss, chunk, scale_log2);
  return dispatch<false, false>(a, B, Hq, HD,
                                static_cast<cudaStream_t>(stream));
}

// int8 codes k/v with bf16 scales k_scale/v_scale (strides in elements).
extern "C" int skypilot_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* out, void* part_m,
    void* part_l, void* part_acc, int B, int S, int Hq, int Hkv, int HD,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long ks_sb, long long ks_ss, long long vs_sb, long long vs_ss,
    int chunk, float scale_log2, void* stream) {
  DecodeArgs a = dense_args(q, k, v, lengths, out, part_m, part_l, part_acc,
                            S, Hkv, k_sb, k_ss, v_sb, v_ss, chunk,
                            scale_log2);
  a.k_scale = static_cast<const bf16*>(k_scale);
  a.v_scale = static_cast<const bf16*>(v_scale);
  a.ks_sb = ks_sb;
  a.ks_ss = ks_ss;
  a.vs_sb = vs_sb;
  a.vs_ss = vs_ss;
  return dispatch<false, true>(a, B, Hq, HD,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int skypilot_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, void* part_m, void* part_l,
    void* part_acc, int B, int W, int MB, int bs, int Hq, int Hkv, int HD,
    long long k_ss, long long v_ss, int chunk, float scale_log2,
    void* stream) {
  if (W < 1 || MB < 1 || bs < 1) return cudaErrorInvalidValue;
  const DecodeArgs a =
      paged_args(q, k, v, table, lengths, out, part_m, part_l, part_acc, W,
                 MB, bs, Hkv, k_ss, v_ss, chunk, scale_log2);
  return dispatch<true, false>(a, B, Hq, HD,
                               static_cast<cudaStream_t>(stream));
}

// int8 pools with bf16 scale pools [N, Hkv] (row strides in elements).
extern "C" int skypilot_paged_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, void* out,
    void* part_m, void* part_l, void* part_acc, int B, int W, int MB, int bs,
    int Hq, int Hkv, int HD, long long k_ss, long long v_ss, long long ks_ss,
    long long vs_ss, int chunk, float scale_log2, void* stream) {
  if (W < 1 || MB < 1 || bs < 1) return cudaErrorInvalidValue;
  DecodeArgs a = paged_args(q, k, v, table, lengths, out, part_m, part_l,
                            part_acc, W, MB, bs, Hkv, k_ss, v_ss, chunk,
                            scale_log2);
  a.k_scale = static_cast<const bf16*>(k_scale);
  a.v_scale = static_cast<const bf16*>(v_scale);
  a.ks_ss = ks_ss;
  a.vs_ss = vs_ss;
  return dispatch<true, true>(a, B, Hq, HD,
                              static_cast<cudaStream_t>(stream));
}

namespace {

cudaError_t cache_write(int n_arrays, void* const* dsts,
                        const void* const* srcs, const int* widths,
                        const void* dst, int n_new, long long n_rows,
                        void* stream) {
  if (n_new < 0) return cudaErrorInvalidValue;
  if (n_new == 0) return cudaSuccess;
  CacheWriteArgs a{};
  for (int j = 0; j < n_arrays; ++j) {
    if (widths[j] <= 0) return cudaErrorInvalidValue;
    a.dst_base[j] = static_cast<uint8_t*>(dsts[j]);
    a.src_base[j] = static_cast<const uint8_t*>(srcs[j]);
    a.width[j] = widths[j];
  }
  a.dst = static_cast<const int*>(dst);
  a.n_rows = n_rows;
  cache_write_kernel<<<dim3(n_new, n_arrays), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int skypilot_cache_write(void* k, void* v, const void* k_new,
                                    const void* v_new, const void* dst,
                                    int n_new, long long n_rows,
                                    int row_bytes, void* stream) {
  void* dsts[2] = {k, v};
  const void* srcs[2] = {k_new, v_new};
  const int widths[2] = {row_bytes, row_bytes};
  return cache_write(2, dsts, srcs, widths, dst, n_new, n_rows, stream);
}

// The int8 form: code rows of row_bytes and scale rows of scale_bytes.
extern "C" int skypilot_cache_write_q8(
    void* k, void* v, void* k_scale, void* v_scale, const void* k_new,
    const void* v_new, const void* ks_new, const void* vs_new,
    const void* dst, int n_new, long long n_rows, int row_bytes,
    int scale_bytes, void* stream) {
  void* dsts[4] = {k, v, k_scale, v_scale};
  const void* srcs[4] = {k_new, v_new, ks_new, vs_new};
  const int widths[4] = {row_bytes, row_bytes, scale_bytes, scale_bytes};
  return cache_write(4, dsts, srcs, widths, dst, n_new, n_rows, stream);
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
