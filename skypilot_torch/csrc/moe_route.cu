// The MoE router of the serving path for Hopper (sm_90a): for each token
// of h [G, T, D] bf16 and the layer's router [D, E] bf16, in one launch,
//   logits_e = sum_d float(h_d) * float(router_de)       (f32)
//   p = softmax(logits)                                   (f32)
//   idx = the k largest p, ties to the lower expert index (lax.top_k)
//   gate_j = p[idx_j] / max(sum_j p[idx_j], 1e-9), rounded to bf16
//   slot = the (token, choice)'s place in expert idx's buffer of its
//          routing group (a row g of h), token-major, or -1 past cap
//   probs = p, f32, where the caller asks for it (the training forward;
//          the serving calls pass null and write nothing more)
// (skypilot_tpu/models/llama.py _moe_mlp's router and capacity, whose
// plain form, ops/moe_route._moe_route_plain, runs on the CPU), and the
// router's backward (moe_route_bwd, at the end of this file).
//
// Not a port of a TPU kernel: the JAX package routes with plain XLA
// (an f32 dot, softmax, lax.top_k and a cumsum). It is a repair. The
// serving rows must stay batch-invariant: cuBLAS's f32 product picks its
// reduction by the number of rows, and torch.topk on CUDA does not
// promise lax.top_k's tie order, so a token's experts could move with the
// batch it shares a call with.
//
// Order, a function of D alone: block (t, g) takes token t of group g;
// its thread i (of 256) adds h_d * router_de for d = i, i + 256, ... in
// turn into its E sums (fmaf); a warp's sums meet in a butterfly
// (__shfl_xor over 16, 8, 4, 2, 1), and thread 0 adds the 8 warps' sums
// in warp order. A warp's loads are coalesced: 32 neighbouring elements
// of h and the 32 router rows under them (one 16-byte row a lane at
// E = 8); a thread's 16 iterations at D 4096 are unrolled, so its loads
// are all in flight at once. Thread 0 then adds the exponentials in
// expert order, and its top-k takes a strictly larger p to replace the
// best so far.
//
// Slots need the whole group in token order. Each block writes its
// token's idx, then counts itself done on the group's counter; the last
// block of the group (the counter reaching gridDim.x) resets the counter
// to 0 for the next call and, in one warp, walks the group's (token,
// choice) entries 32 at a time: per expert a ballot of the lanes that
// chose it gives each its rank, so an entry's place is the count of
// earlier entries with the same expert (JAX's cumsum of the one-hot).
//
// Bound: bytes (h read once, the router once, the outputs written once):
// about a microsecond at a 512-token prefill chunk and well under one at
// a decode step, so a call is set by its latency: the launch, one round
// of loads, the block's reduction and the group's slot scan. A token a
// block (not a warp) keeps that round to one: with a warp a token, a
// decode step's call took 0.0150 ms (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // a token's block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 8;   // ops/moe_route.MOE_ROUTE_MAX_K

__device__ __forceinline__ float bf16_bits(uint32_t word, int hi) {
  return __uint_as_float(hi ? (word & 0xffff0000u) : (word << 16));
}

__device__ __forceinline__ void unpack(uint32_t w, float* r) {
  r[0] = bf16_bits(w, 0);
  r[1] = bf16_bits(w, 1);
}

// Router row d (E bf16, 2 E bytes at a multiple of 2 E) as floats, in
// the widest loads its alignment allows.
template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* r) {
  if constexpr (E % 8 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 w = __ldg(v + i);
      unpack(w.x, r + 8 * i);
      unpack(w.y, r + 8 * i + 2);
      unpack(w.z, r + 8 * i + 4);
      unpack(w.w, r + 8 * i + 6);
    }
  } else if constexpr (E == 4) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    unpack(w.x, r);
    unpack(w.y, r + 2);
  } else {
    unpack(__ldg(reinterpret_cast<const uint32_t*>(p)), r);
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads)
    route_kernel(const __nv_bfloat16* __restrict__ h,
                 const __nv_bfloat16* __restrict__ router,
                 int* __restrict__ idx, __nv_bfloat16* __restrict__ gate,
                 float* __restrict__ gate_f32, int* __restrict__ slot,
                 float* __restrict__ probs, int* __restrict__ counters,
                 int T, int D, int k, int cap) {
  __shared__ float part[kWarps][E];
  const int g = blockIdx.y;
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tok = static_cast<long long>(g) * T + t;
  const unsigned short* hrow =
      reinterpret_cast<const unsigned short*>(h) + tok * D;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll 16
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float xi =
        __uint_as_float(static_cast<uint32_t>(__ldg(hrow + d)) << 16);
    float r[E];
    load_row<E>(router + static_cast<long long>(d) * E, r);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(xi, r[e], acc[e]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) part[warp][e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      l[e] = part[0][e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) l[e] += part[w][e];
    }
    float m = l[0];
#pragma unroll
    for (int e = 1; e < E; ++e) m = fmaxf(m, l[e]);
    float p[E];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      p[e] = expf(l[e] - m);
      s += p[e];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = p[e] / s;
    if (probs != nullptr) {
#pragma unroll
      for (int e = 0; e < E; ++e) probs[tok * E + e] = p[e];
    }
    unsigned used = 0;
    int pick[kMaxK];
    float val[kMaxK];
    float tot = 0.f;
    for (int j = 0; j < k; ++j) {
      int bi = -1;
      float best = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (!((used >> e) & 1u) && (bi < 0 || p[e] > best)) {
          bi = e;
          best = p[e];
        }
      }
      used |= 1u << bi;
      pick[j] = bi;
      val[j] = best;
      tot += best;
    }
    const float den = fmaxf(tot, 1e-9f);
    for (int j = 0; j < k; ++j) {
      const float gj = val[j] / den;
      idx[tok * k + j] = pick[j];
      gate[tok * k + j] = __float2bfloat16_rn(gj);
      gate_f32[tok * k + j] = gj;
    }
  }
  // Slots: the group's last block, once every block's idx is visible.
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(counters + g, 1);
    is_last = done == static_cast<int>(gridDim.x) - 1;
    if (is_last) counters[g] = 0;
  }
  __syncthreads();
  if (!is_last || warp != 0) return;
  __threadfence();
  const long long n = static_cast<long long>(T) * k;
  const int* gi = idx + static_cast<long long>(g) * n;
  int* gs = slot + static_cast<long long>(g) * n;
  const unsigned below = (1u << lane) - 1u;
  int base[E];
#pragma unroll
  for (int e = 0; e < E; ++e) base[e] = 0;
  for (long long i0 = 0; i0 < n; i0 += 32) {
    const long long i = i0 + lane;
    const int ei = i < n ? __ldcg(gi + i) : -1;
    int si = -1;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned chose = __ballot_sync(0xffffffffu, ei == e);
      if (ei == e) {
        const int pos = base[e] + __popc(chose & below);
        si = pos < cap ? pos : -1;
      }
      base[e] += __popc(chose);
    }
    if (i < n) gs[i] = si;
  }
}

template <int E>
int launch(const void* h, const void* router, void* idx, void* gate,
           void* gate_f32, void* slot, void* probs, void* counters, int G,
           int T, int D, int k, int cap, cudaStream_t stream) {
  const dim3 grid(T, G);
  route_kernel<E><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(router), static_cast<int*>(idx),
      static_cast<__nv_bfloat16*>(gate), static_cast<float*>(gate_f32),
      static_cast<int*>(slot), static_cast<float*>(probs),
      static_cast<int*>(counters), T, D, k, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h [G, T, D] bf16, router [D, E] bf16 (E in 2, 4, 8, 16; 16-byte
// aligned); outputs [G, T, k]: idx int32, gate bf16,
// gate_f32 (f32 before the rounding), slot int32; probs [G, T, E] f32
// or null; counters: G int32 zeros, left zero. Returns a cudaError_t.
extern "C" int skypilot_moe_route(const void* h, const void* router,
                                  void* idx, void* gate, void* gate_f32,
                                  void* slot, void* probs, void* counters,
                                  int G, int T, int D, int E, int k,
                                  int cap, void* stream) {
  if (G <= 0 || T <= 0) return 0;
  if (D < 1 || k < 1 || k > kMaxK || k > E || cap < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 2:
      return launch<2>(h, router, idx, gate, gate_f32, slot, probs,
                       counters, G, T, D, k, cap, s);
    case 4:
      return launch<4>(h, router, idx, gate, gate_f32, slot, probs,
                       counters, G, T, D, k, cap, s);
    case 8:
      return launch<8>(h, router, idx, gate, gate_f32, slot, probs,
                       counters, G, T, D, k, cap, s);
    case 16:
      return launch<16>(h, router, idx, gate, gate_f32, slot, probs,
                        counters, G, T, D, k, cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// ---------------------------------------------------------------------
// moe_route_bwd: the router's backward for the training forward, which
// routes with the kernel above (its probs output). Per token n of the
// N = G * T tokens, from p [N, E] f32, idx [N, k], and the gradients of
// the f32 gates dgate [N, k] and of the probabilities dprobs [N, E] (the
// aux loss's; null reads as zeros), with s = sum_j p[idx_j] (the
// forward's max(s, 1e-9) never binds: s >= p_max >= 1 / E):
//   dp_e = dprobs_e + sum_j [idx_j = e] dgate_j / s
//          - [e in top k] sum_j dgate_j p[idx_j] / s^2
//   dlogits_e = p_e (dp_e - sum_m p_m dp_m)          (softmax's vjp)
//   dh[n, d] = sum_e dlogits_e router[d, e], f32 in ascending e, rounded
//              to bf16 (h's gradient through the f32 logits)
// The router's own gradient, h^T @ dlogits, is a reduction over every
// token: a plain product after this kernel (ops/moe_route.py).
//
// Not a port of a TPU kernel: JAX differentiates its XLA router
// (skypilot_tpu/models/llama.py:406-426) by autograd. The kernel is the
// backward of the forward kernel above, so nothing of the plain chain
// (f32 matmul, softmax, top_k, gather, normalize) runs on the card.
//
// Bound: bytes at E 8. dh is [N, D] bf16 (64 MB at N 8192, D 4096: 20
// us at 3.35 TB/s); the rest is N (2 E + 2 k) 4 bytes in and N E 4 out.
// Its 2 N D E f32 flops take 8 us at 67 TFLOP/s. Design: block (r, c)
// owns columns [1024 c, 1024 c + 1024) of tokens [16 r, 16 r + 16):
// threads t < 16 first take token t's dlogits into shared memory (column
// block 0 also writes them out), then each thread keeps its four router
// rows (4 E floats) in registers for the block's tokens and stores four
// dh values (8 bytes) a token, a warp's stores 256 contiguous bytes. The
// router (64 KB at E 8) is read once a block, from L2.

constexpr int kBwdTok = 16;   // tokens a block
constexpr int kBwdCols = 4;   // dh columns a thread

template <int E>
__global__ void __launch_bounds__(kThreads)
    route_bwd_kernel(const float* __restrict__ probs,
                     const int* __restrict__ idx,
                     const float* __restrict__ dgate,
                     const float* __restrict__ dprobs,
                     const __nv_bfloat16* __restrict__ router,
                     float* __restrict__ dlogits,
                     __nv_bfloat16* __restrict__ dh, long long N, int D,
                     int k) {
  __shared__ float sdl[kBwdTok][E];
  const long long n0 = static_cast<long long>(blockIdx.x) * kBwdTok;
  if (threadIdx.x < kBwdTok) {
    const long long n = n0 + threadIdx.x;
    float dl[E];
    if (n < N) {
      float p[E], dp[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        p[e] = probs[n * E + e];
        dp[e] = dprobs != nullptr ? dprobs[n * E + e] : 0.f;
      }
      int pick[kMaxK];
      float dg[kMaxK];
      float s = 0.f, gp = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
          pick[j] = idx[n * k + j];
          dg[j] = dgate[n * k + j];
          float pj = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) pj = pick[j] == e ? p[e] : pj;
          s += pj;
          gp = fmaf(dg[j], pj, gp);
        }
      }
      const float inv = 1.f / s;
      const float sub = gp * inv * inv;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (pick[j] == e) dp[e] += dg[j] * inv - sub;
        }
      }
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(p[e], dp[e], dot);
#pragma unroll
      for (int e = 0; e < E; ++e) dl[e] = p[e] * (dp[e] - dot);
      if (blockIdx.y == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) dlogits[n * E + e] = dl[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) dl[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sdl[threadIdx.x][e] = dl[e];
  }
  __syncthreads();
  const int d0 = (blockIdx.y * kThreads + threadIdx.x) * kBwdCols;
  if (d0 >= D) return;
  float r[kBwdCols][E];
  {
    // Rows d0 .. d0 + 3: 4 E contiguous bf16 (8 E bytes, a multiple of
    // 16 at a 16-byte aligned router), as E / 2 vector loads.
    const uint4* v = reinterpret_cast<const uint4*>(
        router + static_cast<long long>(d0) * E);
    float* flat = &r[0][0];
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const uint4 w = __ldg(v + i);
      unpack(w.x, flat + 8 * i);
      unpack(w.y, flat + 8 * i + 2);
      unpack(w.z, flat + 8 * i + 4);
      unpack(w.w, flat + 8 * i + 6);
    }
  }
  const long long last = N - n0 < kBwdTok ? N - n0 : kBwdTok;
  for (int t = 0; t < last; ++t) {
    float acc[kBwdCols];
#pragma unroll
    for (int c = 0; c < kBwdCols; ++c) {
      acc[c] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[c] = fmaf(sdl[t][e], r[c][e], acc[c]);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
    uint2 out;
    out.x = *reinterpret_cast<const uint32_t*>(&lo);
    out.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dh + (n0 + t) * D + d0) = out;
  }
}

template <int E>
int launch_bwd(const void* probs, const void* idx, const void* dgate,
               const void* dprobs, const void* router, void* dlogits,
               void* dh, long long N, int D, int k, cudaStream_t stream) {
  const int per_block = kThreads * kBwdCols;
  const dim3 grid(static_cast<unsigned>((N + kBwdTok - 1) / kBwdTok),
                  (D + per_block - 1) / per_block);
  route_bwd_kernel<E><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(probs), static_cast<const int*>(idx),
      static_cast<const float*>(dgate), static_cast<const float*>(dprobs),
      static_cast<const __nv_bfloat16*>(router),
      static_cast<float*>(dlogits), static_cast<__nv_bfloat16*>(dh), N, D,
      k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// probs [N, E] f32, idx [N, k] int32, dgate [N, k] f32, dprobs [N, E]
// f32 or null, router [D, E] bf16 (E in 2, 4, 8, 16; 16-byte aligned;
// D a multiple of 4); outputs dlogits [N, E] f32 and dh [N, D] bf16.
// Returns a cudaError_t.
extern "C" int skypilot_moe_route_bwd(const void* probs, const void* idx,
                                      const void* dgate, const void* dprobs,
                                      const void* router, void* dlogits,
                                      void* dh, long long N, int D, int E,
                                      int k, void* stream) {
  if (N <= 0) return 0;
  if (D < 4 || D % 4 || k < 1 || k > kMaxK || k > E ||
      (N + kBwdTok - 1) / kBwdTok > 2147483647LL ||
      (D + kThreads * kBwdCols - 1) / (kThreads * kBwdCols) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 2:
      return launch_bwd<2>(probs, idx, dgate, dprobs, router, dlogits, dh,
                           N, D, k, s);
    case 4:
      return launch_bwd<4>(probs, idx, dgate, dprobs, router, dlogits, dh,
                           N, D, k, s);
    case 8:
      return launch_bwd<8>(probs, idx, dgate, dprobs, router, dlogits, dh,
                           N, D, k, s);
    case 16:
      return launch_bwd<16>(probs, idx, dgate, dprobs, router, dlogits, dh,
                            N, D, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
