// The MoE router of the serving path for Hopper (sm_90a): for each token
// of h [G, T, D] bf16 and the layer's router [D, E] bf16, in one launch,
//   logits_e = sum_d float(h_d) * float(router_de)       (f32)
//   p = softmax(logits)                                   (f32)
//   idx = the k largest p, ties to the lower expert index (lax.top_k)
//   gate_j = p[idx_j] / max(sum_j p[idx_j], 1e-9), rounded to bf16
//   slot = the (token, choice)'s place in expert idx's buffer of its
//          routing group (a row g of h), token-major, or -1 past cap
// (skypilot_tpu/models/llama.py _moe_mlp's router and capacity, whose
// plain form, ops/moe_route._moe_route_plain, runs on the CPU).
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
                 int* __restrict__ counters, int T, int D, int k, int cap) {
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
           void* gate_f32, void* slot, void* counters, int G, int T, int D,
           int k, int cap, cudaStream_t stream) {
  const dim3 grid(T, G);
  route_kernel<E><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h),
      static_cast<const __nv_bfloat16*>(router), static_cast<int*>(idx),
      static_cast<__nv_bfloat16*>(gate), static_cast<float*>(gate_f32),
      static_cast<int*>(slot), static_cast<int*>(counters), T, D, k, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h [G, T, D] bf16, router [D, E] bf16 (E in 2, 4, 8, 16; 16-byte
// aligned); outputs [G, T, k]: idx int32, gate bf16,
// gate_f32 (f32 before the rounding), slot int32; counters:
// G int32 zeros, left zero. Returns a cudaError_t.
extern "C" int skypilot_moe_route(const void* h, const void* router,
                                  void* idx, void* gate, void* gate_f32,
                                  void* slot, void* counters, int G, int T,
                                  int D, int E, int k, int cap,
                                  void* stream) {
  if (G <= 0 || T <= 0) return 0;
  if (D < 1 || k < 1 || k > kMaxK || k > E || cap < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 2:
      return launch<2>(h, router, idx, gate, gate_f32, slot, counters, G, T,
                       D, k, cap, s);
    case 4:
      return launch<4>(h, router, idx, gate, gate_f32, slot, counters, G, T,
                       D, k, cap, s);
    case 8:
      return launch<8>(h, router, idx, gate, gate_f32, slot, counters, G, T,
                       D, k, cap, s);
    case 16:
      return launch<16>(h, router, idx, gate, gate_f32, slot, counters, G,
                        T, D, k, cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
