// The nucleus (top-p) threshold of each sampled row for Hopper (sm_90a):
// one block per row of descending-sorted logits, every sum in an order
// set by the row's length alone.
//
// Not a port of a TPU kernel: the JAX package's filter
// (skypilot_tpu/serve/sampling/sample.py) is plain XLA. It is a repair.
// In PyTorch the filter's softmax sum and cumsum over the 128256-entry
// vocabulary pick their reduction by the number of rows (a single row's
// cumsum even takes another algorithm), so a sampled row's cut could move
// with the batch width or W (PERF.md).
//
// Per row x (sorted descending), with p = top_p:
//   e_i = exp(x_i - x_0), S = sum e_i, prob_i = e_i / S,
//   cum_i = prob_0 + ... + prob_i,
//   kth = min { x_i : cum_i - prob_i < p }
// (serve/sampling/sample.py _filter_top_p_row, whose plain form runs on
// the CPU). Each of the 1024 threads owns a contiguous segment of the row
// and sums it in order; the segment sums meet in a fixed shuffle tree
// (S) or a fixed shuffle scan (cum); the minimum is exact in any order.
// Bound: bytes (the row is read three times, from L2 after the first),
// a few microseconds a row; the engine's calls have 1 to 72 rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// The block's sum of v, in one fixed order; every thread gets it.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffff, v, d));
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

// The sum of v over the threads before this one, in one fixed order.
__device__ float block_exclusive_scan(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(0xffffffff, inc, d);
    if (lane >= d) inc = __fadd_rn(inc, up);
  }
  float exc = __shfl_up_sync(0xffffffff, inc, 1);
  if (lane == 0) exc = 0.f;
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp; ++w) before = __fadd_rn(before, red[w]);
  return __fadd_rn(before, exc);
}

__global__ void __launch_bounds__(kThreads)
    top_p_kth_kernel(const float* __restrict__ sorted,
                     const float* __restrict__ top_p, float* __restrict__ kth,
                     int V) {
  __shared__ float red[kWarps];
  __shared__ float mins[kWarps];
  const float* x = sorted + (long long)blockIdx.x * V;
  const float p = top_p[blockIdx.x];
  const float x0 = x[0];
  const int per = (V + kThreads - 1) / kThreads;
  const int lo = min(V, threadIdx.x * per), hi = min(V, lo + per);
  float s = 0.f;
  for (int i = lo; i < hi; ++i) s = __fadd_rn(s, expf(__fsub_rn(x[i], x0)));
  const float total = block_sum(s, red);
  float ps = 0.f;
  for (int i = lo; i < hi; ++i)
    ps = __fadd_rn(ps, __fdiv_rn(expf(__fsub_rn(x[i], x0)), total));
  float cum = block_exclusive_scan(ps, red);
  float m = INFINITY;
  for (int i = lo; i < hi; ++i) {
    const float prob = __fdiv_rn(expf(__fsub_rn(x[i], x0)), total);
    cum = __fadd_rn(cum, prob);
    if (!(__fsub_rn(cum, prob) >= p)) m = fminf(m, x[i]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffff, m, d));
  if ((threadIdx.x & 31) == 0) mins[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float k = mins[0];
    for (int w = 1; w < kWarps; ++w) k = fminf(k, mins[w]);
    kth[blockIdx.x] = k;
  }
}

}  // namespace

// sorted f32 [rows, V] (each row descending), top_p f32 [rows] (already
// clamped above 0) -> kth f32 [rows].
extern "C" int skypilot_top_p_kth(const void* sorted, const void* top_p,
                                  void* kth, int rows, int V, void* stream) {
  if (rows < 0 || V < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  top_p_kth_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sorted), static_cast<const float*>(top_p),
      static_cast<float*>(kth), V);
  return cudaGetLastError();
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
