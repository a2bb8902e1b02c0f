// RMSNorm of the serving path's rows for Hopper (sm_90a), one block per
// row with a fixed summation tree, so a row's bits do not depend on the
// rows it shares a call with.
//
// Not a port of a TPU kernel: the JAX package's norm
// (skypilot_tpu/models/llama.py _rms_norm) is plain XLA. It is a repair.
// PyTorch's mean over the last dim picks its reduction by the number of
// rows, and on the H100 a verify step's row (M = 72) and the same row
// alone (M = 9) came out an ulp apart at layer 16 of llama3-8b, which
// then moved its K/V rows (PERF.md).
//
// y = x * rsqrt(mean(x^2) + eps) * w, in f32 (w + 1 for Gemma's centered
// weights), rounded once to x's dtype: llama._rms_norm's math. Thread t
// of 256 sums x^2 over columns t, t + 256, ... in order; the 8 warps'
// shuffle trees and then the warps in order make the row's sum. Bound:
// bytes (the row read once, written once), a few microseconds a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    T* __restrict__ y, int D, float eps, int offset) {
  __shared__ float red[kWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f(xr[i]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffff, s, d));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float ss = red[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) ss = __fadd_rn(ss, red[k]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, float(D)), eps));
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float wv = to_f(w[i]);
    if (offset) wv = __fadd_rn(1.f, wv);
    from_f(__fmul_rn(__fmul_rn(to_f(xr[i]), r), wv), yr + i);
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int D,
                   float eps, int offset, cudaStream_t stream) {
  rms_norm_kernel<T, W><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      D, eps, offset);
  return cudaGetLastError();
}

}  // namespace

// x, y [rows, D] contiguous, bf16 (x_f32 0) or f32; w [D] bf16 (w_f32 0)
// or f32.
extern "C" int skypilot_rms_norm(const void* x, const void* w, void* y,
                                 int rows, int D, float eps, int offset,
                                 int x_f32, int w_f32, void* stream) {
  if (rows < 0 || D < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return w_f32 ? launch<float, float>(x, w, y, rows, D, eps, offset, st)
                 : launch<float, __nv_bfloat16>(x, w, y, rows, D, eps,
                                                offset, st);
  return w_f32 ? launch<__nv_bfloat16, float>(x, w, y, rows, D, eps, offset,
                                              st)
               : launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, D, eps,
                                                      offset, st);
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
