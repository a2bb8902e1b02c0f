// The residual add and the RMSNorm of the serving path's rows for Hopper
// (sm_90a), in one launch: s = x + delta, rounded to x's dtype, and
// y = the norm of s. With no delta, s is x (not written) and y is the
// plain norm, through the same code and in the same order, so a layer's
// first norm and its fused ones meet the same arithmetic.
//
// Not a port of a TPU kernel: the JAX package's norm
// (skypilot_tpu/models/llama.py _rms_norm) and its residual adds are
// plain XLA, which fuses them. It is a repair. PyTorch's mean over the
// last dim picks its reduction by the number of rows, and on the H100 a
// verify step's row (M = 72) and the same row alone (M = 9) came out an
// ulp apart at layer 16 of llama3-8b, which then moved its K/V rows
// (PERF.md). Every norm of a serving forward but the first comes right
// after a residual add, which is why the add lives here.
//
// s = float(x) + float(delta) in f32, rounded once to x's dtype (as
// torch's bf16 add rounds); y = s * rsqrt(mean(s^2) + eps) * w, in f32
// (w + 1 for Gemma's centered weights), rounded once to x's dtype:
// llama._rms_norm's math on s.
//
// Bound: bytes, well under a microsecond, so a decode step's call (8
// rows of 8 KB) is set by latency: the launch, one round trip to memory,
// the block's reduction and the stores. One block per row and one pass:
// each thread issues all its 16-byte loads of x, delta and w at once,
// keeps its vectors in registers through the sum of squares, and writes
// s (before the reduction) and y from the same registers.
//
// Order, a function of D and x's dtype alone (never of the rows or of
// delta): the row is cut into vectors of 16 bytes of x (8 bf16 or 4 f32),
// nvec = D / E of them; the block's NT threads (ops/rms_norm.norm_plan)
// hold VPT vectors each, thread t the vectors t, t + NT, ...,
// t + (VPT - 1) NT. Thread t sums s^2 over its vectors in that order and
// over a vector's elements in order; the sums of a warp meet in a
// butterfly (__shfl_xor over 16, 8, 4, 2, 1), then the warps' sums are
// added in warp order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kMaxThreads = 512;  // ops/rms_norm.NORM_MAX_THREADS

// Element e of a vector kept as 32-bit words, and back.
__device__ __forceinline__ float elem(const uint32_t* v, int e, float) {
  return __uint_as_float(v[e]);
}
__device__ __forceinline__ float elem(const uint32_t* v, int e,
                                      __nv_bfloat16) {
  const uint32_t word = v[e >> 1];
  return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
}
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// A vector's E values, rounded to T, as the four words of 16 bytes.
__device__ __forceinline__ void pack(const float* v, uint32_t* out, float) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __float_as_uint(v[i]);
}
__device__ __forceinline__ void pack(const float* v, uint32_t* out,
                                     __nv_bfloat16) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
             uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])))
                 << 16;
}

// `bytes` (8, 16 or 32) from p into words, in 16- or 8-byte loads.
template <int BYTES>
__device__ __forceinline__ void load(const void* p, uint32_t* out) {
  if constexpr (BYTES == 8) {
    const uint2 a = *static_cast<const uint2*>(p);
    out[0] = a.x, out[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 a = static_cast<const uint4*>(p)[i];
      out[4 * i] = a.x, out[4 * i + 1] = a.y, out[4 * i + 2] = a.z,
                out[4 * i + 3] = a.w;
    }
  }
}

__device__ __forceinline__ void store(void* p, const uint32_t* v) {
  *static_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

template <typename T, typename W, int VPT>
__global__ void __launch_bounds__(kMaxThreads)
    add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                        const W* __restrict__ w, T* __restrict__ s,
                        T* __restrict__ y, int D, float eps, int offset) {
  constexpr int E = 16 / sizeof(T);             // elements a vector
  constexpr int WB = E * sizeof(W);             // bytes of w a vector
  __shared__ float red[kMaxThreads / 32];
  const long long base = (long long)blockIdx.x * D;
  const int nvec = D / E;
  uint32_t xv[VPT][4], dv[VPT][4], wv[VPT][WB / 4];
  // Every load first: one round trip for the row.
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < nvec) {
      load<16>(x + base + j * E, xv[k]);
      if (delta) load<16>(delta + base + j * E, dv[k]);
      load<WB>(w + j * E, wv[k]);
    }
  }
  float v[VPT][E];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j >= nvec) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float a = elem(xv[k], e, T());
      if (delta) a = round_to(__fadd_rn(a, elem(dv[k], e, T())), T());
      v[k][e] = a;
      ss = __fadd_rn(ss, __fmul_rn(a, a));
    }
    if (delta) {
      uint32_t out[4];
      pack(v[k], out, T());
      store(s + base + j * E, out);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffff, ss, d));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = red[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k)
    tot = __fadd_rn(tot, red[k]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(tot, float(D)), eps));
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j >= nvec) continue;
    float out[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float wf = elem(wv[k], e, W());
      if (offset) wf = __fadd_rn(1.f, wf);
      out[e] = __fmul_rn(__fmul_rn(v[k][e], r), wf);
    }
    uint32_t words[4];
    pack(out, words, T());
    store(y + base + j * E, words);
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* delta, const void* w, void* s,
                   void* y, int rows, int D, int threads, int vpt, float eps,
                   int offset, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(delta);
  const W* wp = static_cast<const W*>(w);
  T* sp = static_cast<T*>(s);
  T* yp = static_cast<T*>(y);
  switch (vpt) {
    case 1:
      add_rms_norm_kernel<T, W, 1><<<rows, threads, 0, stream>>>(
          xp, dp, wp, sp, yp, D, eps, offset);
      break;
    case 2:
      add_rms_norm_kernel<T, W, 2><<<rows, threads, 0, stream>>>(
          xp, dp, wp, sp, yp, D, eps, offset);
      break;
    case 4:
      add_rms_norm_kernel<T, W, 4><<<rows, threads, 0, stream>>>(
          xp, dp, wp, sp, yp, D, eps, offset);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int run(const void* x, const void* delta, const void* w, void* s, void* y,
        int rows, int D, int threads, int vpt, float eps, int offset,
        int x_f32, int w_f32, void* stream) {
  const int E = x_f32 ? 4 : 8;
  if (rows < 0 || D < 1 || D % E || threads < 32 || threads % 32 ||
      threads > kMaxThreads || (long long)threads * vpt * E < D ||
      (delta != nullptr) != (s != nullptr))
    return cudaErrorInvalidValue;
  for (const void* p : {x, delta, w, static_cast<const void*>(s),
                        static_cast<const void*>(y)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return w_f32 ? launch<float, float>(x, delta, w, s, y, rows, D, threads,
                                        vpt, eps, offset, st)
                 : launch<float, __nv_bfloat16>(x, delta, w, s, y, rows, D,
                                                threads, vpt, eps, offset,
                                                st);
  return w_f32 ? launch<__nv_bfloat16, float>(x, delta, w, s, y, rows, D,
                                              threads, vpt, eps, offset, st)
               : launch<__nv_bfloat16, __nv_bfloat16>(
                     x, delta, w, s, y, rows, D, threads, vpt, eps, offset,
                     st);
}

}  // namespace

// x, delta, s, y [rows, D] contiguous, bf16 (x_f32 0) or f32, 16-byte
// aligned; w [D] bf16 (w_f32 0) or f32; (threads, vpt) from
// ops/rms_norm.norm_plan(D). Writes s = x + delta and y = norm(s).
extern "C" int skypilot_add_rms_norm(const void* x, const void* delta,
                                     const void* w, void* s, void* y,
                                     int rows, int D, int threads, int vpt,
                                     float eps, int offset, int x_f32,
                                     int w_f32, void* stream) {
  if (!delta || !s) return cudaErrorInvalidValue;
  return run(x, delta, w, s, y, rows, D, threads, vpt, eps, offset, x_f32,
             w_f32, stream);
}

// The same kernel with no delta: y = norm(x).
extern "C" int skypilot_rms_norm(const void* x, const void* w, void* y,
                                 int rows, int D, int threads, int vpt,
                                 float eps, int offset, int x_f32, int w_f32,
                                 void* stream) {
  return run(x, nullptr, w, nullptr, y, rows, D, threads, vpt, eps, offset,
             x_f32, w_f32, stream);
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
