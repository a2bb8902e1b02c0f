// The serving path's products for Hopper (sm_90a), made so that a row's
// bits do not depend on the rows it shares a call with.
//
// 1. skypilot_matmul_invariant(_wt, _q8): y[M, N] = x[M, K] @ w, x bf16,
//    w bf16 [K, N] (or, _wt, the transposed view of an [N, K] matrix, the
//    tied LM head), or int8 codes [K, N] with one bf16 scale per output
//    column (_q8); f32 accumulation, bf16 out. The int8 form keeps the
//    JAX package's two rounding points (skypilot_tpu/models/llama.py
//    matmul): the product rounded to bf16, then times the scale in bf16;
//    the codes are widened to bf16 in shared memory (exact), so no bf16
//    copy of the weight is made.
// 2. skypilot_lora_delta: the row-gathered LoRA delta of mixed-adapter
//    rows, (h @ A[slot]) @ B[slot] in f32 (models/decode.lora_gather_delta).
//
// Neither replaces a TPU kernel: the JAX package leaves these products to
// XLA. They are a repair. cuBLAS picks its kernel, its K split and its
// reduction by the whole shape, so a row of the engine's decode (M = B),
// verify (M = B * W) and prefill chunk (M = the bucket) got other bits in
// each; a sampled or near-tied greedy token then depended on the batch.
//
// Invariance. Every M runs one tile shape (64 x 64 x 64), one MMA
// instruction (mma.sync m16n8k16, bf16 -> f32) and one K order: each
// output element's accumulator takes the 16-wide k-steps of its split in
// ascending order, and the splits of K are fixed by (N, K) alone
// (ops/matmul_invariant.py matmul_splits) and summed in split order by
// the last block of each output tile, in the same launch. The m16n8k16
// result of an element depends only on its own row of A and column of B,
// so neither the other rows of the tile nor M reach it. The LoRA delta's
// sums run in a fixed order set by (D, R), each row in blocks of its own.
//
// What bounds the GEMM on the H100: at decode (M = 8) and verify (M = 72)
// the weight's bytes (2 K N, 1 K N for int8) against 3.35 TB/s; at a
// 512-row prefill chunk the 2 M N K operations against 989 TFLOP/s. The
// design streams the weight once per 64-row tile of x through a 4-stage
// cp.async ring (16 KB a stage), and splits K until the (N, K) shape has
// about two waves of blocks, so a narrow N (1024: the k/v projections)
// still keeps every SM's loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 64, kBN = 64, kBK = 64;  // ops: MATMUL_TILE
constexpr int kStages = 4;
constexpr int kThreads = 128;
constexpr int kTile = 64 * 128;   // bytes of one 64 x 64 bf16 tile
constexpr int kStage = 2 * kTile;  // the x tile, then the w tile
// The int8 form widens each stage's codes into one more bf16 tile.
constexpr int kSmemBf16 = kStages * kStage;
constexpr int kSmemQ8 = kStages * kStage + kTile;

struct GemmArgs {
  const bf16* x;      // [M, K], row stride ldx
  const uint8_t* w;   // bf16 [K, N] / [N, K] (WT) or int8 [K, N]
  const bf16* s;      // Q8: [N]
  bf16* y;            // [M, N], row stride ldy
  float* part;        // [splits, M, N] when splits > 1
  int* counters;      // [m_tiles * n_tiles], 0 between calls
  long long ldx, ldw, ldy;
  int M, N, K, splits, k_chunk;
};

// Byte offset of (row, col) in a tile of 128-byte rows, the 16-byte chunk
// c of row r at c ^ (r % 8) (conflict-free ldmatrix). col is a multiple
// of 8 bf16.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool WT, bool Q8>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const __grid_constant__ GemmArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;
  const int kbeg = split * a.k_chunk;
  const int kend = min(a.K, kbeg + a.k_chunk);
  const int n_k = (kend - kbeg + kBK - 1) / kBK;

  // Stage `st` <- k-tile kt: 64 x 64 of x (rows past M and columns past
  // the split zero-filled), and 64 x 64 of w (bf16, swizzled; int8 codes
  // as plain 64-byte rows).
  auto load = [&](int kt, int st) {
    uint8_t* base = smem + st * kStage;
    const uint32_t xs = smem_u32(base), ws = smem_u32(base + kTile);
    const int k0 = kbeg + kt * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx >> 3, c = idx & 7;
      const int gm = m0 + row, gk = k0 + c * 8;
      const bool ok = gm < a.M && gk < kend;
      cp_async16(xs + swz(row, c * 8),
                 ok ? a.x + gm * a.ldx + gk : a.x, ok ? 16 : 0);
    }
    if (Q8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 2, c = idx & 3;  // k row, 16-code chunk
        const int gk = k0 + row, gn = n0 + c * 16;
        const bool ok = gk < kend && gn < a.N;
        cp_async16(ws + row * 64 + c * 16,
                   ok ? a.w + gk * a.ldw + gn : a.w, ok ? 16 : 0);
      }
    } else {
      const bf16* w = reinterpret_cast<const bf16*>(a.w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * kThreads;
        const int row = idx >> 3, c = idx & 7;
        // Rows are k (WT: n), columns n (WT: k).
        const int gk = WT ? k0 + c * 8 : k0 + row;
        const int gn = WT ? n0 + row : n0 + c * 8;
        const bool ok = gk < kend && gn < a.N;
        const long long off = WT ? gn * a.ldw + gk : gk * a.ldw + gn;
        cp_async16(ws + swz(row, c * 8), ok ? w + off : w, ok ? 16 : 0);
      }
    }
  };

  const int wm = warp >> 1, wn = warp & 1;  // a warp's 32 x 32 of the tile
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + kStages - 1 < n_k) load(kt + kStages - 1, (kt + kStages - 1) %
                                                            kStages);
    cp_async_commit();
    uint8_t* st = smem + (kt % kStages) * kStage;
    const uint32_t xs = smem_u32(st);
    uint32_t ws = smem_u32(st + kTile);
    if (Q8) {
      // Widen the codes into the bf16 tile: 32 a thread, exact.
      uint8_t* bt = smem + kStages * kStage;
      const int row = tid >> 1, c0 = (tid & 1) * 32;
      const int8_t* codes = reinterpret_cast<const int8_t*>(
          st + kTile + row * 64 + c0);
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        uint32_t p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = mma::pack_bf16(float(codes[c + 2 * e]),
                                float(codes[c + 2 * e + 1]));
        *reinterpret_cast<uint4*>(bt + swz(row, c0 + c)) =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
      __syncthreads();
      ws = smem_u32(bt);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma::ldsm_x4(af[mt], xs + swz(wm * 32 + mt * 16 + (lane & 15),
                                      kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        if (WT) {
          mma::ldsm_x4(b, ws + swz(wn * 32 + np * 16 + ((lane >> 4) & 1) * 8 +
                                       (lane & 7),
                                   kk * 16 + ((lane >> 3) & 1) * 8));
        } else {
          mma::ldsm_x4_t(b, ws + swz(kk * 16 + ((lane >> 3) & 1) * 8 +
                                         (lane & 7),
                                     wn * 32 + np * 16 +
                                         ((lane >> 4) & 1) * 8));
        }
        bfr[2 * np][0] = b[0];
        bfr[2 * np][1] = b[1];
        bfr[2 * np + 1][0] = b[2];
        bfr[2 * np + 1][1] = b[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma::mma16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  if (a.splits > 1) {
    // This split's partial, then the last block of the tile sums the
    // splits in order.
    float* part = a.part + (long long)split * a.M * a.N;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
        if (row >= a.M) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t;
          if (col < a.N)
            *reinterpret_cast<float2*>(part + (long long)row * a.N + col) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    __threadfence();
    __syncthreads();
    __shared__ int last;
    int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) last = atomicAdd(counter, 1) == a.splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid == 0) *counter = 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
        if (row >= a.M) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t;
          if (col >= a.N) continue;
          const long long off = (long long)row * a.N + col;
          float2 v = __ldcg(reinterpret_cast<const float2*>(a.part + off));
          for (int i = 1; i < a.splits; ++i) {
            const float2 p = __ldcg(reinterpret_cast<const float2*>(
                a.part + (long long)i * a.M * a.N + off));
            v.x += p.x;
            v.y += p.y;
          }
          acc[mt][nt][2 * h] = v.x;
          acc[mt][nt][2 * h + 1] = v.y;
        }
      }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
      if (row >= a.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (col >= a.N) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (Q8) {
          // (x @ codes) rounded to bf16, then times the bf16 scale (the
          // product of two bf16 is exact in f32), rounded once more.
          v0 = __bfloat162float(__float2bfloat16_rn(v0)) *
               __bfloat162float(a.s[col]);
          v1 = __bfloat162float(__float2bfloat16_rn(v1)) *
               __bfloat162float(a.s[col + 1]);
        }
        *reinterpret_cast<uint32_t*>(a.y + (long long)row * a.ldy + col) =
            mma::pack_bf16(v0, v1);
      }
    }
}

template <bool WT, bool Q8>
cudaError_t launch_matmul(const GemmArgs& a, cudaStream_t stream) {
  auto kernel = matmul_kernel<WT, Q8>;
  const int smem = Q8 ? kSmemQ8 : kSmemBf16;
  static unsigned long long attr_set = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set |= bit;
  }
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM, a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t matmul(const void* x, const void* w, const void* s, void* y,
                   void* part, void* counters, int M, int N, int K,
                   long long ldx, long long ldw, long long ldy, int splits,
                   int k_chunk, bool wt, bool q8, void* stream) {
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8 || ldx % 8 || ldw % 8 ||
      ldy % 2 || splits < 1 || splits > 65535 || k_chunk < kBK ||
      k_chunk % kBK || (long long)splits * k_chunk < K ||
      (long long)(splits - 1) * k_chunk >= K || (q8 && N % 16) ||
      (M + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  GemmArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.s = static_cast<const bf16*>(s);
  a.y = static_cast<bf16*>(y);
  a.part = static_cast<float*>(part);
  a.counters = static_cast<int*>(counters);
  a.ldx = ldx;
  a.ldw = ldw;
  a.ldy = ldy;
  a.M = M;
  a.N = N;
  a.K = K;
  a.splits = splits;
  a.k_chunk = k_chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q8) return launch_matmul<false, true>(a, st);
  return wt ? launch_matmul<true, false>(a, st)
            : launch_matmul<false, false>(a, st);
}

// ---------------------------------------------------------------------
// The gathered LoRA delta: blocks (row (b, t), 1024 output columns), in
// f32.
// ---------------------------------------------------------------------

constexpr int kLoraThreads = 1024;
constexpr int kLoraMaxRank = 64;

// mid[r] = sum_d h[d] A[d][r]: thread (g, r) sums d = g, g + G, ... in
// order (G = 1024 / R groups), then mid[r] sums the groups in order;
// out[n] = sum_r mid[r] B[r][n] in r order. Every order is set by (D, R).
// Each of a row's column blocks makes the row's mid the same way (the
// few reads of A come from L2), so the delta's columns spread over many
// blocks and mid never leaves the block.
__global__ void __launch_bounds__(kLoraThreads)
    lora_delta_kernel(const bf16* __restrict__ h,
                      const int* __restrict__ slot_of,
                      const float* __restrict__ a_slots,
                      const float* __restrict__ b_slots,
                      float* __restrict__ out, int T, int D, int R,
                      int n_out) {
  __shared__ float part[kLoraThreads];
  __shared__ float mid[kLoraMaxRank];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = blockIdx.y * kLoraThreads + tid;
  const long long slot = slot_of[row / T];
  const bf16* hr = h + row * D;
  const float* A = a_slots + slot * D * R;
  const float* B = b_slots + slot * R * n_out;
  const int G = kLoraThreads / R;
  if (tid < G * R) {
    const int r = tid % R, g = tid / R;
    float s = 0.f;
#pragma unroll 8
    for (int d = g; d < D; d += G)
      s = __fadd_rn(s, __fmul_rn(__bfloat162float(hr[d]), A[d * R + r]));
    part[tid] = s;
  }
  __syncthreads();
  if (tid < R) {
    float s = part[tid];
    for (int g = 1; g < G; ++g) s = __fadd_rn(s, part[g * R + tid]);
    mid[tid] = s;
  }
  __syncthreads();
  if (n >= n_out) return;
  float o = 0.f;
  for (int r = 0; r < R; ++r)
    o = __fadd_rn(o, __fmul_rn(mid[r], B[(long long)r * n_out + n]));
  out[row * n_out + n] = o;
}

}  // namespace

extern "C" int skypilot_matmul_invariant(const void* x, const void* w,
                                         void* y, void* part, void* counters,
                                         int M, int N, int K, long long ldx,
                                         long long ldw, long long ldy,
                                         int splits, int k_chunk, int wt,
                                         void* stream) {
  return matmul(x, w, nullptr, y, part, counters, M, N, K, ldx, ldw, ldy,
                splits, k_chunk, wt != 0, false, stream);
}

extern "C" int skypilot_matmul_invariant_q8(
    const void* x, const void* codes, const void* scale, void* y, void* part,
    void* counters, int M, int N, int K, long long ldx, long long ldw,
    long long ldy, int splits, int k_chunk, void* stream) {
  return matmul(x, codes, scale, y, part, counters, M, N, K, ldx, ldw, ldy,
                splits, k_chunk, false, true, stream);
}

// h bf16 [B*T, D] contiguous; slots int32 [B]; a_slots f32 [C+1, D, R];
// b_slots f32 [C+1, R, n_out]; out f32 [B*T, n_out].
extern "C" int skypilot_lora_delta(const void* h, const void* slots,
                                   const void* a_slots, const void* b_slots,
                                   void* out, int rows, int T, int D, int R,
                                   int n_out, void* stream) {
  if (rows < 1 || T < 1 || rows % T || D < 1 || R < 1 ||
      R > kLoraMaxRank || n_out < 1)
    return cudaErrorInvalidValue;
  const dim3 grid(rows, (n_out + kLoraThreads - 1) / kLoraThreads);
  lora_delta_kernel<<<grid, kLoraThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const int*>(slots),
      static_cast<const float*>(a_slots), static_cast<const float*>(b_slots),
      static_cast<float*>(out), T, D, R, n_out);
  return cudaGetLastError();
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
