// The nucleus (top-p) threshold of each sampled row for Hopper (sm_90a):
// one thread-block cluster per row of descending-sorted logits, every sum
// in an order set by the row's length alone.
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
//   kth = min { x_i : !(cum_i - prob_i >= p) }
// (serve/sampling/sample.py _filter_top_p_row, whose plain form runs on
// the CPU).
//
// Bound: bytes (the row read once), about a microsecond for a decode
// step's 8 rows; the engine's calls have 1 to 72 rows. What costs is the
// arithmetic (an expf and a division an element) and its latency, so a
// row is spread over a cluster of kC = 8 CTAs (grid 8 x rows, the portable
// cluster size; 16 was no faster, PERF.md): a decode step's 8 rows run as
// 64 blocks, not 8. Each warp stages its own threads' logits into shared
// memory with coalesced loads, and each thread reads its L logits once,
// keeping e_i and then prob_i in registers: one expf and one division an
// element. The CTAs' totals and prefixes go to the others' shared memory
// (DSMEM) and are added there in CTA order; the minimum goes to CTA 0
// (exact in any order).
//
// The plan (ops/top_p.top_p_plan(V)): CTA r of the cluster takes the
// logits [r P, (r + 1) P) of [0, V), P = ceil(V / 8); thread t of its NT
// takes [t L, (t + 1) L) of that slice, L = 36 (4 x an odd number: the
// 16-byte shared-memory reads of 8 neighbouring threads fall in 8
// distinct bank groups), NT = ceil(P / L) rounded up to a warp.
// The order, a function of V alone:
//   S: each thread adds its e_i in index order; a warp's sums meet in a
//      butterfly (__shfl_xor over 16, 8, 4, 2, 1); the CTA adds its warps'
//      sums in warp order, and the cluster its CTAs' sums in CTA order.
//   cum_i: each thread adds its prob_i in order (its sum Q_t); a warp
//      scans its Q_t inclusively (__shfl_up over 1, 2, 4, 8, 16, adding
//      the lower lane's value) and takes lane - 1's as the exclusive
//      prefix e_t; the CTA adds its warps' inclusive totals in warp order
//      (those before warp w: B_w; all of them: P_r), the cluster the P_r
//      of the CTAs before r in CTA order (A_r). Thread t starts from
//      (A_r + B_w) + e_t and adds its prob_i in order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 8;  // CTAs a row's cluster (ops/top_p.TOP_P_CLUSTER)
constexpr int kMaxThreads = 1024;
constexpr int kWarpsMax = kMaxThreads / 32;
constexpr int kL = 36;  // logits a thread (ops/top_p.TOP_P_PER_THREAD)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Every thread of every CTA of the cluster: release this thread's
// (local and remote) shared-memory writes, acquire the others'.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// v into the same shared-memory slot of CTA `rank` of the cluster.
__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// a / b rounded to nearest, as __fdiv_rn, for a = 0 or 2^-100 <= a <= 1,
// and 1 <= b <= 2^24 with inv = __frcp_rn(b): q = RN(a inv) is within an
// ulp of a / b, the remainder a - b q is exact in one fma, and
// RN(q + (a - b q) inv) is the correctly rounded quotient (Markstein's
// theorem: inv within half an ulp of 1 / b; a, q and the remainder
// normal, or all 0). The check and slow path of __fdiv_rn, which a 0 (a
// padding lane, a masked logit) takes, held a warp for most of the
// kernel's time.
__device__ __forceinline__ float div_rn(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  return __fmaf_rn(__fmaf_rn(-q, b, a), inv, q);
}

// Grid (kC, rows), clusters (kC, 1, 1), NT threads, NT * kL floats of
// dynamic shared memory.
__global__ void __launch_bounds__(kMaxThreads)
    top_p_kth_kernel(const float* __restrict__ sorted,
                     const float* __restrict__ top_p,
                     float* __restrict__ kth, int V, int per_cta) {
  extern __shared__ __align__(16) float buf[];
  __shared__ float red[kWarpsMax];
  __shared__ float mins[kWarpsMax];
  __shared__ float tot[kC], psum[kC], cmin[kC];
  // Every CTA of the cluster has started before any writes into another's
  // shared memory (the matching wait is before the first remote store).
  cluster_arrive();
  const int rank = cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const float* x = sorted + (long long)blockIdx.y * V;
  const float x0 = x[0];
  const float p = top_p[blockIdx.y];
  const int lo = min(V, rank * per_cta);
  const int n = min(V, lo + per_cta) - lo;       // this CTA's logits
  // Warp w stages [w 32 L, (w + 1) 32 L) of the slice: its own threads'.
  const int wlo = min(n, warp * 32 * kL);
  const int wn = min(n, wlo + 32 * kL) - wlo;
  for (int i = lane; i < wn; i += 32) buf[wlo + i] = x[lo + wlo + i];
  __syncwarp();
  // Pass 1: e_i, once, and the thread's sum in index order.
  const int mine = min(max(n - tid * kL, 0), kL);
  const float4* row4 = reinterpret_cast<const float4*>(buf + tid * kL);
  float e[kL];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kL / 4; ++q) {
    const float4 v = row4[q];
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * q + c;
      e[j] = j < mine ? expf(__fsub_rn(vs[c], x0)) : 0.f;
      s = __fadd_rn(s, e[j]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffff, s, d));
  if (lane == 0) red[warp] = s;
  __syncthreads();
  float cta_sum = red[0];
  for (int w = 1; w < nw; ++w) cta_sum = __fadd_rn(cta_sum, red[w]);
  cluster_wait();
  if (tid < kC) st_cluster(&tot[rank], tid, cta_sum);
  cluster_sync();
  float total = tot[0];
#pragma unroll
  for (int r = 1; r < kC; ++r) total = __fadd_rn(total, tot[r]);
  // Pass 2: prob_i, one division an element, and the thread's sum. A
  // thread with an e_i in (0, 2^-100) (logits 69 apart) divides as IEEE
  // does; in two loops, so the common one holds no slow path.
  bool tiny = false;
#pragma unroll
  for (int j = 0; j < kL; ++j) tiny |= e[j] != 0.f && e[j] < 0x1p-100f;
  if (tiny) {
#pragma unroll
    for (int j = 0; j < kL; ++j) e[j] = __fdiv_rn(e[j], total);
  } else {
    const float inv = __frcp_rn(total);
#pragma unroll
    for (int j = 0; j < kL; ++j) e[j] = div_rn(e[j], total, inv);
  }
  float q_t = 0.f;
#pragma unroll
  for (int j = 0; j < kL; ++j) q_t = __fadd_rn(q_t, e[j]);
  float inc = q_t;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(0xffffffff, inc, d);
    if (lane >= d) inc = __fadd_rn(inc, up);
  }
  float exc = __shfl_up_sync(0xffffffff, inc, 1);
  if (lane == 0) exc = 0.f;
  if (lane == 31) mins[warp] = inc;  // the warps' totals, for now
  __syncthreads();
  float before = 0.f, cta_prob = 0.f;
  for (int w = 0; w < nw; ++w) {
    if (w == warp) before = cta_prob;
    cta_prob = __fadd_rn(cta_prob, mins[w]);
  }
  if (tid > rank && tid < kC) st_cluster(&psum[rank], tid, cta_prob);
  cluster_sync();
  float prefix = 0.f;
  for (int r = 0; r < rank; ++r) prefix = __fadd_rn(prefix, psum[r]);
  // Pass 3: the running mass and the least logit still inside it.
  float cum = __fadd_rn(__fadd_rn(prefix, before), exc);
  float m = INFINITY;
#pragma unroll
  for (int q = 0; q < kL / 4; ++q) {
    const float4 v = row4[q];
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * q + c;
      cum = __fadd_rn(cum, e[j]);
      if (j < mine && !(__fsub_rn(cum, e[j]) >= p)) m = fminf(m, vs[c]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = fminf(m, __shfl_xor_sync(0xffffffff, m, d));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float k = red[0];
    for (int w = 1; w < nw; ++w) k = fminf(k, red[w]);
    st_cluster(&cmin[rank], 0, k);
  }
  cluster_sync();
  if (rank == 0 && tid == 0) {
    float k = cmin[0];
#pragma unroll
    for (int r = 1; r < kC; ++r) k = fminf(k, cmin[r]);
    kth[blockIdx.y] = k;
  }
}

}  // namespace

// sorted f32 [rows, V] (each row descending), top_p f32 [rows] (already
// clamped above 0) -> kth f32 [rows]. (per_cta, threads) from
// ops/top_p.top_p_plan(V): threads * 36 >= per_cta, 8 * per_cta >= V.
extern "C" int skypilot_top_p_kth(const void* sorted, const void* top_p,
                                  void* kth, int rows, int V, int per_cta,
                                  int threads, void* stream) {
  if (rows < 0 || rows > 65535 || V < 1 || per_cta < 1 ||
      (long long)kC * per_cta < V || threads < 32 || threads % 32 ||
      threads > kMaxThreads || threads * kL < per_cta)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  static unsigned long long attr_set = 0;  // devices already configured
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(
        top_p_kth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxThreads * kL * int(sizeof(float)));
    if (err != cudaSuccess) return err;
    attr_set |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC, rows);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = threads * kL * int(sizeof(float));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, top_p_kth_kernel,
                           static_cast<const float*>(sorted),
                           static_cast<const float*>(top_p),
                           static_cast<float*>(kth), V, per_cta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
