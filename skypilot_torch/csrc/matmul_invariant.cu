// The serving path's products for Hopper (sm_90a), made so that a row's
// bits do not depend on the rows it shares a call with.
//
// 1. skypilot_matmul_invariant(_q8): y[M, N] = x[M, K] @ w, x bf16, w
//    bf16 [K, N] (or, wt, the transposed view of an [N, K] matrix, the
//    tied LM head), or int8 codes [K, N] with one bf16 scale per output
//    column (_q8); f32 accumulation, bf16 out. The int8 form keeps the
//    JAX package's two rounding points (skypilot_tpu/models/llama.py
//    matmul): the product rounded to bf16, then times the scale in bf16;
//    the codes are widened to bf16 in shared memory (exact), so no bf16
//    copy of the weight is made.
// 2. skypilot_lora_mid + skypilot_lora_delta: the row-gathered LoRA delta
//    of mixed-adapter rows, (h @ A[slot]) @ B[slot] in f32
//    (models/decode.lora_gather_delta), in two launches.
//
// Neither replaces a TPU kernel: the JAX package leaves these products to
// XLA. They are a repair. cuBLAS picks its kernel, its K split and its
// reduction by the whole shape, so a row of the engine's decode (M = B),
// verify (M = B * W) and prefill chunk (M = the bucket) got other bits in
// each; a sampled or near-tied greedy token then depended on the batch.
//
// What bounds the GEMM on the H100: at decode (M = 8) and verify (M = 72)
// the weight's bytes (2 K N, 1 K N for int8) against 3.35 TB/s; at a
// 512-row prefill chunk the 2 M N K operations against 989 TFLOP/s,
// which only wgmma reaches.
//
// Design. A block owns a 64 NWG x 128 output tile: NWG consumer
// warpgroups (64 rows each) run wgmma m64n128k16 (bf16 -> f32) on a ring
// of stages that one thread of a producer warpgroup fills with TMA (x
// and the weight in the 128-byte swizzle; [K, N] weights are wgmma's
// MN-major B operand, the transposed head its K-major one; int8 codes
// arrive unswizzled and the consumers, with the producer's three other
// warps, widen them into a swizzled bf16 tile, fenced for the async
// proxy). NWG is 1 for M <= 64 (decode) and 2 above, so a verify call
// (M 72) is one m-tile and reads each weight byte once. Blocks walk the
// m-tiles fastest, so a prefill chunk reads each weight byte from HBM
// once.
//
// Invariance. Every M runs the same instruction (m64n128k16, one N width)
// and each output element takes its 16-wide k-steps in ascending order;
// buckets differ only in how many warpgroups a block has, and an
// element's wgmma result depends only on its own row of x and column of
// w. K is cut into segments of seg_tiles k-tiles, fixed by (N, K) alone
// (ops/matmul_invariant.py matmul_plan); each segment's partial starts
// from a fresh accumulator, and the partials are summed in one fixed
// two-level order: within each group of `group` consecutive segments in
// order, then the group sums in order. The segments run in one of two
// forms, chosen by M (the boundaries never are):
//   split  (run = 1): one block a segment (decode, verify: few m-tiles,
//          so K is spread over blocks to keep every SM's loads in
//          flight);
//   serial (run = group): one block a group, adding each segment's
//          partial to a running sum in registers, in order (a 512-row
//          prefill chunk: its m-tiles fill the card).
// The blocks of one output tile (at most 8) are one thread-block
// cluster: each leaves its partial in its own shared memory and, after a
// cluster barrier, sums a slice of the tile's rows from every block's
// partial over DSMEM in the fixed order; nothing goes to device memory
// but y. Both forms add the same f32 values in the same order, so a
// row's bits are the same at every M.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBN = 128;       // output columns a block (ops: MATMUL_BN)
constexpr int kBK = 64;        // k a stage, one swizzle atom (MATMUL_BK)
constexpr int kWgRows = 64;    // rows a consumer warpgroup owns
constexpr int kAtom = 128;     // bytes of one swizzle-atom row
constexpr int kWTile = kBK * kBN * 2;  // a stage's bf16 weight tile: 16 KB
constexpr int kCTile = kBK * kBN;      // a stage's int8 codes: 8 KB
constexpr int kMaxCluster = 8;         // blocks of a tile (ops: MATMUL_MAX_
                                       // SEGMENTS), the portable cluster

enum Form { kBf16 = 0, kBf16T = 1, kQ8 = 2 };

// Registers a thread after setmaxnreg at NWG 2 (3 warpgroups, 64512 in
// all): the running sum and the accumulator take 128 of a consumer's;
// the producer's helpers widen int8 codes.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// int8: the producer warpgroup's warps 1-3 help the consumers widen.
constexpr int kHelpers = 96;
static_assert(kHelpers == 96, "kWidenThreads counts three helper warps");

// Shared memory of one instantiation (bytes; tiles 1024-byte aligned). A
// stage: x (64 NWG rows x 64 k), then the bf16 weight tile, or for int8
// the codes; int8 widens each stage's codes into one of kWide bf16 tiles
// after the ring, in turn (a warpgroup's wgmma on k-tile kt - 2 is done
// once every consumer has passed k-tile kt's widening barrier, so three
// suffice). One block an SM, as many stages as fit: a decode call's
// weight bytes in flight. The producer is a warpgroup of its own (one
// thread issues every TMA load) so that, at NWG 2, it can hand its
// registers to the consumers (setmaxnreg).
constexpr int kWide = 3;

template <int NWG, int FORM>
struct Layout {
  static constexpr int kConsumers = NWG * 128;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kX = NWG * kWgRows * kAtom;
  static constexpr int kStage = kX + (FORM == kQ8 ? kCTile : kWTile);
  static constexpr int kWideBytes = FORM == kQ8 ? kWide * kWTile : 0;
  static constexpr int kStages = (200 * 1024 - kWideBytes) / kStage;
  static constexpr int kTx = kStage;
  static constexpr int kWideOff = kStages * kStage;
  static constexpr int kBarOff = kWideOff + kWideBytes;
  static constexpr int kLaunchBytes = kBarOff + 16 * kStages + 1024;
};

struct GemmArgs {
  const bf16* s;     // Q8: [N]
  bf16* y;           // [M, N], row stride ldy
  long long ldy;
  int M, N, K;
  int seg_tiles;     // k-tiles a segment
  int n_segs;        // segments of K
  int group;         // segments a group
  int run;           // segments a block: 1 (split) or group (serial)
};

// The int8 widening barrier: the consumers and the producer's helpers.
__device__ __forceinline__ void widen_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Every consumer thread (n of them), and no producer thread.
__device__ __forceinline__ void consumer_sync(int n) {
  asm volatile("bar.sync 2, %0;\n" ::"r"(n) : "memory");
}

// 4 bytes global -> shared, asynchronously: a thread issues all of its
// copies before one wait, so a staging costs one round trip.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// 4 int8 codes (one word) -> 2 bf16x2, exactly: byte u = code ^ 0x80 =
// code + 128 becomes (one byte permute) the f32 2^23 + u, minus 2^23 +
// 128; an integer of at most 8 significant bits keeps its value in the
// top 16 bits.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __float_as_uint(__fsub_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + e)),
        8388736.f));
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// The stage's codes [64 k][128 n] (128-byte rows) -> two swizzled bf16
// atoms [64 k][64 n], the layout TMA gives a bf16 [K, N] weight; this
// thread's share (`idx` of `n` >= kWidenThreads threads), every 16-code
// load issued before the first convert.
constexpr int kWidenThreads = 128 + 96;  // NWG 1: consumers + helpers
constexpr int kWidenItems = (kCTile / 16 + kWidenThreads - 1) / kWidenThreads;

__device__ __forceinline__ void widen_stage(const uint8_t* codes,
                                            uint8_t* wide, int idx, int n) {
  uint4 raw[kWidenItems];
#pragma unroll
  for (int q = 0; q < kWidenItems; ++q) {
    const int i = idx + q * n;
    if (i < kCTile / 16)
      raw[q] = *reinterpret_cast<const uint4*>(codes + (i >> 3) * 128 +
                                               (i & 7) * 16);
  }
#pragma unroll
  for (int q = 0; q < kWidenItems; ++q) {
    const int i = idx + q * n;
    if (i >= kCTile / 16) break;
    const int k = i >> 3, j = i & 7;
    uint4 a, b;
    widen4(raw[q].x, a.x, a.y);
    widen4(raw[q].y, a.z, a.w);
    widen4(raw[q].z, b.x, b.y);
    widen4(raw[q].w, b.z, b.w);
    uint8_t* row = wide + (j >> 2) * (kWTile / 2) + k * kAtom;
    const int c0 = 2 * (j & 3);
    *reinterpret_cast<uint4*>(row + ((c0 ^ (k & 7)) << 4)) = a;
    *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (k & 7)) << 4)) = b;
  }
}

// Every thread of every block of the cluster: release this block's
// shared-memory writes, acquire the others'.
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// 16 bytes at the same shared-memory offset in block `rank` of the
// cluster.
__device__ __forceinline__ float4 ld_cluster4(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(sm90::smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 add4(float4 p, float4 q) {
  return make_float4(__fadd_rn(p.x, q.x), __fadd_rn(p.y, q.y),
                     __fadd_rn(p.z, q.z), __fadd_rn(p.w, q.w));
}

// y[row][col, col + 1] from the f32 sums.
template <int FORM>
__device__ __forceinline__ void store_pair(const GemmArgs& a, long long row,
                                           int col, float v0, float v1) {
  if (FORM == kQ8) {
    // (x @ codes) rounded to bf16, then times the bf16 scale (the product
    // of two bf16 is exact in f32), rounded once more.
    v0 = __bfloat162float(__float2bfloat16_rn(v0)) *
         __bfloat162float(a.s[col]);
    v1 = __bfloat162float(__float2bfloat16_rn(v1)) *
         __bfloat162float(a.s[col + 1]);
  }
  *reinterpret_cast<__nv_bfloat162*>(a.y + row * a.ldy + col) =
      __floats2bfloat162_rn(v0, v1);
}

// The tile's blocks (one cluster, rank z holding the partial of its
// segments) sum their partials: each block's consumers have left theirs
// in the idle stage ring ([rows][kMergeStride] f32); every block sums
// its slice of the rows over all ranks in the fixed order (each group's
// blocks in order, then the groups) and stores y. The consumers call it;
// the producer warpgroup meets its two cluster barriers on its own.
constexpr int kMergeStride = kBN + 4;  // floats; staggers the banks

template <int NWG, int FORM>
__device__ __forceinline__ void matmul_merge(const GemmArgs& a, uint8_t* smem,
                                             int m0, int n0) {
  using L = Layout<NWG, FORM>;
  const float* stage = reinterpret_cast<const float*>(smem);
  const int tid = threadIdx.x;
  cluster_sync();  // every block's partial is in place
  const int blocks = gridDim.z, rank = cluster_rank();
  const int per_group = a.group / a.run;
  const int tile_rows = min(NWG * kWgRows, a.M - m0);
  const int per = (tile_rows + blocks - 1) / blocks;
  const int rb = rank * per, re = min(tile_rows, rb + per);
  constexpr int kQuads = kBN / 4;
  {
    for (int i = tid; i < (re - rb) * kQuads; i += L::kConsumers) {
      const int r = rb + i / kQuads, c = (i % kQuads) * 4;
      if (n0 + c >= a.N) continue;
      const float* p = stage + r * kMergeStride + c;
      float4 v[8];
#pragma unroll
      for (int z = 0; z < 8; ++z)
        if (z < blocks) v[z] = ld_cluster4(p, z);
      float4 total = make_float4(0.f, 0.f, 0.f, 0.f), gs = total;
#pragma unroll
      for (int z = 0; z < 8; ++z) {
        if (z >= blocks) break;
        gs = z % per_group == 0 ? v[z] : add4(gs, v[z]);
        if (z % per_group == per_group - 1)
          total = z < per_group ? gs : add4(total, gs);
      }
      store_pair<FORM>(a, m0 + r, n0 + c, total.x, total.y);
      store_pair<FORM>(a, m0 + r, n0 + c + 2, total.z, total.w);
    }
  }
  cluster_sync();  // no block leaves while another reads its partial
}

// Grid (m_tiles, n_tiles, n_segs / run), clusters (1, 1, n_segs / run):
// the m-tiles of a weight tile run side by side, so a prefill chunk
// reads each weight byte from HBM once (its other m-tiles find it in
// L2).
template <int NWG, int FORM>
__global__ void __launch_bounds__(Layout<NWG, FORM>::kThreads, 1)
    matmul_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const GemmArgs a) {
  using L = Layout<NWG, FORM>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + S;

  const int m0 = blockIdx.x * NWG * kWgRows, n0 = blockIdx.y * kBN;
  const int k_tiles = (a.K + kBK - 1) / kBK;
  const int seg0 = blockIdx.z * a.run;
  const int kt0 = seg0 * a.seg_tiles;
  const int kt1 = min(k_tiles, (seg0 + a.run) * a.seg_tiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NWG * 4);  // one arrival a consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {
    // ------------------------------ producer ---------------------------
    if (NWG == 2) sm90::setmaxnreg_dec<kProducerRegs>();
    const int ptid = threadIdx.x - L::kConsumers;
    if (FORM == kQ8 && ptid >= 32) {
      // Helpers: their share of every k-tile's widening, in the
      // consumers' order and barrier.
      for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
        const int s = it % S;
        sm90::mbar_wait(&full[s], (it / S) & 1);
        widen_stage(smem + s * L::kStage + L::kX,
                    smem + L::kWideOff + (it % kWide) * kWTile,
                    L::kConsumers + ptid - 32, L::kConsumers + kHelpers);
        sm90::fence_proxy_async();
        widen_sync(L::kConsumers + kHelpers);
      }
    }
    if (threadIdx.x == L::kConsumers) {
      sm90::prefetch_tensormap(&xmap);
      sm90::prefetch_tensormap(&wmap);
      for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
        const int s = it % S, n = it / S;
        if (n > 0) sm90::mbar_wait(&empty[s], (n - 1) & 1);
        uint8_t* st = smem + s * L::kStage;
        sm90::mbar_arrive_expect_tx(&full[s], L::kTx);
        sm90::tma_load_2d(st, &xmap, &full[s], kt * kBK, m0);
        if (FORM == kBf16) {
          sm90::tma_load_2d(st + L::kX, &wmap, &full[s], n0, kt * kBK);
          sm90::tma_load_2d(st + L::kX + kWTile / 2, &wmap, &full[s],
                            n0 + 64, kt * kBK);
        } else if (FORM == kBf16T) {
          sm90::tma_load_2d(st + L::kX, &wmap, &full[s], kt * kBK, n0);
        } else {
          sm90::tma_load_2d(st + L::kX, &wmap, &full[s], n0, kt * kBK);
        }
      }
    }
    if (gridDim.z > 1) {
      // The merge's two cluster barriers; the producer has no part in it
      // otherwise (and too few registers for it after setmaxnreg).
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ------------------------------ consumers ----------------------------
  if (NWG == 2) sm90::setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  float acc[kBN / 2];
  float sum[kBN / 2];
  int it = 0;
  for (int seg = 0; seg < a.run; ++seg) {
    const int sb = kt0 + seg * a.seg_tiles;
    const int se = min(kt1, sb + a.seg_tiles);
    int held = -1;  // the stage whose wgmma may still be running
    for (int kt = sb; kt < se; ++kt, ++it) {
      const int s = it % S;
      uint8_t* st = smem + s * L::kStage;
      sm90::mbar_wait(&full[s], (it / S) & 1);
      uint8_t* wt = st + L::kX;  // the bf16 weight tile wgmma reads
      if (FORM == kQ8) {
        wt = smem + L::kWideOff + (it % kWide) * kWTile;
        widen_stage(st + L::kX, wt, tid, L::kConsumers + kHelpers);
        sm90::fence_proxy_async();
        widen_sync(L::kConsumers + kHelpers);
      }
      const uint64_t da =
          sm90::make_desc(st + wg * kWgRows * kAtom, 16, 1024);
      const uint64_t db = FORM == kBf16T
                              ? sm90::make_desc(wt, 16, 1024)
                              : sm90::make_desc(wt, kWTile / 2, 1024);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const int first = kt == sb && kk == 0;
        if (FORM == kBf16T)
          sm90::wgmma_ss<kBN>(acc, da + ((kk * 32) >> 4),
                              db + ((kk * 32) >> 4), !first);
        else
          sm90::wgmma_ss_mn<kBN>(acc, da + ((kk * 32) >> 4),
                                 db + ((kk * 16 * kAtom) >> 4), !first);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (held >= 0 && lane == 0) sm90::mbar_arrive(&empty[held]);
      held = s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(&empty[held]);
    // This block's segments in order: the group's running sum.
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      sum[i] = seg == 0 ? acc[i] : __fadd_rn(sum[i], acc[i]);
  }

  // Accumulator layout: sum[4j + e] is row 16 warp + g + 8 (e / 2),
  // column 8j + 2t + (e % 2) of this warpgroup's 64 x 128.
  const int g = lane / 4, t = lane % 4;
  if (gridDim.z > 1) {
    // This block's partial into the idle ring, for the cluster's merge.
    // The ring is idle only once every consumer warpgroup's last wgmma
    // has read its stages: at NWG 2 the partials of one warpgroup's rows
    // cover stages the other may still be reading.
    consumer_sync(L::kConsumers);
    float* stage = reinterpret_cast<float*>(smem);
    sm90::fence_proxy_async();  // the ring was last written by TMA
    const int r0 = wg * kWgRows + warp * 16 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        *reinterpret_cast<float2*>(stage + (r0 + 8 * h) * kMergeStride +
                                   8 * j + 2 * t) =
            make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
    matmul_merge<NWG, FORM>(a, smem, m0, n0);
    return;
  }
  const int row0 = m0 + wg * kWgRows + warp * 16 + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= a.M) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= a.N) continue;
      store_pair<FORM>(a, row, col, sum[4 * j + 2 * h],
                       sum[4 * j + 2 * h + 1]);
    }
  }
}

template <int NWG, int FORM>
cudaError_t launch_matmul(const CUtensorMap& xmap, const CUtensorMap& wmap,
                          const GemmArgs& a, dim3 grid, cudaStream_t stream) {
  using L = Layout<NWG, FORM>;
  static_assert(L::kLaunchBytes <= 232448, "shared memory of a block");
  auto kernel = matmul_kernel<NWG, FORM>;
  static unsigned long long attr_set = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kLaunchBytes);
    if (err != cudaSuccess) return err;
    attr_set |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kLaunchBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;  // a tile of one block: no cluster
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int matmul(const void* x, long long ldx, const void* wmap, const void* s,
           void* y, int M, int N, int K, long long ldy, int seg_tiles,
           int n_segs, int group, int run, int nwg, int form, void* stream) {
  const int k_tiles = (K + kBK - 1) / kBK;
  const int m_tiles = (M + nwg * kWgRows - 1) / (nwg * kWgRows);
  const int blocks = n_segs / (run > 0 ? run : 1);
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8 || ldx % 8 || ldx < K ||
      ldy % 2 || ldy < N || (nwg != 1 && nwg != 2) || seg_tiles < 1 ||
      n_segs < 1 || group < 1 || n_segs % group ||
      (run != 1 && run != group) ||
      (long long)(n_segs - 1) * seg_tiles >= k_tiles ||
      (long long)n_segs * seg_tiles < k_tiles || blocks > kMaxCluster ||
      (N + kBN - 1) / kBN > 65535 ||
      (form == kQ8 && N % 16) || wmap == nullptr)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wm;
  memcpy(&wm, wmap, sizeof(wm));
  cudaError_t err = sm90::make_map_2d(&xmap, x, false, K, M, ldx * 2, kBK,
                                      nwg * kWgRows, true);
  if (err != cudaSuccess) return err;
  GemmArgs a{};
  a.s = static_cast<const bf16*>(s);
  a.y = static_cast<bf16*>(y);
  a.ldy = ldy;
  a.M = M;
  a.N = N;
  a.K = K;
  a.seg_tiles = seg_tiles;
  a.n_segs = n_segs;
  a.group = group;
  a.run = run;
  const dim3 grid(m_tiles, (N + kBN - 1) / kBN, blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nwg == 1) {
    if (form == kQ8) return launch_matmul<1, kQ8>(xmap, wm, a, grid, st);
    if (form == kBf16T) return launch_matmul<1, kBf16T>(xmap, wm, a, grid, st);
    return launch_matmul<1, kBf16>(xmap, wm, a, grid, st);
  }
  if (form == kQ8) return launch_matmul<2, kQ8>(xmap, wm, a, grid, st);
  if (form == kBf16T) return launch_matmul<2, kBf16T>(xmap, wm, a, grid, st);
  return launch_matmul<2, kBf16>(xmap, wm, a, grid, st);
}

// ---------------------------------------------------------------------
// The gathered LoRA delta, in f32, in two launches. What bounds it: the
// bytes of h, of each distinct slot's A and B, and of the delta; its
// operations are few (2 R (d + out) a row), so its time is round trips.
// Each of a row's sums is made once, and a block stages every distinct
// slot of its rows in one round trip (cp.async, all copies in flight)
// and reads it once for all of the rows that use it.
//   mid: blocks (d-chunk of kLoraChunk, group of kLoraRows rows): the
//        chunk's partial of mid[row][r] = sum_d h[row][d] A[slot][d][r]
//        as four chains (d = j mod 4, ascending) added (0 + 1) + (2 + 3).
//   out: blocks (kLoraCols columns, group of kLoraOutRows rows): mid
//        from the chunks' partials in chunk order, then out[row][n] =
//        sum_r mid[row][r] B[slot][r][n], r ascending. It is launched as
//        mid's programmatic dependent: its slot lookup and B staging run
//        while mid does, and it waits for mid's partials only.
// Every order is set by (d, R); no row's sums see another row. Slot 0
// (all zeros) gives +0 exactly, as the plain version does.
// ---------------------------------------------------------------------

constexpr int kLoraMaxRank = 64;
constexpr int kLoraChunk = 128;
constexpr int kLoraRows = 16;
constexpr int kLoraThreads = 256;
constexpr int kLoraCols = 128;
constexpr int kLoraOutRows = 16;
// Shared floats of the staged factors: every distinct slot of a block
// whose chunk fits is staged in one round trip.
constexpr int kLoraStage = kLoraChunk * kLoraMaxRank;
static_assert(kLoraCols * kLoraMaxRank == kLoraStage, "one staging size");

// The distinct slots of a block's rows in order of first use (uniq, n),
// and each row's index among them (-1 past the last row): every row's
// slot loaded at once into of_row, then thread 0 ranks them. Ends with
// the block synchronised.
__device__ __forceinline__ void distinct_slots(const int* slot_of, int r0,
                                               int nr, int T, int* uniq,
                                               int* of_row, int* n_uniq,
                                               int rows_max) {
  const int tid = threadIdx.x;
  if (tid < rows_max) of_row[tid] = tid < nr ? slot_of[(r0 + tid) / T] : -1;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int r = 0; r < nr; ++r) {
      const int slot = of_row[r];
      int u = 0;
      while (u < n && uniq[u] != slot) ++u;
      if (u == n) uniq[n++] = slot;
      of_row[r] = u;
    }
    *n_uniq = n;
  }
  __syncthreads();
}

// part f32 [rows, n_chunks, R].
__global__ void __launch_bounds__(kLoraThreads)
    lora_mid_kernel(const bf16* __restrict__ h,
                    const int* __restrict__ slot_of,
                    const float* __restrict__ a_slots,
                    float* __restrict__ part, int rows, int T, int D,
                    int R) {
  __shared__ __align__(16) bf16 hs[kLoraRows][kLoraChunk];
  __shared__ __align__(16) float as[kLoraStage];
  __shared__ int uniq[kLoraRows], of_row[kLoraRows], n_uniq;
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int d0 = chunk * kLoraChunk;
  const int dc = min(kLoraChunk, D - d0);
  const int r0 = blockIdx.y * kLoraRows;
  const int nr = min(kLoraRows, rows - r0);
  // Let the out kernel start its own staging now.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // The rows' chunk of h (bf16 pairs; D is even), in flight while the
  // slots are read.
  for (int i = tid; i < nr * (kLoraChunk / 2); i += kLoraThreads) {
    const int r = i / (kLoraChunk / 2), d = 2 * (i % (kLoraChunk / 2));
    if (d < dc) cp_async4(&hs[r][d], h + (long long)(r0 + r) * D + d0 + d);
  }
  distinct_slots(slot_of, r0, nr, T, uniq, of_row, &n_uniq, kLoraRows);
  // As many slots' A chunks a pass as fit.
  const int per = kLoraStage / (dc * R);
  for (int u0 = 0; u0 < n_uniq; u0 += per) {
    const int cnt = min(per, n_uniq - u0);
    for (int u = 0; u < cnt; ++u) {
      const float* src = a_slots + ((long long)uniq[u0 + u] * D + d0) * R;
      for (int e = tid; e < dc * R; e += kLoraThreads)
        cp_async4(&as[u * dc * R + e], src + e);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int item = tid; item < kLoraRows * R; item += kLoraThreads) {
      const int r = item / R, c = item % R;
      const int u = of_row[r] - u0;
      if (u < 0 || u >= cnt) continue;
      const float* A = as + u * dc * R + c;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      int d = 0;
      for (; d + 4 <= dc; d += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[j] = __fadd_rn(s[j], __fmul_rn(__bfloat162float(hs[r][d + j]),
                                           A[(d + j) * R]));
      }
      for (int j = 0; d < dc; ++d, ++j)
        s[j] = __fadd_rn(s[j], __fmul_rn(__bfloat162float(hs[r][d]),
                                         A[d * R]));
      part[((long long)(r0 + r) * n_chunks + chunk) * R + c] =
          __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
    }
    __syncthreads();
  }
}

// Dynamic shared memory: the group's chunk partials [kLoraOutRows,
// n_chunks, R] (the wrapper sizes it).
__global__ void __launch_bounds__(kLoraCols)
    lora_out_kernel(const float* __restrict__ part,
                    const int* __restrict__ slot_of,
                    const float* __restrict__ b_slots,
                    float* __restrict__ out, int rows, int T, int n_chunks,
                    int R, int n_out) {
  extern __shared__ __align__(16) float ps[];
  __shared__ float ms[kLoraOutRows * kLoraMaxRank];
  __shared__ __align__(16) float bs[kLoraStage];
  __shared__ int uniq[kLoraOutRows], of_row[kLoraOutRows], n_uniq;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kLoraCols;
  const int nc = min(kLoraCols, n_out - n0);
  const int r0 = blockIdx.y * kLoraOutRows;
  const int nr = min(kLoraOutRows, rows - r0);
  distinct_slots(slot_of, r0, nr, T, uniq, of_row, &n_uniq, kLoraOutRows);
  // As many slots' columns of B a pass as fit.
  const int per = kLoraMaxRank / R;
  for (int u0 = 0; u0 < n_uniq; u0 += per) {
    const int cnt = min(per, n_uniq - u0);
    for (int ur = 0; ur < cnt * R; ++ur) {
      const float* b = b_slots +
                       ((long long)uniq[u0 + ur / R] * R + ur % R) * n_out +
                       n0;
      if (tid < nc) cp_async4(&bs[ur * kLoraCols + tid], b + tid);
    }
    if (u0 == 0) {
      // mid's partials: only now is the mid kernel waited for.
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      const float* src = part + (long long)r0 * n_chunks * R;
      for (int i = tid; i < nr * n_chunks * R; i += kLoraCols)
        cp_async4(&ps[i], src + i);
    }
    cp_async_wait_all();
    __syncthreads();
    if (u0 == 0) {
      // mid: each row's chunks in order.
      for (int item = tid; item < nr * R; item += kLoraCols) {
        const float* p = ps + (item / R) * n_chunks * R + item % R;
        float m = p[0];
        for (int k = 1; k < n_chunks; ++k) m = __fadd_rn(m, p[k * R]);
        ms[item] = m;
      }
      __syncthreads();
    }
    if (tid < nc) {
#pragma unroll 4
      for (int row = 0; row < nr; ++row) {
        const int u = of_row[row] - u0;
        if (u < 0 || u >= cnt) continue;
        const float* B = bs + u * R * kLoraCols + tid;
        float o = 0.f;
        for (int r = 0; r < R; ++r)
          o = __fadd_rn(o, __fmul_rn(ms[row * R + r], B[r * kLoraCols]));
        out[(long long)(r0 + row) * n_out + n0 + tid] = o;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// The 2-D tensor map of a bf16 ([K, N] or the [N, K] of a transposed
// head) or uint8 (int8 codes [K, N]) weight, into the 128 bytes at `out`:
// the wrapper keeps one per weight. form: 0 bf16 [K, N], 1 bf16 [N, K]
// read transposed, 2 int8 [K, N]; ld: the row stride in elements.
extern "C" int skypilot_matmul_weight_map(void* out, const void* w, int K,
                                          int N, long long ld, int form) {
  if (out == nullptr || w == nullptr || K < 8 || N < 8 || form < 0 ||
      form > 2)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err;
  if (form == kBf16)
    err = sm90::make_map_2d(&map, w, false, N, K, ld * 2, 64, kBK, true);
  else if (form == kBf16T)
    err = sm90::make_map_2d(&map, w, false, K, N, ld * 2, kBK, kBN, true);
  else
    err = sm90::make_map_2d(&map, w, true, N, K, ld, kBN, kBK, false);
  if (err == cudaSuccess) memcpy(out, &map, sizeof(map));
  return err;
}

extern "C" int skypilot_matmul_map_bytes() { return sizeof(CUtensorMap); }

// Clusters of `size` blocks of the (nwg, form) instantiation the card
// holds at once (cudaOccupancyMaxActiveClusters); < 0: a CUDA error.
extern "C" int skypilot_matmul_max_clusters(int nwg, int form, int size) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = size;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(1, 1, size);
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define SKY_MAX_CLUSTERS(W, F)                                            \
  if (nwg == W && form == F) {                                            \
    using L = Layout<W, F>;                                               \
    cfg.blockDim = dim3(L::kThreads);                                     \
    cfg.dynamicSmemBytes = L::kLaunchBytes;                               \
    err = cudaFuncSetAttribute(matmul_kernel<W, F>,                       \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               L::kLaunchBytes);                          \
    if (err == cudaSuccess)                                               \
      err = cudaOccupancyMaxActiveClusters(&n, matmul_kernel<W, F>, &cfg); \
  }
  SKY_MAX_CLUSTERS(1, kBf16)
  SKY_MAX_CLUSTERS(1, kBf16T)
  SKY_MAX_CLUSTERS(1, kQ8)
  SKY_MAX_CLUSTERS(2, kBf16)
  SKY_MAX_CLUSTERS(2, kBf16T)
  SKY_MAX_CLUSTERS(2, kQ8)
#undef SKY_MAX_CLUSTERS
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

extern "C" int skypilot_matmul_invariant(const void* x, long long ldx,
                                         const void* wmap, void* y, int M,
                                         int N, int K, long long ldy,
                                         int seg_tiles, int n_segs, int group,
                                         int run, int nwg, int wt,
                                         void* stream) {
  return matmul(x, ldx, wmap, nullptr, y, M, N, K, ldy, seg_tiles, n_segs,
                group, run, nwg, wt ? kBf16T : kBf16, stream);
}

extern "C" int skypilot_matmul_invariant_q8(
    const void* x, long long ldx, const void* wmap, const void* scale,
    void* y, int M, int N, int K, long long ldy, int seg_tiles, int n_segs,
    int group, int run, int nwg, void* stream) {
  return matmul(x, ldx, wmap, scale, y, M, N, K, ldy, seg_tiles, n_segs,
                group, run, nwg, kQ8, stream);
}

// h bf16 [rows, D] contiguous (rows = B * T, D even); slots int32 [B];
// a_slots f32 [C+1, D, R]; part f32 [rows, ceil(D / kLoraChunk), R].
extern "C" int skypilot_lora_mid(const void* h, const void* slots,
                                 const void* a_slots, void* part, int rows,
                                 int T, int D, int R, void* stream) {
  if (rows < 1 || T < 1 || rows % T || D < 2 || D % 2 || R < 1 ||
      R > kLoraMaxRank || (rows + kLoraRows - 1) / kLoraRows > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((D + kLoraChunk - 1) / kLoraChunk,
                  (rows + kLoraRows - 1) / kLoraRows);
  lora_mid_kernel<<<grid, kLoraThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const int*>(slots),
      static_cast<const float*>(a_slots), static_cast<float*>(part), rows, T,
      D, R);
  return cudaGetLastError();
}

// part as skypilot_lora_mid's; b_slots f32 [C+1, R, n_out]; out f32
// [rows, n_out].
extern "C" int skypilot_lora_delta(const void* part, const void* slots,
                                   const void* b_slots, void* out, int rows,
                                   int T, int D, int R, int n_out,
                                   void* stream) {
  const int n_chunks = (D + kLoraChunk - 1) / kLoraChunk;
  const int smem = kLoraOutRows * n_chunks * R * 4;
  // Static: the rows' mid and B's staged columns (40 KB).
  if (rows < 1 || T < 1 || rows % T || D < 1 || R < 1 || R > kLoraMaxRank ||
      n_out < 1 || (rows + kLoraOutRows - 1) / kLoraOutRows > 65535 ||
      smem > 232448 - 48 * 1024)
    return cudaErrorInvalidValue;
  static unsigned long long attr_set = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(lora_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448 - 48 * 1024);
    if (err != cudaSuccess) return err;
    attr_set |= bit;
  }
  const dim3 grid((n_out + kLoraCols - 1) / kLoraCols,
                  (rows + kLoraOutRows - 1) / kLoraOutRows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kLoraCols);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lora_out_kernel,
                           static_cast<const float*>(part),
                           static_cast<const int*>(slots),
                           static_cast<const float*>(b_slots),
                           static_cast<float*>(out), rows, T, n_chunks, R,
                           n_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
