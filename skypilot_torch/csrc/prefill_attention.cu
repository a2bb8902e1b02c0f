// K4-prefill for Hopper (sm_90a): the attention of the serving engine's
// prefill chunk, and of a dense cache's chunk after earlier positions.
//
// With K4 (decode_attention.cu) it replaces the TPU kernel
// skypilot_tpu/ops/decode_attention.py: _decode_attn_kernel, in the form
// the port's engine needs for a chunk: what skypilot_tpu/models/decode.py
// forward_paged computes around it (paged_gather + _dequant_kv + the int8
// splice + _masked_attention). Contract: q [B, T, Hq, hd]; query j of row
// b attends keys [0, lengths[b] + j) (clamped to S: K4's span_of), so it
// sits at position start = lengths[b] - 1 plus j. Keys come from the
// cache: a bf16 dense [B, S, Hkv, hd] read through strides, or one
// layer's flat pool [N, Hkv, hd] read through the row's block table
// [B, MB] (S = MB * bs), the chunk's own rows written there first; or an
// int8 pool of codes with one bf16 scale per (row, kv head), dequantized
// as _dequant_kv does (code * scale, exact in f32, rounded once to bf16),
// with the chunk's exact bf16 rows k_new / v_new [B, T, Hkv, hd] for keys
// from start on (the JAX int8 splice). Out [B, T, Hq, hd] bf16.
//
// The bit contract. A query row's arithmetic is K4's, op for op (the
// shared code of decode_common.cuh): the constant 256-key splits, each
// 64-key tile's four 16-key slices with their own online softmax, the
// slice merge in slice order, the split merge in split order. So a bf16
// prefill row is bit-equal to K4-paged's decode step (W = 1) at the same
// position over the same pool, at any T, start, bucket or padding; an int8
// row is bit-equal to the bf16 form over a bf16 pool holding the
// dequantized codes (widened into bf16 tiles in natural head-dim order,
// not K4-Q8's permuted operand order).
//
// What bounds it on the H100. At T 512, G 4 a kv head has 2048 query rows
// over ~1100 keys: 4 * hd FLOPs per (row, key) against 4 * hd bytes per
// key, far above the card's balance point once a key tile serves many
// rows. K4's W = T form served 16 rows per read of a tile (each pass
// re-read its split's keys, ~0.5 GB of L2 traffic a call) and sent every
// (split, row) partial through device memory, merged by a last block.
// What is left is the slice structure the bits require: an online softmax
// per 16 keys on mma.sync, far less work per softmax step than a flash
// kernel's, with every K, V and P fragment through ldmatrix per 16-row
// m-tile (shared memory bandwidth). This kernel:
//
// 1. One block per (kv head, 3 m-tiles of 16 query rows), four warps an
//    m-tile, all reading one ring of K/V tiles: a tile is read once per
//    48 rows. Tiles wholly past an m-tile's last key are skipped (they
//    would add exactly nothing). Blocks with the longest rows launch first.
// 2. Warp w of an m-tile runs slice w's scores and softmax and hands its P
//    fragments and rescale factors to the m-tile's four warps (shared
//    memory, one named barrier a tile); each warp keeps all four slices'
//    accumulators for a quarter of the head's columns, so a split's slice
//    merge happens in registers, element by element as K4 merges them.
// 3. The split merge weights a split by exp2(m_i - M) with the row's
//    final max M, known only after the row's last split. Each split's
//    merged partial (16 rows x hd f32 an m-tile) goes to a scratch in
//    device memory (L2 at the engine's shapes) and its max to shared
//    memory; each row's (M, L) is kept online; the splits are folded in
//    split order at the end. bf16 keeps q's fragments in registers.
// 4. Tiles arrive by cp.async (each 16-byte chunk from its source: the
//    pool through the block's span of the table staged in shared memory,
//    the chunk's rows, or zeros past the block's last key) into 128-byte
//    swizzled rows; int8 code rows and their scale words land in staging
//    and are widened into the tile once.
// 5. The grid and the shared memory come from shapes alone (T, Hkv, G, hd,
//    the table's width), never from lengths: a CUDA graph can hold a call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace decode_common;

constexpr int kMT = 3;  // m-tiles of 16 query rows a block
constexpr int kGroup = kSlices * 32;  // threads of one m-tile
constexpr int kThreads = kMT * kGroup;
constexpr int kMaxSmem = 232448;

// K/V tiles in the ring (deeper rings measured no faster on the H100).
__host__ __device__ constexpr int stages(bool q8) { return q8 ? 3 : 2; }

struct PrefillArgs {
  const bf16* q;           // [B, T, Hq, hd]
  const uint8_t* k;        // cache keys (bf16 or int8 codes)
  const uint8_t* v;
  const uint8_t* k_scale;  // int8: bf16 scales [N, Hkv]
  const uint8_t* v_scale;
  const bf16* k_new;       // [B, T, Hkv, hd], or null
  const bf16* v_new;
  const int* lengths;      // [B]: start + 1, start >= 0
  const int* table;        // [B, MB] (paged)
  bf16* out;               // [B, T, Hq, hd]
  float* part;             // the splits' partials (prefill_layout)
  long long k_sb, k_ss;    // K's and V's strides in elements (paged: ss)
  int T, S, Hkv, MB, bs_log2, n_pages, chunk, n_split;
  float scale_log2;
};

// Shared memory, from a 1024-byte aligned base: the K/V stages, the
// m-tiles' q tiles, (int8) the code staging, the P fragments and
// rescale factors each slice hands its m-tile's warps (two buffers), the
// slices' (m, l) at a split's end, each split's max per row, the block's
// page entries. Mirrored by ops/decode_attention.py prefill_smem_bytes.
// The splits' partials go to device memory (L2 at the engine's shapes):
// per (block, m-tile, split) 16 rows x hd f32, slot j of thread i at
// j * 128 + i.
struct Layout {
  int q, codes, code_stage, pfrag, alpha, ml, msplit, table, total;
};

__host__ __device__ inline Layout prefill_layout(int hd, bool q8, int mb,
                                                 int n_split) {
  Layout L;
  L.q = stages(q8) * 2 * kTile * hd * 2;
  L.codes = L.q + kMT * 16 * hd * 2;
  L.code_stage = q8 ? 2 * kTile * hd + 2 * kTile * 4 : 0;
  L.pfrag = L.codes + stages(q8) * L.code_stage;
  L.alpha = L.pfrag + kMT * 2 * kSlices * 32 * 16;
  L.ml = L.alpha + kMT * 2 * kSlices * 16 * 4;
  L.msplit = L.ml + kMT * kSlices * 16 * 2 * 4;
  L.table = L.msplit + kMT * n_split * 16 * 4;
  L.total = L.table + mb * 4;
  return L;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 128 threads of m-tile `mi` (named barrier 1 + mi).
__device__ __forceinline__ void group_sync(int mi) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + mi), "r"(kGroup) : "memory");
}

template <int HD, int G, bool PAGED, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
    prefill_kernel(const __grid_constant__ PrefillArgs a) {
  static_assert(HD == 64 || HD == 128, "head_dim");
  static_assert(PAGED || !Q8, "int8 caches are paged");
  constexpr int KV_TILE = kTile * HD * 2;
  constexpr int C8 = HD / 8;    // 16-byte chunks of a bf16 row
  constexpr int C16 = HD / 16;  // 16-byte chunks of an int8 code row
  // A warp's P V columns: HD / 4, NDN blocks of 16, NB of 8.
  constexpr int NDN = HD / 64, NB = 2 * NDN;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int R = a.T * G;  // query rows of this kv head
  const int n_mt = (R + 15) / 16;
  const int mt0 = (gridDim.x - 1 - blockIdx.x) * kMT;  // longest rows first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = warp / kSlices, sl = warp % kSlices;
  const int mt = mt0 + mi;
  const int len = a.lengths[b], start = len - 1;
  const int Hq = a.Hkv * G;
  auto row_span = [&](int qi) {
    return qi < R ? span_of(len, qi / G, a.S) : 0;
  };
  const int mt_tiles =
      mt < n_mt ? (row_span(min(R, (mt + 1) * 16) - 1) + kTile - 1) / kTile
                : 0;
  const int blk_span = row_span(min(R, (mt0 + kMT) * 16) - 1);
  const int n_tiles = (blk_span + kTile - 1) / kTile;
  const int split_tiles = a.chunk / kTile;
  // Keys from here on come from the chunk's own rows.
  const int cut = a.k_new != nullptr ? start : INT_MAX;
  const int n_cache = min(cut, blk_span);  // keys read from the cache

  const Layout L = prefill_layout(HD, Q8, PAGED ? a.MB : 0, a.n_split);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t smem_s = sm90::smem_u32(smem);
  uint4* pfrag = reinterpret_cast<uint4*>(smem + L.pfrag) +
                 mi * 2 * kSlices * 32;
  float* alpha_x = reinterpret_cast<float*>(smem + L.alpha) +
                   mi * 2 * kSlices * 16;
  float* ml = reinterpret_cast<float*>(smem + L.ml) + mi * kSlices * 16 * 2;
  float* msplit = reinterpret_cast<float*>(smem + L.msplit) +
                  mi * a.n_split * 16;
  // This thread's slots of its m-tile's split partials.
  float* part = a.part +
                ((((long long)b * a.Hkv + kvh) * gridDim.x + blockIdx.x) *
                     kMT + mi) * a.n_split * (16 * HD) + tid % kGroup;
  int* tbl = reinterpret_cast<int*>(smem + L.table);
  const int n_pg = PAGED ? min(a.MB, ((n_cache - 1) >> a.bs_log2) + 1) : 0;

  if (PAGED) {
    // The block's span of the table, one entry per page (clamped into the
    // pool: a bad entry reads some page, never outside it).
    for (int j = tid; j < n_pg; j += kThreads)
      tbl[j] = min(max(a.table[(long long)b * a.MB + j], 0), a.n_pages - 1);
  }
  __syncthreads();

  // The block's q rows, one swizzled [16][hd] tile per m-tile (zeros past
  // the last row).
  for (int idx = tid; idx < kMT * 16 * C8; idx += kThreads) {
    const int m = idx / (16 * C8), r = (idx / C8) % 16, c = idx % C8;
    const int qi = (mt0 + m) * 16 + r;
    const uint32_t dst = tile_addr<16>(smem_s + L.q + m * 16 * HD * 2, r,
                                       c * 8);
    if (qi < R)
      cp_async16(dst, a.q + (((long long)b * a.T + qi / G) * Hq + kvh * G +
                             qi % G) * HD + c * 8);
    else
      *reinterpret_cast<uint4*>(smem + (dst - smem_s)) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // Pool (or dense cache) row of cache key p (pages of 1 << a.bs_log2).
  auto cache_row = [&](int p) -> long long {
    return PAGED ? ((long long)tbl[p >> a.bs_log2] << a.bs_log2) +
                       (p & ((1 << a.bs_log2) - 1))
                 : p;
  };
  // Tile t into the stage at byte `st` (K, then V), code staging `cst`
  // (int8), by cp.async. Thread tid moves 16-byte chunk
  // tid % C8 of rows tid / C8 + j * RPP of K and V; a row comes from the
  // chunk's rows, the cache (int8: as codes, into staging), or is zero
  // past the block's last key.
  constexpr int RPP = kThreads / C8;
  const int my_c = tid % C8, my_r = tid / C8;
  const long long new_row0 = (long long)b * a.T - start;
  auto issue = [&](int t, uint32_t st, uint32_t cst) {
#pragma unroll
    for (int j = 0; j < (kTile + RPP - 1) / RPP; ++j) {
      const int r = my_r + j * RPP, p = t * kTile + r;
      const uint32_t dst = tile_addr(smem_s + st, r, my_c * 8);
      if (r >= kTile) break;
      if (p >= blk_span) {
        *reinterpret_cast<uint4*>(smem + (dst - smem_s)) =
            make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(smem + (dst - smem_s) + KV_TILE) =
            make_uint4(0u, 0u, 0u, 0u);
      } else if (p >= cut) {
        const long long off =
            ((new_row0 + p) * a.Hkv + kvh) * HD + my_c * 8;
        cp_async16(dst, a.k_new + off);
        cp_async16(dst + KV_TILE, a.v_new + off);
      } else if (!Q8) {
        const long long off = 2 * ((PAGED ? 0 : b * a.k_sb) +
                                   cache_row(p) * a.k_ss + kvh * HD +
                                   my_c * 8);
        cp_async16(dst, a.k + off);
        cp_async16(dst + KV_TILE, a.v + off);
      }
    }
    if (Q8) {
      // Code rows (chunk tid % C16 of rows tid / C16 + j * RPQ) and the
      // word holding each row's scale (threads 0..63: K, 64..127: V),
      // into staging.
      constexpr int RPQ = kThreads / C16;
#pragma unroll
      for (int j = 0; j < (kTile + RPQ - 1) / RPQ; ++j) {
        const int r = tid / C16 + j * RPQ, p = t * kTile + r;
        if (r >= kTile || p >= n_cache) continue;
        const long long off = cache_row(p) * a.k_ss + kvh * HD +
                              (tid % C16) * 16;
        const uint32_t dst = smem_s + cst + r * HD + (tid % C16) * 16;
        cp_async16(dst, a.k + off);
        cp_async16(dst + kTile * HD, a.v + off);
      }
      if (tid < 2 * kTile) {
        const int tensor = tid / kTile, r = tid % kTile, p = t * kTile + r;
        if (p < n_cache) {
          const long long e = cache_row(p) * a.Hkv + kvh;
          cp_async4(smem_s + cst + 2 * kTile * HD + tid * 4,
                    (tensor ? a.v_scale : a.k_scale) + 4 * (e >> 1));
        }
      }
    }
  };
  // int8: the staged code rows of tile t widened into the stage's bf16
  // tiles (code * scale rounded once, natural dim order). Hkv is even, so
  // a scale's half of its word is kvh's parity.
  auto widen = [&](int t, uint32_t st, uint32_t cst) {
    const uint8_t* cs = smem + cst;
    constexpr int RPQ = kThreads / C16;
    const int c = tid % C16;
#pragma unroll
    for (int j = 0; j < (kTile + RPQ - 1) / RPQ; ++j) {
      const int r = tid / C16 + j * RPQ;
      if (r >= kTile || t * kTile + r >= n_cache) continue;
#pragma unroll
      for (int tensor = 0; tensor < 2; ++tensor) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            cs + 2 * kTile * HD + (tensor * kTile + r) * 4);
        const uint32_t s16 = (kvh & 1) ? w >> 16 : w & 0xffffu;
        uint32_t d[8];
        dequant16(*reinterpret_cast<const uint4*>(cs + tensor * kTile * HD +
                                                  r * HD + c * 16),
                  s16 * 0x10001u, d);
        store16(smem + st + tensor * KV_TILE, r, c, d);
      }
    }
  };

  // This warp's rows g, g + 8 of its m-tile, and its q fragments.
  const int g = lane >> 2, t4 = lane & 3;
  int span[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    span[r] = mt < n_mt ? row_span(mt * 16 + g + 8 * r) : 0;
  // The m-tile's q rows as A fragments: held in registers (bf16), or read
  // from the q tile per k-step (int8, whose widening needs the registers).
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const uint32_t qt = smem_s + L.q + mi * 16 * HD * 2;
  const auto q_frag = [&](int kk, uint32_t(&f)[4]) {
    ldsm_x4(f, tile_addr<16>(qt, lane & 15, kk * 16 + (lane >> 4) * 8));
  };
  uint32_t qa[Q8 ? 1 : HD / 16][4];
  if (!Q8) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) q_frag(kk, qa[kk]);
  }
  const auto qf = [&](int kk, uint32_t(&f)[4]) {
    if (Q8) {
      q_frag(kk, f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = qa[kk][e];
    }
  };
  const uint32_t zero2[2] = {0u, 0u};

  // Warp sl of the m-tile runs slice sl's scores and softmax, and hands
  // its P fragments and rescale factors to the m-tile's four warps; each
  // warp then keeps all four slices' accumulators for its own HD / 4
  // columns. A split's slices merge in registers; its partial goes to
  // device memory, its max to shared memory, and each row's (M, L) is kept
  // online.
  float o[kSlices][NB][4];
  float m_run[2], l_run[2];
  float row_M[2] = {-INFINITY, -INFINITY}, row_L[2] = {0.f, 0.f};
  // The ring: NS stages of K then V. NS - 1 groups in flight, empty past
  // the last tile: the wait counts groups, and tile t's is then never
  // among the newest NS - 2.
  constexpr int NS = stages(Q8);
  constexpr uint32_t STAGE = 2 * KV_TILE;
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_tiles) issue(j, j * STAGE, L.codes + j * L.code_stage);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % NS, tn = t + NS - 1;
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (Q8) {
      widen(t, st * STAGE, L.codes + st * L.code_stage);
      __syncthreads();
    }
    if (tn < n_tiles)
      issue(tn, (tn % NS) * STAGE, L.codes + (tn % NS) * L.code_stage);
    cp_async_commit();
    if (t >= mt_tiles) continue;
    const uint32_t kt = smem_s + st * STAGE, vt = kt + KV_TILE;
    if (t % split_tiles == 0) {
#pragma unroll
      for (int k = 0; k < kSlices; ++k)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[k][nb][e] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;
      l_run[0] = l_run[1] = 0.f;
    }
    {
      float s[2][4], alpha[2];
      uint32_t pa[4];
      slice_scores<HD, false>(kt, t * kTile, 16 * sl, qf, s, span,
                              a.scale_log2, lane, nullptr, zero2);
      slice_softmax(s, m_run, l_run, alpha, pa);
      pfrag[((t & 1) * kSlices + sl) * 32 + lane] =
          make_uint4(pa[0], pa[1], pa[2], pa[3]);
      if (t4 == 0) {
        alpha_x[((t & 1) * kSlices + sl) * 16 + g] = alpha[0];
        alpha_x[((t & 1) * kSlices + sl) * 16 + g + 8] = alpha[1];
      }
    }
    group_sync(mi);
#pragma unroll
    for (int k = 0; k < kSlices; ++k) {
      const uint4 pk = pfrag[((t & 1) * kSlices + k) * 32 + lane];
      const uint32_t pa[4] = {pk.x, pk.y, pk.z, pk.w};
      const float al[2] = {alpha_x[((t & 1) * kSlices + k) * 16 + g],
                           alpha_x[((t & 1) * kSlices + k) * 16 + g + 8]};
      // Rescaled only when some row's max moved (a factor of 1 changes
      // no bit).
      if (__any_sync(0xffffffff, al[0] != 1.f || al[1] != 1.f)) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[k][nb][e] *= al[e >> 1];
      }
      slice_pv<NDN>(vt, 16 * k, sl * NDN, pa, o[k], lane);
    }
    if (t % split_tiles != split_tiles - 1 && t != mt_tiles - 1) continue;
    // The split ends: the slices' (m, l), then this warp's columns merged
    // into the split's partial.
    quad_sum(l_run);
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ml[(sl * 16 + g + 8 * r) * 2] = m_run[r];
        ml[(sl * 16 + g + 8 * r) * 2 + 1] = l_run[r];
      }
    }
    group_sync(mi);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      float m[kSlices], l[kSlices], wt[kSlices], M, Ls;
#pragma unroll
      for (int k = 0; k < kSlices; ++k) {
        m[k] = ml[(k * 16 + row) * 2];
        l[k] = ml[(k * 16 + row) * 2 + 1];
      }
      merge_slices_ml(m, l, M, Ls, wt);
      merge_split_l(row_M[r], row_L[r], M, Ls);
      if (sl == 0 && t4 == 0) msplit[(t / split_tiles) * 16 + row] = M;
      float* dst = part + (t / split_tiles) * (16 * HD);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          float x[kSlices];
#pragma unroll
          for (int k = 0; k < kSlices; ++k) x[k] = o[k][nb][e];
          __stcg(dst + (nb * 4 + e) * kGroup, merge_slices_acc(wt, x));
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The splits folded in split order with each row's final M, then the
  // output: acc / L, rounded once; this warp's columns.
  if (mt >= n_mt) return;
  float acc[NB * 4];
#pragma unroll
  for (int j = 0; j < NB * 4; ++j) acc[j] = 0.f;
  for (int i = 0; i * split_tiles < mt_tiles; ++i) {
    const float ws[2] = {split_weight(msplit[i * 16 + g], row_M[0]),
                         split_weight(msplit[i * 16 + g + 8], row_M[1])};
    const float* src = part + i * (16 * HD);
#pragma unroll
    for (int j = 0; j < NB * 4; ++j)
      fold_elem(acc[j], ws[(j & 3) >> 1], __ldcg(src + j * kGroup));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = mt * 16 + g + 8 * r;
    if (qi >= R) continue;
    const float inv = 1.f / row_L[r];
    bf16* dst = a.out + (((long long)b * a.T + qi / G) * Hq + kvh * G +
                         qi % G) * HD + sl * (HD / 4) + 2 * t4;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      *reinterpret_cast<uint32_t*>(dst + nb * 8) =
          finish2(acc[nb * 4 + 2 * r], acc[nb * 4 + 2 * r + 1], inv);
  }
}

template <int HD, int G, bool PAGED, bool Q8>
cudaError_t launch(const PrefillArgs& a, int B, cudaStream_t stream) {
  const Layout L = prefill_layout(HD, Q8, PAGED ? a.MB : 0, a.n_split);
  const int smem = L.total + 1024;  // alignment slack
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = prefill_kernel<HD, G, PAGED, Q8>;
  // The attribute is set once per device (a bit each, devices 0-63).
  static unsigned long long attr_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set |= bit;
  }
  const int n_mt = (a.T * G + 15) / 16;
  kernel<<<dim3((n_mt + kMT - 1) / kMT, a.Hkv, B), kThreads, smem, stream>>>(
      a);
  return cudaGetLastError();
}

template <bool PAGED, bool Q8>
cudaError_t dispatch(const PrefillArgs& a, int B, int Hq, int HD,
                     cudaStream_t s) {
  if (a.Hkv <= 0 || Hq % a.Hkv != 0 || a.T < 1 || B < 1 || a.S < 1 ||
      a.chunk < kTile || a.chunk % kTile != 0)
    return cudaErrorInvalidValue;
  const int G = Hq / a.Hkv;
#define SKYPILOT_PREFILL_CASE(hd, g) \
  if (HD == hd && G == g) return launch<hd, g, PAGED, Q8>(a, B, s);
  SKYPILOT_PREFILL_CASE(64, 1)
  SKYPILOT_PREFILL_CASE(64, 2)
  SKYPILOT_PREFILL_CASE(64, 4)
  SKYPILOT_PREFILL_CASE(64, 8)
  SKYPILOT_PREFILL_CASE(128, 1)
  SKYPILOT_PREFILL_CASE(128, 2)
  SKYPILOT_PREFILL_CASE(128, 4)
  SKYPILOT_PREFILL_CASE(128, 8)
#undef SKYPILOT_PREFILL_CASE
  return cudaErrorInvalidValue;
}

cudaError_t prefill(void* part, const void* q, const void* k, const void* v,
                    const void* k_scale, const void* v_scale,
                    const void* k_new, const void* v_new,
                    const void* lengths, const void* table, void* out, int B,
                    int T, int S, int Hq, int Hkv, int HD, long long k_sb,
                    long long k_ss, long long v_sb, long long v_ss, int MB,
                    int bs, long long N, int chunk, float scale_log2,
                    void* stream) {
  PrefillArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const uint8_t*>(k);
  a.v = static_cast<const uint8_t*>(v);
  a.k_scale = static_cast<const uint8_t*>(k_scale);
  a.v_scale = static_cast<const uint8_t*>(v_scale);
  a.k_new = static_cast<const bf16*>(k_new);
  a.v_new = static_cast<const bf16*>(v_new);
  a.lengths = static_cast<const int*>(lengths);
  a.table = static_cast<const int*>(table);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  if (v_ss != k_ss || (table == nullptr && v_sb != k_sb))
    return cudaErrorInvalidValue;
  a.T = T;
  a.Hkv = Hkv;
  a.chunk = chunk;
  a.scale_log2 = scale_log2;
  const bool paged = table != nullptr, q8 = k_scale != nullptr;
  if ((k_new == nullptr) != (v_new == nullptr) || (q8 && !paged) ||
      (!q8 && k_new != nullptr))
    return cudaErrorInvalidValue;
  if (paged) {
    if (MB < 1 || bs < 8 || (bs & (bs - 1)) != 0 || N < bs || N % bs != 0 ||
        N / bs > INT_MAX)
      return cudaErrorInvalidValue;
    a.MB = MB;
    a.bs_log2 = __builtin_ctz(bs);
    a.n_pages = int(N / bs);
    a.S = MB * bs;
  } else {
    a.S = S;
  }
  a.n_split = (a.S + chunk - 1) / chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (paged)
    return q8 ? dispatch<true, true>(a, B, Hq, HD, s)
              : dispatch<true, false>(a, B, Hq, HD, s);
  return dispatch<false, false>(a, B, Hq, HD, s);
}

}  // namespace

// bf16 cache: a dense [B, S, Hkv, hd] (table null; strides in elements)
// or one layer's pool [N, Hkv, hd] (K and V alike strided) read through
// table [B, MB] with pages of bs rows (a power of two), every key from
// the cache (the chunk's own rows written there first). `part`: f32
// scratch of skypilot_prefill_part_floats elements.
extern "C" int skypilot_prefill_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* table, void* out, void* part, int B, int T, int S, int Hq,
    int Hkv, int HD, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, int MB, int bs, long long N, int chunk, float scale_log2,
    void* stream) {
  return prefill(part, q, k, v, nullptr, nullptr, nullptr, nullptr, lengths,
                 table, out, B, T, S, Hq, Hkv, HD, k_sb, k_ss, v_sb, v_ss, MB,
                 bs, N, chunk, scale_log2, stream);
}

// int8 pools of codes (row strides in elements = bytes) with bf16 scale
// pools [N, Hkv], Hkv even, on a 4-byte aligned base (a scale is read as
// the aligned word holding it).
extern "C" int skypilot_prefill_attention_q8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* k_new, const void* v_new,
    const void* lengths, const void* table, void* out, void* part, int B,
    int T, int Hq, int Hkv, int HD, long long k_ss, long long v_ss, int MB,
    int bs, long long N, int chunk, float scale_log2, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr || table == nullptr ||
      Hkv % 2 != 0)
    return cudaErrorInvalidValue;
  return prefill(part, q, k, v, k_scale, v_scale, k_new, v_new, lengths,
                 table, out, B, T, 0, Hq, Hkv, HD, 0, k_ss, 0, v_ss, MB, bs, N,
                 chunk, scale_log2, stream);
}

// The dynamic shared memory one K4-prefill block asks for (layout plus the
// alignment slack), for a check of ops/decode_attention.py
// prefill_smem_bytes.
extern "C" int skypilot_prefill_smem_bytes(int hd, int q8, int mb,
                                           int n_split) {
  return prefill_layout(hd, q8 != 0, mb, n_split).total + 1024;
}

// The f32 elements of a call's split partials: a 16 x hd tile for each
// (row, kv head, block, m-tile, split), splits of `chunk` keys over S.
extern "C" long long skypilot_prefill_part_floats(int B, int T, int Hq,
                                                   int Hkv, int HD, int S,
                                                   int chunk) {
  const int n_mt = (T * (Hq / Hkv) + 15) / 16;
  const long long blocks = (long long)B * Hkv * ((n_mt + kMT - 1) / kMT);
  return blocks * kMT * ((S + chunk - 1) / chunk) * 16 * HD;
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
