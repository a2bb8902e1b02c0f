// Decode-side kernels for Hopper (sm_90a): K4-cuda (decode attention,
// dense and paged/verify, bf16 and int8 KV), K5-cuda (the per-row
// KV-cache write) and K5F (K5 fused with the step's RoPE and int8
// quantization).
//
// K4 replaces the TPU kernel skypilot_tpu/ops/decode_attention.py:
// _decode_attn_kernel (launched by _decode_attention_pallas), and the JAX
// package's gather + K4 and plain-einsum verify routes (paged_decode_
// attention, paged_verify_attention). Contract: q [B,W,Hq,hd], K/V either
// a dense cache [B,S,Hkv,hd] read through strides or one layer's flat pool
// [N,Hkv,hd] read through a block table [B,MB] (logical position p of row
// b is pool row table[b][p/bs]*bs + p%bs, S = MB*bs); query j of row b
// attends [0, min(max(lengths[b] + j, 1), S)). W = 1 is decode, W =
// draft_k + 1 the speculative verify, and the dense bf16 entry's W = T the
// engine's prefill chunk (lengths = start + 1). The output is [B,W,Hq,hd]
// bf16. int8 KV (the *_q8 entries, W = 1 when dense) holds codes with one
// bf16 scale per (row, kv head); a code is dequantized as the JAX
// package's _dequant_kv does (code * scale, exact in f32, rounded once to
// bf16) before the products.
//
// What bounds K4 on the H100: bytes. A visible key costs 4*hd bytes of K
// and V per kv head in bf16 (512 at hd 128) and 2*hd + 4 in int8 (260),
// used for 4*hd FLOPs per query row: at W*G = 4 rows (llama3-8b decode)
// or 36 (verify, W = 9) that is far below the card's ~295 FLOP/byte
// balance point. So the design keeps bytes in flight:
//
// 1. One block per (split, kv head, batch row) reads its span of keys for
//    the W*G query rows of the kv head, one m-tile of 16 rows a pass (W*G
//    <= 16, decode: one pass; verify at G 4, W 9: three, the later ones
//    mostly from L2); a block takes at most 4 passes, so a prefill
//    chunk's T*G rows spread over groups of blocks. The products run on the tensor cores (mma.sync
//    m16n8k16 bf16 -> f32): the m-tile's rows are A (held in registers),
//    a 16-key slice of a 64-key tile is B (ldmatrix), and P = exp2(S - m)
//    is repacked from the accumulators into the A operand of P V (V by
//    ldmatrix.trans). Each of the 4 warps owns 16 keys of every tile, with
//    its own online softmax on the accumulator fragments in f32 (S scaled
//    by scale*log2e in f32), one quad shuffle per row per slice and none
//    per key; the warps' states merge in warp order at the end of a pass.
// 2. Batch invariance: a query row meets its keys in one order whatever
//    W, B or its m-tile: the same 16-key slices per warp, the same online
//    updates, the same warp merge and the same split merge, the splits a
//    constant chunk of keys (ops/decode_attention.py decode_split_plan).
//    Tiles past a row's span (a longer row of the call) are masked and add
//    exactly 0. So a row decoded alone, in a batch of 8, or as the first
//    query of a verify window gets the same bits.
// 3. Keys arrive by TMA (cp.async.bulk.tensor) into a 3-stage ring of
//    64-key tiles, with mbarriers; bf16 tiles land 128-byte swizzled
//    (conflict-free ldmatrix). The map is 4-D, dense [B,S,Hkv,hd] or the
//    pool [1,N,Hkv,hd], in boxes of min(bs, 16) rows of one kv head; a
//    paged row comes from the block's span of the table, read once into
//    shared memory, one entry per page. Past S (dense) a box is
//    zero-filled; a page past the table reads block 0, whose keys are
//    masked. No block-wide barrier runs per tile: each warp copies, waits
//    for and refills its own rows of each stage (its own barrier), so the
//    4 warps run as 4 pipelines.
// 4. int8 moves codes and scales, not bf16 copies: the codes by TMA
//    (swizzled rows), the scale rows of the tile's keys (all kv heads,
//    contiguous) by cp.async.bulk on the same barrier. Each code is
//    dequantized once per tile (byte_perm into f32, one cvt per pair,
//    mul.rn.bf16x2 by the scale): a warp's K codes straight into the QK^T
//    operands (4 codes a lane per k-step, in a permuted order of the head
//    dims that q is loaded in too), its V codes into bf16 rows for
//    ldmatrix. Nothing is shuffled per key.
// 5. Splits come from shapes alone, never from `lengths`, so the call can
//    be captured in a CUDA graph. Blocks whose split starts at or past the
//    row's longest span exit at once. The merge is folded into the same
//    launch: each block writes its (m, l, acc) partials, then bumps a
//    per-(row, kv head, pass group) counter; the block that arrives last
//    merges the group's rows over the valid splits in split order and
//    resets the counter to 0. One
//    launch per call, and the result does not depend on which block
//    finished last.
// 6. One template: decode_kernel<HD, G, PAGED, Q8>. Dense and paged
//    differ only in where a tile's rows come from, so paged W = 1 over a
//    table that lays rows out contiguously is bit-equal to dense K4 (same
//    splits, same tiles, same arithmetic), in bf16 and in int8.
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
// rows (Hkv*2 bytes) of K and V in the same one launch. No serving path
// runs K5 any more (K5F writes them all); it stays the one-to-one
// counterpart of the TPU kernel, held to index_copy_ by its own check.
//
// K5F (skypilot_rope_cache_write, _q8) is K5 redesigned for every serving
// forward: the decode and verify steps, the engine's prefill chunk, and
// the engine-off prompt and decode step (over the dense cache's flat rows,
// dst = b * S + pos + t). It computes what the JAX layer computes around
// the same TPU kernel, where XLA fuses the RoPE and the quantize into the
// scan. On the H100, K5 alone ran at about 1% of its bytes bound: a launch
// of a few hundred bytes costs the launch, and before it ran a chain of
// some 23 eager elementwise launches a layer in bf16 (47 in int8): RoPE of
// q and k with cos and sin recomputed from the angles, then the
// quantization. K5F is that whole chain in one launch a layer (cos and sin
// made once per forward, row r reading table row r mod period, so a
// [B, T] prompt shares one [T] table): one block per new row rotates the
// row's q heads (out), rotates its k heads (into k_out too when asked, for
// every row: the int8 chunk and the engine-off prompt attend their exact
// rotated rows), quantizes k and v when the pool is int8 and writes them in
// place. Bound by the launch at a step's rows, by its bytes at a prompt's
// thousands.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "mma_sync.cuh"
#include "sm90_common.cuh"

namespace {

using namespace decode_common;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;  // tiles in the ring
constexpr int kMaxSmem = 232448;
// m-tiles of query rows (passes) one block takes: a call with more (a
// prefill chunk's T x G rows) spreads its passes over groups of blocks
// (ops: DECODE_PASSES_PER_BLOCK). Which block runs a pass changes no bit.
constexpr int kPassesPerBlock = 4;

__host__ __device__ inline int pass_groups(int rows) {
  return ((rows + 15) / 16 + kPassesPerBlock - 1) / kPassesPerBlock;
}

struct DecodeArgs {
  const bf16* q;          // [B, W, Hq, hd]
  const int* lengths;     // [B]
  const int* table;       // [B, MB] (paged)
  const uint8_t* k_scale;  // Q8: bf16 scale rows of Hkv entries
  const uint8_t* v_scale;
  float* part_ml;   // [B, Hkv, n_split, W*G, 2]: (m, l) of each partial
  float* part_acc;  // [B, Hkv, n_split, W*G, hd]
  int* counters;    // [B, Hkv], 0 between calls
  bf16* out;        // [B, W, Hq, hd]
  int S;            // keys a row can hold: dense S, or MB * bs
  int Hkv;
  int W;
  int MB;
  int bs;        // page rows (paged)
  int n_pages;   // pool pages (paged): N / bs
  int n_split;
  int chunk;     // keys per split, a multiple of kTile
  long long sc_sb;  // Q8 dense: batch stride of the scales, in elements
  float scale_log2;
};

// Shared memory, from a 1024-byte aligned base. Stages first (bf16: the
// K tile then the V tile, each hd/64 swizzled 64-row atoms; int8: K and V
// codes [64][hd] then K and V scale rows [64][Hkv]), then (int8) the
// dequantized bf16 K/V tiles, then the barriers, the last-block flag and
// the block's page entries. After the key loop the region before the
// barriers holds the warps' partials (and, in the merge, per-row (M, L)).
struct Layout {
  int stage;   // bytes of one stage
  int codes;   // int8: bytes of one code tile
  int bf;      // int8: offset of the bf16 K/V tiles
  int bar;
  int flag;
  int table;
  int total;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Mirrored by ops/decode_attention.py decode_smem_bytes (chip_smoke.py
// compares the two through skypilot_decode_smem_bytes).
__host__ __device__ inline Layout layout(int hd, bool q8, int hkv,
                                         int max_pages, int rows) {
  Layout L;
  const int kv_tile = kTile * hd * 2;
  L.codes = kTile * hd;
  L.stage = q8 ? round_up(2 * L.codes + 2 * kTile * hkv * 2, 1024)
               : 2 * kv_tile;
  L.bf = kStages * L.stage;
  // int8: the dequantized bf16 V tile (K is dequantized into registers).
  int end = L.bf + (q8 ? kv_tile : 0);
  const int merge = kWarps * 16 * (hd + 4) * 4 + kWarps * 16 * 2 * 4;
  if (merge > end) end = merge;
  if (rows * 2 * 4 > end) end = rows * 2 * 4;
  L.bar = round_up(end, 128);
  L.flag = L.bar + kStages * kWarps * 8;  // a barrier per (stage, warp)
  L.table = L.flag + 16;                  // the last-block flag
  L.total = L.table + max_pages * 4;
  return L;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(sm90::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------

template <int HD, int G, bool PAGED, bool Q8>
__global__ void __launch_bounds__(kThreads, 2)
    decode_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ DecodeArgs a) {
  static_assert(HD == 64 || HD == 128, "head_dim");
  constexpr int KV_TILE = kTile * HD * 2;  // bytes of one bf16 K or V tile
  constexpr int ATOM = kTile * 128;        // bytes of one 64-column atom
  constexpr int NS = kStages;
  // int8 K is dequantized straight into the products' operands, in a
  // permuted order of the head dims (the same for q).
  constexpr bool DQK = Q8;
  const int split = blockIdx.x % a.n_split, kvh = blockIdx.y, b = blockIdx.z;
  const int group = blockIdx.x / a.n_split;
  const int len = a.lengths[b];
  const int span_max = span_of(len, a.W - 1, a.S);
  const int start = split * a.chunk;
  if (start >= span_max) return;  // nothing of this split is visible
  const int n_valid = (span_max + a.chunk - 1) / a.chunk;
  const int n_tiles = (min(start + a.chunk, span_max) - start + kTile - 1) /
                      kTile;
  const int Hq = a.Hkv * G;
  const int R = a.W * G;  // query rows of this kv head
  // One m-tile of query rows a pass; this block's passes and rows.
  const int n_pass = (R + 15) / 16;
  const int pass0 = group * kPassesPerBlock;
  const int pass1 = min(n_pass, pass0 + kPassesPerBlock);
  const int q0 = pass0 * 16, q1 = min(R, pass1 * 16);

  const Layout L =
      layout(HD, Q8, a.Hkv, PAGED ? a.chunk / a.bs : 0, R);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  int* tbl = reinterpret_cast<int*>(smem + L.table);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int page0 = PAGED ? start / a.bs : 0;
  if (tid == 0) {
    sm90::prefetch_tensormap(&kmap);
    sm90::prefetch_tensormap(&vmap);
    for (int s = 0; s < NS * kWarps; ++s) sm90::mbar_init(&bars[s], 1);
    sm90::mbar_init_fence();
  }
  if (PAGED) {
    // The block's span of the table, one entry per page; entries past
    // the table read page 0 (its keys are past every span).
    const int n_pg = n_tiles * kTile / a.bs;
    for (int j = tid; j < n_pg; j += kThreads) {
      const int lp = page0 + j;
      const int blk = lp < a.MB ? a.table[(long long)b * a.MB + lp] : 0;
      tbl[j] = min(max(blk, 0), a.n_pages - 1);
    }
  }
  if (Q8) {
    // Scale rows a dense edge tile does not copy must hold finite values
    // (their codes are zero-filled): zero every stage's scales once.
    for (int s = 0; s < NS; ++s) {
      uint32_t* sc =
          reinterpret_cast<uint32_t*>(smem + s * L.stage + 2 * L.codes);
      for (int i = tid; i < kTile * a.Hkv; i += kThreads) sc[i] = 0u;
    }
    fence_proxy_async();
  }
  __syncthreads();

  // One warp loads rows [r0, r0 + nr) of tile t of the split (the it-th
  // tile of the block) into its stage, on barrier `bar`: lane 0 announces
  // the bytes, then lane j issues copy j. The rows come in boxes of
  // min(bs, 16) rows (16 dense), each one TMA per 64-column atom of K and
  // of V, or, int8, one TMA of K and of V codes and one bulk copy of K
  // and of V scale rows.
  auto issue = [&](int t, int it, int r0, int nr, uint64_t* bar) {
    uint8_t* st = smem + (it % NS) * L.stage;
    const int key0 = start + t * kTile + r0;  // first key of the rows
    const int box = PAGED ? min(a.bs, 16) : 16;
    const int sc_row = a.Hkv * 2;  // bytes of one scale row (int8)
    // Dense int8: rows past S get no scale rows (their codes are zero).
    const int n_sc = PAGED ? nr : max(min(nr, a.S - key0), 0);
    if (lane == 0)
      sm90::mbar_arrive_expect_tx(
          bar, Q8 ? 2 * nr * HD + 2 * n_sc * sc_row : 4 * nr * HD);
    __syncwarp();
    const int j = lane;
    const int q = Q8 ? j >> 2 : j / (2 * (HD / 64));  // this lane's box
    if (q >= nr / box) return;
    const int key = key0 + q * box, r = r0 + q * box;
    const long long row =
        PAGED ? (long long)tbl[(key - start) / a.bs] * a.bs + key % a.bs
              : key;
    const int batch = PAGED ? 0 : b;
    const int tensor = j & 1;
    const CUtensorMap* map = tensor ? &vmap : &kmap;
    if (!Q8) {
      const int c = (j >> 1) % (HD / 64);
      sm90::tma_load_4d(st + tensor * KV_TILE + c * ATOM + r * 128, map,
                        bar, c * 64, int(row), kvh, batch);
    } else if ((j & 3) < 2) {
      sm90::tma_load_4d(st + tensor * L.codes + r * HD, map, bar, 0,
                        int(row), kvh, batch);
    } else {
      const int n = PAGED ? box : max(min(box, a.S - key), 0);
      if (n > 0)
        bulk_load(st + 2 * L.codes + tensor * kTile * sc_row + r * sc_row,
                  (tensor ? a.v_scale : a.k_scale) +
                      (PAGED ? 0 : b * a.sc_sb * 2) + row * sc_row,
                  n * sc_row, bar);
    }
  };
  // Each warp owns rows [16 warp, 16 warp + 16) of every tile (its keys)
  // and their barrier.
  auto load = [&](int t, int it) {
    issue(t, it, 16 * warp, 16, &bars[(it % NS) * kWarps + warp]);
  };

  // int8: 16 V codes of row `row`, columns [16 j, 16 j + 16), into the
  // bf16 V tile.
  auto dequant = [&](const uint8_t* st, int row, int j, uint8_t* tile) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        st + L.codes + row * HD + code_chunk<HD>(row, j) * 16);
    const uint16_t s16 = reinterpret_cast<const uint16_t*>(
        st + 2 * L.codes + kTile * a.Hkv * 2)[row * a.Hkv + kvh];
    uint32_t d[8];
    dequant16(raw, uint32_t(s16) * 0x10001u, d);
    store16(tile, row, j, d);
  };

  int it = 0;  // tiles consumed by the block, over all passes
  for (int pass = pass0; pass < pass1; ++pass) {
    for (int j = 0; j < NS && j < n_tiles; ++j) load(j, it + j);

    // This pass's m-tile: query rows [16 pass, 16 pass + 16).
    const int mt = pass;
    const int g = lane >> 2, t = lane & 3;
    uint32_t qa[HD / 16][4];
    int span[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = mt * 16 + g + 8 * r;
      const bool ok = qi < R;
      span[r] = ok ? span_of(len, qi / G, a.S) : 0;
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
          a.q + (((long long)b * a.W + qi / G) * Hq + kvh * G + qi % G) *
                    HD);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if (DQK) {  // k 2t, 2t+1 | 2t+8, 2t+9 = dims 16kk + 4t .. + 3
          const uint2 x =
              ok ? *reinterpret_cast<const uint2*>(qrow + kk * 8 + 2 * t)
                 : make_uint2(0u, 0u);
          qa[kk][r] = x.x;
          qa[kk][2 + r] = x.y;
        } else {
          qa[kk][r] = ok ? qrow[kk * 8 + t] : 0u;
          qa[kk][2 + r] = ok ? qrow[kk * 8 + 4 + t] : 0u;
        }
      }
    }
    float o[HD / 8][4];
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    // No block-wide barrier per tile: each warp waits for its rows and
    // refills them.
    for (int tt = 0; tt < n_tiles; ++tt, ++it) {
      const int stage = it % NS;
      sm90::mbar_wait(&bars[stage * kWarps + warp], (it / NS) & 1);
      uint8_t* st = smem + stage * L.stage;
      uint32_t kt = sm90::smem_u32(st), vt = kt + KV_TILE;
      uint32_t ks2[2] = {0u, 0u};
      if (Q8) {
        // Each warp reads only its own 16 keys: it dequantizes their V
        // rows, and their K codes inside the products.
        constexpr int CPR = HD / 16;  // 16-code chunks per row
        uint8_t* bf = smem + L.bf;
#pragma unroll
        for (int i = 0; i < CPR / 2; ++i) {
          const int c = lane + 32 * i;
          dequant(st, 16 * warp + c / CPR, c % CPR, bf);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + (lane >> 2) + 8 * h;
          ks2[h] = uint32_t(reinterpret_cast<const uint16_t*>(
                       st + 2 * L.codes)[r * a.Hkv + kvh]) *
                   0x10001u;
        }
        __syncwarp();
        vt = sm90::smem_u32(bf);
      }
      attend_slice<HD, DQK>(
          kt, vt, start + tt * kTile, 16 * warp,
          [&](int kk, uint32_t(&f)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = qa[kk][e];
          },
          o, m_run, l_run, span, a.scale_log2, lane, st, ks2);
      __syncwarp();
      if (tt + NS < n_tiles) load(tt + NS, it + NS);
    }
    __syncthreads();

    // The warps' partials through shared memory, one (M, L, acc) per
    // query row of the split into the scratch.
    quad_sum(l_run);
    float* w_acc = reinterpret_cast<float*>(smem);
    float* w_ml = w_acc + kWarps * 16 * (HD + 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (t == 0) {
        w_ml[(warp * 16 + row) * 2] = m_run[r];
        w_ml[(warp * 16 + row) * 2 + 1] = l_run[r];
      }
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
        *reinterpret_cast<float2*>(
            &w_acc[(warp * 16 + row) * (HD + 4) + nb * 8 + 2 * t]) =
            make_float2(o[nb][2 * r], o[nb][2 * r + 1]);
    }
    __syncthreads();
    const long long part0 =
        (((long long)b * a.Hkv + kvh) * a.n_split + split) * R;
    for (int idx = tid; idx < 16 * (HD / 4); idx += kThreads) {
      const int row = idx / (HD / 4), d4 = idx % (HD / 4);
      const int qi = mt * 16 + row;
      if (qi >= R) continue;
      float M, Ls;
      float4 A;
      merge_slices(w_ml, w_acc, HD + 4, row, d4, M, Ls, A);
      reinterpret_cast<float4*>(a.part_acc + (part0 + qi) * HD)[d4] = A;
      if (d4 == 0) {
        a.part_ml[(part0 + qi) * 2] = M;
        a.part_ml[(part0 + qi) * 2 + 1] = Ls;
      }
    }
    // The next pass's copies overwrite this region.
    fence_proxy_async();
    __syncthreads();
  }

  // Last block of (b, kvh, group) to finish merges the group's rows over
  // the valid splits, in split order, and resets the counter for the next
  // call.
  __threadfence();
  __syncthreads();
  int* counter = a.counters + ((long long)b * a.Hkv + kvh) * pass_groups(R) +
                 group;
  if (tid == 0) *flag = atomicAdd(counter, 1) == n_valid - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (tid == 0) *counter = 0;
  const long long base = ((long long)b * a.Hkv + kvh) * a.n_split * R;
  float* row_ml = reinterpret_cast<float*>(smem);  // [R][M, 1/L]
  // Each row's M and L in one pass over its splits (an online max and
  // sum), one thread a row.
  for (int qi = q0 + tid; qi < q1; qi += kThreads) {
    float M = -INFINITY, Ls = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_valid; ++i) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          &a.part_ml[(base + (long long)i * R + qi) * 2]));
      merge_split_l(M, Ls, ml.x, ml.y);
    }
    row_ml[qi * 2] = M;
    row_ml[qi * 2 + 1] = 1.f / Ls;
  }
  __syncthreads();
  // Two outputs (4 columns each) a thread at a time, eight splits in
  // flight for each.
  constexpr int Q4 = HD / 4;
  for (int idx = q0 * Q4 + tid; idx < q1 * Q4; idx += 2 * kThreads) {
    int qs[2];
    float4 A[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      qs[k] = min(idx + k * kThreads, q1 * Q4 - 1);
      A[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 8
    for (int i = 0; i < n_valid; ++i) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int qi = qs[k] / Q4;
        const long long pr = base + (long long)i * R + qi;
        fold_split(A[k], __ldcg(&a.part_ml[pr * 2]), row_ml[qi * 2],
                   __ldcg(reinterpret_cast<const float4*>(
                       a.part_acc + pr * HD) + qs[k] % Q4));
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (idx + k * kThreads >= q1 * Q4) break;
      const int qi = qs[k] / Q4, d4 = qs[k] % Q4;
      const uint2 packed = finish4(A[k], row_ml[qi * 2 + 1]);
      bf16* dst = a.out + (((long long)b * a.W + qi / G) * Hq + kvh * G +
                           qi % G) * HD + 4 * d4;
      *reinterpret_cast<uint2*>(dst) = packed;
    }
  }
}

template <int HD, int G, bool PAGED, bool Q8>
cudaError_t launch(const CUtensorMap& km, const CUtensorMap& vm,
                   const DecodeArgs& a, int B, cudaStream_t stream) {
  const Layout L =
      layout(HD, Q8, a.Hkv, PAGED ? a.chunk / a.bs : 0, a.W * G);
  const int smem = L.total + 1024;  // alignment slack
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = decode_kernel<HD, G, PAGED, Q8>;
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
  kernel<<<dim3(a.n_split * pass_groups(a.W * G), a.Hkv, B), kThreads, smem,
           stream>>>(km, vm, a);
  return cudaGetLastError();
}

template <bool PAGED, bool Q8>
cudaError_t dispatch(const CUtensorMap& km, const CUtensorMap& vm,
                     const DecodeArgs& a, int B, int Hq, int HD,
                     cudaStream_t s) {
  if (a.Hkv <= 0 || Hq % a.Hkv != 0 || a.W < 1 || a.chunk < kTile ||
      a.chunk % kTile != 0 || (long long)a.n_split * a.chunk < a.S)
    return cudaErrorInvalidValue;
  const int G = Hq / a.Hkv;
#define SKYPILOT_DECODE_CASE(hd, g) \
  if (HD == hd && G == g) return launch<hd, g, PAGED, Q8>(km, vm, a, B, s);
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

// The tensor map of the int8 codes x[b][row][head][0:hd] (strides in
// bytes, hd contiguous), described as hd / 2 bf16 so TMA swizzles the
// rows (128-byte rows by the 128-byte pattern, 64-byte rows by the
// 64-byte one; see code_chunk): box (hd, box_rows, 1, 1) bytes, rows
// past `rows` read as zero.
cudaError_t make_code_map(CUtensorMap* map, const void* base, int hd,
                          long long rows, int heads, int batch,
                          long long st_row, long long st_batch,
                          int box_rows) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(hd / 2), cuuint64_t(rows),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(st_row), cuuint64_t(hd),
                                 cuuint64_t(st_batch)};
  const cuuint32_t box[4] = {cuuint32_t(hd / 2), cuuint32_t(box_rows), 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        hd == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// K and V maps: dense [B, S, Hkv, hd], or the pool as [1, N, Hkv, hd],
// with boxes of min(bs, 16) rows of one kv head (16 dense).
cudaError_t kv_maps(CUtensorMap* km, CUtensorMap* vm, const void* k,
                    const void* v, bool q8, int HD, long long rows, int Hkv,
                    int batch, long long k_ss, long long k_sb, long long v_ss,
                    long long v_sb, int box_rows) {
  cudaError_t err;
  if (q8) {
    if ((err = make_code_map(km, k, HD, rows, Hkv, batch, k_ss, k_sb,
                             box_rows)) != cudaSuccess)
      return err;
    return make_code_map(vm, v, HD, rows, Hkv, batch, v_ss, v_sb, box_rows);
  }
  if ((err = sm90::make_map(km, k, HD, int(rows), Hkv, batch, k_ss, HD, k_sb,
                            box_rows)) != cudaSuccess)
    return err;
  return sm90::make_map(vm, v, HD, int(rows), Hkv, batch, v_ss, HD, v_sb,
                        box_rows);
}

DecodeArgs common_args(const void* q, const void* lengths, void* out,
                       void* part_ml, void* part_acc, void* counters, int S,
                       int Hkv, int chunk, int n_split, float scale_log2) {
  DecodeArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.lengths = static_cast<const int*>(lengths);
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.counters = static_cast<int*>(counters);
  a.out = static_cast<bf16*>(out);
  a.S = S;
  a.Hkv = Hkv;
  a.W = 1;
  a.bs = 1;
  a.chunk = chunk;
  a.n_split = n_split;
  a.scale_log2 = scale_log2;
  return a;
}

}  // namespace

// W query positions a row (W > 1: the prefill chunk's dense form of the
// verify, query j attending [0, lengths[b] + j)).
extern "C" int skypilot_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_ml, void* part_acc, void* counters, int B, int W,
    int S, int Hq, int Hkv, int HD, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, int chunk, int n_split, float scale_log2,
    void* stream) {
  if (W < 1) return cudaErrorInvalidValue;
  DecodeArgs a = common_args(q, lengths, out, part_ml, part_acc, counters, S,
                             Hkv, chunk, n_split, scale_log2);
  a.W = W;
  CUtensorMap km, vm;
  cudaError_t err = kv_maps(&km, &vm, k, v, false, HD, S, Hkv, B, k_ss, k_sb,
                            v_ss, v_sb, 16);
  if (err != cudaSuccess) return err;
  return dispatch<false, false>(km, vm, a, B, Hq, HD,
                                static_cast<cudaStream_t>(stream));
}

// int8 codes k/v (strides in elements = bytes) with bf16 scales whose
// rows hold the Hkv heads contiguously (ks_ss == vs_ss == Hkv).
extern "C" int skypilot_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* out, void* part_ml,
    void* part_acc, void* counters, int B, int S, int Hq, int Hkv, int HD,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
    long long ks_sb, long long ks_ss, long long vs_sb, long long vs_ss,
    int chunk, int n_split, float scale_log2, void* stream) {
  if (ks_ss != Hkv || vs_ss != Hkv || ks_sb != vs_sb ||
      (ks_sb * 2) % 16 != 0 || (long long)S * Hkv % 8 != 0)
    return cudaErrorInvalidValue;
  DecodeArgs a = common_args(q, lengths, out, part_ml, part_acc, counters, S,
                             Hkv, chunk, n_split, scale_log2);
  a.k_scale = static_cast<const uint8_t*>(k_scale);
  a.v_scale = static_cast<const uint8_t*>(v_scale);
  a.sc_sb = ks_sb;
  CUtensorMap km, vm;
  cudaError_t err = kv_maps(&km, &vm, k, v, true, HD, S, Hkv, B, k_ss, k_sb,
                            v_ss, v_sb, 16);
  if (err != cudaSuccess) return err;
  return dispatch<false, true>(km, vm, a, B, Hq, HD,
                               static_cast<cudaStream_t>(stream));
}

namespace {

cudaError_t paged(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* table, const void* lengths, void* out,
                  void* part_ml, void* part_acc, void* counters, int B,
                  int W, int MB, int bs, long long N, int Hq, int Hkv,
                  int HD, long long k_ss, long long v_ss, int chunk,
                  int n_split, float scale_log2, cudaStream_t stream) {
  if (W < 1 || MB < 1 || bs < 8 || bs > kTile || kTile % bs != 0 ||
      N < bs || N % bs != 0 || chunk % bs != 0)
    return cudaErrorInvalidValue;
  const bool q8 = k_scale != nullptr;
  DecodeArgs a = common_args(q, lengths, out, part_ml, part_acc, counters,
                             MB * bs, Hkv, chunk, n_split, scale_log2);
  a.table = static_cast<const int*>(table);
  a.W = W;
  a.MB = MB;
  a.bs = bs;
  a.n_pages = int(N / bs);
  a.k_scale = static_cast<const uint8_t*>(k_scale);
  a.v_scale = static_cast<const uint8_t*>(v_scale);
  CUtensorMap km, vm;
  cudaError_t err = kv_maps(&km, &vm, k, v, q8, HD, N, Hkv, 1, k_ss,
                            N * k_ss, v_ss, N * v_ss, bs < 16 ? bs : 16);
  if (err != cudaSuccess) return err;
  return q8 ? dispatch<true, true>(km, vm, a, B, Hq, HD, stream)
            : dispatch<true, false>(km, vm, a, B, Hq, HD, stream);
}

}  // namespace

// Pools [N, Hkv, hd] (row strides in elements), N = pages * bs.
extern "C" int skypilot_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* out, void* part_ml, void* part_acc,
    void* counters, int B, int W, int MB, int bs, long long N, int Hq,
    int Hkv, int HD, long long k_ss, long long v_ss, int chunk, int n_split,
    float scale_log2, void* stream) {
  return paged(q, k, v, nullptr, nullptr, table, lengths, out, part_ml,
               part_acc, counters, B, W, MB, bs, N, Hq, Hkv, HD, k_ss, v_ss,
               chunk, n_split, scale_log2, static_cast<cudaStream_t>(stream));
}

// int8 pools with bf16 scale pools [N, Hkv] (contiguous rows).
extern "C" int skypilot_paged_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, void* out,
    void* part_ml, void* part_acc, void* counters, int B, int W, int MB,
    int bs, long long N, int Hq, int Hkv, int HD, long long k_ss,
    long long v_ss, long long ks_ss, long long vs_ss, int chunk,
    int n_split, float scale_log2, void* stream) {
  if (ks_ss != Hkv || vs_ss != Hkv) return cudaErrorInvalidValue;
  return paged(q, k, v, k_scale, v_scale, table, lengths, out, part_ml,
               part_acc, counters, B, W, MB, bs, N, Hq, Hkv, HD, k_ss, v_ss,
               chunk, n_split, scale_log2, static_cast<cudaStream_t>(stream));
}

namespace {

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

namespace {

// The fused RoPE + int8 + cache write of every serving path: one block
// per new row r. q's heads are rotated into q_out; k's heads are rotated
// (into k_out too, when given, for every row) and, with v's, written into
// the pool row dst[r] (bf16, or int8 codes with a bf16 scale per kv head),
// or dropped when dst[r] lies outside [0, N). Row r reads cos and sin row
// r mod period: a [B * T] prompt shares one [T] table. The math is the
// plain chain's bit for bit: f32 x1 c - x2 s and x1 s + x2 c with each
// product rounded before the add (the _rn intrinsics: nvcc would contract
// a*b - c*d into an FMA), then round-to-nearest-even to bf16; int8 as
// _quantize_kv: amax over hd in f32 of the bf16 row, max(amax, 1e-8) / 127
// rounded to bf16, codes rint(x / scale) clamped to +-127.
struct RopeWriteArgs {
  const bf16* q;      // [R, H, hd]
  const bf16* k;      // [R, Hkv, hd]
  const bf16* v;
  const float* cos;   // [period, hd / 2]
  const float* sin;
  const int* dst;     // [R]
  bf16* q_out;        // [R, H, hd]
  bf16* k_out;        // [R, Hkv, hd] or null
  void* k_pool;       // [N, Hkv, hd] bf16 or int8
  void* v_pool;
  bf16* k_scale;      // Q8: [N, Hkv]
  bf16* v_scale;
  long long n_rows;
  int H, Hkv, period;
};

constexpr int kRopeThreads = 256;

__device__ __forceinline__ void rot(float x1, float x2, float c, float s,
                                    float& y1, float& y2) {
  y1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  y2 = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
}

// One warp writes one kv head of row r: lane l holds dims l + 32 j, the
// rotated (ROPE) or copied bf16 values of K or V.
template <int HD, bool Q8>
__device__ __forceinline__ void write_head(const float (&x)[HD / 32],
                                           void* pool, bf16* scales,
                                           long long d, int Hkv, int kvh,
                                           int lane) {
  const long long row = d * Hkv + kvh;
  if (!Q8) {
    bf16* out = static_cast<bf16*>(pool) + row * HD;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j)
      out[lane + 32 * j] = __float2bfloat16_rn(x[j]);
    return;
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 32; ++j) amax = fmaxf(amax, fabsf(x[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffff, amax, off));
  const bf16 sb = __float2bfloat16_rn(__fdiv_rn(fmaxf(amax, 1e-8f), 127.f));
  const float sf = __bfloat162float(sb);
  int8_t* out = static_cast<int8_t*>(pool) + row * HD;
#pragma unroll
  for (int j = 0; j < HD / 32; ++j) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(x[j], sf)), -127.f), 127.f);
    out[lane + 32 * j] = static_cast<int8_t>(c);
  }
  if (lane == 0) scales[row] = sb;
}

// KOUT: k_out is given (a template argument: a run-time test of it slowed
// the int8 form's short calls measurably).
template <int HD, bool Q8, bool KOUT>
__global__ void __launch_bounds__(kRopeThreads)
    rope_cache_write_kernel(const RopeWriteArgs a) {
  constexpr int HALF = HD / 2;
  const long long r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The table row; a step's table has a row per new row, and then the
  // division is skipped (it sits ahead of every load of the q loop).
  const int trow = a.period == static_cast<int>(gridDim.x)
                       ? static_cast<int>(blockIdx.x)
                       : static_cast<int>(blockIdx.x) % a.period;
  const float* cs = a.cos + trow * HALF;
  const float* sn = a.sin + trow * HALF;
  // q: every (head, i < hd/2) pair.
  const bf16* q = a.q + r * a.H * HD;
  bf16* qo = a.q_out + r * a.H * HD;
  for (int idx = tid; idx < a.H * HALF; idx += kRopeThreads) {
    const int h = idx / HALF, i = idx % HALF;
    float y1, y2;
    rot(__bfloat162float(q[h * HD + i]), __bfloat162float(q[h * HD + i + HALF]),
        cs[i], sn[i], y1, y2);
    qo[h * HD + i] = __float2bfloat16_rn(y1);
    qo[h * HD + i + HALF] = __float2bfloat16_rn(y2);
  }
  const long long d = a.dst[r];
  const bool write = d >= 0 && d < a.n_rows;  // the same for the block
  if (!write && !KOUT) return;
  // k and v: a warp per kv head; lane l holds dims l + 32 j.
  for (int kvh = warp; kvh < a.Hkv; kvh += kRopeThreads / 32) {
    const bf16* k = a.k + (r * a.Hkv + kvh) * HD;
    const bf16* v = a.v + (r * a.Hkv + kvh) * HD;
    float kx[HD / 32], vx[HD / 32];
#pragma unroll
    for (int j = 0; j < HD / 64; ++j) {
      const int i = lane + 32 * j;  // < HALF
      float y1, y2;
      rot(__bfloat162float(k[i]), __bfloat162float(k[i + HALF]), cs[i], sn[i],
          y1, y2);
      // The rotated K as the cache stores it: rounded to bf16 first.
      const bf16 b1 = __float2bfloat16_rn(y1), b2 = __float2bfloat16_rn(y2);
      if (KOUT) {
        bf16* ko = a.k_out + (r * a.Hkv + kvh) * HD;
        ko[i] = b1;
        ko[i + HALF] = b2;
      }
      kx[j] = __bfloat162float(b1);
      kx[j + HD / 64] = __bfloat162float(b2);
    }
    if (!write) continue;
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) vx[j] = __bfloat162float(v[lane + 32 * j]);
    write_head<HD, Q8>(kx, a.k_pool, a.k_scale, d, a.Hkv, kvh, lane);
    write_head<HD, Q8>(vx, a.v_pool, a.v_scale, d, a.Hkv, kvh, lane);
  }
}

cudaError_t rope_cache_write(const RopeWriteArgs& a, int R, int HD, bool q8,
                             void* stream) {
  if (R < 0 || a.H < 1 || a.Hkv < 1 || a.n_rows < 0 || a.period < 1)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SKYPILOT_ROPE_CASE(hd, q)                                        \
  if (HD == hd && q8 == q) {                                             \
    if (a.k_out != nullptr)                                              \
      rope_cache_write_kernel<hd, q, true><<<R, kRopeThreads, 0, st>>>(a); \
    else                                                                 \
      rope_cache_write_kernel<hd, q, false><<<R, kRopeThreads, 0, st>>>(a); \
    return cudaGetLastError();                                           \
  }
  SKYPILOT_ROPE_CASE(64, false)
  SKYPILOT_ROPE_CASE(64, true)
  SKYPILOT_ROPE_CASE(128, false)
  SKYPILOT_ROPE_CASE(128, true)
#undef SKYPILOT_ROPE_CASE
  return cudaErrorInvalidValue;
}

RopeWriteArgs rope_args(const void* q, const void* k, const void* v,
                        const void* cos, const void* sin, const void* dst,
                        void* q_out, void* k_out, void* k_pool, void* v_pool,
                        int H, int Hkv, int period, long long n_rows) {
  RopeWriteArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.dst = static_cast<const int*>(dst);
  a.q_out = static_cast<bf16*>(q_out);
  a.k_out = static_cast<bf16*>(k_out);
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.n_rows = n_rows;
  a.H = H;
  a.Hkv = Hkv;
  a.period = period;
  return a;
}

}  // namespace

// q [R, H, hd], k/v [R, Hkv, hd] bf16 (contiguous), cos/sin [period, hd/2]
// f32 (row r reads row r mod period), dst [R] int32; q_out [R, H, hd];
// k_out [R, Hkv, hd] or null; pools [N, Hkv, hd] bf16.
extern "C" int skypilot_rope_cache_write(
    const void* q, const void* k, const void* v, const void* cos,
    const void* sin, const void* dst, void* q_out, void* k_out, void* k_pool,
    void* v_pool, int R, int H, int Hkv, int HD, int period,
    long long n_rows, void* stream) {
  return rope_cache_write(rope_args(q, k, v, cos, sin, dst, q_out, k_out,
                                    k_pool, v_pool, H, Hkv, period, n_rows),
                          R, HD, false, stream);
}

// The int8 form: int8 code pools [N, Hkv, hd] and bf16 scale pools
// [N, Hkv].
extern "C" int skypilot_rope_cache_write_q8(
    const void* q, const void* k, const void* v, const void* cos,
    const void* sin, const void* dst, void* q_out, void* k_out, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, int R, int H, int Hkv, int HD,
    int period, long long n_rows, void* stream) {
  RopeWriteArgs a = rope_args(q, k, v, cos, sin, dst, q_out, k_out, k_pool,
                              v_pool, H, Hkv, period, n_rows);
  a.k_scale = static_cast<bf16*>(k_scale);
  a.v_scale = static_cast<bf16*>(v_scale);
  return rope_cache_write(a, R, HD, true, stream);
}

// The dynamic shared memory one K4 block asks for (layout plus the
// alignment slack), for a check of the wrapper's copy of the layout
// (ops/decode_attention.py decode_smem_bytes).
extern "C" int skypilot_decode_smem_bytes(int hd, int q8, int hkv,
                                          int max_pages, int rows) {
  return layout(hd, q8 != 0, hkv, max_pages, rows).total + 1024;
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
