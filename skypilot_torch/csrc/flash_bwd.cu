// K2-cuda and K3-cuda: the flash-attention backward for Hopper (sm_90a),
// and the backward's pre-pass kernel.
//
// Replace the TPU kernels skypilot_tpu/ops/attention.py:263
// _bwd_dq_kernel (K2, pallas_call :533) and :331 _bwd_dkv_kernel (K3,
// pallas_call :566), which _bwd_pallas (:492) launches after an XLA pass
// for delta (:505); the pre-pass replaces that pass. Same contract:
//   q/dO [B,T,H,D], k/v [B,S,Hkv,D] bf16 (read through strides), lse f32
//   [B,H,T] in the log2 domain (+1e30 for a row that sees no key, which
//   makes its P and so its gradients exactly 0), optional f32 [T, D]
//   cos/sin tables (T == S) when RoPE was fused into the forward: q/k
//   arrive UN-rotated, and dq/dk are pulled back through the inverse
//   rotation (_rot_inv) in registers before they are stored. dq
//   [B,T,H,D], dk/dv [B,S,Hkv,D] bf16. Native GQA, bottom-right causal
//   alignment q_pos + S - T >= k_pos, any T and S: TMA zero-fills the
//   ragged last tiles, which are masked here and never stored. No
//   atomics: two calls on the same inputs give the same bits.
//
// Pre-pass (skypilot_flash_bwd_prep, one launch before K2): delta =
// rowsum(dO * out) in f32 into [B,H,T], and with tables q and k rotated
// once into scratch the wrapper allocates, by flash_common.cuh's
// rope_item, the code K1's RoPE pre-pass runs, so K2 and K3 read the very
// bits K1 computed lse from. It is bound by bytes (dO and out read, and
// with RoPE q and k read and written once), and reads each row as 16-byte
// vectors, D / 8 lanes a row, reduced by shuffles.
//
// Numerics: P = exp2(S scale log2e - lse) with scale * log2(e) applied
// to the f32 scores (one FMA a score), as K1 does, so P's rows sum to 1
// up to rounding whatever |S| is (a bf16 fold of the scale into q or k,
// as the TPU kernels do, leaves an error that grows with |S|). dS = P
// (dP - delta); the softmax scale is applied once to dq and dk.
//
// What bounds them on the H100: the tensor cores. K2 runs 3 and K3 4
// products of T x S x D per head (halved by the causal mask) against a
// few bytes a row; at T = S = 2048 both are compute-bound by ~100x. The
// design is the forward's (flash_fwd_sm90.cuh), on the same primitives
// (sm90_common.cuh) and product issuers:
// - Block: 3 warpgroups. Warpgroup 0 is the producer: it drops to 24
//   registers (setmaxnreg) and issues TMA from per-call 4-D tensor maps.
//   Warpgroups 1 and 2 are consumers (240 registers) of 64 rows each.
//   Tiles are 64 rows or keys: at D 128, K2's S, dP and dQ
//   accumulators take 128 of a consumer's registers and K3's dK and dV
//   128 more beside S^T and dP^T's 64; a 128-wide tile would not fit.
// - K2 (dQ): one block per (128 q rows, head, batch row), heaviest
//   causal q tile first. Each consumer's Q (rotated) and dO tiles stay
//   resident; K/V tiles of 64 keys stream through a 4-stage ring. Per
//   tile: S = Q K^T and dP = dO V^T (wgmma_ss, both K-major), P and dS
//   in f32 registers, dQ += dS K (wgmma_rs: dS re-packed from the
//   accumulator as the forward re-packs P, K read MN-major from the same
//   tile). Tile kt's two products run while tile kt-1's dQ product
//   drains, and the two consumers take turns to issue (named barriers),
//   so one's elementwise work overlaps the other's products.
// - K3 (dK, dV): one block per (128 keys, kv head, batch row), lightest
//   key tile last; each consumer's K (rotated) and V tiles stay resident.
//   The block loops over the kv head's G query heads and the q tiles the
//   causal bound leaves (the TPU grid's sequential axis), so dK and dV
//   stay f32 in registers for the whole group: one write, no atomics. Q
//   and dO tiles of 64 rows stream through the ring with their lse and
//   delta rows, which the producer warp stages beside them (rows past T
//   read lse +1e30 and delta 0). In the transposed frame (rows = keys):
//   S^T = K Q^T and dP^T = V dO^T (wgmma_ss), P^T and dS^T in registers
//   indexed by the accumulator's column (the q row), then dV += P^T dO
//   and dK += dS^T Q (wgmma_rs, B MN-major from the same tiles). A
//   consumer issues twice a tile, in turns with the other: a second
//   S^T / dP^T register set, which K2's overlap of tiles would need, does
//   not fit at D 128.
//
// Not done (later work): K2 and K3 fused into one pass (needs atomics or
// a reduction pass for dQ), a split of K3's q loop at small B (B1 T 2048
// gives 128 blocks for 132 SMs), TMA stores of the gradients.

#include <math.h>

#include "flash_fwd_sm90.cuh"  // and flash_common.cuh, sm90_common.cuh

namespace {

using flash::bf16;
using flash::kEmptyLse;
using flash_sm90::kConsumerRows;
using flash_sm90::kConsumerRegs;
using flash_sm90::kProducerRegs;
using flash_sm90::kThreads;

constexpr int kTile = 64;    // K2: keys a K/V tile; K3: q rows a Q/dO tile
constexpr int kStages = 4;   // ring depth
constexpr int kBlockRows = 2 * kConsumerRows;  // K2 q rows, K3 keys a block
constexpr int kPrepThreads = 256;

struct BwdParams {
  const float* lse;    // [B, H, T]
  const float* delta;  // [B, H, T]
  const float* cosb;   // [T, D], or null: no RoPE
  const float* sinb;
  bf16* out0;          // K2: dq; K3: dk
  bf16* out1;          // K3: dv
  long long s0[3], s1[3];  // out0 / out1 element strides (batch, row, head)
  int T, S, H, Hkv;
  float scale, scale_log2;
  int causal;
};

// Shared-memory plans (bytes; every tile 1024-byte aligned). A resident
// tile is one consumer's 64 rows x D; a streamed tile kTile rows x D.
template <int D>
struct DqSmem {
  static constexpr int kRes = kConsumerRows * D * 2;
  static constexpr int kKV = kTile * D * 2;
  static constexpr int kQOff = 0;            // 2 consumers' Q
  static constexpr int kDoOff = 2 * kRes;    // 2 consumers' dO
  static constexpr int kKOff = 4 * kRes;     // ring of K tiles
  static constexpr int kVOff = kKOff + kStages * kKV;
  static constexpr int kBarOff = kVOff + kStages * kKV;
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages);
  static constexpr int kLaunchBytes = kBytes + 1024;  // alignment slack
};

template <int D>
struct DkvSmem {
  static constexpr int kRes = kConsumerRows * D * 2;
  static constexpr int kRow = kTile * D * 2;
  static constexpr int kKOff = 0;            // 2 consumers' K
  static constexpr int kVOff = 2 * kRes;     // 2 consumers' V
  static constexpr int kQOff = 4 * kRes;     // ring of Q tiles
  static constexpr int kDoOff = kQOff + kStages * kRow;
  static constexpr int kLseOff = kDoOff + kStages * kRow;  // [stage][row]
  static constexpr int kDeltaOff = kLseOff + kStages * kTile * 4;
  static constexpr int kBarOff = kDeltaOff + kStages * kTile * 4;
  static constexpr int kBytes = kBarOff + 8 * (1 + 2 * kStages);
  static constexpr int kLaunchBytes = kBytes + 1024;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
}

// Load the D / 64 atoms (64 columns each) of one 64-row tile of a map
// (rows from row0 of head `head`, batch row b) into dst; completion on
// bar.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int head,
                                          int b) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
    sm90::tma_load_4d(dst + a * kTile * 128, map, bar, a * 64, row0, head,
                      b);
}

// K2's elementwise step on one 64 x 64 tile: P = exp2(S sl - lse) with 0
// where masked (keys past S, and above the diagonal when causal), then s
// becomes dS = P (dP - delta). Rows r = 0 (r_lo) and 1 (r_lo + 8).
__device__ __forceinline__ void ds_tile(float (&s)[kTile / 2],
                                        const float (&dp)[kTile / 2],
                                        bool masked, int key0, int r_lo,
                                        int t4, const BwdParams& p,
                                        int offset, const float (&lse)[2],
                                        const float (&delta)[2]) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float pr =
          flash_sm90::exp2_fast(fmaf(s[4 * j + e], p.scale_log2, -lse[r]));
      if (masked) {
        const int key = key0 + 8 * j + 2 * t4 + (e & 1);
        const int row = r_lo + 8 * r;
        if (!(key < p.S && (!p.causal || key <= row + offset))) pr = 0.f;
      }
      s[4 * j + e] = pr * (dp[4 * j + e] - delta[r]);
    }
}

// K3's elementwise step on one 64-key x 64-row tile in the transposed
// frame: st becomes P^T = exp2(S^T sl - lse[col]) (0 above the diagonal
// when masked) and dpt dS^T = P^T (dP^T - delta[col]); lse and delta
// are the tile's staged rows. Keys key_lo and key_lo + 8.
__device__ __forceinline__ void dst_tile(float (&st)[kTile / 2],
                                         float (&dpt)[kTile / 2],
                                         bool masked, int r0, int key_lo,
                                         int t4, int offset, float sl,
                                         const float* lse,
                                         const float* delta) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * t4);
    const float2 d =
        *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * t4 + (e & 1);
      float pr = flash_sm90::exp2_fast(
          fmaf(st[4 * j + e], sl, -((e & 1) ? l.y : l.x)));
      if (masked && r0 + col + offset < key_lo + 8 * (e >> 1)) pr = 0.f;
      st[4 * j + e] = pr;
      dpt[4 * j + e] = pr * (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));
    }
  }
}

// Store rows row_lo and row_lo + 8 (those < limit) of an f32 m64nD
// accumulator as bf16 at base + row * st_row.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long st_row,
                                           const float (&acc)[D / 2],
                                           int row_lo, int limit, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= limit) continue;
    bf16* dst = base + row * st_row;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// The consumers' issue turns: consumer c waits on named barrier 1 + c
// and passes to the other on 2 - c (256 threads: both consumers).
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
}

// ---------------------------------------------------------------------
// K2: dQ. Grid (ceil(T / 128), H, B).
// ---------------------------------------------------------------------

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap domap,
              const BwdParams p) {
  using L = DqSmem<D>;
  constexpr int BK = kTile;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* q_full = bars;           // Q and dO landed
  uint64_t* full = bars + 1;         // a stage's K and V landed
  uint64_t* empty = bars + 1 + kStages;

  // Heaviest q tile first: the linear block index walks every (head,
  // batch) of the last tile, then of the one before it, and so on.
  const int per_tile = gridDim.y * gridDim.z;
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int tile = gridDim.x - 1 - lin / per_tile;
  const int h = lin % per_tile % gridDim.y;
  const int b = lin % per_tile / gridDim.y;
  const int q0 = tile * kBlockRows;
  const int kvh = h / (p.H / p.Hkv);
  const int offset = p.S - p.T;

  // Key tiles [0, n_kt) are visible to some row of the block.
  int n_kt = (p.S + BK - 1) / BK;
  if (p.causal) {
    const int last_key = min(q0 + kBlockRows, p.T) - 1 + offset;
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / BK + 1);
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2 * 4);  // one arrival per consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------ producer ---------------------------
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_kt > 0) {
      sm90::prefetch_tensormap(&qmap);
      sm90::prefetch_tensormap(&kmap);
      sm90::prefetch_tensormap(&vmap);
      sm90::prefetch_tensormap(&domap);
      sm90::mbar_arrive_expect_tx(q_full, 4 * L::kRes);
      for (int c = 0; c < 2; ++c) {
        const int row0 = q0 + c * kConsumerRows;
        load_tile<D>(smem + L::kQOff + c * L::kRes, &qmap, q_full, row0, h,
                     b);
        load_tile<D>(smem + L::kDoOff + c * L::kRes, &domap, q_full, row0,
                     h, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, n = kt / kStages;
        if (n > 0) sm90::mbar_wait(&empty[s], (n - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
        load_tile<D>(smem + L::kKOff + s * L::kKV, &kmap, &full[s], kt * BK,
                     kvh, b);
        load_tile<D>(smem + L::kVOff + s * L::kKV, &vmap, &full[s], kt * BK,
                     kvh, b);
      }
    }
  } else {
    // ------------------------------ consumers --------------------------
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int ctid = threadIdx.x - 128 * wg;
    const int warp = ctid / 32;
    const int lane = ctid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int row0 = q0 + c * kConsumerRows;
    const int r_lo = row0 + 16 * warp + g;  // rows r_lo and r_lo + 8

    // Tiles [0, n_full) are visible to every row of this consumer.
    int n_full = p.S / BK;
    if (p.causal) {
      const int first_row_keys = row0 + offset + 1;
      n_full = min(n_full, first_row_keys > 0 ? first_row_keys / BK : 0);
    }
    n_full = min(n_full, n_kt);

    // A row past T gets lse = +1e30, so P = 0.
    float lse[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      const long long i = ((long long)b * p.H + h) * p.T + row;
      lse[r] = row < p.T ? p.lse[i] : kEmptyLse;
      delta[r] = row < p.T ? p.delta[i] : 0.f;
    }

    const uint64_t desc_q =
        sm90::make_desc(smem + L::kQOff + c * L::kRes, 16, 1024);
    const uint64_t desc_do =
        sm90::make_desc(smem + L::kDoOff + c * L::kRes, 16, 1024);
    // K and V as the K-major B of S and dP; K again as the MN-major
    // (transposed) B of dQ += dS K.
    auto desc_k = [&](int kt) {
      return sm90::make_desc(smem + L::kKOff + kt % kStages * L::kKV, 16,
                             1024);
    };
    auto desc_v = [&](int kt) {
      return sm90::make_desc(smem + L::kVOff + kt % kStages * L::kKV, 16,
                             1024);
    };
    auto desc_kt = [&](int kt) {
      return sm90::make_desc(smem + L::kKOff + kt % kStages * L::kKV,
                             BK * 128, 1024);
    };

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float s[BK / 2];           // S, then dS, of the newest key tile
    float dp[BK / 2];          // dP of the newest key tile
    uint32_t pa[BK / 16][4];   // dS of the tile whose dQ product is next

    if (n_kt > 0) {
      if (c == 1) turn_pass(c);  // consumer 0 goes first
      sm90::mbar_wait(q_full, 0);
      sm90::mbar_wait(&full[0], 0);
      turn_wait(c);
      flash_sm90::issue_qk<D, BK>(s, desc_q, desc_k(0));
      flash_sm90::issue_qk<D, BK>(dp, desc_do, desc_v(0));
      turn_pass(c);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      ds_tile(s, dp, n_full == 0, 0, r_lo, t4, p, offset, lse, delta);
      flash_sm90::pack_frags<BK>(pa, s);
      for (int kt = 1; kt < n_kt; ++kt) {
        sm90::mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
        turn_wait(c);
        flash_sm90::issue_qk<D, BK>(s, desc_q, desc_k(kt));
        flash_sm90::issue_qk<D, BK>(dp, desc_do, desc_v(kt));
        flash_sm90::issue_pv<D, BK>(dq, pa, desc_kt(kt - 1));
        turn_pass(c);
        sm90::wgmma_wait<1>();  // S and dP done, dQ may still run
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        ds_tile(s, dp, kt >= n_full, kt * BK, r_lo, t4, p, offset, lse,
                delta);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        flash_sm90::fence_frags<BK>(pa);
        if (lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % kStages]);
        flash_sm90::pack_frags<BK>(pa, s);
      }
      const int last = n_kt - 1;
      turn_wait(c);
      flash_sm90::issue_pv<D, BK>(dq, pa, desc_kt(last));
      turn_pass(c);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      flash_sm90::fence_frags<BK>(pa);
      if (lane == 0) sm90::mbar_arrive(&empty[last % kStages]);
    }

    // Epilogue: dq * scale, back through RoPE, bf16 (rows >= T never).
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] *= p.scale;
    if (ROPE) {
      const int pos[2] = {r_lo < p.T ? r_lo : -1,
                          r_lo + 8 < p.T ? r_lo + 8 : -1};
      flash::rope_inv_acc<D>(dq, pos, t4, p.cosb, p.sinb);
    }
    store_rows<D>(p.out0 + b * p.s0[0] + h * p.s0[2], p.s0[1], dq, r_lo,
                  p.T, t4);
  }
}

// ---------------------------------------------------------------------
// K3: dK, dV. Grid (ceil(S / 128), Hkv, B).
// ---------------------------------------------------------------------

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap domap,
               const BwdParams p) {
  using L = DkvSmem<D>;
  constexpr int BQ = kTile;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + L::kLseOff);
  float* s_delta = reinterpret_cast<float*>(smem + L::kDeltaOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* kv_full = bars;          // K and V landed
  uint64_t* full = bars + 1;         // a stage's Q, dO, lse, delta landed
  uint64_t* empty = bars + 1 + kStages;

  // Heaviest key tile first: under the causal mask the first keys are
  // seen by the most rows.
  const int per_tile = gridDim.y * gridDim.z;
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int tile = lin / per_tile;
  const int kvh = lin % per_tile % gridDim.y;
  const int b = lin % per_tile / gridDim.y;
  const int k0 = tile * kBlockRows;
  const int G = p.H / p.Hkv;
  const int offset = p.S - p.T;

  // q tiles [qt0, n_qt) of each of the G heads hold every row that sees
  // a key of this block.
  const int n_qt = (p.T + BQ - 1) / BQ;
  int qt0 = 0;
  if (p.causal) {
    const int first_row = k0 - offset;  // the first row that sees key k0
    qt0 = first_row <= 0 ? 0 : min(n_qt, first_row / BQ);
  }
  const int per_head = n_qt - qt0;
  const int n_it = G * per_head;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // every lane of the producer warp
      sm90::mbar_init(&empty[s], 2 * 4);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------ producer ---------------------------
    // Warp 0: each lane stages its share of a tile's lse and delta rows
    // and arrives; lane 0 also issues the tile's TMA loads.
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32 && n_it > 0) {
      if (lane == 0) {
        sm90::prefetch_tensormap(&qmap);
        sm90::prefetch_tensormap(&kmap);
        sm90::prefetch_tensormap(&vmap);
        sm90::prefetch_tensormap(&domap);
        sm90::mbar_arrive_expect_tx(kv_full, 4 * L::kRes);
        for (int c = 0; c < 2; ++c) {
          const int key0 = k0 + c * kConsumerRows;
          load_tile<D>(smem + L::kKOff + c * L::kRes, &kmap, kv_full, key0,
                       kvh, b);
          load_tile<D>(smem + L::kVOff + c * L::kRes, &vmap, kv_full, key0,
                       kvh, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages, n = it / kStages;
        if (n > 0) sm90::mbar_wait(&empty[s], (n - 1) & 1);
        const int h = kvh * G + it / per_head;
        const int r0 = (qt0 + it % per_head) * BQ;
        const long long stat = ((long long)b * p.H + h) * p.T;
        for (int i = lane; i < BQ; i += 32) {
          const bool in = r0 + i < p.T;
          s_lse[s * BQ + i] = in ? p.lse[stat + r0 + i] : kEmptyLse;
          s_delta[s * BQ + i] = in ? p.delta[stat + r0 + i] : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[s], 2 * L::kRow);
          load_tile<D>(smem + L::kQOff + s * L::kRow, &qmap, &full[s], r0,
                       h, b);
          load_tile<D>(smem + L::kDoOff + s * L::kRow, &domap, &full[s], r0,
                       h, b);
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ------------------------------ consumers --------------------------
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int ctid = threadIdx.x - 128 * wg;
    const int warp = ctid / 32;
    const int lane = ctid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int kc0 = k0 + c * kConsumerRows;
    const int key_lo = kc0 + 16 * warp + g;  // keys key_lo and key_lo + 8

    const uint64_t desc_k =
        sm90::make_desc(smem + L::kKOff + c * L::kRes, 16, 1024);
    const uint64_t desc_v =
        sm90::make_desc(smem + L::kVOff + c * L::kRes, 16, 1024);
    // Q and dO as the K-major B of S^T and dP^T, and as the MN-major B of
    // dK += dS^T Q and dV += P^T dO.
    auto desc_q = [&](int s, int lbo) {
      return sm90::make_desc(smem + L::kQOff + s * L::kRow, lbo, 1024);
    };
    auto desc_do = [&](int s, int lbo) {
      return sm90::make_desc(smem + L::kDoOff + s * L::kRow, lbo, 1024);
    };

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[BQ / 2];          // S^T, then P^T
    float dpt[BQ / 2];         // dP^T, then dS^T
    uint32_t pa[BQ / 16][4];   // P^T as A fragments
    uint32_t da[BQ / 16][4];   // dS^T as A fragments

    if (n_it > 0) {
      if (c == 1) turn_pass(c);  // consumer 0 goes first
      sm90::mbar_wait(kv_full, 0);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int r0 = (qt0 + it % per_head) * BQ;
        sm90::mbar_wait(&full[s], (it / kStages) & 1);
        turn_wait(c);
        flash_sm90::issue_qk<D, BQ>(st, desc_k, desc_q(s, 16));
        flash_sm90::issue_qk<D, BQ>(dpt, desc_v, desc_do(s, 16));
        turn_pass(c);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        // Some (row, key) pair of the tile is hidden when its first row
        // does not see this consumer's last key.
        const bool masked =
            p.causal && r0 + offset < kc0 + kConsumerRows - 1;
        dst_tile(st, dpt, masked, r0, key_lo, t4, offset, p.scale_log2,
                 s_lse + s * BQ, s_delta + s * BQ);
        flash_sm90::pack_frags<BQ>(pa, st);
        flash_sm90::pack_frags<BQ>(da, dpt);
        turn_wait(c);
        flash_sm90::issue_pv<D, BQ>(dv, pa, desc_do(s, BQ * 128));
        flash_sm90::issue_pv<D, BQ>(dk, da, desc_q(s, BQ * 128));
        turn_pass(c);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        flash_sm90::fence_frags<BQ>(pa);
        flash_sm90::fence_frags<BQ>(da);
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
      }
    }

    // Epilogue: dk * scale, back through RoPE (table row = key position),
    // dk and dv in bf16 (keys >= S never).
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] *= p.scale;
    if (ROPE) {
      const int pos[2] = {key_lo < p.S ? key_lo : -1,
                          key_lo + 8 < p.S ? key_lo + 8 : -1};
      flash::rope_inv_acc<D>(dk, pos, t4, p.cosb, p.sinb);
    }
    store_rows<D>(p.out0 + b * p.s0[0] + kvh * p.s0[2], p.s0[1], dk,
                  key_lo, p.S, t4);
    store_rows<D>(p.out1 + b * p.s1[0] + kvh * p.s1[2], p.s1[1], dv,
                  key_lo, p.S, t4);
  }
}

// ---------------------------------------------------------------------
// The pre-pass.
// ---------------------------------------------------------------------

// delta[b, h, t] = sum_d dO * out: D / 8 lanes a row, each reading 16
// bytes of both, rows in delta's own order so its writes are contiguous.
// The loop runs warp-uniformly so a row's lanes can reduce by shuffles.
// Then, with tables, every rope item.
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const bf16* __restrict__ dO, const bf16* __restrict__ out,
                float* __restrict__ delta, long long do_sb, long long do_st,
                long long do_sh, long long o_sb, long long o_st,
                long long o_sh, int B, int T, int H,
                const flash::RopeArgs ra, int rope) {
  constexpr int LANES = D / 8;
  const int lane = threadIdx.x % 32;
  const long long first = blockIdx.x * (long long)kPrepThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kPrepThreads;
  const long long n = (long long)B * H * T * LANES;
  for (long long base = first - lane; base < n; base += stride) {
    const long long i = base + lane;
    const long long row = i / LANES;
    float acc = 0.f;
    if (i < n) {
      const int col = int(i % LANES) * 8;
      const int t = int(row % T);
      const int h = int(row / T % H);
      const int b = int(row / T / H);
      const uint4 x = *reinterpret_cast<const uint4*>(
          dO + b * do_sb + t * do_st + h * do_sh + col);
      const uint4 y = *reinterpret_cast<const uint4*>(
          out + b * o_sb + t * o_st + h * o_sh + col);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 u = __bfloat1622float2(x2[e]);
        const float2 v = __bfloat1622float2(y2[e]);
        acc = fmaf(u.x, v.x, acc);
        acc = fmaf(u.y, v.y, acc);
      }
    }
#pragma unroll
    for (int m = LANES / 2; m > 0; m >>= 1)
      acc += __shfl_xor_sync(0xffffffff, acc, m);
    if (i < n && lane % LANES == 0) delta[row] = acc;
  }
  if (rope) {
    const long long nr = flash::rope_items<D>(ra);
    for (long long i = first; i < nr; i += stride) flash::rope_item<D>(ra, i);
  }
}

// ---------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------

// ptrs: q, k, v, dO, lse, delta, cos, sin, out0[, out1]; strides: the
// (b, t/s, h) element strides of q, k, v, dO, out0, out1.
template <int D, bool ROPE, bool DQ>
cudaError_t launch(const void* const* ptrs, int B, int T, int S, int H,
                   int Hkv, const long long* st, float scale,
                   float scale_log2, int causal, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  cudaError_t err;
  if ((err = sm90::make_map(&qm, ptrs[0], D, T, H, B, st[1], st[2], st[0],
                            kTile)) != cudaSuccess ||
      (err = sm90::make_map(&km, ptrs[1], D, S, Hkv, B, st[4], st[5], st[3],
                            kTile)) != cudaSuccess ||
      (err = sm90::make_map(&vm, ptrs[2], D, S, Hkv, B, st[7], st[8], st[6],
                            kTile)) != cudaSuccess ||
      (err = sm90::make_map(&dom, ptrs[3], D, T, H, B, st[10], st[11],
                            st[9], kTile)) != cudaSuccess)
    return err;
  BwdParams p{};
  p.lse = static_cast<const float*>(ptrs[4]);
  p.delta = static_cast<const float*>(ptrs[5]);
  p.cosb = static_cast<const float*>(ptrs[6]);
  p.sinb = static_cast<const float*>(ptrs[7]);
  p.out0 = static_cast<bf16*>(const_cast<void*>(ptrs[8]));
  p.out1 = DQ ? nullptr : static_cast<bf16*>(const_cast<void*>(ptrs[9]));
  for (int i = 0; i < 3; ++i) {
    p.s0[i] = st[12 + i];
    p.s1[i] = st[15 + i];
  }
  p.T = T;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.scale = scale;
  p.scale_log2 = scale_log2;
  p.causal = causal;
  constexpr int smem = DQ ? DqSmem<D>::kLaunchBytes : DkvSmem<D>::kLaunchBytes;
  static_assert(smem <= 232448, "more shared memory than a block may use");
  auto kernel = DQ ? dq_kernel<D, ROPE> : dkv_kernel<D, ROPE>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((DQ ? T : S) + kBlockRows - 1) / kBlockRows,
                  DQ ? H : Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, dom, p);
  return cudaGetLastError();
}

template <bool DQ>
int dispatch(const void* const* ptrs, int B, int T, int S, int H, int Hkv,
             int D, const long long* st, float scale, float scale_log2,
             int causal, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 ||
      (ptrs[6] != nullptr && T != S))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rope = ptrs[6] != nullptr;
  if (D == 64)
    return rope ? launch<64, true, DQ>(ptrs, B, T, S, H, Hkv, st, scale,
                                       scale_log2, causal, s)
                : launch<64, false, DQ>(ptrs, B, T, S, H, Hkv, st, scale,
                                        scale_log2, causal, s);
  if (D == 128)
    return rope ? launch<128, true, DQ>(ptrs, B, T, S, H, Hkv, st, scale,
                                        scale_log2, causal, s)
                : launch<128, false, DQ>(ptrs, B, T, S, H, Hkv, st, scale,
                                         scale_log2, causal, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t prep(const void* const* ptrs, int B, int T, int H, int Hkv,
                 const long long* st, cudaStream_t stream) {
  const bool rope = ptrs[4] != nullptr;
  const flash::RopeArgs ra{
      static_cast<const bf16*>(ptrs[2]), static_cast<const bf16*>(ptrs[3]),
      static_cast<const float*>(ptrs[4]), static_cast<const float*>(ptrs[5]),
      static_cast<bf16*>(const_cast<void*>(ptrs[6])),
      static_cast<bf16*>(const_cast<void*>(ptrs[7])), B, T, H, Hkv, st[6],
      st[7], st[8], st[9], st[10], st[11], (long long)T * H * D,
      (long long)H * D, D};
  long long items = (long long)B * H * T * (D / 8);
  if (rope && flash::rope_items<D>(ra) > items)
    items = flash::rope_items<D>(ra);
  const long long want = (items + kPrepThreads - 1) / kPrepThreads;
  const int blocks = int(want < 65535 ? want : 65535);  // grid-stride
  prep_kernel<D><<<blocks, kPrepThreads, 0, stream>>>(
      static_cast<const bf16*>(ptrs[0]), static_cast<const bf16*>(ptrs[1]),
      static_cast<float*>(const_cast<void*>(ptrs[8])), st[0], st[1], st[2],
      st[3], st[4], st[5], B, T, H, ra, rope ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// ptrs: q (rotated with RoPE), k (rotated), v, dO, lse, delta, cos, sin,
// dq (cos = sin = NULL: no RoPE). strides: 18 = the (b, t, h) element
// strides of q, k, v, dO, dq, then three unused.
extern "C" int skypilot_flash_bwd_dq(const void* const* ptrs, int B, int T,
                                     int S, int H, int Hkv, int D,
                                     const long long* strides, float scale,
                                     float scale_log2, int causal,
                                     void* stream) {
  return dispatch<true>(ptrs, B, T, S, H, Hkv, D, strides, scale,
                        scale_log2, causal, stream);
}

// ptrs: q (rotated), k (rotated), v, dO, lse, delta, cos, sin, dk, dv.
// strides: (b, t/s, h) element strides of q, k, v, dO, dk, dv.
extern "C" int skypilot_flash_bwd_dkv(const void* const* ptrs, int B, int T,
                                      int S, int H, int Hkv, int D,
                                      const long long* strides, float scale,
                                      float scale_log2, int causal,
                                      void* stream) {
  return dispatch<false>(ptrs, B, T, S, H, Hkv, D, strides, scale,
                         scale_log2, causal, stream);
}

// ptrs: dO, out, q, k, cos, sin, q_rot, k_rot, delta (cos = sin = NULL:
// delta only; q, k, q_rot, k_rot unused). q_rot [B,T,H,D] and k_rot
// [B,S,Hkv,D] are contiguous, delta [B,H,T] f32 contiguous. strides: the
// (b, t, h) element strides of dO, out, q, k.
extern "C" int skypilot_flash_bwd_prep(const void* const* ptrs, int B, int T,
                                       int S, int H, int Hkv, int D,
                                       const long long* strides,
                                       void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 ||
      (ptrs[4] != nullptr && (T != S || ptrs[5] == nullptr ||
                              ptrs[6] == nullptr || ptrs[7] == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return prep<64>(ptrs, B, T, H, Hkv, strides, s);
  if (D == 128) return prep<128>(ptrs, B, T, H, Hkv, strides, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* skypilot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
