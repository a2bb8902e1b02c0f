// The Hopper (sm_90a) flash-attention forward mainloop shared by K1
// (flash_fwd.cu, one head per block) and K6 (attention_packed.cu, a head
// pair per block); the backward (flash_bwd.cu) reuses its product
// issuers (issue_qk, issue_pv), exp2 and fragment re-pack.
//
// Contract of the mainloop: q rows, k/v keys, out rows of one head are
// read and written through strides (any [B,T,H,D] or [B,H,T,D] view with
// a unit-stride D), lse f32 [B,H,T] in the log2 domain; head h reads KV
// head h / (H / Hkv); causal masking is bottom-right aligned (q_pos + S -
// T >= k_pos) or off; a row that sees no key gets out = 0 and lse =
// +1e30. Any T and S: the ragged last q and key tiles are masked here.
//
// What bounds it on the H100: at prefill lengths the two products per
// tile make it compute-bound (4 D FLOPs per visible (q, k) pair against
// ~4 D bytes per key reused by a whole q tile), so the design is about
// keeping the tensor cores fed:
//
// - Block: 3 warpgroups (384 threads, one block per SM). Warpgroup 0 is
//   the producer: it drops to 24 registers (setmaxnreg) and one thread
//   issues every TMA load. Warpgroups 1 and 2 are consumers (240
//   registers); each owns 64 q rows: K1 gives them rows q0..q0+63 and
//   q0+64..q0+127 of one head, K6 the same 64 rows of the pair's two
//   heads.
// - Shared memory, all in the 128-byte swizzle wgmma reads (sm90_common):
//   the two consumers' Q tiles (64 x D each), then a ring of STAGES
//   stages of BK-key K and V tiles (NKV kv heads each: 2 when K6 pairs
//   heads that do not share a kv head), with full barriers (TMA bytes
//   landed, K and V apart so S = Q K^T starts before V is in) and an
//   empty barrier (both consumers' 8 warps done with the stage).
// - S = Q K^T: wgmma m64nBKk16, both operands K-major in shared memory.
//   O += P V: wgmma m64nDk16 with P from registers (the f32 S fragment
//   re-packs as the bf16 A fragment with no shuffle) and V MN-major
//   (transposed) in shared memory.
// - Schedule: inside a consumer, tile kt's Q K^T and tile kt-1's P V are
//   in flight together; the softmax of tile kt runs while that P V
//   drains, and O is rescaled and P re-packed only after it has. Across
//   the two consumers, a ping-pong of named barriers lets them issue
//   their products in turn, so one's softmax overlaps the other's wgmma.
// - Softmax: online, in exp2 with f32 statistics. scale * log2(e) is
//   applied to S in f32 inside the exponent (one FMA a score), not
//   folded into a bf16 copy of q as the TPU kernel does; row maxima are
//   kept on the unscaled scores. A row that has seen no key keeps m =
//   -inf and subtracts 0.
// - Causal structure: key tiles visible to every row of a consumer run
//   mask-free, tiles that straddle the diagonal or the end of S are
//   masked (TMA zero-fills keys past S, so they are masked here), and
//   tiles hidden from the whole block are never loaded. Blocks are
//   scheduled heaviest q tile first across all heads and batch rows, so
//   the last wave holds the light tiles.
// - Epilogue: out = O / l in bf16 straight from registers (rows >= T are
//   never stored), lse from the consumer's row statistics.
//
// Not done (later work): a TMA store of out, and a persistent tile
// scheduler that pays at every head_dim (a static, snake-ordered one was
// faster at D 128 and slower at D 64, so blocks are left to the
// hardware's scheduler).
#pragma once

#include <math.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace flash_sm90 {

using flash::bf16;
using flash::kEmptyLse;
using flash::pack_bf16;

constexpr int kThreads = 384;        // producer + 2 consumer warpgroups
constexpr int kConsumerRows = 64;    // q rows a consumer warpgroup owns
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

struct FwdParams {
  bf16* out;
  float* lse;
  long long o_sb, o_st, o_sh;  // out strides (elements): batch, row, head
  int T, S, H, Hkv;
  float scale_log2;            // scale * log2(e)
  int causal;
};

// Shared-memory plan of one instantiation (bytes; every tile 1024-byte
// aligned).
template <int D, int BK, int STAGES, int NKV>
struct Smem {
  static constexpr int kAtom = 64 * 2;              // one atom row: 128 B
  static constexpr int kQ = kConsumerRows * D * 2;  // one consumer's Q
  static constexpr int kKV = BK * D * 2;            // one kv head's tile
  static constexpr int kStage = NKV * kKV;
  static constexpr int kQOff = 0;
  static constexpr int kKOff = 2 * kQ;
  static constexpr int kVOff = kKOff + STAGES * kStage;
  static constexpr int kBarOff = kVOff + STAGES * kStage;
  static constexpr int kBytes = kBarOff + 8 * (1 + 3 * STAGES);
  static constexpr int kLaunchBytes = kBytes + 1024;  // alignment slack
};

template <int BK>
__device__ __forceinline__ void fence_frags(uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) sm90::fence_regs(pa[kk]);
}

// Issue S = Q K^T (64 rows x BK keys, K = D) into sc; committed, not
// waited. Q and K are K-major: the kk-th 16-column slice of a tile lies
// in its kk / 4-th 64-column atom, at 32 (kk % 4) bytes into each row.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2],
                                         uint64_t desc_q, uint64_t desc_k) {
  sm90::fence_regs(sc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qoff = (kk / 4) * kConsumerRows * 128 + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * BK * 128 + (kk % 4) * 32;
    sm90::wgmma_ss<BK>(sc, desc_q + (qoff >> 4), desc_k + (koff >> 4),
                       kk > 0);
  }
  sm90::wgmma_commit();
}

// Issue O += P V (K = BK keys, 16 a step: 16 rows of 128 bytes of the V
// tile); committed, not waited.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         uint64_t desc_v) {
  sm90::fence_regs(o);
  fence_frags<BK>(pa);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    sm90::wgmma_rs<D>(o, pa[kk], desc_v + ((kk * 16 * 128) >> 4), 1);
  sm90::wgmma_commit();
}

// 2^x on the SFU; 2^-inf = 0.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one key tile in the log2 domain: masks it if asked
// (keys past S, and above the diagonal when causal), updates the row
// maxima (of unscaled scores) and this thread's row sums, turns sc into
// P = 2^(scale log2e (s - m)) and returns each row's rescale factor.
// Rows r = 0 (r_lo) and 1 (r_lo + 8).
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], bool masked, int key0, int r_lo, int t4,
    const FwdParams& p, int offset, float (&m_run)[2], float (&l_run)[2],
    float (&alpha)[2]) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * t4 + (e & 1);
        const int row = r_lo + (e >> 1) * 8;
        const bool ok = key < p.S && (!p.causal || key <= row + offset);
        if (!ok) sc[4 * j + e] = -INFINITY;
      }
  }
  const float sl = p.scale_log2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    // A row that has seen no key yet keeps m = -inf; subtract 0 then so
    // 2^(-inf - m) is 0, never NaN.
    const float ms = (m_new == -INFINITY ? 0.f : m_new) * sl;
    alpha[r] = exp2_fast(m_run[r] * sl - ms);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j + 2 * r] = exp2_fast(fmaf(sc[4 * j + 2 * r], sl, -ms));
      sc[4 * j + 2 * r + 1] =
          exp2_fast(fmaf(sc[4 * j + 2 * r + 1], sl, -ms));
      sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
    l_run[r] = l_run[r] * alpha[r] + sum;
    m_run[r] = m_new;
  }
}

// The f32 accumulator fragment of a 64 x BK tile re-packed as the bf16 A
// fragments of a following wgmma_rs (K = BK): the fragment of columns
// 16kk..16kk+15 is exactly the m16n8k16 A fragment, so no data moves
// between threads.
template <int BK>
__device__ __forceinline__ void pack_frags(uint32_t (&pa)[BK / 16][4],
                                          const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// O *= alpha per row, then P (sc) re-packed as the A fragments of the
// next P V.
template <int D, int BK>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2],
                                             uint32_t (&pa)[BK / 16][4],
                                             const float (&sc)[BK / 2],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  pack_frags<BK>(pa, sc);
}

// PAIRED = false (K1): grid (ceil(T / 128), H, B), one head a block.
// PAIRED = true (K6): grid (ceil(T / 64), H / 2, B), heads 2y and 2y + 1.
template <int D, int BK, int STAGES, int NKV, bool PAIRED>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const FwdParams p) {
  using L = Smem<D, BK, STAGES, NKV>;
  constexpr int ATOMS = D / 64;
  constexpr int BLOCK_ROWS = PAIRED ? kConsumerRows : 2 * kConsumerRows;
  static_assert(D % 64 == 0 && BK % 16 == 0 && BK <= 256, "tile shape");
  static_assert(NKV == 1 || PAIRED, "two kv heads only when paired");

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  // Heaviest q tile first: the linear block index walks every (head,
  // batch) of the last tile, then of the one before it, and so on.
  const int per_tile = gridDim.y * gridDim.z;
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int tile = gridDim.x - 1 - lin / per_tile;
  const int hy = lin % per_tile % gridDim.y;
  const int b = lin % per_tile / gridDim.y;
  const int q0 = tile * BLOCK_ROWS;
  const int groups = p.H / p.Hkv;
  const int offset = p.S - p.T;

  // Key tiles [0, n_kt) are visible to some row of the block; later ones
  // are hidden (causal) or past S and never loaded.
  int n_kt = (p.S + BK - 1) / BK;
  if (p.causal) {
    const int last_key = min(q0 + BLOCK_ROWS, p.T) - 1 + offset;
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / BK + 1);
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
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
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::kQ);
      for (int c = 0; c < 2; ++c) {
        const int head = PAIRED ? 2 * hy + c : hy;
        const int row0 = PAIRED ? q0 : q0 + c * kConsumerRows;
        for (int a = 0; a < ATOMS; ++a)
          sm90::tma_load_4d(smem + L::kQOff + c * L::kQ +
                                a * kConsumerRows * L::kAtom,
                            &qmap, q_full, a * 64, row0, head, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES, n = kt / STAGES;
        if (n > 0) sm90::mbar_wait(&empty[s], (n - 1) & 1);
        sm90::mbar_arrive_expect_tx(&k_full[s], L::kStage);
        for (int j = 0; j < NKV; ++j) {
          const int kvh = PAIRED ? (2 * hy + j) / groups : hy / groups;
          for (int a = 0; a < ATOMS; ++a)
            sm90::tma_load_4d(smem + L::kKOff + s * L::kStage + j * L::kKV +
                                  a * BK * L::kAtom,
                              &kmap, &k_full[s], a * 64, kt * BK, kvh, b);
        }
        sm90::mbar_arrive_expect_tx(&v_full[s], L::kStage);
        for (int j = 0; j < NKV; ++j) {
          const int kvh = PAIRED ? (2 * hy + j) / groups : hy / groups;
          for (int a = 0; a < ATOMS; ++a)
            sm90::tma_load_4d(smem + L::kVOff + s * L::kStage + j * L::kKV +
                                  a * BK * L::kAtom,
                              &vmap, &v_full[s], a * 64, kt * BK, kvh, b);
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
    const int head = PAIRED ? 2 * hy + c : hy;
    const int row0 = PAIRED ? q0 : q0 + c * kConsumerRows;
    const int r_lo = row0 + 16 * warp + g;  // this thread's rows: r_lo and
                                            // r_lo + 8
    const int slot = NKV == 1 ? 0 : c;
    const float sl = p.scale_log2;

    // Tiles [0, n_full) are visible to every row of this consumer.
    int n_full = p.S / BK;
    if (p.causal) {
      const int first_row_keys = row0 + offset + 1;
      n_full = min(n_full, first_row_keys > 0 ? first_row_keys / BK : 0);
    }
    n_full = min(n_full, n_kt);

    const uint64_t desc_q =
        sm90::make_desc(smem + L::kQOff + c * L::kQ, 16, 1024);
    auto desc_k = [&](int kt) {
      return sm90::make_desc(
          smem + L::kKOff + kt % STAGES * L::kStage + slot * L::kKV, 16,
          1024);
    };
    auto desc_v = [&](int kt) {
      return sm90::make_desc(
          smem + L::kVOff + kt % STAGES * L::kStage + slot * L::kKV,
          BK * 128, 1024);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // of unscaled scores
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];
    float sc[BK / 2];             // S, then P, of the newest key tile
    uint32_t pa[BK / 16][4];      // P of the tile whose O += P V is next

    // Tile kt's Q K^T runs on the tensor cores while the softmax of tile
    // kt - 1 finishes and its P V is issued; the P V runs while tile kt's
    // softmax statistics are computed. O is rescaled and the new P packed
    // only once that P V has drained.
    // Ping-pong: the consumers take turns to issue their products (named
    // barriers 1 and 2), so one's softmax overlaps the other's wgmma.
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
    };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
    };
    if (n_kt > 0) {
      if (c == 1) turn_pass();  // consumer 0 goes first
      sm90::mbar_wait(q_full, 0);
      sm90::mbar_wait(&k_full[0], 0);
      turn_wait();
      issue_qk<D, BK>(sc, desc_q, desc_k(0));
      turn_pass();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      softmax_tile<BK>(sc, n_full == 0, 0, r_lo, t4, p, offset, m_run,
                       l_run, alpha);
      rescale_pack<D, BK>(o, pa, sc, alpha);
      for (int kt = 1; kt < n_kt; ++kt) {
        sm90::mbar_wait(&k_full[kt % STAGES], (kt / STAGES) & 1);
        sm90::mbar_wait(&v_full[(kt - 1) % STAGES],
                        ((kt - 1) / STAGES) & 1);
        turn_wait();
        issue_qk<D, BK>(sc, desc_q, desc_k(kt));
        issue_pv<D, BK>(o, pa, desc_v(kt - 1));
        turn_pass();
        sm90::wgmma_wait<1>();  // Q K^T done, P V may still run
        sm90::fence_regs(sc);
        softmax_tile<BK>(sc, kt >= n_full, kt * BK, r_lo, t4, p, offset,
                         m_run, l_run, alpha);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        fence_frags<BK>(pa);
        if (lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % STAGES]);
        rescale_pack<D, BK>(o, pa, sc, alpha);
      }
      const int last = n_kt - 1;
      sm90::mbar_wait(&v_full[last % STAGES], (last / STAGES) & 1);
      turn_wait();
      issue_pv<D, BK>(o, pa, desc_v(last));
      turn_pass();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      fence_frags<BK>(pa);
      if (lane == 0) sm90::mbar_arrive(&empty[last % STAGES]);
    }

    // Epilogue: out = O / l (0 for a row that saw no key), lse.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffff, l, 1);
      l += __shfl_xor_sync(0xffffffff, l, 2);
      const int row = r_lo + 8 * r;
      if (row >= p.T) continue;
      // l == 0 exactly when the row saw no key (its own max contributes
      // exp2(0) = 1 otherwise).
      const float inv = l > 0.f ? 1.f / l : 0.f;
      bf16* orow = p.out + b * p.o_sb + row * p.o_st + head * p.o_sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
      if (t4 == 0)
        p.lse[((long long)b * p.H + head) * p.T + row] =
            l > 0.f ? m_run[r] * sl + log2f(l) : kEmptyLse;
    }
  }
}

// Sets the kernel's dynamic shared memory and launches it on `stream`.
template <int D, int BK, int STAGES, int NKV, bool PAIRED>
cudaError_t launch_fwd(const CUtensorMap& qmap, const CUtensorMap& kmap,
                       const CUtensorMap& vmap, const FwdParams& p,
                       dim3 grid, cudaStream_t stream) {
  constexpr int smem = Smem<D, BK, STAGES, NKV>::kLaunchBytes;
  static_assert(smem <= 232448, "more shared memory than a block may use");
  auto kernel = fwd_kernel<D, BK, STAGES, NKV, PAIRED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(qmap, kmap, vmap, p);
  return cudaGetLastError();
}

}  // namespace flash_sm90
