"""Length-aware decode attention and the per-row KV-cache write — the
port of ``skypilot_tpu/ops/decode_attention.py``.

Kernels (``csrc/decode_attention.cu``, hand-written replacements of the
TPU kernels), each launched for CUDA tensors, with its plain PyTorch
version beside it for CPU tensors (any other device raises):

- ``decode_attention``: K4-cuda, split-K flash-decoding for a dense
  cache (replaces ``_decode_attn_kernel``): 64-key tiles by TMA, the
  products on the tensor cores, the merge of the splits folded into the
  same launch. As in the TPU kernel, a length is clamped to
  ``max(len, 1)`` (and to S).
- ``prefill_attention``: K4-prefill (``csrc/prefill_attention.cu``), the
  engine's prefill chunk (query j attending ``lengths[b] + j`` keys) in
  one launch: the pool read through the block table (int8: codes widened
  in the kernel, the chunk's own exact rows from its start), each split's
  partial through an f32 scratch the wrapper allocates; each row's
  arithmetic is K4's, so a bf16 chunk row is bit-equal to K4-paged's
  decode step at the same position. ``verify_attention`` is its dense
  form over a contiguous cache.
- ``paged_decode_attention`` / ``paged_verify_attention``: K4-paged,
  the same kernel reading the block table directly where the JAX
  package gathers every row's pages into a contiguous view first; W = 1
  query position per row (decode) or W = draft_k + 1 (speculative
  verify, query j attending ``lengths[b] + j`` positions), all W
  positions served by one read of each key.
- ``cache_write``: K5-cuda, R new K/V rows written in place into a flat
  row view at given row indices (replaces ``_cache_write_kernel``);
  ``rows_dst`` gives the TPU kernel's own rows form
  (``dst = b * S + pos[b]``) over a [B * S] view. No serving path runs
  it: each writes through K5F.
- ``rope_cache_write``: K5F, the new rows of every serving forward (the
  decode and verify steps, the engine's prefill chunk, the engine-off
  prompt and decode step) in one launch a layer: q and k rotated (RoPE
  from the forward's cos and sin table), k and v quantized when the pool
  is int8, and written in place; the rotated k rows too when asked
  (``k_out``); its plain version is the chain it replaces, bit for bit.

Every K4 form is batch-invariant on the card: a query row's bits do not
depend on B, W or the rows beside it (``decode_split_plan`` reads S
alone, and the kernel meets a row's keys in one order).

Each entry also takes int8 KV, as the JAX package's caches and pools
hold it: int8 codes with one bf16 scale per (row, kv head),
``k_scale``/``v_scale`` beside k/v (and, for the write, the new rows'
scales ``ks_new``/``vs_new``). The attention entries dequantize as the
JAX ``_dequant_kv`` does, in q's dtype (``code * scale`` rounded once),
then attend; on the card the same kernel templates read the codes
(``*_Q8`` launch counts, kept apart from the bf16 ones), the write
copies code and scale rows in one launch.
"""
import ctypes
from typing import Optional

import torch

from skypilot_torch.ops import _build
from skypilot_torch.serve import kv_pool as kv_pool_lib

LOG2E = 1.4426950408889634
_NEG_INF = -1e30
# K4's shapes (csrc/decode_attention.cu): keys per tile (kTile), tiles in
# the shared-memory ring (kStages), the page sizes its per-page copies
# take (a page is one TMA box, and a 64-key tile holds whole pages), the
# longest split (its page entries sit in shared memory) and the shared
# memory a block may use.
DECODE_TILE = 64
DECODE_STAGES = 3
DECODE_PAGE_SIZES = (8, 16, 32, 64)
DECODE_MAX_SMEM = 232448
# Keys per split, the same for every call: a row's keys split at the same
# points whatever B, W or S, which is what makes K4 batch-invariant. At
# the engine's S = 8192 a full row is 32 splits, about the blocks a B 8
# decode at 2048-key contexts needs to fill the card.
DECODE_CHUNK = 256
# m-tiles of 16 query rows one K4 block takes (kPassesPerBlock): a call
# with more spreads them over groups of blocks, each with its own merge
# counter per (row, kv head).
DECODE_PASSES_PER_BLOCK = 4

# The dense entry, W = 1 (decode) or W > 1 (its verify form, K4's prefill
# form before K4-prefill).
DECODE_ATTENTION = _build.Kernel(
    'decode_attention', 'skypilot_decode_attention',
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4 +
    [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_PAGED_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 +
               [ctypes.c_longlong] + [ctypes.c_int] * 3 +
               [ctypes.c_longlong] * 2 +
               [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p])
# One C entry, two counts: decode (W = 1) and speculative verify (W > 1)
# launches are told apart so a run can match each to its dispatches.
PAGED_DECODE_ATTENTION = _build.Kernel(
    'decode_attention', 'skypilot_paged_decode_attention', _PAGED_ARGS)
PAGED_VERIFY_ATTENTION = _build.Kernel(
    'decode_attention', 'skypilot_paged_decode_attention', _PAGED_ARGS)
CACHE_WRITE = _build.Kernel(
    'decode_attention', 'skypilot_cache_write',
    [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_void_p])
# The int8 forms: the same kernel templates over int8 codes + bf16 scales.
DECODE_ATTENTION_Q8 = _build.Kernel(
    'decode_attention', 'skypilot_decode_attention_q8',
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_void_p])
_PAGED_Q8_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 +
                  [ctypes.c_longlong] + [ctypes.c_int] * 3 +
                  [ctypes.c_longlong] * 4 +
                  [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p])
PAGED_DECODE_ATTENTION_Q8 = _build.Kernel(
    'decode_attention', 'skypilot_paged_decode_attention_q8',
    _PAGED_Q8_ARGS)
PAGED_VERIFY_ATTENTION_Q8 = _build.Kernel(
    'decode_attention', 'skypilot_paged_decode_attention_q8',
    _PAGED_Q8_ARGS)
CACHE_WRITE_Q8 = _build.Kernel(
    'decode_attention', 'skypilot_cache_write_q8',
    [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
ROPE_CACHE_WRITE = _build.Kernel(
    'decode_attention', 'skypilot_rope_cache_write',
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                                   ctypes.c_void_p])
ROPE_CACHE_WRITE_Q8 = _build.Kernel(
    'decode_attention', 'skypilot_rope_cache_write_q8',
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                                   ctypes.c_void_p])
# K4-prefill (csrc/prefill_attention.cu): a bf16 cache, dense or paged,
# and an int8 pool, each its own count.
_PREFILL_TAIL = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
PREFILL_ATTENTION = _build.Kernel(
    'prefill_attention', 'skypilot_prefill_attention',
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 4 +
    _PREFILL_TAIL)
PREFILL_ATTENTION_Q8 = _build.Kernel(
    'prefill_attention', 'skypilot_prefill_attention_q8',
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 2 + _PREFILL_TAIL)
# Its block: PREFILL_MTILES m-tiles of 16 query rows, four warps each
# (one per 16-key slice of a tile for the scores, one per quarter of the
# head's columns for P V), a ring of PREFILL_STAGES K/V tiles (bf16,
# int8); each split's partial of a 16-row m-tile (16 x hd f32) goes to a
# scratch in device memory and is folded at the end.
PREFILL_MTILES = 3
PREFILL_THREADS = PREFILL_MTILES * 4 * 32
PREFILL_STAGES = {False: 2, True: 3}
DECODE_HEAD_DIMS = (64, 128)
DECODE_GROUPS = (1, 2, 4, 8)


# ---------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """Per-(..., head) symmetric int8: x [..., Hkv, hd] -> (codes int8,
    scales bf16 [..., Hkv]). The scale is bf16-rounded BEFORE encoding so
    codes reconstruct against the stored scale (the rule of
    ``models/quant.py``); codes equal JAX's bit for bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.clamp(amax, min=1e-8) / 127.0
    s = s.to(torch.bfloat16).float()
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s.to(torch.bfloat16)


def dequant_kv(x: torch.Tensor, scale, dtype) -> torch.Tensor:
    """int8 codes [..., hd] with per-(row, head) scales [...] -> ``dtype``
    (the JAX ``_dequant_kv``: ``code * scale`` in ``dtype``); x itself
    when ``scale`` is None."""
    if scale is None:
        return x
    return x.to(dtype) * scale[..., None].to(dtype)


def _reference_decode_attention(q, k, v, lengths, scale, k_scale=None,
                                v_scale=None):
    """q [B, Hq, hd]; k/v [B, S, Hkv, hd] (int8 with scales [B, S, Hkv],
    dequantized in q's dtype first); lengths [B] — row b attends keys
    [0, max(lengths[b], 1))."""
    k = dequant_kv(k, k_scale, q.dtype)
    v = dequant_kv(v, v_scale, q.dtype)
    b, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    qg = q.reshape(b, hkv, groups, hd)
    logits = torch.einsum('bhgd,bshd->bhgs', qg.float(),
                          k.float()) * scale
    lengths = lengths.to(q.device).clamp(min=1)
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhgs,bshd->bhgd', probs.to(v.dtype), v)
    return out.reshape(b, hq, hd).to(q.dtype)


def _reference_verify_attention(q, k, v, lengths, scale):
    """q [B, W, Hq, hd]; k/v [B, S, Hkv, hd]; lengths [B] — query
    position j of row b attends keys [0, lengths[b] + j): the
    single-position length mask plus an intra-draft causal stagger."""
    b, w, hq, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    groups = hq // hkv
    qg = q.reshape(b, w, hkv, groups, hd)
    logits = torch.einsum('bwhgd,bshd->bwhgs', qg.float(),
                          k.float()) * scale
    span = (lengths.to(q.device)[:, None] +
            torch.arange(w, device=q.device)[None, :])       # [B, W]
    mask = torch.arange(s, device=q.device)[None, None, :] < \
        span[:, :, None]                                     # [B, W, S]
    logits = logits.masked_fill(~mask[:, :, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bwhgs,bshd->bwhgd', probs.to(v.dtype), v)
    return out.reshape(b, w, hq, hd).to(q.dtype)


def paged_gather(pool_flat: torch.Tensor,
                 gather_idx: torch.Tensor) -> torch.Tensor:
    """Rows' logical KV views out of a flat pool: pool_flat
    [num_blocks * block_size, ...] indexed by flat indices from
    ``kv_pool.read_indices`` ([B, S_pad] -> [B, S_pad, ...])."""
    return pool_flat[gather_idx.long()]


def _gather_views(q, k_pool, v_pool, block_tables, block_size, k_scale,
                  v_scale):
    """Each row's blocks gathered into a contiguous view, dequantized in
    q's dtype when the pools are int8 (the JAX package's route)."""
    gidx = kv_pool_lib.read_indices(block_tables, block_size)
    kd, vd = paged_gather(k_pool, gidx), paged_gather(v_pool, gidx)
    if k_scale is not None:
        kd = dequant_kv(kd, paged_gather(k_scale, gidx), q.dtype)
        vd = dequant_kv(vd, paged_gather(v_scale, gidx), q.dtype)
    return kd, vd


def _reference_paged_decode_attention(q, k_pool, v_pool, block_tables,
                                      lengths, scale, block_size,
                                      k_scale=None, v_scale=None):
    """Gather each row's blocks into a contiguous view, then the plain
    dense decode attention (the JAX package's route)."""
    kd, vd = _gather_views(q, k_pool, v_pool, block_tables, block_size,
                           k_scale, v_scale)
    return _reference_decode_attention(q, kd, vd, lengths, scale)


def _reference_prefill_attention(q, k, v, lengths, scale, block_table=None,
                                 block_size=None, k_new=None, v_new=None,
                                 k_scale=None, v_scale=None):
    """The composition K4-prefill replaces: each row's view of the cache
    (the pool gathered through its table, int8 dequantized in q's dtype),
    the chunk's exact rows spliced over positions [start, start + T)
    (start = lengths[b] - 1), then the plain verify attention."""
    b, t = q.shape[:2]
    if block_table is not None:
        last = int(lengths.max()) + t - 1
        nb = min(block_table.shape[1], -(-last // block_size))
        kd, vd = _gather_views(q, k, v, block_table[:, :nb], block_size,
                               k_scale, v_scale)
    else:
        kd = dequant_kv(k, k_scale, q.dtype)
        vd = dequant_kv(v, v_scale, q.dtype)
    if k_new is not None:
        kd, vd = kd.clone(), vd.clone()
        for row, length in enumerate(lengths.tolist()):
            st = length - 1
            end = min(st + t, kd.shape[1])
            kd[row, st:end] = k_new[row, :end - st]
            vd[row, st:end] = v_new[row, :end - st]
    return _reference_verify_attention(q, kd, vd, lengths, scale)


def _reference_paged_verify_attention(q, k_pool, v_pool, block_tables,
                                      lengths, scale, block_size,
                                      k_scale=None, v_scale=None):
    kd, vd = _gather_views(q, k_pool, v_pool, block_tables, block_size,
                           k_scale, v_scale)
    return _reference_verify_attention(q, kd, vd, lengths, scale)


def rope_plain(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of rows x [R, H, hd] at their own positions, cos
    and sin [R, hd/2] f32: in f32, each product rounded before the add,
    rounded back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


def _reference_rope_cache_write(q, k, v, cos, sin, k_pool, v_pool, dst,
                                k_scale=None, v_scale=None, k_out=None):
    """The chain K5F replaces: q and k rotated, the new rows quantized
    when the pool is int8, then K5's plain write. Row r reads cos and sin
    row r mod their rows. Returns rotated q; rotated k into ``k_out``."""
    period = cos.shape[0]
    if period != q.shape[0]:
        reps = q.shape[0] // period
        cos, sin = cos.repeat(reps, 1), sin.repeat(reps, 1)
    q, k = rope_plain(q, cos, sin), rope_plain(k, cos, sin)
    if k_out is not None:
        k_out.copy_(k)
    if k_scale is None:
        _reference_cache_write(k_pool, v_pool, k, v, dst)
    else:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        _reference_cache_write(k_pool, v_pool, kq, vq, dst, k_scale,
                               v_scale, ks, vs)
    return q


def _reference_cache_write(k, v, k_new, v_new, dst, k_scale=None,
                           v_scale=None, ks_new=None, vs_new=None):
    """``index_copy_`` into the flat views (and the scale views of an
    int8 cache); rows whose ``dst`` lies outside [0, N) are dropped."""
    keep = (dst >= 0) & (dst < k.shape[0])
    pairs = [(k, k_new), (v, v_new)]
    if k_scale is not None:
        pairs += [(k_scale, ks_new), (v_scale, vs_new)]
    if not bool(keep.all()):
        dst = dst[keep]
        pairs = [(out, new[keep]) for out, new in pairs]
    for out, new in pairs:
        out.index_copy_(0, dst.long(), new)


# ---------------------------------------------------------------------
# K4's host-side plan: splits, scratch, shared memory, copy checks
# ---------------------------------------------------------------------


def decode_split_plan(s: int):
    """``(chunk, n_split)`` of a K4 call over rows of S keys (MB * bs
    when paged): ``DECODE_CHUNK`` keys a split, never fewer splits than
    cover S. Never from ``lengths``, so the call can sit in a CUDA graph,
    and never from B or W (nor G), so a query row's keys split at the same
    points whatever else shares the call. Block (split, kv head, row)
    covers keys [split * chunk, (split + 1) * chunk) of its row, in
    64-key tiles."""
    return DECODE_CHUNK, -(-s // DECODE_CHUNK)


def decode_pass_groups(rows: int) -> int:
    """Groups of blocks a K4 call spreads its ``rows`` = W * G query rows
    over (a block takes ``DECODE_PASSES_PER_BLOCK`` m-tiles of 16)."""
    return -(-(-(-rows // 16)) // DECODE_PASSES_PER_BLOCK)


def decode_scratch_shapes(b: int, hkv: int, n_split: int, rows: int,
                          hd: int):
    """Shapes of the f32 partials a K4 call writes: (m, l) and acc of
    each (row, kv head, split, query row)."""
    return (b, hkv, n_split, rows, 2), (b, hkv, n_split, rows, hd)


def decode_smem_bytes(hd: int, q8: bool, hkv: int, max_pages: int,
                      rows: int) -> int:
    """Dynamic shared memory of one K4 block (``layout`` in
    csrc/decode_attention.cu, plus its 1024 bytes of alignment slack)."""
    def up(x, m):
        return -(-x // m) * m
    kv_tile = DECODE_TILE * hd * 2
    codes = DECODE_TILE * hd
    stage = (up(2 * codes + 2 * DECODE_TILE * hkv * 2, 1024) if q8
             else 2 * kv_tile)
    ns = DECODE_STAGES
    # int8: the dequantized bf16 V tile.
    end = ns * stage + (kv_tile if q8 else 0)
    merge = 4 * 16 * (hd + 4) * 4 + 4 * 16 * 2 * 4
    bar = up(max(end, merge, rows * 8), 128)
    return bar + ns * 4 * 8 + 16 + max_pages * 4 + 1024


def prefill_smem_bytes(hd: int, q8: bool, mb: int, n_split: int) -> int:
    """Dynamic shared memory of one K4-prefill block (``prefill_layout``
    in csrc/prefill_attention.cu, plus its 1024 bytes of alignment
    slack); ``mb``: the table's width (0 dense), ``n_split``: the splits
    of a row."""
    mt, tile, ns = PREFILL_MTILES, DECODE_TILE, PREFILL_STAGES[q8]
    size = ns * 2 * tile * hd * 2 + mt * 16 * hd * 2
    if q8:
        size += ns * (2 * tile * hd + 2 * tile * 4)
    size += mt * 2 * 4 * 32 * 16     # P fragments, two buffers
    size += mt * 2 * 4 * 16 * 4      # rescale factors
    size += mt * 4 * 16 * 2 * 4      # the slices' (m, l)
    size += mt * n_split * 16 * 4    # each split's max per row
    return size + mb * 4 + 1024


def prefill_plan(b: int, t: int, hkv: int, groups: int, hd: int, q8: bool,
                 s: int, mb: int = 0) -> dict:
    """A K4-prefill call's launch, from shapes alone (never from lengths,
    so a graph can hold it): the grid (m-tile groups, kv heads, rows),
    the block's threads and shared memory, the split (K4's constant
    ``DECODE_CHUNK`` keys, ``n_split`` over the S = MB * bs keys a row
    can hold) and the f32 elements of the splits' partials (a 16 x hd
    tile per block, m-tile and split)."""
    chunk, n_split = decode_split_plan(s)
    blocks = -(-(-(-(t * groups) // 16)) // PREFILL_MTILES)
    return dict(grid=(blocks, hkv, b), threads=PREFILL_THREADS,
                smem=prefill_smem_bytes(hd, q8, mb, n_split), chunk=chunk,
                n_split=n_split,
                scratch=b * hkv * blocks * PREFILL_MTILES * n_split * 16 * hd)


# K4's merge counters, one int32 per (row, kv head, pass group): the most
# a call may use, and the buffer of each device.
DECODE_MAX_COUNTERS = 1 << 16
_COUNTERS = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The int32 counters K4's last-block merge uses, one per (row, kv
    head, pass group), 0 between calls (the last block of each call
    leaves its counter at 0 again). One buffer per device, made zeroed on the
    device's first K4 call and never replaced, so a CUDA graph that
    captured a call keeps pointing at live counters. Every K4 call on a
    device shares it: calls must run one after another (one stream, or
    streams ordered by events), as the engine's do."""
    if n > DECODE_MAX_COUNTERS:
        raise ValueError(f'decode attention: B * Hkv * pass groups = {n} '
                         f'exceeds the {DECODE_MAX_COUNTERS} merge counters')
    key = (dev.type, dev.index)
    buf = _COUNTERS.get(key)
    if buf is None:
        if dev.type == 'cuda' and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                'decode attention: the merge counters are made on the '
                "device's first K4 call, which may not be captured; make "
                'one call before capturing a CUDA graph')
        buf = torch.zeros(DECODE_MAX_COUNTERS, dtype=torch.int32,
                          device=dev)
        _COUNTERS[key] = buf
    return buf


# ---------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_index(what: str, name: str, x: torch.Tensor, dev,
                 dims: int) -> None:
    if (x.device != dev or x.dtype != torch.int32 or x.dim() != dims
            or not x.is_contiguous()):
        raise TypeError(f'{what}: {name} must be a contiguous int32 '
                        f'tensor of {dims} dims on {dev}, got {x.dtype} '
                        f'{tuple(x.shape)} on {x.device}')


def _check_heads(what: str, hq: int, hkv: int, hd: int) -> None:
    if hq % hkv or hd not in DECODE_HEAD_DIMS or \
            hq // hkv not in DECODE_GROUPS:
        raise ValueError(f'{what}: Hq {hq} / Hkv {hkv} / head_dim {hd} '
                         'not supported by the CUDA kernel (takes '
                         f'head_dim {DECODE_HEAD_DIMS}, group '
                         f'{DECODE_GROUPS})')


def _check_kv(what: str, q, k, v, k_scale, v_scale) -> None:
    """bf16 K/V, or int8 codes with bf16 scales (one per row and kv
    head) on q's device."""
    dev = q.device
    if q.dtype != torch.bfloat16:
        raise TypeError(f'{what}: the CUDA kernel takes bf16 q, got '
                        f'{q.dtype}')
    want = torch.bfloat16 if k_scale is None else torch.int8
    for name, x in (('k', k), ('v', v)):
        if x.device != dev or x.dtype != want:
            raise TypeError(f'{what}: the CUDA kernel takes {want} {name} '
                            f'on {dev} (int8 exactly when scales are '
                            f'given), got {x.dtype} on {x.device}')
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f'{what}: pass both k_scale and v_scale or '
                         'neither')
    if k_scale is None:
        return
    for name, x, like in (('k_scale', k_scale, k), ('v_scale', v_scale, v)):
        if (x.device != dev or x.dtype != torch.bfloat16
                or x.shape != like.shape[:-1] or x.stride(-1) != 1):
            raise ValueError(f'{what}: {name} must be bf16 '
                             f'{tuple(like.shape[:-1])} on {dev} with '
                             f'unit-stride heads, got {x.dtype} '
                             f'{tuple(x.shape)} strides {x.stride()}')


def _check_tma_kv(what: str, name: str, x: torch.Tensor, hd: int) -> None:
    """What K4's TMA map of K or V takes: contiguous [Hkv, hd] rows,
    outer strides that are whole 16-byte units, a 16-byte aligned base
    and fewer than 2^31 rows."""
    es = x.element_size()
    if (x.stride(-1) != 1 or x.stride(-2) != hd
            or any(st * es % 16 for st in x.stride()[:-2])
            or x.data_ptr() % 16 or x.shape[-3] >= 2 ** 31):
        raise ValueError(f'{what}: {name} needs contiguous [Hkv, hd] '
                         'rows, strides of whole 16-byte units and a '
                         '16-byte aligned base for the TMA copies (shape '
                         f'{tuple(x.shape)}, strides {x.stride()}, '
                         f'dtype {x.dtype})')


def _check_scale_rows(what: str, k_scale, v_scale, hkv: int) -> None:
    """int8 scales are copied a whole row of kv heads at a time
    (cp.async.bulk): rows of Hkv contiguous entries, whole 16-byte
    units of batch stride, a 16-byte aligned base, and K and V alike."""
    for name, x in (('k_scale', k_scale), ('v_scale', v_scale)):
        if (x.stride(-2) != hkv or any(st * 2 % 16 for st in
                                       x.stride()[:-2])
                or x.data_ptr() % 16 or x.stride() != k_scale.stride()):
            raise ValueError(f'{what}: {name} needs rows of {hkv} '
                             'contiguous kv heads, batch strides of whole '
                             '16-byte units, a 16-byte aligned base and '
                             'the strides of k_scale for the bulk copies '
                             f'(shape {tuple(x.shape)}, strides '
                             f'{x.stride()})')


def _check_smem(what: str, hd: int, q8: bool, hkv: int, max_pages: int,
                rows: int) -> None:
    need = decode_smem_bytes(hd, q8, hkv, max_pages, rows)
    if need > DECODE_MAX_SMEM:
        raise ValueError(f'{what}: Hkv {hkv} / rows {rows} need {need} '
                         'bytes of shared memory per block, more than '
                         f'the {DECODE_MAX_SMEM} a block may use')


def _check_page_size(what: str, block_size: int) -> None:
    if block_size not in DECODE_PAGE_SIZES:
        raise ValueError(f'{what}: block_size {block_size} is not a page '
                         'size the CUDA kernel takes '
                         f'{DECODE_PAGE_SIZES}: a page is one TMA box and '
                         f'a {DECODE_TILE}-key tile holds whole pages')


def _launch_scratch(dev, b, hkv, s, rows, hd):
    """The split plan, the partials' scratch and the merge counters of a
    K4 call."""
    counters = _counters(dev, b * hkv * decode_pass_groups(rows))
    chunk, n_split = decode_split_plan(s)
    ml_shape, acc_shape = decode_scratch_shapes(b, hkv, n_split, rows, hd)
    part_ml = torch.empty(ml_shape, dtype=torch.float32, device=dev)
    part_acc = torch.empty(acc_shape, dtype=torch.float32, device=dev)
    return chunk, n_split, part_ml, part_acc, counters


def _decode_attention_cuda(q, k, v, lengths, scale, k_scale=None,
                           v_scale=None):
    """Launch K4-cuda (or its int8 form with scales) for q [B, W, Hq, hd]
    (W > 1 bf16 only); raises on anything the kernel does not take,
    before anything launches."""
    what = 'decode_attention'
    if not all(x.device == q.device for x in (k, v, lengths)):
        raise ValueError('decode_attention: q, k, v, lengths must share a '
                         'device')
    _check_kv(what, q, k, v, k_scale, v_scale)
    if lengths.dtype != torch.int32 or lengths.dim() != 1:
        raise TypeError('decode_attention: lengths must be int32 [B], got '
                        f'{lengths.dtype} {tuple(lengths.shape)}')
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError('decode_attention: q [B,W,Hq,hd], k/v '
                         f'[B,S,Hkv,hd] expected, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    b, w, hq, hd = q.shape
    if w < 1 or (w > 1 and k_scale is not None):
        raise ValueError(f'decode_attention: W {w} (the int8 form takes '
                         'W = 1)')
    bk, s, hkv, hdk = k.shape
    if bk != b or hdk != hd or lengths.shape[0] != b or hq % hkv or s < 1:
        raise ValueError('decode_attention: incompatible shapes q '
                         f'{tuple(q.shape)}, k/v {tuple(k.shape)}, '
                         f'lengths {tuple(lengths.shape)}')
    _check_heads('decode_attention', hq, hkv, hd)
    if not q.is_contiguous() or not lengths.is_contiguous():
        raise ValueError('decode_attention: q and lengths must be '
                         'contiguous')
    for name, x in (('k', k), ('v', v)):
        _check_tma_kv(what, name, x, hd)
    rows = w * (hq // hkv)
    if k_scale is not None:
        _check_scale_rows(what, k_scale, v_scale, hkv)
        if s * hkv % 8:
            raise ValueError(f'{what}: an int8 cache needs S * Hkv a '
                             f'multiple of 8 (the last tile\'s scale rows '
                             f'are whole 16-byte units), got S {s}, Hkv '
                             f'{hkv}')
    _check_smem(what, hd, k_scale is not None, hkv, 0, rows)
    if q.data_ptr() % 16:
        raise ValueError('decode_attention: q needs a 16-byte aligned base')
    chunk, n_split, *scratch = _launch_scratch(q.device, b, hkv, s, rows,
                                               hd)
    stream = _stream(q)
    out = torch.empty_like(q)
    parts = (lengths.data_ptr(), out.data_ptr(),
             *(x.data_ptr() for x in scratch))
    strides = (k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    tail = (chunk, n_split, scale * LOG2E, stream)
    if k_scale is None:
        DECODE_ATTENTION(q.data_ptr(), k.data_ptr(), v.data_ptr(), *parts, b,
                         w, s, hq, hkv, hd, *strides, *tail)
    else:
        DECODE_ATTENTION_Q8(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            k_scale.data_ptr(), v_scale.data_ptr(), *parts,
                            b, s, hq, hkv, hd, *strides,
                            k_scale.stride(0), k_scale.stride(1),
                            v_scale.stride(0), v_scale.stride(1), *tail)
    return out


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths,
                          scale, block_size, k_scale=None, v_scale=None):
    """Launch K4-paged (or its int8 form) for q [B, W, Hq, hd] over one
    layer's flat pools [N, Hkv, hd]; raises on anything the kernel does
    not take, before anything launches."""
    what = 'paged_attention'
    dev = q.device
    _check_kv(what, q, k_pool, v_pool, k_scale, v_scale)
    if q.dim() != 4 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f'{what}: q must be a contiguous, 16-byte '
                         f'aligned [B, W, Hq, hd], got {tuple(q.shape)}')
    b, w, hq, hd = q.shape
    if k_pool.shape != v_pool.shape or k_pool.dim() != 3 or \
            k_pool.shape[2] != hd:
        raise ValueError(f'{what}: pools must be [N, Hkv, {hd}], got '
                         f'{tuple(k_pool.shape)}, {tuple(v_pool.shape)}')
    n_rows, hkv = k_pool.shape[0], k_pool.shape[1]
    _check_heads(what, hq, hkv, hd)
    _check_page_size(what, block_size)
    if n_rows < block_size or n_rows % block_size:
        raise ValueError(f'{what}: pools of {n_rows} rows are not whole '
                         f'pages of {block_size}')
    _check_tma_kv(what, 'k_pool', k_pool, hd)
    _check_tma_kv(what, 'v_pool', v_pool, hd)
    if k_scale is not None:
        _check_scale_rows(what, k_scale, v_scale, hkv)
    _check_index(what, 'block_tables', block_tables, dev, 2)
    _check_index(what, 'lengths', lengths, dev, 1)
    mb = block_tables.shape[1]
    if block_tables.shape[0] != b or lengths.shape[0] != b or mb < 1 \
            or w < 1:
        raise ValueError(f'{what}: block_tables {tuple(block_tables.shape)}'
                         f', lengths {tuple(lengths.shape)}, block_size '
                         f'{block_size} do not fit q {tuple(q.shape)}')
    rows = w * (hq // hkv)
    s = mb * block_size
    chunk, _ = decode_split_plan(s)
    _check_smem(what, hd, k_scale is not None, hkv, chunk // block_size,
                rows)
    chunk, n_split, *scratch = _launch_scratch(dev, b, hkv, s, rows, hd)
    stream = _stream(q)
    out = torch.empty_like(q)
    parts = (block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             *(x.data_ptr() for x in scratch), b, w, mb, block_size, n_rows,
             hq, hkv, hd, k_pool.stride(0), v_pool.stride(0))
    tail = (chunk, n_split, scale * LOG2E, stream)
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr())
    if k_scale is None:
        kernel = PAGED_DECODE_ATTENTION if w == 1 else PAGED_VERIFY_ATTENTION
        kernel(*head, *parts, *tail)
    else:
        kernel = (PAGED_DECODE_ATTENTION_Q8 if w == 1
                  else PAGED_VERIFY_ATTENTION_Q8)
        kernel(*head, k_scale.data_ptr(), v_scale.data_ptr(), *parts,
               k_scale.stride(0), v_scale.stride(0), *tail)
    return out


def _prefill_attention_cuda(q, k, v, lengths, scale, block_table,
                            block_size, k_new, v_new, k_scale, v_scale):
    """Launch K4-prefill (or its int8 form); raises on anything the
    kernel does not take, before anything launches."""
    what = 'prefill_attention'
    dev = q.device
    q8 = k_scale is not None
    _check_kv(what, q, k, v, k_scale, v_scale)
    if q.dim() != 4 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f'{what}: q must be a contiguous, 16-byte aligned '
                         f'[B, T, Hq, hd], got {tuple(q.shape)}')
    b, t, hq, hd = q.shape
    paged = block_table is not None
    if k.shape != v.shape or k.dim() != (3 if paged else 4) or \
            k.shape[-1] != hd:
        raise ValueError(f'{what}: k/v must be ' +
                         (f'pools [N, Hkv, {hd}]' if paged else
                          f'[B, S, Hkv, {hd}]') +
                         f', got {tuple(k.shape)}, {tuple(v.shape)}')
    hkv = k.shape[-2]
    _check_heads(what, hq, hkv, hd)
    _check_tma_kv(what, 'k', k, hd)
    _check_tma_kv(what, 'v', v, hd)
    if k.stride() != v.stride():
        raise ValueError(f'{what}: k and v must share strides, got '
                         f'{k.stride()} and {v.stride()}')
    _check_index(what, 'lengths', lengths, dev, 1)
    if lengths.shape[0] != b:
        raise ValueError(f'{what}: lengths {tuple(lengths.shape)} for B {b}')
    if paged:
        _check_index(what, 'block_tables', block_table, dev, 2)
        _check_page_size(what, block_size)
        n_rows, mb, s = k.shape[0], block_table.shape[1], 0
        if block_table.shape[0] != b or mb < 1 or \
                n_rows < block_size or n_rows % block_size:
            raise ValueError(f'{what}: block_tables '
                             f'{tuple(block_table.shape)} and block_size '
                             f'{block_size} do not fit q {tuple(q.shape)} '
                             f'and pools of {n_rows} rows')
        strides = (0, k.stride(0), 0, v.stride(0))
    else:
        n_rows, mb, s = 0, 0, k.shape[1]
        if k.shape[0] != b or s < 1:
            raise ValueError(f'{what}: k/v {tuple(k.shape)} for q '
                             f'{tuple(q.shape)}')
        strides = (k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    if k_new is not None:
        for name, x in (('k_new', k_new), ('v_new', v_new)):
            if (x.device != dev or x.dtype != torch.bfloat16 or
                    tuple(x.shape) != (b, t, hkv, hd) or
                    not x.is_contiguous() or x.data_ptr() % 16):
                raise ValueError(f'{what}: {name} must be a contiguous, '
                                 f'16-byte aligned bf16 {(b, t, hkv, hd)} '
                                 f'on {dev}, got {x.dtype} '
                                 f'{tuple(x.shape)} on {x.device}')
    if q8:
        if not paged:
            raise ValueError(f'{what}: the CUDA kernel reads int8 codes from '
                             'a paged pool only (dequantize a dense cache '
                             'first)')
        for name, x in (('k_scale', k_scale), ('v_scale', v_scale)):
            # Each scale is read as the aligned 4-byte word holding it.
            if (x.stride(-2) != hkv or x.stride() != k_scale.stride() or
                    x.data_ptr() % 4 or hkv % 2):
                raise ValueError(f'{what}: {name} needs rows of {hkv} '
                                 'contiguous kv heads (an even count), the '
                                 'strides of k_scale and a 4-byte aligned '
                                 f'base (shape {tuple(x.shape)}, strides '
                                 f'{x.stride()})')
    plan = prefill_plan(b, t, hkv, hq // hkv, hd, q8,
                        mb * block_size if paged else s, mb)
    if plan['smem'] > DECODE_MAX_SMEM:
        raise ValueError(f'{what}: a table of {mb} pages needs '
                         f'{plan["smem"]} bytes of shared memory per block, '
                         f'more than the {DECODE_MAX_SMEM} a block may use')
    out = torch.empty_like(q)
    part = torch.empty(plan['scratch'], dtype=torch.float32, device=dev)
    new = ((k_new.data_ptr(), v_new.data_ptr()) if k_new is not None
           else (None, None))
    ptrs = (lengths.data_ptr(), block_table.data_ptr() if paged else None,
            out.data_ptr(), part.data_ptr())
    tail = (mb, block_size if paged else 0, n_rows, plan['chunk'],
            scale * LOG2E, _stream(q))
    if q8:
        PREFILL_ATTENTION_Q8(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             k_scale.data_ptr(), v_scale.data_ptr(), *new,
                             *ptrs, b, t, hq, hkv, hd, k.stride(0),
                             v.stride(0), *tail)
    else:
        PREFILL_ATTENTION(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, b,
                          t, s, hq, hkv, hd, *strides, *tail)
    return out


def _cache_write_cuda(k, v, k_new, v_new, dst):
    """Launch K5-cuda; raises on anything the kernel does not take."""
    what = 'cache_write'
    dev = k.device
    if k.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == k_new.dtype == v_new.dtype):
        raise TypeError(f'{what}: caches and new rows must share one '
                        'dtype, bf16 or f32, got '
                        f'{k.dtype}, {v.dtype}, {k_new.dtype}, '
                        f'{v_new.dtype}')
    if not all(x.device == dev for x in (v, k_new, v_new)):
        raise ValueError(f'{what}: all tensors must share a device')
    if k.shape != v.shape or k_new.shape != v_new.shape or \
            k.dim() < 2 or k_new.shape[1:] != k.shape[1:] or \
            dst.shape != k_new.shape[:1]:
        raise ValueError(f'{what}: k/v [N, ...], new rows [R, ...] and '
                         f'dst [R] expected, got {tuple(k.shape)}, '
                         f'{tuple(k_new.shape)}, {tuple(dst.shape)}')
    _check_index(what, 'dst', dst, dev, 1)
    row_bytes = k[0].numel() * k.element_size()
    for name, x in (('k', k), ('v', v), ('k_new', k_new),
                    ('v_new', v_new)):
        if not x.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous')
    if k_new.shape[0] == 0:
        return
    CACHE_WRITE(k.data_ptr(), v.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), dst.data_ptr(), k_new.shape[0],
                k.shape[0], row_bytes, _stream(k))


def _cache_write_q8_cuda(k, v, k_new, v_new, dst, k_scale, v_scale,
                         ks_new, vs_new):
    """Launch K5-cuda's int8 form: code rows and scale rows of K and V
    in one launch; raises on anything the kernel does not take."""
    what = 'cache_write'
    dev = k.device
    arrays = (('k', k, torch.int8), ('v', v, torch.int8),
              ('k_new', k_new, torch.int8), ('v_new', v_new, torch.int8),
              ('k_scale', k_scale, torch.bfloat16),
              ('v_scale', v_scale, torch.bfloat16),
              ('ks_new', ks_new, torch.bfloat16),
              ('vs_new', vs_new, torch.bfloat16))
    for name, x, dtype in arrays:
        if x is None or x.device != dev or x.dtype != dtype:
            raise TypeError(f'{what}: an int8 cache write takes {dtype} '
                            f'{name} on {dev}, got '
                            f'{None if x is None else (x.dtype, x.device)}')
        if not x.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous')
    if k.shape != v.shape or k_new.shape != v_new.shape or \
            k.dim() < 2 or k_new.shape[1:] != k.shape[1:] or \
            dst.shape != k_new.shape[:1] or \
            k_scale.shape != k.shape[:-1] or \
            v_scale.shape != v.shape[:-1] or \
            ks_new.shape != k_new.shape[:-1] or \
            vs_new.shape != v_new.shape[:-1]:
        raise ValueError(f'{what}: k/v [N, ..., hd] with scales [N, ...], '
                         'new rows [R, ..., hd] with scales [R, ...] and '
                         f'dst [R] expected, got {tuple(k.shape)}, '
                         f'{tuple(k_scale.shape)}, {tuple(k_new.shape)}, '
                         f'{tuple(ks_new.shape)}, {tuple(dst.shape)}')
    _check_index(what, 'dst', dst, dev, 1)
    if k_new.shape[0] == 0:
        return
    CACHE_WRITE_Q8(k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                   v_scale.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                   ks_new.data_ptr(), vs_new.data_ptr(), dst.data_ptr(),
                   k_new.shape[0], k.shape[0], k[0].numel(),
                   2 * k_scale[0].numel(), _stream(k))


# ---------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------


def _route(what: str, x: torch.Tensor) -> str:
    if x.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'{what}: unsupported device {x.device}')
    return x.device.type


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-position decode attention over per-row valid prefixes.

    q [B, Hq, hd]; k/v [B, S, Hkv, hd] (int8 codes with ``k_scale``/
    ``v_scale`` [B, S, Hkv] when the cache is quantized); lengths [B]
    int32 — row b attends keys [0, lengths[b]). Returns [B, Hq, hd] in
    q.dtype. CUDA tensors go to K4-cuda, CPU tensors to the plain
    reference.
    """
    if _route('decode_attention', q) == 'cuda':
        return _decode_attention_cuda(q[:, None], k, v, lengths,
                                      float(scale), k_scale, v_scale)[:, 0]
    return _reference_decode_attention(q, k, v, lengths, scale, k_scale,
                                       v_scale)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, scale: float,
                      block_table: Optional[torch.Tensor] = None,
                      block_size: Optional[int] = None,
                      k_new: Optional[torch.Tensor] = None,
                      v_new: Optional[torch.Tensor] = None,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """A prefill chunk's attention: q [B, T, Hq, hd], lengths [B] int32
    — query j of row b sits at position start = lengths[b] - 1 plus j and
    attends keys [0, lengths[b] + j).

    Keys come from the cache: a dense k/v [B, S, Hkv, hd], or
    (``block_table`` [B, MB] int32 with ``block_size``) one layer's flat
    pools [N, Hkv, hd] read through each row's table, the chunk's own rows
    written there first. An int8 cache holds codes with ``k_scale``/
    ``v_scale`` ([B, S, Hkv] or [N, Hkv]; the CUDA kernel takes pools
    only), dequantized in q's dtype, and then ``k_new``/``v_new`` [B, T,
    Hkv, hd] give the chunk's exact post-RoPE rows for keys from start on
    (the JAX package's splice over their int8 round trip; a bf16 cache
    already holds them exactly). Returns [B, T, Hq, hd]. CUDA:
    K4-prefill, one launch, a row's bits those of K4 over the same keys
    (bf16: K4-paged's decode step at the same position); CPU: the plain
    composition it replaces (gather, dequant, splice,
    ``_reference_verify_attention``)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError('prefill_attention: pass both k_scale and v_scale '
                         'or neither')
    if (block_table is None) != (block_size is None):
        raise ValueError('prefill_attention: block_table and block_size go '
                         'together')
    if (k_new is None) != (v_new is None) or (
            k_new is not None and k_scale is None):
        raise ValueError('prefill_attention: k_new and v_new go together, '
                         'over an int8 cache only')
    if _route('prefill_attention', q) == 'cuda':
        return _prefill_attention_cuda(q, k, v, lengths, float(scale),
                                       block_table, block_size, k_new, v_new,
                                       k_scale, v_scale)
    return _reference_prefill_attention(q, k, v, lengths, scale, block_table,
                                        block_size, k_new, v_new, k_scale,
                                        v_scale)


def verify_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """W query positions a row over a dense bf16/f32 cache: q [B, W, Hq,
    hd], k/v [B, S, Hkv, hd], lengths [B] int32 — query j of row b
    attends keys [0, lengths[b] + j). Returns [B, W, Hq, hd]. The dense
    form of ``prefill_attention`` (K4-prefill on the card, a query row's
    bits independent of the chunk's bucket and start); CPU: the plain
    version."""
    return prefill_attention(q, k, v, lengths, scale)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, scale: float,
                           block_size: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-position decode attention over PAGED caches.

    q [B, Hq, hd]; k_pool/v_pool one layer's flat pool
    [num_blocks * block_size, Hkv, hd] (int8 codes with ``k_scale``/
    ``v_scale`` [num_blocks * block_size, Hkv] when quantized);
    block_tables [B, MB] int32 maps row b's logical block i to a pool
    block; lengths [B] — row b attends its first ``lengths[b]`` logical
    positions. CUDA: K4-paged with W = 1 reads the table directly; CPU:
    gather (+ dequant) + the plain dense version."""
    if _route('paged_decode_attention', q) == 'cuda':
        return _paged_attention_cuda(q[:, None], k_pool, v_pool,
                                     block_tables, lengths, float(scale),
                                     block_size, k_scale, v_scale)[:, 0]
    return _reference_paged_decode_attention(q, k_pool, v_pool,
                                             block_tables, lengths, scale,
                                             block_size, k_scale, v_scale)


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, scale: float,
                           block_size: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Multi-position (speculative VERIFY) decode attention over PAGED
    caches: q [B, W, Hq, hd], query j of row b attends its first
    ``lengths[b] + j`` logical positions; lengths is the BASE length
    (the j = 0 query's valid prefix, self included). Pools, scales and
    tables as in ``paged_decode_attention``. Returns [B, W, Hq, hd]."""
    if _route('paged_verify_attention', q) == 'cuda':
        return _paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                     lengths, float(scale), block_size,
                                     k_scale, v_scale)
    return _reference_paged_verify_attention(q, k_pool, v_pool,
                                             block_tables, lengths, scale,
                                             block_size, k_scale, v_scale)


def cache_write(k: torch.Tensor, v: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, dst: torch.Tensor,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                ks_new: Optional[torch.Tensor] = None,
                vs_new: Optional[torch.Tensor] = None) -> None:
    """Write R new K/V rows IN PLACE: k/v flat row views [N, Hkv, hd],
    k_new/v_new [R, Hkv, hd], dst [R] int32 row indices; for an int8
    cache also the scale views ``k_scale``/``v_scale`` [N, Hkv] and the
    new rows' scales ``ks_new``/``vs_new`` [R, Hkv]. A dst outside
    [0, N) writes nothing; rows sharing a dst leave any one of them.
    CUDA: K5-cuda (one launch for K and V, codes and scales); CPU:
    ``index_copy_``."""
    scales = (k_scale, v_scale, ks_new, vs_new)
    if any(x is None for x in scales) and any(x is not None
                                              for x in scales):
        raise ValueError('cache_write: pass all of k_scale, v_scale, '
                         'ks_new, vs_new or none')
    if _route('cache_write', k) == 'cuda':
        if k_scale is None:
            _cache_write_cuda(k, v, k_new, v_new, dst)
        else:
            _cache_write_q8_cuda(k, v, k_new, v_new, dst, *scales)
    else:
        _reference_cache_write(k, v, k_new, v_new, dst, *scales)


def _rope_cache_write_cuda(q, k, v, cos, sin, k_pool, v_pool, dst,
                           k_scale, v_scale, k_out=None):
    """Launch K5F (or its int8 form); raises on anything it does not
    take."""
    what = 'rope_cache_write'
    dev = q.device
    q8 = k_scale is not None
    r, hq, hd = q.shape
    hkv = k.shape[1]
    period = cos.shape[0]
    pool_dtype = torch.int8 if q8 else torch.bfloat16
    checks = [('q', q, torch.bfloat16, (r, hq, hd)),
              ('k', k, torch.bfloat16, (r, hkv, hd)),
              ('v', v, torch.bfloat16, (r, hkv, hd)),
              ('cos', cos, torch.float32, (period, hd // 2)),
              ('sin', sin, torch.float32, (period, hd // 2)),
              ('k_pool', k_pool, pool_dtype, (k_pool.shape[0], hkv, hd)),
              ('v_pool', v_pool, pool_dtype, tuple(k_pool.shape))]
    if q8:
        checks += [('k_scale', k_scale, torch.bfloat16,
                    tuple(k_pool.shape[:2])),
                   ('v_scale', v_scale, torch.bfloat16,
                    tuple(k_pool.shape[:2]))]
    if k_out is not None:
        checks.append(('k_out', k_out, torch.bfloat16, (r, hkv, hd)))
    for name, x, dtype, shape in checks:
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise TypeError(f'{what}: {name} must be a contiguous {dtype} '
                            f'{shape} on {dev}, got {x.dtype} '
                            f'{tuple(x.shape)} on {x.device}')
    if hd not in DECODE_HEAD_DIMS:
        raise ValueError(f'{what}: head_dim {hd} not in {DECODE_HEAD_DIMS}')
    _check_index(what, 'dst', dst, dev, 1)
    if dst.shape[0] != r:
        raise ValueError(f'{what}: dst {tuple(dst.shape)} for {r} rows')
    q_out = torch.empty_like(q)
    if r == 0:
        return q_out
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), dst.data_ptr(), q_out.data_ptr(),
            0 if k_out is None else k_out.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr())
    tail = (r, hq, hkv, hd, period, k_pool.shape[0], _stream(q))
    if q8:
        ROPE_CACHE_WRITE_Q8(*head, k_scale.data_ptr(), v_scale.data_ptr(),
                            *tail)
    else:
        ROPE_CACHE_WRITE(*head, *tail)
    return q_out


def rope_cache_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     k_pool: torch.Tensor, v_pool: torch.Tensor,
                     dst: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     k_out: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """A serving forward's new rows for one layer: q [R, H, hd] and k [R,
    Hkv, hd] rotated by RoPE at each row's position, k and v [R, Hkv, hd]
    written IN PLACE into the flat pools [N, Hkv, hd] at rows dst [R]
    int32 (int8 codes with bf16 scales [N, Hkv] when ``k_scale``/
    ``v_scale`` are given: each row quantized per kv head). A dst outside
    [0, N) writes nothing. cos and sin [P, hd/2] f32 are the forward's
    table: row r is at the position of table row r mod P, so a step passes
    one row per new row (P = R) and a [B, T] prompt its T positions once.
    ``k_out`` [R, Hkv, hd] in k's dtype, when given, takes every row's
    rotated k (the rows dst drops too), as the cache stores it before any
    quantization. Returns the rotated q. CUDA: K5F, one launch; CPU: the
    chain it replaces (``rope_plain`` on q and k, ``quantize_kv``, the
    plain ``cache_write``)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError('rope_cache_write: pass both k_scale and v_scale '
                         'or neither')
    if cos.dim() != 2 or cos.shape[0] < 1 or q.shape[0] % cos.shape[0]:
        raise ValueError(f'rope_cache_write: cos/sin {tuple(cos.shape)} '
                         f'must tile the {q.shape[0]} rows')
    if k_out is not None and (k_out.shape != k.shape
                              or k_out.dtype != k.dtype):
        raise ValueError(f'rope_cache_write: k_out {k_out.dtype} '
                         f'{tuple(k_out.shape)} for k {k.dtype} '
                         f'{tuple(k.shape)}')
    if _route('rope_cache_write', q) == 'cuda':
        return _rope_cache_write_cuda(q, k, v, cos, sin, k_pool, v_pool,
                                      dst, k_scale, v_scale, k_out)
    return _reference_rope_cache_write(q, k, v, cos, sin, k_pool, v_pool,
                                       dst, k_scale, v_scale, k_out)


def rows_dst(pos: torch.Tensor, s: int) -> torch.Tensor:
    """Flat row of each batch row's write position in a [B * S] view:
    ``b * S + pos[b]``, or -1 (no write) where pos is outside [0, S)."""
    b = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    ok = (pos >= 0) & (pos < s)
    return torch.where(ok, b * s + pos, -1).to(torch.int32)
