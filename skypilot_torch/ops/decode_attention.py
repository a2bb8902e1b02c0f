"""Length-aware decode attention and the per-row KV-cache write — the
port of ``skypilot_tpu/ops/decode_attention.py``.

Kernels (``csrc/decode_attention.cu``, hand-written replacements of the
TPU kernels), each launched for CUDA tensors, with its plain PyTorch
version beside it for CPU tensors (any other device raises):

- ``decode_attention``: K4-cuda, split-K flash-decoding plus a merge
  kernel, for a dense cache (replaces ``_decode_attn_kernel``). As in
  the TPU kernel, a length is clamped to ``max(len, 1)`` (and to S).
- ``paged_decode_attention`` / ``paged_verify_attention``: K4-paged,
  the same kernel reading the block table directly where the JAX
  package gathers every row's pages into a contiguous view first; W = 1
  query position per row (decode) or W = draft_k + 1 (speculative
  verify, query j attending ``lengths[b] + j`` positions).
- ``cache_write``: K5-cuda, R new K/V rows written in place into a flat
  row view at given row indices (replaces ``_cache_write_kernel``);
  ``cache_write_rows`` is the TPU kernel's own rows form
  (``dst = b * S + pos[b]``).

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
# Keys per split block. At batch 1 and 2k context that is ~17 busy
# blocks per KV head (136 for Llama-3-8B's 8 heads, about one per SM);
# blocks past a row's length exit at once.
SPLIT_CHUNK = 128

DECODE_ATTENTION = _build.Kernel(
    'decode_attention', 'skypilot_decode_attention',
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 +
    [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_float,
                               ctypes.c_void_p])
_PAGED_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 +
               [ctypes.c_longlong] * 2 +
               [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
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
    [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_float,
                               ctypes.c_void_p])
_PAGED_Q8_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 +
                  [ctypes.c_longlong] * 4 +
                  [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
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
DECODE_HEAD_DIMS = (64, 128)
DECODE_GROUPS = (1, 2, 4, 8)


# ---------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------


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


def _reference_paged_verify_attention(q, k_pool, v_pool, block_tables,
                                      lengths, scale, block_size,
                                      k_scale=None, v_scale=None):
    kd, vd = _gather_views(q, k_pool, v_pool, block_tables, block_size,
                           k_scale, v_scale)
    return _reference_verify_attention(q, kd, vd, lengths, scale)


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


def _check_rows_kv(what: str, name: str, x: torch.Tensor, hd: int) -> None:
    """Contiguous [Hkv, hd] rows and aligned vector loads: 16 bytes a
    lane for bf16, 8 for int8 codes."""
    align = 16 if x.dtype == torch.bfloat16 else 8
    if (x.stride(-1) != 1 or x.stride(-2) != hd
            or any(st % 8 for st in x.stride()[:-2])
            or x.data_ptr() % align):
        raise ValueError(f'{what}: {name} needs contiguous [Hkv, hd] '
                         'rows, 8-element aligned strides and an aligned '
                         f'base (shape {tuple(x.shape)}, strides '
                         f'{x.stride()})')


def _decode_attention_cuda(q, k, v, lengths, scale, k_scale=None,
                           v_scale=None):
    """Launch K4-cuda (or its int8 form with scales); raises on anything
    the kernel does not take."""
    what = 'decode_attention'
    if not all(x.device == q.device for x in (k, v, lengths)):
        raise ValueError('decode_attention: q, k, v, lengths must share a '
                         'device')
    _check_kv(what, q, k, v, k_scale, v_scale)
    if lengths.dtype != torch.int32 or lengths.dim() != 1:
        raise TypeError('decode_attention: lengths must be int32 [B], got '
                        f'{lengths.dtype} {tuple(lengths.shape)}')
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError('decode_attention: q [B,Hq,hd], k/v '
                         f'[B,S,Hkv,hd] expected, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    b, hq, hd = q.shape
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
        _check_rows_kv(what, name, x, hd)
    if q.data_ptr() % 16:
        raise ValueError('decode_attention: q needs a 16-byte aligned base')
    n_split = -(-s // SPLIT_CHUNK)
    out = torch.empty_like(q)
    part_m = torch.empty((b, hq, n_split), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hq, n_split, hd), dtype=torch.float32,
                           device=q.device)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    parts = (lengths.data_ptr(), out.data_ptr(), part_m.data_ptr(),
             part_l.data_ptr(), part_acc.data_ptr(), b, s, hq, hkv, hd,
             k.stride(0), k.stride(1), v.stride(0), v.stride(1))
    tail = (SPLIT_CHUNK, scale * LOG2E, _stream(q))
    if k_scale is None:
        DECODE_ATTENTION(*head, *parts, *tail)
    else:
        DECODE_ATTENTION_Q8(*head, k_scale.data_ptr(), v_scale.data_ptr(),
                            *parts, k_scale.stride(0), k_scale.stride(1),
                            v_scale.stride(0), v_scale.stride(1), *tail)
    return out


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths,
                          scale, block_size, k_scale=None, v_scale=None):
    """Launch K4-paged (or its int8 form) for q [B, W, Hq, hd] over one
    layer's flat pools [N, Hkv, hd]; raises on anything the kernel does
    not take."""
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
    hkv = k_pool.shape[1]
    _check_heads(what, hq, hkv, hd)
    _check_rows_kv(what, 'k_pool', k_pool, hd)
    _check_rows_kv(what, 'v_pool', v_pool, hd)
    _check_index(what, 'block_tables', block_tables, dev, 2)
    _check_index(what, 'lengths', lengths, dev, 1)
    mb = block_tables.shape[1]
    if block_tables.shape[0] != b or lengths.shape[0] != b or mb < 1 \
            or block_size < 1 or w < 1:
        raise ValueError(f'{what}: block_tables {tuple(block_tables.shape)}'
                         f', lengths {tuple(lengths.shape)}, block_size '
                         f'{block_size} do not fit q {tuple(q.shape)}')
    n_split = -(-(mb * block_size) // SPLIT_CHUNK)
    out = torch.empty_like(q)
    part_m = torch.empty((b, w, hq, n_split), dtype=torch.float32,
                         device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, w, hq, n_split, hd), dtype=torch.float32,
                           device=dev)
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr())
    parts = (block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), b,
             w, mb, block_size, hq, hkv, hd, k_pool.stride(0),
             v_pool.stride(0))
    tail = (SPLIT_CHUNK, scale * LOG2E, _stream(q))
    if k_scale is None:
        kernel = PAGED_DECODE_ATTENTION if w == 1 else PAGED_VERIFY_ATTENTION
        kernel(*head, *parts, *tail)
    else:
        kernel = (PAGED_DECODE_ATTENTION_Q8 if w == 1
                  else PAGED_VERIFY_ATTENTION_Q8)
        kernel(*head, k_scale.data_ptr(), v_scale.data_ptr(), *parts,
               k_scale.stride(0), v_scale.stride(0), *tail)
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
        return _decode_attention_cuda(q, k, v, lengths, float(scale),
                                      k_scale, v_scale)
    return _reference_decode_attention(q, k, v, lengths, scale, k_scale,
                                       v_scale)


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


def rows_dst(pos: torch.Tensor, s: int) -> torch.Tensor:
    """Flat row of each batch row's write position in a [B * S] view:
    ``b * S + pos[b]``, or -1 (no write) where pos is outside [0, S)."""
    b = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    ok = (pos >= 0) & (pos < s)
    return torch.where(ok, b * s + pos, -1).to(torch.int32)


def cache_write_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     pos: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     ks_new: Optional[torch.Tensor] = None,
                     vs_new: Optional[torch.Tensor] = None) -> None:
    """The TPU kernel's form: write one new K/V position per row,
    k/v_cache [B, S, Hkv, hd] (contiguous), k/v_new [B, Hkv, hd], pos
    [B] int32 — row b writes index pos[b], in place. An int8 cache
    passes its scales [B, S, Hkv] and the new rows' [B, Hkv]."""
    b, s = k_cache.shape[:2]
    flat = [x if x is None else x.view(b * s, *x.shape[2:])
            for x in (k_cache, v_cache, k_scale, v_scale)]
    cache_write(flat[0], flat[1], k_new, v_new, rows_dst(pos, s),
                flat[2], flat[3], ks_new, vs_new)
