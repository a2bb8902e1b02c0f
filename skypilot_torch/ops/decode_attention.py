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
"""
import ctypes

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
DECODE_HEAD_DIMS = (64, 128)
DECODE_GROUPS = (1, 2, 4, 8)


# ---------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------


def _reference_decode_attention(q, k, v, lengths, scale):
    """q [B, Hq, hd]; k/v [B, S, Hkv, hd]; lengths [B] — row b
    attends keys [0, max(lengths[b], 1))."""
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


def _reference_paged_decode_attention(q, k_pool, v_pool, block_tables,
                                      lengths, scale, block_size):
    """Gather each row's blocks into a contiguous view, then the plain
    dense decode attention (the JAX package's route)."""
    gidx = kv_pool_lib.read_indices(block_tables, block_size)
    return _reference_decode_attention(q, paged_gather(k_pool, gidx),
                                       paged_gather(v_pool, gidx),
                                       lengths, scale)


def _reference_paged_verify_attention(q, k_pool, v_pool, block_tables,
                                      lengths, scale, block_size):
    gidx = kv_pool_lib.read_indices(block_tables, block_size)
    return _reference_verify_attention(q, paged_gather(k_pool, gidx),
                                       paged_gather(v_pool, gidx),
                                       lengths, scale)


def _reference_cache_write(k, v, k_new, v_new, dst):
    """``index_copy_`` into the flat views; rows whose ``dst`` lies
    outside [0, N) are dropped."""
    keep = (dst >= 0) & (dst < k.shape[0])
    if not bool(keep.all()):
        dst, k_new, v_new = dst[keep], k_new[keep], v_new[keep]
    k.index_copy_(0, dst.long(), k_new)
    v.index_copy_(0, dst.long(), v_new)


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


def _check_rows(what: str, name: str, x: torch.Tensor, hd: int) -> None:
    """[N, Hkv, hd] with contiguous [Hkv, hd] rows, 16-byte loads."""
    if (x.dim() != 3 or x.stride(2) != 1 or x.stride(1) != hd
            or x.stride(0) % 8 or x.data_ptr() % 16):
        raise ValueError(f'{what}: {name} needs contiguous [Hkv, hd] '
                         'rows, an 8-element aligned row stride and a '
                         f'16-byte aligned base (shape {tuple(x.shape)}, '
                         f'strides {x.stride()})')


def _check_heads(what: str, hq: int, hkv: int, hd: int) -> None:
    if hq % hkv or hd not in DECODE_HEAD_DIMS or \
            hq // hkv not in DECODE_GROUPS:
        raise ValueError(f'{what}: Hq {hq} / Hkv {hkv} / head_dim {hd} '
                         'not supported by the CUDA kernel (takes '
                         f'head_dim {DECODE_HEAD_DIMS}, group '
                         f'{DECODE_GROUPS})')


def _decode_attention_cuda(q, k, v, lengths, scale):
    """Launch K4-cuda; raises on anything the kernel does not take."""
    if not all(x.device == q.device for x in (k, v, lengths)):
        raise ValueError('decode_attention: q, k, v, lengths must share a '
                         'device')
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError('decode_attention: the CUDA kernel takes bf16 '
                        f'q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}')
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
        if (x.stride(3) != 1 or x.stride(2) != hd or x.stride(1) % 8
                or x.stride(0) % 8 or x.data_ptr() % 16):
            raise ValueError(f'decode_attention: {name} needs contiguous '
                             '[Hkv, hd] rows, 8-element aligned strides '
                             f'and a 16-byte aligned base (strides '
                             f'{x.stride()})')
    if q.data_ptr() % 16:
        raise ValueError('decode_attention: q needs a 16-byte aligned base')
    n_split = -(-s // SPLIT_CHUNK)
    out = torch.empty_like(q)
    part_m = torch.empty((b, hq, n_split), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hq, n_split, hd), dtype=torch.float32,
                           device=q.device)
    DECODE_ATTENTION(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lengths.data_ptr(), out.data_ptr(), part_m.data_ptr(),
                     part_l.data_ptr(), part_acc.data_ptr(), b, s, hq, hkv,
                     hd, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                     SPLIT_CHUNK, scale * LOG2E, _stream(q))
    return out


def _paged_attention_cuda(q, k_pool, v_pool, block_tables, lengths,
                          scale, block_size):
    """Launch K4-paged for q [B, W, Hq, hd] over one layer's flat pools
    [N, Hkv, hd]; raises on anything the kernel does not take."""
    what = 'paged_attention'
    dev = q.device
    for name, x in (('q', q), ('k_pool', k_pool), ('v_pool', v_pool)):
        if x.device != dev or x.dtype != torch.bfloat16:
            raise TypeError(f'{what}: the CUDA kernel takes bf16 {name} '
                            f'on {dev}, got {x.dtype} on {x.device}')
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
    _check_rows(what, 'k_pool', k_pool, hd)
    _check_rows(what, 'v_pool', v_pool, hd)
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
    kernel = PAGED_DECODE_ATTENTION if w == 1 else PAGED_VERIFY_ATTENTION
    kernel(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
           part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), b, w,
           mb, block_size, hq, hkv, hd, k_pool.stride(0), v_pool.stride(0),
           SPLIT_CHUNK, scale * LOG2E, _stream(q))
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
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be contiguous with a '
                             '16-byte aligned base')
    if row_bytes % 16:
        raise ValueError(f'{what}: a row of {row_bytes} bytes is not a '
                         'whole number of 16-byte vectors')
    if k_new.shape[0] == 0:
        return
    CACHE_WRITE(k.data_ptr(), v.data_ptr(), k_new.data_ptr(),
                v_new.data_ptr(), dst.data_ptr(), k_new.shape[0],
                k.shape[0], row_bytes, _stream(k))


# ---------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------


def _route(what: str, x: torch.Tensor) -> str:
    if x.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'{what}: unsupported device {x.device}')
    return x.device.type


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """Single-position decode attention over per-row valid prefixes.

    q [B, Hq, hd]; k/v [B, S, Hkv, hd]; lengths [B] int32 — row b
    attends keys [0, lengths[b]). Returns [B, Hq, hd] in q.dtype. CUDA
    tensors go to K4-cuda, CPU tensors to the plain reference.
    """
    if _route('decode_attention', q) == 'cuda':
        return _decode_attention_cuda(q, k, v, lengths, float(scale))
    return _reference_decode_attention(q, k, v, lengths, scale)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, scale: float,
                           block_size: int) -> torch.Tensor:
    """Single-position decode attention over PAGED caches.

    q [B, Hq, hd]; k_pool/v_pool one layer's flat pool
    [num_blocks * block_size, Hkv, hd]; block_tables [B, MB] int32 maps
    row b's logical block i to a pool block; lengths [B] — row b
    attends its first ``lengths[b]`` logical positions. CUDA: K4-paged
    with W = 1 reads the table directly; CPU: gather + the plain dense
    version."""
    if _route('paged_decode_attention', q) == 'cuda':
        return _paged_attention_cuda(q[:, None], k_pool, v_pool,
                                     block_tables, lengths, float(scale),
                                     block_size)[:, 0]
    return _reference_paged_decode_attention(q, k_pool, v_pool,
                                             block_tables, lengths, scale,
                                             block_size)


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           lengths: torch.Tensor, scale: float,
                           block_size: int) -> torch.Tensor:
    """Multi-position (speculative VERIFY) decode attention over PAGED
    caches: q [B, W, Hq, hd], query j of row b attends its first
    ``lengths[b] + j`` logical positions; lengths is the BASE length
    (the j = 0 query's valid prefix, self included). Pools and tables
    as in ``paged_decode_attention``. Returns [B, W, Hq, hd]."""
    if _route('paged_verify_attention', q) == 'cuda':
        return _paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                     lengths, float(scale), block_size)
    return _reference_paged_verify_attention(q, k_pool, v_pool,
                                             block_tables, lengths, scale,
                                             block_size)


def cache_write(k: torch.Tensor, v: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, dst: torch.Tensor) -> None:
    """Write R new K/V rows IN PLACE: k/v flat row views [N, Hkv, hd],
    k_new/v_new [R, Hkv, hd], dst [R] int32 row indices. A dst outside
    [0, N) writes nothing; rows sharing a dst leave any one of them.
    CUDA: K5-cuda (one launch for K and V); CPU: ``index_copy_``."""
    if _route('cache_write', k) == 'cuda':
        _cache_write_cuda(k, v, k_new, v_new, dst)
    else:
        _reference_cache_write(k, v, k_new, v_new, dst)


def rows_dst(pos: torch.Tensor, s: int) -> torch.Tensor:
    """Flat row of each batch row's write position in a [B * S] view:
    ``b * S + pos[b]``, or -1 (no write) where pos is outside [0, S)."""
    b = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device)
    ok = (pos >= 0) & (pos < s)
    return torch.where(ok, b * s + pos, -1).to(torch.int32)


def cache_write_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     pos: torch.Tensor) -> None:
    """The TPU kernel's form: write one new K/V position per row,
    k/v_cache [B, S, Hkv, hd] (contiguous), k/v_new [B, Hkv, hd], pos
    [B] int32 — row b writes index pos[b], in place."""
    b, s = k_cache.shape[:2]
    cache_write(k_cache.view(b * s, *k_cache.shape[2:]),
                v_cache.view(b * s, *v_cache.shape[2:]), k_new, v_new,
                rows_dst(pos, s))
