"""Length-aware decode attention — the port of
``skypilot_tpu/ops/decode_attention.py`` (dense cache only).

``decode_attention`` on a CUDA tensor launches K4-cuda
(``csrc/decode_attention.cu``: split-K flash-decoding plus a merge
kernel, the hand-written replacement of the TPU kernel
``_decode_attn_kernel``); on a CPU tensor it runs
``_reference_decode_attention``. As in the TPU kernel, a length is
clamped to ``max(len, 1)`` (and to S). The paged and verify variants,
``cache_write`` (K5) and ``paged_gather`` come with the engine slice
(ROADMAP.md).
"""
import ctypes

import torch

from skypilot_torch.ops import _build

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
DECODE_HEAD_DIMS = (64, 128)
DECODE_GROUPS = (1, 2, 4, 8)


def _reference_decode_attention(q, k, v, lengths, scale):
    """q [B, Hq, hd]; k/v [B, S, Hkv, hd]; lengths [B] — row b attends
    keys [0, max(lengths[b], 1))."""
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
    if hd not in DECODE_HEAD_DIMS or hq // hkv not in DECODE_GROUPS:
        raise ValueError(f'decode_attention: head_dim {hd} / group '
                         f'{hq // hkv} not supported by the CUDA kernel '
                         f'(takes {DECODE_HEAD_DIMS} / {DECODE_GROUPS})')
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
                     SPLIT_CHUNK, scale * LOG2E,
                     torch.cuda.current_stream(q.device).cuda_stream)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float) -> torch.Tensor:
    """Single-position decode attention over per-row valid prefixes.

    q [B, Hq, hd]; k/v [B, S, Hkv, hd]; lengths [B] int32 — row b
    attends keys [0, lengths[b]). Returns [B, Hq, hd] in q.dtype. CUDA
    tensors go to K4-cuda, CPU tensors to the plain reference; any
    other device raises.
    """
    if q.device.type == 'cuda':
        return _decode_attention_cuda(q, k, v, lengths, float(scale))
    if q.device.type == 'cpu':
        return _reference_decode_attention(q, k, v, lengths, scale)
    raise ValueError(f'decode_attention: unsupported device {q.device}')
