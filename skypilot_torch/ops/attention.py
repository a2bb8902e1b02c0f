"""Attention ops — the port of ``skypilot_tpu/ops/attention.py``.

``flash_attention`` on a CUDA tensor launches K1-cuda
(``csrc/flash_fwd.cu``, the hand-written replacement of the TPU
kernel ``_fwd_kernel``); on a CPU tensor it runs ``_flash_fwd_plain``,
a dense f32 computation under the same contract. Forward only: the
backward kernels and the fused-RoPE variant come with the training
slice (ROADMAP.md).

Contract of both paths (the TPU kernel's, ``_fwd_kernel``):

- q ``[B, T, H, D]``, k/v ``[B, S, Hkv, D]``; GQA is native — head
  ``h`` reads KV head ``h // (H // Hkv)``, K/V are never repeated;
- causal masking is bottom-right aligned: ``q_pos + S - T >= k_pos``;
- ``lse`` is f32 ``[B, H, T]`` in the log2 domain;
- a row that sees no key (causal with T > S) gets ``out = 0`` and
  ``lse = +1e30``. The dense reference ``dot_product_attention`` gives
  such rows a uniform average instead; the port follows the kernel,
  which a backward kernel depends on.
"""
import ctypes
import math
from typing import Optional, Tuple

import torch

from skypilot_torch.ops import _build

LOG2E = 1.4426950408889634
EMPTY_ROW_LSE = 1e30
_NEG_INF = -1e30

FLASH_FWD = _build.Kernel(
    'flash_fwd', 'skypilot_flash_fwd',
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
    [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
FLASH_HEAD_DIMS = (64, 128)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q: [B,T,H,D]; k,v: [B,S,Hkv,D] -> [B,T,H,D]."""
    b, t, h, d = q.shape
    _, s, hkv, _ = k.shape
    if h % hkv:
        raise ValueError(f'H={h} is not a multiple of Hkv={hkv}')
    groups = h // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, t, hkv, groups, d)
    logits = torch.einsum('bthgd,bshd->bhgts', qg.float(),
                          k.float()) * scale
    if causal:
        mask = torch.ones((t, s), dtype=torch.bool,
                          device=q.device).tril(diagonal=s - t)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhgts,bshd->bthgd', probs.to(v.dtype), v)
    return out.reshape(q.shape)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE on [B, T, H, D]; angles [T, D/2] f32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense f32 (out [B,T,H,D] in q.dtype, lse f32 [B,H,T] log2)
    under the kernel's contract (module docstring)."""
    b, t, h, d = q.shape
    _, s, hkv, _ = k.shape
    if h % hkv:
        raise ValueError(f'H={h} is not a multiple of Hkv={hkv}')
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, t, hkv, h // hkv, d)
    logits = torch.einsum('bthgd,bshd->bhgts', qg,
                          k.float()) * (scale * LOG2E)
    if causal:
        q_pos = torch.arange(t, device=q.device)[:, None]
        k_pos = torch.arange(s, device=q.device)[None, :]
        logits = logits.masked_fill(k_pos > q_pos + (s - t),
                                    -math.inf)
    m = logits.amax(dim=-1, keepdim=True)
    seen = m > -math.inf
    p = torch.exp2(logits - torch.where(seen, m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    # Rows that see no key have p == 0 everywhere, hence out == 0.
    out = torch.einsum('bhgts,bshd->bthgd',
                       p / torch.where(seen, l, torch.ones_like(l)),
                       v.float())
    lse = torch.where(seen, m + torch.log2(l),
                      torch.full_like(m, EMPTY_ROW_LSE))
    return (out.reshape(b, t, h, d).to(q.dtype),
            lse.reshape(b, h, t))


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1-cuda; raises on anything the kernel does not take."""
    if not (k.device == q.device and v.device == q.device):
        raise ValueError('flash_attention: q, k, v must share a device, '
                         f'got {q.device}, {k.device}, {v.device}')
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError('flash_attention: the CUDA kernel takes bf16 '
                        f'q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}')
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError('flash_attention: q [B,T,H,D], k/v [B,S,Hkv,D] '
                         f'expected, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    b, t, h, d = q.shape
    bk, s, hkv, dk = k.shape
    if bk != b or dk != d or h % hkv or t < 1 or s < 1:
        raise ValueError(f'flash_attention: incompatible shapes q '
                         f'{tuple(q.shape)}, k/v {tuple(k.shape)}')
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f'flash_attention: head_dim {d} not supported '
                         f'by the CUDA kernel (takes {FLASH_HEAD_DIMS})')
    for name, x in (('q', q), ('k', k), ('v', v)):
        # 16-byte cp.async / vector loads: unit-stride rows, 8-element
        # aligned row strides, 16-byte aligned base.
        if (x.stride(3) != 1 or any(st % 8 for st in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f'flash_attention: {name} needs a unit-'
                             'stride head_dim, strides that are '
                             'multiples of 8 and a 16-byte aligned '
                             f'base (strides {x.stride()})')
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), b, t, s, h, hkv, d,
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              out.stride(0), out.stride(1), out.stride(2),
              scale * LOG2E, int(causal),
              torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D], lse f32 [B,H,T] log2 domain). CUDA tensors go to
    K1-cuda, CPU tensors to ``_flash_fwd_plain``; any other device
    raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == 'cuda':
        return _flash_fwd_cuda(q, k, v, causal, float(scale))
    if q.device.type == 'cpu':
        return _flash_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f'flash_attention: unsupported device {q.device}')


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention forward. q: [B,T,H,D]; k,v: [B,S,Hkv,D] ->
    [B,T,H,D]."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
