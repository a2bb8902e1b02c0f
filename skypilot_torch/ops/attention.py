"""Attention ops — the port of ``skypilot_tpu/ops/attention.py``.

``flash_attention`` on CUDA tensors launches the hand-written kernels
that replace the TPU ones: K1-cuda (``csrc/flash_fwd.cu``, for
``_fwd_kernel``, with or without fused RoPE) forward; and backward the
pre-pass (``csrc/flash_bwd.cu`` ``skypilot_flash_bwd_prep``, for the XLA
pass that computes delta in ``_bwd_pallas``), then K2-cuda and K3-cuda
(the same file, for ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``), through
``_FlashAttention``, the counterpart of the JAX ``custom_vjp``. On CPU
tensors the same entry points run ``_flash_fwd_plain`` /
``_flash_bwd_plain`` (on ``_bwd_prep_plain``), dense f32 computations
under the kernels' contract; any other device raises.

Contract of both paths (the TPU kernels'):

- q ``[B, T, H, D]``, k/v ``[B, S, Hkv, D]``; GQA is native — head
  ``h`` reads KV head ``h // (H // Hkv)``, K/V are never repeated;
- causal masking is bottom-right aligned: ``q_pos + S - T >= k_pos``;
- ``lse`` is f32 ``[B, H, T]`` in the log2 domain, from scores that
  ``scale * log2(e)`` multiplies in f32; the backward rebuilds ``P =
  exp2(s * scale * log2(e) - lse)`` the same way (the TPU kernels fold
  the scale into a bf16 copy of q or k instead);
- a row that sees no key (causal with T > S) gets ``out = 0`` and
  ``lse = +1e30``, so its backward ``P`` and all its gradients are 0.
  The dense reference ``dot_product_attention`` gives such rows a
  uniform average instead; the port follows the kernels;
- fused RoPE (``rope_angles``, T == S): q/k come in un-rotated with
  ``[T, D]`` f32 cos/sin tables (the angles duplicated to full width);
  they are rotated in f32 and rounded to the input dtype before the dot
  (``_rot``; K1-cuda and the backward's pre-pass rotate every row once,
  with one shared code), and dq/dk are pulled back through the inverse
  rotation (``_rot_inv``). Only un-rotated q/k are saved for backward.

Not ported: the ``remat_policy`` names that let a layer checkpoint keep
the kernel's out/lse (ROADMAP.md Queue 2); under a plain per-layer
checkpoint the forward kernel runs again in backward.
"""
import ctypes
import math
from typing import Optional, Tuple

import torch

from skypilot_torch.ops import _build

LOG2E = 1.4426950408889634
EMPTY_ROW_LSE = 1e30
_NEG_INF = -1e30

_FWD_ARGS = ([ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 +
             [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
FLASH_FWD = _build.Kernel('flash_fwd', 'skypilot_flash_fwd',
                          [ctypes.c_void_p] * 5 + _FWD_ARGS)
# q, k, v, cos, sin, krot (the rotated-k scratch), out, lse.
FLASH_FWD_ROPE = _build.Kernel('flash_fwd', 'skypilot_flash_fwd_rope',
                               [ctypes.c_void_p] * 8 + _FWD_ARGS)
_BWD_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]
FLASH_BWD_DQ = _build.Kernel('flash_bwd', 'skypilot_flash_bwd_dq',
                             _BWD_ARGS)
FLASH_BWD_DKV = _build.Kernel('flash_bwd', 'skypilot_flash_bwd_dkv',
                              _BWD_ARGS)
# ptrs (dO, out, q, k, cos, sin, q_rot, k_rot, delta), B, T, S, H, Hkv,
# D, strides, stream.
FLASH_BWD_PREP = _build.Kernel(
    'flash_bwd', 'skypilot_flash_bwd_prep',
    [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
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


def rope_tables(angles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, D/2] angles -> (cos, sin), each [T, D] f32 contiguous: the
    angles duplicated to full width, as the kernels read them."""
    full = torch.cat([angles, angles], dim=-1).float()
    return torch.cos(full).contiguous(), torch.sin(full).contiguous()


def _rot(x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor) -> torch.Tensor:
    """RoPE of [B, L, H, D] by [L, D] tables, in f32, rounded to x's
    dtype (the TPU kernels' ``_rot``)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    swap = torch.cat([-x2, x1], dim=-1)
    return (xf * cos[None, :, None] + swap * sin[None, :, None]).to(x.dtype)


def _rot_inv(g: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> torch.Tensor:
    """The transpose (inverse) rotation of an f32 [B, L, H, D] gradient
    (``_rot_inv``)."""
    g1, g2 = g.chunk(2, dim=-1)
    swap = torch.cat([g2, -g1], dim=-1)
    return g * cos[None, :, None] + swap * sin[None, :, None]


def _check_rope(t: int, s: int, d: int, cos, sin) -> None:
    if (cos is None) != (sin is None):
        raise ValueError('flash_attention: pass both cos and sin or '
                         'neither')
    if cos is None:
        return
    if t != s:
        raise ValueError(f'flash_attention: fused RoPE assumes aligned '
                         f'self-attention positions, got T={t} != S={s}')
    if cos.shape != (t, d) or sin.shape != (t, d):
        raise ValueError(f'flash_attention: cos/sin must be [T, D] = '
                         f'{(t, d)}, got {tuple(cos.shape)}, '
                         f'{tuple(sin.shape)}')


def _causal_visible(t: int, s: int, device) -> torch.Tensor:
    q_pos = torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    return k_pos <= q_pos + (s - t)


def _flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, scale: Optional[float] = None,
                     cos: Optional[torch.Tensor] = None,
                     sin: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense f32 (out [B,T,H,D] in q.dtype, lse f32 [B,H,T] log2)
    under the kernel's contract (module docstring); ``cos``/``sin``
    [T, D] fuse RoPE."""
    b, t, h, d = q.shape
    _, s, hkv, _ = k.shape
    if h % hkv:
        raise ValueError(f'H={h} is not a multiple of Hkv={hkv}')
    _check_rope(t, s, d, cos, sin)
    if scale is None:
        scale = d ** -0.5
    if cos is not None:
        q, k = _rot(q, cos, sin), _rot(k, cos, sin)
    qg = q.float().reshape(b, t, hkv, h // hkv, d)
    logits = torch.einsum('bthgd,bshd->bhgts', qg,
                          k.float()) * (scale * LOG2E)
    if causal:
        logits = logits.masked_fill(~_causal_visible(t, s, q.device),
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


def _bwd_prep_plain(q: torch.Tensor, k: torch.Tensor, out: torch.Tensor,
                    do: torch.Tensor, cos: Optional[torch.Tensor] = None,
                    sin: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward pre-pass: (delta, q_rot, k_rot). ``delta = rowsum(do
    * out)`` in f32, ``[B, H, T]`` like lse; with tables q and k rotated
    by ``_rot`` (the forward's rotation), else q and k as given."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if cos is None:
        return delta, q, k
    return delta, _rot(q, cos, sin), _rot(k, cos, sin)


def _flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, lse: torch.Tensor,
                     do: torch.Tensor, cos: Optional[torch.Tensor] = None,
                     sin: Optional[torch.Tensor] = None,
                     causal: bool = True, scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense f32 (dq, dk, dv) under the pre-pass's and K2/K3's contract:
    delta and the rotated q/k from ``_bwd_prep_plain``, P rebuilt as
    ``exp2(s * scale * log2(e) - lse)`` from the saved log2-domain lse
    (so a row that saw no key, lse = +1e30, gets zero gradients), dS = P
    (dP - delta), the scale applied once to dq/dk, and with ``cos``/
    ``sin`` the gradients pulled back through RoPE. q/k are the
    un-rotated inputs. Returns gradients in q/k/v's dtypes."""
    b, t, h, d = q.shape
    _, s, hkv, _ = k.shape
    g = h // hkv
    _check_rope(t, s, d, cos, sin)
    if scale is None:
        scale = d ** -0.5
    delta, qr, kr = _bwd_prep_plain(q, k, out, do, cos, sin)
    qf = qr.float().reshape(b, t, hkv, g, d)
    kf, vf = kr.float(), v.float()
    dof = do.float().reshape(b, t, hkv, g, d)
    logits = torch.einsum('bthgd,bshd->bhgts', qf, kf) * (scale * LOG2E)
    if causal:
        logits = logits.masked_fill(~_causal_visible(t, s, q.device),
                                    -math.inf)
    p = torch.exp2(logits - lse.float().reshape(b, hkv, g, t)[..., None])
    dp = torch.einsum('bthgd,bshd->bhgts', dof, vf)
    ds = p * (dp - delta.reshape(b, hkv, g, t)[..., None])
    dq = torch.einsum('bhgts,bshd->bthgd', ds, kf).reshape(b, t, h, d)
    dk = torch.einsum('bhgts,bthgd->bshd', ds, qf)
    dv = torch.einsum('bhgts,bthgd->bshd', p, dof)
    dq, dk = dq * scale, dk * scale
    if cos is not None:
        dq, dk = _rot_inv(dq, cos, sin), _rot_inv(dk, cos, sin)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(what: str, tensors, dtype=torch.bfloat16) -> None:
    """Device, dtype and layout checks shared by the CUDA wrappers."""
    dev = tensors[0][1].device
    for name, x in tensors:
        if x.device != dev:
            raise ValueError(f'{what}: all tensors must share a device, '
                             f'{name} is on {x.device}, not {dev}')
        if x.dtype != dtype:
            raise TypeError(f'{what}: the CUDA kernel takes {dtype} '
                            f'{name}, got {x.dtype}')
        # TMA tensor maps and 16-byte vector loads: unit-stride rows,
        # strides of whole 16-byte units, a 16-byte aligned base.
        if (x.dim() != 4 or x.stride(3) != 1
                or any(st % 8 for st in x.stride()[:3])
                or x.data_ptr() % 16):
            raise ValueError(f'{what}: {name} needs 4 dims, a unit-'
                             'stride head_dim, strides that are '
                             'multiples of 8 and a 16-byte aligned '
                             f'base (shape {tuple(x.shape)}, strides '
                             f'{x.stride()})')


def _check_shapes(what: str, q, k, v) -> Tuple[int, ...]:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f'{what}: q [B,T,H,D], k/v [B,S,Hkv,D] '
                         f'expected, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    b, t, h, d = q.shape
    bk, s, hkv, dk = k.shape
    if bk != b or dk != d or h % hkv or t < 1 or s < 1:
        raise ValueError(f'{what}: incompatible shapes q '
                         f'{tuple(q.shape)}, k/v {tuple(k.shape)}')
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f'{what}: head_dim {d} not supported by the '
                         f'CUDA kernels (they take {FLASH_HEAD_DIMS})')
    return b, t, s, h, hkv, d


def _check_tables(what: str, dev, cos, sin) -> None:
    for name, x in (('cos', cos), ('sin', sin)):
        if (x.device != dev or x.dtype != torch.float32
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f'{what}: {name} must be a contiguous, '
                             f'16-byte aligned f32 tensor on {dev}')


def _strides(*tensors) -> list:
    return [st for x in tensors for st in x.stride()[:3]]


def _flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float, cos=None, sin=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1-cuda (FLASH_FWD, or FLASH_FWD_ROPE with tables);
    raises on anything the kernel does not take. With tables the kernel
    first rotates q into ``out`` and k into a scratch it is given, then
    attends over the rotated copies."""
    b, t, s, h, hkv, d = _check_shapes('flash_attention', q, k, v)
    _check_cuda('flash_attention', (('q', q), ('k', k), ('v', v)))
    _check_rope(t, s, d, cos, sin)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    tail = [b, t, s, h, hkv, d, *_strides(q, k, v, out), scale * LOG2E,
            int(causal), torch.cuda.current_stream(q.device).cuda_stream]
    if cos is None:
        FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), *tail)
    else:
        _check_tables('flash_attention', q.device, cos, sin)
        krot = torch.empty((b, s, hkv, d), dtype=k.dtype, device=k.device)
        FLASH_FWD_ROPE(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       cos.data_ptr(), sin.data_ptr(), krot.data_ptr(),
                       out.data_ptr(), lse.data_ptr(), *tail)
    return out, lse


def _bwd_prep_cuda(q, k, out, do, cos, sin
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the pre-pass (FLASH_BWD_PREP) on checked inputs: (delta,
    q_rot, k_rot) as ``_bwd_prep_plain``; the rotated copies are scratch
    allocated here, and without tables q and k come back as given."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    qr, kr, rot = q, k, [None, None, None, None]
    if cos is not None:
        qr = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
        kr = torch.empty((b, s, hkv, d), dtype=k.dtype, device=k.device)
        rot = [cos.data_ptr(), sin.data_ptr(), qr.data_ptr(), kr.data_ptr()]
    ptrs = (ctypes.c_void_p * 9)(do.data_ptr(), out.data_ptr(),
                                 q.data_ptr(), k.data_ptr(), *rot,
                                 delta.data_ptr())
    FLASH_BWD_PREP(ptrs, b, t, s, h, hkv, d,
                   (ctypes.c_longlong * 12)(*_strides(do, out, q, k)),
                   torch.cuda.current_stream(q.device).cuda_stream)
    return delta, qr, kr


def _flash_bwd_cuda(q, k, v, out, lse, do, cos, sin, causal: bool,
                    scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the pre-pass (delta, and with tables the rotated q/k),
    then K2-cuda and K3-cuda on its outputs; raises, before any launch,
    on anything they or their tensor maps do not take (q, k, v, out and
    do alike)."""
    what = 'flash_attention backward'
    b, t, s, h, hkv, d = _check_shapes(what, q, k, v)
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f'{what}: out/do must match q {tuple(q.shape)}')
    _check_cuda(what, (('q', q), ('k', k), ('v', v), ('out', out),
                       ('do', do)))
    _check_rope(t, s, d, cos, sin)
    if (lse.shape != (b, h, t) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f'{what}: lse must be f32 [B, H, T] = '
                         f'{(b, h, t)} contiguous on {q.device}')
    if cos is not None:
        _check_tables(what, q.device, cos, sin)
    delta, qr, kr = _bwd_prep_cuda(q, k, out, do, cos, sin)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    args = (qr, kr, v, do, lse, delta, cos, sin)
    _bwd_launch(FLASH_BWD_DQ, *args, (dq,), causal, scale)
    _bwd_launch(FLASH_BWD_DKV, *args, (dk, dv), causal, scale)
    return dq, dk, dv


def _bwd_launch(kernel: _build.Kernel, q, k, v, do, lse, delta, cos, sin,
                outs, causal: bool, scale: float) -> None:
    """One launch of K2 (outs = (dq,)) or K3 (outs = (dk, dv)) on the
    pre-pass's outputs (q and k rotated when tables are given; the
    tables then pull dq/dk back through RoPE)."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    tables = ([cos.data_ptr(), sin.data_ptr()] if cos is not None
              else [None, None])
    ptrs = (ctypes.c_void_p * 10)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *tables,
        *(x.data_ptr() for x in outs))
    strides = _strides(q, k, v, do, *outs)
    strides += [0] * (18 - len(strides))
    kernel(ptrs, b, t, s, h, hkv, d, (ctypes.c_longlong * 18)(*strides),
           scale, scale * LOG2E, int(causal),
           torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None,
                        cos: Optional[torch.Tensor] = None,
                        sin: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,D], lse f32 [B,H,T] log2 domain). CUDA tensors go to
    K1-cuda, CPU tensors to ``_flash_fwd_plain``; any other device
    raises. ``cos``/``sin`` ([T, D] f32, T == S) fuse RoPE."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == 'cuda':
        return _flash_fwd_cuda(q, k, v, causal, float(scale), cos, sin)
    if q.device.type == 'cpu':
        return _flash_fwd_plain(q, k, v, causal, scale, cos, sin)
    raise ValueError(f'flash_attention: unsupported device {q.device}')


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, cos: Optional[torch.Tensor] = None,
                        sin: Optional[torch.Tensor] = None,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(dq, dk, dv) from the forward's saved (un-rotated) q/k, v, out
    and lse. CUDA tensors go to the pre-pass, K2-cuda and K3-cuda, CPU
    tensors to ``_flash_bwd_plain``; any other device raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == 'cuda':
        return _flash_bwd_cuda(q, k, v, out, lse, do, cos, sin, causal,
                               float(scale))
    if q.device.type == 'cpu':
        return _flash_bwd_plain(q, k, v, out, lse, do, cos, sin, causal,
                                scale)
    raise ValueError(f'flash_attention: unsupported device {q.device}')


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX ``_flash_attention``: the forward
    saves the un-rotated q/k, v, out, lse and the tables; the backward
    runs the pre-pass, K2 then K3 (the plain version for CPU tensors).
    cos/sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, cos, sin)
        ctx.save_for_backward(q, k, v, cos, sin, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         do.contiguous(), cos, sin,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    rope_angles: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Flash attention. q: [B,T,H,D]; k,v: [B,S,Hkv,D] -> [B,T,H,D].

    ``rope_angles`` ([T, D/2] f32, requires T == S): apply RoPE to q
    and k inside the kernels; callers pass them un-rotated. Gradients
    flow through ``_FlashAttention`` when autograd records."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    cos = sin = None
    if rope_angles is not None:
        cos, sin = rope_tables(rope_angles)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, cos, sin, causal,
                                     float(scale))
    return flash_attention_fwd(q, k, v, causal, scale, cos, sin)[0]
