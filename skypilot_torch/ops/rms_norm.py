"""The residual add and RMSNorm of the serving path's rows
(``add_rms_norm``, and ``rms_norm`` with no add), with a row's bits
independent of the other rows of the call.

CUDA tensors launch ``csrc/rms_norm.cu`` (one block per row, one pass,
the sum of squares in one fixed tree set by ``norm_plan``); CPU tensors
take the plain version, torch's add and then ``llama._rms_norm``, which
the training forward keeps.
"""
import ctypes
from typing import Optional, Tuple

import torch

from skypilot_torch.models import llama
from skypilot_torch.ops import _build

_LAUNCH = [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
RMS_NORM = _build.Kernel('rms_norm', 'skypilot_rms_norm',
                         [ctypes.c_void_p] * 3 + _LAUNCH)
ADD_RMS_NORM = _build.Kernel('rms_norm', 'skypilot_add_rms_norm',
                             [ctypes.c_void_p] * 5 + _LAUNCH)
_DTYPES = (torch.bfloat16, torch.float32)
# The threads a row's block aims at, the vectors a thread may hold (the
# kernel's instantiations), and the most threads a block has.
NORM_THREADS = 256
NORM_VPT = (1, 2, 4)
NORM_MAX_THREADS = 512


# The plain version, the training forward's norm.
_rms_norm_plain = llama._rms_norm


def norm_plan(d: int, elem_bytes: int) -> Tuple[int, int]:
    """(threads NT, vectors a thread VPT) of a row of ``d`` elements of
    ``elem_bytes`` each: the row is ``d * elem_bytes / 16`` vectors of 16
    bytes, thread t holds vectors t, t + NT, ..., and the sum of squares'
    order follows from these, so from d and the dtype alone."""
    per = 16 // elem_bytes
    if d < 1 or d % per:
        raise ValueError(f'rms_norm: the CUDA kernel takes rows of a '
                         f'multiple of {per} elements (16 bytes), got {d}')
    nvec = d // per
    vpt = next((v for v in NORM_VPT if nvec <= NORM_THREADS * v),
               NORM_VPT[-1])
    threads = 32 * -(-nvec // (32 * vpt))
    if threads > NORM_MAX_THREADS:
        raise ValueError(f'rms_norm: a row of {d} elements needs {threads} '
                         f'threads a block (at most {NORM_MAX_THREADS})')
    return threads, vpt


def _add_rms_norm_plain(x, delta, weight, eps, offset):
    s = x if delta is None else x + delta
    return s, _rms_norm_plain(s, weight, eps, offset)


def _add_rms_norm_cuda(x, delta, weight, eps, offset):
    """Launch the kernel; raises on anything it does not take."""
    d = x.shape[-1]
    if (x.dtype not in _DTYPES or weight.dtype not in _DTYPES
            or weight.shape != (d,) or weight.device != x.device):
        raise TypeError('rms_norm: the CUDA kernel takes bf16/f32 x [..., D] '
                        f'and a bf16/f32 [D] weight on its device, got '
                        f'{x.dtype} {tuple(x.shape)}, {weight.dtype} '
                        f'{tuple(weight.shape)}')
    if not weight.is_contiguous():
        raise ValueError('rms_norm: the weight must be contiguous')
    threads, vpt = norm_plan(d, x.element_size())
    # Bound to names: a temporary's memory could be handed out again
    # before the kernel reads it.
    xc = x.contiguous()
    dc = None if delta is None else delta.contiguous()
    y = torch.empty_like(xc)
    s = xc if dc is None else torch.empty_like(xc)
    if any(t.data_ptr() % 16 for t in (xc, weight, y, s) + (
            () if dc is None else (dc,))):
        raise ValueError('rms_norm: the CUDA kernel takes 16-byte aligned '
                         'rows and weight')
    rows = xc.numel() // d
    if rows:
        tail = (rows, d, threads, vpt, float(eps), int(bool(offset)),
                int(x.dtype == torch.float32),
                int(weight.dtype == torch.float32),
                torch.cuda.current_stream(x.device).cuda_stream)
        if dc is None:
            RMS_NORM(xc.data_ptr(), weight.data_ptr(), y.data_ptr(), *tail)
        else:
            ADD_RMS_NORM(xc.data_ptr(), dc.data_ptr(), weight.data_ptr(),
                         s.data_ptr(), y.data_ptr(), *tail)
    return s, y


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
                 weight: torch.Tensor, eps: float,
                 offset: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, y)``: ``s = x + delta`` rounded to x's dtype (``x`` itself when
    ``delta`` is None) and ``y = s * rsqrt(mean(s^2) + eps) * w`` over the
    last dim in f32 (``w + 1`` when ``offset``), rounded to x's dtype.
    CUDA: one launch, one block per row, a fixed summation tree; CPU: the
    plain version (torch's add, then ``llama._rms_norm``)."""
    if delta is not None and (delta.shape != x.shape
                              or delta.dtype != x.dtype
                              or delta.device != x.device):
        raise ValueError('add_rms_norm: delta must match x, got '
                         f'{delta.dtype} {tuple(delta.shape)} on '
                         f'{delta.device} for {x.dtype} {tuple(x.shape)} '
                         f'on {x.device}')
    if x.device.type == 'cuda':
        return _add_rms_norm_cuda(x, delta, weight, eps, offset)
    if x.device.type != 'cpu':
        raise ValueError(f'rms_norm: unsupported device {x.device}')
    return _add_rms_norm_plain(x, delta, weight, eps, offset)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    """``add_rms_norm`` with no delta: the norm alone, through the same
    kernel and order."""
    return add_rms_norm(x, None, weight, eps, offset)[1]
