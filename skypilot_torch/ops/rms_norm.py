"""RMSNorm of the serving path's rows (``rms_norm``), with a row's bits
independent of the other rows of the call.

CUDA tensors launch ``csrc/rms_norm.cu`` (one block per row, the sum of
squares in one fixed tree); CPU tensors take the plain version,
``llama._rms_norm``, which the training forward keeps.
"""
import ctypes

import torch

from skypilot_torch.models import llama
from skypilot_torch.ops import _build

RMS_NORM = _build.Kernel('rms_norm', 'skypilot_rms_norm',
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 +
                         [ctypes.c_float] + [ctypes.c_int] * 3 +
                         [ctypes.c_void_p])
_DTYPES = (torch.bfloat16, torch.float32)


# The plain version, the training forward's norm.
_rms_norm_plain = llama._rms_norm


def _rms_norm_cuda(x, weight, eps, offset):
    d = x.shape[-1]
    if (x.dtype not in _DTYPES or weight.dtype not in _DTYPES
            or weight.shape != (d,) or weight.device != x.device):
        raise TypeError('rms_norm: the CUDA kernel takes bf16/f32 x [..., D] '
                        f'and a bf16/f32 [D] weight on its device, got '
                        f'{x.dtype} {tuple(x.shape)}, {weight.dtype} '
                        f'{tuple(weight.shape)}')
    # Bound to names: a temporary's memory could be handed out again
    # before the kernel reads it.
    xc, wc = x.contiguous(), weight.contiguous()
    y = torch.empty_like(xc)
    rows = xc.numel() // d if d else 0
    if rows:
        RMS_NORM(xc.data_ptr(), wc.data_ptr(), y.data_ptr(), rows, d,
                 float(eps), int(bool(offset)), int(x.dtype == torch.float32),
                 int(weight.dtype == torch.float32),
                 torch.cuda.current_stream(x.device).cuda_stream)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last dim in f32
    (``w + 1`` when ``offset``), rounded to x's dtype. CUDA: one block
    per row, a fixed summation tree; CPU: the plain version."""
    if x.device.type == 'cuda':
        return _rms_norm_cuda(x, weight, eps, offset)
    if x.device.type != 'cpu':
        raise ValueError(f'rms_norm: unsupported device {x.device}')
    return _rms_norm_plain(x, weight, eps, offset)
