"""The nucleus threshold of sampled rows (``top_p_kth``), with a row's
bits independent of the other rows of the call.

CUDA tensors launch ``csrc/top_p.cu`` (a cluster of ``TOP_P_CLUSTER``
blocks a row, every sum in an order set by the vocabulary size through
``top_p_plan``); CPU tensors take the plain version, the JAX package's
filter as ``serve/sampling/sample.py`` has always written it.
"""
import ctypes
from typing import Tuple

import torch

from skypilot_torch.ops import _build

TOP_P_KTH = _build.Kernel('top_p', 'skypilot_top_p_kth',
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 +
                          [ctypes.c_void_p])
# Blocks of a row's cluster (the kernel's kC: the portable cluster size),
# the logits a thread takes (its kL), and the most threads a block has.
TOP_P_CLUSTER = 8
TOP_P_PER_THREAD = 36
TOP_P_MAX_THREADS = 1024


def top_p_plan(v: int) -> Tuple[int, int, int]:
    """(cluster C, logits a block P, threads a block NT) of a row of ``v``
    logits: block r of the cluster takes [r P, (r + 1) P) of [0, v),
    thread t of it [t L, (t + 1) L) of that slice (L =
    ``TOP_P_PER_THREAD``), and every sum's order follows from these, so
    from v alone."""
    if v < 1:
        raise ValueError(f'top_p_kth: a row of {v} logits')
    c, per = TOP_P_CLUSTER, TOP_P_PER_THREAD
    per_cta = -(-v // c)
    threads = 32 * -(-per_cta // (32 * per))
    if threads > TOP_P_MAX_THREADS:
        raise ValueError(f'top_p_kth: a row of {v} logits needs '
                         f'{threads} threads a block (at most '
                         f'{TOP_P_MAX_THREADS})')
    return c, per_cta, threads


def _top_p_kth_plain(sorted_desc: torch.Tensor,
                     top_p: torch.Tensor) -> torch.Tensor:
    # jax.nn.softmax: exp(x - max) over its sum.
    e = torch.exp(sorted_desc - sorted_desc[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    # Outside the nucleus: the mass before the token already reached
    # top_p.
    outside = (cum - probs) >= top_p[:, None]
    return torch.where(outside, float('inf'), sorted_desc).amin(
        dim=-1, keepdim=True)


def _top_p_kth_cuda(sorted_desc: torch.Tensor,
                    top_p: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; raises on anything it does not take."""
    if (sorted_desc.dtype != torch.float32 or top_p.dtype != torch.float32
            or sorted_desc.dim() != 2 or top_p.shape != sorted_desc.shape[:1]
            or top_p.device != sorted_desc.device):
        raise TypeError('top_p_kth: f32 [N, V] and f32 [N] on one device '
                        f'expected, got {sorted_desc.dtype} '
                        f'{tuple(sorted_desc.shape)}, {top_p.dtype} '
                        f'{tuple(top_p.shape)}')
    rows, v = sorted_desc.shape
    if rows > 65535:
        raise ValueError(f'top_p_kth: {rows} rows (the grid takes at most '
                         '65535)')
    x = sorted_desc.contiguous()
    p = top_p.contiguous()
    kth = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    _, per_cta, threads = top_p_plan(v)
    if rows:
        TOP_P_KTH(x.data_ptr(), p.data_ptr(), kth.data_ptr(), rows, v,
                  per_cta, threads,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return kth


def top_p_kth(sorted_desc: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """The smallest logit kept by each row's nucleus: ``sorted_desc``
    [N, V] f32 (each row descending), ``top_p`` [N] f32 (clamped above
    0). Returns [N, 1] f32: the least ``sorted_desc[i]`` whose preceding
    probability mass is still below top_p."""
    if sorted_desc.device.type == 'cuda':
        return _top_p_kth_cuda(sorted_desc, top_p)
    if sorted_desc.device.type != 'cpu':
        raise ValueError(f'top_p_kth: unsupported device {sorted_desc.device}')
    return _top_p_kth_plain(sorted_desc, top_p)
