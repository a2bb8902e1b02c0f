"""Device resolution for the port's entry points.

Entry points default to ``device='cuda'``. Asking for CUDA where there
is none raises :class:`DeviceError`; nothing here falls back to the
CPU. Callers that want the CPU (the parity tests) pass ``'cpu'``.
"""
from typing import Union

import torch

DEFAULT_DEVICE = 'cuda'


class DeviceError(RuntimeError):
    """The requested device is not available in this process."""


def resolve_device(device: Union[str, torch.device, None] = None,
                   allow_meta: bool = False) -> torch.device:
    """``device`` (default ``'cuda'``) as a ``torch.device``; raises
    :class:`DeviceError` for CUDA when ``torch.cuda.is_available()``
    is false, and for any device type other than ``cuda``/``cpu`` (and
    ``meta``, shapes without storage, where ``allow_meta``)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if allow_meta and dev.type == 'meta':
        return dev
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise DeviceError(
                f'device {str(dev)!r} requested but CUDA is not '
                'available (torch.cuda.is_available() is False); pass '
                "device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        return dev
    if dev.type != 'cpu':
        raise DeviceError(f'unsupported device {str(dev)!r}: the port '
                          'runs on cuda (kernels) or cpu (plain path)')
    return dev


def generator(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None on
    ``meta``, which draws nothing."""
    if device.type == 'meta':
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
