"""Device memory telemetry — the port of
``skypilot_tpu/metrics/device.py`` on ``torch.cuda``.

Samples every visible card's memory into the JAX package's per-device
gauges, so "how full is the card" is a scrapeable series under the
same names:

    skytpu_device_hbm_used_bytes{device}    allocated_bytes.all.current
    skytpu_device_hbm_limit_bytes{device}   mem_get_info(device)[1]
    skytpu_device_hbm_peak_bytes{device}    allocated_bytes.all.peak

"used" is what PyTorch's caching allocator has handed out to tensors
(``torch.cuda.memory_allocated``), not the larger reserved pool it holds
from CUDA (``memory_reserved``); "peak" is that allocated figure's
high-water mark (``max_memory_allocated``, reset by
``reset_peak_memory_stats``); "limit" is the card's total memory as CUDA
reports it.

Graceful no-op where there is no CUDA — the gauges are simply absent,
never zeros that look like an empty card. A card this process has never
allocated on is skipped, so sampling never creates a CUDA context there.
The series reach the host agent's ``/metrics`` through the textfile
bridge (``metrics/publish.py``), labeled with the process's ``proc`` id.
"""
from typing import Any, Dict, List, Optional


def _hbm_gauges(reg) -> Dict[str, Any]:
    """stats key -> gauge family (the JAX package's literal names)."""
    return {
        'bytes_in_use': reg.gauge(
            'skytpu_device_hbm_used_bytes',
            'Device memory currently allocated.',
            labelnames=('device',)),
        'bytes_limit': reg.gauge(
            'skytpu_device_hbm_limit_bytes',
            'Device memory capacity available to the process.',
            labelnames=('device',)),
        'peak_bytes_in_use': reg.gauge(
            'skytpu_device_hbm_peak_bytes',
            'High-water mark of device memory allocated.',
            labelnames=('device',)),
    }


class CudaDevice:
    """One card as a stats source: ``memory_stats()`` in the JAX
    device's key names, read from ``torch.cuda``."""

    def __init__(self, index: int):
        self.index = index

    def memory_stats(self) -> Optional[Dict[str, int]]:
        import torch
        stats = torch.cuda.memory_stats(self.index)
        if not stats.get('reserved_bytes.all.peak'):
            return None          # never allocated on: no context here
        return {
            'bytes_in_use': stats['allocated_bytes.all.current'],
            'peak_bytes_in_use': stats['allocated_bytes.all.peak'],
            'bytes_limit': torch.cuda.mem_get_info(self.index)[1],
        }


def cuda_devices() -> List[CudaDevice]:
    """Every visible card as a stats source ([] without CUDA)."""
    try:
        import torch
        if not torch.cuda.is_available():
            return []
        return [CudaDevice(i) for i in range(torch.cuda.device_count())]
    except Exception:  # pylint: disable=broad-except
        return []


def sample_device_memory(devices: Optional[List[Any]] = None,
                         registry=None) -> List[Dict[str, Any]]:
    """Read every card's memory stats into the registry gauges.
    Returns the raw per-device dicts (``{'device': i, 'bytes_in_use':
    ..., ...}``). ``devices`` is injectable for tests (objects with a
    ``memory_stats()`` method returning the JAX key names, or None);
    default is :func:`cuda_devices` — no CUDA, a card without stats or
    a failing read all degrade to "no samples", never an exception in a
    metrics path."""
    from skypilot_torch import metrics as metrics_lib
    reg = registry or metrics_lib.registry()
    if devices is None:
        devices = cuda_devices()
    gauges = _hbm_gauges(reg)
    out: List[Dict[str, Any]] = []
    for idx, dev in enumerate(devices):
        try:
            stats = dev.memory_stats()
        except Exception:  # pylint: disable=broad-except
            stats = None
        if not stats:
            continue
        row: Dict[str, Any] = {'device': idx}
        for key, family in gauges.items():
            value = stats.get(key)
            if value is None:
                continue
            family.labels(device=str(idx)).set(float(value))
            row[key] = int(value)
        if len(row) > 1:
            out.append(row)
    return out
