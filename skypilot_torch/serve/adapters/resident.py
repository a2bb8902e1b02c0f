"""Device-resident adapter set: the LRU the batched engine gathers
from — the port of ``skypilot_tpu/serve/adapters/resident.py`` (same
API and policy; the buffers are torch tensors on the engine's device).

Adapters live stacked in four device buffers shaped
``[L, capacity+1, ...]`` (A factors ``[L, C+1, d, R]``, B factors
``[L, C+1, R, out]``), so the decode/prefill/verify device steps can
gather each batch row's A/B matrices by integer slot index — one
forward serves many adapters. Slot 0 is reserved and all-zeros: a
row with no adapter gathers the zero factors and its delta is
EXACTLY zero (no branch in the step's math, no numeric drift for
base-model rows). Adapters with rank below the bucket ``R`` are
zero-padded — padded columns of A contribute zero to ``h @ A`` and
padded rows of B multiply those zeros, so padding is exact, not
approximate.

Residency policy: LRU over refcount-0 adapters only. A pin
(taken at request admission, dropped when the row is released) makes
an adapter ineligible for eviction — an in-flight request's adapter
can NEVER be evicted from under it. Cold loads are asynchronous:
``ensure_loading`` kicks a host-side checkpoint read on a daemon
thread, the engine loop polls ``poll`` each iteration, and uploads
land in a free (or LRU-evicted) slot — the waiting request is
admitted on the iteration the weights arrive, while unrelated
traffic keeps decoding.

Thread-safety: all mutating entry points take the internal lock; the
device buffers themselves are only written from the engine loop
thread (via ``poll``; ``preload`` runs before the loop starts), so a dispatch never races an
upload.

Where the JAX set rebuilds the buffer dict on every install
(``.at[:, slot].set``), the port writes the rank-padded factors into
their slot IN PLACE, on the calling thread's current stream — the
engine loop's, between two dispatches, so the copy is ordered after
every dispatch already issued and before every later one, and no side
stream or event is needed. In place is safe: a claimed slot is free or
belongs to an evicted adapter whose refcount was 0, so no admitted row
gathers it. The buffers therefore keep their addresses for the
engine's life, which a captured decode step can rely on.
``load_times`` keeps each adapter's last cold load split into the host
read (on the loader thread) and the upload (the install on the engine
loop), in seconds.
"""
import collections
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_torch import device as device_lib
from skypilot_torch import exceptions

logger = logging.getLogger(__name__)


def _pad_rank(arr: np.ndarray, axis: int, bucket: int) -> np.ndarray:
    """Zero-pad the rank axis to the bucket width (exactness note in
    the module docstring)."""
    if arr.shape[axis] == bucket:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, bucket - arr.shape[axis])
    return np.pad(arr, pad)


class ResidentAdapterSet:
    """LRU of device-loaded adapters with refcount pinning.

    ``shapes``: ``(num_layers, d_model, q_out, v_out)`` of the base
    model; ``rank_bucket`` sizes the shared rank axis (adapters with
    larger rank are refused with ``AdapterCapacityError`` — the
    buffers are allocated once); ``device``: where the buffers live
    (default: cuda; raises without it).
    """

    def __init__(self, registry, capacity: int,
                 shapes: Tuple[int, int, int, int],
                 rank_bucket: int = 16, device=None):
        if capacity < 1:
            raise ValueError('adapter capacity must be >= 1')
        self.registry = registry
        self.capacity = int(capacity)
        self.rank_bucket = int(rank_bucket)
        num_layers, d_model, q_out, v_out = shapes
        c1 = self.capacity + 1
        dev = device_lib.resolve_device(device)
        self._buffers = {
            name: torch.zeros(shape, dtype=torch.float32, device=dev)
            for name, shape in (
                ('wq_a', (num_layers, c1, d_model, rank_bucket)),
                ('wq_b', (num_layers, c1, rank_bucket, q_out)),
                ('wv_a', (num_layers, c1, d_model, rank_bucket)),
                ('wv_b', (num_layers, c1, rank_bucket, v_out)))}
        self._lock = threading.Lock()
        self._slot_of: Dict[str, int] = {}
        self._slot_ids: List[Optional[str]] = [None] * c1
        self._pins: Dict[str, int] = {}
        # Refcount-0 residents in eviction order (head = coldest).
        self._lru: 'collections.OrderedDict[str, None]' = \
            collections.OrderedDict()
        # Cold loads: id -> monotonic start while the host read runs;
        # completed reads park in _loaded until a slot frees up.
        self._loading: Dict[str, float] = {}
        self._loaded: Dict[str, Dict[str, np.ndarray]] = {}
        self._load_started: Dict[str, float] = {}
        self._failed: Dict[str, BaseException] = {}
        self._read_s: Dict[str, float] = {}
        self.load_times: Dict[str, Dict[str, float]] = {}

    # -- queries --------------------------------------------------------

    def slot(self, adapter_id: Optional[str]) -> Optional[int]:
        """Device slot of a resident adapter (0 for None == the
        zero-delta identity slot); None when not resident."""
        if adapter_id is None:
            return 0
        with self._lock:
            return self._slot_of.get(adapter_id)

    def resident_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._slot_of)

    def resident_count(self) -> int:
        with self._lock:
            return len(self._slot_of)

    def buffers(self) -> Dict[str, torch.Tensor]:
        """The stacked device factors, for the device steps: the same
        four tensors for the set's life, written in place on install
        (module docstring)."""
        return self._buffers

    def check_fits(self, adapter_id: str) -> None:
        """Typed refusal for adapters this engine can NEVER serve
        (rank over the bucket). Resolves the spec, so unknown ids
        raise ``AdapterNotFoundError`` here too."""
        spec = self.registry.spec(adapter_id)
        if spec.rank > self.rank_bucket:
            raise exceptions.AdapterCapacityError(
                f'adapter {adapter_id!r} has rank {spec.rank}, over '
                f'this engine\'s rank bucket {self.rank_bucket} '
                '(set engine adapters.rank_bucket at least as large '
                'as the largest served adapter)')

    # -- pinning --------------------------------------------------------

    def pin(self, adapter_id: str) -> int:
        """Refcount-pin a RESIDENT adapter (admission time). Returns
        its slot; pinned adapters are never evicted."""
        with self._lock:
            slot = self._slot_of[adapter_id]
            self._pins[adapter_id] = \
                self._pins.get(adapter_id, 0) + 1
            self._lru.pop(adapter_id, None)
            return slot

    def unpin(self, adapter_id: str) -> None:
        """Drop one pin (row release). The last unpin moves the
        adapter to the warm end of the LRU — still resident, now
        evictable."""
        with self._lock:
            count = self._pins.get(adapter_id, 0) - 1
            if count > 0:
                self._pins[adapter_id] = count
                return
            self._pins.pop(adapter_id, None)
            if adapter_id in self._slot_of:
                self._lru[adapter_id] = None
                self._lru.move_to_end(adapter_id)

    # -- cold loads -----------------------------------------------------

    def ensure_loading(self, adapter_id: str) -> None:
        """Start the async host-side checkpoint read unless the
        adapter is already resident, loading, or parked loaded."""
        with self._lock:
            if adapter_id in self._slot_of or \
                    adapter_id in self._loading or \
                    adapter_id in self._loaded:
                return
            self._failed.pop(adapter_id, None)
            self._loading[adapter_id] = time.monotonic()

        def run():
            t0 = time.monotonic()
            try:
                host = self.registry.load_host(adapter_id)
            except BaseException as e:  # pylint: disable=broad-except
                with self._lock:
                    self._load_started[adapter_id] = \
                        self._loading.pop(adapter_id, 0.0)
                    self._failed[adapter_id] = e
                return
            with self._lock:
                self._load_started[adapter_id] = \
                    self._loading.pop(adapter_id, 0.0)
                self._read_s[adapter_id] = time.monotonic() - t0
                self._loaded[adapter_id] = host

        threading.Thread(target=run, daemon=True,
                         name=f'adapter-load-{adapter_id}').start()

    def take_failure(self, adapter_id: str) -> Optional[BaseException]:
        """Pop-and-return a failed cold load's exception (the engine
        fails the waiting requests with it)."""
        with self._lock:
            return self._failed.pop(adapter_id, None)

    def poll(self) -> Tuple[List[str], List[str], List[float]]:
        """Engine-loop tick: install completed host loads into
        device slots. Returns ``(now_resident_ids, evicted_ids,
        load_seconds)``. A load with no installable slot (every
        resident adapter pinned) stays parked and retries next tick
        — transient pressure, never an error."""
        with self._lock:
            pending = list(self._loaded.items())
        ready, evicted, durations = [], [], []
        for adapter_id, host in pending:
            slot, victim = self._claim_slot()
            if slot is None:
                break  # all slots pinned; retry next tick
            if victim is not None:
                evicted.append(victim)
            self._install(adapter_id, slot, host)
            ready.append(adapter_id)
            with self._lock:
                self._loaded.pop(adapter_id, None)
                started = self._load_started.pop(adapter_id, None)
            if started:
                durations.append(time.monotonic() - started)
        return ready, evicted, durations

    def preload(self, adapter_ids) -> None:
        """Synchronous load+install (engine startup, before serving).
        Raises on anything unusable — a preload list names adapters
        the operator expects to serve."""
        for adapter_id in adapter_ids:
            self.check_fits(adapter_id)
            if self.slot(adapter_id) is not None:
                continue
            t0 = time.monotonic()
            host = self.registry.load_host(adapter_id)
            with self._lock:
                self._read_s[adapter_id] = time.monotonic() - t0
            slot, victim = self._claim_slot()
            if slot is None:
                raise exceptions.AdapterCapacityError(
                    f'preload list exceeds adapter capacity '
                    f'{self.capacity}')
            if victim is not None:
                logger.info('adapter %s evicted for preload of %s',
                            victim, adapter_id)
            self._install(adapter_id, slot, host)

    # -- internals ------------------------------------------------------

    def _claim_slot(self) -> Tuple[Optional[int], Optional[str]]:
        """A free slot, else the coldest refcount-0 resident's slot
        (returned as ``(slot, evicted_id)``); ``(None, None)`` when
        everything is pinned."""
        with self._lock:
            for i in range(1, self.capacity + 1):
                if self._slot_ids[i] is None:
                    return i, None
            if not self._lru:
                return None, None
            victim, _ = self._lru.popitem(last=False)
            slot = self._slot_of.pop(victim)
            self._slot_ids[slot] = None
            return slot, victim

    def _install(self, adapter_id: str, slot: int,
                 host: Dict[str, np.ndarray]) -> None:
        """Write the rank-padded factors into ``slot`` in place, on the
        calling thread's current stream (module docstring)."""
        t0 = time.monotonic()
        bucket = self.rank_bucket
        padded = {
            'wq_a': _pad_rank(host['wq_a'], 2, bucket),
            'wq_b': _pad_rank(host['wq_b'], 1, bucket),
            'wv_a': _pad_rank(host['wv_a'], 2, bucket),
            'wv_b': _pad_rank(host['wv_b'], 1, bucket),
        }
        for name, buf in self._buffers.items():
            buf[:, slot].copy_(torch.from_numpy(
                np.require(padded[name], np.float32, ['C', 'W'])))
        with self._lock:
            self.load_times[adapter_id] = dict(
                read_s=self._read_s.pop(adapter_id, None),
                upload_s=time.monotonic() - t0)
            self._slot_of[adapter_id] = slot
            self._slot_ids[slot] = adapter_id
            self._lru[adapter_id] = None
            self._lru.move_to_end(adapter_id)
