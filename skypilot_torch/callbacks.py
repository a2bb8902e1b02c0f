"""Benchmark step callbacks — a copy of ``skypilot_tpu/callbacks.py``
(stdlib only), the analog of the reference's separate
``sky_callback`` package (``sky/callbacks/sky_callback/__init__.py``).

``init/step_begin/step_end`` write per-step timing JSON consumed by
the benchmark harness (``skypilot_tpu/benchmark``), so ``x bench``
can compare $/step and time-to-K-steps across candidate slices.
"""
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_DEFAULT_LOG = 'skytpu_callback.json'

_state = threading.local()


class _Recorder:

    def __init__(self, log_dir: str, total_steps: Optional[int]):
        self.path = os.path.join(os.path.expanduser(log_dir),
                                 _DEFAULT_LOG)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.total_steps = total_steps
        self.begins: List[float] = []
        self.ends: List[float] = []
        self._flush_every = 10

    def step_begin(self) -> None:
        self.begins.append(time.time())

    def step_end(self) -> None:
        self.ends.append(time.time())
        if len(self.ends) % self._flush_every == 0 or \
                (self.total_steps is not None and
                 len(self.ends) >= self.total_steps):
            self.flush()

    def flush(self) -> None:
        payload: Dict[str, Any] = {
            'total_steps': self.total_steps,
            'num_steps': len(self.ends),
            'first_step_at': self.begins[0] if self.begins else None,
            'last_step_at': self.ends[-1] if self.ends else None,
            'avg_step_seconds':
                ((self.ends[-1] - self.begins[0]) / len(self.ends))
                if self.ends else None,
        }
        tmp = self.path + '.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)


def init(log_dir: str = '~/sky_benchmark_dir',
         total_steps: Optional[int] = None) -> None:
    _state.recorder = _Recorder(log_dir, total_steps)


def step_begin() -> None:
    if getattr(_state, 'recorder', None):
        _state.recorder.step_begin()


def step_end() -> None:
    if getattr(_state, 'recorder', None):
        _state.recorder.step_end()


class step:  # noqa: N801 — context-manager sugar, reference-style
    """with skytpu_callback.step(): train_one_step()"""

    def __enter__(self):
        step_begin()
        return self

    def __exit__(self, *exc):
        step_end()
        return False
