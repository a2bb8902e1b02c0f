"""Step profiling on ``torch.profiler`` — the port of
``skypilot_tpu/utils/profiling.py``: capture a trace and summarize op
time, as a library AND as the on-demand runtime service.

Library usage::

    with capture_trace() as tmpdir:
        run_steps()                # synchronize inside the block
    for row in summarize_trace(tmpdir, top=20):
        print(row)

The capture records CPU and, where CUDA is available, CUDA activity and
writes a Chrome trace (``trace.json``) into the directory. The summary
aggregates its complete ('X') events per name: the device rows are the
kernels the card ran (category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``), named as the profiler names them (the demangled kernel
function); with no device rows — a CPU-only process — the host's
``cpu_op`` rows stand in.

Runtime service (docs/observability.md, On-demand profiling), with the
JAX package's file protocol: the host agent's ``POST /profile`` (or
:func:`write_trigger`) writes ``trigger.json`` under the shared profile
dir; instrumented loops (``parallel.train.instrument_train_step``, the
serve batching engine) poll for it through :class:`StepProfiler` and,
when armed, capture the next N steps and write the op-time summary
``latest.json`` beside the trigger in the JAX package's schema, so
``xsky profile`` reads it unchanged.
"""
import collections
import contextlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

TRACE_FILE = 'trace.json'
# Chrome-trace categories of work that ran on the card.
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATEGORY = 'cpu_op'


class OpTime(NamedTuple):
    name: str
    total_ms: float
    count: int
    category: str


def _start_profile():
    """A started ``torch.profiler`` capture: CPU activity, plus CUDA
    where the process has it."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, trace_dir: str) -> str:
    """Stop ``prof`` (after the card has finished the profiled work) and
    write its Chrome trace into ``trace_dir``; returns the file."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def capture_trace(trace_dir: Optional[str] = None) -> Iterator[str]:
    """Context manager: profile the enclosed work. Yields the directory
    the Chrome trace is written into when the block exits."""
    out = trace_dir or tempfile.mkdtemp(prefix='xsky_trace_')
    prof = _start_profile()
    try:
        yield out
    finally:
        _stop_profile(prof, out)


def summarize_trace(trace_dir: str, top: int = 25,
                    device_only: bool = True) -> List[OpTime]:
    """Aggregate the trace's complete ('X') events by name, descending
    total duration: the device rows with ``device_only``, else the host
    ``cpu_op`` rows."""
    path = os.path.join(trace_dir, TRACE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f'no {TRACE_FILE} under {trace_dir}')
    with open(path, encoding='utf-8') as f:
        events = json.load(f).get('traceEvents', [])
    cats = DEVICE_CATEGORIES if device_only else (HOST_CATEGORY,)
    agg = collections.defaultdict(lambda: [0.0, 0, ''])
    for ev in events:
        if ev.get('ph') != 'X' or ev.get('cat') not in cats:
            continue
        a = agg[ev['name']]
        a[0] += float(ev.get('dur', 0)) / 1e3  # us -> ms
        a[1] += 1
        a[2] = ev['cat']
    rows = [OpTime(name, ms, n, cat)
            for name, (ms, n, cat) in agg.items()]
    rows.sort(key=lambda r: -r.total_ms)
    return rows[:top]


def format_summary(rows: List[OpTime]) -> str:
    lines = [f'{"total ms":>10}  {"count":>6}  {"category":<22} name']
    for r in rows:
        lines.append(f'{r.total_ms:10.1f}  {r.count:6d}  '
                     f'{r.category:<22} {r.name}')
    return '\n'.join(lines)


# ---------------------------------------------------------------------
# On-demand runtime profiling service (the JAX package's protocol):
#   <profile_dir>/trigger.json   {"steps": N, "requested_at": ts}
#       written by the agent's POST /profile; CONSUMED (unlinked) by the
#       first instrumented loop that sees it.
#   <profile_dir>/latest.json    the most recent op-time summary
#       {"kind", "steps", "captured_at", "rows": [...]}, written
#       atomically.
# ---------------------------------------------------------------------

TRIGGER_FILE = 'trigger.json'
LATEST_SUMMARY = 'latest.json'
DEFAULT_PROFILE_STEPS = 5
# How often an instrumented loop stats the trigger file (time-based:
# a fast decode dispatch must not stat many times a second).
TRIGGER_CHECK_SECONDS = 1.0
# Rows kept in a summary: every kernel of a train step, whatever its rank.
SUMMARY_ROWS = 256


def profile_dir(base: Optional[str] = None) -> str:
    """The profile exchange directory shared by the host agent and the
    instrumented loops on one host: ``SKYTPU_PROFILE_DIR``, else
    ``$SKYTPU_RUNTIME_DIR/profiles``, else ``$SKYTPU_STATE_DIR/profiles``
    (the JAX package's resolution order)."""
    if base:
        return os.path.expanduser(base)
    override = os.environ.get('SKYTPU_PROFILE_DIR')
    if override:
        return os.path.expanduser(override)
    runtime_dir = os.environ.get('SKYTPU_RUNTIME_DIR')
    if runtime_dir:
        return os.path.join(os.path.expanduser(runtime_dir),
                            'profiles')
    state_dir = os.path.expanduser(
        os.environ.get('SKYTPU_STATE_DIR', '~/.skypilot_tpu'))
    return os.path.join(state_dir, 'profiles')


def write_trigger(directory: Optional[str] = None,
                  steps: int = DEFAULT_PROFILE_STEPS) -> str:
    """Arm a capture: write the trigger file (what the agent's POST
    /profile does). Returns the trigger path."""
    directory = profile_dir(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TRIGGER_FILE)
    tmp = path + '.tmp'
    with open(tmp, 'w', encoding='utf-8') as f:
        json.dump({'steps': int(steps), 'requested_at': time.time()},
                  f)
    os.replace(tmp, path)
    return path


def consume_trigger(directory: Optional[str] = None) -> Optional[int]:
    """If a trigger is armed, consume it (unlink) and return the
    requested step count; else None. Unlink-first, so two loops in one
    process cannot both arm off one trigger; a torn trigger is dropped,
    not retried."""
    directory = profile_dir(directory)
    path = os.path.join(directory, TRIGGER_FILE)
    try:
        with open(path, encoding='utf-8') as f:
            payload = json.load(f)
    except OSError:
        return None
    except ValueError:
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    try:
        os.unlink(path)
    except OSError:
        return None
    try:
        steps = int(payload.get('steps') or DEFAULT_PROFILE_STEPS)
    except (TypeError, ValueError):
        steps = DEFAULT_PROFILE_STEPS
    return max(1, steps)


def write_summary(rows: List[OpTime], kind: str, steps: int,
                  directory: Optional[str] = None) -> str:
    """Persist an op-time summary as the host's ``latest.json`` (atomic
    write-then-rename)."""
    directory = profile_dir(directory)
    os.makedirs(directory, exist_ok=True)
    payload = {
        'kind': kind,
        'steps': steps,
        'captured_at': time.time(),
        'rows': [{'name': r.name, 'total_ms': r.total_ms,
                  'count': r.count, 'category': r.category}
                 for r in rows],
    }
    path = os.path.join(directory, LATEST_SUMMARY)
    tmp = path + f'.{os.getpid()}.tmp'
    with open(tmp, 'w', encoding='utf-8') as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def load_summary(directory: Optional[str] = None
                 ) -> Optional[Dict[str, Any]]:
    path = os.path.join(profile_dir(directory), LATEST_SUMMARY)
    try:
        with open(path, encoding='utf-8') as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class StepProfiler:
    """Per-loop hook for the on-demand profiling service.

    Call :meth:`on_step` once per train step / decode dispatch, before
    its work. The hook stats the trigger file at most once per
    ``TRIGGER_CHECK_SECONDS``; when armed it starts a ``torch.profiler``
    capture, lets the next N steps run, then stops it at the (N+1)-th
    call, summarizes and writes ``latest.json``. Every failure degrades
    to "not profiling" (a profiler that cannot start, e.g. inside
    another capture) or to host rows (no device rows) — a broken
    profiler must never take down the loop it watches.
    """

    def __init__(self, kind: str, directory: Optional[str] = None):
        self.kind = kind
        self._dir = directory
        self._next_check = 0.0
        self._armed_steps = 0
        self._requested_steps = 0
        self._prof = None
        self._trace_dir: Optional[str] = None

    def on_step(self) -> None:
        if self._prof is not None:
            self._armed_steps -= 1
            if self._armed_steps <= 0:
                self._finish()
            return
        now = time.monotonic()
        if now < self._next_check:
            return
        self._next_check = now + TRIGGER_CHECK_SECONDS
        steps = consume_trigger(self._dir)
        if steps is None:
            return
        try:
            self._trace_dir = tempfile.mkdtemp(
                prefix=f'xsky_profile_{self.kind}_')
            self._prof = _start_profile()
            self._armed_steps = steps
            self._requested_steps = steps
        except Exception:  # pylint: disable=broad-except
            self._prof = None
            if self._trace_dir is not None:
                shutil.rmtree(self._trace_dir, ignore_errors=True)
                self._trace_dir = None

    def _finish(self) -> None:
        prof, self._prof = self._prof, None
        trace_dir, self._trace_dir = self._trace_dir, None
        rows: List[OpTime] = []
        try:
            _stop_profile(prof, trace_dir)
            rows = summarize_trace(trace_dir, top=SUMMARY_ROWS)
            if not rows:
                # No card (CPU process): the host's op rows.
                rows = summarize_trace(trace_dir, top=SUMMARY_ROWS,
                                       device_only=False)
        except Exception:  # pylint: disable=broad-except
            pass
        try:
            write_summary(rows, self.kind, self._requested_steps,
                          self._dir)
        except OSError:
            pass
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
            self._armed_steps = 0
