"""Textfile metrics bridge: process registry -> host agent /metrics — a
copy of ``skypilot_tpu/metrics/publish.py`` (stdlib only) whose
``start_publisher`` pre-wires the port's card-memory sampler.

The compute processes that own the interesting series (train loops:
goodput/MFU/step time; serve replicas: batching + KV-cache gauges;
anything sampling device HBM) are NOT the host agent — yet the
agent's ``GET /metrics`` is the one scrape surface the orchestration-side
aggregator pulls. This module is the node_exporter-textfile-collector
analog that connects them:

- the compute process runs a :class:`MetricsPublisher` that
  periodically renders its registry (every sample stamped with a
  ``proc="<component>-<pid>"`` label so two processes exporting the
  same family stay distinct series) to
  ``<textfile_dir>/<component>-<pid>.prom`` (atomic
  write-then-rename);
- both host agents append fresh ``*.prom`` files from that directory
  to their ``/metrics`` response, deduplicating ``# HELP``/``# TYPE``
  header lines by family name (the samples themselves are disjoint
  thanks to the proc label);
- files older than ``STALE_SECONDS`` are skipped (and swept): a
  crashed process must stop exporting, not freeze its last gauges
  into dashboards forever.

Directory resolution (mirrored by the JAX package's runtime/agent.py
and host_agent.cc — keep in sync): ``SKYTPU_METRICS_DIR`` env override,
else ``$SKYTPU_RUNTIME_DIR/metrics.d`` (agent-spawned processes
share the agent's runtime dir), else ``$SKYTPU_STATE_DIR/metrics.d``.
"""
import glob
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from skypilot_torch.metrics import exposition

TEXTFILE_SUBDIR = 'metrics.d'
# A publisher ticks every PUBLISH_INTERVAL; anything not refreshed
# within the staleness threshold is a dead process's leftovers.
PUBLISH_INTERVAL_SECONDS = 10.0
STALE_SECONDS = 120.0


def stale_seconds() -> float:
    """Textfile staleness threshold. ``SKYTPU_METRICS_TEXTFILE_
    MAX_AGE`` overrides the 120 s default (both host agents honor
    the same variable) — slow publishers (a train loop blocked in a
    long compile) can be granted a longer leash without recompiling
    anything."""
    try:
        return float(os.environ.get('SKYTPU_METRICS_TEXTFILE_MAX_AGE',
                                    STALE_SECONDS))
    except (TypeError, ValueError):
        return STALE_SECONDS


def textfile_dir(base: Optional[str] = None) -> str:
    if base:
        return os.path.expanduser(base)
    override = os.environ.get('SKYTPU_METRICS_DIR')
    if override:
        return os.path.expanduser(override)
    runtime_dir = os.environ.get('SKYTPU_RUNTIME_DIR')
    if runtime_dir:
        return os.path.join(os.path.expanduser(runtime_dir),
                            TEXTFILE_SUBDIR)
    state_dir = os.path.expanduser(
        os.environ.get('SKYTPU_STATE_DIR', '~/.skypilot_tpu'))
    return os.path.join(state_dir, TEXTFILE_SUBDIR)


def render_labeled(registry,
                   extra_labels: Sequence[Tuple[str, str]]) -> str:
    """Prometheus text of ``registry`` with ``extra_labels`` injected
    into every sample (before the family's own labels, matching the
    scraper's host-label convention). One renderer: this is
    ``exposition.render_text`` with its label-injection parameter."""
    return exposition.render_text(
        registry, extra_labels=tuple(extra_labels))


def read_textfiles(directory: Optional[str] = None,
                   stale_after: Optional[float] = None,
                   now: Optional[float] = None) -> str:
    """Concatenate fresh ``*.prom`` files for an agent's /metrics
    response, dropping duplicate ``# HELP``/``# TYPE`` lines (two
    publishers sharing a family keep one header; their samples are
    disjoint via the proc label). Stale files are skipped AND
    unlinked — the publisher removes its file on clean close, this
    sweeps crashes."""
    directory = textfile_dir(directory)
    now = time.time() if now is None else now
    if stale_after is None:
        stale_after = stale_seconds()
    lines: List[str] = []
    seen_headers: set = set()
    for path in sorted(glob.glob(os.path.join(directory, '*.prom'))):
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        if now - mtime > stale_after:
            try:
                os.unlink(path)
            except OSError:
                pass
            continue
        try:
            with open(path, encoding='utf-8') as f:
                text = f.read()
        except OSError:
            continue
        for line in text.splitlines():
            if line.startswith('#'):
                parts = line.split(None, 3)
                if len(parts) >= 3 and parts[1] in ('HELP', 'TYPE'):
                    key = (parts[1], parts[2])
                    if key in seen_headers:
                        continue
                    seen_headers.add(key)
            if line:
                lines.append(line)
    return '\n'.join(lines) + ('\n' if lines else '')


class MetricsPublisher:
    """Publishes this process's registry to the host textfile dir.

    ``collectors`` run before each render (e.g. the device-memory
    sampler) so point-in-time gauges are fresh at publish, mirroring
    the agent's own sample-at-scrape discipline.
    """

    def __init__(self, component: str,
                 directory: Optional[str] = None,
                 interval: float = PUBLISH_INTERVAL_SECONDS,
                 registry=None,
                 collectors: Sequence[Callable[[], None]] = ()):
        from skypilot_torch import metrics as metrics_lib
        self.component = component
        self._dir = textfile_dir(directory)
        self._interval = interval
        self._registry = registry or metrics_lib.registry()
        self._collectors = list(collectors)
        self._proc_id = f'{component}-{os.getpid()}'
        self._path = os.path.join(self._dir,
                                  f'{self._proc_id}.prom')
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def path(self) -> str:
        return self._path

    def publish_once(self) -> str:
        """One render+write (also the test seam). Atomic
        write-then-rename so an agent scrape mid-publish reads the
        previous complete file."""
        for collector in self._collectors:
            try:
                collector()
            except Exception:  # pylint: disable=broad-except
                pass
        text = render_labeled(self._registry,
                              (('proc', self._proc_id),))
        os.makedirs(self._dir, exist_ok=True)
        tmp = self._path + '.tmp'
        with open(tmp, 'w', encoding='utf-8') as f:
            f.write(text)
        os.replace(tmp, self._path)
        return self._path

    def start(self) -> 'MetricsPublisher':
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f'metrics-publisher-{self.component}')
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.publish_once()
            except Exception:  # pylint: disable=broad-except
                pass
            self._stop.wait(self._interval)

    def close(self) -> None:
        """Stop publishing and remove the file — a cleanly exiting
        process stops exporting immediately instead of waiting out
        the staleness TTL."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            os.unlink(self._path)
        except OSError:
            pass


def start_publisher(component: str,
                    directory: Optional[str] = None,
                    interval: float = PUBLISH_INTERVAL_SECONDS,
                    extra_collectors: Sequence[Callable[[], None]] = ()
                    ) -> MetricsPublisher:
    """Convenience used by the recipes: publisher with the
    device-memory sampler pre-wired (every tick refreshes the HBM
    gauges, then publishes)."""
    from skypilot_torch.metrics import device as device_lib
    collectors: List[Callable[[], None]] = [
        lambda: device_lib.sample_device_memory()]
    collectors.extend(extra_collectors)
    pub = MetricsPublisher(component, directory=directory,
                           interval=interval, collectors=collectors)
    try:
        pub.publish_once()
    except OSError:
        # Unwritable textfile dir must degrade to "unpublished", not
        # crash a replica/train process at boot; the background loop
        # keeps retrying (the dir may appear later).
        pass
    return pub.start()
