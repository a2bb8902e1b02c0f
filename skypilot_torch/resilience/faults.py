"""Deterministic fault injection — a copy of
``skypilot_tpu/resilience/faults.py`` (stdlib only, ``logging`` in place
of ``tpu_logging``, the port's metrics registry), so the port's
``checkpoint.save`` site honours the same ``SKYTPU_FAULTS`` grammar and
the same ``$SKYTPU_STATE_DIR/chaos.conf`` that ``xsky chaos arm`` writes
without importing the JAX package. Of the sites below the port fires
only ``checkpoint.save``; the list stays whole so a spec armed for the
whole managed-job recursion parses here too. Only what that site needs
is copied: parsing, the env and chaos-file sources, ``arm``, ``fire``
and ``reset`` (the original's disarm / clear / armed / fired-count /
reseed helpers serve its CLI and drills). The text below is the
original's, its wording trimmed in places.


Named sites in the codebase call :func:`fire` on their hot path; a
fault armed for that site converts the call into an error, a timeout,
or a preemption with a configured probability. The RNG is seeded, so
a given (seed, call sequence) always injects the same faults — chaos
drills and recovery tests are REPRODUCIBLE, not merely random.

Sites (one per recovery path the paper cares about):

    agent.run         client→agent /run RPC
    agent.health      client→agent /health RPC
    provision.launch  managed-job cluster (re)launch
    serve.probe       replica readiness probe
    jobs.poll         managed-job status poll
    checkpoint.save   native checkpoint write→commit window (a
                      ``preempt`` tears the write between the shard
                      files and the commit rename)
    lifecycle.kill    the kill ladder's SIGTERM rung (lifecycle/
                      terminate.py) — an armed fault suppresses the
                      SIGTERM, simulating a SIGTERM-ignoring hung
                      daemon so the SIGKILL escalation is drilled
    recovery.resize   the NEXT_BEST_SHAPE elastic step-down (jobs/
                      recovery_strategy.py): any injected kind fails
                      the CURRENT downsized-shape attempt, driving
                      the strategy to the next smaller shape
    serve.stall       the batching-engine loop iteration (serve/
                      batching.py): any injected kind sleeps the
                      loop for SKYTPU_SERVE_STALL_SECONDS before it
                      runs — a slow-decode brownout that drills
                      deadline enforcement and load shedding
                      without killing the engine

Activation:
  - programmatically: ``faults.arm('agent.health', 'error', 0.3)``
    (tests use the ``faults`` pytest fixture, which resets around
    each test);
  - environment: ``SKYTPU_FAULTS=site:kind:rate[:count][,...]``
    (inherited by controller subprocesses — the way to arm a whole
    managed-job recursion);
  - live drills: ``xsky chaos arm SPEC`` writes
    ``$SKYTPU_STATE_DIR/chaos.conf``, picked up by processes
    that start after arming (same grammar; see docs/resilience.md).

Injections are counted in the ``skytpu_fault_injections_total``
metric (site, kind labels) so a drill's blast radius is observable.
"""
import dataclasses
import logging
import os
import random
import threading
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

SITES = ('agent.run', 'agent.health', 'provision.launch',
         'serve.probe', 'jobs.poll', 'checkpoint.save',
         'lifecycle.kill', 'recovery.resize', 'serve.stall')
KINDS = ('error', 'timeout', 'preempt')

ENV_VAR = 'SKYTPU_FAULTS'
CHAOS_FILE_NAME = 'chaos.conf'


@dataclasses.dataclass
class FaultSpec:
    site: str
    kind: str
    rate: float
    count: Optional[int] = None  # None = unlimited

    def render(self) -> str:
        out = f'{self.site}:{self.kind}:{self.rate:g}'
        if self.count is not None:
            out += f':{self.count}'
        return out


def chaos_file_path() -> str:
    base = os.path.expanduser(
        os.environ.get('SKYTPU_STATE_DIR', '~/.skypilot_tpu'))
    return os.path.join(base, CHAOS_FILE_NAME)


def parse_specs(text: str) -> List[FaultSpec]:
    """Parse the ``site:kind:rate[:count]`` grammar (comma- or
    newline-separated). Raises ``ValueError`` on malformed input —
    a typo'd chaos drill must fail loudly, not silently no-op."""
    specs = []
    for chunk in text.replace('\n', ',').split(','):
        chunk = chunk.strip()
        if not chunk or chunk.startswith('#'):
            continue
        parts = chunk.split(':')
        if len(parts) not in (3, 4):
            raise ValueError(
                f'bad fault spec {chunk!r}: want '
                f'site:kind:rate[:count]')
        site, kind, rate_s = parts[0], parts[1], parts[2]
        if site not in SITES:
            raise ValueError(f'unknown fault site {site!r}; choose '
                             f'from {SITES}')
        if kind not in KINDS:
            raise ValueError(f'unknown fault kind {kind!r}; choose '
                             f'from {KINDS}')
        try:
            rate = float(rate_s)
        except ValueError as e:
            raise ValueError(f'bad rate in {chunk!r}') from e
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f'rate must be in [0,1], got {rate}')
        count = None
        if len(parts) == 4:
            count = int(parts[3])
            if count < 1:
                raise ValueError(f'count must be >= 1 in {chunk!r}')
        specs.append(FaultSpec(site, kind, rate, count))
    return specs


class FaultRegistry:
    """Armed faults + seeded RNG."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._specs: Dict[str, FaultSpec] = {}
        self._rng = random.Random(seed)
        self._external_loaded = False

    # -- arming ---------------------------------------------------------

    def arm(self, site: str, kind: str, rate: float,
            count: Optional[int] = None) -> FaultSpec:
        spec = parse_specs(
            FaultSpec(site, kind, float(rate), count).render())[0]
        with self._lock:
            self._specs[spec.site] = spec
        logger.info('fault armed: %s', spec.render())
        return spec

    # -- external sources -----------------------------------------------

    def _load_external_once(self) -> None:
        """Lazily merge SKYTPU_FAULTS and the chaos file, once per
        process (so controller subprocesses armed via env pick the
        faults up with no code in their entrypoints)."""
        if self._external_loaded:
            return
        with self._lock:
            if self._external_loaded:
                return
            self._external_loaded = True
        self.load_external()

    def load_external(self) -> None:
        for source, text in self._external_sources():
            try:
                specs = parse_specs(text)
            except ValueError as e:
                logger.error('ignoring bad fault config from %s: %s',
                             source, e)
                continue
            with self._lock:
                for spec in specs:
                    # Programmatic arming wins over ambient config.
                    self._specs.setdefault(spec.site, spec)
            if specs:
                logger.warning(
                    'faults armed from %s: %s', source,
                    ', '.join(s.render() for s in specs))

    def _external_sources(self) -> List[Tuple[str, str]]:
        out = []
        env = os.environ.get(ENV_VAR)
        if env:
            out.append((f'${ENV_VAR}', env))
        path = chaos_file_path()
        try:
            with open(path, encoding='utf-8') as f:
                out.append((path, f.read()))
        except OSError:
            pass
        return out

    # -- the hot-path hook ----------------------------------------------

    def fire(self, site: str) -> Optional[str]:
        """Roll the dice for ``site``. Returns the fault kind to
        inject, or None (the overwhelmingly common case: no spec
        armed — one dict lookup, no RNG draw)."""
        self._load_external_once()
        with self._lock:
            spec = self._specs.get(site)
            if spec is None:
                return None
            if spec.count is not None and spec.count <= 0:
                return None
            if spec.rate < 1.0 and self._rng.random() >= spec.rate:
                return None
            if spec.count is not None:
                spec.count -= 1
            kind = spec.kind
        _injections_counter().labels(site=site, kind=kind).inc()
        logger.warning('fault injected: %s -> %s', site, kind)
        return kind


_registry = FaultRegistry()
_registry_lock = threading.Lock()


def registry() -> FaultRegistry:
    return _registry


def fire(site: str) -> Optional[str]:
    return _registry.fire(site)


def arm(site: str, kind: str, rate: float,
        count: Optional[int] = None) -> FaultSpec:
    return _registry.arm(site, kind, rate, count)


def reset(seed: int = 0) -> None:
    """Fresh registry (test isolation / reseeding). The replacement
    has NOT loaded external sources yet, so a reset inside a test
    with SKYTPU_FAULTS set re-arms from the env on first fire."""
    global _registry
    with _registry_lock:
        _registry = FaultRegistry(seed)


def _injections_counter():
    from skypilot_torch import metrics as metrics_lib
    return metrics_lib.registry().counter(
        'skytpu_fault_injections_total',
        'Faults injected, by site and kind.', ('site', 'kind'))
