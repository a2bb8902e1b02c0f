"""Process-local metrics registry: Counter, Gauge, Histogram — a copy
of ``skypilot_tpu/metrics/registry.py`` (stdlib only), so the port
exports the same families in the same text.

Dependency-free by design (the tree vendors no web framework and no
prometheus_client); the exposition format is the Prometheus text
format so any scraper — including ours (``metrics/scrape.py``) —
can consume it.

Concurrency model: every mutation takes the metric family's lock.
Values are plain floats guarded by that lock; label lookups create
children on first use. Label CARDINALITY is bounded per family
(``max_label_sets``, default 1000) — a runaway label (e.g. a
request-id accidentally used as a label value) degrades into one
overflow series instead of an unbounded dict eating the process
(vLLM/JetStream treat metric memory as load-bearing the same way).
"""
import bisect
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Latency-shaped default buckets (seconds), request-serving oriented:
# 1 ms .. 60 s, roughly x2.5 per step.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0)

_OVERFLOW_LABELS = ('__overflow__',)


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in '_:' for c in name):
        raise ValueError(f'invalid metric name {name!r}')
    if name[0].isdigit():
        raise ValueError(f'metric name must not start with a digit: '
                         f'{name!r}')
    return name


class _Child:
    """One labeled series. Interface depends on the family kind."""

    def __init__(self, family: '_Family'):
        self._family = family

    @property
    def _lock(self):
        return self._family._lock  # pylint: disable=protected-access


class _CounterChild(_Child):

    def __init__(self, family: '_Family'):
        super().__init__(family)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError('counters can only increase '
                             f'(inc({amount}))')
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):

    def __init__(self, family: '_Family'):
        super().__init__(family)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild(_Child):

    def __init__(self, family: '_Family'):
        super().__init__(family)
        self._bucket_counts = [0] * (len(family.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if math.isnan(value):
            return
        idx = bisect.bisect_left(self._family.buckets, value)
        with self._lock:
            self._bucket_counts[idx] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl +Inf, sum, count)."""
        with self._lock:
            counts = list(self._bucket_counts)
            total_sum, count = self._sum, self._count
        cumulative, running = [], 0
        for c in counts:
            running += c
            cumulative.append(running)
        return cumulative, total_sum, count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


_KIND_CHILD = {'counter': _CounterChild, 'gauge': _GaugeChild,
               'histogram': _HistogramChild}


class _Family:
    """A named metric with a fixed label schema and many children."""

    def __init__(self, name: str, help_text: str, kind: str,
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None,
                 max_label_sets: int = 1000):
        self.name = _validate_name(name)
        self.help = help_text
        self.kind = kind
        self.labelnames = tuple(labelnames)
        for label in self.labelnames:
            if not label.isidentifier():
                raise ValueError(f'invalid label name {label!r}')
        if kind == 'histogram':
            bkts = tuple(sorted(buckets or DEFAULT_BUCKETS))
            if not bkts:
                raise ValueError('histogram needs >= 1 bucket')
            self.buckets: Tuple[float, ...] = bkts
        else:
            if buckets is not None:
                raise ValueError(f'{kind} takes no buckets')
            self.buckets = ()
        self.max_label_sets = max_label_sets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            # Unlabeled family IS its single child.
            self._children[()] = _KIND_CHILD[kind](self)

    # -- child access ---------------------------------------------------

    def _label_key(self, labelvalues, labelkwargs) -> Tuple[str, ...]:
        if labelkwargs:
            if labelvalues:
                raise ValueError('pass label values positionally OR '
                                 'by keyword, not both')
            try:
                labelvalues = tuple(labelkwargs[name]
                                    for name in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f'{self.name}: missing label {e.args[0]!r} '
                    f'(schema {self.labelnames})') from e
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f'{self.name} takes labels {self.labelnames}, got '
                f'{len(labelvalues)} value(s)')
        return tuple(str(v) for v in labelvalues)

    def labels(self, *labelvalues, **labelkwargs):
        key = self._label_key(labelvalues, labelkwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_label_sets:
                    # Cardinality bound: collapse the excess into one
                    # well-known overflow series.
                    key = _OVERFLOW_LABELS * len(self.labelnames)
                    child = self._children.get(key)
                    if child is None:
                        child = _KIND_CHILD[self.kind](self)
                        self._children[key] = child
                else:
                    child = _KIND_CHILD[self.kind](self)
                    self._children[key] = child
        return child

    def remove(self, *labelvalues, **labelkwargs) -> None:
        """Drop one labeled series (no-op if absent). For label
        values naming entities with a lifecycle (replicas, hosts): a
        scaled-away target must stop exporting its last sample, not
        freeze it into dashboards/alerts forever."""
        if not self.labelnames:
            raise ValueError(
                f'{self.name} is unlabeled; nothing to remove')
        key = self._label_key(labelvalues, labelkwargs)
        with self._lock:
            self._children.pop(key, None)

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f'{self.name} is labeled {self.labelnames}; use '
                '.labels(...) first')
        return self._children[()]

    # Unlabeled convenience passthroughs.
    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    @property
    def value(self) -> float:
        return self._default_child().value

    # -- collection -----------------------------------------------------

    def collect(self) -> List[Tuple[Tuple[Tuple[str, str], ...],
                                    '_Child']]:
        """[(((label, value), ...), child)] — stable label order."""
        with self._lock:
            items = list(self._children.items())
        out = []
        for key, child in sorted(items):
            out.append((tuple(zip(self.labelnames, key)), child))
        return out


class Counter(_Family):

    def __init__(self, name, help_text='', labelnames=(),
                 max_label_sets=1000):
        super().__init__(name, help_text, 'counter', labelnames,
                         max_label_sets=max_label_sets)


class Gauge(_Family):

    def __init__(self, name, help_text='', labelnames=(),
                 max_label_sets=1000):
        super().__init__(name, help_text, 'gauge', labelnames,
                         max_label_sets=max_label_sets)


class Histogram(_Family):

    def __init__(self, name, help_text='', labelnames=(),
                 buckets=None, max_label_sets=1000):
        super().__init__(name, help_text, 'histogram', labelnames,
                         buckets=buckets or DEFAULT_BUCKETS,
                         max_label_sets=max_label_sets)


class WindowedRate:
    """Events-per-second over a trailing window, from timestamps.

    The autoscaler's measured-QPS source: the LB feeds every proxied
    request in; ``rate()`` is the trailing-window average. O(1)
    memory via fixed one-second buckets (not a timestamp list — a
    traffic spike must not grow the LB's heap)."""

    def __init__(self, window_seconds: float = 60.0):
        if window_seconds <= 0:
            raise ValueError('window must be positive')
        self.window = float(window_seconds)
        self._nbuckets = int(math.ceil(self.window)) + 1
        self._buckets = [0] * self._nbuckets
        self._bucket_epoch = [0] * self._nbuckets  # second it counts
        self._lock = threading.Lock()

    def record(self, now: Optional[float] = None,
               count: int = 1) -> None:
        now = time.time() if now is None else now
        sec = int(now)
        idx = sec % self._nbuckets
        with self._lock:
            if self._bucket_epoch[idx] != sec:
                self._bucket_epoch[idx] = sec
                self._buckets[idx] = 0
            self._buckets[idx] += count

    def rate(self, now: Optional[float] = None) -> float:
        """Average events/sec over the trailing window."""
        now = time.time() if now is None else now
        cutoff = now - self.window
        total = 0
        with self._lock:
            for idx in range(self._nbuckets):
                epoch = self._bucket_epoch[idx]
                # A bucket's events all lie in [epoch, epoch+1).
                if cutoff < epoch + 1 and epoch <= now:
                    total += self._buckets[idx]
        return total / self.window


class Registry:
    """Holds metric families; renders/serves them together.

    ``counter``/``gauge``/``histogram`` are get-or-create: a second
    call with the same name returns the SAME family (so modules can
    declare their metrics at import or lazily without coordinating),
    but re-declaring with a different kind or label schema is a bug
    and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, kind: str, name: str, help_text: str,
                       labelnames: Sequence[str],
                       buckets: Optional[Sequence[float]] = None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f'metric {name!r} already registered as '
                        f'{fam.kind}{fam.labelnames}, cannot '
                        f're-register as {kind}{tuple(labelnames)}')
                if kind == 'histogram' and \
                        fam.buckets != tuple(sorted(buckets)):
                    # Silently returning the first layout would land
                    # the caller's observations in buckets it never
                    # chose — wrong quantiles with nothing flagging
                    # it.
                    raise ValueError(
                        f'histogram {name!r} already registered '
                        f'with buckets {fam.buckets}, cannot '
                        f're-register with {tuple(sorted(buckets))}')
                return fam
            if buckets is not None:
                fam = cls(name, help_text, labelnames, buckets=buckets)
            else:
                fam = cls(name, help_text, labelnames)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str = '',
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, 'counter', name, help_text,
                                   labelnames)

    def gauge(self, name: str, help_text: str = '',
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, 'gauge', name, help_text,
                                   labelnames)

    def histogram(self, name: str, help_text: str = '',
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None
                  ) -> Histogram:
        return self._get_or_create(Histogram, 'histogram', name,
                                   help_text, labelnames,
                                   buckets=buckets or DEFAULT_BUCKETS)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)

    def families(self) -> List[_Family]:
        with self._lock:
            return sorted(self._families.values(),
                          key=lambda f: f.name)

    def render(self) -> str:
        from skypilot_torch.metrics import exposition
        return exposition.render_text(self)


# The process-global default registry. Components that might coexist
# in one process under different roles (agent vs LB vs engine) use
# distinct metric-name prefixes instead of separate registries, so
# one /metrics handler serves everything the process knows.
_default_registry = Registry()


def registry() -> Registry:
    return _default_registry
