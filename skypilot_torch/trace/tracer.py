"""Distributed tracing core: spans, context propagation, jsonl sinks —
a copy of ``skypilot_tpu/trace/tracer.py`` (stdlib only), with the
same env contract, ``traceparent`` format and sink files, so the JAX
package's collector assembles the port's spans unchanged.

Dapper-style request tracing for the multi-process topology this
repo actually has — CLI → optimizer → provisioner → host agents →
job runner → controllers → LB → replica. Stdlib-only by design (like
``metrics/``, ``resilience/`` and ``lifecycle/``): one span model,
three propagation channels, one sink format.

Span model
    ``trace_id`` (32 hex) names the end-to-end request; ``span_id``
    (16 hex) names one timed operation; ``parent_id`` links the tree.
    Durations are measured on the MONOTONIC clock (an NTP step must
    not stretch a span); start/end are exported as epoch seconds
    derived from one wall-clock anchor per span so multi-process
    waterfalls line up (cross-host skew is whatever NTP leaves — the
    tree structure, not the clock, is the source of truth for
    causality).

Propagation
    - In-process: a ``contextvars`` context variable — ``span()``
      nests automatically across threads spawned with a copied
      context and across the same thread's call stack.
    - Cross-process by ENV: ``SKYTPU_TRACE_CONTEXT`` carries a
      traceparent-style stamp; ``current()`` falls back to it, so a
      task/daemon spawned with the stamp is in-trace with zero code.
    - Cross-process by HEADER: a W3C-style ``traceparent`` header on
      every AgentClient RPC and on the serve LB → replica proxy hop;
      servers adopt it with :func:`attach`.

Sinks
    One jsonl file per process under ``$SKYTPU_TRACE_DIR`` (default
    ``$SKYTPU_STATE_DIR/trace``): ``spans-<component>-<pid>.jsonl``,
    one span per line, appended+flushed at span end so a crash loses
    at most the open spans. Torn lines are SKIPPED by the collector
    (same contract as the lifecycle registry). The orchestration-side
    collector (``skypilot_tpu/trace/collect.py``, not part of the port)
    assembles a full trace from the sinks of many processes/hosts.

Recording rule: a span records to the sink only when it belongs to a
trace — i.e. there is an ambient/explicit parent, or the caller asked
for a root with ``new_trace=True``. Background polls and idle loops
therefore cost nothing. With ``SKYTPU_DEBUG=1`` every span (orphans
included) additionally lands in the in-process Chrome-trace buffer
(``chrome_export`` writes it; the JAX package's ``utils/timeline.py``
facade over it is not ported).

``SKYTPU_TRACE=0`` disables sink writes entirely.
"""
import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, NamedTuple, Optional

ENV_CONTEXT = 'SKYTPU_TRACE_CONTEXT'
ENV_COMPONENT = 'SKYTPU_TRACE_COMPONENT'
TRACEPARENT_HEADER = 'traceparent'


class SpanContext(NamedTuple):
    trace_id: str
    span_id: str


# Ambient context: _UNSET means "consult the env stamp"; _NO_TRACE is
# an explicit barrier (a server handling an untraced request must not
# inherit the process's launch-time env stamp).
_UNSET = object()
_NO_TRACE = object()
_ctx: 'contextvars.ContextVar[Any]' = contextvars.ContextVar(
    'skytpu_trace_ctx', default=_UNSET)

_component: Optional[str] = None
_sink_lock = threading.Lock()
_sink_path: Optional[str] = None
_sink_file = None

# Chrome-trace debug buffer (SKYTPU_DEBUG=1): the timeline facade's
# storage. Events use the Chrome trace-event phases ('B'/'E'/'X').
_debug_events: list = []
_debug_lock = threading.Lock()


def enabled() -> bool:
    return os.environ.get('SKYTPU_TRACE', '1') != '0'


def sample_root() -> bool:
    """Head-based sampling decision for a NEW request-rooted trace
    (the serve LB consults this per request; requests that arrive
    with a traceparent header are always traced — the caller already
    decided). SKYTPU_TRACE_SAMPLE in [0, 1], default 1 (trace
    everything — the e2e/acceptance default; production serve fleets
    dial it down)."""
    if not enabled():
        return False
    raw = os.environ.get('SKYTPU_TRACE_SAMPLE', '1')
    try:
        rate = float(raw)
    except ValueError:
        return True
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    import random
    return random.random() < rate


def _debug_enabled() -> bool:
    return os.environ.get('SKYTPU_DEBUG', '0') == '1'


def set_component(name: str) -> None:
    """Name this process's sink file (e.g. 'lb', 'replica'); also
    recorded on every span so the waterfall can say who did what."""
    global _component
    _component = name


def component() -> str:
    return (_component or os.environ.get(ENV_COMPONENT) or
            f'proc{os.getpid()}')


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


# -- context ----------------------------------------------------------


def current() -> Optional[SpanContext]:
    """The ambient span context: the innermost active span, else the
    process's ``SKYTPU_TRACE_CONTEXT`` env stamp, else None."""
    v = _ctx.get()
    if v is _NO_TRACE:
        return None
    if v is not _UNSET:
        return v
    return parse_traceparent(os.environ.get(ENV_CONTEXT))


@contextlib.contextmanager
def attach(ctx: Optional[SpanContext]) -> Iterator[None]:
    """Explicitly set (or with None: BLOCK) the ambient context for
    the duration of the block — the server-side adoption primitive
    for a ``traceparent`` header. ``attach(None)`` installs a barrier
    so an untraced request cannot inherit the process's launch-time
    env stamp."""
    token = _ctx.set(ctx if ctx is not None else _NO_TRACE)
    try:
        yield
    finally:
        _ctx.reset(token)


def format_traceparent(ctx: Optional[SpanContext] = None
                       ) -> Optional[str]:
    """W3C-traceparent-style stamp ('00-<trace>-<span>-01') of the
    given (default: current) context, or None when untraced."""
    if ctx is None:
        ctx = current()
    if ctx is None:
        return None
    return f'00-{ctx.trace_id}-{ctx.span_id}-01'


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Tolerant parse of the stamp; malformed input is untraced, not
    an error (an old client's garbage header must not 500 a serve
    request)."""
    if not value:
        return None
    parts = value.strip().split('-')
    if len(parts) == 4:
        _, trace_id, span_id = parts[0], parts[1], parts[2]
    elif len(parts) == 2:
        trace_id, span_id = parts
    else:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    if not trace_id or not span_id:
        return None
    return SpanContext(trace_id, span_id)


def context_env(ctx: Optional[SpanContext] = None) -> Dict[str, str]:
    """The env stamp for a child process ({} when untraced):
    ``env.update(trace.context_env())`` before spawn."""
    stamp = format_traceparent(ctx)
    if stamp is None:
        return {}
    return {ENV_CONTEXT: stamp}


# -- sink -------------------------------------------------------------


def sink_dir() -> str:
    explicit = os.environ.get('SKYTPU_TRACE_DIR')
    if explicit:
        return os.path.expanduser(explicit)
    base = os.path.expanduser(
        os.environ.get('SKYTPU_STATE_DIR', '~/.skypilot_tpu'))
    return os.path.join(base, 'trace')


def _max_sink_bytes() -> int:
    """Per-sink-file size cap (SKYTPU_TRACE_MAX_MB, default 64): on
    overflow the file rotates to ``<path>.1`` (one generation kept),
    so a long-lived traced LB/replica can never fill the disk its
    checkpoints and logs share."""
    try:
        mb = float(os.environ.get('SKYTPU_TRACE_MAX_MB', '64'))
    except ValueError:
        mb = 64.0
    return int(mb * 1e6)


def _write_record(rec: Dict[str, Any]) -> None:
    """Append one span line to this process's sink. Never raises —
    tracing must not take the traced process down; the state dir can
    vanish mid-write (test teardown) and that's a dropped span, not a
    crash."""
    global _sink_path, _sink_file
    if not enabled():
        return
    try:
        line = json.dumps(rec, separators=(',', ':'))
    except (TypeError, ValueError):
        return
    with _sink_lock:
        try:
            path = os.path.join(
                sink_dir(), f'spans-{component()}-{os.getpid()}.jsonl')
            if path != _sink_path or _sink_file is None:
                if _sink_file is not None:
                    try:
                        _sink_file.close()
                    except OSError:
                        pass
                os.makedirs(os.path.dirname(path), exist_ok=True)
                _sink_file = open(path, 'a', encoding='utf-8')
                _sink_path = path
            _sink_file.write(line + '\n')
            _sink_file.flush()
            if _sink_file.tell() > _max_sink_bytes():
                _sink_file.close()
                os.replace(path, path + '.1')
                _sink_file = open(path, 'a', encoding='utf-8')
        except OSError:
            _sink_file = None
            _sink_path = None


def reset_sink() -> None:
    """Close the cached sink handle (tests switching state dirs)."""
    global _sink_path, _sink_file
    with _sink_lock:
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
        _sink_file = None
        _sink_path = None


# -- debug (Chrome trace) buffer --------------------------------------


def _debug_event(name: str, phase: str, ts_us: float,
                 args: Optional[Dict[str, Any]] = None,
                 dur_us: Optional[float] = None) -> None:
    ev: Dict[str, Any] = {
        'name': name,
        'ph': phase,
        'ts': ts_us,
        'pid': os.getpid(),
        'tid': threading.get_ident() % (1 << 31),
    }
    if dur_us is not None:
        ev['dur'] = dur_us
    if args:
        ev['args'] = args
    with _debug_lock:
        _debug_events.append(ev)


def chrome_export(path: Optional[str] = None) -> Optional[str]:
    """Persist the process-local Chrome trace buffer (write-then-
    rename; keeps the buffer). Returns the path, or None when the
    buffer is empty. The ``utils/timeline`` facade's save/flush."""
    with _debug_lock:
        if not _debug_events:
            return None
        payload = {'traceEvents': list(_debug_events)}
    if path is None:
        base = os.path.expanduser(
            os.environ.get('SKYTPU_STATE_DIR', '~/.skypilot_tpu'))
        path = os.path.join(base, f'timeline-{os.getpid()}.json')
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'w', encoding='utf-8') as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def debug_buffer_nonempty() -> bool:
    with _debug_lock:
        return bool(_debug_events)


# -- spans ------------------------------------------------------------


class Span:
    """One timed operation. Use via :func:`span` (context manager);
    spans that outlive a ``with`` block use
    :func:`child_context` + :func:`emit_span` instead.

    ``recording`` is False for orphans (no parent and not asked to
    root a new trace): they still measure — and still land in the
    Chrome debug buffer under SKYTPU_DEBUG=1 — but write nothing to
    the sink and propagate no context."""

    __slots__ = ('name', 'context', 'parent_id', 'attrs', 'status',
                 'recording', '_start_wall', '_start_mono',
                 '_token', '_ended')

    def __init__(self, name: str, parent: Optional[SpanContext],
                 attrs: Optional[Dict[str, Any]], new_trace: bool):
        self.name = name
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.status = 'OK'
        self._token = None
        self._ended = False
        if parent is not None:
            self.context: Optional[SpanContext] = SpanContext(
                parent.trace_id, _new_span_id())
            self.parent_id: Optional[str] = parent.span_id
            self.recording = True
        elif new_trace:
            self.context = SpanContext(_new_trace_id(),
                                       _new_span_id())
            self.parent_id = None
            self.recording = True
        else:
            self.context = None
            self.parent_id = None
            self.recording = False
        self._start_wall = time.time()
        self._start_mono = time.monotonic()

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> 'Span':
        if self.recording:
            self._token = _ctx.set(self.context)
        if _debug_enabled():
            _debug_event(self.name, 'B', self._start_wall * 1e6,
                         self.attrs or None)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.status = 'ERROR'
            self.attrs.setdefault('error', repr(exc)[:200])
        if self._token is not None:
            _ctx.reset(self._token)
            self._token = None
        self.end()
        return False

    def end(self, end_mono: Optional[float] = None) -> None:
        """Record the span. ``end_mono`` lets a caller reuse ONE
        monotonic clock read for both a metric observation and the
        span duration (the LB does — no skew between
        ``skytpu_lb_request_seconds`` and the span)."""
        if self._ended:
            return
        self._ended = True
        if end_mono is None:
            end_mono = time.monotonic()
        duration = max(0.0, end_mono - self._start_mono)
        if _debug_enabled():
            _debug_event(self.name, 'E',
                         (self._start_wall + duration) * 1e6)
        if not self.recording:
            return
        assert self.context is not None
        _write_record({
            'trace_id': self.context.trace_id,
            'span_id': self.context.span_id,
            'parent_id': self.parent_id,
            'name': self.name,
            'start': self._start_wall,
            'end': self._start_wall + duration,
            'status': self.status,
            'attrs': self.attrs,
            'component': component(),
            'pid': os.getpid(),
        })


_AMBIENT = object()


def span(name: str, attrs: Optional[Dict[str, Any]] = None,
         new_trace: bool = False, parent: Any = _AMBIENT) -> Span:
    """Start a span (context manager).

    - ``parent`` defaults to the ambient context (:func:`current`);
      pass an explicit SpanContext (or None) to ignore the ambient —
      servers do this so a request's trace comes from its HEADER, not
      from the process's launch-time env stamp.
    - With no parent and ``new_trace=False`` the span is a no-op
      orphan (measures, records nothing) — hot paths can be
      instrumented unconditionally.
    - ``new_trace=True`` roots a fresh trace when there is no parent
      (entry points: ``sky launch``, ``jobs launch``, the LB's
      per-request root).
    """
    p = current() if parent is _AMBIENT else parent
    return Span(name, p, attrs, new_trace)


def child_context(parent: Optional[SpanContext]
                  ) -> Optional[SpanContext]:
    """Pre-allocate a span's identity so children can be parented to
    it BEFORE it is recorded (the train-step span is open from one
    step call to the next; a checkpoint save submitted in between
    nests under it)."""
    if parent is None:
        return None
    return SpanContext(parent.trace_id, _new_span_id())


def emit_span(ctx: SpanContext, parent: Optional[SpanContext],
              name: str, start: float, end: float,
              attrs: Optional[Dict[str, Any]] = None,
              status: str = 'OK') -> None:
    """Record a span whose identity was pre-allocated with
    :func:`child_context`, from explicit wall timestamps."""
    if _debug_enabled():
        _debug_event(name, 'X', start * 1e6, attrs,
                     dur_us=max(0.0, end - start) * 1e6)
    _write_record({
        'trace_id': ctx.trace_id,
        'span_id': ctx.span_id,
        'parent_id': parent.span_id if parent else None,
        'name': name,
        'start': start,
        'end': max(start, end),
        'status': status,
        'attrs': dict(attrs or {}),
        'component': component(),
        'pid': os.getpid(),
    })


def set_current(ctx: Optional[SpanContext]):
    """Low-level ambient-context set; returns the reset token. For
    spans held open across calls (train-step); everyone else should
    use :func:`span`/:func:`attach`."""
    return _ctx.set(ctx if ctx is not None else _NO_TRACE)


def reset_current(token) -> None:
    _ctx.reset(token)


def record_span(name: str, start: float, end: float,
                parent: Optional[SpanContext],
                attrs: Optional[Dict[str, Any]] = None,
                status: str = 'OK'
                ) -> Optional[SpanContext]:
    """Emit a span from explicit WALL-clock timestamps under an
    explicit parent — for work measured outside a ``with`` block
    (the batching engine's queue-wait/TTFT windows, the checkpoint
    writer thread). Returns the new span's context (so children can
    be parented), or None when ``parent`` is None (untraced request:
    record nothing)."""
    if parent is None:
        return None
    ctx = SpanContext(parent.trace_id, _new_span_id())
    if _debug_enabled():
        _debug_event(name, 'X', start * 1e6, attrs,
                     dur_us=max(0.0, end - start) * 1e6)
    _write_record({
        'trace_id': ctx.trace_id,
        'span_id': ctx.span_id,
        'parent_id': parent.span_id,
        'name': name,
        'start': start,
        'end': max(start, end),
        'status': status,
        'attrs': dict(attrs or {}),
        'component': component(),
        'pid': os.getpid(),
    })
    return ctx
