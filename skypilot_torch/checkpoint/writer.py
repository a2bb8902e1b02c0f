"""Async background checkpoint writer — the port of
``skypilot_tpu/checkpoint/writer.py``: the same ``skytpu_ckpt_*``
families (names, help strings, labels, buckets) on the port's metrics
registry, and the ``ckpt.save`` span on the port's tracer. The text
below is the original's; "device arrays" are the state's tensors.

The save path splits in two, Orbax/TensorStore-style:

1. **Snapshot** (caller's thread, blocking, fast): device arrays are
   copied to host memory. The training loop may mutate/donate the
   live state the moment this returns.
2. **Write** (background thread): the host snapshot streams to
   disk/bucket and commits, while training continues.

Backpressure is the queue depth: at most ``queue_depth`` snapshots
may be in flight; a further ``submit`` BLOCKS until the writer
drains one. That bounds host memory at ``queue_depth`` state copies
— a slow bucket degrades save frequency, never host RAM.

A write error is captured and re-raised on the next ``submit``/
``wait`` (same surfacing contract as orbax's async checkpointer);
an injected ``checkpoint.save`` *preempt* fault abandons the write
silently, modeling the process dying mid-save.
"""
import logging
import queue
import threading
import time
from typing import Any, Callable, Optional, Tuple

logger = logging.getLogger(__name__)

_SAVE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                 30.0, 60.0, 120.0, 300.0, 600.0)


def ckpt_metrics():
    """The ``skytpu_ckpt_*`` families (docs/observability.md)."""
    from skypilot_torch import metrics as metrics_lib
    reg = metrics_lib.registry()
    return {
        'save_seconds': reg.histogram(
            'skytpu_ckpt_save_seconds',
            'Background write+commit time per checkpoint save.',
            buckets=_SAVE_BUCKETS),
        'bytes_total': reg.counter(
            'skytpu_ckpt_bytes_total',
            'Checkpoint bytes written to storage.'),
        'queue_depth': reg.gauge(
            'skytpu_ckpt_queue_depth',
            'Checkpoint snapshots waiting for the background '
            'writer.'),
        'saves_total': reg.counter(
            'skytpu_ckpt_saves_total',
            'Checkpoint saves, by outcome.', ('outcome',)),
        'restores_total': reg.counter(
            'skytpu_ckpt_restores_total',
            'Checkpoint restores, by outcome.', ('outcome',)),
        'reshard_restores_total': reg.counter(
            'skytpu_ckpt_reshard_restores_total',
            'Restores that re-partitioned saved shards onto a '
            'different sharding/mesh (elastic resume).'),
        'last_committed_step': reg.gauge(
            'skytpu_ckpt_last_committed_step',
            'Step of the most recently committed checkpoint.'),
    }


class AsyncWriter:
    """Bounded-queue background writer.

    ``write_fn(step, payload)`` runs on the writer thread; it must
    raise on failure and return either the number of bytes written
    (or None), or a ``(nbytes, committed)`` tuple — ``committed``
    gates the ``skytpu_ckpt_last_committed_step`` gauge, so a
    non-zero rank that only contributed shards (rank 0 owns the
    commit) never reports a committed step that may not exist.
    """

    def __init__(self, write_fn: Callable[[int, Any], Optional[int]],
                 queue_depth: int = 2,
                 on_abandoned: Optional[Callable[[int], None]] = None):
        if queue_depth < 1:
            raise ValueError('queue_depth must be >= 1')
        self._write_fn = write_fn
        self._on_abandoned = on_abandoned
        self._queue: 'queue.Queue[Optional[Tuple[int, Any]]]' = \
            queue.Queue(maxsize=queue_depth)
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._metrics = ckpt_metrics()
        self._thread = threading.Thread(target=self._run,
                                        name='ckpt-writer',
                                        daemon=True)
        self._thread.start()

    # -- producer side --------------------------------------------------

    def submit(self, step: int, payload: Any) -> None:
        """Enqueue a host snapshot; blocks when ``queue_depth``
        writes are already in flight (bounded backpressure). The
        submitter's trace context rides along so the background
        write's `ckpt.save` span parents into the train step that
        triggered it (contextvars don't cross the writer thread)."""
        self.raise_pending_error()
        from skypilot_torch import trace as trace_lib
        self._queue.put((step, payload, trace_lib.current()))
        self._metrics['queue_depth'].set(self._queue.qsize())

    def wait(self) -> None:
        """Block until every submitted snapshot is durably written,
        then surface any write error."""
        self._queue.join()
        self.raise_pending_error()

    def close(self) -> None:
        """Drain, then stop the writer thread. Errors surface."""
        self._queue.join()
        self._queue.put(None)
        self._thread.join(timeout=60.0)
        self.raise_pending_error()

    def raise_pending_error(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    @property
    def in_flight(self) -> int:
        return self._queue.qsize()

    # -- writer thread --------------------------------------------------

    def _run(self) -> None:
        from skypilot_torch import trace as trace_lib
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, payload, trace_ctx = item
            t0 = time.perf_counter()
            t0_wall = time.time()
            span_status = 'OK'
            span_bytes = 0
            try:
                nbytes = self._write_fn(step, payload)
            except _AbandonedSave:
                # Injected preemption mid-save: the tmp dir stays
                # torn on disk, exactly as if the process had died.
                span_status = 'ERROR'
                self._metrics['saves_total'].labels(
                    outcome='abandoned').inc()
                logger.warning('checkpoint save of step %d abandoned '
                               '(injected preemption)', step)
                if self._on_abandoned is not None:
                    self._on_abandoned(step)
            except BaseException as e:  # pylint: disable=broad-except
                span_status = 'ERROR'
                with self._error_lock:
                    self._error = e
                self._metrics['saves_total'].labels(
                    outcome='error').inc()
                logger.error('checkpoint save of step %d failed: %s',
                             step, e)
            else:
                committed = True
                if isinstance(nbytes, tuple):
                    nbytes, committed = nbytes
                dt = time.perf_counter() - t0
                span_bytes = nbytes or 0
                self._metrics['save_seconds'].observe(dt)
                if nbytes:
                    self._metrics['bytes_total'].inc(nbytes)
                self._metrics['saves_total'].labels(
                    outcome='ok').inc()
                if committed:
                    self._metrics['last_committed_step'].set(step)
            finally:
                trace_lib.record_span(
                    'ckpt.save', t0_wall,
                    t0_wall + (time.perf_counter() - t0), trace_ctx,
                    attrs={'step': step, 'bytes': span_bytes},
                    status=span_status)
                self._queue.task_done()
                self._metrics['queue_depth'].set(self._queue.qsize())


class _AbandonedSave(BaseException):
    """Control-flow signal for an injected mid-save preemption.

    Derives from BaseException so generic ``except Exception``
    wrappers in write paths cannot convert the simulated crash into
    an ordinary handled error."""
