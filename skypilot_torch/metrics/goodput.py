"""Goodput & MFU accounting for training loops — the port of
``skypilot_tpu/metrics/goodput.py``: the same families and accounting;
the chip peak comes from the port's own table of cards
(``PEAK_BF16_FLOPS``) instead of the TPU catalog.

Classifies every second of a training run's wall clock into buckets —
what fraction of the time the chips were doing useful compute versus
compiling, blocking on checkpoint I/O, restoring, or stalled in
recovery — and derives MFU (model FLOPs utilization) from the model
config and the card's peak. This is the measurement substrate
the ROADMAP's perf items hinge on: "tokens/s went down" becomes
"goodput dropped because checkpoint_save seconds doubled", and
"is this config fast" becomes an MFU number comparable across chips.

Exported series (docs/observability.md, Compute plane):

    skytpu_goodput_seconds_total{bucket}   counter, bucket in BUCKETS
    skytpu_goodput_ratio                   gauge, compute / total
    skytpu_mfu_ratio                       gauge, latest compute step

Accounting model (exclusive partition of wall clock): the accountant
lives in the TRAINING process. ``parallel.instrument_train_step``
feeds it the interval between consecutive step calls
(``observe_step``); blocking activities inside that interval
(checkpoint snapshot/submit backpressure, restore, a recovery stall)
``note()`` their wall time, which is carved OUT of the enclosing
step interval — so the buckets sum to wall clock instead of
double-counting. The first observed interval is the compile step.
Async checkpoint writes that overlap compute are NOT noted (only the
blocking portion is), which is exactly what goodput means.

Stdlib-only: importable from agents, adapters and tests without jax.
"""
import os
import threading
import time
from typing import Dict, Optional

BUCKETS = ('compute', 'compile', 'checkpoint_save', 'restore',
           'recovery_stall')

# Env var the gang launcher stamps with the accelerator name so
# the train process can resolve its chip's peak FLOPs without plumbing
# it through every recipe flag.
ENV_ACCELERATOR = 'SKYTPU_ACCELERATOR'

# Peak dense bf16 FLOP/s of one card, by every name that card goes by:
# the accelerator stamp and what ``torch.cuda.get_device_name()``
# reports (matched case-insensitively). One row: the H100 SXM (NVIDIA's
# data sheet, dense bf16). A name not here exports no MFU.
PEAK_BF16_FLOPS = (
    (('H100-SXM', 'H100-SXM5', 'H100-SXM5-80GB',
      'NVIDIA H100 80GB HBM3'), 989e12),
)

# Wall-clock stamp (unix seconds) the jobs controller applies to a
# recovery relaunch at the moment it OBSERVED the failure: the
# relaunched training process calls note_recovery_stall_from_env() to
# price the dead time between those two points into the
# `recovery_stall` bucket. This is the number NEXT_BEST_SHAPE elastic
# recovery exists to shrink (docs/resilience.md, Elastic resume).
ENV_RECOVERY_DETECTED_AT = 'SKYTPU_RECOVERY_DETECTED_AT'


def train_metrics(reg=None) -> Dict[str, object]:
    """The train-loop metric families, get-or-create (shared by
    ``parallel.instrument_train_step`` and the framework callback
    adapters so both feed the SAME series — re-declaring with
    different buckets would raise, by registry design)."""
    from skypilot_torch import metrics as metrics_lib
    reg = reg or metrics_lib.registry()
    return {
        'step_seconds': reg.histogram(
            'skytpu_train_step_seconds',
            'Wall time between consecutive train steps.',
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     5.0, 10.0, 30.0, 60.0, 120.0, 300.0)),
        'tokens_total': reg.counter('skytpu_train_tokens_total',
                                    'Tokens trained on.'),
        'steps_total': reg.counter('skytpu_train_steps_total',
                                   'Train steps executed.'),
        'tokens_per_sec': reg.gauge(
            'skytpu_train_tokens_per_sec',
            'Token throughput of the latest step.'),
    }


def peak_flops_per_chip(accelerator: Optional[str] = None
                        ) -> Optional[float]:
    """Peak dense bf16 FLOPs/s of one card named ``accelerator``
    (default: the ``SKYTPU_ACCELERATOR`` env stamp), from
    ``PEAK_BF16_FLOPS``. None when the name is unknown or absent (CPU
    dev boxes) — MFU is simply not exported then."""
    accelerator = accelerator or os.environ.get(ENV_ACCELERATOR)
    if not accelerator:
        return None
    name = accelerator.strip().lower()
    for names, peak in PEAK_BF16_FLOPS:
        if name in (n.lower() for n in names):
            return peak
    return None


class GoodputAccountant:
    """Partitions training wall clock into the goodput buckets.

    Thread-safe: ``note()`` may be called from the checkpoint
    writer's submitting path while the loop thread calls
    ``observe_step``.
    """

    def __init__(self, registry=None):
        from skypilot_torch import metrics as metrics_lib
        reg = registry or metrics_lib.registry()
        self._seconds = reg.counter(
            'skytpu_goodput_seconds_total',
            'Training wall clock partitioned by activity.',
            labelnames=('bucket',))
        self._ratio = reg.gauge(
            'skytpu_goodput_ratio',
            'Fraction of accounted wall clock spent in useful '
            'device compute.')
        self._reg = reg
        # The MFU gauge is created LAZILY on the first real value:
        # a process with no resolvable chip peak (CPU dev box, local
        # fake cloud) must not export a fake 0% MFU.
        self._mfu = None
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        # Pending claims as (noted_at_monotonic, remaining_seconds):
        # a claim is carved out of a step interval only to the extent
        # its wall window [noted_at - remaining, noted_at] OVERLAPS
        # that interval. Blocking time outside every observed
        # interval (a pre-loop restore; a save between the framework
        # adapters' begin->end brackets) counts in its own bucket but
        # never docks compute/compile it didn't actually interrupt.
        self._pending: list = []
        # MFU inputs (set_model_info).
        self._flops_per_step: Optional[float] = None
        self._n_chips = 1
        self._peak_flops: Optional[float] = None

    # -- wiring ---------------------------------------------------------

    def set_model_info(self, param_count: int, tokens_per_step: int,
                       n_chips: Optional[int] = None,
                       peak_flops_per_chip_value: Optional[float] = None,
                       accelerator: Optional[str] = None,
                       full_finetune: bool = True) -> None:
        """Arm MFU: model FLOPs/step = (6 full / 4 LoRA-frozen-base)
        * params * tokens (fwd 2N + bwd 4N per token; a frozen base
        skips its weight-grad 2N). Peak comes from ``PEAK_BF16_FLOPS``
        via ``accelerator`` (or the SKYTPU_ACCELERATOR env stamp) unless
        given explicitly. Without a resolvable peak (CPU dev box),
        MFU stays unset."""
        flops_per_token = (6 if full_finetune else 4) * param_count
        peak = peak_flops_per_chip_value
        if peak is None:
            peak = peak_flops_per_chip(accelerator)
        with self._lock:
            self._flops_per_step = float(flops_per_token) * \
                float(tokens_per_step)
            if n_chips:
                self._n_chips = int(n_chips)
            self._peak_flops = peak

    # -- accounting -----------------------------------------------------

    def note(self, bucket: str, seconds: float,
             noted_at: Optional[float] = None) -> None:
        """Attribute ``seconds`` of loop-blocking wall time ENDING
        now (or at ``noted_at``, monotonic) to ``bucket``
        (checkpoint_save / restore / recovery_stall). The amount is
        flushed to the counter immediately; the portion overlapping
        a later-observed step interval is carved out of that
        interval so the partition holds."""
        if bucket not in BUCKETS:
            raise ValueError(f'unknown goodput bucket {bucket!r} '
                             f'(choose from {BUCKETS})')
        if seconds <= 0:
            return
        if noted_at is None:
            noted_at = time.monotonic()
        with self._lock:
            self._totals[bucket] += seconds
            self._pending.append([noted_at, seconds])
            self._seconds.labels(bucket=bucket).inc(seconds)
            self._update_ratio_locked()

    def observe_step(self, dt: float, compile_step: bool = False,
                     now: Optional[float] = None) -> None:
        """One step interval of ``dt`` seconds ending now (or at
        ``now``, monotonic). Pending claims are subtracted exactly
        where their wall windows overlap this interval; the
        remainder goes to ``compile`` (first interval) or
        ``compute``."""
        if dt <= 0:
            return
        if now is None:
            now = time.monotonic()
        start = now - dt
        with self._lock:
            claimed = 0.0
            kept = []
            for entry in self._pending:
                noted_at, remaining = entry
                overlap = min(now, noted_at) - \
                    max(start, noted_at - remaining)
                if overlap > 0:
                    take = min(remaining, overlap)
                    claimed += take
                    remaining -= take
                if remaining > 1e-9 and noted_at > start:
                    # Could still overlap a FUTURE interval (a claim
                    # larger than this interval). Claims entirely
                    # before this interval can never overlap a later
                    # one — intervals only move forward — so they are
                    # dropped, already fully counted in their bucket.
                    kept.append([noted_at, remaining])
            self._pending = kept
            rest = max(0.0, dt - claimed)
            bucket = 'compile' if compile_step else 'compute'
            if rest > 0:
                self._totals[bucket] += rest
                self._seconds.labels(bucket=bucket).inc(rest)
            self._update_ratio_locked()
            if (bucket == 'compute' and rest > 0
                    and self._flops_per_step
                    and self._peak_flops):
                # MFU against the FULL interval, not just the compute
                # remainder: blocking time is utilization lost.
                mfu = self._flops_per_step / (
                    dt * self._n_chips * self._peak_flops)
                if self._mfu is None:
                    self._mfu = self._reg.gauge(
                        'skytpu_mfu_ratio',
                        'Model FLOPs utilization of the latest '
                        'compute step (model FLOPs/step vs catalog '
                        'chip peak).')
                self._mfu.set(mfu)

    def _update_ratio_locked(self) -> None:
        total = sum(self._totals.values())
        if total > 0:
            self._ratio.set(self._totals['compute'] / total)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)


_accountant: Optional[GoodputAccountant] = None
_accountant_lock = threading.Lock()


def accountant() -> GoodputAccountant:
    """The process-global accountant (one training loop per process
    in this stack; several callers share the same wall clock)."""
    global _accountant
    with _accountant_lock:
        if _accountant is None:
            _accountant = GoodputAccountant()
        return _accountant


def note(bucket: str, seconds: float) -> None:
    """Convenience: ``accountant().note(...)`` — the call sites that
    blockingly interrupt a training loop (checkpoint submit/wait,
    restore, recovery stalls) are scattered across subsystems."""
    accountant().note(bucket, seconds)


def note_recovery_stall_from_env() -> Optional[float]:
    """Price a recovery relaunch's dead time into `recovery_stall`.

    The jobs controller stamps ``SKYTPU_RECOVERY_DETECTED_AT`` (unix
    wall clock — the only clock that survives the process boundary)
    on every recovery relaunch; the restarted training process calls
    this once at startup. Returns the stall seconds noted, or None
    when the process is not a recovery relaunch. The env var is
    consumed (popped) so a fork/exec inside the task cannot
    double-count the same stall."""
    raw = os.environ.pop(ENV_RECOVERY_DETECTED_AT, '')
    if not raw:
        return None
    try:
        detected_at = float(raw)
    except ValueError:
        return None
    stall = max(0.0, time.time() - detected_at)
    if stall > 0:
        note('recovery_stall', stall)
    return stall


def reset_accountant() -> None:
    """Test seam: drop the process accountant (its counter families
    persist in the registry; tests isolate via fresh registries or
    delta assertions)."""
    global _accountant
    with _accountant_lock:
        _accountant = None
