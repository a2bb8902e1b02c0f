"""Metrics of the port — the ``skypilot_tpu.metrics`` substrate, kept
as the port's own copy so ``skypilot_torch`` imports nothing of the JAX
package.

A dependency-free, process-local metrics registry (Counter / Gauge /
Histogram, thread-safe, labeled) with Prometheus text exposition, and
the families the port's loops feed under the JAX package's names,
help strings, labels and buckets, so the orchestration layer's
alerts, ``xsky top`` and the host agent read the port unchanged:

- ``serve/batching.py`` records queue-wait, TTFT, decode tokens/s,
  slot occupancy, KV-pool, prefix-cache, speculation, overload and
  adapter series (``skytpu_batch_*``);
- ``parallel/train.py`` ``instrument_train_step`` records step time
  and tokens/s plus goodput buckets and MFU (``metrics/goodput.py``);
- ``metrics/device.py`` samples the card's allocated / peak / total
  memory into the ``skytpu_device_hbm_*`` gauges;
- ``metrics/publish.py`` bridges the process registry into the host
  agent's ``/metrics`` (textfile collector pattern).

Metric names/labels contract: ``docs/observability.md``.
"""
from skypilot_torch.metrics.exposition import (format_value, parse_text,
                                               render_text)
from skypilot_torch.metrics.registry import (DEFAULT_BUCKETS, Counter,
                                             Gauge, Histogram, Registry,
                                             WindowedRate, registry)

__all__ = [
    'Counter',
    'Gauge',
    'Histogram',
    'Registry',
    'WindowedRate',
    'DEFAULT_BUCKETS',
    'registry',
    'render_text',
    'parse_text',
    'format_value',
]
