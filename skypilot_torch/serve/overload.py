"""Shared overload-control plumbing for the serve plane — a copy of
``skypilot_tpu/serve/overload.py`` (stdlib only), so the port never
imports the JAX package. The text below is the original's.

The deadline hop contract (docs/resilience.md, Overload control):
the LB stamps an absolute deadline on arrival (request body
``timeout_s``, the ``X-Skytpu-Deadline`` header, or the service
spec's ``overload.default_timeout_s``), then forwards the REMAINING
budget in seconds via ``X-Skytpu-Deadline`` — decremented across
the proxy hop, so replica clocks never need to agree with the LB's.
serve_model re-anchors the remaining budget against its own clock
and hands the absolute deadline to the batching engine, which
enforces it at admission and between decode iterations.
"""
from typing import Optional

# Carries SECONDS-REMAINING (a float) on the LB->replica hop, and
# accepts the same from external clients that prefer a header over
# the body's ``timeout_s`` field.
DEADLINE_HEADER = 'X-Skytpu-Deadline'


def parse_timeout_s(raw) -> Optional[float]:
    """A client-supplied timeout/remaining-budget value: positive
    finite float, else None (a garbage or non-positive budget must
    not become an instant 504 — it reads as 'no deadline')."""
    if raw is None:
        return None
    try:
        val = float(raw)
    except (TypeError, ValueError):
        return None
    if val <= 0 or val != val or val == float('inf'):
        return None
    return val
