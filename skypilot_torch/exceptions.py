"""Typed exceptions of the port's serving engine — copied from
``skypilot_tpu/exceptions.py`` (the classes the paged KV pool, the
batching engine's overload control and the adapter subsystem raise;
the same names, bases and meanings).
"""


class SkyTpuError(Exception):
    """Base class for all framework errors."""


class KVPoolExhaustedError(SkyTpuError):
    """The paged-KV block pool cannot ever satisfy a request.

    Raised to the SUBMITTING client (via its token queue / a
    ``generate()`` re-raise) when a single request needs more KV
    blocks than the pool has usable blocks in total — transient
    exhaustion is handled by preempt-and-requeue instead, and must
    never fail unrelated in-flight requests."""


class KVBlockError(SkyTpuError, ValueError):
    """Invalid paged-KV block-pool operation.

    Raised on refcount-invariant violations: double free (releasing a
    block whose refcount is already zero), freeing the reserved
    scratch block or an out-of-range id, pinning a block that is
    neither cached nor referenced, or registering cached content on a
    block the caller does not hold a reference to. Subclasses
    ValueError so pre-refcount callers that caught ValueError keep
    working."""


class DeadlineExceededError(SkyTpuError):
    """A serve request ran past its end-to-end deadline.

    Raised to the submitting client (via its token queue) when the
    batching engine observes, at an iteration boundary or at
    admission, that the request's stamped deadline has passed. The
    HTTP surface maps this to 504 — the budget was the CLIENT's, so
    timing out is the client-visible contract, not a replica fault.
    The request's KV blocks are released through the same reclaim
    path as preemption before the error is delivered."""


class EngineOverloadedError(SkyTpuError):
    """The batching engine's bounded pending queue refused a request.

    Raised at ``submit()`` time when admission would exceed
    ``overload.max_queued_requests`` / ``max_queued_tokens``. Typed
    refusal (HTTP 429) beats silent unbounded queueing: the caller
    learns IMMEDIATELY and can retry elsewhere. ``retry_after_s``
    estimates when queue space frees up, derived from the engine's
    recent drain rate (0 when the engine has no history yet)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class AdapterError(SkyTpuError):
    """Base for adapter-serving (multi-tenant LoRA) failures —
    serve/adapters/. Subclasses are the typed refusals the HTTP
    surface maps to status codes; transient conditions (resident set
    momentarily full of pinned adapters, cold load in flight) are
    never errors — they hold the request in the pending queue."""


class AdapterNotFoundError(AdapterError):
    """A request named an adapter id the registry cannot resolve —
    no lineage dir, or a dir with no committed checkpoint. Raised at
    ``submit()`` time so the caller learns before queueing; the HTTP
    surface maps this to 404 (the id is client-supplied)."""


class AdapterCapacityError(AdapterError):
    """An adapter can NEVER be served by this engine: the engine has
    no adapter support (capacity 0), or the adapter's rank exceeds
    the engine's rank bucket (the stacked device buffers are sized
    once, at engine construction). Permanent for this engine config,
    so a typed refusal (HTTP 413) — unlike a full-but-drainable
    resident set, which is transient queueing, not an error."""


class AdapterManifestError(AdapterError):
    """An adapter checkpoint's manifest is unusable: missing the
    ``lora/*`` leaves, inconsistent A/B shapes, or an unreadable
    manifest. Registry-side validation — raised when the adapter is
    registered or first resolved, never from the decode path."""
