"""Typed exceptions of the port's serving engine — copied from
``skypilot_tpu/exceptions.py`` (the classes the paged KV pool and the
batching engine raise; the same names, bases and meanings).
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
