"""The port's count of collectives, and the point-to-point exchanges
of the model axes that cut a batch row or the layers: the ring of
``sp`` (:func:`ring_exchange`, used by ``ops/ring_attention.py``) and
the stages of ``pp`` (:func:`pp_exchange`, used by
``parallel/pipeline.py``). Both are one batch of ``isend``/``irecv`` a
call (:func:`p2p`). This module imports nothing of the model, so the
ops layer and ``parallel/sharding.py`` (which issues the other
collectives and counts them in the same :data:`COLLECTIVES`) both
import it.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Collectives:
    """Counts of the collectives the port issues (``parallel/sharding.py``
    and the exchanges here): ``gathers`` (forward all-gathers),
    ``reduce_scatters`` (their backward), ``all_reduces`` (over data
    axes and ``sp``), ``tp_reduces`` (the all-reduces over ``tp``: *f*,
    *g*, the vocab-sharded lookup, loss and argmax), ``all_to_alls``
    (the MoE exchanges over ``ep``, each way), ``ring_sends`` and
    ``pp_sends`` (the tensors sent point to point over ``sp`` and
    ``pp``) and ``host_staged`` (the point-to-point calls staged through
    host memory, :func:`p2p`)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.gathers = 0
        self.reduce_scatters = 0
        self.all_reduces = 0
        self.tp_reduces = 0
        self.all_to_alls = 0
        self.ring_sends = 0
        self.pp_sends = 0
        self.host_staged = 0

    def counts(self) -> Dict[str, int]:
        return {'gathers': self.gathers,
                'reduce_scatters': self.reduce_scatters,
                'all_reduces': self.all_reduces,
                'tp_reduces': self.tp_reduces,
                'all_to_alls': self.all_to_alls,
                'ring_sends': self.ring_sends,
                'pp_sends': self.pp_sends,
                'host_staged': self.host_staged}


COLLECTIVES = Collectives()


def p2p(sends, recvs, group) -> None:
    """One batch of point-to-point calls over ``group``: ``sends`` and
    ``recvs`` are ``(tensor, peer)`` pairs, peers global ranks; each
    ``recvs`` tensor is filled in place. Returns once all are done.

    NCCL sends device memory. gloo sends host memory: on a gloo group a
    CUDA tensor is copied to the host, sent from there, and a received
    one copied back to the card (``COLLECTIVES.host_staged`` counts these
    calls). That is the case of ranks that share one card, where NCCL
    refuses the group; it is chosen from the backend and the tensors'
    device, never by catching a failed call."""
    if not sends and not recvs:
        return
    staged = dist.get_backend(group) == 'gloo' and any(
        x.is_cuda for x, _ in list(sends) + list(recvs))
    if staged:
        COLLECTIVES.host_staged += 1
        host_recvs = [(torch.empty(x.shape, dtype=x.dtype), p)
                      for x, p in recvs]
        ops = ([dist.P2POp(dist.isend, x.contiguous().cpu(), p, group)
                for x, p in sends] +
               [dist.P2POp(dist.irecv, h, p, group) for h, p in host_recvs])
    else:
        ops = ([dist.P2POp(dist.isend, x.contiguous(), p, group)
                for x, p in sends] +
               [dist.P2POp(dist.irecv, x, p, group) for x, p in recvs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (x, _), (h, _) in zip(recvs, host_recvs):
            x.copy_(h)


def neighbours(group) -> Tuple[int, int, int, int]:
    """(this rank's index in ``group``, the group's size, the global
    ranks of the next and of the previous member, cyclically)."""
    ranks = dist.get_process_group_ranks(group)
    i, n = ranks.index(dist.get_rank()), len(ranks)
    return i, n, ranks[(i + 1) % n], ranks[(i - 1) % n]


def ring_exchange(tensors: Sequence[torch.Tensor], group
                  ) -> List[torch.Tensor]:
    """Send ``tensors`` to the next rank of the ring ``group`` (the
    ``sp`` group) and return the previous rank's, in one call
    (:func:`p2p`); ``COLLECTIVES.ring_sends`` counts the tensors sent."""
    _, _, nxt, prev = neighbours(group)
    out = [torch.empty_like(x, memory_format=torch.contiguous_format)
           for x in tensors]
    p2p([(x, nxt) for x in tensors], [(y, prev) for y in out], group)
    COLLECTIVES.ring_sends += len(tensors)
    return out


def pp_exchange(group, to_next: Optional[torch.Tensor] = None,
                to_prev: Optional[torch.Tensor] = None,
                from_prev: Optional[torch.Tensor] = None,
                from_next: Optional[torch.Tensor] = None) -> None:
    """One step's traffic of a pipeline stage over ``group`` (the
    ``pp`` group), in one call (:func:`p2p`): an activation to the next
    stage and a gradient to the previous one, and the buffers
    ``from_prev`` / ``from_next`` filled from them. Stages are not a
    ring: the last sends nothing on, the first nothing back.
    ``COLLECTIVES.pp_sends`` counts the tensors sent."""
    _, _, nxt, prev = neighbours(group)
    sends = [(x, p) for x, p in ((to_next, nxt), (to_prev, prev))
             if x is not None]
    recvs = [(x, p) for x, p in ((from_prev, prev), (from_next, nxt))
             if x is not None]
    p2p(sends, recvs, group)
    COLLECTIVES.pp_sends += len(sends)
