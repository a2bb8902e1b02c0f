"""Multi-process bootstrap from the runtime's env contract — the port of
``skypilot_tpu/parallel/distributed.py``.

JAX runs one process per host and drives every chip of the host from
it; the port runs one process per GPU. That mapping is the whole
difference: a host of ``SKYTPU_NUM_CHIPS_PER_NODE`` GPUs runs that many
processes (``recipes/finetune.py`` spawns them), and the process on GPU
``local_rank`` of host ``SKYTPU_NODE_RANK`` is global rank
``node_rank * local_world + local_rank`` of a ``torch.distributed``
process group whose store is the coordinator of the contract. NCCL
carries the collectives on ``cuda`` and gloo on ``cpu``.

Env contract (set by the on-cluster runtime,
``skypilot_tpu/runtime/env_contract.py``):
    SKYTPU_NODE_RANK           0-based host index
    SKYTPU_NUM_NODES           total host count
    SKYTPU_NODE_IPS            newline-separated host IPs (rank order)
    SKYTPU_COORDINATOR_PORT    default 8476
    SKYTPU_COORDINATOR_ADDRESS host:port of the store (else first IP:port)
    SKYTPU_NUM_CHIPS_PER_NODE  processes per host (else the GPU count)
"""
import datetime
import logging
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

COORDINATOR_PORT_DEFAULT = 8476
# How long a collective, and the store's rendezvous, may wait for the
# other ranks before it raises.
TIMEOUT_SECONDS_DEFAULT = 600

ENV_NODE_RANK = 'SKYTPU_NODE_RANK'
ENV_NUM_NODES = 'SKYTPU_NUM_NODES'
ENV_NODE_IPS = 'SKYTPU_NODE_IPS'
ENV_COORDINATOR_PORT = 'SKYTPU_COORDINATOR_PORT'
ENV_COORDINATOR_ADDRESS = 'SKYTPU_COORDINATOR_ADDRESS'
ENV_NUM_CHIPS_PER_NODE = 'SKYTPU_NUM_CHIPS_PER_NODE'


def env_is_multihost() -> bool:
    return int(os.environ.get(ENV_NUM_NODES, '1')) > 1


def coordinator_address() -> Optional[str]:
    ips = os.environ.get(ENV_NODE_IPS, '').split()
    if not ips:
        return None
    port = os.environ.get(ENV_COORDINATOR_PORT,
                          str(COORDINATOR_PORT_DEFAULT))
    return f'{ips[0]}:{port}'


def store_address() -> str:
    """``SKYTPU_COORDINATOR_ADDRESS``, else the first host IP and the
    coordinator port, else this host at that port (a forced one-node
    run)."""
    explicit = os.environ.get(ENV_COORDINATOR_ADDRESS)
    if explicit:
        return explicit
    port = os.environ.get(ENV_COORDINATOR_PORT,
                          str(COORDINATOR_PORT_DEFAULT))
    return coordinator_address() or f'127.0.0.1:{port}'


def free_port() -> int:
    """A TCP port free on this host now, for a one-host store."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def local_world_size(device='cuda') -> int:
    """Processes on this host: ``SKYTPU_NUM_CHIPS_PER_NODE`` when set
    above 0, else the visible GPU count on ``cuda`` and 1 on ``cpu``."""
    n = int(os.environ.get(ENV_NUM_CHIPS_PER_NODE, '0') or 0)
    if n > 0:
        return n
    if torch.device(device).type == 'cuda':
        return torch.cuda.device_count()
    return 1


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's global rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def initialize(force: bool = False, local_rank: Optional[int] = None,
               device='cuda', init_method: Optional[str] = None,
               timeout_s: float = TIMEOUT_SECONDS_DEFAULT) -> bool:
    """Join the process group of the env contract; returns whether this
    call made it.

    No-op for a single process (one host, one process on it) unless
    ``force``; a second call is ignored. ``local_rank`` is this
    process's GPU on its host (required when the host runs more than
    one). On ``cuda`` the backend is NCCL, bound to GPU ``local_rank``,
    and a missing NCCL raises; on ``cpu`` it is gloo. ``init_method``
    replaces the contract's ``tcp://`` store (tests meet through a
    ``file://`` one)."""
    if is_initialized():
        logger.debug('torch.distributed already initialized.')
        return False
    local_world = local_world_size(device)
    num_nodes = int(os.environ.get(ENV_NUM_NODES, '1'))
    if num_nodes * local_world == 1 and not force:
        logger.debug('Single-process run; skipping init_process_group.')
        return False
    if local_rank is None:
        if local_world != 1:
            raise ValueError(
                f'{local_world} processes per host: pass local_rank (one '
                'process per GPU)')
        local_rank = 0
    if not 0 <= local_rank < local_world:
        raise ValueError(f'local_rank {local_rank} outside the host\'s '
                         f'{local_world} processes')
    rank = int(os.environ.get(ENV_NODE_RANK, '0')) * local_world + local_rank
    world = num_nodes * local_world
    if torch.device(device).type == 'cuda':
        if not dist.is_nccl_available():
            raise RuntimeError('device cuda needs the NCCL backend, which '
                               'this torch build lacks')
        torch.cuda.set_device(local_rank)
        backend = 'nccl'
    else:
        backend = 'gloo'
    init_method = init_method or f'tcp://{store_address()}'
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    logger.info('torch.distributed initialized: rank %d/%d (%s), store %s',
                rank, world, backend, init_method)
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()
