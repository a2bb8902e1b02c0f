"""The six-axis process mesh — the port of
``skypilot_tpu/parallel/mesh.py``.

Axes (fixed order, outer→inner): ``pp`` (pipeline stages), ``dp``
(pure data parallel; the axis that spans slices), ``fsdp`` (data
parallel with weight sharding, ZeRO-3), ``ep`` (expert parallel; an
extra data/weight-shard axis for non-expert params), ``tp`` (tensor
parallel), ``sp`` (sequence parallel). The plan arithmetic
(``MeshConfig``, ``auto_mesh_config``, ``replan_mesh_config``,
``rescale_global_batch``, ...) is a copy of the JAX module's. A device
there is a rank here (one process per GPU, ``parallel/distributed.py``),
and :func:`make_mesh` lays the ranks out as JAX lays out its device
list: a row-major reshape over the axes, so with ``num_slices > 1`` the
``dp`` axis spans the slices (ranks are slice-major by the env
contract).
"""
import dataclasses
import math
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch.distributed as dist

AXES = ('pp', 'dp', 'fsdp', 'ep', 'tp', 'sp')


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return (self.pp * self.dp * self.fsdp * self.ep * self.tp *
                self.sp)

    def shape(self):
        return {'pp': self.pp, 'dp': self.dp, 'fsdp': self.fsdp,
                'ep': self.ep, 'tp': self.tp, 'sp': self.sp}


def num_slices_from_env() -> int:
    """Slice count from the runtime's env contract
    (SKYTPU_NUM_SLICES, set by the gang driver for multi-slice jobs;
    1 otherwise)."""
    return int(os.environ.get('SKYTPU_NUM_SLICES', '1'))


def _world_size() -> int:
    return dist.get_world_size() if (dist.is_available() and
                                     dist.is_initialized()) else 1


def auto_mesh_config(n_devices: Optional[int] = None,
                     tp: int = 1, sp: int = 1,
                     dp: int = 1, ep: int = 1, pp: int = 1,
                     num_slices: int = 1) -> MeshConfig:
    """Default strategy: everything not claimed by pp/tp/sp/dp/ep goes
    to fsdp. ``n_devices`` defaults to the process group's world size
    (1 without a group).

    ``num_slices`` > 1: dp is raised to (a multiple of) the slice
    count so the cross-slice axis exists — only pure-DP gradient
    all-reduces may cross slices.
    """
    if n_devices is None:
        n_devices = _world_size()
    if num_slices > 1 and dp % num_slices != 0:
        dp = dp * num_slices
    claimed = tp * sp * dp * ep * pp
    if n_devices % claimed != 0:
        raise ValueError(
            f'n_devices={n_devices} not divisible by tp*sp*dp*ep*pp='
            f'{claimed}')
    return MeshConfig(pp=pp, dp=dp, fsdp=n_devices // claimed, ep=ep,
                      tp=tp, sp=sp)


def rank_grid(config: MeshConfig) -> np.ndarray:
    """The global ranks laid out over ``AXES``: the row-major reshape
    the JAX ``make_mesh`` applies to its device list."""
    return np.arange(config.num_devices).reshape(
        config.pp, config.dp, config.fsdp, config.ep, config.tp,
        config.sp)


class Mesh:
    """The process mesh: every rank laid out over ``AXES`` (``grid``),
    this rank's coordinate on it, and the process group of any set of
    its axes (:meth:`group`).

    ``shape`` maps each axis to its size, as a JAX ``Mesh.shape``
    does."""

    def __init__(self, config: MeshConfig):
        self.config = config
        self.grid = rank_grid(config)
        self.shape: Dict[str, int] = config.shape()
        where = np.argwhere(self.grid == dist.get_rank())[0]
        self.coordinate: Dict[str, int] = dict(zip(AXES, map(int, where)))
        self._groups: Dict[Tuple[str, ...], dist.ProcessGroup] = {}

    def size(self, axes: Iterable[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: Iterable[str]) -> int:
        """This rank's position among the ranks that differ from it only
        on ``axes``, the first axis major (the rank order of
        :meth:`group`)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coordinate[a]
        return i

    def group(self, axes: Tuple[str, ...]) -> dist.ProcessGroup:
        """The process group of the ranks that differ from this one only
        on ``axes`` (in mesh order), made on first use. Every rank must
        ask for the same axes in the same order: making a group is a
        collective call."""
        axes = tuple(a for a in AXES if a in axes)
        if axes not in self._groups:
            keep = [AXES.index(a) for a in axes]
            rest = [i for i in range(len(AXES)) if i not in keep]
            blocks = np.transpose(self.grid, rest + keep).reshape(
                -1, self.size(axes))
            self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                [sorted(map(int, b)) for b in blocks])
        return self._groups[axes]

    def __repr__(self) -> str:
        return f'Mesh({describe_config(self.config)})'


def make_mesh(config: Optional[MeshConfig] = None,
              num_slices: int = 1) -> Mesh:
    """The mesh over every rank of the initialized process group
    (``distributed.initialize``): ``config`` defaults to
    ``auto_mesh_config()``; its device count must be the world size.
    With ``num_slices`` > 1, ``dp`` must be a multiple of it (the only
    axis whose collectives may cross slices). The groups are made on
    first use, on the group's backend (NCCL on ``cuda``, gloo on
    ``cpu``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('make_mesh needs an initialized process group '
                           '(parallel.distributed.initialize)')
    world = dist.get_world_size()
    if config is None:
        config = auto_mesh_config(world)
    if config.num_devices != world:
        raise ValueError(
            f'Mesh needs {config.num_devices} devices, got {world}')
    if num_slices > 1 and config.dp % num_slices != 0:
        raise ValueError(
            f'dp={config.dp} must be a multiple of num_slices='
            f'{num_slices}: dp is the only axis whose collectives '
            'may cross slices')
    return Mesh(config)


def describe_config(config: MeshConfig) -> str:
    """Compact human string for a mesh plan, e.g. ``8c:dp2.fsdp4``
    (device count, then every non-1 axis) — for log lines and
    errors."""
    axes = '.'.join(f'{a}{getattr(config, a)}' for a in AXES
                    if getattr(config, a) > 1)
    return f'{config.num_devices}c:{axes}' if axes else \
        f'{config.num_devices}c'


def replan_mesh_config(config: MeshConfig,
                       n_devices: int) -> MeshConfig:
    """Re-plan a PINNED mesh config for a DIFFERENT device count
    (elastic resume).

    Model-parallel axes (pp/tp/sp/ep) are preserved, and the data axes
    absorb the change: ``dp`` shrinks (or grows) first; only when the
    remaining devices cannot sustain the old ``fsdp`` degree does
    ``fsdp`` shrink too, keeping per-device weight and optimizer memory
    constant across the resize.

    Raises ``ValueError`` when the model axes do not divide
    ``n_devices``.
    """
    model = config.pp * config.tp * config.sp * config.ep
    if n_devices < 1 or n_devices % model != 0:
        raise ValueError(
            f'cannot re-plan mesh {describe_config(config)} for '
            f'{n_devices} devices: model-parallel degree '
            f'pp*tp*sp*ep={model} does not divide it')
    data_total = n_devices // model
    if data_total % config.fsdp == 0:
        fsdp = config.fsdp
    else:
        # Largest divisor of data_total that is <= the old fsdp: keep
        # as much weight sharding as the new device count sustains.
        fsdp = max(d for d in range(1, min(config.fsdp,
                                           data_total) + 1)
                   if data_total % d == 0)
    return MeshConfig(pp=config.pp, dp=data_total // fsdp, fsdp=fsdp,
                      ep=config.ep, tp=config.tp, sp=config.sp)


def rescale_global_batch(global_batch: int, old_config: MeshConfig,
                         new_config: MeshConfig) -> int:
    """Global batch for the re-planned mesh, holding the PER-DEVICE
    batch constant. Result is a positive multiple of the new
    data-parallel degree."""
    old_n = math.prod(getattr(old_config, a) for a in data_axes())
    new_n = math.prod(getattr(new_config, a) for a in data_axes())
    if global_batch % old_n != 0:
        raise ValueError(
            f'global batch {global_batch} not divisible by the old '
            f'data-parallel degree {old_n}')
    return (global_batch // old_n) * new_n


def data_axes():
    """Mesh axes the batch dimension is sharded over (ep doubles as a
    data axis outside the expert computation — GShard layout)."""
    return ('dp', 'fsdp', 'ep')


def batch_size_per_device(global_batch: int, mesh) -> int:
    n = math.prod(mesh.shape[a] for a in data_axes())
    if global_batch % n != 0:
        raise ValueError(
            f'global batch {global_batch} not divisible by data-'
            f'parallel degree {n}')
    return global_batch // n
