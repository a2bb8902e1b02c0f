"""Per-leaf sharding over a mesh — the port's counterpart of the JAX
package's ``NamedSharding`` trees (``sharding_tree``,
``skypilot_tpu/parallel/train.py:57-63``) and of the collectives GSPMD
derives from them.

A spec is written as JAX writes ``P(...)``: one entry per dim, None
(replicated), an axis name, or a tuple of axis names (sharded over
their product, the first axis major: ``('fsdp', 'ep')`` shards
fsdp-major). A rank holds the window of each dim given by its
coordinate on the dim's axes (:func:`window`); a dim its axes do not
divide raises, as JAX does.

XLA inserts a sharded program's collectives; here they are explicit.
:func:`gather` brings a leaf's dims sharded over the data axes
(``dp``/``fsdp``/``ep``) whole: ``all_gather_into_tensor`` forward and
``reduce_scatter_tensor`` (sum) backward, the FSDP gradient path that
DTensor's ``Shard → Replicate`` redistribution does not give (its
backward slices the replicated gradient without summing across ranks);
over a group of one rank the block is the whole dim, and nothing is
issued. A dim sharded over ``ep`` alone is an expert stack's expert
axis: it stays the rank's experts, and the tokens travel to them
instead (:meth:`Layout.to_experts` and :meth:`Layout.from_experts`, an
``all_to_all_single`` over ``ep`` each way: JAX's GShard dispatch).
Dims sharded over ``tp`` stay sharded: a layer runs Megatron-style on
the rank's heads and ffn columns, between :meth:`Layout.copy_to_tp`
(Megatron's *f*: identity forward, all-reduce over ``tp`` backward) and
:meth:`Layout.reduce_from_tp` (*g*: all-reduce forward, identity
backward). Every ``tp`` collective is an ``all_reduce``, never an
all-gather, so a gloo group can carry it between ranks that share one
GPU. At ``tp`` 1 both return their input and issue nothing.
:func:`all_reduce` sums over a set of axes. ``COLLECTIVES`` counts each
kind where it is issued, and nowhere else, so a run can hold the
collectives of a step against their identity.

The model axes that cut a batch row rather than a layer: ``sp`` splits
each row's tokens, so a layer's sums over tokens (the loss's count, the
MoE aux's means) and the gradients of every leaf run over the data axes
and ``sp`` together (:attr:`Layout.token_axes`); attention crosses the
ranks of ``sp`` as a ring (``ops/ring_attention.py``), whose K/V blocks
go to the next rank by ``comm.ring_exchange``. ``pp`` splits the stacked
``[L, ...]`` layers into stages (``parallel/pipeline.py``), whose
activations and their gradients go between neighbouring stages by
``comm.pp_exchange``. Both are point-to-point (``skypilot_torch/
comm.py``), counted in the same ``COLLECTIVES``.

:class:`Layout` is a state's place on the mesh (the spec trees of its
params and adapters, the rank's ``tp`` coordinate and head counts), and
:class:`ShardedLeaf` one local tensor with its global shape and window,
the form in which the checkpoint engine writes and reads a rank's part
of a leaf.
"""
import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from skypilot_torch.comm import COLLECTIVES
from skypilot_torch.parallel import mesh as mesh_lib

Spec = Tuple[Any, ...]
DATA_AXES = mesh_lib.data_axes()
# The process groups that :meth:`Layout.make_groups` has used once.
_WARM = set()


def _group_device(group) -> str:
    """Where a collective on ``group`` puts its tensors: the card for
    NCCL, the host for gloo."""
    if dist.get_backend(group) == 'nccl':
        return f'cuda:{torch.cuda.current_device()}'
    return 'cpu'




def dim_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in mesh order (a tuple out of
    mesh order raises: its rank order would not be the groups')."""
    if entry is None:
        return ()
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    unknown = [a for a in axes if a not in mesh_lib.AXES]
    if unknown:
        raise ValueError(f'unknown mesh axes {unknown} in spec entry '
                         f'{entry!r}')
    if list(axes) != sorted(axes, key=mesh_lib.AXES.index):
        raise ValueError(f'spec entry {entry!r}: axes must follow the '
                         f'mesh order {mesh_lib.AXES}')
    return axes


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec names, in mesh order."""
    named = {a for e in spec for a in dim_axes(e)}
    return tuple(a for a in mesh_lib.AXES if a in named)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """A rank's block shape of a leaf of global ``shape``."""
    if len(spec) > len(shape):
        raise ValueError(f'spec {spec} has more entries than shape '
                         f'{tuple(shape)} has dims')
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        n = 1
        for a in dim_axes(entry):
            n *= mesh_shape[a]
        if size % n:
            raise ValueError(
                f'dim {d} of shape {tuple(shape)} (size {size}) is not '
                f'divisible by the {n} shards of {entry!r}')
        out.append(size // n)
    return tuple(out)


def window(mesh, spec: Spec, shape: Sequence[int]) -> List[List[int]]:
    """This rank's ``[[start, stop], ...]`` of a leaf of global
    ``shape`` (the checkpoint format's index form)."""
    block = local_shape(shape, spec, mesh.shape)
    out = []
    for d, n in enumerate(block):
        entry = spec[d] if d < len(spec) else None
        i = mesh.index(dim_axes(entry))
        out.append([i * n, (i + 1) * n])
    return out


def local_slice(mesh, spec: Spec, full: torch.Tensor) -> torch.Tensor:
    """This rank's block of a whole tensor, as its own storage."""
    win = window(mesh, spec, full.shape)
    return full[tuple(slice(a, b) for a, b in win)].clone()


def replica_id(mesh, spec: Spec) -> int:
    """This rank's index among the ranks holding the same block (JAX's
    ``Shard.replica_id``): its position on the axes the spec does not
    name. Replica 0 writes the block to a checkpoint."""
    named = spec_axes(spec)
    return mesh.index([a for a in mesh_lib.AXES if a not in named])


def data_axes_of(entry) -> Tuple[str, ...]:
    return tuple(a for a in dim_axes(entry) if a in DATA_AXES)


def is_expert_axis(entry) -> bool:
    """A spec entry of ``ep`` alone: an expert stack's expert axis (the
    dense leaves fold ``ep`` into their fsdp group, ``('fsdp', 'ep')``)."""
    return entry == 'ep'


class _Gather(torch.autograd.Function):
    """All-gather of dim ``dim`` over ``group`` (forward) and the
    reduce-scatter (sum) of its gradient back to the block (backward).
    The collectives stack the ``n`` blocks on a new leading dim, which
    merges into ``dim``: a view where the blocks are already in place
    (``dim`` 0, or one block), else one copy. The whole tensor comes
    back contiguous, in the layout of the unsharded leaf's slice, so the
    products that read it run as they do on one device."""

    @staticmethod
    def forward(ctx, x, group, dim, n):
        ctx.group, ctx.dim, ctx.n = group, dim, n
        x = x.contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        COLLECTIVES.gathers += 1
        shape = list(x.shape)
        shape[dim] *= n
        return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(
            shape)

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim:ctx.dim + 1] = [ctx.n, shape[ctx.dim] // ctx.n]
        src = g.reshape(shape).movedim(ctx.dim, 0).contiguous()
        out = torch.empty(src.shape[1:], dtype=src.dtype,
                          device=src.device)
        dist.reduce_scatter_tensor(out, src.flatten(0, 1), group=ctx.group)
        COLLECTIVES.reduce_scatters += 1
        return out, None, None, None


def gather(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """``x`` (this rank's block) with every dim sharded over data axes
    made whole: one all-gather a dim, over the dim's data axes when they
    hold more than one rank. Their gradients reduce-scatter back to the
    block. An expert axis (:func:`is_expert_axis`) stays the rank's."""
    for d, entry in enumerate(spec):
        if is_expert_axis(entry):
            continue
        axes = data_axes_of(entry)
        if axes and mesh.size(axes) > 1:
            x = _Gather.apply(x, mesh.group(axes), d, mesh.size(axes))
    return x


def gather_tree(tree, mesh, specs):
    """:func:`gather` over a tree of leaves (an int8 ``{'q', 's'}``
    pair is a subtree) and its matching spec tree."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, mesh, specs[k]) for k, v in tree.items()}
    return gather(tree, mesh, specs)


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum ``x`` in place over the ranks that differ on ``axes``."""
    dist.all_reduce(x, group=mesh.group(tuple(axes)))
    COLLECTIVES.all_reduces += 1
    return x


class _TokenSum(torch.autograd.Function):
    """A sum over ``axes`` forward whose backward sums the gradient over
    them too: each rank's share of a function of the sum sends its part
    of the gradient to every rank's addend."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.mesh, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` in equal blocks of dim 0:
    block j goes to the group's rank j, and block i of the result came
    from rank i. Its adjoint is the same exchange, so the backward sends
    the gradient's blocks back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    COLLECTIVES.all_to_alls += 1
    return out


def all_to_all(x: torch.Tensor, mesh, axes: Sequence[str] = ('ep',)
               ) -> torch.Tensor:
    """:class:`_AllToAll` over the ranks that differ on ``axes``."""
    return _AllToAll.apply(x, mesh.group(tuple(axes)))


def tp_all_reduce(x: torch.Tensor, mesh,
                  op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``x`` in place over this rank's ``tp`` group."""
    dist.all_reduce(x, op=op, group=mesh.group(('tp',)))
    COLLECTIVES.tp_reduces += 1
    return x


class _CopyToTP(torch.autograd.Function):
    """Megatron's *f*: the identity forward; the gradient all-reduced
    over ``tp`` backward (each rank's column-parallel products give a
    part of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp_all_reduce(g.clone(memory_format=torch.contiguous_format),
                             ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's *g*: the row-parallel partial sums all-reduced over
    ``tp`` forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return tp_all_reduce(x.clone(memory_format=torch.contiguous_format),
                             mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_heads(config, tp: int) -> Tuple[int, int]:
    """(query heads, kv heads) of one ``tp`` rank. A Megatron layer
    splits whole heads, so both counts must divide by ``tp`` (GSPMD
    would split inside a head)."""
    if config.n_heads % tp or config.n_kv_heads % tp:
        raise ValueError(
            f'{config.name}: {config.n_heads} query / {config.n_kv_heads} '
            f'kv heads do not split over tp {tp}: each tp rank runs whole '
            'heads')
    return config.n_heads // tp, config.n_kv_heads // tp


def map_specs(fn: Callable, tree, specs, path: Tuple[str, ...] = (),
              flat: bool = False):
    """``tree`` with each leaf replaced by ``fn(path, leaf, spec)``; with
    ``flat``, the concatenation of the lists ``fn`` returns, in
    sorted-key order."""
    if isinstance(tree, dict):
        if flat:
            return list(itertools.chain.from_iterable(
                map_specs(fn, tree[k], specs[k], path + (k,), True)
                for k in sorted(tree)))
        return {k: map_specs(fn, v, specs[k], path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, specs)


def strip_lead(specs):
    """A spec tree with each spec's first entry dropped: the specs of
    one layer's slices of stacked ``[L, ...]`` leaves."""
    if isinstance(specs, dict):
        return {k: strip_lead(v) for k, v in specs.items()}
    return tuple(specs[1:])


@dataclasses.dataclass(frozen=True)
class ShardedLeaf:
    """This rank's block of a leaf: ``data`` is the local tensor,
    ``shape`` the global shape; ``index`` its window and ``replica_id``
    its replica (both from the mesh coordinate)."""
    data: torch.Tensor
    mesh: Any
    spec: Spec
    shape: Tuple[int, ...]

    @property
    def index(self) -> List[List[int]]:
        return window(self.mesh, self.spec, self.shape)

    @property
    def replica_id(self) -> int:
        return replica_id(self.mesh, self.spec)

    @property
    def sharding(self) -> str:
        """Names the mesh plan and spec; a restore compares it with the
        saved one to tell a reshard."""
        return (f'mesh={mesh_lib.describe_config(self.mesh.config)} '
                f'spec={tuple(self.spec)!r}')


def global_shape(x: torch.Tensor, spec: Spec,
                 mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """The global shape of a rank's block ``x``."""
    out = []
    for d, n in enumerate(x.shape):
        entry = spec[d] if d < len(spec) else None
        for a in dim_axes(entry):
            n *= mesh_shape[a]
        out.append(n)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A state's place on ``mesh``: the spec trees of its params and
    (LoRA) adapters. ``trainable`` is the tree the step trains
    (``train.opt_state_shardings`` puts the moments on its specs). A
    serving layout (``models/decode.py``) has the params' specs alone."""
    mesh: Any
    params: Dict[str, Any]
    lora: Optional[Dict[str, Any]] = None

    @property
    def trainable(self) -> Dict[str, Any]:
        return self.params if self.lora is None else self.lora

    def gather(self, tree, specs):
        """:func:`gather_tree` on this layout's mesh."""
        return gather_tree(tree, self.mesh, specs)

    def layer_specs(self):
        """(params, lora) spec trees of one layer's slices of the
        stacked ``[L, ...]`` leaves."""
        return (strip_lead(self.params['layers']),
                None if self.lora is None else strip_lead(self.lora))

    @property
    def tp(self) -> int:
        """The ``tp`` size of the mesh (1: no tensor parallelism)."""
        return self.mesh.shape['tp']

    @property
    def tp_index(self) -> int:
        """This rank's coordinate on ``tp``."""
        return self.mesh.coordinate['tp']

    def heads(self, config) -> Tuple[int, int]:
        """(query heads, kv heads) of this rank (:func:`tp_heads`)."""
        return tp_heads(config, self.tp)

    def vocab_window(self, vocab: int) -> Tuple[int, int]:
        """[start, stop) of the vocabulary rows this rank holds."""
        n = vocab // self.tp
        return self.tp_index * n, (self.tp_index + 1) * n

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed in place over this rank's ``tp`` group."""
        return tp_all_reduce(x, self.mesh)

    def tp_max(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` maxed in place over this rank's ``tp`` group."""
        return tp_all_reduce(x, self.mesh, dist.ReduceOp.MAX)

    def tp_min(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` minimized in place over this rank's ``tp`` group."""
        return tp_all_reduce(x, self.mesh, dist.ReduceOp.MIN)

    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        """*f* on ``x`` (``x`` itself at tp 1)."""
        return x if self.tp == 1 else _CopyToTP.apply(x, self.mesh)

    def reduce_from_tp(self, x: torch.Tensor) -> torch.Tensor:
        """*g* on ``x`` (``x`` itself at tp 1). Every caller hands it a
        fresh product, so with no autograd to record (serving) ``x`` is
        summed in place, without the Function's copy."""
        if self.tp == 1:
            return x
        if not torch.is_grad_enabled():
            return self.tp_sum(x)
        return _ReduceFromTP.apply(x, self.mesh)

    @property
    def token_axes(self) -> Tuple[str, ...]:
        """The axes a batch's tokens are split over: the data axes (its
        rows) and, above 1, ``sp`` (each row's positions)."""
        return DATA_AXES + (('sp',) if self.sp > 1 else ())

    def token_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over :attr:`token_axes` (a copy; ``x`` is kept)."""
        return all_reduce(x.clone(), self.mesh, self.token_axes)

    def loss_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' loss shares ``x`` summed into the loss: over the
        token axes, and over ``pp`` where it is above 1 (the last stage
        holds the CE, every stage its layers' MoE aux)."""
        axes = self.token_axes + (('pp',) if self.pp > 1 else ())
        return all_reduce(x.clone(), self.mesh, axes)

    @property
    def token_ranks(self) -> int:
        """The ranks that split a batch's tokens (dp x fsdp x ep x sp)."""
        return self.mesh.size(self.token_axes)

    def token_sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over :attr:`token_axes`, its gradient summed over
        them too (:class:`_TokenSum`); ``x`` itself on one rank."""
        if self.token_ranks == 1:
            return x
        return _TokenSum.apply(x, self.mesh, self.token_axes)

    @property
    def sp(self) -> int:
        """The ``sp`` size of the mesh (1: whole rows on each rank)."""
        return self.mesh.shape['sp']

    @property
    def sp_index(self) -> int:
        """This rank's coordinate on ``sp``: its rows' positions are
        ``[sp_index T / sp, (sp_index + 1) T / sp)``."""
        return self.mesh.coordinate['sp']

    def sp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed in place over this rank's ``sp`` group."""
        return all_reduce(x, self.mesh, ('sp',))

    @property
    def pp(self) -> int:
        """The ``pp`` size of the mesh (1: every layer on each rank)."""
        return self.mesh.shape['pp']

    @property
    def pp_index(self) -> int:
        """This rank's stage: its ``L / pp`` layers follow those of stage
        ``pp_index - 1``."""
        return self.mesh.coordinate['pp']

    def grad_axes(self, spec: Spec, tp_partial: bool = False
                  ) -> Tuple[str, ...]:
        """The axes over which the gradient of a trainable leaf with
        ``spec`` is summed after the backward: the token axes it is
        replicated on (its sharded data axes were reduce-scattered by
        the gather), ``pp`` where it is replicated over stages (the
        embedding and the head: one stage computes their gradient), and
        ``tp`` for a ``tp_partial`` one (``lora.TP_PARTIAL_GRADS``)."""
        named = spec_axes(spec)
        axes = {a for a in self.token_axes if a not in named}
        if self.pp > 1 and 'pp' not in named:
            axes.add('pp')
        if tp_partial:
            axes.add('tp')
        return tuple(a for a in mesh_lib.AXES if a in axes)

    def norm_axes(self, spec: Spec) -> Tuple[str, ...]:
        """The axes over which the squares of a gradient block with
        ``spec`` are summed for the global norm: the data axes it names,
        and ``tp`` and ``pp`` where they are above 1 (a replicated leaf
        counts once)."""
        return tuple(a for a in spec_axes(spec)
                     if a in DATA_AXES or (a in ('tp', 'pp') and
                                           self.mesh.shape[a] > 1))

    def make_groups(self) -> None:
        """Make, in one order on every rank, each process group a step
        may use: the gathers', the gradient sums' and the norm's (from
        the specs), and the fixed ones (``tp``, ``sp``, ``pp``, ``ep``,
        the token axes). A pipeline stage reaches its groups in an order
        of its own (the first stage alone embeds), and making a group is
        a collective call, so they are all made up front; each is then
        used once, so that an NCCL communicator exists before the
        point-to-point calls on it."""
        sets = {('tp',), ('sp',), ('pp',), ('ep',), DATA_AXES,
                self.token_axes}
        for tree in (self.params, self.lora):
            if tree is None:
                continue
            for spec in map_specs(lambda _, s, __: [tuple(s)], tree, tree,
                                  flat=True):
                sets.update(data_axes_of(e) for e in spec)
                sets.update((self.grad_axes(spec), self.grad_axes(spec, True),
                             self.norm_axes(spec)))
        for axes in sorted(a for a in sets if a):
            group = self.mesh.group(axes)
            if id(group) not in _WARM:
                dist.all_reduce(torch.zeros(1, device=_group_device(group)),
                                group=group)
                _WARM.add(id(group))

    @property
    def ep(self) -> int:
        """The ``ep`` size of the mesh (1: every rank holds every
        expert)."""
        return self.mesh.shape['ep']

    def to_experts(self, x: torch.Tensor) -> torch.Tensor:
        """An MoE dispatch buffer ``[E, R, ...]`` (this rank's R slot
        rows of every expert) to ``[E / ep, ep R, ...]``: the rank's
        experts with the rows of every rank of its ``ep`` group, in ``ep``
        order (JAX's ``P('ep', ('dp', 'fsdp'))`` on the dispatch). One
        all-to-all over ``ep``; ``x`` itself at ep 1."""
        ep = self.ep
        if ep == 1:
            return x
        e, r = x.shape[:2]
        y = all_to_all(x, self.mesh)            # [ep (source), E/ep, R, ..]
        return y.view((ep, e // ep) + tuple(x.shape[1:])).transpose(
            0, 1).reshape((e // ep, ep * r) + tuple(x.shape[2:]))

    def from_experts(self, y: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`to_experts`: the experts' output rows sent
        back to the ranks whose tokens they are, ``[E / ep, ep R, ...]``
        to ``[E, R, ...]``."""
        ep = self.ep
        if ep == 1:
            return y
        el, rr = y.shape[:2]
        rest = tuple(y.shape[2:])
        blocks = y.view((el, ep, rr // ep) + rest).transpose(0, 1)
        return all_to_all(blocks, self.mesh).view((ep * el, rr // ep) +
                                                  rest)

    def local_batch(self, batch: Dict[str, torch.Tensor],
                    micro: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """This rank's part of a global batch of ``[B, T + 1]`` token
        rows (and their ``loss_mask``): its rows, by its position on the
        data axes, ``dp`` major (JAX's ``P(('dp', 'fsdp', 'ep'))``), and
        at ``sp`` > 1 its ``T / sp`` positions of each, with the next
        token after them, so that ``tokens[:, :-1]`` are its inputs and
        ``tokens[:, 1:]`` their targets (JAX's ``P(..., 'sp')`` on the
        inputs and targets). With ``micro`` (a pipeline's microbatch
        count M) the rows are taken microbatch by microbatch: microbatch
        m is the global rows ``[m B / M, (m + 1) B / M)``, as JAX splits
        them, and the rank's part of it is its position's share of them;
        the rank's rows come out microbatch-major."""
        first = next(iter(batch.values()))
        n = self.mesh.size(DATA_AXES)
        i = self.mesh.index(DATA_AXES)
        if micro is None:
            b = mesh_lib.batch_size_per_device(first.shape[0], self.mesh)
            out = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        else:
            rows = first.shape[0]
            if rows % (micro * n):
                raise ValueError(
                    f'batch {rows} not divisible by num_micro={micro} x '
                    f'the data-parallel degree {n}')
            b = rows // (micro * n)
            out = {k: v.reshape((micro, n, b) + tuple(v.shape[1:]))[:, i]
                   .reshape((micro * b,) + tuple(v.shape[1:]))
                   for k, v in batch.items()}
        if self.sp > 1:
            t = first.shape[1] - 1
            if t % self.sp:
                raise ValueError(f'sequence {t} not divisible by sp='
                                 f'{self.sp}')
            n = t // self.sp
            j = self.sp_index * n
            out = {k: v[:, j:j + n + 1] for k, v in out.items()}
        return out

    def wrap(self, tree, specs):
        """``tree`` with each tensor leaf as a :class:`ShardedLeaf`."""
        return map_specs(lambda _, x, s: ShardedLeaf(
            x, self.mesh, tuple(s), global_shape(x, s, self.mesh.shape)),
            tree, specs)


def window_fn(mesh, specs) -> Callable:
    """``fn(path, shape) -> tuple of slices``: this rank's window of the
    leaf at ``path`` (its spec in ``specs``) of global ``shape``, for
    inits that draw a whole leaf and keep a block."""
    def fn(path, shape):
        spec = specs
        for k in path:
            spec = spec[k]
        return tuple(slice(a, b) for a, b in window(mesh, spec, shape))
    return fn


def unwrap(tree):
    """Inverse of :meth:`Layout.wrap`: (plain tree, spec tree or None,
    mesh or None)."""
    if isinstance(tree, ShardedLeaf):
        return tree.data, tree.spec, tree.mesh
    if isinstance(tree, dict):
        parts = {k: unwrap(v) for k, v in tree.items()}
        meshes = [m for _, _, m in parts.values() if m is not None]
        data = {k: d for k, (d, _, _) in parts.items()}
        if not meshes:
            return data, None, None
        return data, {k: s for k, (_, s, _) in parts.items()}, meshes[0]
    return tree, None, None
