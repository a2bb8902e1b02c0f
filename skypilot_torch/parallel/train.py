"""The train step — the port of ``skypilot_tpu/parallel/train.py``.

``build_train_step(config, optimizer, lora_scale)`` returns
``step(state, batch) -> (state, {'loss', 'grad_norm'})``: the loss
(``llama.loss_fn``), its gradient by autograd, then clip-by-global-norm
and AdamW, written out here so the optimizer state has optax's exact
dtypes (``mu`` f32, ``nu`` in the param dtype; ``torch.optim.AdamW``
keeps both in the param dtype). LoRA trains the adapters over a frozen
base; without LoRA every param trains. ``init_qlora_state`` makes that
frozen base int8 (QLoRA): the same step runs over it, autograd going
through ``llama.matmul``'s dequant to the adapters only.
``instrument_train_step`` wraps a step with the JAX package's step
metrics, goodput and MFU, the ``train.step`` span and the on-demand
profiler. ``TrainState.checkpoint_tree`` maps the state onto the JAX
``TrainState``'s tree for the native checkpoint engine.

Over a mesh (``parallel/mesh.py``; ``init_train_state(mesh=...)``)
every leaf of the state is this rank's block under
``llama.param_sharding_rules`` / ``lora.lora_sharding_rules`` /
``quantized_sharding_rules`` (``TrainState.layout``), and the step is
FSDP/DP over the data axes, Megatron tensor parallel over ``tp`` and
expert parallel over ``ep``: the global batch is split over the data
axes (dp, fsdp, ep; the ranks of a ``tp`` group take the same rows),
each layer's blocks are gathered over the data axes inside its
checkpointed call and their gradients reduce-scattered back
(``parallel/sharding.gather``), but for the expert stacks' expert axis,
which stays the rank's: an MoE layer sends its dispatched tokens to the
experts' ranks over ``ep`` and their outputs back, and its aux loss
takes its means over the global batch (``models/llama.py``
``_moe_mlp``); each layer runs on the rank's heads and ffn columns
between *f* and *g*, the embedding and the fused CE run on the rank's
vocabulary window, the gradients of leaves replicated over a data axis
are all-reduced over it (an expert stack, sharded over ``ep``, over
``dp`` only; the adapters' A factors, whose gradients come back
partial, over ``tp`` too), the loss is the global masked mean, the
global norm counts each element once, and AdamW runs on the blocks.
``plan_train_state`` gives the per-device bytes of a mesh plan on the
meta device.

Over ``sp`` each rank takes its ``T / sp`` positions of its rows
(``Layout.local_batch``) and attention is the ring
(``ops/ring_attention.py``); the params are replicated over ``sp``, so
their gradients, the loss's count and the MoE aux's means are summed
over ``sp`` as over the data axes (``Layout.token_axes``). Over ``pp``
the stacked layers shard into stages and the step runs a GPipe or 1F1B
schedule of ``pipeline_microbatches`` microbatches
(``parallel/pipeline.py``); the embedding and head gradients, computed
on one stage, are summed over ``pp``.
"""
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama, quant
from skypilot_torch.parallel import distributed
from skypilot_torch.parallel import lora as lora_lib
from skypilot_torch.parallel import mesh as mesh_lib
from skypilot_torch.parallel import pipeline as pipeline_lib
from skypilot_torch.parallel import sharding

Params = llama.Params


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and the moments, trees
    shaped like the trainable params."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: AdamState
    # When LoRA-finetuning, params are frozen and only `lora` trains.
    lora: Optional[Params] = None
    # Over a mesh: the leaves are this rank's blocks, placed by these
    # specs (None: every leaf whole on one device).
    layout: Optional[sharding.Layout] = None

    def checkpoint_tree(self) -> Dict[str, Any]:
        """The JAX ``TrainState``'s tree, which the native checkpoint
        engine (``checkpoint/native.py``) writes under its tree-path
        keys: ``step`` and AdamW's ``count`` as int32 scalars (JAX keeps
        both as int32 arrays), and the optimizer state nested as
        ``optax.chain(clip_by_global_norm, adamw)`` nests it — (the
        clip's empty state, (``ScaleByAdamState(count, mu, nu)``,
        ``add_decayed_weights``' and ``scale_by_learning_rate``'s empty
        states)) — so its keys are ``opt_state/1/0/{count,mu,nu}/...``.
        ``lora`` is None (no leaves) in a full finetune. Over a mesh each
        tensor leaf is a ``sharding.ShardedLeaf``: the engine writes this
        rank's block at its global window."""
        opt = self.opt_state
        params, lora, mu, nu = self.params, self.lora, opt.mu, opt.nu
        lay = self.layout
        if lay is not None:
            params = lay.wrap(params, lay.params)
            lora = None if lora is None else lay.wrap(lora, lay.lora)
            opt_specs = opt_state_shardings(lay.trainable)
            mu = lay.wrap(mu, opt_specs['mu'])
            nu = lay.wrap(nu, opt_specs['nu'])
        adam = {'count': np.asarray(opt.count, np.int32), 'mu': mu,
                'nu': nu}
        return {'step': np.asarray(self.step, np.int32),
                'params': params, 'opt_state': ((), (adam, (), ())),
                'lora': lora}

    @classmethod
    def from_checkpoint_tree(cls, tree: Dict[str, Any]) -> 'TrainState':
        """Inverse of :meth:`checkpoint_tree`."""
        adam = tree['opt_state'][1][0]
        params, param_specs, mesh = sharding.unwrap(tree['params'])
        lora, lora_specs, _ = sharding.unwrap(tree['lora'])
        layout = None if mesh is None else sharding.Layout(
            mesh, param_specs, lora_specs)
        return cls(step=int(tree['step']), params=params,
                   opt_state=AdamState(
                       count=int(adam['count']),
                       mu=sharding.unwrap(adam['mu'])[0],
                       nu=sharding.unwrap(adam['nu'])[0]),
                   lora=lora, layout=layout)


def _leaves(tree: Params, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) pairs in sorted-key order — jax.tree_util's leaf
    order, so sums over leaves run in the reference's order."""
    out = []
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            out += _leaves(node, prefix + (key,))
        else:
            out.append((prefix + (key,), node))
    return out


def _tree(pairs) -> Params:
    """Inverse of :func:`_leaves`."""
    tree: Params = {}
    for path, x in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return tree


def _get(tree: Params, path: Tuple[str, ...]) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    return tree


def global_norm(grads: List[torch.Tensor],
                layout: Optional[sharding.Layout] = None,
                specs: Optional[List[Any]] = None) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum over leaves of sum(g*g),
    each in the gradient's own dtype. With a ``layout`` the grads are
    blocks with these ``specs``: each block's sum of squares is summed
    over the ranks of its shard group (``Layout.norm_axes``: the data
    axes its spec names, and ``tp`` and ``pp`` where they are above 1;
    one all-reduce per group and dtype), and a replicated leaf counts
    once."""
    sqs = [torch.sum(g * g) for g in grads]
    if layout is not None:
        groups: Dict[Any, List[int]] = {}
        for i, (sq, spec) in enumerate(zip(sqs, specs)):
            axes = layout.norm_axes(spec)
            if axes:
                groups.setdefault((axes, sq.dtype), []).append(i)
        for (axes, _), idx in groups.items():
            summed = sharding.all_reduce(
                torch.stack([sqs[i] for i in idx]), layout.mesh, axes)
            for j, i in enumerate(idx):
                sqs[i] = summed[j]
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...,
    mu_dtype=f32))``, the reference's ``default_optimizer``, with the
    same operation order and dtypes on every leaf."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0

    def init(self, params: Params) -> AdamState:
        leaves = _leaves(params)
        return AdamState(
            count=0,
            mu=_tree((p, torch.zeros_like(x, dtype=torch.float32))
                     for p, x in leaves),
            nu=_tree((p, torch.zeros_like(x)) for p, x in leaves))

    def update(self, grads: Params, state: AdamState, params: Params,
               g_norm: torch.Tensor) -> Tuple[Params, AdamState]:
        """One step from raw ``grads`` whose global norm is ``g_norm``:
        returns (new params, new state). Nothing is updated in place."""
        count = state.count + 1
        # optax: 1 - decay ** count in f32, then cast to the moment's
        # dtype before the division.
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
        keep = g_norm < self.grad_clip  # stays on the device: no sync
        mus, nus = dict(_leaves(state.mu)), dict(_leaves(state.nu))
        new_p, new_mu, new_nu = [], [], []
        for path, g in _leaves(grads):
            p = _get(params, path)
            g = torch.where(keep, g, (g / g_norm.to(g.dtype)) *
                            self.grad_clip)
            mu = (1 - self.b1) * g + self.b1 * mus[path]
            nu = (1 - self.b2) * (g ** 2) + self.b2 * nus[path]
            mu_hat = mu / bc1.to(device=mu.device, dtype=mu.dtype)
            nu_hat = nu / bc2.to(device=nu.device, dtype=nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + self.weight_decay * p
            u = -self.learning_rate * u
            new_p.append((path, (p + u).to(p.dtype)))
            new_mu.append((path, mu.to(torch.float32)))
            new_nu.append((path, nu))
        return _tree(new_p), AdamState(count, _tree(new_mu), _tree(new_nu))


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1, b1: float = 0.9,
                      b2: float = 0.95, grad_clip: float = 1.0) -> AdamW:
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 b1=b1, b2=b2, grad_clip=grad_clip)


def quantized_sharding_rules(config: llama.LlamaConfig,
                             pipeline: bool = False) -> Params:
    """``llama.param_sharding_rules`` mapped onto an int8 tree (the JAX
    ``quantized_sharding_rules``): ``{'q', 's'}`` pairs for the big
    matmuls and the LM head (``quant.init_quantized``'s structure), the
    codes on the weight's spec and the scale on ``_scale_spec``; the
    stacked layer axis over 'pp' with ``pipeline``."""
    rules = llama.param_sharding_rules(config, pipeline=pipeline)
    out = dict(rules)
    layers = dict(rules['layers'])
    for name in quant._LAYER_MATMULS:  # pylint: disable=protected-access
        if name in layers:
            layers[name] = {'q': layers[name],
                            's': _scale_spec(layers[name])}
    out['layers'] = layers
    if 'lm_head' in rules:
        out['lm_head'] = {'q': rules['lm_head'],
                          's': _scale_spec(rules['lm_head'])}
    return out


def _scale_spec(spec) -> tuple:
    """The spec of a quantized weight's per-output-channel scale (the
    weight's shape with the contracted axis collapsed to 1): the
    weight's, with that size-1 axis unsharded."""
    parts = list(spec)
    if len(parts) >= 2:
        parts[-2] = None
    return tuple(parts)


def opt_state_shardings(trainable_specs: Params) -> Dict[str, Any]:
    """The specs of AdamW's state: ``count`` replicated, and each moment
    on its param's spec BY TREE PATH (``mu``/``nu`` mirror the trainable
    tree key for key). A shape match would not do: wq and wo share a
    shape but not a spec (JAX ``opt_state_shardings``)."""
    return {'count': (), 'mu': trainable_specs, 'nu': trainable_specs}


def _layout(config: llama.LlamaConfig, mesh, lora: bool,
            quantized: bool = False) -> sharding.Layout:
    """The state's layout on ``mesh`` (a ``mesh.Mesh``, or a
    ``MeshConfig`` for a plan): refuses a ``tp`` that does not split the
    heads and a ``pp`` that does not split the layers; at ``pp`` > 1 the
    stacked layer axis shards over it."""
    shape = _mesh_shape(mesh)
    sharding.tp_heads(config, shape['tp'])
    pipeline = shape['pp'] > 1
    if pipeline:
        pipeline_lib.validate_pipeline_config(config, shape)
    rules = (quantized_sharding_rules(config, pipeline) if quantized
             else llama.param_sharding_rules(config, pipeline))
    return sharding.Layout(
        mesh, rules,
        lora_lib.lora_sharding_rules(config, pipeline) if lora else None)


def _mesh_shape(mesh) -> Dict[str, int]:
    return mesh.shape() if isinstance(mesh, mesh_lib.MeshConfig) \
        else mesh.shape


def plan_train_state(config: llama.LlamaConfig, mesh,
                     optimizer: Optional[AdamW] = None,
                     param_dtype: torch.dtype = torch.float32,
                     lora_rank: Optional[int] = None) -> Dict[str, Any]:
    """The train state's plan over ``mesh`` (a ``mesh.Mesh`` or just a
    ``MeshConfig``) WITHOUT allocating anything: the state is built on
    the meta device. Returns ``{'leaves': {key: {shape, spec,
    local_shape, dtype, bytes}}, 'state_bytes', 'grad_bytes',
    'device_bytes'}``, bytes per device: the state's blocks, the
    gradients of the trainable blocks, and their sum (activations not
    counted). Keys are the checkpoint's (``opt_state/1/0/mu/...``)."""
    shape = _mesh_shape(mesh)
    state = init_train_state(config, optimizer=optimizer,
                             param_dtype=param_dtype, lora_rank=lora_rank,
                             device='meta')
    layout = _layout(config, mesh, lora_rank is not None)
    opt_specs = opt_state_shardings(layout.trainable)
    trees = [('params', state.params, layout.params),
             ('lora', state.lora, layout.lora),
             ('opt_state/1/0/mu', state.opt_state.mu, opt_specs['mu']),
             ('opt_state/1/0/nu', state.opt_state.nu, opt_specs['nu'])]
    leaves = {}
    for prefix, tree, specs in trees:
        if tree is None:
            continue
        for path, x, spec in sharding.map_specs(
                lambda path, x, spec: [(path, x, spec)], tree, specs,
                flat=True):
            local = sharding.local_shape(x.shape, spec, shape)
            leaves['/'.join((prefix,) + path)] = {
                'shape': tuple(x.shape), 'spec': tuple(spec),
                'local_shape': local, 'dtype': str(x.dtype),
                'bytes': math.prod(local) * x.element_size()}
    state_bytes = sum(v['bytes'] for v in leaves.values())
    prefix = 'lora/' if lora_rank is not None else 'params/'
    grad_bytes = sum(v['bytes'] for k, v in leaves.items()
                     if k.startswith(prefix))
    return {'leaves': leaves, 'state_bytes': state_bytes,
            'grad_bytes': grad_bytes,
            'device_bytes': state_bytes + grad_bytes}


def init_train_state(config: llama.LlamaConfig, seed: int = 0,
                     optimizer: Optional[AdamW] = None,
                     param_dtype: torch.dtype = torch.float32,
                     lora_rank: Optional[int] = None,
                     device=None, mesh=None) -> TrainState:
    """Random params (``llama.init_params``) in ``param_dtype`` on
    ``device`` (default ``'cuda'``), and with ``lora_rank`` adapters of
    that rank (``lora.init_lora``, same seed) that alone train.

    With a ``mesh`` every leaf is this rank's block (``layout``): the
    init draws each slice as the unsharded init does and keeps the
    block, so the values are the unsharded state's blocks and no rank
    ever holds the whole tree."""
    optimizer = optimizer or default_optimizer()
    dev = device_lib.resolve_device(device, allow_meta=True)
    layout = (None if mesh is None
              else _layout(config, mesh, lora_rank is not None))
    window = (None if layout is None
              else sharding.window_fn(mesh, layout.params))
    params = llama.init_params(config, seed, dtype=param_dtype, device=dev,
                               window=window)
    lora = None
    if lora_rank is not None:
        lora = lora_lib.init_lora(
            config, seed, rank=lora_rank, dtype=param_dtype, device=dev,
            window=None if layout is None
            else sharding.window_fn(mesh, layout.lora))
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(
                          lora if lora is not None else params),
                      lora=lora, layout=layout)


def init_qlora_state(config: llama.LlamaConfig, seed: int = 0,
                     lora_rank: int = 16,
                     optimizer: Optional[AdamW] = None,
                     device=None, mesh=None) -> TrainState:
    """QLoRA train state (default device ``'cuda'``): an int8 FROZEN
    base from ``quant.init_quantized`` (leaf by leaf, so the bf16 tree
    never exists: ~8.6 GB at llama3-8b instead of 16) paired with bf16
    LoRA adapters of ``lora_rank`` and their AdamW state, as the JAX
    ``init_qlora_state``. With a ``mesh``, this rank's blocks under
    ``quantized_sharding_rules``, as ``init_train_state`` keeps them.
    Feed it to ``build_train_step`` like ``init_train_state``'s."""
    optimizer = optimizer or default_optimizer()
    dev = device_lib.resolve_device(device)
    layout = (None if mesh is None
              else _layout(config, mesh, True, quantized=True))
    params = quant.init_quantized(
        config, seed, device=dev,
        window=None if layout is None
        else sharding.window_fn(mesh, layout.params))
    lora = lora_lib.init_lora(
        config, seed, rank=lora_rank, dtype=torch.bfloat16, device=dev,
        window=None if layout is None
        else sharding.window_fn(mesh, layout.lora))
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(lora), lora=lora,
                      layout=layout)


def build_train_step(config: llama.LlamaConfig,
                     optimizer: Optional[AdamW] = None,
                     lora_scale: float = 2.0, mesh=None,
                     pipeline_microbatches: Optional[int] = None,
                     pipeline_schedule: str = 'gpipe'
                     ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                   Tuple[TrainState,
                                         Dict[str, torch.Tensor]]]:
    """The full step: loss -> grad -> clip + AdamW. The batch is
    ``{'tokens': [B, T+1] int}`` (optionally ``'loss_mask'``) on the
    state's device. ``grad_norm`` is the global norm of the raw grads,
    before the clip. Metrics stay on the device (no host sync).

    With a ``mesh`` the state must be one made over it
    (``init_train_state(mesh=...)``), and the batch is the GLOBAL batch,
    the same on every rank: each rank takes its part (its rows on the
    data axes, dp major, and its positions on ``sp``), runs its share of
    the global masked mean, and the gradients meet as the module
    docstring says. ``loss`` is the global loss on every rank. A ``pp``
    axis above 1 runs the layers as a pipeline of
    ``pipeline_microbatches`` microbatches (default ``2 pp``) under
    ``pipeline_schedule``, ``'gpipe'`` or ``'1f1b'``
    (``parallel/pipeline.py``); an unknown schedule raises ValueError,
    and 1F1B with MoE or ``sp`` NotImplementedError, as in JAX."""
    optimizer = optimizer or default_optimizer()
    num_micro = None
    if mesh is not None and mesh.shape['pp'] > 1:
        pipeline_lib.validate_pipeline_config(config, mesh.shape)
        pipeline_lib.check_schedule(config, mesh.shape, pipeline_schedule)
        num_micro = pipeline_microbatches or 2 * mesh.shape['pp']

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        layout = state.layout
        if (mesh is None) != (layout is None) or (
                layout is not None and layout.mesh is not mesh):
            raise ValueError('build_train_step: the state was made over '
                             f'{getattr(layout, "mesh", None)}, the step '
                             f'over {mesh}')
        if layout is not None:
            batch = layout.local_batch(batch, num_micro)
        is_lora = state.lora is not None
        trainable = state.lora if is_lora else state.params
        leaves = [(p, x.detach().requires_grad_(True))
                  for p, x in _leaves(trainable)]
        tree = _tree(leaves)
        frozen = (_tree((p, x.detach()) for p, x in _leaves(state.params))
                  if is_lora else tree)
        if num_micro is not None:
            loss, grads = pipeline_lib.value_and_grad(
                config, frozen, tree if is_lora else None, batch, layout,
                [x for _, x in leaves], num_micro, pipeline_schedule,
                lora_scale)
        else:
            loss = llama.loss_fn(frozen, batch, config,
                                 lora=tree if is_lora else None,
                                 lora_scale=lora_scale, layout=layout)
            grads = list(torch.autograd.grad(loss, [x for _, x in leaves]))
        specs = None
        loss = loss.detach()
        if layout is not None:
            specs = [_get(layout.trainable, p) for p, _ in leaves]
            tp_partial = layout.tp > 1 and is_lora
            for (path, _), g, spec in zip(leaves, grads, specs):
                # Summed over the axes the leaf is replicated on (the A
                # factors' over tp too: each rank's part comes through its
                # own columns of B).
                axes = layout.grad_axes(spec, tp_partial and path[-1] in
                                        lora_lib.TP_PARTIAL_GRADS)
                if axes:
                    sharding.all_reduce(g, layout.mesh, axes)
            loss = layout.loss_sum(loss)
        g_norm = global_norm(grads, layout, specs)
        new_trainable, new_opt = optimizer.update(
            _tree((p, g) for (p, _), g in zip(leaves, grads)),
            state.opt_state, trainable, g_norm)
        new_state = TrainState(
            step=state.step + 1,
            params=state.params if is_lora else new_trainable,
            opt_state=new_opt,
            lora=new_trainable if is_lora else None, layout=layout)
        return new_state, {'loss': loss, 'grad_norm': g_norm}

    return step


def instrument_train_step(step_fn: Callable,
                          tokens_per_step: Optional[int] = None,
                          model_config=None,
                          accelerator: Optional[str] = None,
                          full_finetune: bool = False
                          ) -> Callable:
    """Wrap a ``train_step(state, batch)`` so every call records step
    time and token throughput into the port's process metrics registry
    (``skytpu_train_step_seconds`` / ``skytpu_train_tokens_total`` /
    ``skytpu_train_steps_total`` / ``skytpu_train_tokens_per_sec``) —
    the port of ``skypilot_tpu.parallel.instrument_train_step``.

    Timing is the interval between successive calls: in a loop that
    syncs per step (fetching the loss, as ``recipes/finetune`` does),
    that IS the step time. The first call records nothing, so N calls
    observe N - 1 intervals. Tokens per step default to
    ``batch['tokens'].shape`` minus the shifted label column.

    Tracing: inside a trace (the ``SKYTPU_TRACE_CONTEXT`` stamp), every
    step emits a ``train.step`` span over the SAME interval the
    histogram observed, and the step's span stays the ambient context
    until the next call (work recorded between steps nests under it).

    Goodput & MFU: every interval feeds the process goodput accountant —
    the first as ``compile``, the rest as ``compute``. With
    ``model_config`` and a card the peak table knows (``accelerator``
    or the ``SKYTPU_ACCELERATOR`` stamp; ``metrics/goodput.py``) each
    compute step sets ``skytpu_mfu_ratio`` (4 N FLOPs a token for a
    frozen-base LoRA step, 6 N with ``full_finetune``) over the process
    group's cards (one process per card; 1 without a group).

    On-demand profiling: a trigger in the profile dir arms a
    ``torch.profiler`` capture of the next N steps
    (``utils/profiling.py``).
    """
    from skypilot_torch import trace as trace_lib
    from skypilot_torch.metrics import goodput as goodput_lib
    from skypilot_torch.utils import profiling as profiling_lib
    fams = goodput_lib.train_metrics()
    step_hist = fams['step_seconds']
    tokens_total = fams['tokens_total']
    steps_total = fams['steps_total']
    tok_s = fams['tokens_per_sec']
    acct = goodput_lib.accountant()
    profiler = profiling_lib.StepProfiler('train')
    model_armed = [False]

    def arm_model(n_tokens: int) -> None:
        acct.set_model_info(model_config.num_params(), n_tokens,
                            n_chips=distributed.process_count(),
                            accelerator=accelerator,
                            full_finetune=full_finetune)
        model_armed[0] = True

    if model_config is not None and tokens_per_step is not None:
        arm_model(tokens_per_step)
    last_call: List[Optional[float]] = [None]
    # Open train.step span: (context, parent, start_wall, ambient token,
    # step index). Its identity is pre-allocated so work recorded while
    # it is ambient parents correctly; it is EMITTED when the next call
    # closes the interval.
    open_step: List[Optional[tuple]] = [None]
    step_idx = [0]

    def _tokens_in(batch) -> int:
        if tokens_per_step is not None:
            return tokens_per_step
        try:
            tokens = batch['tokens']
            return int(tokens.shape[0] * (tokens.shape[1] - 1))
        except Exception:  # pylint: disable=broad-except
            return 0

    def wrapper(state, batch):
        now = time.perf_counter()
        now_wall = time.time()
        n_tokens = _tokens_in(batch)
        if model_config is not None and not model_armed[0] \
                and n_tokens:
            arm_model(n_tokens)
        if last_call[0] is not None:
            dt = now - last_call[0]
            step_hist.observe(dt)
            acct.observe_step(dt, compile_step=(step_idx[0] == 1))
            if dt > 0 and n_tokens:
                tok_s.set(n_tokens / dt)
            prev = open_step[0]
            if prev is not None:
                ctx, parent, start_wall, token, idx = prev
                trace_lib.reset_current(token)
                # SAME dt as the histogram observation above.
                trace_lib.emit_span(ctx, parent, 'train.step',
                                    start_wall, start_wall + dt,
                                    attrs={'step': idx,
                                           'tokens': n_tokens})
                open_step[0] = None
        last_call[0] = now
        parent = trace_lib.current()
        if parent is not None:
            ctx = trace_lib.child_context(parent)
            token = trace_lib.set_current(ctx)
            open_step[0] = (ctx, parent, now_wall, token, step_idx[0])
        step_idx[0] += 1
        steps_total.inc()
        if n_tokens:
            tokens_total.inc(n_tokens)
        profiler.on_step()
        return step_fn(state, batch)

    # The identity copy by hand (functools.wraps skips attributes the
    # target lacks): __wrapped__ -> the callable -> its type.
    target = getattr(step_fn, '__wrapped__', step_fn)
    wrapper.__name__ = getattr(
        target, '__name__', type(step_fn).__name__)
    wrapper.__qualname__ = getattr(
        target, '__qualname__', wrapper.__name__)
    wrapper.__doc__ = getattr(target, '__doc__', None)
    wrapper.__module__ = getattr(
        target, '__module__', wrapper.__module__)
    wrapper.__wrapped__ = step_fn
    wrapper.inner = step_fn
    return wrapper
