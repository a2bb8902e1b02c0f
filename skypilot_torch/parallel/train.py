"""One-device train step — the port of ``skypilot_tpu/parallel/train.py``.

``build_train_step(config, optimizer, lora_scale)`` returns
``step(state, batch) -> (state, {'loss', 'grad_norm'})``: the loss
(``llama.loss_fn``), its gradient by autograd, then clip-by-global-norm
and AdamW, written out here so the optimizer state has optax's exact
dtypes (``mu`` f32, ``nu`` in the param dtype; ``torch.optim.AdamW``
keeps both in the param dtype). LoRA trains the adapters over a frozen
base; without LoRA every param trains. ``init_qlora_state`` makes that
frozen base int8 (QLoRA): the same step runs over it, autograd going
through ``llama.matmul``'s dequant to the adapters only.

Not here yet (ROADMAP.md): meshes with any axis > 1 (FSDP/TP, the
``sp`` ring and the ``pp`` pipeline) and ``instrument_train_step``.
"""
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama, quant
from skypilot_torch.parallel import lora as lora_lib

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


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax ``global_norm``: sqrt of the sum over leaves of sum(g*g),
    each in the gradient's own dtype."""
    total = None
    for g in grads:
        sq = torch.sum(g * g)
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


def init_train_state(config: llama.LlamaConfig, seed: int = 0,
                     optimizer: Optional[AdamW] = None,
                     param_dtype: torch.dtype = torch.float32,
                     lora_rank: Optional[int] = None,
                     device=None) -> TrainState:
    """Random params (``llama.init_params``) in ``param_dtype`` on
    ``device`` (default ``'cuda'``), and with ``lora_rank`` adapters of
    that rank (``lora.init_lora``, same seed) that alone train."""
    optimizer = optimizer or default_optimizer()
    dev = device_lib.resolve_device(device)
    params = llama.init_params(config, seed, dtype=param_dtype, device=dev)
    lora = None
    if lora_rank is not None:
        lora = lora_lib.init_lora(config, seed, rank=lora_rank,
                                  dtype=param_dtype, device=dev)
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(
                          lora if lora is not None else params),
                      lora=lora)


def init_qlora_state(config: llama.LlamaConfig, seed: int = 0,
                     lora_rank: int = 16,
                     optimizer: Optional[AdamW] = None,
                     device=None) -> TrainState:
    """QLoRA train state on one device (default ``'cuda'``): an int8
    FROZEN base from ``quant.init_quantized`` (leaf by leaf, so the
    bf16 tree never exists: ~8.6 GB at llama3-8b instead of 16) paired
    with bf16 LoRA adapters of ``lora_rank`` and their AdamW state, as
    the JAX ``init_qlora_state``. Feed it to ``build_train_step`` like
    ``init_train_state``'s."""
    optimizer = optimizer or default_optimizer()
    dev = device_lib.resolve_device(device)
    params = quant.init_quantized(config, seed, device=dev)
    lora = lora_lib.init_lora(config, seed, rank=lora_rank,
                              dtype=torch.bfloat16, device=dev)
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(lora), lora=lora)


def build_train_step(config: llama.LlamaConfig,
                     optimizer: Optional[AdamW] = None,
                     lora_scale: float = 2.0
                     ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                   Tuple[TrainState,
                                         Dict[str, torch.Tensor]]]:
    """The full step: loss -> grad -> clip + AdamW. The batch is
    ``{'tokens': [B, T+1] int}`` (optionally ``'loss_mask'``) on the
    state's device. ``grad_norm`` is the global norm of the raw grads,
    before the clip. Metrics stay on the device (no host sync)."""
    optimizer = optimizer or default_optimizer()
    llama.require_dense(config)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        is_lora = state.lora is not None
        trainable = state.lora if is_lora else state.params
        leaves = [(p, x.detach().requires_grad_(True))
                  for p, x in _leaves(trainable)]
        tree = _tree(leaves)
        if is_lora:
            frozen = _tree((p, x.detach())
                           for p, x in _leaves(state.params))
            loss = llama.loss_fn(frozen, batch, config, lora=tree,
                                 lora_scale=lora_scale)
        else:
            loss = llama.loss_fn(tree, batch, config)
        grads = torch.autograd.grad(loss, [x for _, x in leaves])
        g_norm = global_norm(list(grads))
        new_trainable, new_opt = optimizer.update(
            _tree((p, g) for (p, _), g in zip(leaves, grads)),
            state.opt_state, trainable, g_norm)
        new_state = TrainState(
            step=state.step + 1,
            params=state.params if is_lora else new_trainable,
            opt_state=new_opt,
            lora=new_trainable if is_lora else None)
        return new_state, {'loss': loss.detach(), 'grad_norm': g_norm}

    return step
