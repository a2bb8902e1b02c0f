"""Pipeline parallelism over the ``pp`` mesh axis — the port of
``skypilot_tpu/parallel/pipeline.py``.

The stacked ``[L, ...]`` layer leaves (and adapters) shard their leading
axis over ``pp`` (``llama.param_sharding_rules(pipeline=True)``), so
stage ``i`` (the rank's ``pp`` coordinate) holds layers ``[i L / pp,
(i + 1) L / pp)`` and runs them on each microbatch in turn
(``llama.run_layers``: the rank's data, ``tp``, ``ep`` and ``sp``
shards as outside a pipeline). The batch splits into ``num_micro``
microbatches: microbatch ``m`` is the global rows ``[m B / M, (m + 1) B
/ M)``, split over the data axes (``Layout.local_batch(micro=M)``). The
first stage embeds; the last applies the final norm and the fused CE
over the whole batch's unmasked count, so the microbatches' losses sum
to the masked mean. JAX runs the embedding and the head on every stage,
outside its pipeline; here each runs on the one stage that needs it, and
the gradients of these leaves, replicated over ``pp``, are summed over
it by the step (``Layout.grad_axes``), where the other stages add zeros.

Both schedules run in lock-step rounds, as JAX's ``scan`` does: in each
round a stage works on at most one microbatch forward and one backward,
then trades with its neighbours in one point-to-point call
(``comm.pp_exchange``): the activation it made goes to the next
stage, the gradient of its input to the previous one. The rounds need
no buffering beyond one activation and one gradient, and every stage
makes the same calls in the same order, so none waits on a call that a
neighbour makes later. The schedule drives the backward itself, one
microbatch at a time (``torch.autograd.grad`` on the stage's outputs),
rather than through autograd Functions over the sends, whose backward
order the autograd engine would choose.

- GPipe (``gpipe``; JAX's ``build_pipeline_loss``): ``M + pp - 1``
  forward rounds, stage ``i`` running microbatch ``r - i`` in round
  ``r``, every microbatch's graph kept; then ``M + pp - 1`` backward
  rounds, the last stage first. Rounds where a stage has no microbatch
  (the bubble) do nothing: JAX computes on junk there and masks it.
  MoE's aux loss is microbatch-local, the mean over (layer,
  microbatch), as in JAX.
- 1F1B (``1f1b``; JAX's ``build_pipeline_value_and_grad``): ``M + 2
  (pp - 1)`` rounds; in round ``r`` stage ``i`` runs microbatch ``r - i``
  forward with no graph, keeping only its input, and microbatch ``r - 2
  (pp - 1) + i`` backward, recomputing its forward from the kept input.
  Stage ``i`` keeps at most ``2 (pp - i) - 1`` inputs, whatever ``M``.
  The last stage runs each microbatch once, forward with its graph and
  backward at once (JAX runs it twice: its program is the same on every
  stage). Refused, as in JAX, with MoE or ``sp``.
"""
from typing import Dict, List, Optional, Tuple

import torch

from skypilot_torch import comm
from skypilot_torch.models import llama
from skypilot_torch.parallel import sharding

# The schedules ``build_train_step`` runs (``pipeline_schedule``).
SCHEDULES = ('gpipe', '1f1b')


def validate_pipeline_config(config: llama.LlamaConfig,
                             mesh_shape: Dict[str, int]) -> None:
    """Structural checks for a ``pp`` > 1 mesh, with JAX's messages."""
    pp = mesh_shape['pp']
    if config.n_layers % pp != 0:
        raise ValueError(
            f'n_layers={config.n_layers} not divisible by pp={pp}')
    if mesh_shape.get('sp', 1) > 1 and config.n_experts:
        raise NotImplementedError(
            'MoE + sequence parallelism inside a pipeline is not '
            'supported: the manual-sp stage would route on local '
            'sequence shards, changing capacity semantics')


def check_schedule(config: llama.LlamaConfig, mesh_shape: Dict[str, int],
                   schedule: str) -> None:
    """Raise for a schedule JAX does not run on this config and mesh."""
    if schedule == '1f1b':
        if config.n_experts:
            raise NotImplementedError(
                '1F1B with MoE is not supported; use the GPipe schedule')
        if mesh_shape.get('sp', 1) > 1:
            raise NotImplementedError(
                '1F1B with sequence parallelism is not supported; use '
                'the GPipe schedule')
    elif schedule not in SCHEDULES:
        raise ValueError(f'unknown pipeline_schedule {schedule!r} '
                         "(choose 'gpipe' or '1f1b')")


class _Stage:
    """One stage's share of a step: its layers, and the first stage's
    embedding or the last stage's head, on microbatch ``m`` of the
    rank's part of the batch (``Layout.local_batch(micro=M)``)."""

    def __init__(self, config, params, lora, batch, layout, num_micro,
                 lora_scale, inputs):
        self.config, self.params, self.lora = config, params, lora
        self.layout, self.lora_scale = layout, lora_scale
        tokens = batch['tokens']
        self.inputs, self.targets = tokens[:, :-1], tokens[:, 1:]
        self.mask = llama.shifted_loss_mask(batch, self.targets)
        b, t = self.inputs.shape
        self.mb = b // num_micro
        self.num_micro = num_micro
        self.count = layout.token_sum(self.mask.sum())
        self.angles = llama.rank_angles(config, t, tokens.device, layout)
        self.attn = llama.attention_impl(layout)
        self.first = layout.pp_index == 0
        self.last = layout.pp_index == layout.pp - 1
        self.inputs_grad = inputs
        self.grads: List[Optional[torch.Tensor]] = [None] * len(inputs)
        self.loss = torch.zeros((), dtype=torch.float32,
                                device=tokens.device)
        self.act_shape = (self.mb, t, config.dim)

    def rows(self, m: int) -> slice:
        return slice(m * self.mb, (m + 1) * self.mb)

    def forward(self, m: int, x: Optional[torch.Tensor]):
        """(stage output or the last stage's loss root, the value this
        microbatch adds to the rank's loss). ``x``: the received
        activation (None on the first stage, which embeds)."""
        config = self.config
        cparams = llama.compute_params(self.params, config)
        if self.first:
            x = llama.embed_tokens(cparams, self.inputs[self.rows(m)],
                                   config, self.layout)
        y, aux = llama.run_layers(config, x, cparams['layers'], self.angles,
                                  self.attn, self.lora, self.lora_scale,
                                  self.layout)
        root = None
        if config.n_experts:
            # The (layer, microbatch) sum divided down to JAX's mean.
            root = config.moe_aux_coef * aux / (config.n_layers *
                                                self.num_micro)
        if self.last:
            r = self.rows(m)
            ce = llama.loss_from_hidden(
                self.params, llama.final_norm(cparams, y, config),
                self.targets[r], self.mask[r], config,
                train_lm_head=self.lora is None, layout=self.layout,
                count=self.count)
            root = ce if root is None else ce + root
            return root, root
        return y, root

    def backward(self, out, aux_root, cot: Optional[torch.Tensor],
                 x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Accumulate the gradients of ``out`` (the stage output, with
        cotangent ``cot``; the loss root on the last stage) and of the
        aux root into the step's inputs; return the gradient of the
        stage input ``x`` (None on the first stage)."""
        if self.last:
            outs, cots = [out], [None]
        else:
            outs, cots = [out], [cot]
            if aux_root is not None:
                outs.append(aux_root)
                cots.append(None)
        wrt = list(self.inputs_grad) + ([] if x is None else [x])
        got = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
        for j, g in enumerate(got[:len(self.inputs_grad)]):
            if g is not None:
                g = g.float()
                self.grads[j] = g if self.grads[j] is None else \
                    self.grads[j] + g
        return None if x is None else got[-1].detach()

    def add_loss(self, value) -> None:
        if value is not None:
            self.loss = self.loss + value.detach().float()

    def buffer(self, dtype, device) -> torch.Tensor:
        return torch.empty(self.act_shape, dtype=dtype, device=device)

    def result(self) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        # Contiguous: a tied head's gradient is a transpose, and the
        # step sums the gradients in place over their ranks.
        grads = [torch.zeros_like(x) if g is None
                 else g.to(x.dtype).contiguous()
                 for x, g in zip(self.inputs_grad, self.grads)]
        return self.loss, grads


def _gpipe(stage: _Stage, group, dtype, device) -> None:
    pp, i, M = stage.layout.pp, stage.layout.pp_index, stage.num_micro
    rounds = M + pp - 1
    kept = {}
    act = None
    for r in range(rounds):
        m = r - i
        y = None
        if 0 <= m < M:
            x = None if stage.first else act.requires_grad_(True)
            out, aux_root = stage.forward(m, x)
            stage.add_loss(aux_root)
            kept[m] = (out, aux_root, x)
            y = None if stage.last else out.detach()
        act = (stage.buffer(dtype, device)
               if not stage.first and 0 <= r + 1 - i < M else None)
        comm.pp_exchange(group, to_next=y, from_prev=act)
    cot = None
    for r in range(rounds):
        m = r - (pp - 1 - i)
        dx = None
        if 0 <= m < M:
            out, aux_root, x = kept.pop(m)
            dx = stage.backward(out, aux_root, cot, x)
        cot = (stage.buffer(dtype, device)
               if not stage.last and 0 <= r + 1 - (pp - 1 - i) < M else None)
        comm.pp_exchange(group, to_prev=dx, from_next=cot)


def _one_f_one_b(stage: _Stage, group, dtype, device) -> int:
    """Runs the 1F1B rounds; returns the most stage inputs kept at once."""
    pp, i, M = stage.layout.pp, stage.layout.pp_index, stage.num_micro
    kept: Dict[int, Optional[torch.Tensor]] = {}
    most = 0
    act = cot = None
    for r in range(M + 2 * (pp - 1)):
        fm, bm = r - i, r - 2 * (pp - 1) + i
        y = dx = None
        if 0 <= fm < M and not stage.last:
            kept[fm] = act
            with torch.no_grad():
                y, _ = stage.forward(fm, act)
            most = max(most, len(kept))
        if 0 <= bm < M:
            x = act if stage.last else kept.pop(bm)
            if x is not None:
                x = x.requires_grad_(True)
            out, root = stage.forward(bm, x)
            if stage.last:
                stage.add_loss(root)
            dx = stage.backward(out, None, cot, x)
        act = (stage.buffer(dtype, device)
               if not stage.first and 0 <= r + 1 - i < M else None)
        cot = (stage.buffer(dtype, device) if not stage.last and
               0 <= r + 1 - 2 * (pp - 1) + i < M else None)
        comm.pp_exchange(group, to_next=y, to_prev=dx, from_prev=act,
                         from_next=cot)
    return most


def value_and_grad(config: llama.LlamaConfig, params, lora, batch,
                   layout: sharding.Layout, inputs: List[torch.Tensor],
                   num_micro: int, schedule: str = 'gpipe',
                   lora_scale: float = 2.0
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One pipelined forward and backward of this rank's stage: (its share
    of the loss, the gradients of ``inputs``, the trainable leaves of
    ``params`` or ``lora``, in their order). ``batch`` is the rank's part
    (``Layout.local_batch(micro=num_micro)``). The shares of the ranks
    sum to the global loss over the token axes and ``pp``, and the
    gradients are the rank's before the step's sums over them."""
    b = batch['tokens'].shape[0]
    if b % num_micro:
        raise ValueError(f'batch {b} not divisible by num_micro={num_micro}')
    layout.make_groups()
    stage = _Stage(config, params, lora, batch, layout, num_micro,
                   lora_scale, inputs)
    group = layout.mesh.group(('pp',))
    device = batch['tokens'].device
    if schedule == 'gpipe':
        _gpipe(stage, group, config.dtype, device)
    else:
        _one_f_one_b(stage, group, config.dtype, device)
    return stage.result()
