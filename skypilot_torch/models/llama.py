"""Llama 3.x family in PyTorch — the port of
``skypilot_tpu/models/llama.py``.

Params are a plain dict of tensors in the JAX package's layout: layer
weights STACKED along a leading ``[L, ...]`` axis and every projection
oriented ``[in, out]`` (``x @ w``), so a JAX params tree maps onto
this one key for key (``models/convert.py``). Here: configs, init,
the norm/RoPE/activation helpers, the training forward
(``forward_hidden`` over ``_layer`` with LoRA q/v deltas, attention
with RoPE fused into the flash kernels) and the loss (``loss_fn``,
with the chunked fused LM-head + cross-entropy ``_FusedCE``). Any
matmul weight and the LM head may be an int8 ``{'q', 's'}`` pair
(``models/quant.py``): ``matmul`` and the fused CE take both forms, so
a LoRA step runs over an int8 frozen base (QLoRA). MoE configs
(``n_experts > 0``) replace every layer's MLP with the JAX package's
top-k routed expert MLP (``_moe_mlp``: static per-row capacity, the
Switch aux loss over the global batch), routed on the card by the
``moe_route`` kernels (``ops/moe_route.route_for_training``), its experts
sharded over ``ep``. MoE serving runs ``models/decode.moe_mlp``.

With a ``layout`` (``parallel/sharding.Layout``) the params are a
rank's blocks on a mesh: each layer's dims sharded over the data axes
are gathered inside its call, and over ``tp`` the layer runs
Megatron-style on the rank's heads and ffn columns (``_layer``), the
embedding and the fused CE on its vocabulary window. Over ``sp`` the
tokens are the rank's positions of each row: RoPE runs at their global
positions and attention is the ring (``attention_impl``), and an MoE
layer routes the whole row (``_row_slots``). A pipeline stage
(``parallel/pipeline.py``) runs its own layers through ``run_layers``.

Under ``config.remat`` each layer runs in ``torch.utils.checkpoint``
(non-reentrant): only the layer inputs are kept, and backward runs the
layer's forward again — the flash forward kernel included. Keeping the
kernel's out/lse across the checkpoint (the JAX ``remat_policy``) and
the other ``remat_saves`` tokens are later work (ROADMAP.md Queue 2).
"""
import dataclasses
import functools
import itertools
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_torch import device as device_lib
from skypilot_torch.ops import attention as attention_ops
from skypilot_torch.ops import moe_route as moe_route_ops
from skypilot_torch.ops import ring_attention as ring_attention_ops

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Field for field the JAX ``LlamaConfig``; ``dtype`` is the torch
    compute dtype (``torch.bfloat16`` or ``torch.float32``)."""
    name: str
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    ffn_hidden: int
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    rope_scaling: bool = False
    remat: bool = True
    remat_saves: str = 'attn'
    head_dim_override: Optional[int] = None
    mlp_activation: str = 'silu'
    tie_embeddings: bool = False
    norm_offset: bool = False
    scale_embeddings: bool = False
    qkv_bias: bool = False
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_coef: float = 0.02

    def __post_init__(self):
        unknown = set(self.remat_saves.split('+')) - {
            'attn', 'mlp', 'mlp_up', 'qkv'}
        if unknown:
            raise ValueError(
                f'unknown remat_saves token(s) {sorted(unknown)} in '
                f'{self.remat_saves!r}; valid: attn, mlp, mlp_up, qkv')
        if self.mlp_activation not in ('silu', 'gelu_tanh'):
            raise ValueError(
                f'unknown mlp_activation {self.mlp_activation!r}')

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.dim // self.n_heads

    def num_params(self) -> int:
        d, v, h = self.dim, self.vocab_size, self.ffn_hidden
        nh, nkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        mlp = 3 * d * h
        if self.n_experts:
            mlp = self.n_experts * mlp + d * self.n_experts
        per_layer = (
            d * nh * hd + 2 * d * nkv * hd + nh * hd * d +
            mlp + 2 * d)
        if self.qkv_bias:
            per_layer += (nh + 2 * nkv) * hd
        head = 0 if self.tie_embeddings else v * d
        return v * d + head + self.n_layers * per_layer + d

    def num_active_params(self) -> int:
        """Params touched per token (``num_params`` for dense configs;
        for MoE only top_k of the n_experts MLPs): the FLOPs/token
        basis."""
        if not self.n_experts:
            return self.num_params()
        unused = ((self.n_experts - self.moe_top_k) *
                  3 * self.dim * self.ffn_hidden * self.n_layers)
        return self.num_params() - unused


CONFIGS: Dict[str, LlamaConfig] = {
    'llama3-8b': LlamaConfig(
        name='llama3-8b', vocab_size=128256, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_hidden=14336,
        rope_theta=500000.0),
    'llama3.1-8b': LlamaConfig(
        name='llama3.1-8b', vocab_size=128256, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_hidden=14336,
        rope_theta=500000.0, rope_scaling=True, max_seq_len=131072),
    'llama3.2-1b': LlamaConfig(
        name='llama3.2-1b', vocab_size=128256, dim=2048, n_layers=16,
        n_heads=32, n_kv_heads=8, ffn_hidden=8192,
        rope_theta=500000.0, rope_scaling=True),
    'llama2-7b': LlamaConfig(
        name='llama2-7b', vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=32, ffn_hidden=11008,
        rope_theta=10000.0, max_seq_len=4096),
    'gemma-2b': LlamaConfig(
        name='gemma-2b', vocab_size=256000, dim=2048, n_layers=18,
        n_heads=8, n_kv_heads=1, ffn_hidden=16384,
        head_dim_override=256, rope_theta=10000.0, max_seq_len=8192,
        mlp_activation='gelu_tanh', tie_embeddings=True,
        norm_offset=True, scale_embeddings=True),
    'gemma-7b': LlamaConfig(
        name='gemma-7b', vocab_size=256000, dim=3072, n_layers=28,
        n_heads=16, n_kv_heads=16, ffn_hidden=24576,
        head_dim_override=256, rope_theta=10000.0, max_seq_len=8192,
        mlp_activation='gelu_tanh', tie_embeddings=True,
        norm_offset=True, scale_embeddings=True),
    'qwen2.5-7b': LlamaConfig(
        name='qwen2.5-7b', vocab_size=152064, dim=3584, n_layers=28,
        n_heads=28, n_kv_heads=4, ffn_hidden=18944,
        rope_theta=1000000.0, max_seq_len=32768, qkv_bias=True),
    'qwen2.5-1.5b': LlamaConfig(
        name='qwen2.5-1.5b', vocab_size=151936, dim=1536, n_layers=28,
        n_heads=12, n_kv_heads=2, ffn_hidden=8960,
        rope_theta=1000000.0, max_seq_len=32768, qkv_bias=True,
        tie_embeddings=True),
    'mistral-7b': LlamaConfig(
        name='mistral-7b', vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_hidden=14336,
        rope_theta=10000.0, max_seq_len=8192),
    'mixtral-8x7b': LlamaConfig(
        name='mixtral-8x7b', vocab_size=32000, dim=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, ffn_hidden=14336,
        rope_theta=1000000.0, max_seq_len=32768,
        n_experts=8, moe_top_k=2),
    'debug-250m': LlamaConfig(
        name='debug-250m', vocab_size=32000, dim=1024, n_layers=8,
        n_heads=16, n_kv_heads=4, ffn_hidden=2816),
    'tiny': LlamaConfig(
        name='tiny', vocab_size=512, dim=128, n_layers=2, n_heads=4,
        n_kv_heads=2, ffn_hidden=256, max_seq_len=512,
        dtype=torch.float32, remat=False),
    'tiny-moe': LlamaConfig(
        name='tiny-moe', vocab_size=512, dim=128, n_layers=2,
        n_heads=4, n_kv_heads=2, ffn_hidden=256, max_seq_len=512,
        dtype=torch.float32, remat=False, n_experts=4, moe_top_k=2),
}


def get_config(name: str, **overrides) -> LlamaConfig:
    cfg = CONFIGS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def moe_capacity(config: LlamaConfig, t: int) -> int:
    """Per-expert buffer of a routing group of ``t`` tokens:
    ``min(ceil(top_k * t * capacity_factor / E), t)``, the JAX
    ``_moe_mlp``'s expression."""
    return min(int(math.ceil(config.moe_top_k * t *
                             config.moe_capacity_factor /
                             config.n_experts)), t)


# ---------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------


def init_params(config: LlamaConfig, seed: int = 0,
                dtype: Optional[torch.dtype] = None,
                device=None, quantize=None, window=None) -> Params:
    """Random params in the JAX package's layout (stacked ``[L, ...]``,
    ``[in, out]`` projections; MoE: ``router [L, D, E]`` and expert
    stacks ``[L, E, in, out]``): ``normal / sqrt(fan_in)`` drawn in f32
    from an explicit ``torch.Generator`` seeded with ``seed``, then
    cast to ``dtype`` (default ``config.dtype``). Norms init to ones
    (zeros under ``norm_offset``), q/k/v biases to zeros.

    The draws differ from ``jax.random`` for the same seed; tests carry
    JAX's weights across with ``convert.params_from_numpy`` instead.
    Stacked weights are drawn one ``[in, out]`` slice at a time (a
    layer's, an expert's of a layer for MoE stacks), so the f32
    temporary is one slice, not the whole stack (8B: ~0.2 GB, not 7.5;
    mixtral's expert: ~0.23 GB). ``quantize`` (``quant.quantize_weight``;
    use ``quant.init_quantized``) turns each matmul weight's slice and
    the LM head into an int8 ``{'q', 's'}`` pair as it is drawn, so the
    wide stack never exists; the router stays wide.

    ``window(path, shape)`` (``parallel/sharding.window_fn``) keeps one
    block of each leaf: every slice is drawn as above and only the
    block's part is stored, so a rank of a mesh holds its block of the
    unsharded init and never the whole tree. ``device='meta'`` gives the
    shapes and dtypes alone (``train.plan_train_state``).
    """
    dev = device_lib.resolve_device(device, allow_meta=True)
    dtype = dtype or config.dtype
    d = config.dim
    hd = config.head_dim
    nh, nkv = config.n_heads, config.n_kv_heads
    ffn = config.ffn_hidden
    L = config.n_layers
    E = config.n_experts
    gen = device_lib.generator(dev, seed)

    def block(path, shape):
        if window is None:
            return tuple(slice(0, n) for n in shape)
        return window(path, tuple(shape))

    def dense(shape, fan_in):
        scale = 1.0 / math.sqrt(fan_in)
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    def kept(path, x):
        """x's block as its own storage (x itself when whole)."""
        sl = block(path, x.shape)
        whole = all(s.start == 0 and s.stop == n
                    for s, n in zip(sl, x.shape))
        return x if whole else x[sl].clone()

    def empty_block(path, shape, dt):
        sl = block(path, shape)
        return torch.empty([s.stop - s.start for s in sl], dtype=dt,
                           device=dev), sl

    def fill(out, sl, lead, i, part):
        """Stores slice ``i`` (of the lead dims) of a stacked leaf into
        its block ``out`` (window ``sl``) when the block holds it."""
        if all(s.start <= j < s.stop for s, j in zip(sl, i)):
            at = tuple(j - s.start for s, j in zip(sl, i))
            out[at] = part[sl[len(lead):]]

    def stacked(name, shape, fan_in, wide=False):
        lead = (L,) + shape[:-2]
        path = ('layers', name)
        if quantize is not None and not wide:
            q, q_sl = empty_block(path + ('q',), lead + shape[-2:],
                                  torch.int8)
            sc, s_sl = empty_block(path + ('s',), lead + (1, shape[-1]),
                                   torch.bfloat16)
            for i in itertools.product(*map(range, lead)):
                part = quantize(dense(shape[-2:], fan_in))
                fill(q, q_sl, lead, i, part['q'])
                fill(sc, s_sl, lead, i, part['s'])
            return {'q': q, 's': sc}
        out, sl = empty_block(path, lead + shape[-2:], dtype)
        for i in itertools.product(*map(range, lead)):
            fill(out, sl, lead, i, dense(shape[-2:], fan_in))
        return out

    def norm_init(path, shape):
        init = torch.zeros if config.norm_offset else torch.ones
        return kept(path, init(shape, dtype=dtype, device=dev))

    embed = kept(('embed',), dense((config.vocab_size, d), d))
    layers = {
        'wq': stacked('wq', (d, nh * hd), d),
        'wk': stacked('wk', (d, nkv * hd), d),
        'wv': stacked('wv', (d, nkv * hd), d),
        'wo': stacked('wo', (nh * hd, d), nh * hd),
    }
    experts = (E,) if E else ()
    if E:
        layers['router'] = stacked('router', (d, E), d, wide=True)
    layers.update({
        'w_gate': stacked('w_gate', experts + (d, ffn), d),
        'w_up': stacked('w_up', experts + (d, ffn), d),
        'w_down': stacked('w_down', experts + (ffn, d), ffn),
        'attn_norm': norm_init(('layers', 'attn_norm'), (L, d)),
        'mlp_norm': norm_init(('layers', 'mlp_norm'), (L, d)),
    })
    params: Params = {
        'embed': embed,
        'layers': layers,
        'final_norm': norm_init(('final_norm',), (d,)),
    }
    if config.qkv_bias:
        for name, width in (('bq', nh * hd), ('bk', nkv * hd),
                            ('bv', nkv * hd)):
            params['layers'][name] = kept(
                ('layers', name),
                torch.zeros((L, width), dtype=dtype, device=dev))
    if not config.tie_embeddings:
        head = dense((d, config.vocab_size), d)
        if quantize is not None:
            head = quantize(head)
            params['lm_head'] = {k: kept(('lm_head', k), v)
                                 for k, v in head.items()}
        else:
            params['lm_head'] = kept(('lm_head',), head)
    return params


def param_sharding_rules(config: LlamaConfig,
                         pipeline: bool = False) -> Params:
    """A spec per param over the mesh axes (pp, fsdp, ep, tp), the JAX
    ``param_sharding_rules`` (``parallel/sharding.py`` reads a spec as
    JAX reads ``P(...)``).

    TP shards heads / ffn-hidden / vocab; FSDP shards the other big
    axis (ZeRO-3). Non-expert params fold 'ep' into the fsdp group;
    expert-stacked weights shard their expert axis over 'ep'. The
    stacked layer axis is replicated, except under pipeline parallelism
    (``pipeline=True``), where it shards over 'pp' so each stage holds
    its own ``L / pp`` layers (``parallel/pipeline.py``). No spec names
    'sp': every ``sp`` rank holds the same blocks.
    """
    pl = 'pp' if pipeline else None
    fs = ('fsdp', 'ep')
    if config.n_experts:
        mlp_rules = {
            'router': (pl, fs, None),
            'w_gate': (pl, 'ep', 'fsdp', 'tp'),
            'w_up': (pl, 'ep', 'fsdp', 'tp'),
            'w_down': (pl, 'ep', 'tp', 'fsdp'),
        }
    else:
        mlp_rules = {
            'w_gate': (pl, fs, 'tp'),
            'w_up': (pl, fs, 'tp'),
            'w_down': (pl, 'tp', fs),
        }
    rules = {
        'embed': ('tp', fs),
        'layers': {
            'wq': (pl, fs, 'tp'),
            'wk': (pl, fs, 'tp'),
            'wv': (pl, fs, 'tp'),
            'wo': (pl, 'tp', fs),
            **mlp_rules,
            'attn_norm': (pl, None),
            'mlp_norm': (pl, None),
        },
        'final_norm': (None,),
    }
    if config.qkv_bias:
        rules['layers']['bq'] = (pl, 'tp')
        rules['layers']['bk'] = (pl, 'tp')
        rules['layers']['bv'] = (pl, 'tp')
    if not config.tie_embeddings:
        rules['lm_head'] = (fs, 'tp')
    return rules


# ---------------------------------------------------------------------
# Forward helpers
# ---------------------------------------------------------------------


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for plain or int8 ``{'q', 's'}`` weights (``models/quant``):
    ``(x @ q.to(x.dtype)) * s``, the per-output-channel scale applied
    after the product in the product's dtype, JAX's two rounding points.
    The convert materializes a copy of the weight per call (XLA fuses
    it into the dot on the TPU; a fused dequant GEMV is ROADMAP.md
    Queue 2 work). Gradients flow to x, never to the codes."""
    if isinstance(w, dict):
        q = w.get('q')
        if not isinstance(q, torch.Tensor) or q.dtype != torch.int8:
            raise TypeError('matmul: a {q, s} weight needs int8 codes q, '
                            f'got {type(q).__name__} '
                            f'{getattr(q, "dtype", "")}')
        out = x @ q.to(x.dtype)
        return out * w['s'].to(out.dtype)
    return x @ w


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
              offset: bool = False) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    w = weight.float()
    if offset:
        w = 1.0 + w  # Gemma's zero-centered norm weights
    return (norm * w).to(x.dtype)


def _rope_frequencies(config: LlamaConfig, positions: torch.Tensor
                      ) -> torch.Tensor:
    """[T, head_dim/2] f32 rotation angles for ``positions`` [T]."""
    hd = config.head_dim
    exponent = torch.arange(0, hd, 2, dtype=torch.float32,
                            device=positions.device) / hd
    freqs = 1.0 / torch.pow(config.rope_theta, exponent)
    if config.rope_scaling:
        # Llama-3.1 NTK-style frequency scaling (factor 8, low/high
        # freq cutoffs 1 and 4, original context 8192).
        factor, low, high, orig = 8.0, 1.0, 4.0, 8192.0
        wavelen = 2.0 * math.pi / freqs
        ratio = orig / wavelen
        smooth = torch.clamp((ratio - low) / (high - low), 0.0, 1.0)
        freqs = torch.where(ratio < low, freqs / factor,
                            torch.where(ratio > high, freqs,
                                        (1 - smooth) * freqs / factor +
                                        smooth * freqs))
    return positions.float()[:, None] * freqs[None, :]


def mlp_act(config: LlamaConfig) -> Callable[[torch.Tensor],
                                             torch.Tensor]:
    """The family's gated-MLP activation."""
    if config.mlp_activation == 'silu':
        return F.silu
    return lambda x: F.gelu(x, approximate='tanh')


def output_head(params: Params, config: LlamaConfig, layout=None):
    """[D, V] output projection — the transposed embedding when the
    config ties them. An int8 ``{'q', 's'}`` head comes back as it is:
    consume it with ``matmul`` or the fused CE, not ``@``. With a
    ``layout`` (``parallel/sharding.Layout``) the params are this rank's
    blocks, and the head is gathered over the data axes here, where it is
    used; at ``tp`` > 1 it is the rank's vocabulary columns [D, V/tp]."""
    if config.tie_embeddings:
        return _whole(layout, 'embed',
                      params['embed'].to(config.dtype)).T
    head = params['lm_head']
    if not isinstance(head, dict):
        head = head.to(config.dtype)
    return _whole(layout, 'lm_head', head)


def _whole(layout, name: str, x):
    """Top-level param ``name``'s value ``x`` gathered whole over the
    layout's data axes (``x`` itself without a layout)."""
    return x if layout is None else layout.gather(x, layout.params[name])


# ---------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------


def expert_einsum(subscript: str, x: torch.Tensor, w) -> torch.Tensor:
    """``einsum(subscript, x, w)`` over an expert stack ``w [E, in,
    out]``, plain or int8 ``{'q': [E, in, out], 's': [E, 1, out]}``: the
    int8 form is ``einsum(x, q.to(x.dtype)) * s``, the per-(expert,
    out-channel) scale after the contraction in its dtype (JAX's two
    rounding points, ``quant.expert_einsum`` there)."""
    if isinstance(w, dict):
        out = torch.einsum(subscript, x, w['q'].to(x.dtype))
        s = w['s'].to(out.dtype)
        return out * s.reshape(s.shape[0], *([1] * (out.dim() - 2)),
                               s.shape[-1])
    return torch.einsum(subscript, x, w)


def _moe_aux(config: LlamaConfig, idx: torch.Tensor, probs: torch.Tensor,
             layout=None) -> torch.Tensor:
    """The Switch aux loss of JAX's ``_moe_mlp``: ``E * sum(frac * pm)``,
    ``frac`` the share of (token, choice) entries each expert took and
    ``pm`` its mean probability, both means over the GLOBAL batch.

    With a ``layout`` whose batch's tokens are split over n > 1 ranks
    (the data axes and ``sp``, ``layout.token_axes``), each rank sums its
    [E] counts and probabilities and the two are summed over those axes
    in one all-reduce whose backward sums the gradient too
    (``layout.token_sum_grad``); the rank returns aux / n. The step
    reports ``layout.token_sum`` of the ranks' losses, which counts aux
    once, and the gradient of aux / n reaching the sum is summed over the
    n ranks on its way back, so each rank's probabilities get the whole
    d aux / d pm: the summed loss and the summed router gradient are the
    one-process step's. ``tp`` ranks compute it alike, as they do the
    router."""
    E, k = config.n_experts, config.moe_top_k
    counts = F.one_hot(idx.long(), E).sum((0, 1, 2)).to(probs.dtype)
    stats = torch.stack([counts, probs.sum((0, 1))])
    n, ranks = idx.shape[0] * idx.shape[1], 1
    if layout is not None and layout.token_ranks > 1:
        stats = layout.token_sum_grad(stats)
        ranks = layout.token_ranks
    n *= ranks
    frac = stats[0] / (n * k)
    return E * torch.sum(frac * (stats[1] / n)) / ranks


def _moe_mlp(config: LlamaConfig, h: torch.Tensor, layer_params: Params,
             layout=None):
    """The top-k routed expert MLP of the JAX ``_moe_mlp``: h [B, T, D]
    -> (out [B, T, D], the Switch aux loss f32, :func:`_moe_aux`). Each
    batch row is a routing group with per-expert capacity
    ``moe_capacity(config, T)``; (token, choice) slots go token-major, so
    earlier tokens win, and overflow is dropped (the residual passes).

    The f32 router (``route_for_training``: the ``moe_route`` kernels on
    the card, deterministic, so a layer's recompute under remat routes
    as its forward did), the gates rounded to h's dtype before the
    combine, and the capacity are JAX's; its one-hot dispatch and combine
    einsums are done as gathers that move the same values (the serving
    form, ``models/decode.moe_mlp``): each kept (token, choice) copies
    its row of h into row ``b C + slot`` of its expert's part of a zeroed
    ``[E, B C, D]`` buffer, the expert products run on the whole buffer
    (``expert_einsum``, plain or int8 stacks), and the combine reads each
    choice's output row back (a dropped one reads a zero row) and adds
    the k products ``out * gate`` in f32, rounded once. The gates and the
    aux carry gradients to h and the router.

    ``layout``: the expert stacks are this rank's ``[E / ep, D, F / tp]``
    (``w_down`` ``[E / ep, F / tp, D]``) blocks. Over ``ep`` the buffer
    goes to the experts' ranks and their outputs come back
    (``layout.to_experts`` / ``from_experts``, one all-to-all each way).
    Over ``tp`` the experts run on the rank's ffn columns between *f* on
    the dispatched rows' source (h) and one *g* after the combine. The
    router runs whole on every tp rank outside them, and so would sum
    its h gradient tp times under an *f*; but each rank's combine gives
    the gates only its columns' part of their gradient, so the gates
    pass through an *f* of their own (a [B, T, k] all-reduce
    backward).

    At ``sp`` > 1, h is the rank's ``T / sp`` positions of each row, and
    the routing group is still the whole row (:func:`_row_slots`): the
    capacity is the global T's and the slots are the row's."""
    b, t, d = h.shape
    E, k = config.n_experts, config.moe_top_k
    sp = 1 if layout is None else layout.sp
    cap = moe_capacity(config, t * sp)
    if sp == 1:
        idx, gate, slot, probs = moe_route_ops.route_for_training(
            h, layer_params['router'], k, cap)
    else:
        # Routed without a drop (no expert takes more than t entries of
        # t tokens), then given the row's slots.
        idx, gate, slot, probs = moe_route_ops.route_for_training(
            h, layer_params['router'], k, t)
        slot = _row_slots(layout, idx, slot, E, cap)
    aux = _moe_aux(config, idx, probs, layout)
    f = (lambda y: y) if layout is None else layout.copy_to_tp
    rows = b * cap
    first = torch.arange(b, dtype=torch.int32, device=h.device) * cap
    dest = torch.where(slot >= 0, idx * rows + first[:, None, None] + slot,
                       E * rows).view(-1).long()
    src = f(h)[:, :, None].expand(b, t, k, d).reshape(-1, d)
    xin = h.new_zeros((E * rows + 1, d)).index_copy(0, dest, src)
    xe = xin[:E * rows].view(E, rows, d)
    if layout is not None:
        xe = layout.to_experts(xe)
    g = expert_einsum('erd,edf->erf', xe, layer_params['w_gate'])
    up = expert_einsum('erd,edf->erf', xe, layer_params['w_up'])
    act = mlp_act(config)(g.float()).to(h.dtype)
    xout = expert_einsum('erf,efd->erd', act * up, layer_params['w_down'])
    if layout is not None:
        xout = layout.from_experts(xout)
    picked = torch.cat([xout.reshape(E * rows, d), xout.new_zeros((1, d))]
                       )[dest].view(b, t, k, d)
    weight = f(gate).to(h.dtype).float()
    out = (picked.float() * weight[..., None]).sum(2).to(h.dtype)
    if layout is not None:
        out = layout.reduce_from_tp(out)
    return out, aux


def _row_slots(layout, idx: torch.Tensor, slot: torch.Tensor, n_experts: int,
               cap: int) -> torch.Tensor:
    """The slots of the rank's (token, choice) entries in their WHOLE
    rows at ``sp`` > 1: JAX routes a row as one group, token-major, so an
    entry's slot is its slot among the rank's entries (``slot``, routed
    with no drop) plus the row's entries for the same expert on the
    ``sp`` ranks before it. Each rank's [B, E] counts go into its row of
    a zeroed [sp, B, E] tensor, summed over ``sp`` in one all-reduce;
    the exclusive prefix over the ranks gives the offsets. Entries at
    ``cap`` or past it are dropped (-1), as JAX drops them."""
    b = idx.shape[0]
    one_hot = F.one_hot(idx.long(), n_experts)          # [B, t, k, E]
    counts = torch.zeros((layout.sp, b, n_experts), dtype=torch.float32,
                         device=idx.device)
    counts[layout.sp_index] = one_hot.sum((1, 2)).float()
    counts = layout.sp_sum(counts)
    offset = counts[:layout.sp_index].sum(0).to(torch.int32)   # [B, E]
    row = slot + offset.gather(1, idx.reshape(b, -1).long()).view(idx.shape)
    return torch.where(row < cap, row, -1).to(torch.int32)


def _gathered_layer(layout, specs, config: LlamaConfig, x: torch.Tensor,
                    layer_params: Params, angles: torch.Tensor, attn_impl,
                    lora_params: Optional[Params] = None,
                    lora_scale: float = 1.0):
    """``_layer`` on this rank's blocks of one layer: each leaf (and
    adapter) sharded over a data axis is gathered whole first. Under
    remat this runs inside the layer's checkpoint, so its recompute
    gathers again and only one layer is whole at a time (ZeRO-3); the
    gathers' backward reduce-scatters the gradients to the blocks.
    ``specs``: the (params, lora) spec trees of one layer's slices. Dims
    sharded over ``tp`` stay the rank's: the block runs Megatron-style
    (``_layer``'s ``layout``)."""
    layer_params = layout.gather(layer_params, specs[0])
    if lora_params is not None:
        lora_params = layout.gather(lora_params, specs[1])
    return _layer(config, x, layer_params, angles, attn_impl, lora_params,
                  lora_scale, layout)


def _layer(config: LlamaConfig, x: torch.Tensor, layer_params: Params,
           angles: torch.Tensor, attn_impl,
           lora_params: Optional[Params] = None,
           lora_scale: float = 1.0, layout=None):
    """One transformer block. x: [B, T, D] -> ([B, T, D], the MoE aux
    loss, 0 for a dense block). LoRA deltas ``((h @ a) @ b) *
    lora_scale`` join q and v before RoPE, which the attention impl
    applies.

    With a ``layout`` at ``tp`` > 1 the weights are the rank's columns
    of q/k/v, gate and up (and their biases, and the adapters' B) and
    its rows of wo and w_down: the block runs on the rank's heads and
    ffn columns, with *f* (``layout.copy_to_tp``) on the normed input
    and *g* (``layout.reduce_from_tp``) after wo and after w_down. The
    adapters' A products read the same *f*-wrapped input, so their
    gradients come back partial, one part per rank's columns of B
    (``train.build_train_step`` sums them over ``tp``); the norms'
    gradients come back whole."""
    b, t, _ = x.shape
    hd = config.head_dim
    nh, nkv = ((config.n_heads, config.n_kv_heads) if layout is None
               else layout.heads(config))
    f = (lambda y: y) if layout is None else layout.copy_to_tp
    g = (lambda y: y) if layout is None else layout.reduce_from_tp

    h = f(_rms_norm(x, layer_params['attn_norm'], config.norm_eps,
                    config.norm_offset))
    q = matmul(h, layer_params['wq'])
    k = matmul(h, layer_params['wk'])
    v = matmul(h, layer_params['wv'])
    if config.qkv_bias:
        q = q + layer_params['bq']
        k = k + layer_params['bk']
        v = v + layer_params['bv']
    q = q.reshape(b, t, nh, hd)
    k = k.reshape(b, t, nkv, hd)
    v = v.reshape(b, t, nkv, hd)
    if lora_params is not None:
        dq = ((h @ lora_params['wq_a']) @ lora_params['wq_b']) * lora_scale
        dv = ((h @ lora_params['wv_a']) @ lora_params['wv_b']) * lora_scale
        q = q + dq.reshape(b, t, nh, hd).to(q.dtype)
        v = v + dv.reshape(b, t, nkv, hd).to(v.dtype)
    attn = attn_impl(q, k, v, angles).reshape(b, t, nh * hd)
    x = x + g(matmul(attn, layer_params['wo']))

    h = _rms_norm(x, layer_params['mlp_norm'], config.norm_eps,
                  config.norm_offset)
    if config.n_experts:
        out, aux = _moe_mlp(config, h, layer_params, layout)
        return x + out, aux
    h = f(h)
    gate = mlp_act(config)(
        matmul(h, layer_params['w_gate']).float()).to(h.dtype)
    up = matmul(h, layer_params['w_up'])
    return (x + g(matmul(gate * up, layer_params['w_down'])),
            torch.zeros((), dtype=torch.float32, device=x.device))


def default_attn_impl():
    """Causal flash attention with RoPE fused into the kernels (K1
    forward, K2/K3 backward on the card)."""
    return lambda q, k, v, ang: attention_ops.flash_attention(
        q, k, v, causal=True, rope_angles=ang)


def embed_tokens(cparams: Params, tokens: torch.Tensor,
                 config: LlamaConfig, layout=None) -> torch.Tensor:
    """Token embedding lookup (+ Gemma's sqrt(dim) scaling) on
    compute-dtype params. With a ``layout`` the table is gathered whole
    over the data axes for the lookup; at ``tp`` > 1 each rank holds a
    window of the vocabulary rows, looks up the ids inside it, writes
    zeros for the others and the ranks' rows are summed
    (``layout.reduce_from_tp``): exact, since one rank gives each row."""
    table = _whole(layout, 'embed', cparams['embed'])
    if layout is None or layout.tp == 1:
        x = table[tokens]
    else:
        lo, hi = layout.vocab_window(config.vocab_size)
        inside = (tokens >= lo) & (tokens < hi)
        rows = table[torch.where(inside, tokens - lo, 0)]
        x = layout.reduce_from_tp(rows.masked_fill(~inside[..., None], 0))
    if config.scale_embeddings:
        x = x * torch.tensor(math.sqrt(config.dim), dtype=x.dtype)
    return x


def shifted_loss_mask(batch: Dict[str, torch.Tensor],
                      targets: torch.Tensor) -> torch.Tensor:
    """loss_mask aligns with ``tokens``: position i contributes iff its
    *target* token i+1 is unmasked."""
    mask = batch.get('loss_mask')
    if mask is None:
        return torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    return mask.float()[:, 1:]


def _require_remat_supported(config: LlamaConfig) -> None:
    if config.remat and config.remat_saves != 'attn':
        raise NotImplementedError(
            f'remat_saves={config.remat_saves!r}: only the default '
            "'attn' is ported; saving mlp/mlp_up/qkv activations across "
            'the layer checkpoint is later work (ROADMAP.md Queue 2, '
            '"remat_saves")')


def compute_params(params: Params, config: LlamaConfig) -> Params:
    """Params in the compute dtype (the leaves themselves when they
    already are); gradients flow back to f32 masters through it. int8
    codes stay int8 (their scales take the compute dtype), as the JAX
    ``cparams`` rule leaves them."""
    def cast(node):
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        return node if node.dtype == torch.int8 else node.to(config.dtype)
    return cast(params)


def unbind_layers(w) -> list:
    """Per-layer slices of a stacked ``[L, ...]`` leaf or ``{'q', 's'}``
    pair (``unbind``: its backward stacks the per-layer grads once
    instead of scattering each into a zeroed [L, ...] buffer)."""
    if isinstance(w, dict):
        parts = {k: v.unbind(0) for k, v in w.items()}
        return [dict(zip(parts, vals)) for vals in zip(*parts.values())]
    return list(w.unbind(0))


def rank_angles(config: LlamaConfig, t: int, device,
                layout=None) -> torch.Tensor:
    """RoPE angles ``[t, head_dim / 2]`` of the rank's ``t`` positions
    of a row: ``0 .. t - 1``, or at ``sp`` > 1 the global positions of
    its shard, ``sp_index t + (0 .. t - 1)`` (JAX's ``local_angles``)."""
    start = 0 if layout is None or layout.sp == 1 else layout.sp_index * t
    return _rope_frequencies(config, torch.arange(start, start + t,
                                                  device=device))


def attention_impl(layout=None):
    """The layers' attention: causal flash attention with fused RoPE, or
    at ``sp`` > 1 ring attention over the rank's ``sp`` group with RoPE
    applied first at the global positions (``attention.apply_rope``, as
    JAX's ``make_ring_attention_impl``); its blocks run on the same
    kernels."""
    if layout is None or layout.sp == 1:
        return default_attn_impl()
    group = layout.mesh.group(('sp',))

    def impl(q, k, v, ang):
        return ring_attention_ops.ring_attention(
            attention_ops.apply_rope(q, ang), attention_ops.apply_rope(k, ang),
            v, group)
    return impl


def run_layers(config: LlamaConfig, x: torch.Tensor, layers: Params,
               angles: torch.Tensor, attn_impl,
               lora: Optional[Params] = None, lora_scale: float = 1.0,
               layout=None):
    """``x`` [B, T, D] through the stacked layers ``layers`` (compute
    dtype; with a ``layout`` this rank's blocks, gathered a layer at a
    time inside its call) and ``lora`` (the matching adapters), each
    layer under ``torch.utils.checkpoint`` when ``config.remat``. The
    stack is as deep as its leaves (a pipeline stage's ``L / pp``).
    Returns (x, the sum of the layers' MoE aux losses)."""
    stack = {name: unbind_layers(w) for name, w in layers.items()}
    body = _layer
    if layout is not None:
        body = functools.partial(_gathered_layer, layout,
                                 layout.layer_specs())
    loras = None
    if lora is not None:
        loras = {name: w.to(config.dtype).unbind(0)
                 for name, w in lora.items()}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(len(next(iter(stack.values())))):
        layer_params = {name: w[i] for name, w in stack.items()}
        layer_lora = (None if loras is None else
                      {name: w[i] for name, w in loras.items()})
        if config.remat:
            x, layer_aux = torch.utils.checkpoint.checkpoint(
                body, config, x, layer_params, angles, attn_impl,
                layer_lora, lora_scale, use_reentrant=False)
        else:
            x, layer_aux = body(config, x, layer_params, angles,
                                attn_impl, layer_lora, lora_scale)
        aux = aux + layer_aux
    return x, aux


def final_norm(cparams: Params, x: torch.Tensor,
               config: LlamaConfig) -> torch.Tensor:
    return _rms_norm(x, cparams['final_norm'], config.norm_eps,
                     config.norm_offset)


def forward_hidden(params: Params, tokens: torch.Tensor,
                   config: LlamaConfig,
                   positions: Optional[torch.Tensor] = None,
                   attn_impl=None, lora: Optional[Params] = None,
                   lora_scale: float = 1.0, with_aux: bool = False,
                   layout=None):
    """tokens [B, T] int -> final hidden states [B, T, D]
    (post-final-norm, compute dtype). Params may be f32 masters; they
    are cast to ``config.dtype`` where used and gradients flow back to
    them. ``lora``: optional stacked ``[L, ...]`` adapters. With
    ``with_aux`` returns (hidden, the layer-mean MoE aux loss; 0 for
    dense configs).

    ``layout`` (``parallel/sharding.Layout``): ``params`` and ``lora``
    are this rank's blocks; each layer's are gathered inside its
    checkpointed call (``_gathered_layer``), the embedding where it is
    looked up. The cast to the compute dtype runs on the blocks, before
    the gathers (elementwise: the same bits). At ``sp`` > 1 ``tokens``
    are the rank's shard of each row: RoPE runs at their global
    positions and attention is the ring (:func:`attention_impl`)."""
    _require_remat_supported(config)
    if attn_impl is None:
        attn_impl = attention_impl(layout)
    _, t = tokens.shape
    angles = (rank_angles(config, t, tokens.device, layout)
              if positions is None else _rope_frequencies(config, positions))
    cparams = compute_params(params, config)
    x = embed_tokens(cparams, tokens, config, layout)
    x, aux = run_layers(config, x, cparams['layers'], angles, attn_impl, lora,
                        lora_scale, layout)
    hidden = final_norm(cparams, x, config)
    if with_aux:
        return hidden, aux / config.n_layers
    return hidden


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            positions: Optional[torch.Tensor] = None, attn_impl=None,
            lora: Optional[Params] = None,
            lora_scale: float = 1.0) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] (f32)."""
    x = forward_hidden(params, tokens, config, positions, attn_impl, lora,
                       lora_scale)
    return matmul(x, output_head(params, config)).float()


def _ce_from_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Per-position NLL: logsumexp minus the target logit, in f32."""
    lf = logits.float()
    tgt = lf.gather(-1, targets[..., None])[..., 0]
    return torch.logsumexp(lf, dim=-1) - tgt


# Sequence-chunk size of the fused head + CE. 512 keeps the f32 temp at
# B * 512 * V (~0.25 GB per batch row for the 128k Llama-3 vocab).
LOSS_CHUNK = 512


class _FusedCE(torch.autograd.Function):
    """Chunked LM head + cross-entropy with the hidden-state gradient
    computed EAGERLY in the forward (the JAX ``_fused_ce``).

    dloss/dlogits = softmax - onehot is known in closed form, so each
    chunk's dhidden = dlogits @ W^T is produced while its logits are
    live and the [B, T, V] logits never exist at once; backward only
    scales the stored [B, T, D] dhidden (and the [D, V] dW when the head
    trains) by ``g / denom``. Inputs: hidden [B, T, D], lm_head [D, V]
    (or a frozen int8 ``{'q', 's'}`` pair: QLoRA), targets [B, T], mask
    [B, T] f32, and ``count``: the unmasked positions the mean divides
    by (None: this call's own; a sharded step passes the global count,
    so each rank's loss is its share of the global masked mean).
    Returns the mean NLL over unmasked positions.

    An int8 head is converted to the hidden dtype once per call, not
    once per chunk; its logits are ``(h @ q) * s`` as ``matmul`` forms
    them, and dhidden is ``(dlogits * s) @ q^T`` (the JAX
    ``_head_mm_t``).

    ``layout`` (``tp`` > 1): the head is this rank's vocabulary columns
    (``layout.vocab_window``; an int8 head's scale with them). A chunk's
    row max is all-reduced with MAX over ``tp``, then its sums of exps
    and its targets' logits (each from the rank whose window holds the
    target, zeros elsewhere) in one SUM; each rank's dhidden is its
    columns' part, summed over ``tp`` once after the last chunk. A
    trained head's dW stays the rank's block, and the loss is the whole
    loss on every rank."""

    @staticmethod
    def forward(ctx, hidden, lm_head, targets, mask, chunk, train_head,
                count=None, layout=None):
        _, t, _ = hidden.shape
        ns = torch.zeros((), dtype=torch.float32, device=hidden.device)
        ms = torch.zeros((), dtype=torch.float32, device=hidden.device)
        dh = torch.empty_like(hidden)
        quantized = isinstance(lm_head, dict)
        if quantized:
            if train_head:
                raise ValueError('an int8 LM head is frozen: it cannot '
                                 'train')
            w = lm_head['q'].to(hidden.dtype)
            s = lm_head['s'].to(hidden.dtype)
        else:
            w, s = lm_head, None
        if layout is not None:
            lo = layout.vocab_window(w.shape[1] * layout.tp)[0]
            targets = targets - lo
        dw = (torch.zeros(w.shape, dtype=torch.float32,
                          device=hidden.device) if train_head else None)
        for c0 in range(0, t, chunk):
            h = hidden[:, c0:c0 + chunk]
            tg = targets[:, c0:c0 + chunk]
            mk = mask[:, c0:c0 + chunk]
            logits = h @ w
            if quantized:
                logits = logits * s
            logits = logits.float()  # [B, C, V]
            if layout is None:
                lse = torch.logsumexp(logits, dim=-1)
                nll = lse - logits.gather(-1, tg[..., None])[..., 0]
                hot = torch.full(tg[..., None].shape, -1.0,
                                 device=logits.device)
            else:
                lse, nll, tg, hot = _tp_lse_nll(layout, logits, tg)
            ns = ns + (nll * mk).sum()
            ms = ms + mk.sum()
            dlog = torch.exp(logits.sub_(lse[..., None]))
            dlog.scatter_add_(-1, tg[..., None], hot)
            dlog = (dlog * mk[..., None]).to(h.dtype)
            if quantized:
                dlog = dlog * s
            dh[:, c0:c0 + chunk] = dlog @ w.T
            if train_head:
                dw += torch.einsum('bcd,bcv->dv', h.float(), dlog.float())
            del logits, dlog
        if layout is not None:
            layout.tp_sum(dh)
        denom = torch.clamp(ms if count is None else count, min=1.0)
        ctx.save_for_backward(dh, dw, denom)
        ctx.head_meta = None if quantized else (w.shape, w.dtype)
        ctx.train_head = train_head
        return ns / denom

    @staticmethod
    def backward(ctx, g):
        dh, dw, denom = ctx.saved_tensors
        scale = g / denom
        dhid = dh * scale.to(dh.dtype)
        if ctx.train_head:
            dlm = (dw * scale).to(dh.dtype)
        elif ctx.head_meta is None:
            dlm = None  # a frozen int8 head: no gradient
        else:
            shape, dtype = ctx.head_meta
            dlm = torch.zeros(shape, dtype=dtype, device=dh.device)
        return dhid, dlm, None, None, None, None, None, None


def _tp_lse_nll(layout, logits: torch.Tensor, tg: torch.Tensor):
    """One chunk's (lse, nll) over the vocabulary sharded on ``tp``:
    ``logits`` [B, C, V/tp] this rank's columns, ``tg`` the targets
    less the window's start. Returns them with the targets clamped into
    the window and the one-hot's [B, C, 1] f32 entries (-1 where the
    target is this rank's, 0 elsewhere) for the softmax gradient."""
    inside = (tg >= 0) & (tg < logits.shape[-1])
    tg = tg.clamp(0, logits.shape[-1] - 1)
    m = layout.tp_max(logits.amax(-1))
    sumexp, picked = layout.tp_sum(torch.stack([
        torch.exp(logits - m[..., None]).sum(-1),
        logits.gather(-1, tg[..., None])[..., 0].masked_fill(~inside, 0)]))
    lse = m + torch.log(sumexp)
    return lse, lse - picked, tg, -inside.float()[..., None]


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig, lora: Optional[Params] = None,
            lora_scale: float = 1.0, attn_impl=None,
            layout=None) -> torch.Tensor:
    """Causal LM cross-entropy over positions predicting
    ``tokens[:, 1:]`` (mask-aware if the batch has 'loss_mask'), plus
    ``moe_aux_coef`` times the layer-mean aux loss for MoE configs.
    ``tokens`` is [B, T+1]: the forward runs on the first T.

    With a ``layout`` the batch is this rank's rows (at ``sp`` > 1 its
    positions of them) and the params its blocks; the result is this
    rank's share of the GLOBAL masked mean (its masked NLL sum over the
    count all-reduced over the data axes and ``sp``), so the shares sum
    to the loss of the whole batch."""
    tokens = batch['tokens']
    inputs = tokens[:, :-1]
    targets = tokens[:, 1:]
    hidden, moe_aux = forward_hidden(params, inputs, config, lora=lora,
                                     lora_scale=lora_scale,
                                     attn_impl=attn_impl, with_aux=True,
                                     layout=layout)
    mask = shifted_loss_mask(batch, targets)
    # The head is frozen exactly when training LoRA adapters: skip its
    # [D, V] gradient then.
    ce = loss_from_hidden(params, hidden, targets, mask, config,
                          train_lm_head=lora is None, layout=layout)
    if config.n_experts:
        ce = ce + config.moe_aux_coef * moe_aux
    return ce


def loss_from_hidden(params: Params, hidden: torch.Tensor,
                     targets: torch.Tensor, mask: torch.Tensor,
                     config: LlamaConfig, train_lm_head: bool = True,
                     layout=None, count=None) -> torch.Tensor:
    """Chunked fused LM-head + CE over final hidden states (with a
    ``layout``: over the global unmasked count, as ``loss_fn`` says).
    ``count``: the count to divide by, where the caller has it (a
    pipeline's microbatch divides by the whole batch's)."""
    t = hidden.shape[1]
    chunk = LOSS_CHUNK if t % LOSS_CHUNK == 0 else t
    mask = mask.float()
    if count is None and layout is not None:
        count = layout.token_sum(mask.sum())
    tp = layout if layout is not None and layout.tp > 1 else None
    return _FusedCE.apply(hidden, output_head(params, config, layout),
                          targets.long(), mask, chunk, train_lm_head,
                          count, tp)
