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
a LoRA step runs over an int8 frozen base (QLoRA). MoE configs raise
until their slice (ROADMAP.md).

Under ``config.remat`` each layer runs in ``torch.utils.checkpoint``
(non-reentrant): only the layer inputs are kept, and backward runs the
layer's forward again — the flash forward kernel included. Keeping the
kernel's out/lse across the checkpoint (the JAX ``remat_policy``) and
the other ``remat_saves`` tokens are later work (ROADMAP.md Queue 2).
"""
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from skypilot_torch import device as device_lib
from skypilot_torch.ops import attention as attention_ops

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


def require_dense(config: LlamaConfig) -> None:
    """Raise for configs this slice of the port cannot run yet."""
    if config.n_experts:
        raise NotImplementedError(
            f'{config.name}: MoE layers (n_experts={config.n_experts}) '
            'are not ported yet; they come with the MoE slice in '
            'ROADMAP.md (Queue 1, "MoE")')


# ---------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------


def init_params(config: LlamaConfig, seed: int = 0,
                dtype: Optional[torch.dtype] = None,
                device=None, quantize=None) -> Params:
    """Random params in the JAX package's layout (stacked ``[L, ...]``,
    ``[in, out]`` projections): ``normal / sqrt(fan_in)`` drawn in f32
    from an explicit ``torch.Generator`` seeded with ``seed``, then
    cast to ``dtype`` (default ``config.dtype``). Norms init to ones
    (zeros under ``norm_offset``), q/k/v biases to zeros.

    The draws differ from ``jax.random`` for the same seed; tests carry
    JAX's weights across with ``convert.params_from_numpy`` instead.
    Stacked weights are drawn one layer at a time so the f32 temporary
    is one layer's slice, not the whole stack (8B: ~0.2 GB, not 7.5).
    ``quantize`` (``quant.quantize_weight``; use ``quant.init_quantized``)
    turns each matmul weight's layer slice and the LM head into an int8
    ``{'q', 's'}`` pair as it is drawn, so the wide stack never exists.
    """
    require_dense(config)
    dev = device_lib.resolve_device(device)
    dtype = dtype or config.dtype
    d = config.dim
    hd = config.head_dim
    nh, nkv = config.n_heads, config.n_kv_heads
    ffn = config.ffn_hidden
    L = config.n_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def dense(shape, fan_in):
        scale = 1.0 / math.sqrt(fan_in)
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    def stacked(shape, fan_in):
        if quantize is not None:
            out = {'q': torch.empty((L,) + shape, dtype=torch.int8,
                                    device=dev),
                   's': torch.empty((L, 1, shape[-1]),
                                    dtype=torch.bfloat16, device=dev)}
            for i in range(L):
                part = quantize(dense(shape, fan_in))
                out['q'][i], out['s'][i] = part['q'], part['s']
            return out
        out = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for i in range(L):
            out[i] = dense(shape, fan_in)
        return out

    def norm_init(shape):
        fill = torch.zeros if config.norm_offset else torch.ones
        return fill(shape, dtype=dtype, device=dev)

    params: Params = {
        'embed': dense((config.vocab_size, d), d),
        'layers': {
            'wq': stacked((d, nh * hd), d),
            'wk': stacked((d, nkv * hd), d),
            'wv': stacked((d, nkv * hd), d),
            'wo': stacked((nh * hd, d), nh * hd),
            'w_gate': stacked((d, ffn), d),
            'w_up': stacked((d, ffn), d),
            'w_down': stacked((ffn, d), ffn),
            'attn_norm': norm_init((L, d)),
            'mlp_norm': norm_init((L, d)),
        },
        'final_norm': norm_init((d,)),
    }
    if config.qkv_bias:
        for name, width in (('bq', nh * hd), ('bk', nkv * hd),
                            ('bv', nkv * hd)):
            params['layers'][name] = torch.zeros((L, width), dtype=dtype,
                                                 device=dev)
    if not config.tie_embeddings:
        params['lm_head'] = dense((d, config.vocab_size), d)
        if quantize is not None:
            params['lm_head'] = quantize(params['lm_head'])
    return params


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


def output_head(params: Params, config: LlamaConfig):
    """[D, V] output projection — the transposed embedding when the
    config ties them. An int8 ``{'q', 's'}`` head comes back as it is:
    consume it with ``matmul`` or the fused CE, not ``@``."""
    if config.tie_embeddings:
        return params['embed'].to(config.dtype).T
    head = params['lm_head']
    if isinstance(head, dict):
        return head
    return head.to(config.dtype)


# ---------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------


def _layer(config: LlamaConfig, x: torch.Tensor, layer_params: Params,
           angles: torch.Tensor, attn_impl,
           lora_params: Optional[Params] = None,
           lora_scale: float = 1.0) -> torch.Tensor:
    """One transformer block (dense). x: [B, T, D] -> [B, T, D].
    LoRA deltas ``((h @ a) @ b) * lora_scale`` join q and v before
    RoPE, which the attention impl applies."""
    b, t, _ = x.shape
    nh, nkv, hd = config.n_heads, config.n_kv_heads, config.head_dim

    h = _rms_norm(x, layer_params['attn_norm'], config.norm_eps,
                  config.norm_offset)
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
    x = x + matmul(attn, layer_params['wo'])

    h = _rms_norm(x, layer_params['mlp_norm'], config.norm_eps,
                  config.norm_offset)
    gate = mlp_act(config)(
        matmul(h, layer_params['w_gate']).float()).to(h.dtype)
    up = matmul(h, layer_params['w_up'])
    return x + matmul(gate * up, layer_params['w_down'])


def default_attn_impl():
    """Causal flash attention with RoPE fused into the kernels (K1
    forward, K2/K3 backward on the card)."""
    return lambda q, k, v, ang: attention_ops.flash_attention(
        q, k, v, causal=True, rope_angles=ang)


def embed_tokens(cparams: Params, tokens: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """Token embedding lookup (+ Gemma's sqrt(dim) scaling) on
    compute-dtype params."""
    x = cparams['embed'][tokens]
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


def forward_hidden(params: Params, tokens: torch.Tensor,
                   config: LlamaConfig,
                   positions: Optional[torch.Tensor] = None,
                   attn_impl=None, lora: Optional[Params] = None,
                   lora_scale: float = 1.0) -> torch.Tensor:
    """tokens [B, T] int -> final hidden states [B, T, D]
    (post-final-norm, compute dtype). Params may be f32 masters; they
    are cast to ``config.dtype`` where used and gradients flow back to
    them. ``lora``: optional stacked ``[L, ...]`` adapters."""
    require_dense(config)
    _require_remat_supported(config)
    if attn_impl is None:
        attn_impl = default_attn_impl()
    _, t = tokens.shape
    if positions is None:
        positions = torch.arange(t, device=tokens.device)
    angles = _rope_frequencies(config, positions)
    cparams = compute_params(params, config)
    x = embed_tokens(cparams, tokens, config)
    layers = {name: unbind_layers(w)
              for name, w in cparams['layers'].items()}
    loras = None
    if lora is not None:
        loras = {name: w.to(config.dtype).unbind(0)
                 for name, w in lora.items()}
    for i in range(config.n_layers):
        layer_params = {name: w[i] for name, w in layers.items()}
        layer_lora = (None if loras is None else
                      {name: w[i] for name, w in loras.items()})
        if config.remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, config, x, layer_params, angles, attn_impl,
                layer_lora, lora_scale, use_reentrant=False)
        else:
            x = _layer(config, x, layer_params, angles, attn_impl,
                       layer_lora, lora_scale)
    return _rms_norm(x, cparams['final_norm'], config.norm_eps,
                     config.norm_offset)


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
    [B, T] f32. Returns the mean NLL over unmasked positions.

    An int8 head is converted to the hidden dtype once per call, not
    once per chunk; its logits are ``(h @ q) * s`` as ``matmul`` forms
    them, and dhidden is ``(dlogits * s) @ q^T`` (the JAX
    ``_head_mm_t``)."""

    @staticmethod
    def forward(ctx, hidden, lm_head, targets, mask, chunk, train_head):
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
            lse = torch.logsumexp(logits, dim=-1)
            nll = lse - logits.gather(-1, tg[..., None])[..., 0]
            ns = ns + (nll * mk).sum()
            ms = ms + mk.sum()
            dlog = torch.exp(logits.sub_(lse[..., None]))
            dlog.scatter_add_(-1, tg[..., None],
                              torch.full(tg[..., None].shape, -1.0,
                                         device=dlog.device))
            dlog = (dlog * mk[..., None]).to(h.dtype)
            if quantized:
                dlog = dlog * s
            dh[:, c0:c0 + chunk] = dlog @ w.T
            if train_head:
                dw += torch.einsum('bcd,bcv->dv', h.float(), dlog.float())
            del logits, dlog
        denom = torch.clamp(ms, min=1.0)
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
        return dhid, dlm, None, None, None, None


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig, lora: Optional[Params] = None,
            lora_scale: float = 1.0, attn_impl=None) -> torch.Tensor:
    """Causal LM cross-entropy over positions predicting
    ``tokens[:, 1:]`` (mask-aware if the batch has 'loss_mask').
    ``tokens`` is [B, T+1]: the forward runs on the first T."""
    tokens = batch['tokens']
    inputs = tokens[:, :-1]
    targets = tokens[:, 1:]
    hidden = forward_hidden(params, inputs, config, lora=lora,
                            lora_scale=lora_scale, attn_impl=attn_impl)
    mask = shifted_loss_mask(batch, targets)
    # The head is frozen exactly when training LoRA adapters: skip its
    # [D, V] gradient then.
    return loss_from_hidden(params, hidden, targets, mask, config,
                            train_lm_head=lora is None)


def loss_from_hidden(params: Params, hidden: torch.Tensor,
                     targets: torch.Tensor, mask: torch.Tensor,
                     config: LlamaConfig,
                     train_lm_head: bool = True) -> torch.Tensor:
    """Chunked fused LM-head + CE over final hidden states."""
    t = hidden.shape[1]
    chunk = LOSS_CHUNK if t % LOSS_CHUNK == 0 else t
    return _FusedCE.apply(hidden, output_head(params, config),
                          targets.long(), mask.float(), chunk,
                          train_lm_head)
