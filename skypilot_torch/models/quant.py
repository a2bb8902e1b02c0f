"""Weight-only int8 quantization — the port of
``skypilot_tpu/models/quant.py``.

Symmetric per-output-channel int8: a matmul weight ``w [..., in, out]``
becomes ``{'q': int8 [..., in, out], 's': bf16 [..., 1, out]}`` with
``w ~= q * s``, and ``llama.matmul`` applies it as
``(x @ q.to(x.dtype)) * s`` (the scale after the product, exact for
per-output-channel scaling). Quantized: the stacked layer projections
(``_LAYER_MATMULS``) and the LM head; the embedding, norms and biases
stay in the compute dtype. Codes and scales equal the JAX package's bit
for bit: amax in f32 over the contraction axis (-2), ``s = max(amax,
1e-8) / 127`` rounded to bf16 BEFORE encoding, codes ``clip(round(w /
s), -127, 127)`` with round-half-to-even (``torch.round`` as
``jnp.round``).

Port difference: the JAX ``matmul`` lets XLA fuse the int8 -> bf16
convert into the dot; here the convert materializes a copy of the
weight per call before cuBLAS (a fused dequant GEMV is later work,
ROADMAP.md Queue 2). ``[L, in, out]`` stacks are quantized one layer
slice at a time, so the f32 temporary is one layer's, never the
stack's (7.5 GB for llama3-8b's ``w_gate``). MoE expert weights come
with the MoE slice.
"""
from typing import Any, Dict

import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama

Params = Dict[str, Any]

# Leaves under params['layers'] that are [L, in, out] matmul weights.
_LAYER_MATMULS = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')


def _quantize_stack(w: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    """``quantize_weight`` of ``w [L, ..., in, out]`` one leading slice
    at a time, each moved to ``device`` first, into outputs allocated
    once."""
    q = torch.empty(w.shape, dtype=torch.int8, device=device)
    s = torch.empty(w.shape[:-2] + (1, w.shape[-1]), dtype=torch.bfloat16,
                    device=device)
    for i in range(w.shape[0]):
        part = quantize_weight(w[i].to(device))
        q[i], s[i] = part['q'], part['s']
    return {'q': q, 's': s}


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{'q': int8, 's': bf16}`` for ``w [..., in, out]``, the scale
    reduced over the contraction axis (-2) only, so a stacked leaf keeps
    one scale row per layer. Leading axes are quantized one slice at a
    time (the f32 temporary is one slice)."""
    if w.dim() > 2:
        return _quantize_stack(w, w.device)
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp(amax, min=1e-8) / 127.0
    # Encode against the bf16-rounded scale that is stored, so q * s
    # reconstructs exactly.
    s = s.to(torch.bfloat16).float()
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {'q': q, 's': s.to(torch.bfloat16)}


matmul = llama.matmul


def expert_einsum(subscript: str, x: torch.Tensor, w) -> torch.Tensor:
    """The MoE dispatch's int8-aware einsum: MoE layers come with the
    MoE slice."""
    raise NotImplementedError(
        'expert_einsum: MoE expert weights are not ported yet; they come '
        'with the MoE slice in ROADMAP.md (Queue 1, "MoE")')


def quantize_params(params: Params, config: llama.LlamaConfig) -> Params:
    """A params tree with the big matmul weights replaced by
    ``{'q', 's'}`` pairs (the rest shared, not copied)."""
    llama.require_dense(config)
    out = dict(params)
    layers = dict(params['layers'])
    for name in _LAYER_MATMULS:
        if name in layers:
            layers[name] = quantize_weight(layers[name])
    out['layers'] = layers
    if 'lm_head' in params:
        out['lm_head'] = quantize_weight(params['lm_head'])
    return out


def init_quantized(config: llama.LlamaConfig, seed: int = 0,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Params:
    """Random params with the matmul weights quantized as they
    materialize, leaf by leaf on ``device`` (default ``'cuda'``): the
    wide tree never exists (llama3-8b's bf16 tree is 16 GB; the int8
    tree ~8.6 GB with its bf16 embedding). The draws are
    ``llama.init_params``'s (same generator, same order), so the result
    equals ``quantize_params(init_params(config, seed, dtype))``."""
    return llama.init_params(config, seed, dtype=dtype, device=device,
                             quantize=quantize_weight)


def quantize_params_streamed(params: Params, config: llama.LlamaConfig,
                             device=None) -> Params:
    """``quantize_params`` for HOST-resident trees (checkpoint
    restores): one leaf at a time goes to ``device`` (default
    ``'cuda'``) and is quantized there, one layer slice at a time, so
    the wide tree never sits on the card whole. Leaves that stay wide
    are cast to ``config.dtype``."""
    llama.require_dense(config)
    dev = device_lib.resolve_device(device)
    out = dict(params)
    out['layers'] = {}
    for name, leaf in params['layers'].items():
        out['layers'][name] = (_quantize_stack(leaf, dev)
                               if name in _LAYER_MATMULS
                               else leaf.to(dev, config.dtype))
    for name in ('embed', 'final_norm'):
        out[name] = params[name].to(dev, config.dtype)
    if 'lm_head' in params:
        out['lm_head'] = quantize_weight(params['lm_head'].to(dev))
    return out


def is_quantized(params: Params) -> bool:
    wq = params.get('layers', {}).get('wq')
    return isinstance(wq, dict) and 'q' in wq
