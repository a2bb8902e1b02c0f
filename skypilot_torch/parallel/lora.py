"""LoRA adapters for the Llama family — the port of
``skypilot_tpu/parallel/lora.py``.

Adapters attach to the q/v projections (torchtune's defaults, as in the
reference recipe ``llm/llama-3_1-finetuning/lora.yaml``), stored
STACKED over layers like the base weights: ``wq_a`` [L, D, r], ``wq_b``
[L, r, H*hd], ``wv_a`` [L, D, r], ``wv_b`` [L, r, Hkv*hd]. The sharding
rules wait for the sharding slice (ROADMAP.md).
"""
import math
from typing import Any, Dict

import numpy as np
import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama

Lora = Dict[str, Any]


def init_lora(config: llama.LlamaConfig, seed: int = 0, rank: int = 16,
              dtype: torch.dtype = torch.float32, device=None) -> Lora:
    """Zero B and gaussian A (``normal / sqrt(dim)``, drawn in f32 from
    an explicit ``torch.Generator`` seeded with ``seed``), so the delta
    starts at 0. The draws differ from ``jax.random``; tests carry JAX's
    adapters across with ``convert.tree_from_numpy``."""
    dev = device_lib.resolve_device(device)
    L, d = config.n_layers, config.dim
    q_out = config.n_heads * config.head_dim
    v_out = config.n_kv_heads * config.head_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def a_init():
        return (torch.randn((L, d, rank), generator=gen, device=dev,
                            dtype=torch.float32) / math.sqrt(d)).to(dtype)

    return {
        'wq_a': a_init(),
        'wq_b': torch.zeros((L, rank, q_out), dtype=dtype, device=dev),
        'wv_a': a_init(),
        'wv_b': torch.zeros((L, rank, v_out), dtype=dtype, device=dev),
    }


def merge_lora(params: llama.Params, lora: Lora,
               scale: float = 2.0) -> llama.Params:
    """Fold the adapters into the base wq/wv (for export or serving):
    ``w + scale * (a @ b)`` cast to the weight's dtype."""
    merged = dict(params)
    layers = dict(params['layers'])
    for w, a, b in (('wq', 'wq_a', 'wq_b'), ('wv', 'wv_a', 'wv_b')):
        base = params['layers'][w]
        layers[w] = base + scale * torch.einsum(
            'ldr,lro->ldo', lora[a], lora[b]).to(base.dtype)
    merged['layers'] = layers
    return merged


def merge_lora_host(params: Dict[str, Any], lora: Dict[str, Any],
                    scale: float = 2.0) -> Dict[str, Any]:
    """``merge_lora`` on host numpy trees, leaf by leaf, in f32: for
    checkpoint-restored trees that should not land on one device whole
    first. Merged leaves keep the base weight's dtype."""
    merged = dict(params)
    layers = dict(params['layers'])
    for w, a, b in (('wq', 'wq_a', 'wq_b'), ('wv', 'wv_a', 'wv_b')):
        base = np.asarray(layers[w])
        delta = scale * np.einsum('ldr,lro->ldo',
                                  np.asarray(lora[a], np.float32),
                                  np.asarray(lora[b], np.float32))
        layers[w] = (base.astype(np.float32) + delta).astype(base.dtype)
    merged['layers'] = layers
    return merged
