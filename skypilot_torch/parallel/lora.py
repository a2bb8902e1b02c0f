"""LoRA adapters for the Llama family — the port of
``skypilot_tpu/parallel/lora.py``.

Adapters attach to the q/v projections (torchtune's defaults, as in the
reference recipe ``llm/llama-3_1-finetuning/lora.yaml``), stored
STACKED over layers like the base weights: ``wq_a`` [L, D, r], ``wq_b``
[L, r, H*hd], ``wv_a`` [L, D, r], ``wv_b`` [L, r, Hkv*hd], sharded
over a mesh by ``lora_sharding_rules``.
"""
import math
from typing import Any, Dict

import numpy as np
import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama

Lora = Dict[str, Any]


def init_lora(config: llama.LlamaConfig, seed: int = 0, rank: int = 16,
              dtype: torch.dtype = torch.float32, device=None,
              window=None) -> Lora:
    """Zero B and gaussian A (``normal / sqrt(dim)``, drawn in f32 from
    an explicit ``torch.Generator`` seeded with ``seed``), so the delta
    starts at 0. The draws differ from ``jax.random``; tests carry JAX's
    adapters across with ``convert.tree_from_numpy``. ``window`` and
    ``device='meta'`` as in ``llama.init_params``."""
    dev = device_lib.resolve_device(device, allow_meta=True)
    L, d = config.n_layers, config.dim
    q_out = config.n_heads * config.head_dim
    v_out = config.n_kv_heads * config.head_dim
    gen = device_lib.generator(dev, seed)

    def kept(name, x):
        if window is None:
            return x
        return x[window((name,), tuple(x.shape))].clone()

    def a_init(name):
        return kept(name, (torch.randn((L, d, rank), generator=gen,
                                       device=dev, dtype=torch.float32) /
                           math.sqrt(d)).to(dtype))

    return {
        'wq_a': a_init('wq_a'),
        'wq_b': kept('wq_b', torch.zeros((L, rank, q_out), dtype=dtype,
                                         device=dev)),
        'wv_a': a_init('wv_a'),
        'wv_b': kept('wv_b', torch.zeros((L, rank, v_out), dtype=dtype,
                                         device=dev)),
    }


def lora_sharding_rules(config: llama.LlamaConfig,
                        pipeline: bool = False) -> Dict[str, Any]:
    """The JAX ``lora_sharding_rules``: A shards its input dim on fsdp;
    B shards its output (head) dim on tp, matching the base wq/wv
    specs. The stacked layer axis is replicated, as the base weights'
    is, or under pipeline parallelism (``pipeline=True``) sharded over
    'pp' like theirs."""
    del config
    pl = 'pp' if pipeline else None
    return {
        'wq_a': (pl, 'fsdp', None),
        'wq_b': (pl, None, 'tp'),
        'wv_a': (pl, 'fsdp', None),
        'wv_b': (pl, None, 'tp'),
    }


# The adapters whose gradient a tp rank gets in part: the A factors are
# replicated over tp, but each rank's gradient of A comes back through
# its own columns of B (``llama._layer``), so the step sums it over tp.
TP_PARTIAL_GRADS = ('wq_a', 'wv_a')


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


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to('cpu', torch.float32).numpy()
    return np.asarray(x, np.float32)


def merge_lora_host(params: Dict[str, Any], lora: Dict[str, Any],
                    scale: float = 2.0) -> Dict[str, Any]:
    """``merge_lora`` on HOST trees, leaf by leaf, in f32 numpy as the
    JAX ``merge_lora_host`` computes it: for checkpoint-restored trees
    that should not land on one device whole first. Leaves may be numpy
    arrays or host tensors (bfloat16 ones included); merged leaves keep
    the base weight's type and dtype."""
    merged = dict(params)
    layers = dict(params['layers'])
    for w, a, b in (('wq', 'wq_a', 'wq_b'), ('wv', 'wv_a', 'wv_b')):
        base = layers[w]
        delta = scale * np.einsum('ldr,lro->ldo', _host_f32(lora[a]),
                                  _host_f32(lora[b]))
        out = _host_f32(base) + delta
        layers[w] = (torch.from_numpy(out).to(base.dtype)
                     if isinstance(base, torch.Tensor)
                     else out.astype(np.asarray(base).dtype))
    merged['layers'] = layers
    return merged
