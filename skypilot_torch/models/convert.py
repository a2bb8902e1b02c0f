"""Weight bridge between the JAX package's params tree and the port's.

The two share key names and layouts (stacked ``[L, ...]`` layers,
``[in, out]`` projections), so the bridge is a leaf-for-leaf copy:
:func:`params_from_numpy` takes the JAX tree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``) and
:func:`params_to_numpy` is its inverse. bf16 leaves cross as f32 numpy
arrays (numpy has no bfloat16) and are cast back to
``config.dtype`` on the way in. An int8-quantized weight, a
``{'q', 's'}`` pair, crosses as int8 codes and scales (f32 numpy on the
way out, bf16 tensors on the way in), in both directions.

The same copy carries LoRA adapter trees (:func:`tree_from_numpy`) and
the trainable part of a JAX ``TrainState`` (its ``params`` and
``lora``) into a port ``TrainState`` with a fresh optimizer state
(:func:`train_state_from_numpy`), and back
(:func:`train_state_to_numpy`).
"""
from typing import Any, Dict, Optional

import numpy as np
import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama
from skypilot_torch.parallel import train as train_lib

Params = Dict[str, Any]


def _is_int8_pair(node) -> bool:
    return isinstance(node, dict) and set(node) == {'q', 's'}


def tree_from_numpy(tree: Dict[str, Any], dtype: torch.dtype,
                    device=None) -> Params:
    """Nested dict of numpy arrays -> nested dict of ``dtype`` tensors
    on ``device`` (default ``'cuda'``). An int8 ``{'q', 's'}`` pair
    (``models/quant.py``) keeps its int8 codes and bf16 scales."""
    dev = device_lib.resolve_device(device)

    def leaf(x, to=dtype):
        arr = np.asarray(x)
        if arr.dtype.kind not in 'fci':
            # ml_dtypes' bfloat16 (what np.asarray gives for a JAX
            # bf16 leaf) has kind 'V'; go through f32 first.
            arr = arr.astype(np.float32)
        return torch.tensor(arr, dtype=to, device=dev)

    def walk(node):
        if _is_int8_pair(node):
            if np.asarray(node['q']).dtype != np.int8:
                raise TypeError(f'an int8 {{q, s}} pair needs int8 codes, '
                                f'got {np.asarray(node["q"]).dtype}')
            return {'q': leaf(node['q'], torch.int8),
                    's': leaf(node['s'], torch.bfloat16)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def params_from_numpy(tree: Dict[str, Any], config: llama.LlamaConfig,
                      device=None) -> Params:
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (default ``'cuda'``) in ``config.dtype``."""
    llama.require_dense(config)
    return tree_from_numpy(tree, config.dtype, device)


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """Inverse of :func:`params_from_numpy`: nested dict of f32 numpy
    arrays (bf16 widens exactly); int8 codes stay int8."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if node.dtype == torch.int8:
            return node.detach().cpu().numpy()
        return node.detach().to('cpu', torch.float32).numpy()

    return walk(params)


def train_state_from_numpy(params: Dict[str, Any],
                           lora: Optional[Dict[str, Any]],
                           param_dtype: torch.dtype,
                           device=None) -> train_lib.TrainState:
    """A JAX ``TrainState``'s ``params`` and ``lora`` (numpy trees, lora
    None for a full finetune) -> a port ``TrainState`` at step 0 in
    ``param_dtype``, with a fresh (zero) AdamW state for its trainable
    tree."""
    p = tree_from_numpy(params, param_dtype, device)
    lo = None if lora is None else tree_from_numpy(lora, param_dtype,
                                                   device)
    opt_state = train_lib.default_optimizer().init(p if lo is None else lo)
    return train_lib.TrainState(step=0, params=p, opt_state=opt_state,
                                lora=lo)


def train_state_to_numpy(state: train_lib.TrainState) -> Dict[str, Any]:
    """``{'params': ..., 'lora': ... or None}`` as f32 numpy trees."""
    return {'params': params_to_numpy(state.params),
            'lora': (None if state.lora is None
                     else params_to_numpy(state.lora))}
