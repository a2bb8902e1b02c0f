"""Weight bridge between the JAX package's params tree and the port's.

The two share key names and layouts (stacked ``[L, ...]`` layers,
``[in, out]`` projections), so the bridge is a leaf-for-leaf copy:
:func:`params_from_numpy` takes the JAX tree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``) and
:func:`params_to_numpy` is its inverse. bf16 leaves cross as f32 numpy
arrays (numpy has no bfloat16) and are cast back to
``config.dtype`` on the way in.
"""
from typing import Any, Dict

import numpy as np
import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama

Params = Dict[str, Any]


def params_from_numpy(tree: Dict[str, Any], config: llama.LlamaConfig,
                      device=None) -> Params:
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (default ``'cuda'``) in ``config.dtype``."""
    llama.require_dense(config)
    dev = device_lib.resolve_device(device)

    def leaf(x):
        arr = np.asarray(x)
        if arr.dtype.kind not in 'fc':
            # ml_dtypes' bfloat16 (what np.asarray gives for a JAX
            # bf16 leaf) has kind 'V'; go through f32 first.
            arr = arr.astype(np.float32)
        return torch.tensor(arr, dtype=config.dtype, device=dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """Inverse of :func:`params_from_numpy`: nested dict of f32 numpy
    arrays (bf16 widens exactly)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.detach().to('cpu', torch.float32).numpy()

    return walk(params)
