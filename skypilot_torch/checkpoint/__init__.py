"""The port's side of the native checkpoint format (``format.py`` and
``commit.py``, copies of the JAX package's jax-free modules).

``save_tree`` writes a nested dict of tensors or arrays as one committed
step, as ``NativeCheckpointManager.save`` does on one process: every
leaf one shard file, the per-host and merged manifests, then the atomic
commit. Leaf keys are the dict paths joined with ``/``, byte-identical
to the JAX writer's ``key_str`` of the same tree, so the JAX registry
and restore read what this writes and the reverse. The adapter registry
(``serve/adapters/registry.py``) reads lineages through the same two
modules.
"""
import os
from typing import Any, Dict

import numpy as np
import torch

from skypilot_torch.checkpoint import commit as commit_lib
from skypilot_torch.checkpoint import format as format_lib


def flatten(tree: Any, prefix: str = '') -> Dict[str, Any]:
    """``key -> leaf`` over nested dicts and lists, keys joined with
    ``/`` as ``format.key_str`` joins a JAX tree path (dict keys by
    name, list items by index)."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f'{prefix}/{k}' if prefix else k))
    return out


def _host_leaf(leaf):
    """(host numpy array, dtype name) of a tensor or array leaf;
    bfloat16 tensors as their ``uint16`` bit patterns, named
    ``bfloat16`` as the JAX writer names them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), \
                format_lib.BF16_NAME
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, format_lib.dtype_name(arr.dtype)


def save_tree(base_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` as committed step ``step`` of the lineage at
    ``base_dir`` (one process, every leaf replicated). Returns the
    committed step directory."""
    base_dir = os.path.expanduser(base_dir)
    os.makedirs(base_dir, exist_ok=True)
    tmp = os.path.join(base_dir, commit_lib.tmp_dir_name(step))
    os.makedirs(tmp, exist_ok=True)
    leaves: Dict[str, Any] = {}
    for i, (key, leaf) in enumerate(flatten(tree).items()):
        arr, name = _host_leaf(leaf)
        entry = format_lib.leaf_entry(name, arr.shape)
        fname = f'h0_{i:05d}_0.bin'
        size, crc = format_lib.write_shard_file(tmp, fname, arr)
        entry['shards'].append({'file': fname,
                                'index': format_lib.full_index(arr.shape),
                                'nbytes': size, 'checksum': crc})
        leaves[key] = entry
    format_lib.write_host_manifest(tmp, 0, leaves, 1)
    format_lib.write_manifest(tmp, step,
                              format_lib.merge_host_manifests(tmp, 1), 1)
    return commit_lib.commit(base_dir, step)
