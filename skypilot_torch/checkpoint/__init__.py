"""The port's native checkpoint subsystem — the JAX package's
``skypilot_tpu/checkpoint/`` on torch tensors, writing and reading the
same step directories (keys, dtypes, shard files, manifests, the commit
marker), so each engine restores what the other saved.

- ``format.py``, ``commit.py``, ``retention.py``: copies of the JAX
  package's jax-free modules (the on-disk format, the atomic
  write-then-rename commit, ``max_to_keep`` / ``keep_period`` GC);
- ``writer.py``: the async background writer with bounded queue-depth
  backpressure and the ``skytpu_ckpt_*`` families;
- ``native.py``: ``NativeCheckpointManager`` (snapshot to host, async
  write, the ``checkpoint.save`` fault site, the multi-host commit
  barrier, template and raw restore).

``save_tree`` writes a tree as one committed step, synchronously,
through the same manager (one process, no retention): the adapter
lineages of ``serve/adapters/`` are written with it. Leaf keys are
``flatten``'s, byte-identical to the JAX writer's ``key_str`` of the
same tree.

Metrics (the JAX package's names): ``skytpu_ckpt_save_seconds``,
``skytpu_ckpt_bytes_total``, ``skytpu_ckpt_queue_depth``,
``skytpu_ckpt_saves_total{outcome}``,
``skytpu_ckpt_restores_total{outcome}``,
``skytpu_ckpt_reshard_restores_total``,
``skytpu_ckpt_last_committed_step``. The orbax engine is not ported
(``data/checkpoint.py``).
"""
import os
from typing import Any

from skypilot_torch.checkpoint.commit import (committed_steps,
                                              gc_orphaned_tmp,
                                              latest_committed_step,
                                              step_dir_name)
from skypilot_torch.checkpoint.format import (CheckpointError,
                                              CheckpointRestoreError)
from skypilot_torch.checkpoint.native import (NativeCheckpointManager,
                                              flatten, saved_device_count)
from skypilot_torch.checkpoint.retention import apply_retention

__all__ = [
    'CheckpointError',
    'CheckpointRestoreError',
    'NativeCheckpointManager',
    'apply_retention',
    'committed_steps',
    'flatten',
    'gc_orphaned_tmp',
    'latest_committed_step',
    'save_tree',
    'saved_device_count',
    'step_dir_name',
]


def save_tree(base_dir: str, step: int, tree: Any) -> str:
    """Write ``tree`` as committed step ``step`` of the lineage at
    ``base_dir`` and wait for the commit. Returns the committed step
    directory."""
    mgr = NativeCheckpointManager(base_dir, max_to_keep=None,
                                  process_index=0, process_count=1)
    try:
        mgr.save(step, tree)
        mgr.wait()
    finally:
        mgr.close()
    return os.path.join(mgr.path, step_dir_name(step))
