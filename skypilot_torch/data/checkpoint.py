"""Async checkpointing for spot resumption — the port of
``skypilot_tpu/data/checkpoint.py``, the engine-selecting facade the
recipes program against.

Checkpoints are namespaced by the env-contract task id
(``SKYTPU_TASK_ID``, else ``SKYPILOT_TASK_ID``) so retries of one
managed job share a lineage while unrelated runs do not collide. The
native engine (``checkpoint/native.py``) is the default and the only
one ported; ``SKYTPU_CKPT_ENGINE=orbax`` (the JAX package's optional
TensorStore engine) raises, and does not fall back to native.

Usage in a training loop::

    ckpt = CheckpointManager('/checkpoints')   # a mounted bucket
    state, start_step = ckpt.restore_or(state)
    for step in range(start_step, total):
        state, metrics = train_step(state, batch)
        ckpt.maybe_save(step, state)
    ckpt.wait()
"""
import os
import re
from typing import Any, Callable, Optional, Sequence, Tuple

from skypilot_torch import checkpoint as checkpoint_lib

ENGINE_ENV_VAR = 'SKYTPU_CKPT_ENGINE'
ENGINES = ('native', 'orbax')

# Managed-job recovery stamps SKYTPU_TASK_ID as
# ``managed-<job>-<task>-<launch_seq>``; the trailing counter
# distinguishes launches, the stripped prefix is the checkpoint lineage
# every retry shares. The strip is gated on the ``managed-`` prefix so
# an ordinary task the USER happened to name with a trailing
# ``-<digits>`` (e.g. ``exp-1`` vs ``exp-2``) never has its lineage
# silently merged with a sibling's.
_MANAGED_RETRY_RE = re.compile(r'^(managed-\d+-\d+)-\d+$')


def task_checkpoint_dir(base_dir: str) -> str:
    """``base_dir/<task id>``, retry counters of a managed job
    stripped."""
    task_id = os.environ.get('SKYTPU_TASK_ID',
                             os.environ.get('SKYPILOT_TASK_ID',
                                            'default'))
    m = _MANAGED_RETRY_RE.match(task_id)
    if m:
        task_id = m.group(1)
    return os.path.join(os.path.expanduser(base_dir), task_id)


def selected_engine(engine: Optional[str] = None) -> str:
    engine = (engine or
              os.environ.get(ENGINE_ENV_VAR, 'native')).lower()
    if engine not in ENGINES:
        raise ValueError(
            f'unknown checkpoint engine {engine!r} '
            f'(${ENGINE_ENV_VAR}); choose from {ENGINES}')
    return engine


class CheckpointManager:
    """Engine-selecting facade (native only in the port). In a process
    group every rank makes one over the same directory: the engine takes
    the rank and the world size from ``parallel/distributed`` and writes
    the blocks of a state sharded over a mesh (``checkpoint/native``)."""

    def __init__(self, base_dir: str, save_interval_steps: int = 100,
                 max_to_keep: Optional[int] = 3,
                 use_task_namespace: bool = True,
                 engine: Optional[str] = None,
                 **engine_kwargs):
        engine = selected_engine(engine)
        if engine == 'orbax':
            raise NotImplementedError(
                f'checkpoint engine {engine!r} (${ENGINE_ENV_VAR}): the '
                'orbax engine is not ported; a torch.distributed.checkpoint '
                'analog is ROADMAP.md Queue 1 item 22. Use the native '
                'engine (the default).')
        path = (task_checkpoint_dir(base_dir) if use_task_namespace
                else os.path.expanduser(base_dir))
        self._impl = checkpoint_lib.NativeCheckpointManager(
            path, save_interval_steps=save_interval_steps,
            max_to_keep=max_to_keep, **engine_kwargs)
        self.engine = engine
        self.path = self._impl.path

    def maybe_save(self, step: int, state: Any) -> bool:
        """Save if the step hits the interval; async (training
        continues while the write streams to the bucket)."""
        return self._impl.maybe_save(step, state)

    def latest_step(self) -> Optional[int]:
        return self._impl.latest_step()

    def restore_or(self, state: Any) -> Tuple[Any, int]:
        """Restore the latest checkpoint if one exists; returns
        (state, next_step)."""
        return self._impl.restore_or(state)

    def restore_latest_raw(self,
                           keys: Optional[Sequence[str]] = None,
                           window: Optional[Callable] = None
                           ) -> Optional[Any]:
        """Restore the latest checkpoint WITHOUT a template — host
        tensors in the saved tree structure. ``keys`` selects top-level
        subtrees (e.g. ``('params', 'lora')``), so serving never reads
        the optimizer moments; ``window`` reads blocks
        (``NativeCheckpointManager.restore_latest_raw``)."""
        return self._impl.restore_latest_raw(keys=keys, window=window)

    @property
    def last_restore(self) -> Optional[dict]:
        """Details of the most recent restore: ``{step, bytes_read,
        resharded, saved_device_count, device_count}``; None before
        any restore."""
        return self._impl.last_restore

    def saved_device_count(self) -> Optional[int]:
        """Device count recorded by the latest committed save in this
        manager's (task-namespaced) directory, or None when unknown."""
        return checkpoint_lib.saved_device_count(self.path)

    def wait(self) -> None:
        self._impl.wait()

    def close(self) -> None:
        self._impl.close()
