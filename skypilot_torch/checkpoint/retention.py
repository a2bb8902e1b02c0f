"""Retention GC: ``max_to_keep`` / ``keep_period`` — a copy of
``skypilot_tpu/checkpoint/retention.py`` (stdlib only, ``logging`` in
place of ``tpu_logging``). The text below is the original's.

Semantics (orbax-compatible where they overlap):

- the LATEST committed step is never deleted, regardless of policy;
- steps divisible by ``keep_period`` (when set) are permanent
  "milestone" checkpoints and never deleted;
- of the remaining committed steps, the newest ``max_to_keep`` are
  kept and older ones removed; ``max_to_keep=None`` (or ``<= 0``)
  disables the cap.

Only COMMITTED steps are considered — torn writes belong to
``commit.gc_orphaned_tmp``, not retention.
"""
import logging
import os
import shutil
from typing import List, Optional

from skypilot_torch.checkpoint import commit as commit_lib

logger = logging.getLogger(__name__)


def plan_retention(steps: List[int], max_to_keep: Optional[int],
                   keep_period: Optional[int] = None) -> List[int]:
    """Pure policy: which of ``steps`` (sorted ascending) to delete."""
    if not steps or max_to_keep is None or max_to_keep <= 0:
        return []
    steps = sorted(steps)
    latest = steps[-1]
    candidates = []
    for step in steps:
        if step == latest:
            continue
        if keep_period and step % keep_period == 0:
            continue
        candidates.append(step)
    # Newest max_to_keep survive, counting the always-kept latest
    # toward the budget (max_to_keep=3 -> latest + 2 others).
    budget = max(0, max_to_keep - 1)
    if budget == 0:
        return candidates
    return candidates[:-budget] if budget < len(candidates) else []


def apply_retention(base_dir: str, max_to_keep: Optional[int],
                    keep_period: Optional[int] = None) -> List[int]:
    """Delete committed steps per policy; returns deleted steps."""
    base_dir = os.path.expanduser(base_dir)
    doomed = plan_retention(commit_lib.committed_steps(base_dir),
                            max_to_keep, keep_period)
    for step in doomed:
        path = os.path.join(base_dir, commit_lib.step_dir_name(step))
        shutil.rmtree(path, ignore_errors=True)
        logger.info('checkpoint retention: removed step %d (%s)',
                    step, path)
    return doomed
