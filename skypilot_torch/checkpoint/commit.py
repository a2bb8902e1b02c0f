"""Atomic commit protocol (GFS-style write-then-rename) — a copy of
``skypilot_tpu/checkpoint/commit.py`` (stdlib only, ``logging`` in place
of ``tpu_logging``), so the port reads and writes the same step
directories without importing the JAX package. The text below is the
original's.

Invariants (docs/checkpointing.md):

1. All of a step's data lands in ``step_N.tmp/`` first; every shard
   file and the manifest are fsynced as they are written.
2. One ``os.rename(step_N.tmp, step_N)`` publishes the directory; the
   parent directory is fsynced after the rename (best effort — FUSE
   bucket mounts reject directory fsync).
3. The ``COMMITTED`` marker is written into the FINAL directory,
   AFTER the rename, and fsynced. Ordering matters: on filesystems
   where rename is not atomic (object-store mounts materialize
   renames as copy+delete), a crash mid-"rename" leaves a partial
   ``step_N/`` — but the marker cannot exist yet, so the partial dir
   is just another torn write, never a committed checkpoint.
4. A reader only trusts a ``step_N/`` directory that contains the
   ``COMMITTED`` marker.
5. A crash at ANY point leaves either a committed previous step, an
   orphaned ``.tmp`` dir, or a markerless ``step_N/`` — both torn
   forms are invisible to readers, and ``gc_orphaned_tmp`` sweeps
   them before a writer's first save (never from a restore-only
   consumer, and with an age threshold so a LIVE writer's in-flight
   dir is never swept from under it).
"""
import logging
import os
import re
import shutil
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

COMMITTED_MARKER = 'COMMITTED'
TMP_SUFFIX = '.tmp'
# 8+ digits: step dirs are zero-padded to 8 for lexicographic sort,
# but steps >= 1e8 widen the field and must still parse.
_STEP_RE = re.compile(r'^step_(\d{8,})$')


def step_dir_name(step: int) -> str:
    if step < 0:
        raise ValueError(f'negative checkpoint step {step}')
    return f'step_{step:08d}'


def tmp_dir_name(step: int) -> str:
    return step_dir_name(step) + TMP_SUFFIX


def parse_step(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def is_committed(step_dir: str) -> bool:
    return os.path.exists(os.path.join(step_dir, COMMITTED_MARKER))


def committed_steps(base_dir: str) -> List[int]:
    """Sorted steps whose directories carry the COMMITTED marker."""
    base_dir = os.path.expanduser(base_dir)
    try:
        names = os.listdir(base_dir)
    except OSError:
        return []
    steps = []
    for name in names:
        step = parse_step(name)
        if step is None:
            continue
        if is_committed(os.path.join(base_dir, name)):
            steps.append(step)
    return sorted(steps)


def latest_committed_step(base_dir: str) -> Optional[int]:
    steps = committed_steps(base_dir)
    return steps[-1] if steps else None


def commit(base_dir: str, step: int) -> str:
    """Publish ``step_N.tmp/`` as ``step_N/``. The caller has already
    written + fsynced every shard file and the merged manifest into
    the tmp dir. The COMMITTED marker lands in the FINAL dir after
    the rename — a torn rename therefore never carries the marker."""
    base_dir = os.path.expanduser(base_dir)
    tmp = os.path.join(base_dir, tmp_dir_name(step))
    final = os.path.join(base_dir, step_dir_name(step))
    if os.path.isdir(final):
        if is_committed(final):
            # Same step committed twice (e.g. a resumed run re-saving
            # its first interval): the existing committed step wins;
            # this write becomes an orphan for a later GC sweep.
            logger.warning('checkpoint %s already committed; '
                           'dropping duplicate write', final)
            return final
        # Markerless leftover (torn rename of a dead predecessor):
        # ours to replace.
        shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    fsync_dir(base_dir)
    marker = os.path.join(final, COMMITTED_MARKER)
    with open(marker, 'w', encoding='utf-8') as f:
        f.write(f'{time.time():.3f}\n')
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(final)
    return final


def fsync_dir(path: str) -> None:
    """Directory fsync, best effort (FUSE mounts often EINVAL)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# A torn dir younger than this may belong to a LIVE writer in another
# process (a training job mid-save while a serve replica boots, a
# faster peer host in a multi-host restart) — deleting it would fail
# that save out from under the writer. True orphans are old by the
# time anyone relaunches; in-flight dirs have fresh mtimes.
GC_MIN_AGE_SECONDS = 60.0


def gc_orphaned_tmp(base_dir: str,
                    min_age_seconds: float = GC_MIN_AGE_SECONDS
                    ) -> List[str]:
    """Remove torn writes: ``step_N.tmp/`` dirs left by a crash or
    preemption mid-save, and markerless ``step_N/`` dirs from torn
    non-atomic renames. Never touches committed steps, and skips
    dirs modified within ``min_age_seconds`` (possibly a live
    writer's). Returns the removed directory names."""
    base_dir = os.path.expanduser(base_dir)
    try:
        names = os.listdir(base_dir)
    except OSError:
        return []
    removed = []
    now = time.time()
    for name in names:
        path = os.path.join(base_dir, name)
        if not os.path.isdir(path):
            continue
        orphan = (name.endswith(TMP_SUFFIX)
                  and parse_step(name[:-len(TMP_SUFFIX)]) is not None)
        torn_rename = (parse_step(name) is not None
                       and not is_committed(path))
        if not orphan and not torn_rename:
            continue
        try:
            # ALL entries, not a sample: a live writer streaming into
            # one long-lived shard file keeps that file's mtime fresh
            # while creating no new directory entries.
            mtimes = [os.path.getmtime(path)]
            with os.scandir(path) as it:
                for entry in it:
                    mtimes.append(entry.stat().st_mtime)
            age = now - max(mtimes)
        except OSError:
            age = now
        if age < min_age_seconds:
            logger.info('checkpoint GC: leaving fresh torn write %s '
                        '(%.0fs old; may be a live writer)', path,
                        age)
            continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(name)
        logger.info('checkpoint GC: removed torn write %s', path)
    return removed
