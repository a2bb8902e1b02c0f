"""The native checkpoint engine — the port of
``skypilot_tpu/checkpoint/native.py``.

Save path (``maybe_save``):

1. snapshot: every leaf this process writes is copied to host memory
   (a tensor on the card by one device-to-host copy, a CPU tensor or a
   numpy array by a clone), so the loop may update the live state the
   moment ``maybe_save`` returns; only this blocking part is noted to
   goodput's ``checkpoint_save`` bucket;
2. the snapshot is handed to the :class:`writer.AsyncWriter` (bounded
   queue — backpressure, not unbounded host RAM);
3. writer thread: shard files + per-host manifest land in
   ``step_N.tmp/`` (fsynced), rank 0 waits for every host's manifest
   (the filesystem barrier), merges them, the ``checkpoint.save``
   fault site fires (a drill can tear the write HERE, between the
   merge and the commit), then the atomic commit and retention GC.

The tree: nested dicts, lists and tuples of tensors, numpy arrays and
scalars, keyed as ``format.key_str`` keys a JAX tree path (dict keys
in sorted order, sequence items by index; None holds no leaf). A state
that defines ``checkpoint_tree()`` is saved as that tree and rebuilt by
its type's ``from_checkpoint_tree`` on a template restore:
``parallel/train.TrainState`` maps itself onto the JAX ``TrainState``'s
tree, so the two engines read each other's steps. bfloat16 leaves are
written as their ``uint16`` bits under the name ``bfloat16``, as the
JAX writer names them.

Processes: ``process_index`` / ``process_count`` come from the
constructor, else from ``parallel/distributed`` (the rank and world size
of the process group; 0 / 1 without one). A leaf of a state trained
over a mesh is this rank's block (``parallel/sharding.ShardedLeaf``):
the rank writes it at its global window (``format.normalize_index``
form) when it is the block's first replica (``replica_id == 0``, the
JAX engine's rule), so each block is written once. A whole leaf is
written by rank 0. The barrier and the per-host manifests are the JAX
engine's, so either engine reads the other's multi-process lineages.

Restore: template-driven (``restore_or``): each template leaf is read
over its window — a block its rank's window of the saved leaf, a whole
leaf all of it — from the shard files that overlap it
(``format.assemble_region``), and lands on the template leaf's device
and dtype. A restore onto another mesh shape (or from the JAX engine's
sharding) is re-sliced the same way, and ``last_restore`` records it as
``resharded``. Or template-free (``restore_latest_raw``) into nested
host tensors with optional top-level subtree selection — the serve
warm-start path skips the optimizer moments entirely.
"""
import dataclasses
import logging
import os
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from skypilot_torch.checkpoint import commit as commit_lib
from skypilot_torch.checkpoint import format as format_lib
from skypilot_torch.checkpoint import retention as retention_lib
from skypilot_torch.checkpoint import writer as writer_lib
from skypilot_torch.checkpoint.format import (CheckpointError,
                                              CheckpointRestoreError)
from skypilot_torch.parallel import distributed
from skypilot_torch.parallel.sharding import ShardedLeaf

logger = logging.getLogger(__name__)

BARRIER_POLL_SECONDS = 0.05


def _join(prefix: str, key: Any) -> str:
    return f'{prefix}/{key}' if prefix else str(key)


def _walk(tree: Any, prefix: str = '') -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], _join(prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, _join(prefix, i))
    else:
        yield prefix, tree


def flatten(tree: Any) -> Dict[str, Any]:
    """``key -> leaf`` over nested dicts, lists and tuples, keys joined
    with ``/`` as ``format.key_str`` joins a JAX tree path (dict keys
    by name in sorted order, sequence items by index; None holds no
    leaf)."""
    return dict(_walk(tree))


def _map_leaves(tree: Any, fn, prefix: str = '') -> Any:
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, _join(prefix, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, _join(prefix, i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _as_tree(state: Any) -> Any:
    to_tree = getattr(state, 'checkpoint_tree', None)
    return state if to_tree is None else to_tree()


def host_leaf(leaf: Any) -> Tuple[np.ndarray, str]:
    """(host numpy COPY, dtype name) of a tensor, array or scalar leaf;
    bfloat16 tensors as their ``uint16`` bit patterns, named
    ``bfloat16`` as the JAX writer names them."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = (t.clone() if t.device.type == 'cpu' else t.cpu()).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), \
                format_lib.BF16_NAME
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, format_lib.dtype_name(arr.dtype)


def host_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A host tensor over ``arr`` as read from a shard file
    (``format.dtype_from_name``): bfloat16 bits viewed as bfloat16."""
    if dtype_name == format_lib.BF16_NAME:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _device_count(leaves) -> Optional[int]:
    """Devices the state lives on: the mesh's ranks for a sharded state,
    else the devices of the tensors among ``leaves``; None for a tree
    of host arrays (a device count means nothing there)."""
    leaves = list(leaves)
    for x in leaves:
        if isinstance(x, ShardedLeaf):
            return x.mesh.config.num_devices
    devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    return len(devices) or None


def saved_device_count(lineage_dir: str) -> Optional[int]:
    """Device count recorded in the latest COMMITTED checkpoint under
    ``lineage_dir`` (manifest peek). None when there is no committed
    step or the manifest predates elastic resume — callers must treat
    that as "unknown", not as 0."""
    lineage_dir = os.path.expanduser(lineage_dir)
    step = commit_lib.latest_committed_step(lineage_dir)
    if step is None:
        return None
    step_dir = os.path.join(lineage_dir,
                            commit_lib.step_dir_name(step))
    try:
        manifest = format_lib.read_manifest(step_dir)
    except CheckpointRestoreError:
        return None
    count = manifest.get('device_count')
    return int(count) if count is not None else None


class NativeCheckpointManager:
    """Async checkpointing of a tree of tensors (torch + numpy + stdlib).

    Drop-in for the facade surface of ``data/checkpoint.py``:
    ``maybe_save`` / ``latest_step`` / ``restore_or`` /
    ``restore_latest_raw`` / ``wait`` / ``close``.
    """

    def __init__(self, path: str, save_interval_steps: int = 100,
                 max_to_keep: Optional[int] = 3,
                 keep_period: Optional[int] = None,
                 queue_depth: int = 2,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 barrier_timeout: float = 600.0):
        self.path = os.path.expanduser(path)
        os.makedirs(self.path, exist_ok=True)
        self._interval = max(1, int(save_interval_steps))
        self._max_to_keep = max_to_keep
        self._keep_period = keep_period
        self._barrier_timeout = barrier_timeout
        self._proc = (distributed.process_index() if process_index is None
                      else process_index)
        self._nprocs = (distributed.process_count() if process_count is None
                        else process_count)
        self._metrics = writer_lib.ckpt_metrics()
        self._last_submitted: Optional[int] = None
        # Device count captured at snapshot time (rank 0 writes it into
        # the merged manifest) and details of the most recent restore.
        self._snapshot_device_count: Optional[int] = None
        self.last_restore: Optional[Dict[str, Any]] = None
        # Torn writes from a crashed/preempted predecessor are swept
        # before the FIRST save (rank 0), not in __init__: a manager
        # constructed only to restore (a serve replica warm-starting
        # against a lineage another process is still training into)
        # must never run destructive GC.
        self._orphans_swept = False
        self._writer = writer_lib.AsyncWriter(
            self._write_step, queue_depth=queue_depth,
            # An abandoned (drill-preempted) step must stay
            # retryable: clear the same-step dedup for it.
            on_abandoned=self._forget_submitted)

    # -- save -----------------------------------------------------------

    def should_save(self, step: int) -> bool:
        return step % self._interval == 0

    def _forget_submitted(self, step: int) -> None:
        if self._last_submitted == step:
            self._last_submitted = None

    def maybe_save(self, step: int, state: Any,
                   force: bool = False) -> bool:
        # Surface a parked write error FIRST — and forget the failed
        # step, so a retry of that same step is not silently dropped
        # by the dedup below.
        try:
            self._writer.raise_pending_error()
        except BaseException:
            self._last_submitted = None
            raise
        if not force and not self.should_save(step):
            return False
        step = int(step)
        if step == self._last_submitted:
            return False
        # Goodput: only the LOOP-BLOCKING portion of a save counts
        # against the checkpoint bucket — the device->host snapshot
        # and any submit backpressure. A save that raises still
        # blocked the loop for its duration — note in finally.
        from skypilot_torch.metrics import goodput as goodput_lib
        t0 = time.monotonic()
        try:
            payload = self._snapshot(state)
            self._writer.submit(step, payload)
        finally:
            goodput_lib.note('checkpoint_save', time.monotonic() - t0)
        self._last_submitted = step
        return True

    def save(self, step: int, state: Any) -> bool:
        return self.maybe_save(step, state, force=True)

    def wait(self) -> None:
        from skypilot_torch.metrics import goodput as goodput_lib
        t0 = time.monotonic()
        try:
            self._writer.wait()
        except BaseException:
            # The failed step must stay retryable.
            self._last_submitted = None
            raise
        finally:
            goodput_lib.note('checkpoint_save', time.monotonic() - t0)

    def close(self) -> None:
        try:
            self._writer.close()
        except BaseException:
            self._last_submitted = None
            raise

    # -- read side ------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        return commit_lib.latest_committed_step(self.path)

    def all_steps(self) -> List[int]:
        return commit_lib.committed_steps(self.path)

    def restore_or(self, state: Any) -> Tuple[Any, int]:
        """Restore the latest committed checkpoint into the template
        ``state`` (same tree, each leaf on the template's device and
        dtype); returns ``(state, next_step)``."""
        step = self.latest_step()
        if step is None:
            self._metrics['restores_total'].labels(
                outcome='empty').inc()
            return state, 0
        try:
            restored = self.restore(step, state)
        except Exception:
            self._metrics['restores_total'].labels(
                outcome='error').inc()
            raise
        self._metrics['restores_total'].labels(outcome='ok').inc()
        return restored, step + 1

    def restore(self, step: int, state: Any) -> Any:
        # The span shows the restore in a preemption resume's
        # recovery waterfall; goodput gets the same interval.
        from skypilot_torch import trace as trace_lib
        from skypilot_torch.metrics import goodput as goodput_lib
        t0 = time.monotonic()
        try:
            with trace_lib.span('ckpt.restore', attrs={'step': step}):
                return self._restore_traced(step, state)
        finally:
            goodput_lib.note('restore', time.monotonic() - t0)

    def _restore_traced(self, step: int, state: Any) -> Any:
        step_dir = os.path.join(self.path,
                                commit_lib.step_dir_name(step))
        manifest = format_lib.read_manifest(step_dir)
        leaves = manifest['leaves']
        tree = _as_tree(state)
        flat = flatten(tree)
        missing = [key for key in flat if key not in leaves]
        if missing:
            raise CheckpointRestoreError(
                f'checkpoint step {step} at {self.path} is missing '
                f'{len(missing)} leaves of the restore template '
                f'(first few: {missing[:5]}); was it saved from a '
                'different model/optimizer configuration?')
        stats = {'bytes_read': 0, 'resharded': False}
        restored = _map_leaves(
            tree, lambda key, leaf: self._place_leaf(
                step_dir, key, leaves[key], leaf, stats))
        rebuild = getattr(state, 'from_checkpoint_tree', None)
        if rebuild is not None:
            restored = rebuild(restored)
        device_count = _device_count(flat.values())
        self.last_restore = {
            'step': step,
            'bytes_read': stats['bytes_read'],
            'resharded': stats['resharded'],
            'saved_device_count': manifest.get('device_count'),
            'device_count': device_count,
        }
        if stats['resharded']:
            self._metrics['reshard_restores_total'].inc()
            logger.info(
                'checkpoint step %d restored RESHARDED onto the '
                'current device (%s saved devices -> %s; %.1f MB read)',
                step, manifest.get('device_count', '?'),
                device_count, stats['bytes_read'] / 1e6)
        return restored

    def _place_leaf(self, step_dir: str, key: str,
                    entry: Dict[str, Any], template_leaf: Any,
                    stats: Dict[str, Any]) -> Any:
        """Materialize one leaf against the template leaf: a block is
        read over its window (only the overlapping shard files), a whole
        leaf assembled from every shard file that holds a part of it;
        either is put on the tensor template's device and dtype. A numpy
        template takes the saved dtype and a scalar its type, as in the
        JAX engine."""
        shape = tuple(entry['shape'])
        if isinstance(template_leaf, ShardedLeaf):
            if tuple(template_leaf.shape) != shape:
                raise CheckpointRestoreError(
                    f'leaf {key!r}: saved shape {list(shape)}, template '
                    f'{list(template_leaf.shape)}')
            if entry.get('sharding') != template_leaf.sharding:
                stats['resharded'] = True
            host = format_lib.assemble_region(step_dir, key, entry,
                                              template_leaf.index)
            stats['bytes_read'] += host.nbytes
            data = template_leaf.data
            return dataclasses.replace(
                template_leaf, data=host_tensor(host, entry['dtype']).to(
                    device=data.device, dtype=data.dtype))
        shards = entry['shards']
        if len(shards) != 1 or \
                shards[0]['index'] != format_lib.full_index(shape):
            # Saved over a mesh (the JAX engine), restored whole.
            stats['resharded'] = True
        host = format_lib.assemble_leaf(step_dir, key, entry)
        stats['bytes_read'] += host.nbytes
        if isinstance(template_leaf, torch.Tensor):
            if tuple(template_leaf.shape) != shape:
                raise CheckpointRestoreError(
                    f'leaf {key!r}: saved shape {list(shape)}, template '
                    f'{list(template_leaf.shape)}')
            return host_tensor(host, entry['dtype']).to(
                device=template_leaf.device, dtype=template_leaf.dtype)
        if isinstance(template_leaf, np.ndarray):
            return host
        if host.shape == ():
            return type(template_leaf)(host.item())
        return host

    def restore_latest_raw(self, keys: Optional[Sequence[str]] = None,
                           window: Optional[Callable] = None
                           ) -> Optional[Any]:
        """Template-free restore of the latest committed step: host
        tensors (numpy has no bfloat16) in the saved tree structure.
        ``keys`` selects top-level subtrees (e.g. ``('params', 'lora')``)
        — unselected subtrees (the optimizer moments) are never read
        from storage. ``window(path, shape)`` (the leaf's key split on
        '/', its saved shape) gives the slices of the block to read, or
        None for the whole leaf: only the shard files that overlap a
        block are read (a tensor-parallel replica reads its own
        blocks)."""
        step = self.latest_step()
        if step is None:
            self._metrics['restores_total'].labels(
                outcome='empty').inc()
            return None
        step_dir = os.path.join(self.path,
                                commit_lib.step_dir_name(step))
        try:
            manifest = format_lib.read_manifest(step_dir)
            flat: Dict[str, torch.Tensor] = {}
            for key, entry in manifest['leaves'].items():
                top = key.split('/', 1)[0]
                if keys is not None and top not in keys:
                    continue
                block = None if window is None else window(
                    tuple(key.split('/')), tuple(entry['shape']))
                host = (format_lib.assemble_leaf(step_dir, key, entry)
                        if block is None else format_lib.assemble_region(
                            step_dir, key, entry,
                            [[sl.start, sl.stop] for sl in block]))
                flat[key] = host_tensor(host, entry['dtype'])
        except Exception:
            self._metrics['restores_total'].labels(
                outcome='error').inc()
            raise
        if not flat:
            # Nothing matched the subtree selection: to the caller
            # this is "no usable checkpoint", not a success.
            self._metrics['restores_total'].labels(
                outcome='empty').inc()
            logger.warning(
                'checkpoint step %d at %s has no leaves under %s '
                '(top-level keys: %s)', step, self.path, keys,
                sorted({k.split('/', 1)[0]
                        for k in manifest['leaves']}))
            return None
        self._metrics['restores_total'].labels(outcome='ok').inc()
        logger.info('restored checkpoint step %d from %s (%d leaves)',
                    step, self.path, len(flat))
        return format_lib.nest(flat)

    # -- internals ------------------------------------------------------

    def _snapshot(self, state: Any
                  ) -> List[Tuple[str, Dict[str, Any],
                                  List[Tuple[Any, np.ndarray]]]]:
        """Host copy of every leaf this process writes. Returns
        ``[(key, leaf_entry, [(index, host_np)]), ...]`` — after this
        returns, the live state may be updated freely."""
        flat = flatten(_as_tree(state))
        self._snapshot_device_count = _device_count(flat.values())
        payload = []
        for key, leaf in flat.items():
            if isinstance(leaf, ShardedLeaf):
                if leaf.replica_id != 0:
                    continue  # another rank writes this block
                arr, name = host_leaf(leaf.data)
                payload.append((key, format_lib.leaf_entry(
                    name, leaf.shape, sharding=leaf.sharding),
                    [(leaf.index, arr)]))
            elif self._proc == 0:  # a whole leaf: rank 0 writes it
                arr, name = host_leaf(leaf)
                payload.append((key, format_lib.leaf_entry(name, arr.shape),
                                [(format_lib.full_index(arr.shape), arr)]))
        return payload

    def _write_step(self, step: int, payload) -> Tuple[int, bool]:
        """Writer-thread body: shards -> host manifest -> barrier ->
        merge -> fault site -> commit -> retention. Returns
        ``(nbytes, committed)`` — only rank 0's commit counts as a
        committed step for the metrics gauge."""
        from skypilot_torch.resilience import faults
        if self._proc == 0 and not self._orphans_swept:
            self._orphans_swept = True
            commit_lib.gc_orphaned_tmp(self.path)
        tmp = os.path.join(self.path, commit_lib.tmp_dir_name(step))
        os.makedirs(tmp, exist_ok=True)
        nbytes = 0
        leaves: Dict[str, Any] = {}
        for i, (key, entry, shards) in enumerate(payload):
            for j, (index, host_arr) in enumerate(shards):
                fname = f'h{self._proc}_{i:05d}_{j}.bin'
                size, crc = format_lib.write_shard_file(tmp, fname,
                                                        host_arr)
                nbytes += size
                entry['shards'].append({
                    'file': fname,
                    'index': index,
                    'nbytes': size,
                    'checksum': crc,
                })
            leaves[key] = entry
        format_lib.write_host_manifest(tmp, self._proc, leaves,
                                       self._nprocs)
        if self._proc != 0:
            # Non-zero ranks are done: rank 0 owns the commit.
            return nbytes, False
        self._await_host_manifests(tmp, step)
        merged = format_lib.merge_host_manifests(tmp, self._nprocs)
        format_lib.write_manifest(
            tmp, step, merged, self._nprocs,
            device_count=self._snapshot_device_count)
        kind = faults.fire('checkpoint.save')
        if kind == 'preempt':
            # Simulated crash between shard write and commit: leave
            # the torn tmp dir exactly as a dead process would.
            raise writer_lib._AbandonedSave()  # noqa: SLF001
        if kind is not None:
            raise CheckpointError(
                f'[fault:checkpoint.save] injected {kind}')
        commit_lib.commit(self.path, step)
        retention_lib.apply_retention(self.path, self._max_to_keep,
                                      self._keep_period)
        return nbytes, True

    def _await_host_manifests(self, tmp: str, step: int) -> None:
        """Rank 0's pre-commit barrier: every process's manifest must
        be visible in the shared step dir before the merge. A host that
        died mid-save never produces its manifest: the barrier times
        out and the previous committed step stays authoritative."""
        deadline = time.monotonic() + self._barrier_timeout
        pending = set(range(1, self._nprocs))
        while pending:
            pending = {
                p for p in pending
                if not os.path.exists(os.path.join(
                    tmp, format_lib.HOST_MANIFEST_FMT.format(proc=p)))
            }
            if not pending:
                return
            if time.monotonic() >= deadline:
                raise CheckpointError(
                    f'checkpoint step {step}: hosts {sorted(pending)} '
                    f'never wrote their manifests within '
                    f'{self._barrier_timeout:.0f}s; leaving the step '
                    'uncommitted')
            time.sleep(BARRIER_POLL_SECONDS)
