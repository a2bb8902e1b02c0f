"""On-disk checkpoint format: pytree metadata + shard files — a copy of
``skypilot_tpu/checkpoint/format.py`` (numpy only), so the port reads
and writes the same step directories without importing the JAX
package. One change: bfloat16 leaves, which the original reads through
``ml_dtypes`` (a JAX dependency the port does not have), are read as
their raw ``uint16`` bit patterns (``dtype_from_name``) and widened
exactly by ``as_float32``; writers hand them in the same way
(``leaf_entry``'s ``dtype`` takes the name). Leaf keys and bytes
are the original's. The text below is the original's.

A checkpoint step directory holds

    step_00000042/
        COMMITTED                  # commit marker (commit.py)
        manifest.json              # merged manifest, written by rank 0
        manifest.host0.json        # per-host manifests (multi-host)
        h0_00000_0.bin             # shard files: h{proc}_{leaf}_{shard}
        ...

The manifest maps stable leaf keys (tree paths joined with ``/``) to
dtype/global shape and a list of shards, each with its file, the
global index it covers (``[[start, stop], ...]`` per dim), byte size
and a crc32 checksum. A leaf sharded over hosts therefore assembles
from several files; a replicated leaf is written once (by the process
holding ``replica_id == 0`` of each shard).

Keys are derived with ``jax.tree_util.tree_flatten_with_path`` so any
registered pytree (dicts, lists, dataclasses like ``TrainState``,
optax named tuples) round-trips. Raw (template-free) restore rebuilds
nested dicts from the keys, turning all-digit levels back into lists.
"""
import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST_NAME = 'manifest.json'
HOST_MANIFEST_FMT = 'manifest.host{proc}.json'
FORMAT_VERSION = 1


class CheckpointError(Exception):
    """A checkpoint save failed."""


class CheckpointRestoreError(Exception):
    """A checkpoint restore failed (missing/corrupt leaves)."""


def key_str(path: Sequence[Any]) -> str:
    """Stable string key for a tree path (GetAttrKey/DictKey/
    SequenceKey/FlattenedIndexKey all reduce to their name/index)."""
    parts = []
    for k in path:
        if hasattr(k, 'name'):       # GetAttrKey
            parts.append(str(k.name))
        elif hasattr(k, 'key'):      # DictKey / FlattenedIndexKey
            parts.append(str(k.key))
        elif hasattr(k, 'idx'):      # SequenceKey
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return '/'.join(parts)


# bfloat16 leaves: the name the JAX writer records (``ml_dtypes``'
# dtype name) and the numpy dtype their bytes are read as.
BF16_NAME = 'bfloat16'
BF16_STORAGE = np.dtype('<u2')


def dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def dtype_from_name(name: str) -> np.dtype:
    """The numpy dtype a leaf's bytes are read as: bfloat16 as its raw
    ``uint16`` bit patterns (numpy has no bfloat16; ``as_float32``
    widens them)."""
    if name == BF16_NAME:
        return BF16_STORAGE
    return np.dtype(name)


def as_float32(arr: np.ndarray, name: str) -> np.ndarray:
    """A leaf read with ``dtype_from_name(name)`` as float32: exact for
    bfloat16 (its bits are the top half of a float32's)."""
    if name == BF16_NAME:
        return (np.ascontiguousarray(arr).astype(np.uint32) << 16
                ).view(np.float32)
    return np.asarray(arr, dtype=np.float32)


def normalize_index(index, shape: Sequence[int]) -> List[List[int]]:
    """Shard index (tuple of slices) -> [[start, stop], ...]."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = int(dim) if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def full_index(shape: Sequence[int]) -> List[List[int]]:
    return [[0, int(d)] for d in shape]


def write_shard_file(dirpath: str, filename: str,
                     array: np.ndarray) -> Tuple[int, int]:
    """Write one host-resident shard; returns (nbytes, crc32). The
    file is fsynced — the commit rename must never land before its
    data blocks do."""
    # memoryview, not tobytes(): no second full copy of the shard on
    # top of the snapshot the async writer already holds. Arrays that
    # reject the buffer protocol go through a (still zero-copy) uint8
    # reinterpreting view.
    arr = np.ascontiguousarray(array)
    try:
        buf = memoryview(arr).cast('B')
    except (ValueError, TypeError):
        buf = memoryview(arr.reshape(-1).view(np.uint8))
    path = os.path.join(dirpath, filename)
    with open(path, 'wb') as f:
        f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    return len(buf), zlib.crc32(buf)


def read_shard_file(dirpath: str, entry: Dict[str, Any],
                    dtype: np.dtype,
                    shard_shape: Sequence[int]) -> np.ndarray:
    path = os.path.join(dirpath, entry['file'])
    with open(path, 'rb') as f:
        data = f.read()
    if len(data) != entry['nbytes']:
        raise CheckpointRestoreError(
            f'{path}: expected {entry["nbytes"]} bytes, '
            f'got {len(data)}')
    if zlib.crc32(data) != entry['checksum']:
        raise CheckpointRestoreError(f'{path}: checksum mismatch '
                                     '(corrupt shard)')
    return np.frombuffer(data, dtype=dtype).reshape(shard_shape)


def leaf_entry(dtype, shape: Sequence[int],
               sharding: Optional[str] = None) -> Dict[str, Any]:
    return {
        'dtype': dtype_name(dtype),
        'shape': [int(d) for d in shape],
        'sharding': sharding,
        'shards': [],
    }


def write_host_manifest(dirpath: str, proc: int,
                        leaves: Dict[str, Any],
                        process_count: int) -> None:
    doc = {
        'format_version': FORMAT_VERSION,
        'process_index': proc,
        'process_count': process_count,
        'leaves': leaves,
    }
    _write_json(os.path.join(dirpath,
                             HOST_MANIFEST_FMT.format(proc=proc)),
                doc)


def merge_host_manifests(dirpath: str,
                         process_count: int) -> Dict[str, Any]:
    """Rank 0's merge: union every host's leaf entries (shard lists
    concatenate; dtype/shape must agree)."""
    merged: Dict[str, Any] = {}
    for proc in range(process_count):
        path = os.path.join(dirpath,
                            HOST_MANIFEST_FMT.format(proc=proc))
        with open(path, encoding='utf-8') as f:
            doc = json.load(f)
        for key, entry in doc['leaves'].items():
            if key not in merged:
                merged[key] = {k: (list(v) if k == 'shards' else v)
                               for k, v in entry.items()}
                continue
            have = merged[key]
            if (have['dtype'] != entry['dtype'] or
                    have['shape'] != entry['shape']):
                raise CheckpointError(
                    f'host manifests disagree on leaf {key!r}: '
                    f'{have["dtype"]}{have["shape"]} vs '
                    f'{entry["dtype"]}{entry["shape"]}')
            have['shards'].extend(entry['shards'])
    return merged


def write_manifest(dirpath: str, step: int,
                   leaves: Dict[str, Any],
                   process_count: int,
                   device_count: Optional[int] = None) -> None:
    doc = {
        'format_version': FORMAT_VERSION,
        'step': int(step),
        'process_count': process_count,
        'leaves': leaves,
    }
    if device_count is not None:
        # The global device count the state was sharded over at save
        # time: elastic resume (docs/checkpointing.md) compares it
        # against the restoring mesh to detect a resize and rescale
        # the global batch. Absent in pre-elastic checkpoints —
        # readers must treat None as "unknown", never as 0.
        doc['device_count'] = int(device_count)
    _write_json(os.path.join(dirpath, MANIFEST_NAME), doc)


def read_manifest(step_dir: str) -> Dict[str, Any]:
    path = os.path.join(step_dir, MANIFEST_NAME)
    try:
        with open(path, encoding='utf-8') as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointRestoreError(
            f'unreadable manifest {path}: {e}') from e


def assemble_leaf(step_dir: str, key: str,
                  entry: Dict[str, Any]) -> np.ndarray:
    """Reconstruct one leaf's global array from its shard files."""
    shape = tuple(entry['shape'])
    return assemble_region(step_dir, key, entry, full_index(shape))


def region_overlap(a: Sequence[Sequence[int]],
                   b: Sequence[Sequence[int]]
                   ) -> Optional[List[List[int]]]:
    """Intersection of two global index windows (``[[start, stop],
    ...]`` per dim), or None when they are disjoint."""
    out = []
    for (a_lo, a_hi), (b_lo, b_hi) in zip(a, b):
        lo, hi = max(a_lo, b_lo), min(a_hi, b_hi)
        if lo >= hi:
            return None
        out.append([lo, hi])
    return out


def assemble_region(step_dir: str, key: str, entry: Dict[str, Any],
                    region: Sequence[Sequence[int]]) -> np.ndarray:
    """Reconstruct one WINDOW of a leaf's global array from the shard
    files that overlap it (``region`` is ``[[start, stop], ...]`` per
    dim, global coordinates).

    This is the re-partitioning primitive behind elastic resume
    (docs/checkpointing.md, Elastic resume): a restore onto a
    different mesh asks for each new shard's window and only the
    saved shards intersecting it are read — no host ever
    materializes leaves it does not own. ``region == full_index``
    reduces to the classic whole-leaf assembly."""
    dtype = dtype_from_name(entry['dtype'])
    shape = tuple(entry['shape'])
    shards = entry['shards']
    if not shards:
        raise CheckpointRestoreError(f'leaf {key!r} has no shards')
    region = [[int(lo), int(hi)] for lo, hi in region]
    if len(region) != len(shape):
        raise CheckpointRestoreError(
            f'leaf {key!r}: region rank {len(region)} does not match '
            f'leaf rank {len(shape)}')
    for (lo, hi), dim in zip(region, shape):
        if not 0 <= lo <= hi <= dim:
            raise CheckpointRestoreError(
                f'leaf {key!r}: region {region} outside global shape '
                f'{list(shape)}')
    region_shape = tuple(hi - lo for lo, hi in region)
    # Fast path: one saved shard covers exactly the requested window
    # (same-mesh restore, or a resize whose new partition lines up
    # with an old shard boundary) — one read, no copy into a staging
    # buffer.
    for shard in shards:
        if shard['index'] == region:
            return read_shard_file(step_dir, shard, dtype,
                                   region_shape)
    out = np.empty(region_shape, dtype=dtype)
    covered = 0
    for shard in shards:
        overlap = region_overlap(shard['index'], region)
        if overlap is None:
            continue
        shard_shape = tuple(hi - lo for lo, hi in shard['index'])
        data = read_shard_file(step_dir, shard, dtype, shard_shape)
        # Slice the overlap out of the shard, place it into the
        # window — both in their own local coordinates.
        src = tuple(slice(lo - s_lo, hi - s_lo)
                    for (lo, hi), (s_lo, _)
                    in zip(overlap, shard['index']))
        dst = tuple(slice(lo - r_lo, hi - r_lo)
                    for (lo, hi), (r_lo, _)
                    in zip(overlap, region))
        out[dst] = data[src]
        covered += int(np.prod([hi - lo for lo, hi in overlap]))
    want = int(np.prod(region_shape)) if region_shape else 1
    if covered < want:
        raise CheckpointRestoreError(
            f'leaf {key!r}: shards cover {covered} of {want} '
            f'elements of window {region} (incomplete multi-host '
            'write?)')
    return out


def nest(flat: Dict[str, Any]) -> Any:
    """Rebuild a nested structure from ``key -> value``; levels whose
    keys are all digits become lists (tuple/optax-state subtrees)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split('/')
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(root)


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


def _write_json(path: str, doc: Dict[str, Any]) -> None:
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
