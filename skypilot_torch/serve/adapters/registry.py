"""Adapter registry: adapter id -> checkpoint lineage dir — a copy of
``skypilot_tpu/serve/adapters/registry.py`` (numpy only, ``logging`` in
place of ``tpu_logging``), reading lineages through the port's copies of
``checkpoint/format.py`` and ``commit.py``; a bfloat16 leaf is widened
to float32 from its bit patterns (``format.as_float32``), where the
original reads it through ``ml_dtypes``. The text below is the
original's.

An adapter is the ``lora`` subtree of a native checkpoint (what the
QLoRA finetune recipe saves): stacked per-layer low-rank factors
``wq_a [L, d, r]`` / ``wq_b [L, r, q_out]`` (and ``wv_*``) under
manifest keys ``lora/wq_a`` etc. The registry resolves ids to
lineage dirs, validates the manifest ONCE per committed step
(rank/target-module shapes — typed ``AdapterManifestError`` on
anything unusable), versions each adapter by a content hash over the
manifest's lora entries, and lazily assembles ONLY the ``lora/*``
leaves on load — base weights are never read (checkpoint/format.py's
per-leaf manifest makes the subtree read free of the params bytes).

jax-free on purpose: loads return host numpy arrays; device
placement belongs to the resident-set manager.
"""
import hashlib
import json
import logging
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from skypilot_torch import exceptions
from skypilot_torch.checkpoint import commit as commit_lib
from skypilot_torch.checkpoint import format as format_lib

logger = logging.getLogger(__name__)

# The target-module leaves every adapter checkpoint must carry —
# q/v-only LoRA, matching parallel/lora.py's init/merge convention.
LORA_LEAVES = ('lora/wq_a', 'lora/wq_b', 'lora/wv_a', 'lora/wv_b')

# Scale folded into the B factors at host-load time, so the serving
# delta ``(h @ A) @ B_scaled`` needs no separate multiply — matches
# parallel/lora.py merge_lora's default (alpha/rank = 2.0).
DEFAULT_SCALE = 2.0


class AdapterSpec:
    """One validated adapter version: where it lives and its shape
    contract (the resident-set manager sizes gather slots from
    ``rank``; routing/versioning key on ``content_hash``)."""

    def __init__(self, adapter_id: str, lineage_dir: str, step: int,
                 rank: int, num_layers: int, content_hash: str,
                 scale: float):
        self.adapter_id = adapter_id
        self.lineage_dir = lineage_dir
        self.step = step
        self.rank = rank
        self.num_layers = num_layers
        self.content_hash = content_hash
        self.scale = scale

    def __repr__(self):
        return (f'AdapterSpec({self.adapter_id!r}, step={self.step}, '
                f'rank={self.rank}, hash={self.content_hash[:12]})')


class AdapterRegistry:
    """id -> lineage dir, with per-step validation caching.

    Two registration styles compose:

    - ``base_dir``: any subdirectory with a committed checkpoint is
      an adapter named by the subdirectory (the fleet layout —
      ``<base>/<tenant-adapter>/step_N/...``);
    - ``register(id, dir)``: explicit single-adapter mappings (tests,
      preload lists pointing outside the base dir).
    """

    def __init__(self, base_dir: Optional[str] = None,
                 scale: float = DEFAULT_SCALE):
        self.base_dir = os.path.expanduser(base_dir) \
            if base_dir else None
        self.scale = scale
        self._explicit: Dict[str, str] = {}
        # content-validated specs keyed (id, step): a new committed
        # step re-validates; an unchanged step never re-reads the
        # manifest.
        self._specs: Dict[tuple, AdapterSpec] = {}
        self._lock = threading.Lock()

    def register(self, adapter_id: str, lineage_dir: str) -> None:
        with self._lock:
            self._explicit[adapter_id] = \
                os.path.expanduser(lineage_dir)

    def lineage_dir(self, adapter_id: str) -> str:
        """Resolve an id to its lineage dir (typed not-found)."""
        with self._lock:
            explicit = self._explicit.get(adapter_id)
        if explicit is not None:
            return explicit
        if self.base_dir is not None:
            # Ids are path components here: refuse separators rather
            # than letting a request escape the base dir.
            if adapter_id != os.path.basename(adapter_id) or \
                    adapter_id in ('.', '..'):
                raise exceptions.AdapterNotFoundError(
                    f'invalid adapter id {adapter_id!r}')
            candidate = os.path.join(self.base_dir, adapter_id)
            if os.path.isdir(candidate):
                return candidate
        raise exceptions.AdapterNotFoundError(
            f'unknown adapter {adapter_id!r} (no registration and '
            f'no directory under {self.base_dir!r})')

    def list_ids(self) -> List[str]:
        ids = set(self._explicit)
        if self.base_dir is not None and \
                os.path.isdir(self.base_dir):
            for name in os.listdir(self.base_dir):
                if os.path.isdir(os.path.join(self.base_dir, name)):
                    ids.add(name)
        return sorted(ids)

    def spec(self, adapter_id: str) -> AdapterSpec:
        """Validated spec of the adapter's LATEST committed step.
        Raises ``AdapterNotFoundError`` for unknown ids / no
        committed checkpoint, ``AdapterManifestError`` for a
        committed checkpoint that is not a usable adapter."""
        lineage = self.lineage_dir(adapter_id)
        step = commit_lib.latest_committed_step(lineage)
        if step is None:
            raise exceptions.AdapterNotFoundError(
                f'adapter {adapter_id!r}: no committed checkpoint '
                f'under {lineage}')
        with self._lock:
            cached = self._specs.get((adapter_id, step))
        if cached is not None:
            return cached
        spec = self._validate(adapter_id, lineage, step)
        with self._lock:
            self._specs[(adapter_id, step)] = spec
        return spec

    def _validate(self, adapter_id: str, lineage: str,
                  step: int) -> AdapterSpec:
        step_dir = os.path.join(lineage,
                                commit_lib.step_dir_name(step))
        try:
            manifest = format_lib.read_manifest(step_dir)
        except format_lib.CheckpointRestoreError as e:
            raise exceptions.AdapterManifestError(
                f'adapter {adapter_id!r} step {step}: unreadable '
                f'manifest: {e}') from e
        leaves = manifest.get('leaves', {})
        missing = [k for k in LORA_LEAVES if k not in leaves]
        if missing:
            raise exceptions.AdapterManifestError(
                f'adapter {adapter_id!r} step {step}: checkpoint is '
                f'not a q/v LoRA adapter — missing {missing} '
                f'(top-level keys: '
                f'{sorted({k.split("/", 1)[0] for k in leaves})})')
        shapes = {k: tuple(leaves[k]['shape']) for k in LORA_LEAVES}
        for k, shape in shapes.items():
            if len(shape) != 3:
                raise exceptions.AdapterManifestError(
                    f'adapter {adapter_id!r} step {step}: {k} has '
                    f'shape {shape}, want stacked [layers, ., .]')
        num_layers = shapes['lora/wq_a'][0]
        rank = shapes['lora/wq_a'][2]
        # Shape contract: A [L, d, r] feeds B [L, r, out]; q and v
        # share rank (one rank bucket per adapter).
        problems = []
        if shapes['lora/wv_a'][2] != rank or \
                shapes['lora/wq_b'][1] != rank or \
                shapes['lora/wv_b'][1] != rank:
            problems.append(f'inconsistent rank across leaves '
                            f'({shapes})')
        if any(shapes[k][0] != num_layers for k in LORA_LEAVES):
            problems.append(f'inconsistent layer counts ({shapes})')
        if problems:
            raise exceptions.AdapterManifestError(
                f'adapter {adapter_id!r} step {step}: '
                + '; '.join(problems))
        # Content hash: the manifest's lora entries (shapes, dtypes,
        # shard checksums) + step — two adapters with identical
        # weights hash identically, and a re-finetuned step changes
        # the version without any dir rename.
        hasher = hashlib.sha256()
        hasher.update(str(step).encode())
        for k in LORA_LEAVES:
            entry = leaves[k]
            hasher.update(k.encode())
            hasher.update(json.dumps(
                {'dtype': entry.get('dtype'),
                 'shape': entry.get('shape'),
                 'checksums': [s.get('checksum')
                               for s in entry.get('shards', ())]},
                sort_keys=True).encode())
        return AdapterSpec(adapter_id, lineage, step, rank,
                           num_layers, hasher.hexdigest(), self.scale)

    def load_host(self, adapter_id: str
                  ) -> Dict[str, np.ndarray]:
        """Assemble the adapter's four factors as float32 host
        arrays, scale folded into the B factors. Reads ONLY the
        ``lora/*`` shard files."""
        spec = self.spec(adapter_id)
        step_dir = os.path.join(
            spec.lineage_dir, commit_lib.step_dir_name(spec.step))
        manifest = format_lib.read_manifest(step_dir)
        out: Dict[str, np.ndarray] = {}
        for key in LORA_LEAVES:
            entry = manifest['leaves'][key]
            arr = format_lib.assemble_leaf(step_dir, key, entry)
            name = key.split('/', 1)[1]
            arr = format_lib.as_float32(arr, entry['dtype'])
            if name.endswith('_b'):
                arr = arr * np.float32(spec.scale)
            out[name] = arr
        logger.info('adapter %s loaded (step %d, rank %d, %.1f KB)',
                    adapter_id, spec.step, spec.rank,
                    sum(a.nbytes for a in out.values()) / 1e3)
        return out
