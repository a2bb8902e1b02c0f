"""Paged KV-cache block pool for the continuous-batching engine — the
port of ``skypilot_tpu/serve/kv_pool.py``.

KV storage is ONE pool of fixed-size blocks per layer stack

    k/v:    [L, num_blocks, block_size, Hkv, hd]   (bf16 or f32, or int8)
    scales: [L, num_blocks, block_size, Hkv]       (int8 pool only, bf16)

and each request holds a host-side list of block ids plus a device
block-table row that maps its logical positions onto pool slots.
Admission is bounded by FREE BLOCKS, and the engine preempts and
requeues the youngest request instead of deadlocking when the pool
runs dry.

As in the JAX module:

- Block 0 is a reserved SCRATCH block, never allocated: parked rows
  (inactive decode lanes), padded prefill positions and rejected or
  padded draft lanes direct their writes there, so stale block-table
  entries can never corrupt a block recycled to another request.
- Automatic prefix caching: blocks are REFCOUNTED, and a full block
  whose content is a complete token block of some prompt can be
  REGISTERED under its chain hash (``serve/prefix_hash.py``, which the
  engine computes). The free list has two tiers: ``_free`` (refcount-0
  unregistered, handed out first, LIFO) and ``_cached`` (refcount-0
  registered, LRU, evicted oldest first only when ``_free`` runs dry).

Port differences: the pool tensors are mutable and updated in place
(the engine writes rows into them with K5; ``copy_pool_block`` copies
in place), where the JAX pool's arrays are donated through jit. The
pools start zeroed, so a position that was never written reads as a
finite 0 (masked attention multiplies it by exactly 0).
"""
import collections
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from skypilot_torch import device as device_lib
from skypilot_torch import exceptions
from skypilot_torch.models import llama

# The reserved scratch block (see module docstring).
SCRATCH_BLOCK = 0

# Partial-match (COW) index bound: at most this many registered
# children per chain parent are kept discoverable for partial-block
# matching, so a hot shared prefix cannot turn every admission into an
# unbounded sibling scan on the engine loop. Blocks past the cap still
# register for EXACT full-chain matching.
MAX_PARTIAL_CHILDREN = 64


# ---------------------------------------------------------------------
# Index math (device tensors; no host sync)
# ---------------------------------------------------------------------


def read_indices(block_tables: torch.Tensor,
                 block_size: int) -> torch.Tensor:
    """Flat pool-slot indices for every logical position of every
    row: block_tables [..., MB] int32 -> [..., MB * block_size].
    Positions in unallocated tail blocks land in the scratch block —
    callers mask them via their per-row lengths."""
    offs = torch.arange(block_size, dtype=torch.int32,
                        device=block_tables.device)
    flat = block_tables[..., :, None] * block_size + offs
    return flat.reshape(*block_tables.shape[:-1], -1)


def write_index(block_tables: torch.Tensor, pos: torch.Tensor,
                block_size: int) -> torch.Tensor:
    """Flat pool-slot index for each row's next write:
    block_tables [B, MB], pos [B] -> [B] int32. Positions at or past
    the table's capacity (or negative) are redirected to the scratch
    block (overrun tokens of rows that finished mid-dispatch, parked
    lanes)."""
    mb = block_tables.shape[-1]
    blk = torch.clamp(pos // block_size, 0, mb - 1).long()
    idx = (torch.gather(block_tables, 1, blk[:, None])[:, 0] * block_size
           + pos % block_size)
    safe = (pos >= 0) & (pos < mb * block_size)
    return torch.where(safe, idx,
                       SCRATCH_BLOCK * block_size).to(torch.int32)


def verify_write_indices(block_tables: torch.Tensor, pos: torch.Tensor,
                         n_real: torch.Tensor, width: int,
                         block_size: int) -> torch.Tensor:
    """Flat pool-slot indices for a speculative VERIFY dispatch: row b
    writes ``width`` consecutive positions from ``pos[b]``, of which
    only the first ``n_real[b]`` are real. Padded draft lanes, parked
    rows (n_real 0) and positions past the table capacity all go to
    the scratch block. block_tables [B, MB], pos/n_real [B] ->
    [B, width] int32."""
    t = torch.arange(width, dtype=torch.int32, device=pos.device)
    p = pos[:, None] + t[None, :]
    mb = block_tables.shape[-1]
    pc = torch.clamp(p, min=0)
    blk = torch.clamp(pc // block_size, max=mb - 1).long()
    idx = torch.gather(block_tables, 1, blk) * block_size + \
        pc % block_size
    valid = ((t[None, :] < n_real[:, None]) & (p >= 0) &
             (p < mb * block_size))
    return torch.where(valid, idx,
                       SCRATCH_BLOCK * block_size).to(torch.int32)


def chunk_write_indices(block_row: torch.Tensor, start: int,
                        real_len: int, chunk: int,
                        block_size: int) -> torch.Tensor:
    """Flat pool-slot indices for a prefill chunk's ``chunk`` rows
    written at positions [start, start + real_len): block_row [MB].
    Padded positions (t >= real_len) go to the scratch block."""
    t = torch.arange(chunk, dtype=torch.int32, device=block_row.device)
    pos = start + t
    mb = block_row.shape[0]
    blk = torch.clamp(pos // block_size, max=mb - 1).long()
    idx = block_row[blk] * block_size + pos % block_size
    valid = (t < real_len) & (pos < mb * block_size)
    return torch.where(valid, idx,
                       SCRATCH_BLOCK * block_size).to(torch.int32)


# ---------------------------------------------------------------------
# Pool
# ---------------------------------------------------------------------


class KVBlockPool:
    """Device KV block pool + host free-list allocator.

    ``caches`` is the engine-facing tuple ``(k, v, k_scale, v_scale)``
    with k/v ``[L, num_blocks, block_size, Hkv, hd]`` in the compute
    dtype and the scales None, or, with ``kv_int8``, int8 codes and bf16
    scales ``[L, num_blocks, block_size, Hkv]`` (the JAX 4-tuple).
    """

    def __init__(self, config: llama.LlamaConfig, num_blocks: int,
                 block_size: int, kv_int8: bool = False, device=None):
        if config.dtype not in (torch.bfloat16, torch.float32):
            raise NotImplementedError(
                f'KV pool dtype {config.dtype}: only bf16/f32 are '
                'ported')
        if block_size < 1:
            raise ValueError(f'block_size must be >= 1: {block_size}')
        if num_blocks < 2:
            # Block 0 is scratch; a pool with zero usable blocks can
            # never admit anything.
            raise ValueError(
                f'num_blocks must be >= 2 (block 0 is reserved '
                f'scratch): {num_blocks}')
        dev = device_lib.resolve_device(device)
        self.config = config
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_int8 = kv_int8
        shape = (config.n_layers, num_blocks, block_size,
                 config.n_kv_heads, config.head_dim)
        if kv_int8:
            self.caches: Optional[Tuple] = (
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev),
                torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev))
        else:
            self.caches = (
                torch.zeros(shape, dtype=config.dtype, device=dev),
                torch.zeros(shape, dtype=config.dtype, device=dev),
                None, None)
        self._nbytes = sum(c.numel() * c.element_size()
                           for c in self.caches if c is not None)
        # LIFO free list; block 0 (scratch) is never handed out.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        # Prefix cache: refcounts for allocated blocks, LRU over
        # refcount-0 registered blocks, and the hash-chain registry.
        # ``_hash_meta`` keeps (parent, tokens) per registered hash for
        # partial-block (copy-on-write) matches, and ``_by_parent``
        # indexes registered children per chain parent.
        self._refcount: Dict[int, int] = {}
        self._cached: 'collections.OrderedDict[int, bytes]' = \
            collections.OrderedDict()   # block -> hash, oldest first
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_hash: Dict[int, bytes] = {}
        self._hash_meta: Dict[bytes, Tuple[bytes, Tuple[int, ...]]] = {}
        self._by_parent: Dict[bytes, List[bytes]] = {}
        self.evictions = 0      # cached blocks reclaimed by alloc

    # -- capacity ------------------------------------------------------

    @property
    def usable_blocks(self) -> int:
        """Allocatable blocks (total minus the scratch block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """RECLAIMABLE blocks: truly free plus refcount-0 cached."""
        return len(self._free) + len(self._cached)

    @property
    def used_blocks(self) -> int:
        """Blocks currently REFERENCED by admitted requests."""
        return self.usable_blocks - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks holding registered (reusable) content."""
        return len(self._cached)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    @property
    def block_bytes(self) -> float:
        """Resident bytes per block (codes + scales in an int8 pool)."""
        return self.nbytes / self.num_blocks

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` positions."""
        return max(1, -(-tokens // self.block_size))

    # -- allocation ----------------------------------------------------

    def try_alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks (refcount 1 each), or None (and no change)
        if fewer are reclaimable. Truly-free blocks are taken first;
        only then are LRU cached blocks evicted (content
        unregistered)."""
        if n < 0:
            raise exceptions.KVBlockError(f'negative alloc: {n}')
        if n > self.free_blocks:
            return None
        out: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, h = self._cached.popitem(last=False)  # LRU oldest
                self._unregister(b, h)
                self.evictions += 1
            self._refcount[b] = 1
            out.append(b)
        return out

    def alloc(self, n: int) -> List[int]:
        blocks = self.try_alloc(n)
        if blocks is None:
            raise exceptions.KVPoolExhaustedError(
                f'KV pool exhausted: need {n} blocks, '
                f'{self.free_blocks} reclaimable of '
                f'{self.usable_blocks} usable')
        return blocks

    def free(self, blocks: List[int]) -> None:
        """Release one reference per block. At refcount 0 a registered
        block parks in the cached LRU (content intact); an
        unregistered one returns to the free list. A block that holds
        no reference is a typed ``KVBlockError``, checked for the
        WHOLE batch before any state changes."""
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise exceptions.KVBlockError(
                    f'freeing invalid block id {b}')
            if self._refcount.get(b, 0) < 1:
                raise exceptions.KVBlockError(
                    f'double free of block {b} (refcount 0)')
        counts: Dict[int, int] = {}
        for b in blocks:
            counts[b] = counts.get(b, 0) + 1
        for b, k in counts.items():
            if self._refcount[b] < k:
                raise exceptions.KVBlockError(
                    f'freeing block {b} {k} times with refcount '
                    f'{self._refcount[b]}')
        for b in blocks:
            rc = self._refcount[b] - 1
            if rc > 0:
                self._refcount[b] = rc
                continue
            del self._refcount[b]
            h = self._block_hash.get(b)
            if h is not None:
                # Most-recent end of the LRU; callers release a chain
                # deepest-first so eviction peels chains from the
                # leaves.
                self._cached[b] = h
            else:
                self._free.append(b)

    # -- prefix cache ---------------------------------------------------

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest registered prefix of the chain: block ids for
        ``hashes[0..k)`` where every link resolves to a live block.
        Does NOT pin — callers pin before the next alloc can evict."""
        out: List[int] = []
        for h in hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def partial_match(self, parent: bytes,
                      tokens: Sequence[int]
                      ) -> Optional[Tuple[int, int]]:
        """Best partial-block hit past the full-block chain: among
        registered children of ``parent``, the one sharing the longest
        leading token run with ``tokens``. Returns (block_id,
        shared_tokens) or None — the copy-on-write seed."""
        best: Optional[Tuple[int, int]] = None
        for h in self._by_parent.get(parent, ()):
            b = self._hash_to_block.get(h)
            if b is None:
                continue
            _, cached_tokens = self._hash_meta[h]
            d = 0
            for a, c in zip(tokens, cached_tokens):
                if a != c:
                    break
                d += 1
            if d > 0 and (best is None or d > best[1]):
                best = (b, d)
        return best

    def pin(self, blocks: Sequence[int]) -> None:
        """Take a reference on matched blocks: a cached block leaves
        the LRU (refcount 1); an already-referenced block is shared
        (refcount++). Pinning a block that is neither is a typed
        error, so a stale match can never alias recycled content."""
        for b in blocks:
            if b in self._cached:
                continue
            if self._refcount.get(b, 0) < 1:
                raise exceptions.KVBlockError(
                    f'pin of unallocated block {b} (stale match?)')
        for b in blocks:
            if b in self._cached:
                del self._cached[b]
                self._refcount[b] = 1
            else:
                self._refcount[b] += 1

    def register(self, block: int, block_hash: bytes, parent: bytes,
                 tokens: Sequence[int]) -> bool:
        """Record that ``block`` holds the FULL token block ``tokens``
        at chain position ``block_hash``. First writer wins; only a
        current reference holder may register."""
        if self._refcount.get(block, 0) < 1:
            raise exceptions.KVBlockError(
                f'register of unreferenced block {block}')
        if block_hash in self._hash_to_block:
            return False
        if block in self._block_hash:
            return False
        self._hash_to_block[block_hash] = block
        self._block_hash[block] = block_hash
        self._hash_meta[block_hash] = (parent, tuple(
            int(t) for t in tokens))
        siblings = self._by_parent.setdefault(parent, [])
        if len(siblings) < MAX_PARTIAL_CHILDREN:
            siblings.append(block_hash)
        return True

    def _unregister(self, block: int, block_hash: bytes) -> None:
        del self._hash_to_block[block_hash]
        del self._block_hash[block]
        parent, _ = self._hash_meta.pop(block_hash)
        siblings = self._by_parent.get(parent)
        if siblings is not None:
            try:
                siblings.remove(block_hash)
            except ValueError:
                pass
            if not siblings:
                del self._by_parent[parent]


def copy_pool_block(caches, src: int, dst: int):
    """Copy one block's content ``src`` -> ``dst`` across every layer
    of the pool 4-tuple, IN PLACE — the copy-on-write primitive: a
    partial-block prefix hit duplicates the cached block into a
    private one, then prefill overwrites from the first divergent
    token. Returns ``caches``."""
    for c in caches:
        if c is not None:
            c[:, dst] = c[:, src]
    return caches

