"""Content hash chain over token blocks — the prefix-cache key.

A verbatim copy of ``skypilot_tpu/serve/prefix_hash.py`` (stdlib
only), so the port never imports the JAX package; the hash bytes are
the same, which the parity tests check. The text below is the
original's.

One tiny stdlib-only module shared by the two layers that must agree
on the key derivation:

- the paged KV pool (``serve/kv_pool.py``) keys cached blocks by the
  chain, so two prompts share blocks exactly when their token
  prefixes are identical block by block;
- the load balancer's ``PrefixAffinityPolicy``
  (``serve/load_balancer.py``) consistent-hashes a request's LEADING
  block hashes to pick a replica, so repeat traffic lands where its
  blocks already live. The LB runs in the controller process and
  must not import jax — hence this module carries no jax imports.

The chain is positional: ``h_k = H(h_{k-1} || tokens of block k)``
with ``h_{-1} = ROOT``. A block's hash therefore commits to the
ENTIRE token prefix up to and including it, not just its own tokens
— block 7 of prompt A can only alias block 7 of prompt B when all
preceding tokens match too, which is exactly the reuse-safety
condition for attention KV (a position's K/V depends on the whole
prefix). sha256 keeps the chain deterministic across processes and
restarts (Python's builtin ``hash`` is salted per process and would
break LB↔replica agreement).
"""
import hashlib
from typing import List, Sequence

# Chain seed: the hash "before" the first block.
ROOT = b''

# Replica -> LB wire protocol for per-request prefix-cache
# accounting: the replica (recipes/serve_model.py) stamps these
# response headers from the engine's hit/miss counts; the LB folds
# them into its per-endpoint block-hit-rate. They live HERE — the
# shared no-deps module — so the replica never imports the LB
# module (policies, proxy handler, metric registrations) for two
# strings.
PREFIX_HITS_HEADER = 'X-Skytpu-Prefix-Hits'
PREFIX_MISSES_HEADER = 'X-Skytpu-Prefix-Misses'

# Same wire protocol for the adapter-serving subsystem
# (serve/adapters/): per-request resident-hit (the adapter was
# already device-loaded at admission) vs cold-load accounting, folded
# by the LB into its per-endpoint adapter hit rate.
ADAPTER_HITS_HEADER = 'X-Skytpu-Adapter-Hits'
ADAPTER_LOADS_HEADER = 'X-Skytpu-Adapter-Loads'


def adapter_root(adapter_id) -> bytes:
    """Chain seed for a request's prefix chain: ``ROOT`` for
    base-model requests, an adapter-id digest otherwise.

    KV content is adapter-dependent — the v projection carries the
    adapter's LoRA delta, so a block prefilled under adapter X holds
    DIFFERENT values than the same tokens under adapter Y (or the
    base model). Salting the chain root keeps those blocks from ever
    aliasing in the prefix cache, and gives the LB's affinity policy
    a per-(adapter, prefix) routing key for free."""
    if not adapter_id:
        return ROOT
    return hashlib.sha256(b'adapter:' +
                          str(adapter_id).encode()).digest()


def block_hash(parent: bytes, tokens: Sequence[int]) -> bytes:
    """One chain link: commit ``tokens`` on top of ``parent``."""
    payload = parent + b':' + ','.join(
        str(int(t)) for t in tokens).encode()
    return hashlib.sha256(payload).digest()


def chain_hashes(tokens: Sequence[int],
                 block_size: int,
                 root: bytes = ROOT) -> List[bytes]:
    """Hash chain over the FULL blocks of ``tokens`` (the trailing
    partial block has no hash — only complete, immutable blocks are
    ever shared). ``root`` seeds the chain — ``adapter_root`` for
    adapter requests, so per-adapter KV never aliases."""
    out: List[bytes] = []
    h = root
    for i in range(len(tokens) // block_size):
        h = block_hash(h, tokens[i * block_size:(i + 1) * block_size])
        out.append(h)
    return out
