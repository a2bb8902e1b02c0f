"""Parity of the port's paged KV pool (skypilot_torch/serve/kv_pool.py)
with the JAX package's on the CPU: the index math is integer-equal on
random tables (overrun, parked and padded lanes included), one seeded
random sequence of allocator calls gives equal return values and
counters on both pools, the typed errors are raised, and the
copy-on-write block copy gives the same pool. The prefix-hash copy
gives the same bytes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu import exceptions as jexc
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import kv_pool as jpool
from skypilot_tpu.serve import prefix_hash as jhash
from skypilot_torch import exceptions as texc
from skypilot_torch.models import llama as tllama
from skypilot_torch.serve import kv_pool as tpool
from skypilot_torch.serve import prefix_hash as thash

BS, MB = 4, 6


def _tables(rng, b):
    return rng.integers(0, 40, (b, MB)).astype(np.int32)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_index_math_is_integer_equal(seed):
    rng = np.random.default_rng(seed)
    b = 5
    tables = _tables(rng, b)
    # Positions inside, at the capacity edge, past it (overrun) and far
    # past it (a parked lane at max_seq + ...).
    pos = np.asarray([0, 7, MB * BS - 1, MB * BS, MB * BS + 9], np.int32)
    rng.shuffle(pos)
    n_real = np.asarray([0, 1, 3, 2, 1], np.int32)
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    np.testing.assert_array_equal(
        tpool.read_indices(tt, BS).numpy(),
        np.asarray(jpool.read_indices(jt, BS)))
    np.testing.assert_array_equal(
        tpool.write_index(tt, torch.from_numpy(pos), BS).numpy(),
        np.asarray(jpool.write_index(jt, jnp.asarray(pos), BS)))
    np.testing.assert_array_equal(
        tpool.verify_write_indices(tt, torch.from_numpy(pos),
                                   torch.from_numpy(n_real), 4,
                                   BS).numpy(),
        np.asarray(jpool.verify_write_indices(jt, jnp.asarray(pos),
                                              jnp.asarray(n_real), 4, BS)))
    for start, real_len, chunk in ((0, 5, 8), (9, 8, 8), (17, 3, 8),
                                   (22, 4, 4)):
        np.testing.assert_array_equal(
            tpool.chunk_write_indices(tt[1], start, real_len, chunk,
                                      BS).numpy(),
            np.asarray(jpool.chunk_write_indices(
                jt[1], jnp.asarray(start), jnp.asarray(real_len), chunk,
                BS)))


def _pools(num_blocks=12, block_size=4):
    jcfg = jllama.get_config('tiny')
    tcfg = tllama.get_config('tiny')
    return (jpool.KVBlockPool(jcfg, num_blocks, block_size),
            tpool.KVBlockPool(tcfg, num_blocks, block_size, device='cpu'))


def _state(pool):
    return (pool.free_blocks, pool.used_blocks, pool.cached_blocks,
            pool.evictions, pool.usable_blocks)


def _call(pool, name, *args):
    try:
        return ('ok', getattr(pool, name)(*args))
    except (jexc.KVBlockError, texc.KVBlockError) as e:
        return ('KVBlockError', type(e).__name__)


def test_random_allocator_sequence_matches():
    """alloc/free/match/partial_match/pin/register driven identically on
    both pools from one seeded stream of operations."""
    rng = np.random.default_rng(7)
    jp, tp = _pools()
    held = []          # lists of blocks each "request" holds
    chains = []        # (hashes, tokens) registered so far
    for _ in range(400):
        op = rng.choice(['alloc', 'free', 'register', 'match', 'pin',
                         'partial', 'bad_free'])
        if op == 'alloc':
            n = int(rng.integers(0, 5))
            a, b = jp.try_alloc(n), tp.try_alloc(n)
            assert a == b
            if a:
                held.append(a)
        elif op == 'free' and held:
            blocks = held.pop(int(rng.integers(len(held))))
            assert _call(jp, 'free', list(reversed(blocks))) == \
                _call(tp, 'free', list(reversed(blocks)))
        elif op == 'register' and held:
            blocks = held[int(rng.integers(len(held)))]
            toks = [int(t) for t in rng.integers(0, 6, len(blocks) * 4)]
            hashes = thash.chain_hashes(toks, 4)
            assert hashes == jhash.chain_hashes(toks, 4)
            parent = thash.ROOT
            for i, h in enumerate(hashes):
                chunk = toks[i * 4:(i + 1) * 4]
                assert _call(jp, 'register', blocks[i], h, parent, chunk) \
                    == _call(tp, 'register', blocks[i], h, parent, chunk)
                parent = h
            chains.append((hashes, toks))
        elif op == 'match' and chains:
            hashes, _ = chains[int(rng.integers(len(chains)))]
            assert jp.match(hashes) == tp.match(hashes)
        elif op == 'pin' and chains:
            hashes, _ = chains[int(rng.integers(len(chains)))]
            m = tp.match(hashes)
            res = _call(jp, 'pin', m)
            assert res == _call(tp, 'pin', m)
            if m and res[0] == 'ok':
                held.append(list(m))
        elif op == 'partial' and chains:
            hashes, toks = chains[int(rng.integers(len(chains)))]
            probe = list(toks[:4])
            probe[int(rng.integers(4))] += 1
            assert jp.partial_match(thash.ROOT, probe) == \
                tp.partial_match(thash.ROOT, probe)
        elif op == 'bad_free':
            b = int(rng.integers(0, 14))
            assert _call(jp, 'free', [b]) == _call(tp, 'free', [b])
        assert _state(jp) == _state(tp)
    assert tp.evictions > 0 and tp.cached_blocks >= 0


def test_typed_errors():
    _, tp = _pools(num_blocks=5)
    with pytest.raises(texc.KVBlockError, match='negative'):
        tp.try_alloc(-1)
    with pytest.raises(texc.KVPoolExhaustedError):
        tp.alloc(5)
    a = tp.alloc(2)
    with pytest.raises(texc.KVBlockError, match='invalid block'):
        tp.free([0])
    with pytest.raises(texc.KVBlockError, match='times with refcount'):
        tp.free([a[0], a[0]])
    assert tp.used_blocks == 2           # the refused batch changed nothing
    tp.free(a)
    with pytest.raises(texc.KVBlockError, match='double free'):
        tp.free([a[0]])
    with pytest.raises(texc.KVBlockError, match='stale match'):
        tp.pin([a[0]])
    with pytest.raises(texc.KVBlockError, match='unreferenced'):
        tp.register(a[0], b'h', thash.ROOT, [1, 2, 3, 4])
    with pytest.raises(ValueError, match='num_blocks'):
        tpool.KVBlockPool(tllama.get_config('tiny'), 1, 4, device='cpu')
    # An int8 pool: int8 codes and bf16 scales, counted in its bytes.
    q8 = tpool.KVBlockPool(tllama.get_config('tiny'), 4, 4, kv_int8=True,
                           device='cpu')
    assert [None if c is None else c.dtype for c in q8.caches] == [
        torch.int8, torch.int8, torch.bfloat16, torch.bfloat16]
    assert q8.nbytes == sum(c.numel() * c.element_size()
                            for c in q8.caches)
    assert issubclass(texc.KVBlockError, ValueError)


def test_copy_pool_block_matches():
    jp, tp = _pools(num_blocks=6)
    rng = np.random.default_rng(3)
    k = rng.standard_normal(tp.caches[0].shape).astype(np.float32)
    v = rng.standard_normal(tp.caches[1].shape).astype(np.float32)
    jk, jv, _, _ = jpool.copy_pool_block(
        (jnp.asarray(k), jnp.asarray(v), None, None), jnp.asarray(2),
        jnp.asarray(5))
    caches = (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
              None, None)
    out = tpool.copy_pool_block(caches, 2, 5)
    assert out is caches
    np.testing.assert_array_equal(caches[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(caches[1].numpy(), np.asarray(jv))


def test_pool_starts_zeroed_with_the_jax_shape():
    jp, tp = _pools()
    assert tuple(tp.caches[0].shape) == tuple(jp.caches[0].shape)
    assert not tp.caches[0].any() and not tp.caches[1].any()
    assert tp.caches[2] is None and tp.caches[3] is None
    assert tp.nbytes == jp.nbytes and tp.block_bytes == jp.block_bytes
    assert tp.blocks_for(0) == jp.blocks_for(0) == 1
    assert tp.blocks_for(9) == jp.blocks_for(9) == 3
