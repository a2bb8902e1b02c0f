"""Parity of the port's paged decode/verify attention and per-row cache
write (skypilot_torch/ops/decode_attention.py) with the JAX package on
the CPU. The CPU path is each kernel's plain version: cache_write must
be bit-equal to the JAX Pallas kernel in interpret mode and to its
reference; paged decode and verify must match JAX's
``paged_decode_attention`` / ``paged_verify_attention`` on shuffled
block tables within 2e-5 (the JAX package's own tolerance for these
ops, f32 under the conftest's 'highest' precision). No kernel launches
on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.ops import decode_attention as jda
from skypilot_torch.ops import decode_attention as tda

TOL = dict(rtol=2e-5, atol=2e-5)
HQ, HKV, HD = 8, 2, 64


def _launches():
    return (tda.CACHE_WRITE.launches, tda.PAGED_DECODE_ATTENTION.launches,
            tda.PAGED_VERIFY_ATTENTION.launches,
            tda.DECODE_ATTENTION.launches)


def _cache_write_rows(k_cache, v_cache, k_new, v_new, pos):
    """The TPU kernel's rows form through the flat write: row b of
    k/v_cache [B, S, Hkv, hd] gets its new row at pos[b]."""
    b, s = k_cache.shape[:2]
    tda.cache_write(k_cache.view(b * s, *k_cache.shape[2:]),
                    v_cache.view(b * s, *v_cache.shape[2:]), k_new, v_new,
                    tda.rows_dst(pos, s))


def test_cache_write_rows_bit_equal_to_pallas_and_reference():
    """The positions of tests/test_decode_attention.py: window starts,
    mid-window and the last row."""
    rng = np.random.default_rng(0)
    b, s = 4, 2048
    k = rng.standard_normal((b, s, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((b, s, HKV, HD)).astype(np.float32)
    kn = rng.standard_normal((b, HKV, HD)).astype(np.float32)
    vn = rng.standard_normal((b, HKV, HD)).astype(np.float32)
    pos = np.asarray([0, 7, 511, 2047], np.int32)
    jargs = [jnp.asarray(x) for x in (k, v, kn, vn, pos)]
    kp, vp = jda._cache_write_pallas(*jargs, interpret=True)
    kr, vr = jda._reference_cache_write(*jargs)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    before = _launches()
    _cache_write_rows(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(pos))
    assert _launches() == before
    for got, want in ((tk, kp), (tk, kr), (tv, vp), (tv, vr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cache_write_rows_drops_positions_outside_the_cache():
    """A pos at or past S (a parked row) writes nothing, as the JAX
    one-hot reference's miss does."""
    rng = np.random.default_rng(1)
    k = rng.standard_normal((3, 16, HKV, HD)).astype(np.float32)
    kn = rng.standard_normal((3, HKV, HD)).astype(np.float32)
    pos = np.asarray([16, 3, 40], np.int32)
    kr, _ = jda._reference_cache_write(*[jnp.asarray(x) for x in
                                         (k, k, kn, kn, pos)])
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(k.copy())
    _cache_write_rows(tk, tv, torch.from_numpy(kn), torch.from_numpy(kn),
                      torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kr))
    np.testing.assert_array_equal(tda.rows_dst(torch.from_numpy(pos),
                                               16).numpy(), [-1, 19, -1])


def test_cache_write_flat_pool_form():
    rng = np.random.default_rng(2)
    n, r = 64, 5
    k = rng.standard_normal((n, HKV, HD)).astype(np.float32)
    kn = rng.standard_normal((r, HKV, HD)).astype(np.float32)
    dst = rng.permutation(n)[:r].astype(np.int32)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(k.copy())
    tda.cache_write(tk, tv, torch.from_numpy(kn), torch.from_numpy(-kn),
                    torch.from_numpy(dst))
    want = k.copy()
    want[dst] = kn
    np.testing.assert_array_equal(tk.numpy(), want)
    want[dst] = -kn
    np.testing.assert_array_equal(tv.numpy(), want)


def _paged_case(seed, b, w, block_size, mb, lengths):
    """A pool whose blocks are handed out in shuffled order, so every
    row's logical view is scattered over the pool."""
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    k = rng.standard_normal((nb * block_size, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((nb * block_size, HKV, HD)).astype(np.float32)
    ids = rng.permutation(np.arange(1, nb))
    tables = ids[:b * mb].reshape(b, mb).astype(np.int32)
    q = rng.standard_normal((b, w, HQ, HD)).astype(np.float32)
    return q, k, v, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize('lengths', [[1, 17, 64, 33], [5, 2, 63, 40]])
def test_paged_decode_matches_jax(lengths):
    q, k, v, tables, lens = _paged_case(3, 4, 1, 8, 8, lengths)
    scale = HD ** -0.5
    ref = jda.paged_decode_attention(
        jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables), jnp.asarray(lens), scale, 8)
    before = _launches()
    out = tda.paged_decode_attention(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lens), scale, 8)
    assert _launches() == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('w', [2, 9])
def test_paged_verify_matches_jax(w):
    """Query j attends lengths + j positions; spans reach the table's
    capacity (the kernel's clamp) on row 2."""
    q, k, v, tables, lens = _paged_case(4, 3, w, 8, 6, [1, 20, 48 - w + 1])
    scale = HD ** -0.5
    ref = jda.paged_verify_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), scale, 8)
    before = _launches()
    out = tda.paged_verify_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lens), scale, 8)
    assert _launches() == before
    assert out.shape == (3, w, HQ, HD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_verify_at_width_one_is_paged_decode():
    q, k, v, tables, lens = _paged_case(5, 2, 1, 4, 5, [3, 20])
    args = [torch.from_numpy(x) for x in (k, v, tables, lens)]
    one = tda.paged_verify_attention(torch.from_numpy(q), *args, 0.125, 4)
    dec = tda.paged_decode_attention(torch.from_numpy(q[:, 0]), *args,
                                     0.125, 4)
    np.testing.assert_allclose(one[:, 0].numpy(), dec.numpy(), **TOL)


def test_contiguous_tables_equal_dense_decode():
    """A table that lays each row's blocks out contiguously reads
    exactly the dense cache: the plain paged version equals the plain
    dense one."""
    rng = np.random.default_rng(6)
    b, mb, bs = 3, 4, 8
    k = rng.standard_normal((b, mb * bs, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((b, mb * bs, HKV, HD)).astype(np.float32)
    q = rng.standard_normal((b, HQ, HD)).astype(np.float32)
    lens = torch.tensor([1, 13, 32], dtype=torch.int32)
    tables = torch.arange(b * mb, dtype=torch.int32).reshape(b, mb)
    flat = (torch.from_numpy(k).reshape(b * mb * bs, HKV, HD),
            torch.from_numpy(v).reshape(b * mb * bs, HKV, HD))
    paged = tda.paged_decode_attention(torch.from_numpy(q), *flat, tables,
                                       lens, 0.125, bs)
    dense = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), lens, 0.125)
    assert torch.equal(paged, dense)


def test_other_devices_raise():
    x = torch.zeros((1, HQ, HD), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tda.paged_decode_attention(x, x, x, x, x, 1.0, 4)
    with pytest.raises(ValueError, match='unsupported device'):
        tda.cache_write(x, x, x, x, x)
