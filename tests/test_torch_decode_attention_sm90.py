"""K4 on sm_90a (skypilot_torch/csrc/decode_attention.cu): the host side
the kernel depends on, and its plain versions against the JAX package,
on the CPU.

- The split plan (``decode_split_plan``), from S alone (never B, W or
  G: a row's keys split at the same points in every call), for every
  instantiation (head_dim 64 and 128, groups 1, 2, 4 and 8) at B 1 and
  8, W 1, 2 and 9, and lengths 0, 1, a page edge, a tile edge, S - 1 and
  S: every key of every query's span is covered by exactly one tile of
  one split, and the scratch the wrapper allocates holds every partial.
- The plain versions (what the CPU runs and what the card is held to)
  against the JAX package on the same numpy inputs: dense against the
  Pallas kernel in interpret mode, paged W = 1..9 against JAX's
  ``paged_decode_attention`` / ``paged_verify_attention``, the int8 forms
  against JAX ``_dequant_kv`` and the reference. Tolerance 2e-5 in f32,
  as tests/test_torch_decode_attention.py states.
- The wrapper's refusals, before anything launches, of what the TMA and
  bulk copies cannot take: page sizes, strides, alignment, scale rows,
  shared memory, and more rows than the merge counters hold; the merge
  counters are one buffer per device that is never replaced.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.ops import decode_attention as jda
from skypilot_torch.ops import decode_attention as tda

TOL = dict(rtol=2e-5, atol=2e-5)
HQ = 32                     # llama3-8b's query heads; Hkv = HQ / G
S = 8192                    # the serve path's max_seq
PAGE = 16                   # the engine's block size


def _launches():
    return tuple(k.launches for k in (
        tda.DECODE_ATTENTION, tda.DECODE_ATTENTION_Q8,
        tda.PAGED_DECODE_ATTENTION, tda.PAGED_VERIFY_ATTENTION,
        tda.PAGED_DECODE_ATTENTION_Q8, tda.PAGED_VERIFY_ATTENTION_Q8))


# ---------------------------------------------------------------------
# The split plan
# ---------------------------------------------------------------------


def _spans(lengths, w, s):
    """Keys query j of each row attends: ``min(max(len + j, 1), S)``."""
    return [[min(max(n + j, 1), s) for j in range(w)] for n in lengths]


def _block_tiles(split, chunk, span_max):
    """The kernel's rule: 64-key tiles block ``split`` loads for a row
    whose longest query span is ``span_max`` (0: it exits at once). Tile
    t holds keys [split * chunk + 64 t, + 64); keys past a query's span
    are masked."""
    start = split * chunk
    if start >= span_max:
        return 0
    return -(-(min(start + chunk, span_max) - start) // tda.DECODE_TILE)


@pytest.mark.parametrize('b', [1, 8])
@pytest.mark.parametrize('g', tda.DECODE_GROUPS)
@pytest.mark.parametrize('hd', tda.DECODE_HEAD_DIMS)
def test_split_plan_covers_every_key_once(hd, g, b):
    hkv = HQ // g
    lengths = [0, 1, PAGE, tda.DECODE_TILE, S - 1, S]
    for w in (1, 2, 9):
        rows = w * g
        chunk, n_split = tda.decode_split_plan(S)
        assert chunk % tda.DECODE_TILE == 0
        assert chunk == tda.DECODE_CHUNK
        assert chunk % PAGE == 0 and (n_split - 1) * chunk < S <= \
            n_split * chunk
        ml_shape, acc_shape = tda.decode_scratch_shapes(b, hkv, n_split,
                                                        rows, hd)
        assert ml_shape == (b, hkv, n_split, rows, 2)
        assert acc_shape == (b, hkv, n_split, rows, hd)
        for spans in _spans(lengths, w, S):
            span_max = spans[-1]
            assert span_max == max(spans)
            seen = np.zeros(S, np.int64)
            valid = 0
            for split in range(n_split):
                tiles = _block_tiles(split, chunk, span_max)
                if not tiles:
                    continue
                valid += 1
                start = split * chunk
                # The block's tiles stay inside its split ...
                assert tiles * tda.DECODE_TILE <= chunk
                seen[start:start + tiles * tda.DECODE_TILE] += 1
            # ... cover each query's span exactly once ...
            for span in spans:
                assert (seen[:span] == 1).all(), (w, span)
            # ... and the partials of the valid splits fit the scratch
            # (split index < n_split; the merge reads the first `valid`).
            assert valid == -(-span_max // chunk) <= n_split


def test_plan_reads_shapes_only():
    """Dense S and paged MB * bs give one plan, which is what makes paged
    W = 1 over a contiguous table bit-equal to dense K4; the plan never
    sees lengths, and its chunk is one for every S, so a row's keys split
    at the same points at any B, W, G or padded S."""
    for s in (8192, 2048, 592):
        assert tda.decode_split_plan(s) == \
            tda.decode_split_plan((s // PAGE) * PAGE)
    chunks = {tda.decode_split_plan(s)[0] for s in (1, 64, 592, 1104, 8192,
                                                    131072)}
    assert chunks == {tda.DECODE_CHUNK}
    # Verify's 36 query rows write 36-row partials: its splits hold at
    # least 3 tiles (one per m-tile of 16 rows).
    assert tda.DECODE_CHUNK >= 3 * tda.DECODE_TILE


def test_shared_memory_fits_two_blocks_per_sm():
    """llama3-8b's shapes: a K4 block at W 1 and 9, bf16 and int8, uses
    at most half of an SM's 228 KB, so two blocks share an SM."""
    chunk, _ = tda.decode_split_plan(S)
    for q8 in (False, True):
        for w in (1, 9):
            need = tda.decode_smem_bytes(128, q8, 8, chunk // PAGE, 4 * w)
            assert need <= 233472 // 2 - 1024, (q8, w, need)


# ---------------------------------------------------------------------
# The plain versions against the JAX package
# ---------------------------------------------------------------------


@pytest.mark.parametrize('g', tda.DECODE_GROUPS)
@pytest.mark.parametrize('hd', tda.DECODE_HEAD_DIMS)
def test_dense_plain_matches_pallas(hd, g):
    """Lengths across the Pallas kernel's 512-key blocks, a 0 clamped to
    1 by both."""
    rng = np.random.default_rng(10 * hd + g)
    hq, hkv, s = 8, 8 // g, 1024
    q = rng.standard_normal((3, hq, hd)).astype(np.float32)
    k = rng.standard_normal((3, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((3, s, hkv, hd)).astype(np.float32)
    lens = np.asarray([0, 513, s], np.int32)
    scale = hd ** -0.5
    ref = jda._decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        scale, jda._BLOCK_S, interpret=True)
    before = _launches()
    out = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens),
                               scale)
    assert _launches() == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _pool_case(seed, b, w, mb, hkv=2, hd=64, hq=8, bs=8):
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    k = rng.standard_normal((nb * bs, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((nb * bs, hkv, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[:b * mb].reshape(
        b, mb).astype(np.int32)
    q = rng.standard_normal((b, w, hq, hd)).astype(np.float32)
    return q, k, v, tables


@pytest.mark.parametrize('w', range(1, 10))
def test_paged_plain_matches_jax(w):
    """W = 1 is decode, W > 1 verify; spans from 1 to the table's
    capacity (the kernel's clamp), over shuffled pages."""
    mb, bs = 6, 8
    q, k, v, tables = _pool_case(20 + w, 3, w, mb, bs=bs)
    lens = np.asarray([1, 17, mb * bs - w + 1], np.int32)
    scale = 64 ** -0.5
    args = [jnp.asarray(x) for x in (k, v, tables, lens)]
    targs = [torch.from_numpy(x) for x in (k, v, tables, lens)]
    before = _launches()
    if w == 1:
        ref = jda.paged_decode_attention(jnp.asarray(q[:, 0]), *args, scale,
                                         bs)
        out = tda.paged_decode_attention(torch.from_numpy(q[:, 0]), *targs,
                                         scale, bs)
    else:
        ref = jda.paged_verify_attention(jnp.asarray(q), *args, scale, bs)
        out = tda.paged_verify_attention(torch.from_numpy(q), *targs, scale,
                                         bs)
    assert _launches() == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _int8(rng, shape):
    x = rng.standard_normal((1, *shape)).astype(np.float32)
    codes, scales = jdecode._quantize_kv(jnp.asarray(x))
    return np.array(codes[0]), np.array(scales[0].astype(jnp.float32))


def _dequant(codes, scales):
    return jdecode._dequant_kv(jnp.asarray(codes), jnp.asarray(
        scales).astype(jnp.bfloat16), jnp.float32)


@pytest.mark.parametrize('form', ['dense', 'paged W1', 'paged W9'])
def test_int8_plain_matches_jax_dequant(form):
    """The int8 forms: codes * scales (JAX ``_dequant_kv``), then the
    reference attention of each form."""
    rng = np.random.default_rng(30)
    scale = 0.125
    if form == 'dense':
        kq, ks = _int8(rng, (2 * 40, 2, 64))
        vq, vs = _int8(rng, (2 * 40, 2, 64))
        kq, vq = kq.reshape(2, 40, 2, 64), vq.reshape(2, 40, 2, 64)
        ks, vs = ks.reshape(2, 40, 2), vs.reshape(2, 40, 2)
        q = rng.standard_normal((2, 8, 64)).astype(np.float32)
        lens = np.asarray([3, 40], np.int32)
        want = jda._reference_decode_attention(
            jnp.asarray(q), _dequant(kq, ks), _dequant(vq, vs),
            jnp.asarray(lens), scale)
        got = tda.decode_attention(
            *(torch.from_numpy(x) for x in (q, kq, vq, lens)), scale,
            torch.from_numpy(ks).to(torch.bfloat16),
            torch.from_numpy(vs).to(torch.bfloat16))
    else:
        w = 1 if form == 'paged W1' else 9
        mb, bs, b = 5, 8, 3
        kq, ks = _int8(rng, ((b * mb + 1) * bs, 2, 64))
        vq, vs = _int8(rng, ((b * mb + 1) * bs, 2, 64))
        _, _, _, tables = _pool_case(31, b, w, mb, bs=bs)
        q = rng.standard_normal((b, w, 8, 64)).astype(np.float32)
        lens = np.asarray([1, 9, mb * bs - w + 1], np.int32)
        want = jda.paged_verify_attention(
            jnp.asarray(q), _dequant(kq, ks), _dequant(vq, vs),
            jnp.asarray(tables), jnp.asarray(lens), scale, bs)
        got = tda.paged_verify_attention(
            *(torch.from_numpy(x) for x in (q, kq, vq, tables, lens)), scale,
            bs, torch.from_numpy(ks).to(torch.bfloat16),
            torch.from_numpy(vs).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------
# Refusals before any launch
# ---------------------------------------------------------------------


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _paged_call(k, v, bs=PAGE, k_scale=None, v_scale=None, w=1, hq=32):
    q = _bf16(2, w, hq, k.shape[-1])
    tables = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    return tda._paged_attention_cuda(q, k, v, tables, lens, 0.1, bs, k_scale,
                                     v_scale)


def _refused(fn, match):
    before = _launches()
    with pytest.raises(ValueError, match=match):
        fn()
    assert _launches() == before


@pytest.mark.parametrize('bs', [4, 12, 128])
def test_refuses_page_sizes_the_copies_cannot_take(bs):
    pool = _bf16(8 * 128, 8, 128)
    _refused(lambda: _paged_call(pool, pool, bs=bs), 'block_size')


def test_refuses_pools_of_partial_pages():
    pool = _bf16(8 * PAGE + 3, 8, 128)
    _refused(lambda: _paged_call(pool, pool), 'whole')


def test_refuses_strided_rows():
    """A pool whose [Hkv, hd] rows are not contiguous: heads padded to
    hd + 8 elements."""
    pool = _bf16(4 * PAGE, 8, 136)[:, :, :128]
    _refused(lambda: _paged_call(pool, pool), 'TMA')


def test_refuses_misaligned_base():
    """A pool starting 8 bytes into its storage."""
    flat = _bf16(4 * PAGE * 8 * 128 + 4)
    pool = flat[4:].view(4 * PAGE, 8, 128)
    assert pool.data_ptr() % 16 == 8
    _refused(lambda: _paged_call(pool, pool), 'aligned')


def test_refuses_int8_strides_of_partial_16_byte_units():
    """int8 rows of 64 + 8 codes: 72-byte strides."""
    pool = torch.zeros((4 * PAGE, 1, 72), dtype=torch.int8)[:, :, :64]
    scales = _bf16(4 * PAGE, 1)
    _refused(lambda: _paged_call(pool, pool, k_scale=scales,
                                 v_scale=scales, hq=8), 'TMA')


def test_refuses_scale_rows_that_are_not_contiguous_heads():
    codes = torch.zeros((4 * PAGE, 8, 128), dtype=torch.int8)
    scales = _bf16(4 * PAGE, 16)[:, :8]
    _refused(lambda: _paged_call(codes, codes, k_scale=scales,
                                 v_scale=scales), 'bulk copies')


def test_refuses_dense_int8_with_partial_last_scale_units():
    """Dense int8 at S * Hkv not a multiple of 8 (views of 13 of 16
    positions, so the batch strides are whole units): the last tile's
    scale rows would not be whole 16-byte units."""
    q = _bf16(1, 1, 4, 64)
    codes = torch.zeros((1, 16, 2, 64), dtype=torch.int8)[:, :13]
    scales = _bf16(1, 16, 2)[:, :13]
    lens = torch.ones((1,), dtype=torch.int32)
    _refused(lambda: tda._decode_attention_cuda(q, codes, codes, lens, 0.1,
                                                scales, scales), 'S \\* Hkv')


def test_refuses_blocks_beyond_shared_memory():
    """int8 scale rows hold every kv head of a tile's keys: at Hkv 512
    a block's ring no longer fits."""
    codes = torch.zeros((4 * PAGE, 512, 64), dtype=torch.int8)
    scales = _bf16(4 * PAGE, 512)
    _refused(lambda: _paged_call(codes, codes, k_scale=scales,
                                 v_scale=scales, hq=512), 'shared memory')


def test_refuses_more_rows_than_merge_counters():
    """B * Hkv beyond the merge counters' buffer: 8193 rows of 8 kv
    heads."""
    b = tda.DECODE_MAX_COUNTERS // 8 + 1
    q = _bf16(b, 1, 32, 64)
    pool = _bf16(4 * PAGE, 8, 64)
    tables = torch.zeros((b, 1), dtype=torch.int32)
    lens = torch.ones((b,), dtype=torch.int32)
    _refused(lambda: tda._paged_attention_cuda(q, pool, pool, tables, lens,
                                               0.1, PAGE), 'merge counters')


def test_merge_counters_are_one_buffer_per_device(monkeypatch):
    """One zeroed buffer per device, made on its first call and never
    replaced, whatever B * Hkv a later call needs: a CUDA graph that
    captured a call keeps pointing at live counters."""
    monkeypatch.setattr(tda, '_COUNTERS', {})
    dev = torch.device('cpu')
    first = tda._counters(dev, 8)
    assert first.numel() == tda.DECODE_MAX_COUNTERS
    assert not bool(first.any())
    assert tda._counters(dev, tda.DECODE_MAX_COUNTERS) is first
    assert list(tda._COUNTERS) == [('cpu', None)]


def test_engine_layouts_pass_the_checks():
    """The engine's pools (16-row pages, [N, Hkv, hd] bf16 or int8 with
    [N, Hkv] scales) and the dense caches pass every copy check."""
    n = 9 * PAGE
    for dtype in (torch.bfloat16, torch.int8):
        pool = torch.zeros((n, 8, 128), dtype=dtype)
        tda._check_tma_kv('t', 'k_pool', pool, 128)
        dense = torch.zeros((2, 64, 8, 128), dtype=dtype)
        tda._check_tma_kv('t', 'k', dense, 128)
    tda._check_scale_rows('t', _bf16(n, 8), _bf16(n, 8), 8)
    tda._check_scale_rows('t', _bf16(2, 64, 8), _bf16(2, 64, 8), 8)
    tda._check_page_size('t', PAGE)
    tda._check_smem('t', 128, True, 8, tda.DECODE_CHUNK // PAGE, 36)
