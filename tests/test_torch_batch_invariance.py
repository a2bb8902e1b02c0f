"""The batch-invariant serving path and K5F on the CPU: the host side of
the kernels (split rules, the wrappers' refusals) and their plain
versions against the code they replaced and against the JAX package.

- ``ops/matmul_invariant``: the plain ``matmul`` is ``llama.matmul``
  bit for bit (bf16, f32, int8 ``{'q', 's'}``) and within 1e-6 of the
  JAX ``llama.matmul`` in f32; ``matmul_plan`` reads (N, K) alone and
  always covers K in whole k-tiles; ``matmul_launch`` picks the bucket
  from M and keeps the segments and their sum order at every M and in
  both forms; the wrapper refuses what the kernel does not take (TMA's
  16-byte strides) before anything launches, never encodes a weight's
  tensor map inside a capture and keeps a live weight's map through a
  sweep; the plan's prefill grouping follows the engine's chunk.
- ``decode_split_plan`` reads S alone, with one chunk for every S.
- ``rope_cache_write``'s plain version is the chain it replaced in the
  device steps (``_rope_rows`` / ``_rope_verify``, ``_new_rows``, the
  plain K5), bit for bit, bf16 and int8, with rows whose dst is outside
  the pool; against the JAX step's ``_rope_rows`` and ``_quantize_kv``
  within 1e-6 in f32 (cos and sin are XLA's there); its ``k_out`` is the
  plain rotation of every row, and a table of P rows read at r mod P is
  the table repeated, bit for bit.
- ``verify_attention`` (K4-prefill's dense form) against the JAX
  ``_masked_attention`` it replaced in ``forward_paged``: f32, 2e-5.
- ``forward_cached``'s products: the engine-off prompt on
  ``llama.matmul``, every later forward on the invariant GEMM.
- ``top_p_kth``'s plain version is the nucleus filter's old inline
  code, and the filter equals the JAX ``_filter_top_p_row``.
No test here touches CUDA.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import batching as jbatching
from skypilot_tpu.serve.sampling import sample as jsample
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.models import quant as tquant
from skypilot_torch.ops import decode_attention as tda
from skypilot_torch.ops import matmul_invariant as tmi
from skypilot_torch.ops import top_p as ttp
from skypilot_torch.serve.sampling import sample as tsample

F32_TOL = dict(rtol=1e-6, atol=1e-6)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


def _launches():
    return (tmi.MATMUL.launches, tmi.MATMUL_Q8.launches,
            tmi.LORA_MID.launches, tmi.LORA_DELTA.launches, ttp.TOP_P_KTH.launches,
            tda.ROPE_CACHE_WRITE.launches, tda.ROPE_CACHE_WRITE_Q8.launches,
            tda.PREFILL_ATTENTION.launches, tda.PREFILL_ATTENTION_Q8.launches)


# ---------------------------------------------------------------------
# The invariant GEMM
# ---------------------------------------------------------------------


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m', [1, 8, 72])
def test_matmul_plain_is_llama_matmul(m, dtype):
    gen = torch.Generator().manual_seed(m)
    x = torch.randn((m, 64), generator=gen).to(dtype)
    w = torch.randn((64, 48), generator=gen).to(dtype)
    assert torch.equal(tmi.matmul(x, w), tllama.matmul(x, w))
    wq = tquant.quantize_weight(w.float())
    assert torch.equal(tmi.matmul(x, wq), tllama.matmul(x, wq))
    # The tied head's transposed view.
    wt = w.T.contiguous().T
    assert torch.equal(tmi.matmul(x, wt), tllama.matmul(x, wt))


@pytest.mark.parametrize('quantized', [False, True])
def test_matmul_plain_matches_jax(quantized):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    if quantized:
        tw = tquant.quantize_weight(torch.from_numpy(w))
        jw = {'q': jnp.asarray(tw['q'].numpy()),
              's': jnp.asarray(tw['s'].float().numpy()).astype(
                  jnp.bfloat16)}
    else:
        tw, jw = torch.from_numpy(w), jnp.asarray(w)
    got = tmi.matmul(torch.from_numpy(x), tw).float().numpy()
    want = np.asarray(jllama.matmul(jnp.asarray(x), jw), np.float32)
    np.testing.assert_allclose(got, want, **F32_TOL)


ENGINE_SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
                 (128256, 4096), (48, 64), (1000, 512)]


@pytest.mark.parametrize('n,k', ENGINE_SHAPES)
def test_matmul_splits_cover_k_from_n_and_k_alone(n, k):
    """Whole k-tiles per segment, every k in exactly one segment, the
    column tiles in one wave of clusters of that many blocks when K is
    split, groups that divide the segments, and nothing of M in the rule
    (it takes N and K only)."""
    seg_tiles, n_segs, group = tmi.matmul_plan(n, k)
    tiles = -(-k // tmi.MATMUL_BK)
    assert n_segs >= 1 and seg_tiles >= 1
    assert (n_segs - 1) * seg_tiles < tiles <= n_segs * seg_tiles
    assert n_segs % group == 0 and n_segs in tmi.MATMUL_CLUSTERS
    if n_segs > 1:
        assert tiles % n_segs == 0
        assert seg_tiles >= tmi.MATMUL_MIN_K_TILES
        assert -(-n // tmi.MATMUL_BN) <= tmi.MATMUL_CLUSTERS[n_segs]
    assert tmi.matmul_plan(n, k) == (seg_tiles, n_segs, group)


def test_matmul_splits_at_llama3_8b():
    """The engine's shapes split as the kernel's comment says: q/o (N
    4096, 32 column tiles) and down (K 14336) 2 ways in one group, so a
    512-row chunk runs them serially with no merge; the k/v projections
    (N 1024, 8 column tiles) 8 ways in 2 groups; the MLP's gate/up (112
    column tiles) and the head not at all."""
    assert [tmi.matmul_plan(n, k)[1] for n, k in ENGINE_SHAPES[:5]] == \
        [2, 8, 1, 2, 1]
    assert [tmi.matmul_plan(n, k)[2] for n, k in ENGINE_SHAPES[:5]] == \
        [2, 4, 1, 2, 1]


@pytest.mark.parametrize('m', [1, 8, 9, 63, 64, 65, 72, 128, 129, 512,
                               4096])
def test_matmul_bucket_warpgroups_from_m(m):
    """One 64-row warpgroup a block up to 64 rows, two above: verify's
    72 rows are one m-tile, so each weight byte is read once a call."""
    launch = tmi.matmul_launch(m, 4096, 4096)
    assert launch['nwg'] == tmi.matmul_bucket(m) == (1 if m <= 64 else 2)
    assert launch['tile'] == [64 * launch['nwg'], tmi.MATMUL_BN,
                              tmi.MATMUL_BK]
    rows = launch['nwg'] * tmi.MATMUL_WG_ROWS
    assert (launch['m_tiles'] - 1) * rows < m <= launch['m_tiles'] * rows
    if m <= 128:
        assert launch['m_tiles'] == 1


@pytest.mark.parametrize('n,k', ENGINE_SHAPES)
def test_matmul_launch_covers_every_k_tile_once(n, k):
    """At every M, in both forms: the segments are the plan's (of (N, K)
    alone), the blocks of an output tile take every k-tile exactly once
    and in segment order, and the fixed sum order (segments within a
    group, then groups) is the same whether a block runs one segment or
    a whole group."""
    plan = tmi.matmul_plan(n, k)
    tiles = -(-k // tmi.MATMUL_BK)
    orders, forms = set(), set()
    for m in (1, 8, 9, 72, 512, 2048):
        launch = tmi.matmul_launch(m, n, k)
        seg_tiles, n_segs, group = plan
        assert (launch['seg_tiles'], launch['n_segs'], launch['group']) == \
            plan
        run = launch['run']
        assert run in (1, group)
        assert launch['blocks_per_tile'] * run == n_segs
        taken = []
        order = []
        for z in range(launch['blocks_per_tile']):
            block_segs = list(range(z * run, (z + 1) * run))
            for seg in block_segs:
                taken += list(range(seg * seg_tiles,
                                    min(tiles, (seg + 1) * seg_tiles)))
            # In a block, its segments in order; across blocks, the merge
            # takes per_group blocks a group, then the groups.
            order.append(block_segs)
        assert taken == list(range(tiles))
        per_group = group // run
        grouped = tuple(tuple(s for blk in order[g:g + per_group]
                              for s in blk)
                        for g in range(0, len(order), per_group))
        orders.add(grouped)
        forms.add(launch['form'])
    assert len(orders) == 1
    assert orders.pop() == tuple(tuple(range(g, g + plan[2]))
                                 for g in range(0, plan[1], plan[2]))


def test_matmul_forms_at_llama3_8b():
    """Decode and verify spread K over one cluster a tile (split), in one
    wave; a 512-row chunk runs each block's group of segments in turn
    (serial), its clusters in one wave; gate/up, one segment, whole."""
    for n, k in ENGINE_SHAPES[:4]:
        single = tmi.matmul_plan(n, k)[1] == 1
        for m in (8, 72):
            launch = tmi.matmul_launch(m, n, k)
            assert launch['run'] == 1, (n, k, m)
            assert launch['form'] == ('single' if single else 'split')
            assert launch['n_tiles'] <= tmi.MATMUL_CLUSTERS[
                launch['blocks_per_tile']]
        launch = tmi.matmul_launch(512, n, k)
        assert launch['form'] == ('single' if single else 'serial'), (n, k)
        if not single:
            assert (launch['m_tiles'] * launch['n_tiles'] <=
                    tmi.MATMUL_CLUSTERS[launch['blocks_per_tile']]), (n, k)
    # q/o and down: one group covers K, so no merge at 512 rows.
    assert tmi.matmul_launch(512, 4096, 4096)['blocks_per_tile'] == 1
    assert tmi.matmul_launch(512, 4096, 14336)['blocks_per_tile'] == 1


def _refused(fn, exc, match):
    before = _launches()
    with pytest.raises(exc, match=match):
        fn()
    assert _launches() == before


def test_matmul_wrapper_refusals():
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 32), dtype=torch.bfloat16)
    _refused(lambda: tmi._matmul_cuda(x.float(), w), TypeError, 'bf16 x')
    _refused(lambda: tmi._matmul_cuda(x, w.float()), TypeError,
             'bf16 weights')
    _refused(lambda: tmi._matmul_cuda(x, w[:, ::2]), ValueError,
             'contiguous')
    _refused(lambda: tmi._matmul_cuda(x[:, :60], w[:60]), ValueError,
             'multiples of 8')
    # TMA: a row stride of 72 bytes, and a base 2 bytes off 16.
    xs = torch.zeros((4, 100), dtype=torch.bfloat16)
    _refused(lambda: tmi._matmul_cuda(xs[:, :64], w), ValueError,
             '16-byte')
    _refused(lambda: tmi._matmul_cuda(xs.view(-1)[1:257].view(4, 64), w),
             ValueError, '16-byte')
    wq = {'q': torch.zeros((64, 24), dtype=torch.int8),
          's': torch.zeros((1, 24), dtype=torch.bfloat16)}
    _refused(lambda: tmi._matmul_cuda(x, wq), TypeError, 'multiple of 16')
    _refused(lambda: tmi._lora_cuda(x[None], torch.zeros((1, 64, 65)),
                                    torch.zeros((1, 65, 8)),
                                    torch.zeros((1,), dtype=torch.int32)),
             ValueError, 'R <= 64')
    _refused(lambda: ttp._top_p_kth_cuda(torch.zeros((2, 8)).to(
        torch.bfloat16), torch.zeros((2,))), TypeError, 'f32')


def test_matmul_weight_maps_are_never_encoded_in_a_capture(monkeypatch):
    """A weight's tensor map is encoded on its first call and kept under
    (device, pointer, shape, strides, dtype, form); during a CUDA-graph
    capture a missing map raises, and a kept one is reused."""
    monkeypatch.setattr(tmi, '_MAPS', {})
    encoded = []

    def encode(mat, form, k, n, ld):
        encoded.append((mat.data_ptr(), form, k, n, ld))
        return bytes(128)
    monkeypatch.setattr(tmi, '_encode_map', encode)
    w = torch.zeros((64, 32), dtype=torch.bfloat16)
    first = tmi._weight_map(w, tmi.FORM_BF16, 64, 32, 32)
    assert tmi._weight_map(w, tmi.FORM_BF16, 64, 32, 32) is first
    assert len(encoded) == 1
    monkeypatch.setattr(tmi, '_capturing', lambda dev: True)
    assert tmi._weight_map(w, tmi.FORM_BF16, 64, 32, 32) is first
    with pytest.raises(RuntimeError, match='captured'):
        tmi._weight_map(w.T.contiguous().T, tmi.FORM_BF16_T, 32, 64, 32)
    with pytest.raises(RuntimeError, match='captured'):
        tmi._weight_map(w, tmi.FORM_Q8, 64, 32, 32)
    assert len(encoded) == 1 and len(tmi._MAPS) == 1


def test_matmul_weight_map_sweep_keeps_live_weights(monkeypatch):
    """Past ``MATMUL_MAX_MAPS`` maps only freed weights' maps go: a live
    weight's map (and its tied-head view's, kept by the view's base)
    survives the sweep, so a capture after it still finds both."""
    monkeypatch.setattr(tmi, '_MAPS', {})
    monkeypatch.setattr(tmi, 'MATMUL_MAX_MAPS', 3)
    encoded = []

    def encode(mat, form, k, n, ld):
        encoded.append(mat.data_ptr())
        return bytearray(128)
    monkeypatch.setattr(tmi, '_encode_map', encode)
    w = torch.zeros((64, 32), dtype=torch.bfloat16)
    embed = torch.zeros((32, 64), dtype=torch.bfloat16)
    first = tmi._weight_map(w, tmi.FORM_BF16, 64, 32, 32)
    head = tmi._weight_map(embed.T, tmi.FORM_BF16_T, 64, 32, 64)
    for i in range(4):   # weights made and freed, as copies of a timing
        tmp = torch.zeros((64, 32 + 8 * i), dtype=torch.bfloat16)
        tmi._weight_map(tmp, tmi.FORM_BF16, 64, 32 + 8 * i, 32 + 8 * i)
        del tmp
    assert len(encoded) == 6 and len(tmi._MAPS) == 3
    n = len(encoded)
    monkeypatch.setattr(tmi, '_capturing', lambda dev: True)
    assert tmi._weight_map(w, tmi.FORM_BF16, 64, 32, 32) is first
    assert tmi._weight_map(embed.T, tmi.FORM_BF16_T, 64, 32, 64) is head
    assert len(encoded) == n


def test_matmul_prefill_m_tiles_follow_the_engine_chunk():
    """The plan's grouping counts the engine's default prefill chunk in
    two-warpgroup m-tiles."""
    import inspect

    from skypilot_torch.serve import batching as tbatching
    chunk = inspect.signature(tbatching.BatchingEngine).parameters[
        'prefill_chunk'].default
    assert (tmi.MATMUL_PREFILL_M_TILES ==
            -(-chunk // (2 * tmi.MATMUL_WG_ROWS)))
    assert tmi.matmul_bucket(chunk) == 2


# ---------------------------------------------------------------------
# K4's plan
# ---------------------------------------------------------------------


@pytest.mark.parametrize('s', [1, 16, 63, 64, 256, 592, 1104, 2048, 8192,
                               131072])
def test_decode_split_plan_reads_s_alone(s):
    """One chunk for every S (so a row's keys split at the same points
    at any B, W, G or padding of S), and splits that cover [0, S)."""
    chunk, n_split = tda.decode_split_plan(s)
    assert chunk == tda.DECODE_CHUNK
    assert (n_split - 1) * chunk < s <= n_split * chunk


@pytest.mark.parametrize('rows', [1, 4, 16, 17, 36, 72, 2048])
def test_decode_pass_groups_take_every_m_tile_once(rows):
    """A K4 call's m-tiles of 16 query rows, DECODE_PASSES_PER_BLOCK to a
    group of blocks: every m-tile in exactly one group, no group empty,
    and decode (W x G <= 16) and verify at W 9, G 4 in one group."""
    groups = tda.decode_pass_groups(rows)
    tiles = -(-rows // 16)
    per = tda.DECODE_PASSES_PER_BLOCK
    taken = [t for g in range(groups)
             for t in range(g * per, min(tiles, (g + 1) * per))]
    assert taken == list(range(tiles))
    assert (groups - 1) * per < tiles
    if rows <= 36:
        assert groups == 1


# ---------------------------------------------------------------------
# K5F's plain version against the chain it replaced and the JAX step
# ---------------------------------------------------------------------


def _old_rope_rows(x, angles):
    """The device steps' RoPE before K5F (serve/batching._rope_rows): x
    [B, 1, H, D], angles [B, D/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles)[:, None, None, :]
    sin = torch.sin(angles)[:, None, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _old_rope_verify(x, angles):
    """``_rope_verify`` before K5F: x [B, W, H, D], angles [B, W, D/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _old_new_rows(k, v, quantized):
    if not quantized:
        return k, v, None, None
    kq, ks = tdecode._quantize_kv(k[None])
    vq, vs = tdecode._quantize_kv(v[None])
    return kq[0], vq[0], ks[0], vs[0]


def _pools(n, hkv, hd, q8, gen):
    if q8:
        return [torch.randint(-127, 128, (n, hkv, hd), generator=gen,
                              dtype=torch.int8) for _ in range(2)] + \
            [torch.rand((n, hkv), generator=gen).to(torch.bfloat16)
             for _ in range(2)]
    return [torch.randn((n, hkv, hd), generator=gen).to(torch.bfloat16)
            for _ in range(2)] + [None, None]


@pytest.mark.parametrize('q8', [False, True], ids=['bf16', 'int8'])
@pytest.mark.parametrize('w', [1, 3])
def test_rope_cache_write_plain_is_the_replaced_chain(w, q8):
    """B rows of W positions each (W 1: decode, W > 1: verify), at their
    own positions, dst scattered over a pool with one row past it and
    one negative: the new plain version and the old chain give the same
    rotated q and the same pools, bit for bit."""
    gen = torch.Generator().manual_seed(10 * w + q8)
    b, hq, hkv, hd, n = 4, 8, 2, 32, 64
    q = torch.randn((b, w, hq, hd), generator=gen).to(torch.bfloat16)
    k = torch.randn((b, w, hkv, hd), generator=gen).to(torch.bfloat16)
    v = torch.randn((b, w, hkv, hd), generator=gen).to(torch.bfloat16)
    angles = torch.rand((b, w, hd // 2), generator=gen) * 300
    dst = torch.randperm(n, generator=gen)[:b * w].to(torch.int32)
    dst[0], dst[-1] = -1, n
    new = _pools(n, hkv, hd, q8, gen)
    old = [None if x is None else x.clone() for x in new]
    rows = b * w
    cos = torch.cos(angles.reshape(rows, -1))
    sin = torch.sin(angles.reshape(rows, -1))
    q_new = tda.rope_cache_write(
        q.reshape(rows, hq, hd), k.reshape(rows, hkv, hd),
        v.reshape(rows, hkv, hd), cos, sin, new[0], new[1], dst, new[2],
        new[3])
    rope = _old_rope_rows if w == 1 else _old_rope_verify
    ang = angles[:, 0] if w == 1 else angles
    q_old = rope(q, ang)
    k_old = rope(k, ang)
    kr, vr, ksr, vsr = _old_new_rows(k_old.reshape(rows, hkv, hd),
                                     v.reshape(rows, hkv, hd), q8)
    tda._reference_cache_write(old[0], old[1], kr, vr, dst, old[2], old[3],
                               ksr, vsr)
    assert torch.equal(q_new, q_old.reshape(rows, hq, hd))
    for a, c in zip(new, old):
        assert a is None or torch.equal(a, c)


def test_rope_cache_write_plain_matches_jax_step():
    """f32 rows: the rotation against the JAX step's ``_rope_rows``
    (XLA's cos and sin, within 1e-6) and the written int8 rows against
    the JAX ``_quantize_kv`` of the same rotated k (bit-equal codes and
    scales)."""
    rng = np.random.default_rng(7)
    b, hq, hkv, hd, n = 3, 8, 2, 32, 16
    q = rng.standard_normal((b, 1, hq, hd)).astype(np.float32)
    k = rng.standard_normal((b, 1, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, 1, hkv, hd)).astype(np.float32)
    angles = (rng.random((b, hd // 2)) * 100).astype(np.float32)
    ta = torch.from_numpy(angles)
    kp, vp = (torch.zeros((n, hkv, hd)) for _ in range(2))
    dst = torch.tensor([3, 9, 0], dtype=torch.int32)
    got_q = tda.rope_cache_write(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k[:, 0]),
        torch.from_numpy(v[:, 0]), torch.cos(ta), torch.sin(ta), kp, vp,
        dst)
    want_q = np.asarray(jbatching._rope_rows(jnp.asarray(q),
                                             jnp.asarray(angles)))[:, 0]
    want_k = np.asarray(jbatching._rope_rows(jnp.asarray(k),
                                             jnp.asarray(angles)))[:, 0]
    np.testing.assert_allclose(got_q.numpy(), want_q, **F32_TOL)
    np.testing.assert_allclose(kp[dst.long()].numpy(), want_k, **F32_TOL)
    np.testing.assert_array_equal(vp[dst.long()].numpy(), v[:, 0])
    # int8: the same rotated rows (taken from the port) quantized by both.
    codes = [torch.zeros((n, hkv, hd), dtype=torch.int8) for _ in range(2)]
    scales = [torch.zeros((n, hkv), dtype=torch.bfloat16) for _ in range(2)]
    kb = torch.from_numpy(k[:, 0]).to(torch.bfloat16)
    vb = torch.from_numpy(v[:, 0]).to(torch.bfloat16)
    tda.rope_cache_write(torch.from_numpy(q[:, 0]).to(torch.bfloat16), kb,
                         vb, torch.cos(ta), torch.sin(ta), codes[0],
                         codes[1], dst, scales[0], scales[1])
    rot = tda.rope_plain(kb, torch.cos(ta), torch.sin(ta))
    for x, c, s in ((rot, codes[0], scales[0]), (vb, codes[1], scales[1])):
        jq, js = jdecode._quantize_kv(
            jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)[None])
        np.testing.assert_array_equal(c[dst.long()].numpy(),
                                      np.asarray(jq)[0])
        np.testing.assert_array_equal(
            s[dst.long()].float().numpy(),
            np.asarray(js.astype(jnp.float32))[0])


def test_rope_cache_write_refusals():
    r, hq, hkv, hd, n = 2, 4, 2, 64, 16
    q = torch.zeros((r, hq, hd), dtype=torch.bfloat16)
    kv = torch.zeros((r, hkv, hd), dtype=torch.bfloat16)
    cs = torch.zeros((r, hd // 2))
    pool = torch.zeros((n, hkv, hd), dtype=torch.bfloat16)
    dst = torch.zeros((r,), dtype=torch.int32)
    _refused(lambda: tda._rope_cache_write_cuda(
        q.float(), kv, kv, cs, cs, pool, pool, dst, None, None), TypeError,
        'q must be')
    _refused(lambda: tda._rope_cache_write_cuda(
        q, kv, kv, cs.double(), cs, pool, pool, dst, None, None), TypeError,
        'cos must be')
    _refused(lambda: tda._rope_cache_write_cuda(
        q, kv, kv, cs, cs, pool.to(torch.int8), pool.to(torch.int8), dst,
        None, None), TypeError, 'k_pool must be')
    _refused(lambda: tda._rope_cache_write_cuda(
        q[:, :, :48].contiguous(), kv[:, :, :48].contiguous(),
        kv[:, :, :48].contiguous(), cs[:, :24].contiguous(),
        cs[:, :24].contiguous(), pool[:, :, :48].contiguous(),
        pool[:, :, :48].contiguous(), dst, None, None), ValueError,
        'head_dim')
    with pytest.raises(ValueError, match='both k_scale and v_scale'):
        tda.rope_cache_write(q, kv, kv, cs, cs, pool, pool, dst,
                             torch.zeros((n, hkv)))


@pytest.mark.parametrize('q8', [False, True], ids=['bf16', 'int8'])
@pytest.mark.parametrize('period', [12, 4, 1])
def test_rope_cache_write_k_out_and_table_period(period, q8):
    """12 rows over a table of ``period`` rows (row r at table row r mod
    period: a [B, T] prompt's T positions once, a decode step's one): the
    same rotated q, pools and ``k_out`` as the table repeated to 12 rows,
    and ``k_out`` the plain rotation of every row's k, bit for bit, the
    rows whose dst is -1 or past the pool included; the pools equal a
    call without ``k_out``."""
    gen = torch.Generator().manual_seed(period + 20 * q8)
    r, hq, hkv, hd, n = 12, 8, 2, 32, 40
    q = torch.randn((r, hq, hd), generator=gen).to(torch.bfloat16)
    k = torch.randn((r, hkv, hd), generator=gen).to(torch.bfloat16)
    v = torch.randn((r, hkv, hd), generator=gen).to(torch.bfloat16)
    angles = torch.rand((period, hd // 2), generator=gen) * 300
    cos, sin = torch.cos(angles), torch.sin(angles)
    full = (cos.repeat(r // period, 1), sin.repeat(r // period, 1))
    dst = torch.randperm(n, generator=gen)[:r].to(torch.int32)
    dst[0], dst[5] = -1, n
    pools = _pools(n, hkv, hd, q8, gen)
    runs = []
    for table, with_k in ((full, True), ((cos, sin), True),
                          ((cos, sin), False)):
        p = [None if x is None else x.clone() for x in pools]
        k_out = torch.full_like(k, float('nan')) if with_k else None
        qo = tda.rope_cache_write(q, k, v, *table, p[0], p[1], dst, p[2],
                                  p[3], k_out=k_out)
        runs.append((qo, p, k_out))
    for qo, p, _ in runs[1:]:
        assert torch.equal(qo, runs[0][0])
        assert all(a is None or torch.equal(a, b)
                   for a, b in zip(p, runs[0][1]))
    rot = tda.rope_plain(k, *full)
    assert torch.equal(runs[0][2], rot) and torch.equal(runs[1][2], rot)
    assert torch.equal(runs[0][0], tda.rope_plain(q, *full))


def test_rope_cache_write_k_out_and_table_refusals():
    """A ``k_out`` or a table the call cannot take is refused on both
    routes (the wrapper) and by the CUDA form's own checks, before
    anything launches."""
    r, hq, hkv, hd, n = 4, 4, 2, 64, 16
    q = torch.zeros((r, hq, hd), dtype=torch.bfloat16)
    kv = torch.zeros((r, hkv, hd), dtype=torch.bfloat16)
    cs = torch.zeros((r, hd // 2))
    pool = torch.zeros((n, hkv, hd), dtype=torch.bfloat16)
    dst = torch.zeros((r,), dtype=torch.int32)
    _refused(lambda: tda.rope_cache_write(
        q, kv, kv, cs, cs, pool, pool, dst, k_out=kv[:2].clone()),
        ValueError, 'k_out')
    _refused(lambda: tda.rope_cache_write(
        q, kv, kv, cs, cs, pool, pool, dst, k_out=kv.float()),
        ValueError, 'k_out')
    _refused(lambda: tda.rope_cache_write(
        q, kv, kv, cs[:3].clone(), cs[:3].clone(), pool, pool, dst),
        ValueError, 'must tile')
    _refused(lambda: tda.rope_cache_write(
        q, kv, kv, cs[0], cs[0], pool, pool, dst), ValueError, 'must tile')
    _refused(lambda: tda._rope_cache_write_cuda(
        q, kv, kv, cs, cs, pool, pool, dst, None, None,
        torch.zeros((r, hd, hkv), dtype=torch.bfloat16).transpose(1, 2)),
        TypeError, 'k_out must be')
    _refused(lambda: tda._rope_cache_write_cuda(
        q, kv, kv, cs, cs, pool, pool, dst, None, None,
        torch.zeros((r, hkv, hd), dtype=torch.int8)), TypeError,
        'k_out must be')
    _refused(lambda: tda._rope_cache_write_cuda(
        q, kv, kv, cs[:2].clone(), cs, pool, pool, dst, None, None),
        TypeError, 'sin must be')


# ---------------------------------------------------------------------
# The prefill chunk's attention and the sampler's threshold
# ---------------------------------------------------------------------


@pytest.mark.parametrize('start,t,real', [(0, 8, 8), (16, 8, 5),
                                          (40, 16, 16)])
def test_prefill_attention_matches_jax_masked_attention(start, t, real):
    """``verify_attention`` at lengths = start + 1 is the causal window
    ``forward_paged`` attended with ``_masked_attention`` (the JAX
    step's form) on every real query; padded queries are never read."""
    rng = np.random.default_rng(start + t)
    s = -(-(start + real) // 8) * 8
    q = rng.standard_normal((1, t, 8, 32)).astype(np.float32)
    k = rng.standard_normal((1, s, 2, 32)).astype(np.float32)
    v = rng.standard_normal((1, s, 2, 32)).astype(np.float32)
    got = tda.verify_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.tensor([start + 1], dtype=torch.int32),
                               32 ** -0.5)
    want = jdecode._masked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), start, start + real,
                                     32 ** -0.5)
    np.testing.assert_allclose(got.numpy()[:, :real],
                               np.asarray(want)[:, :real], **ATTN_TOL)


@pytest.mark.parametrize('prefill', [True, False],
                         ids=['engine_off_prompt', 'cached_step'])
def test_forward_cached_products_route(monkeypatch, prefill):
    """The engine-off prompt (``prefill``) runs its 7 products a layer and
    the head on ``llama.matmul``; every later forward on the invariant
    GEMM's entry (``matmul_invariant.matmul``)."""
    cfg = tllama.get_config('tiny')
    params = tllama.init_params(cfg, seed=0, device='cpu')
    calls = {'llama': 0, 'invariant': 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    monkeypatch.setattr(tllama, 'matmul', counted('llama', tllama.matmul))
    monkeypatch.setattr(tmi, 'matmul', counted('invariant', tmi.matmul))
    cache = tdecode.init_cache(cfg, 2, 16, device='cpu')
    tokens = torch.zeros((2, 4), dtype=torch.long)
    if not prefill:
        tdecode.forward_cached(params, tokens, cache, cfg, prefill=True)
        calls.update(llama=0, invariant=0)
    tdecode.forward_cached(params, tokens[:, :1 if not prefill else 4],
                           cache, cfg, last_only=True, prefill=prefill)
    n = 7 * cfg.n_layers + 1
    assert calls == ({'llama': n, 'invariant': 0} if prefill else
                     {'llama': 0, 'invariant': n})


def test_dense_k4_refuses_int8_with_several_positions():
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16)
    codes = torch.zeros((1, 16, 2, 64), dtype=torch.int8)
    scales = torch.zeros((1, 16, 2), dtype=torch.bfloat16)
    lens = torch.ones((1,), dtype=torch.int32)
    _refused(lambda: tda._decode_attention_cuda(q, codes, codes, lens, 0.1,
                                                scales, scales),
             ValueError, 'W = 1')


def _old_filter(logits, top_p):
    """The nucleus filter as ``sample.py`` wrote it inline before
    ``top_p_kth``."""
    top_p = torch.clamp_min(top_p.float(), 1e-6)[:, None]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    e = torch.exp(sorted_desc - sorted_desc[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    outside = (cum - probs) >= top_p
    kth = torch.where(outside, float('inf'), sorted_desc).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < kth, tsample.NEG_INF, logits)


@pytest.mark.parametrize('top_p', [0.0, 0.3, 0.9, 1.0])
def test_top_p_filter_is_unchanged_and_matches_jax(top_p):
    rng = np.random.default_rng(int(top_p * 10))
    logits = (rng.standard_normal((5, 300)) * 3).astype(np.float32)
    tl = torch.from_numpy(logits)
    tp = torch.full((5,), top_p)
    got = tsample._filter_top_p_row(tl, tp)
    assert torch.equal(got, _old_filter(tl, tp))
    if top_p == 1.0:
        # The cut then falls where the cumulative mass rounds to 1, which
        # depends on the order of the sums (XLA's cumsum and torch's).
        return
    want = jax.vmap(jsample._filter_top_p_row)(
        jnp.asarray(logits), jnp.full((5,), top_p, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
