"""K4-prefill (``skypilot_torch/ops/decode_attention.prefill_attention``,
``csrc/prefill_attention.cu``) on the CPU, where the entry runs its plain
version: the composition the kernel replaces (the pool gathered through
the block table, int8 dequantized, the chunk's exact rows spliced over
their positions, the plain verify attention).

- The plain version against the JAX package's own route in
  ``forward_paged`` (``paged_gather`` + ``_dequant_kv`` + the int8 splice
  + ``_masked_attention``) on the same numpy inputs: bf16-form (f32) and
  int8 pools, G 1 and 4, head_dim 64 and 128, pages of 8 and 16, a chunk
  from 0, an unaligned start, a prefix-hit start and a padded chunk
  (``real_len < T``): every real query within 2e-5 (f32 under the
  conftest's 'highest' precision, the JAX package's tolerance for these
  ops).
- The launch plan comes from shapes alone: the CUDA wrapper hands the
  kernel the same arguments, pointers aside, at any start, and its grid
  and shared memory fit a block at every head_dim, group and table width
  the engine uses.
- ``forward_paged`` and ``forward_cached``'s chunk after earlier
  positions route through the entry once a layer and gather no view
  themselves; the wrapper refuses what the kernel does not take before
  anything launches.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.ops import decode_attention as jda
from skypilot_tpu.serve import kv_pool as jkv_pool
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.ops import decode_attention as tda

TOL = dict(rtol=2e-5, atol=2e-5)
HKV = 2


def _launches():
    return (tda.PREFILL_ATTENTION.launches,
            tda.PREFILL_ATTENTION_Q8.launches,
            tda.DECODE_ATTENTION.launches)


def _case(rng, groups, hd, bs, start, t, real, q8):
    """A request's table over a shuffled pool holding its earlier keys,
    the chunk's rows written at their positions (real rows only, as K5
    writes them; int8 as codes and scales), q and the chunk's rows."""
    hq = HKV * groups
    mb = -(-(start + t) // bs) + 1
    nb = 2 * mb + 1
    table = (rng.permutation(nb - 1)[:mb] + 1).astype(np.int32)
    q = rng.standard_normal((1, t, hq, hd)).astype(np.float32)
    k = rng.standard_normal((1, t, HKV, hd)).astype(np.float32)
    v = rng.standard_normal((1, t, HKV, hd)).astype(np.float32)
    pos = start + np.arange(real)
    dst = table[pos // bs] * bs + pos % bs
    if q8:
        kp = rng.integers(-127, 128, (nb * bs, HKV, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (nb * bs, HKV, hd)).astype(np.int8)
        ks = torch.from_numpy(rng.random((nb * bs, HKV)).astype(
            np.float32) * 0.02).to(torch.bfloat16)
        vs = torch.from_numpy(rng.random((nb * bs, HKV)).astype(
            np.float32) * 0.02).to(torch.bfloat16)
        (kc, kcs), (vc, vcs) = (tda.quantize_kv(torch.from_numpy(x[0]))
                                for x in (k, v))
        kp[dst], vp[dst] = kc[:real].numpy(), vc[:real].numpy()
        ks[dst], vs[dst] = kcs[:real], vcs[:real]
        scales = (ks, vs)
    else:
        kp = rng.standard_normal((nb * bs, HKV, hd)).astype(np.float32)
        vp = rng.standard_normal((nb * bs, HKV, hd)).astype(np.float32)
        kp[dst], vp[dst] = k[0, :real], v[0, :real]
        scales = None
    return table, q, k, v, kp, vp, scales


def _jax_route(table, q, k, v, kp, vp, scales, start, real, bs):
    """``forward_paged``'s attention in the JAX package: the view gathered
    up to kv_len's last block, dequantized, the chunk spliced (int8), the
    causal window from start."""
    t, hd = q.shape[1], q.shape[-1]
    kv_len = start + real
    gr = jkv_pool.read_indices(jnp.asarray(table[:-(-kv_len // bs)]), bs)
    if scales is None:
        kd = jda.paged_gather(jnp.asarray(kp), gr[None])
        vd = jda.paged_gather(jnp.asarray(vp), gr[None])
    else:
        jks, jvs = (jnp.asarray(s.float().numpy()).astype(jnp.bfloat16)
                    for s in scales)
        kd = jdecode._dequant_kv(jda.paged_gather(jnp.asarray(kp), gr[None]),
                                 jda.paged_gather(jks, gr[None]),
                                 jnp.float32)
        vd = jdecode._dequant_kv(jda.paged_gather(jnp.asarray(vp), gr[None]),
                                 jda.paged_gather(jvs, gr[None]),
                                 jnp.float32)
        rel = jnp.arange(gr.shape[0]) - start
        inside = ((rel >= 0) & (rel < t))[None, :, None, None]
        relc = jnp.clip(rel, 0, t - 1)
        kd = jnp.where(inside, jnp.asarray(k[0])[relc][None], kd)
        vd = jnp.where(inside, jnp.asarray(v[0])[relc][None], vd)
    return np.asarray(jdecode._masked_attention(
        jnp.asarray(q), kd, vd, q_pos=start, kv_len=kv_len,
        scale=hd ** -0.5))


@pytest.mark.parametrize('q8', [False, True], ids=['bf16_form', 'int8'])
@pytest.mark.parametrize('groups,hd', [(1, 64), (4, 128)])
@pytest.mark.parametrize('bs', [8, 16])
@pytest.mark.parametrize('start,t,real', [(0, 16, 16), (13, 16, 16),
                                          (32, 16, 16), (40, 16, 11)],
                         ids=['from_0', 'unaligned', 'prefix_hit',
                              'padded'])
def test_plain_matches_jax_route(q8, groups, hd, bs, start, t, real):
    """Tolerance 2e-5 (f32): the two routes differ only in their
    reductions' order; padded queries past ``real`` are never read."""
    rng = np.random.default_rng(start * 7 + bs + hd + groups + q8)
    table, q, k, v, kp, vp, scales = _case(rng, groups, hd, bs, start, t,
                                           real, q8)
    want = _jax_route(table, q, k, v, kp, vp, scales, start, real, bs)
    extra = {}
    if q8:
        extra = dict(k_new=torch.from_numpy(k), v_new=torch.from_numpy(v),
                     k_scale=scales[0], v_scale=scales[1])
    before = _launches()
    got = tda.prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.tensor([start + 1], dtype=torch.int32), hd ** -0.5,
        block_table=torch.from_numpy(table)[None], block_size=bs, **extra)
    assert _launches() == before
    np.testing.assert_allclose(got.numpy()[:, :real], want[:, :real], **TOL)


def test_dense_form_equals_paged_form_over_a_contiguous_table():
    """``verify_attention`` (the dense form) and the paged form over a
    table laying the same keys out in order compute one function."""
    rng = np.random.default_rng(5)
    s, t, bs, hd = 48, 16, 8, 64
    q = torch.from_numpy(rng.standard_normal((1, t, 8, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, s, HKV, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, s, HKV, hd)).astype(
        np.float32))
    lengths = torch.tensor([s - t + 1], dtype=torch.int32)
    dense = tda.verify_attention(q, k, v, lengths, hd ** -0.5)
    paged = tda.prefill_attention(
        q, k[0], v[0], lengths, hd ** -0.5,
        block_table=torch.arange(s // bs, dtype=torch.int32)[None],
        block_size=bs)
    torch.testing.assert_close(dense, paged, rtol=0, atol=0)


class _Recorder:
    """Stands in for a kernel entry: records the arguments of each call,
    pointers (ctypes c_void_p arguments) left out."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.calls = []

    def __call__(self, *args):
        import ctypes
        self.calls.append(tuple(
            a for a, ty in zip(args, self.kernel.argtypes)
            if ty is not ctypes.c_void_p))


@pytest.mark.parametrize('q8', [False, True], ids=['bf16', 'int8'])
def test_launch_arguments_depend_on_shapes_only(monkeypatch, q8):
    """The CUDA wrapper at starts 0, 37 and 600 of a 1040-key table (the
    engine's T 512 chunk, llama3-8b heads, 16-row pages): the same
    arguments each time but the pointers, so the grid, the split and the
    shared memory come from shapes, and a CUDA graph can hold a call."""
    rec = {False: _Recorder(tda.PREFILL_ATTENTION),
           True: _Recorder(tda.PREFILL_ATTENTION_Q8)}
    monkeypatch.setattr(tda, 'PREFILL_ATTENTION', rec[False])
    monkeypatch.setattr(tda, 'PREFILL_ATTENTION_Q8', rec[True])
    monkeypatch.setattr(tda, '_stream', lambda x: 0)
    t, hq, hkv, hd, bs, mb = 512, 32, 8, 128, 16, 65
    n = (mb + 1) * bs
    q = torch.zeros((1, t, hq, hd), dtype=torch.bfloat16)
    table = torch.arange(1, mb + 1, dtype=torch.int32)[None]
    if q8:
        pool = torch.zeros((n, hkv, hd), dtype=torch.int8)
        scales = torch.zeros((n, hkv), dtype=torch.bfloat16)
        rows = torch.zeros((1, t, hkv, hd), dtype=torch.bfloat16)
        extra = dict(k_new=rows, v_new=rows, k_scale=scales, v_scale=scales)
    else:
        pool = torch.zeros((n, hkv, hd), dtype=torch.bfloat16)
        extra = {}
    for start in (0, 37, 600):
        tda._prefill_attention_cuda(
            q, pool, pool, torch.tensor([start + 1], dtype=torch.int32),
            hd ** -0.5, table, bs, extra.get('k_new'), extra.get('v_new'),
            extra.get('k_scale'), extra.get('v_scale'))
    calls = rec[q8].calls
    assert len(calls) == 3 and calls[0] == calls[1] == calls[2]
    assert not rec[not q8].calls
    assert tda.DECODE_CHUNK in calls[0]


@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('groups', [1, 2, 4, 8])
def test_plan_fits_a_block(hd, groups):
    """Every instantiation's block at the engine's table widths (an
    8192-key row in 16-row pages, with slack) and at pages of 8: the
    shared memory within what a block may use, the grid covering every
    m-tile of a 512-row chunk once, K4's splits over the row's keys and
    a 16 x hd partial for each (block, m-tile, split)."""
    for q8 in (False, True):
        for mb, bs in ((0, 16), (69, 16), (514, 16), (1026, 8)):
            s = bs * max(mb, 69)
            plan = tda.prefill_plan(1, 512, 32 // groups, groups, hd, q8,
                                    s, mb)
            assert plan['smem'] <= tda.DECODE_MAX_SMEM, (q8, mb, plan)
            assert plan['threads'] == tda.PREFILL_THREADS
            mtiles = math.ceil(512 * groups / 16)
            assert plan['grid'][0] * tda.PREFILL_MTILES >= mtiles
            assert (plan['grid'][0] - 1) * tda.PREFILL_MTILES < mtiles
            assert plan['grid'][1:] == (32 // groups, 1)
            assert (plan['chunk'], plan['n_split']) == \
                tda.decode_split_plan(s)
            assert plan['scratch'] == (32 // groups * plan['grid'][0] *
                                       tda.PREFILL_MTILES *
                                       plan['n_split'] * 16 * hd)


def _refused(fn, exc, match):
    before = _launches()
    with pytest.raises(exc, match=match):
        fn()
    assert _launches() == before


def test_wrapper_refusals():
    """What the kernel does not take raises before anything launches:
    exact rows over a bf16 cache (it holds them), an int8 dense cache,
    a page size that is not a power of two of at least 8, K and V with
    other strides."""
    q = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16)
    pool = torch.zeros((64, HKV, 64), dtype=torch.bfloat16)
    lens = torch.ones((1,), dtype=torch.int32)
    table = torch.zeros((1, 4), dtype=torch.int32)
    rows = torch.zeros((1, 4, HKV, 64), dtype=torch.bfloat16)
    _refused(lambda: tda.prefill_attention(q, pool, pool, lens, 0.1,
                                           block_table=table, block_size=16,
                                           k_new=rows, v_new=rows),
             ValueError, 'int8 cache only')
    codes = torch.zeros((1, 16, HKV, 64), dtype=torch.int8)
    sc = torch.zeros((1, 16, HKV), dtype=torch.bfloat16)
    _refused(lambda: tda._prefill_attention_cuda(q, codes, codes, lens, 0.1,
                                                 None, None, None, None, sc,
                                                 sc),
             ValueError, 'paged pool only')
    _refused(lambda: tda._prefill_attention_cuda(q, pool, pool, lens, 0.1,
                                                 table, 12, None, None, None,
                                                 None),
             ValueError, 'block_size')
    wide = torch.zeros((64, HKV, 128), dtype=torch.bfloat16)[..., :64]
    _refused(lambda: tda._prefill_attention_cuda(q, pool, wide, lens, 0.1,
                                                 table, 16, None, None, None,
                                                 None),
             ValueError, 'contiguous')


def _counting(monkeypatch):
    """Counts of ``prefill_attention`` calls and of ``paged_gather`` calls
    made outside them (the entry's plain version gathers inside)."""
    calls = {'prefill_attention': 0, 'paged_gather': 0}
    inside = [False]
    real_pa, real_gather = tda.prefill_attention, tda.paged_gather

    def pa(*args, **kwargs):
        calls['prefill_attention'] += 1
        inside[0] = True
        try:
            return real_pa(*args, **kwargs)
        finally:
            inside[0] = False

    def gather(*args, **kwargs):
        if not inside[0]:
            calls['paged_gather'] += 1
        return real_gather(*args, **kwargs)
    monkeypatch.setattr(tda, 'prefill_attention', pa)
    monkeypatch.setattr(tda, 'paged_gather', gather)
    return calls


@pytest.mark.parametrize('quantized', [False, True], ids=['bf16', 'int8'])
def test_forward_paged_routes_through_the_entry(monkeypatch, quantized):
    """One ``prefill_attention`` a layer, no gathered view of its own."""
    cfg = tllama.get_config('tiny')
    params = tllama.init_params(cfg, seed=0, device='cpu')
    bs, nb = 8, 6
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        pools = (torch.zeros(shape, dtype=torch.int8),
                 torch.zeros(shape, dtype=torch.int8),
                 torch.zeros(shape[:-1], dtype=torch.bfloat16),
                 torch.zeros(shape[:-1], dtype=torch.bfloat16))
    else:
        pools = (torch.zeros(shape, dtype=cfg.dtype),
                 torch.zeros(shape, dtype=cfg.dtype), None, None)
    calls = _counting(monkeypatch)
    row = torch.tensor([3, 1, 4, 0], dtype=torch.int32)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    tdecode.forward_paged(params, tokens, pools, row, 8, 6, cfg, bs)
    assert calls == {'prefill_attention': cfg.n_layers, 'paged_gather': 0}


def test_forward_cached_chunk_routes_through_the_entry(monkeypatch):
    """A chunk after earlier positions (``_layer_cached``): the dense form,
    once a layer."""
    cfg = tllama.get_config('tiny')
    params = tllama.init_params(cfg, seed=0, device='cpu')
    cache = tdecode.init_cache(cfg, 2, 16, device='cpu')
    tokens = torch.zeros((2, 4), dtype=torch.long)
    tdecode.forward_cached(params, tokens, cache, cfg, prefill=True)
    calls = _counting(monkeypatch)
    tdecode.forward_cached(params, tokens, cache, cfg)
    assert calls == {'prefill_attention': cfg.n_layers, 'paged_gather': 0}
