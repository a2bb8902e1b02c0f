"""The port's int8 slice against the JAX package on the CPU, on ``tiny``
in f32 with JAX's weights carried across as numpy: int8 KV (the dense
cache, the paged pool, the batching steps and the engine), the int8
forms of the decode-attention ops and the cache write, and a QLoRA
finetune over an int8 frozen base.

Tolerances, each from the arithmetic that differs:

- KV codes and scales from the same f32 rows: bit-equal;
- codes written from rows the two sides computed in different summation
  orders: equal but for a rare rounding-boundary flip of one code step,
  and scales within 1e-5 relative;
- attention over int8 pools (dequantized in f32): 2e-5, the JAX
  package's own tolerance for these ops;
- logits: 1e-4 absolute (two f32 layers, logits of magnitude ~5);
  greedy tokens and accepted counts: equal;
- QLoRA (bf16 adapters over an int8 base, f32 compute): as the bf16
  LoRA case of tests/test_torch_train.py — losses rtol 1e-4, grad norms
  one bf16 ulp, adapters two bf16 ulps plus two steps' size.
"""
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import quant as jquant
from skypilot_tpu.ops import decode_attention as jda
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import train as jtrain
from skypilot_tpu.serve import batching as jbatching
from skypilot_torch.models import convert
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.models import quant as tquant
from skypilot_torch.ops import decode_attention as tda
from skypilot_torch.parallel import train as ttrain
from skypilot_torch.recipes import serve_model
from skypilot_torch.serve import batching as tbatching
from skypilot_torch.serve import kv_pool as tpool

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BS = 8


def _np(tree):
    """A JAX tree as numpy: int8 codes stay int8, the rest f32."""
    return jax.tree.map(
        lambda x: np.asarray(x) if x.dtype == jnp.int8
        else np.asarray(x.astype(jnp.float32)), tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_codes(got, want):
    """int8 codes from rows computed in other summation orders: equal
    but for rare one-step flips at a rounding boundary."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, diff.max()


@functools.lru_cache(maxsize=None)
def _models(weights):
    """JAX and port params holding the same weights, plain f32 or
    int8-quantized (each side's tree carries the same codes)."""
    jcfg = jllama.get_config('tiny', dtype=jnp.float32)
    tcfg = tllama.get_config('tiny', dtype=torch.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if weights == 'int8':
        jp = jquant.quantize_params(jp, jcfg)
    tp = convert.params_from_numpy(_np(jp), tcfg, device='cpu')
    return jcfg, tcfg, jp, tp


# Each JAX compile costs seconds on the CPU, so each path runs over one
# kind of weights (both for greedy decoding): int8 weights wherever the
# step reads a {q, s} tree, f32 where the point is the KV arithmetic.
@pytest.fixture(scope='module')
def models():
    return _models('int8')


@pytest.fixture(scope='module')
def f32_models():
    return _models('f32')


def test_quantize_kv_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 3, 64)) *
         rng.uniform(0.01, 4.0, (2, 5, 3, 1))).astype(np.float32)
    x[0, 1, 2] = 0.0                                   # an all-zero row
    for dt in (jnp.float32, jnp.bfloat16):
        jq, js = jdecode._quantize_kv(jnp.asarray(x).astype(dt))
        tx = torch.from_numpy(x).to(torch.bfloat16 if dt == jnp.bfloat16
                                    else torch.float32)
        tq, ts = tdecode._quantize_kv(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.float().numpy(),
                                      np.asarray(js.astype(jnp.float32)))


@pytest.mark.parametrize('weights', ['f32', 'int8'])
def test_greedy_generate_kv_int8_equals_jax(weights):
    jcfg, tcfg, jp, tp = _models(weights)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    want = np.asarray(jdecode.greedy_generate(
        jp, jnp.asarray(prompt), jcfg, 14, max_seq=48, kv_int8=True))
    got = tdecode.greedy_generate(tp, torch.from_numpy(prompt).long(), tcfg,
                                  14, max_seq=48, kv_int8=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_cached_int8_matches_jax(f32_models):
    """Prefill (flash over the exact rows), one decode step (attention
    over codes), a 3-token chunk (the chunk path over the dequantized
    cache); the caches' codes and scales."""
    jcfg, tcfg, jp, tp = f32_models
    rng = np.random.default_rng(2)
    jc = jdecode.init_cache(jcfg, 2, 40, kv_int8=True)
    tc = tdecode.init_cache(tcfg, 2, 40, device='cpu', kv_int8=True)
    assert tc.quantized and tc.k.dtype == torch.int8
    for t, kw in ((11, dict(prefill=True)), (1, {}), (3, {})):
        toks = rng.integers(0, jcfg.vocab_size, (2, t)).astype(np.int32)
        jl, jc = jdecode.forward_cached(jp, jnp.asarray(toks), jc, jcfg,
                                        prefill=kw.get('prefill', False))
        tl, tc = tdecode.forward_cached(tp, torch.from_numpy(toks).long(),
                                        tc, tcfg, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc.pos == int(jc.pos) == 15
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        _close_codes(got.numpy(), want)
    for got, want in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-5, atol=0)


# ---------------------------------------------------------------------
# The int8 forms of the decode-attention ops and the cache write
# ---------------------------------------------------------------------


def _int8_pool(rng, n, hkv=2, hd=64):
    x = rng.standard_normal((1, n, hkv, hd)).astype(np.float32)
    q, s = jdecode._quantize_kv(jnp.asarray(x))
    return np.asarray(q[0]), np.asarray(s[0].astype(jnp.float32))


@pytest.mark.parametrize('w', [1, 3])
def test_paged_int8_attention_matches_jax(w):
    rng = np.random.default_rng(3)
    nb, mb, hq = 13, 4, 8
    kq, ks = _int8_pool(rng, nb * BS)
    vq, vs = _int8_pool(rng, nb * BS)
    q = rng.standard_normal((3, w, hq, 64)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[:3 * mb].reshape(
        3, mb).astype(np.int32)
    lengths = np.asarray([1, 13, mb * BS - w + 1], np.int32)
    jks, jvs = (jnp.asarray(x).astype(jnp.bfloat16) for x in (ks, vs))
    tks, tvs = (_t(x).to(torch.bfloat16) for x in (ks, vs))
    before = (tda.PAGED_DECODE_ATTENTION_Q8.launches,
              tda.PAGED_VERIFY_ATTENTION_Q8.launches)
    if w == 1:
        want = jda.paged_decode_attention(
            jnp.asarray(q[:, 0]), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(tables), jnp.asarray(lengths), 0.125, BS,
            k_scale=jks, v_scale=jvs)
        got = tda.paged_decode_attention(
            _t(q[:, 0]), _t(kq), _t(vq), _t(tables), _t(lengths), 0.125, BS,
            k_scale=tks, v_scale=tvs)
    else:
        want = jda.paged_verify_attention(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(tables), jnp.asarray(lengths), 0.125, BS,
            k_scale=jks, v_scale=jvs)
        got = tda.paged_verify_attention(
            _t(q), _t(kq), _t(vq), _t(tables), _t(lengths), 0.125, BS,
            k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    # The plain version ran: no kernel launch is counted on the CPU.
    assert (tda.PAGED_DECODE_ATTENTION_Q8.launches,
            tda.PAGED_VERIFY_ATTENTION_Q8.launches) == before


def test_dense_int8_attention_matches_jax_dequant_route():
    """The JAX dense path dequantizes the cache, then decode_attention."""
    rng = np.random.default_rng(4)
    b, s = 3, 40
    kq, ks = _int8_pool(rng, b * s)
    vq, vs = _int8_pool(rng, b * s)
    kq, vq = kq.reshape(b, s, 2, 64), vq.reshape(b, s, 2, 64)
    ks, vs = ks.reshape(b, s, 2), vs.reshape(b, s, 2)
    q = rng.standard_normal((b, 8, 64)).astype(np.float32)
    lengths = np.asarray([1, 17, 40], np.int32)
    kd = jdecode._dequant_kv(jnp.asarray(kq), jnp.asarray(ks).astype(
        jnp.bfloat16), jnp.float32)
    vd = jdecode._dequant_kv(jnp.asarray(vq), jnp.asarray(vs).astype(
        jnp.bfloat16), jnp.float32)
    want = jda.decode_attention(jnp.asarray(q), kd, vd, jnp.asarray(lengths),
                                0.125)
    got = tda.decode_attention(_t(q), _t(kq), _t(vq), _t(lengths), 0.125,
                               k_scale=_t(ks).to(torch.bfloat16),
                               v_scale=_t(vs).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_cache_write_int8_bit_equal():
    """Codes and scales land at their rows, as the JAX steps' scatter
    (``.at[idx].set``) puts them; a dst outside the view writes
    nothing."""
    rng = np.random.default_rng(5)
    n, r = 32, 5
    k, ks = _int8_pool(rng, n)
    v, vs = _int8_pool(rng, n)
    kn, ksn = _int8_pool(rng, r)
    vn, vsn = _int8_pool(rng, r)
    dst = np.asarray([3, 31, 0, 40, -1], np.int32)
    keep = (dst >= 0) & (dst < n)
    want = [x.copy() for x in (k, v, ks, vs)]
    for out, new in zip(want, (kn, vn, ksn, vsn)):
        out[dst[keep]] = new[keep]
    got = [_t(k), _t(v), _t(ks).to(torch.bfloat16),
           _t(vs).to(torch.bfloat16)]
    tda.cache_write(got[0], got[1], _t(kn), _t(vn), _t(dst), got[2],
                    got[3], _t(ksn).to(torch.bfloat16),
                    _t(vsn).to(torch.bfloat16))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), w)
    with pytest.raises(ValueError, match='none'):
        tda.cache_write(got[0], got[1], _t(kn), _t(vn), _t(dst), got[2])


# ---------------------------------------------------------------------
# int8 pools through forward_paged and the batching steps
# ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def prefilled(models):
    """Three rows prefilled densely into an int8 cache (JAX), laid into
    an int8 pool with each row's blocks scattered (rows 0, 1) plus a
    parked row 2, and the same content as a dense [L, B, S] cache."""
    jcfg, _, jp, _ = models
    prompts = jnp.asarray([[1, 2, 3, 4], [9, 8, 7, 6], [5, 5, 5, 5]],
                          jnp.int32)
    cache = jdecode.init_cache(jcfg, 3, max_seq=32, kv_int8=True)
    logits, cache = jdecode.forward_cached(jp, prompts, cache, jcfg, True)
    first = np.asarray(logits[:, -1].argmax(-1).astype(jnp.int32))
    nl, nb = jcfg.n_layers, 13
    dense = [np.asarray(x.astype(jnp.float32)) if x.dtype != jnp.int8
             else np.asarray(x)
             for x in (cache.k, cache.v, cache.k_scale, cache.v_scale)]
    order = np.random.default_rng(0).permutation(np.arange(1, nb))
    tables = order.reshape(3, 4).astype(np.int32)
    pools = []
    for x in dense:
        pool = np.zeros((nl, nb, BS) + x.shape[3:], x.dtype)
        for b in range(3):
            rows = x[:, b].reshape((nl, 4, BS) + x.shape[3:])
            for i, blk in enumerate(tables[b]):
                pool[:, blk] = rows[:, i]
        pools.append(pool)
    return dict(first=first, dense=dense, pools=pools, tables=tables,
                pos=np.asarray([4, 4, 32], np.int32),
                active=np.asarray([True, True, False]))


def _jcaches(arrs):
    k, v, ks, vs = arrs
    return (jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(ks).astype(jnp.bfloat16),
            jnp.asarray(vs).astype(jnp.bfloat16))


def _tcaches(arrs):
    k, v, ks, vs = arrs
    return (_t(k), _t(v), _t(ks).to(torch.bfloat16),
            _t(vs).to(torch.bfloat16))


def _check_pools(tc, jc, skip_scratch=True):
    lo = 1 if skip_scratch else 0
    for got, want in zip(tc[:2], jc[:2]):
        _close_codes(got.numpy()[:, lo:], np.asarray(want)[:, lo:])
    for got, want in zip(tc[2:], jc[2:]):
        np.testing.assert_allclose(
            got.float().numpy()[:, lo:],
            np.asarray(want.astype(jnp.float32))[:, lo:], rtol=1e-5, atol=0)


def test_decode_steps_int8_match_jax(models, prefilled):
    """decode_steps_paged over the scattered int8 pool and
    decode_steps_rows over the dense int8 cache, 4 steps each."""
    jcfg, tcfg, jp, tp = models
    p = prefilled
    jt, jc, jpos = jbatching.decode_steps_paged(
        jp, jnp.asarray(p['first']), _jcaches(p['pools']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(p['active']), jcfg, 4, BS)
    tc = _tcaches(p['pools'])
    tt, _, tpos = tbatching.decode_steps_paged(
        tp, _t(p['first']), tc, _t(p['tables']), _t(p['pos']),
        _t(p['active']), tcfg, 4, BS)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _check_pools(tc, jc)
    rt, rc, rpos = jbatching.decode_steps_rows(
        jp, jnp.asarray(p['first']), _jcaches(p['dense']),
        jnp.asarray(p['pos']), jnp.asarray(p['active']), jcfg, 4)
    tc = _tcaches(p['dense'])
    tt, _, tpos = tbatching.decode_steps_rows(
        tp, _t(p['first']), tc, _t(p['pos']), _t(p['active']), tcfg, 4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(rpos))
    _check_pools(tc, rc, skip_scratch=False)


def test_verify_step_int8_matches_jax(models, prefilled):
    jcfg, tcfg, jp, tp = models
    p = prefilled
    want, _, _ = jbatching.decode_steps_paged(
        jp, jnp.asarray(p['first']), _jcaches(p['pools']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(p['active']), jcfg, 5, BS)
    toks = np.concatenate([p['first'][:, None], np.asarray(want)[:, :3]],
                          1).astype(np.int32)
    n_real = np.asarray([4, 2, 0], np.int32)       # row 2 parked
    jout = jbatching.verify_step_paged(
        jp, jnp.asarray(toks), _jcaches(p['pools']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(n_real), jcfg, 4, BS)
    tc = _tcaches(p['pools'])
    tout = tbatching.verify_step_paged(
        tp, _t(toks), tc, _t(p['tables']), _t(p['pos']), _t(n_real), tcfg,
        4, BS)
    live = n_real > 0
    np.testing.assert_array_equal(tout[0].numpy()[live],
                                  np.asarray(jout[0])[live])
    for got, exp in zip(tout[1:4], jout[1:4]):   # accepted, pos, tok
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    _check_pools(tc, jout[4])


def test_forward_paged_int8_matches_jax(models):
    """A 20-token prompt in three chunks over an int8 pool (later
    chunks read earlier chunks' codes), then a request that reuses the
    first two blocks and prefills from offset 16."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, jcfg.vocab_size, 20).astype(np.int32)
    other = np.concatenate([prompt[:16], rng.integers(
        0, jcfg.vocab_size, 7).astype(np.int32)])
    nb = 10
    shape = (jcfg.n_layers, nb, BS, jcfg.n_kv_heads, jcfg.head_dim)
    zeros = [np.zeros(shape, np.int8), np.zeros(shape, np.int8),
             np.zeros(shape[:-1], np.float32),
             np.zeros(shape[:-1], np.float32)]
    jc, tc = _jcaches(zeros), _tcaches(zeros)
    rows = [np.asarray([3, 7, 1, 0], np.int32),
            np.asarray([3, 7, 5, 9], np.int32)]
    for toks, row, starts in ((prompt, rows[0], (0, 8, 16)),
                              (other, rows[1], (16,))):
        for start in starts:
            real = min(8, len(toks) - start)
            chunk = np.zeros((1, 8), np.int32)
            chunk[0, :real] = toks[start:start + real]
            jl, jc = jdecode.forward_paged(
                jp, jnp.asarray(chunk), jc, jnp.asarray(row),
                jnp.asarray(start), jnp.asarray(real), jcfg, BS)
            tl, tc = tdecode.forward_paged(tp, _t(chunk).long(), tc,
                                           _t(row), start, real, tcfg, BS)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
            assert int(tl.argmax()) == int(jnp.argmax(jl))
    _check_pools(tc, jc)


def test_forward_paged_int8_three_chunks_pools_equal_jax(models):
    """A three-chunk int8 prompt, every layer's RoPE, quantization and
    write one ``rope_cache_write``: request A's positions 0-7, then
    request B, which shares A's first block (a prefix hit), from offset 8
    and from 16 (5 real rows, 3 padded to the scratch block). The pools'
    codes and scales equal JAX's bit for bit outside the scratch block;
    each chunk's logits within LOGIT_TOL."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, jcfg.vocab_size, 21).astype(np.int32)
    nb = 6
    shape = (jcfg.n_layers, nb, BS, jcfg.n_kv_heads, jcfg.head_dim)
    zeros = [np.zeros(shape, np.int8), np.zeros(shape, np.int8),
             np.zeros(shape[:-1], np.float32),
             np.zeros(shape[:-1], np.float32)]
    jc, tc = _jcaches(zeros), _tcaches(zeros)
    rows = [np.asarray([2, 5, 4], np.int32), np.asarray([2, 1, 3], np.int32)]
    for req, start in ((0, 0), (1, 8), (1, 16)):
        real = min(8, len(prompt) - start)
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :real] = prompt[start:start + real]
        jl, jc = jdecode.forward_paged(
            jp, jnp.asarray(chunk), jc, jnp.asarray(rows[req]),
            jnp.asarray(start), jnp.asarray(real), jcfg, BS)
        tl, tc = tdecode.forward_paged(tp, _t(chunk).long(), tc,
                                       _t(rows[req]), start, real, tcfg, BS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for got, want in zip(tc[:2], jc[:2]):
        np.testing.assert_array_equal(got.numpy()[:, 1:],
                                      np.asarray(want)[:, 1:])
    for got, want in zip(tc[2:], jc[2:]):
        np.testing.assert_array_equal(
            got.float().numpy()[:, 1:],
            np.asarray(want.astype(jnp.float32))[:, 1:])


def test_engine_kv_int8_equals_jax_engine(models):
    """Single-chunk prompts (the int8 exactness caveat) and a shared
    prefix that hits the prefix cache: the port's int8-KV engine gives
    the JAX int8-KV engine's tokens, request by request."""
    jcfg, tcfg, jp, tp = models
    shared = [(i * 7) % 250 + 1 for i in range(17)]
    cases = [(shared + [3, 9], 8), ([5, 4, 3], 6), (shared + [1], 7)]
    kw = dict(slots=2, max_seq=64, steps_per_dispatch=3, block_size=8,
              prefill_chunk=32, max_num_batched_tokens=64, kv_int8=True)
    jeng = jbatching.BatchingEngine(jp, jcfg, **kw)
    teng = tbatching.BatchingEngine(tp, tcfg, **kw)
    try:
        assert teng.caches[0].dtype == torch.int8
        want = [_drain(jeng.submit(p, m)) for p, m in cases]
        reqs = [teng.submit_request(p, m) for p, m in cases]
        got = [_drain(r.out) for r in reqs]
    finally:
        jeng.close()
        teng.close()
    assert got == want
    assert reqs[2].prefix_hit_blocks > 0


def _drain(q, timeout=60):
    toks = []
    while True:
        t = q.get(timeout=timeout)
        if t is None:
            return toks
        assert not isinstance(t, BaseException), t
        toks.append(t)


def test_engine_kv_int8_equals_dense_int8_greedy(f32_models):
    """The engine over an int8 pool against the dense int8 path
    (``greedy_generate(kv_int8=True)``) on single-chunk prompts, with
    requests outnumbering slots."""
    _, tcfg, _, tp = f32_models
    rng = np.random.default_rng(7)
    cases = [([int(t) for t in rng.integers(1, 500, n)], m)
             for n, m in ((5, 6), (21, 9), (3, 4), (13, 7))]
    eng = tbatching.BatchingEngine(tp, tcfg, slots=2, max_seq=64,
                                   steps_per_dispatch=3, block_size=8,
                                   prefill_chunk=32, kv_int8=True)
    try:
        got = [_drain(eng.submit(p, m)) for p, m in cases]
    finally:
        eng.close()
    for (p, m), toks in zip(cases, got):
        want = tdecode.greedy_generate(tp, torch.tensor([p]), tcfg, m,
                                       max_seq=64, kv_int8=True)
        assert toks == want[0].tolist()


# ---------------------------------------------------------------------
# QLoRA and the replica
# ---------------------------------------------------------------------


def test_qlora_steps_match_jax():
    """Three steps of the port's build_train_step over an int8 frozen
    base against JAX init_qlora_state + build_train_step on a 1-device
    mesh, from the same state (the same codes on each side)."""
    jcfg = jllama.get_config('tiny')
    tcfg = tllama.get_config('tiny')
    mesh = jmesh.make_mesh(jmesh.MeshConfig(), devices=jax.devices()[:1])
    jstate, shardings = jtrain.init_qlora_state(
        jcfg, mesh, jax.random.PRNGKey(0), lora_rank=4)
    jstep = jtrain.build_train_step(jcfg, mesh, shardings, donate=False)
    tstate = convert.train_state_from_numpy(
        _np(jstate.params), _np(jstate.lora), torch.bfloat16, device='cpu')
    assert tquant.is_quantized(tstate.params)
    assert tstate.params['lm_head']['q'].dtype == torch.int8
    tstep = ttrain.build_train_step(tcfg)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 512, (2, 33)).astype(np.int32)
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {'tokens': torch.from_numpy(tokens)})
        np.testing.assert_allclose(tm['loss'].item(), float(jm['loss']),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm['grad_norm'].float().item(),
                                   float(jm['grad_norm']), rtol=2 ** -8)
        losses.append(tm['loss'].item())
    assert losses[2] < losses[0]                  # one fixed batch
    got = convert.train_state_to_numpy(tstate)
    for path, ref in jax.tree_util.tree_leaves_with_path(_np(jstate.lora)):
        np.testing.assert_allclose(got['lora'][path[0].key], ref,
                                   rtol=2 ** -7, atol=6e-4)
    # The frozen base never moves.
    for (_, a), (_, b) in zip(ttrain._leaves(got['params']),
                              ttrain._leaves(_np(jstate.params))):
        np.testing.assert_array_equal(a, b)


def test_init_qlora_state_structure():
    cfg = tllama.get_config('tiny')
    state = ttrain.init_qlora_state(cfg, seed=0, lora_rank=4, device='cpu')
    assert tquant.is_quantized(state.params)
    assert state.lora['wq_a'].dtype == torch.bfloat16
    assert state.opt_state.mu['wq_a'].dtype == torch.float32
    assert state.opt_state.nu['wq_a'].dtype == torch.bfloat16


def test_replica_quant_int8_kv_int8():
    """``serve_model --quant int8 --kv-int8 --slots 2`` on the CPU: the
    replica serves init_quantized's seed-0 weights through an int8 pool,
    token-equal to the dense int8 path on single-chunk prompts."""
    import http.client
    import json
    args = serve_model.parse_args(['--model', 'tiny', '--port', '0',
                                   '--device', 'cpu', '--slots', '2',
                                   '--quant', 'int8', '--kv-int8'])
    server, _ = serve_model.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert server.engine.kv_int8
        prompt = [7, 3, 99, 4, 12]
        conn = http.client.HTTPConnection('127.0.0.1',
                                          server.server_address[1],
                                          timeout=60)
        conn.request('POST', '/generate', body=json.dumps(
            {'prompt_ids': prompt, 'max_new_tokens': 6}),
            headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        server.engine.close()
        thread.join(timeout=10)
    assert resp.status == 200
    cfg = tllama.get_config('tiny')
    params = tquant.init_quantized(cfg, seed=0, device='cpu')
    want = tdecode.greedy_generate(params, torch.tensor([prompt]), cfg, 6,
                                   kv_int8=True)
    assert body['output_ids'] == want[0].tolist()


def test_replica_quant_refusals():
    with pytest.raises(SystemExit):
        serve_model.parse_args(['--quant', 'int8', '--tp', '2'])
    with pytest.raises(SystemExit):
        serve_model.parse_args(['--slots', '2', '--tp', '2'])


def test_int8_pool_bytes_count_codes_and_scales():
    cfg = tllama.get_config('llama3-8b', n_layers=1)
    # Built on the meta-free CPU at a tiny block count: 1 layer, 3 blocks.
    pool = tpool.KVBlockPool(cfg, 3, 16, kv_int8=True, device='cpu')
    per_block = 2 * 16 * 8 * 128 + 2 * 2 * 16 * 8   # codes + bf16 scales
    assert pool.block_bytes == per_block
