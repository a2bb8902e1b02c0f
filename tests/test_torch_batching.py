"""Parity of the port's batching device steps and host helpers
(skypilot_torch/serve/batching.py, models/decode.forward_paged,
serve/sampling/accept.py) with the JAX package on the CPU, on ``tiny``
in f32 with JAX's weights carried across as numpy: tokens, ``pos`` and
``accepted`` are equal, and pool contents agree within 1e-5 (the same
f32 layer math summed in another order). The drafting, adaptive-k and
acceptance helpers are compared on seeded streams, and the port keeps
exactly one acceptance implementation."""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import batching as jbatching
from skypilot_tpu.serve.sampling import accept_tokens as jaccept
import skypilot_torch
from skypilot_torch.models import convert
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.serve import batching as tbatching
from skypilot_torch.serve.sampling import accept_tokens as taccept

POOL_TOL = dict(rtol=1e-5, atol=1e-5)
BS = 8


@pytest.fixture(scope='module')
def models():
    jcfg = jllama.get_config('tiny', dtype=jnp.float32)
    tcfg = tllama.get_config('tiny', dtype=torch.float32)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, tcfg, device='cpu')
    return jcfg, tcfg, jp, tp


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def prefilled(models):
    """Three rows prefilled densely (JAX), laid into a pool with each
    row's blocks scattered (rows 0, 1) plus a parked row 2, and the
    same content as a dense [L, B, S] cache."""
    jcfg, _, jp, _ = models
    prompts = jnp.asarray([[1, 2, 3, 4], [9, 8, 7, 6], [5, 5, 5, 5]],
                          jnp.int32)
    cache = jdecode.init_cache(jcfg, 3, max_seq=32)
    logits, cache = jdecode.forward_cached(jp, prompts, cache, jcfg, True)
    first = np.asarray(logits[:, -1].argmax(-1).astype(jnp.int32))
    nl = jcfg.n_layers
    dense_k, dense_v = np.asarray(cache.k), np.asarray(cache.v)
    nb = 13
    shape = (nl, nb, BS, jcfg.n_kv_heads, jcfg.head_dim)
    k_pool, v_pool = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    order = np.random.default_rng(0).permutation(np.arange(1, nb))
    tables = order.reshape(3, 4).astype(np.int32)
    for b in range(3):
        rk = dense_k[:, b].reshape(nl, 4, BS, *shape[3:])
        rv = dense_v[:, b].reshape(nl, 4, BS, *shape[3:])
        for i, blk in enumerate(tables[b]):
            k_pool[:, blk] = rk[:, i]
            v_pool[:, blk] = rv[:, i]
    return dict(first=first, dense_k=dense_k, dense_v=dense_v,
                k_pool=k_pool, v_pool=v_pool, tables=tables,
                pos=np.asarray([4, 4, 32], np.int32),
                active=np.asarray([True, True, False]))


def _jcaches(k, v):
    return (jnp.asarray(k), jnp.asarray(v), None, None)


def _tcaches(k, v):
    return (_t(k), _t(v), None, None)


def test_decode_steps_paged_matches_jax(models, prefilled):
    jcfg, tcfg, jp, tp = models
    p = prefilled
    jt, jc, jpos = jbatching.decode_steps_paged(
        jp, jnp.asarray(p['first']), _jcaches(p['k_pool'], p['v_pool']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(p['active']), jcfg, 4, BS)
    tc = _tcaches(p['k_pool'], p['v_pool'])
    tt, tc2, tpos = tbatching.decode_steps_paged(
        tp, _t(p['first']), tc, _t(p['tables']), _t(p['pos']),
        _t(p['active']), tcfg, 4, BS)
    assert tc2 is tc                      # updated in place
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    # The scratch block takes the parked row's racing writes; the rest
    # of the pool must agree.
    for got, want in zip(tc[:2], jc[:2]):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], **POOL_TOL)


def test_decode_steps_rows_matches_jax(models, prefilled):
    jcfg, tcfg, jp, tp = models
    p = prefilled
    jt, jc, jpos = jbatching.decode_steps_rows(
        jp, jnp.asarray(p['first']), _jcaches(p['dense_k'], p['dense_v']),
        jnp.asarray(p['pos']), jnp.asarray(p['active']), jcfg, 4)
    tc = _tcaches(p['dense_k'], p['dense_v'])
    tt, _, tpos = tbatching.decode_steps_rows(
        tp, _t(p['first']), tc, _t(p['pos']), _t(p['active']), tcfg, 4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for got, want in zip(tc[:2], jc[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **POOL_TOL)


def test_paged_step_equals_rows_twin_on_contiguous_tables(models,
                                                          prefilled):
    """The port of tests/test_kv_pool.py's twin test: rows laid out
    contiguously in a pool decode exactly as the dense cache does."""
    _, tcfg, _, tp = models
    p = prefilled
    nl = tcfg.n_layers
    dk, dv = p['dense_k'][:, :2], p['dense_v'][:, :2]
    want, _, want_pos = tbatching.decode_steps_rows(
        tp, _t(p['first'][:2]), _tcaches(dk, dv), _t(p['pos'][:2]),
        torch.tensor([True, True]), tcfg, 4)
    # Row b's slab is blocks [b*4+1 .. b*4+4]; block 0 stays scratch.
    scratch = np.zeros((nl, BS) + dk.shape[3:], np.float32)
    k_pool = np.concatenate([scratch,
                             dk.reshape(nl, 2 * 32, *dk.shape[3:])], 1)
    v_pool = np.concatenate([scratch,
                             dv.reshape(nl, 2 * 32, *dv.shape[3:])], 1)
    k_pool = k_pool.reshape(nl, 9, BS, *dk.shape[3:])
    v_pool = v_pool.reshape(nl, 9, BS, *dv.shape[3:])
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    got, _, got_pos = tbatching.decode_steps_paged(
        tp, _t(p['first'][:2]), _tcaches(k_pool, v_pool), tables,
        _t(p['pos'][:2]), torch.tensor([True, True]), tcfg, 4, BS)
    assert torch.equal(got, want) and torch.equal(got_pos, want_pos)


@pytest.mark.parametrize('corrupt', [False, True])
def test_verify_step_paged_matches_jax(models, prefilled, corrupt):
    jcfg, tcfg, jp, tp = models
    p = prefilled
    want, _, _ = jbatching.decode_steps_paged(
        jp, jnp.asarray(p['first']), _jcaches(p['k_pool'], p['v_pool']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(p['active']), jcfg, 5, BS)
    draft = np.asarray(want)[:, :3].copy()
    if corrupt:
        draft[0, 1] = (draft[0, 1] + 1) % jcfg.vocab_size
    toks = np.concatenate([p['first'][:, None], draft], 1).astype(np.int32)
    n_real = np.asarray([4, 2, 0], np.int32)       # row 2 parked
    jout = jbatching.verify_step_paged(
        jp, jnp.asarray(toks), _jcaches(p['k_pool'], p['v_pool']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(n_real), jcfg, 4, BS)
    tc = _tcaches(p['k_pool'], p['v_pool'])
    tout = tbatching.verify_step_paged(
        tp, _t(toks), tc, _t(p['tables']), _t(p['pos']), _t(n_real), tcfg,
        4, BS)
    # A parked row attends one key in the port (its predictions are
    # never read), so preds agree on the live rows only.
    live = n_real > 0
    np.testing.assert_array_equal(tout[0].numpy()[live],
                                  np.asarray(jout[0])[live])
    for got, exp in zip(tout[1:4], jout[1:4]):   # accepted, pos, tok
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert tout[1].tolist() == ([1, 1, 0] if corrupt else [3, 1, 0])
    for got, exp in zip(tc[:2], jout[4][:2]):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(exp)[:, 1:], **POOL_TOL)


def test_forward_paged_chunks_and_prefix_offset_match_jax(models):
    """A 20-token prompt in three chunks (8, 8, 4 padded to 8), then a
    second request that reuses the first two blocks (a prefix hit) and
    prefills from offset 16."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, 20).astype(np.int32)
    other = np.concatenate([prompt[:16], rng.integers(
        0, jcfg.vocab_size, 7).astype(np.int32)])
    nb = 10
    shape = (jcfg.n_layers, nb, BS, jcfg.n_kv_heads, jcfg.head_dim)
    jc = _jcaches(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
    tc = _tcaches(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
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
            assert tl.shape == (1, tcfg.vocab_size)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)
            assert int(tl.argmax()) == int(jnp.argmax(jl))
    for got, exp in zip(tc[:2], jc[:2]):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(exp)[:, 1:], **POOL_TOL)


def _count_writes(monkeypatch):
    """Count ``rope_cache_write`` and ``cache_write`` calls through the
    module the serving forwards call them from."""
    from skypilot_torch.ops import decode_attention as tda
    calls = {'rope_cache_write': 0, 'cache_write': 0}
    for name in calls:
        real = getattr(tda, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tda, name, counted)
    return calls


@pytest.mark.parametrize('int8', [False, True], ids=['f32', 'int8'])
def test_forward_paged_writes_through_rope_cache_write(models, monkeypatch,
                                                       int8):
    """Each chunk's RoPE, quantization and write are one
    ``rope_cache_write`` a layer (K5F on the card): L calls a chunk, no
    ``cache_write``; over two chunks, the second at offset 8."""
    _, tcfg, _, tp = models
    calls = _count_writes(monkeypatch)
    shape = (tcfg.n_layers, 4, BS, tcfg.n_kv_heads, tcfg.head_dim)
    if int8:
        pools = (torch.zeros(shape, dtype=torch.int8),
                 torch.zeros(shape, dtype=torch.int8),
                 torch.zeros(shape[:-1], dtype=torch.bfloat16),
                 torch.zeros(shape[:-1], dtype=torch.bfloat16))
    else:
        pools = (torch.zeros(shape), torch.zeros(shape), None, None)
    row = torch.tensor([2, 3, 1], dtype=torch.int32)
    for n, (start, real) in enumerate(((0, 8), (8, 5)), 1):
        toks = torch.arange(1, 9)[None]
        tdecode.forward_paged(tp, toks, pools, row, start, real, tcfg, BS)
        assert calls == {'rope_cache_write': n * tcfg.n_layers,
                         'cache_write': 0}


def _streams(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pat = [int(x) for x in rng.integers(0, 6, int(rng.integers(2, 6)))]
        noise = [int(x) for x in rng.integers(0, 6, i % 7)]
        out.append(pat * 4 + noise + pat[:2])
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_propose_ngram_draft_matches(seed):
    for stream in _streams(seed):
        for k in (0, 1, 3, 8):
            for bar in (2, 3, 4):
                assert tbatching.propose_ngram_draft(
                    stream, k, min_ngram=bar) == \
                    jbatching.propose_ngram_draft(stream, k, min_ngram=bar)
    long = list(range(3000)) + [5, 6]
    assert tbatching.propose_ngram_draft(long, 4) == \
        jbatching.propose_ngram_draft(long, 4) == []


def test_update_spec_k_matches():
    rng = np.random.default_rng(2)
    for _ in range(300):
        window = [(int(p), int(rng.integers(0, p + 1)))
                  for p in rng.integers(0, 9, int(rng.integers(0, 8)))]
        cur = int(rng.integers(0, 9))
        assert tbatching.update_spec_k(cur, window, 8) == \
            jbatching.update_spec_k(cur, window, 8)


def test_accept_tokens_matches():
    rng = np.random.default_rng(3)
    for w in (1, 2, 5, 9):
        tokens = rng.integers(0, 3, (16, w)).astype(np.int32)
        preds = rng.integers(0, 3, (16, w)).astype(np.int32)
        n_real = rng.integers(0, w + 1, 16).astype(np.int32)
        got = taccept(_t(tokens), _t(preds), _t(n_real))
        want = jaccept(jnp.asarray(tokens), jnp.asarray(preds),
                       jnp.asarray(n_real))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_single_accept_tokens_definition():
    """The port keeps ONE acceptance implementation, as the JAX package
    lints for its own tree."""
    root = os.path.dirname(skypilot_torch.__file__)
    defs = []
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith('.py'):
                path = os.path.join(dirpath, fn)
                with open(path, encoding='utf-8') as f:
                    text = f.read()
                defs += [path for _ in re.finditer(
                    r'^\s*def accept_tokens\(', text, re.M)]
    assert len(defs) == 1, defs
    assert defs[0].endswith(os.path.join('serve', 'sampling', 'accept.py'))


def _sampling_args(n_rows, v, width=None, masked=False, seed=0):
    """A ``sampling`` dict for the device steps on both sides: mixed
    temperatures (a greedy row among them), top_p and seeds of both
    signs, and a mask table whose line 1 (row 0's) allows a third of
    the vocab."""
    rng = np.random.default_rng(seed)
    temps = np.asarray([0.8, 0.0, 1.3][:n_rows], np.float32)
    tops = np.asarray([0.9, 1.0, 0.7][:n_rows], np.float32)
    seeds = np.asarray([7, -3, 2 ** 31 - 9][:n_rows], np.int32)
    shape = (n_rows + 1, v) if width is None else (n_rows + 1, width, v)
    table = np.ones(shape, bool)
    idx = np.zeros(n_rows, np.int32)
    if masked:
        table[1] = rng.random(shape[1:]) < 0.33
        idx[0] = 1
    raw = dict(temps=temps, top_ps=tops, seeds=seeds, mask_table=table,
               mask_idx=idx)
    return ({k: jnp.asarray(x) for k, x in raw.items()},
            {k: _t(x) for k, x in raw.items()})


@pytest.mark.parametrize('masked', [False, True])
def test_sampled_decode_steps_paged_matches_jax(models, prefilled,
                                                masked):
    jcfg, tcfg, jp, tp = models
    p = prefilled
    js, ts = _sampling_args(3, jcfg.vocab_size, masked=masked)
    jt, _, jpos = jbatching.decode_steps_paged(
        jp, jnp.asarray(p['first']), _jcaches(p['k_pool'], p['v_pool']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(p['active']), jcfg, 4, BS, sampling=js)
    tt, _, tpos = tbatching.decode_steps_paged(
        tp, _t(p['first']), _tcaches(p['k_pool'], p['v_pool']),
        _t(p['tables']), _t(p['pos']), _t(p['active']), tcfg, 4, BS,
        sampling=ts)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    if masked:
        assert ts['mask_table'][1][tt[0].long()].all()


def test_sampled_decode_steps_rows_matches_jax(models, prefilled):
    jcfg, tcfg, jp, tp = models
    p = prefilled
    js, ts = _sampling_args(3, jcfg.vocab_size, masked=True, seed=1)
    jt, _, jpos = jbatching.decode_steps_rows(
        jp, jnp.asarray(p['first']), _jcaches(p['dense_k'], p['dense_v']),
        jnp.asarray(p['pos']), jnp.asarray(p['active']), jcfg, 4,
        sampling=js)
    tt, _, tpos = tbatching.decode_steps_rows(
        tp, _t(p['first']), _tcaches(p['dense_k'], p['dense_v']),
        _t(p['pos']), _t(p['active']), tcfg, 4, sampling=ts)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize('masked', [False, True])
def test_sampled_verify_step_paged_matches_jax(models, prefilled, masked):
    """Drafts taken from the sampled decode's own tokens, so the sampled
    verify accepts them: the maximal coupling, on both sides."""
    jcfg, tcfg, jp, tp = models
    p = prefilled
    js, ts = _sampling_args(3, jcfg.vocab_size, masked=False, seed=2)
    want, _, _ = jbatching.decode_steps_paged(
        jp, jnp.asarray(p['first']), _jcaches(p['k_pool'], p['v_pool']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(p['active']), jcfg, 5, BS, sampling=js)
    draft = np.asarray(want)[:, :3].copy()
    toks = np.concatenate([p['first'][:, None], draft], 1).astype(np.int32)
    n_real = np.asarray([4, 2, 0], np.int32)
    js, ts = _sampling_args(3, jcfg.vocab_size, width=4, masked=masked,
                            seed=2)
    jout = jbatching.verify_step_paged(
        jp, jnp.asarray(toks), _jcaches(p['k_pool'], p['v_pool']),
        jnp.asarray(p['tables']), jnp.asarray(p['pos']),
        jnp.asarray(n_real), jcfg, 4, BS, sampling=js)
    tout = tbatching.verify_step_paged(
        tp, _t(toks), _tcaches(p['k_pool'], p['v_pool']), _t(p['tables']),
        _t(p['pos']), _t(n_real), tcfg, 4, BS, sampling=ts)
    live = n_real > 0
    np.testing.assert_array_equal(tout[0].numpy()[live],
                                  np.asarray(jout[0])[live])
    for got, exp in zip(tout[1:4], jout[1:4]):   # accepted, pos, tok
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    if not masked:
        assert tout[1].tolist() == [3, 1, 0]


def test_deferred_step_options_raise(models, prefilled):
    """The steps' adapter arguments (ported with the multi-LoRA slice) go
    together: one without the other raises. With both, rows on slot 0 of
    an all-zeros factor set run exactly the adapterless math."""
    _, tcfg, _, tp = models
    p = prefilled
    args = (tp, _t(p['first']), _tcaches(p['k_pool'], p['v_pool']),
            _t(p['tables']), _t(p['pos']), _t(p['active']), tcfg, 1, BS)
    zeros = {name: torch.zeros((tcfg.n_layers, 2) + shape)
             for name, shape in (('wq_a', (tcfg.dim, 4)),
                                 ('wq_b', (4, tcfg.n_heads * tcfg.head_dim)),
                                 ('wv_a', (tcfg.dim, 4)),
                                 ('wv_b', (4, tcfg.n_kv_heads *
                                           tcfg.head_dim)))}
    with pytest.raises(ValueError, match='together'):
        tbatching.decode_steps_paged(*args, adapters=zeros)
    with pytest.raises(ValueError, match='together'):
        tbatching.decode_steps_paged(*args, adapter_idx=_t([0, 0, 0]))
    with pytest.raises(ValueError, match='together'):
        tbatching.verify_step_paged(
            tp, _t(np.zeros((3, 2), np.int32)),
            _tcaches(p['k_pool'], p['v_pool']), _t(p['tables']),
            _t(p['pos']), _t(np.ones(3, np.int32)), tcfg, 2, BS,
            adapters=zeros)
    want, _, _ = tbatching.decode_steps_paged(*args)
    args = (tp, _t(p['first']), _tcaches(p['k_pool'], p['v_pool'])) + \
        args[3:]
    got, _, _ = tbatching.decode_steps_paged(
        *args, adapters=zeros, adapter_idx=_t(np.zeros(3, np.int32)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
