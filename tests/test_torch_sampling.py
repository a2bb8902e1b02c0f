"""Parity of the port's sampling modules (skypilot_torch/serve/sampling/
prng.py, sample.py, grammar.py and models/decode.sample_generate) with
the JAX package on the CPU.

Keys, random bits and uniforms are held bit for bit to the installed
JAX (threefry2x32, ``jax_threefry_partitionable`` on); gumbel noise
stage by stage: each of its two logs within 1 f32 ulp of XLA's on the
same input, and the composite within the inner ulp carried through the
outer log (2**-22) plus one ulp of the result; tokens drawn by
``sample_rows``,
``sample_first``, ``verify_targets`` and ``sample_generate`` must be
equal; grammar masks and DFA walks equal. Inputs are made from seeds
with numpy."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve.sampling import grammar as jgrammar
from skypilot_tpu.serve.sampling import prng as jprng
from skypilot_tpu.serve.sampling import sample as jsample
from skypilot_torch.models import convert
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.serve import sampling as tsampling
from skypilot_torch.serve.sampling import grammar as tgrammar
from skypilot_torch.serve.sampling import prng as tprng
from skypilot_torch.serve.sampling import sample as tsample

# Seeds as the engine stores them (the int32 two's complement of seed
# mod 2**32): negative, 2**31 and above, and the edges.
SEEDS = [0, 1, 7, -1, -12345, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5,
         2 ** 32 - 1, 2746413216]
POSITIONS = [0, 1, 17, 4095, 2 ** 31 - 1]
VOCABS = [16, 1000, 128256]
# Upper 0.001 quantiles of chi-square by degrees of freedom.
CHI2_999 = {4: 18.467, 5: 20.515, 6: 22.458, 7: 24.322}


def _int32(seed: int) -> int:
    s = seed & 0xFFFFFFFF
    return s - (1 << 32) if s >= 1 << 31 else s


def _key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


# ---------------------------------------------------------------------
# prng
# ---------------------------------------------------------------------


def test_partitionable_threefry_is_what_the_port_reproduces():
    """The port carries JAX's partitionable threefry path; an upgrade
    that flips the flag shows up here by name, not as drifting
    tokens."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.__version__.split('.')[:2] == ['0', '9'], jax.__version__


@pytest.mark.parametrize('seed', SEEDS)
def test_row_key_is_bit_equal(seed):
    for pos in POSITIONS:
        want = np.asarray(jprng.row_key(jnp.int32(_int32(seed)),
                                        jnp.int32(pos)))
        assert (tprng.row_key(_int32(seed), pos).numpy() ==
                want.astype(np.int64)).all(), (seed, pos)
        # Any int congruent mod 2**32 names the same key.
        assert torch.equal(tprng.row_key(seed, pos),
                           tprng.row_key(_int32(seed), pos))


def test_row_keys_vectorized_is_bit_equal():
    rng = np.random.default_rng(0)
    seeds = np.asarray([_int32(s) for s in SEEDS] +
                       list(rng.integers(-2 ** 31, 2 ** 31, 54)),
                       np.int32)
    pos = rng.integers(0, 2 ** 31, seeds.shape[0]).astype(np.int32)
    want = np.asarray(jprng.row_keys(jnp.asarray(seeds),
                                     jnp.asarray(pos)))
    got = tprng.row_keys(torch.from_numpy(seeds), torch.from_numpy(pos))
    assert got.shape == (64, 2)
    assert (got.numpy() == want.astype(np.int64)).all()


@pytest.mark.parametrize('data', [0, 1, 77, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_and_split_are_bit_equal(data):
    key = jax.random.PRNGKey(42)
    assert (tprng.fold_in(_key(key), data).numpy() ==
            np.asarray(jax.random.fold_in(key, np.uint32(data)))
            .astype(np.int64)).all()
    sub = jax.random.fold_in(key, np.uint32(data))
    for num in (2, 3):
        assert (tprng.split(_key(sub), num).numpy() ==
                np.asarray(jax.random.split(sub, num))
                .astype(np.int64)).all()


def test_seed_key_is_prngkey():
    for s in (0, 5, 2 ** 31, 2 ** 32 - 1):
        assert (tprng.seed_key(s).numpy() ==
                np.asarray(jax.random.PRNGKey(np.uint32(s)))
                .astype(np.int64)).all()


@pytest.mark.parametrize('v', VOCABS)
def test_random_bits_and_uniform_are_bit_equal(v):
    for seed, pos in ((3, 0), (-1, 9), (2 ** 31 + 1, 4096)):
        jk = jprng.row_key(jnp.int32(_int32(seed)), jnp.int32(pos))
        tk = tprng.row_key(seed, pos)
        want = np.asarray(jax.random.bits(jk, (v,), jnp.uint32))
        assert (tprng.random_bits(tk, (v,)).numpy() ==
                want.astype(np.int64)).all()
        ju = np.asarray(jax.random.uniform(jk, (v,)))
        np.testing.assert_array_equal(tprng.uniform(tk, (v,)).numpy(), ju)
        lo = np.finfo(np.float32).tiny
        ju = np.asarray(jax.random.uniform(jk, (v,), minval=lo, maxval=1.0))
        np.testing.assert_array_equal(
            tprng.uniform(tk, (v,), lo, 1.0).numpy(), ju)


def test_random_bits_over_a_2d_shape_and_a_batch_of_keys():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.bits(key, (3, 1000), jnp.uint32))
    assert (tprng.random_bits(_key(key), (3, 1000)).numpy() ==
            want.astype(np.int64)).all()
    keys = jax.random.split(key, 4)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (100,), jnp.uint32))(keys))
    assert (tprng.random_bits(_key(keys), (100,)).numpy() ==
            want.astype(np.int64)).all()


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) -
                  b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize('v', VOCABS)
def test_gumbel_within_one_ulp(v):
    jk = jax.random.PRNGKey(11)
    tk = _key(jk)
    want = np.asarray(jax.random.gumbel(jk, (v,)))
    got = tprng.gumbel(tk, (v,)).numpy()
    # The inner log's one ulp (at most 2**-23 of y relative) moves
    # -log(y) by at most 2**-22 absolute; the outer log adds its own ulp.
    tol = 2.0 ** -22 + np.spacing(np.abs(want))
    assert (np.abs(got - want) <= tol).all()
    # Stage by stage on the same inputs: each log within 1 ulp.
    u = tprng.uniform(tk, (v,), np.finfo(np.float32).tiny, 1.0)
    inner_t = -torch.log(u)
    inner_j = np.asarray(-jnp.log(jnp.asarray(u.numpy())))
    assert _ulps(inner_t.numpy(), inner_j).max() <= 1
    outer_j = np.asarray(-jnp.log(jnp.asarray(inner_j)))
    outer_t = (-torch.log(torch.from_numpy(inner_j.copy()))).numpy()
    assert _ulps(outer_t, outer_j).max() <= 1


@pytest.mark.parametrize('shape', [(8,), (3, 50)])
def test_categorical_matches(shape):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=shape).astype(np.float32)
    for s in range(20):
        key = jax.random.PRNGKey(s)
        want = int(np.asarray(jax.random.categorical(
            key, jnp.asarray(logits), axis=-1)).ravel()[0])
        got = int(tprng.categorical(_key(key),
                                    torch.from_numpy(logits)).ravel()[0])
        assert got == want, s


# ---------------------------------------------------------------------
# sample
# ---------------------------------------------------------------------


def _knobs(b, rng):
    temps = rng.choice([0.0, 0.3, 0.7, 1.0, 1.5], b).astype(np.float32)
    tops = rng.choice([1.0, 0.95, 0.9, 0.5, 0.05], b).astype(np.float32)
    seeds = np.asarray([_int32(s) for s in rng.choice(SEEDS, b)], np.int32)
    pos = rng.integers(0, 5000, b).astype(np.int32)
    return temps, tops, seeds, pos


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize('v', VOCABS)
@pytest.mark.parametrize('masked', [False, True])
def test_sample_rows_matches(v, masked):
    rng = np.random.default_rng(v + masked)
    b = 16
    logits = (rng.normal(size=(b, v)) *
              rng.choice([0.5, 2.0, 8.0], (b, 1))).astype(np.float32)
    knobs = _knobs(b, rng)
    allowed = None
    if masked:
        allowed = rng.random((b, v)) < 0.3
        allowed[:, 0] = True
    want = np.asarray(jsample.sample_rows(
        *_j(logits, *knobs), None if allowed is None
        else jnp.asarray(allowed)))
    got = tsample.sample_rows(
        *_t(logits, *knobs), None if allowed is None
        else torch.from_numpy(allowed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if masked:
        assert allowed[np.arange(b), got.numpy()].all()


def test_temperature_zero_is_the_argmax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 300)).astype(np.float32)
    got = tsample.sample_rows(
        *_t(logits, np.zeros(6, np.float32), np.full(6, 0.3, np.float32),
            np.arange(6, dtype=np.int32), np.arange(6, dtype=np.int32)))
    assert torch.equal(got.long(), torch.from_numpy(logits).argmax(-1))


def test_row_is_invariant_to_batch_composition():
    rng = np.random.default_rng(4)
    mine = rng.normal(size=(1, 64)).astype(np.float32)
    args = (np.float32([0.9]), np.float32([0.95]), np.int32([42]),
            np.int32([13]))
    solo = tsample.sample_rows(*_t(mine, *args))
    for width in (4, 16):
        others = rng.normal(size=(width - 1, 64)).astype(np.float32)
        knobs = _knobs(width - 1, rng)
        batch = tsample.sample_rows(*_t(
            np.concatenate([mine, others]),
            *[np.concatenate([a, k]) for a, k in zip(args, knobs)]))
        assert int(batch[0]) == int(solo[0])


@pytest.mark.parametrize('seed', [5, -3, 2 ** 31 + 9])
@pytest.mark.parametrize('masked', [False, True])
def test_sample_first_matches(seed, masked):
    rng = np.random.default_rng(abs(seed) % 1000)
    logits = rng.normal(size=(1, 1000)).astype(np.float32)
    allowed = (rng.random(1000) < 0.2) if masked else None
    for temp, top, pos in ((0.8, 0.9, 31), (1.0, 1.0, 0), (0.0, 1.0, 7)):
        want = int(jsample.sample_first(
            jnp.asarray(logits), jnp.float32(temp), jnp.float32(top),
            jnp.int32(_int32(seed)), jnp.int32(pos),
            None if allowed is None else jnp.asarray(allowed)))
        got = tsample.sample_first(
            torch.from_numpy(logits), temp, top, _int32(seed), pos,
            None if allowed is None else torch.from_numpy(allowed))
        assert int(got) == want
        # The prompt/decode boundary is invisible: the same draw as
        # sample_rows at that position.
        again = tsample.sample_rows(*_t(
            logits, np.float32([temp]), np.float32([top]),
            np.int32([_int32(seed)]), np.int32([pos])),
            None if allowed is None else torch.from_numpy(allowed[None]))
        assert int(again[0]) == want


@pytest.mark.parametrize('v', [16, 1000])
@pytest.mark.parametrize('masked', [False, True])
def test_verify_targets_matches(v, masked):
    rng = np.random.default_rng(7 + v + masked)
    b, w = 5, 9
    logits = (2 * rng.normal(size=(b, w, v))).astype(np.float32)
    temps, tops, seeds, pos = _knobs(b, rng)
    allowed = None
    if masked:
        allowed = rng.random((b, w, v)) < 0.4
        allowed[..., 1] = True
    want = np.asarray(jsample.verify_targets(
        *_j(logits, temps, tops, seeds, pos),
        None if allowed is None else jnp.asarray(allowed)))
    got = tsample.verify_targets(
        *_t(logits, temps, tops, seeds, pos),
        None if allowed is None else torch.from_numpy(allowed))
    np.testing.assert_array_equal(got.numpy(), want)
    # Column j draws as plain decode at pos + j.
    for j in range(w):
        plain = tsample.sample_rows(
            *_t(logits[:, j], temps, tops, seeds, pos + j),
            None if allowed is None else torch.from_numpy(allowed[:, j]))
        assert torch.equal(plain, got[:, j])


def test_gather_masks_matches():
    rng = np.random.default_rng(8)
    for shape in ((5, 40), (5, 3, 40)):
        table = rng.random(shape) < 0.5
        idx = rng.integers(0, 5, 7).astype(np.int32)
        want = np.asarray(jsample.gather_masks(jnp.asarray(table),
                                               jnp.asarray(idx)))
        got = tsample.gather_masks(*_t(table, idx))
        np.testing.assert_array_equal(got.numpy(), want)


def _chisq(counts, probs):
    exp = probs * counts.sum()
    return float(((counts - exp) ** 2 / exp).sum())


@pytest.mark.parametrize('temp,top_p', [(1.0, 1.0), (0.7, 1.0),
                                        (1.0, 0.9)])
def test_chi_square_of_keyed_draws(temp, top_p):
    """4096 keyed draws (one request's positions) against softmax of
    the filtered logits; the statistic is deterministic for fixed
    seeds, so the 0.999 quantile is a stable line."""
    probs = np.asarray([0.3, 0.22, 0.16, 0.12, 0.08, 0.06, 0.04, 0.02])
    logits = np.log(probs).astype(np.float32)
    n = 4096
    toks = tsample.sample_rows(*_t(
        np.tile(logits, (n, 1)), np.full(n, temp, np.float32),
        np.full(n, top_p, np.float32), np.full(n, 17, np.int32),
        np.arange(n, dtype=np.int32))).numpy()
    p = np.exp(logits / temp)
    p /= p.sum()
    keep = np.cumsum(p) - p < top_p
    p = np.where(keep, p, 0.0)
    p /= p.sum()
    assert set(np.unique(toks)) <= set(np.flatnonzero(keep))
    counts = np.bincount(toks, minlength=8)[keep].astype(float)
    df = int(keep.sum()) - 1
    assert _chisq(counts, p[keep]) < CHI2_999[df]


def test_package_exports_match_the_jax_package():
    from skypilot_tpu.serve import sampling as jsampling
    assert sorted(tsampling.__all__) == sorted(jsampling.__all__)


# ---------------------------------------------------------------------
# grammar
# ---------------------------------------------------------------------


def _walk_both(pattern_or_rf, vocab, eos, tokens):
    """Compile on both sides and compare masks and states along a walk
    of ``tokens`` (states compared by the masks and acceptance they
    give)."""
    rf = pattern_or_rf if isinstance(pattern_or_rf, dict) else \
        {'type': 'regex', 'pattern': pattern_or_rf}
    jg = jgrammar.compile_grammar(rf, vocab, eos)
    tg = tgrammar.compile_grammar(rf, vocab, eos)
    js, ts = jg.start, tg.start
    assert ts == js
    for tok in [None] + list(tokens):
        if tok is not None:
            js, ts = jg.advance(js, tok), tg.advance(ts, tok)
            assert ts == js
        np.testing.assert_array_equal(tg.allowed(ts), jg.allowed(js))
        assert tg.is_accepting(ts) == jg.is_accepting(js)


GRAMMAR_CASES = [
    # TestGrammarUnit's cases and three JSON ones: (response_format or
    # regex, vocab, eos id, a walk of token texts; 'EOS' is eos).
    ('a+b', [None, 'a', 'b', None], 3, ['a', 'b', 'EOS']),
    ('a+b', [None, 'a', 'b', None], 3, ['a', 'b', 'a']),
    ('true|false', [None, 'true', 'false', 'tr', None], 4, ['tr']),
    ('true|false', [None, 'true', 'false', 'tr', None], 4,
     ['true', 'EOS']),
    ('a+', [None, 'a', None], 2, ['a', 'a', 'EOS']),
    ({'type': 'json_schema',
      'schema': {'type': 'object',
                 'properties': {'a': {'type': 'boolean'}}}},
     [None] + list('{}[],:."ab') + ['true', 'false', 'null', None], 14,
     ['{', '"', 'a', '"', ':', 'true', '}', 'EOS']),
    ({'type': 'json_schema',
      'schema': {'type': 'array', 'items': {'type': 'integer'},
                 'minItems': 1, 'maxItems': 3}},
     [None] + list('0123456789[],-') + ['12', '[1', None], 17,
     ['[1', ',', '12', ']', 'EOS']),
    (r'\{"a":[0-9]{1,4}\}',
     [None] + list('0123456789{}":a') + ['{"', '12', None], 18,
     ['{"', 'a', '"', ':', '12', '}', 'EOS']),
]


@pytest.mark.parametrize('case', range(len(GRAMMAR_CASES)))
def test_grammar_masks_and_walks_match(case):
    rf, vocab, eos, walk = GRAMMAR_CASES[case]
    _walk_both(rf, vocab, eos, [eos if t == 'EOS' else vocab.index(t)
                                for t in walk])


def test_schema_to_regex_matches():
    for schema in ({'type': 'boolean'}, {'const': 'hi'},
                   {'type': 'array', 'items': {'type': 'boolean'},
                    'minItems': 1, 'maxItems': 2},
                   {'type': 'object', 'properties': {
                       'n': {'type': 'integer'}, 's': {'type': 'string'},
                       'e': {'enum': ['x', 1, None]}}},
                   {'type': 'number'}, {'type': 'null'}):
        assert tgrammar.schema_to_regex(schema) == \
            jgrammar.schema_to_regex(schema)


@pytest.mark.parametrize('rf', [
    {'type': 'xml'}, {'type': 'regex', 'pattern': ''},
    {'type': 'json_schema', 'schema': 'nope'}, 'nope',
    {'type': 'json_schema', 'schema': {'type': 'array', 'minItems': -1,
                                       'items': {'type': 'integer'}}},
])
def test_grammar_errors_are_typed_on_both_sides(rf):
    vocab = [None, 'a', None]
    with pytest.raises(jgrammar.GrammarError):
        jgrammar.compile_grammar(rf, vocab, 2)
    with pytest.raises(tgrammar.GrammarError):
        tgrammar.compile_grammar(rf, vocab, 2)


def test_grammar_hash_and_cache():
    a = {'type': 'json_schema', 'schema': {'type': 'integer'}}
    b = {'schema': {'type': 'integer'}, 'type': 'json_schema'}
    assert tgrammar.grammar_hash(a) == tgrammar.grammar_hash(b) == \
        jgrammar.grammar_hash(a)
    vocab = [None, 'a', None]
    rf = {'type': 'regex', 'pattern': 'a+'}
    assert tgrammar.compile_grammar(rf, vocab, 2) is \
        tgrammar.compile_grammar(rf, vocab, 2)


def test_grammar_over_a_random_vocab_matches():
    """A 2000-entry vocab of random strings over the JSON lexicon: every
    mask along a random legal walk agrees."""
    rng = np.random.default_rng(12)
    alphabet = list('0123456789{}[],:."abtrufense-')
    vocab = [None] + [''.join(rng.choice(alphabet, int(rng.integers(1, 4))))
                      for _ in range(1998)] + [None]
    eos = 1999
    rf = {'type': 'json_schema', 'schema': {
        'type': 'object', 'properties': {
            'ok': {'type': 'boolean'},
            'xs': {'type': 'array', 'items': {'type': 'integer'},
                   'maxItems': 3}}}}
    jg = jgrammar.compile_grammar(rf, vocab, eos)
    tg = tgrammar.compile_grammar(rf, vocab, eos)
    st = tg.start
    for _ in range(12):
        mask = tg.allowed(st)
        np.testing.assert_array_equal(mask, jg.allowed(st))
        tok = int(rng.choice(np.flatnonzero(mask)))
        if tok == eos:
            break
        nxt = tg.advance(st, tok)
        assert nxt == jg.advance(st, tok)
        st = nxt


# ---------------------------------------------------------------------
# models/decode sampling
# ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def tiny():
    jcfg = jllama.get_config('tiny', dtype=jnp.float32)
    tcfg = tllama.get_config('tiny', dtype=torch.float32)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg, device='cpu'))


@pytest.mark.parametrize('kw', [
    dict(temperature=0.8), dict(temperature=1.0, top_p=0.9),
    dict(temperature=0.7, top_k=20), dict(temperature=1.2, top_k=50,
                                          top_p=0.8),
    dict(temperature=0.0)])
def test_sample_generate_matches(tiny, kw):
    jcfg, tcfg, jp, tp = tiny
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jdecode.sample_generate(
        jp, jnp.asarray(prompt), jcfg, 10, key, max_seq=64, **kw))
    got = tdecode.sample_generate(tp, torch.from_numpy(prompt).long(),
                                  tcfg, 10, _key(key), max_seq=64, **kw)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_filters_match():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(4, 300)).astype(np.float32)
    logits[:, 5] = logits[:, 7]          # a tie at the cut
    for k in (1, 7, 299):
        np.testing.assert_array_equal(
            tdecode._filter_top_k(torch.from_numpy(logits), k).numpy(),
            np.asarray(jdecode._filter_top_k(jnp.asarray(logits), k)))
    for p in (0.05, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            tdecode._filter_top_p(torch.from_numpy(logits), p).numpy(),
            np.asarray(jdecode._filter_top_p(jnp.asarray(logits), p)))


def test_sample_token_keeps_the_key_split_order(tiny):
    """One step of the scan by hand: split, then categorical on the
    sub-key over [B, V] (a single key for the batch)."""
    jcfg, _, _, _ = tiny
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, jcfg.vocab_size)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    _, sub = jax.random.split(key)
    want = np.asarray(jdecode.sample_token(jnp.asarray(logits), sub,
                                           jnp.float32(0.9)))
    _, tsub = tprng.split(_key(key))
    got = tdecode.sample_token(torch.from_numpy(logits), tsub, 0.9)
    np.testing.assert_array_equal(got.numpy(), want)
