"""The port's continuous-batching engine (skypilot_torch/serve/batching.py
BatchingEngine) on the CPU at ``tiny`` in f32: its greedy outputs must
equal the port's single-stream ``greedy_generate`` token for token —
with requests outnumbering slots, eos retirement, chunked prefill,
prefix-cache hits, a copy-on-write divergence, preemption and live
speculative verifies — and the JAX ``BatchingEngine`` on the same
weights. Sampled and grammar-constrained requests must give the JAX
engine's tokens, and the sampling contract is held directly: a
request's tokens are the same alone and beside neighbours, with
speculation on and off, and across a preempt-resume (each request
against its own solo run). The overload and multi-LoRA knobs are taken
(their behavior is held in test_torch_overload.py and
test_torch_adapters.py)."""
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import batching as jbatching
from skypilot_torch import exceptions
from skypilot_torch.models import convert, decode, llama
from skypilot_torch.serve.batching import BatchingEngine
from skypilot_torch.serve.sampling import GrammarError


@pytest.fixture(scope='module')
def setup():
    config = llama.get_config('tiny', dtype=torch.float32)
    return config, llama.init_params(config, seed=0, device='cpu')


@pytest.fixture(scope='module')
def loopy_setup():
    """A vocab-restricted tiny config: greedy decode enters repetition
    loops quickly, where n-gram drafting fires and accepts."""
    config = dataclasses.replace(llama.get_config('tiny',
                                                  dtype=torch.float32),
                                 vocab_size=16)
    return config, llama.init_params(config, seed=0, device='cpu')


def _reference(params, config, prompt, max_new, max_seq=64, eos_id=None):
    out = decode.greedy_generate(params, torch.tensor([prompt]), config,
                                 max_new, max_seq=max_seq, eos_id=eos_id)
    toks = out[0].tolist()
    if eos_id is not None and eos_id in toks:
        toks = toks[:toks.index(eos_id) + 1]
    return toks


def _drain(q, timeout=60):
    toks = []
    while True:
        t = q.get(timeout=timeout)
        if t is None:
            return toks
        assert not isinstance(t, BaseException), t
        toks.append(t)


def _engine(params, config, **kw):
    kw = dict(dict(slots=2, max_seq=64, steps_per_dispatch=3,
                   block_size=8, prefill_chunk=8,
                   max_num_batched_tokens=16), **kw)
    return BatchingEngine(params, config, **kw)


def test_more_requests_than_slots_and_chunked_prefill(setup):
    config, params = setup
    rng = np.random.default_rng(0)
    cases = [([int(t) for t in rng.integers(1, 500, n)], m)
             for n, m in ((5, 6), (21, 9), (3, 4), (13, 7), (30, 5))]
    engine = _engine(params, config)
    try:
        qs = [engine.submit(p, m) for p, m in cases]
        for (p, m), q in zip(cases, qs):
            assert _drain(q) == _reference(params, config, p, m)
        kinds = [e[0] for e in engine.events]
        # Chunked prefill: the 21- and 30-token prompts take 3-4 chunks
        # of 8 under a 16-token budget, with decode dispatches between.
        first_chunk = kinds.index('prefill_chunk')
        assert 'decode' in kinds[first_chunk:]
        assert kinds.count('admit') == len(cases)
    finally:
        engine.close()
    assert not engine.thread.is_alive()
    assert engine.pool.free_blocks == engine.pool.usable_blocks


def test_eos_retires_the_row(setup):
    config, params = setup
    prompt = [7, 3, 5, 11, 2]
    full = _reference(params, config, prompt, 10)
    eos = full[3]
    engine = _engine(params, config)
    try:
        got = engine.generate(prompt, 10, eos_id=eos)
        assert got == _reference(params, config, prompt, 10, eos_id=eos)
        assert got[-1] == eos and len(got) <= 4
    finally:
        engine.close()


def test_matches_the_jax_engine():
    """Same weights, same requests: the port's engine and the JAX
    package's give the same tokens."""
    jcfg = jllama.get_config('tiny', dtype=jnp.float32)
    tcfg = llama.get_config('tiny', dtype=torch.float32)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(tree, tcfg, device='cpu')
    shared = [(i * 7) % 250 + 1 for i in range(17)]
    cases = [(shared + [3, 9], 8), ([5, 4, 3], 6), (shared + [1], 7)]
    kw = dict(slots=2, max_seq=64, steps_per_dispatch=3, block_size=8,
              prefill_chunk=8, max_num_batched_tokens=16)
    jeng = jbatching.BatchingEngine(jax.tree.map(jnp.asarray, tree), jcfg,
                                    **kw)
    teng = BatchingEngine(tp, tcfg, **kw)
    try:
        jq = [jeng.submit(p, m) for p, m in cases]
        tq = [teng.submit(p, m) for p, m in cases]
        want = [_drain(q) for q in jq]
        got = [_drain(q) for q in tq]
    finally:
        jeng.close()
        teng.close()
    assert got == want


def test_prefix_hit_and_copy_on_write_stay_exact(setup):
    config, params = setup
    engine = _engine(params, config)
    try:
        base = [(i * 7) % 250 + 1 for i in range(24)]
        want = _reference(params, config, base, 8)
        assert engine.generate(base, 8) == want
        req = engine.submit_request(base, 8)
        assert _drain(req.out) == want
        # Two full prompt blocks reused (COW may extend it, capped at
        # t0 - 1 so the last token always recomputes).
        assert req.prefix_hit_blocks == 2 and req.prefix_miss_blocks == 1
        # Shares 2 full blocks + 4 tokens of block 2, then diverges:
        # COW copies the cached block and recomputes from there.
        fork = base[:20] + [99, 98, 97, 96]
        assert engine.generate(fork, 8) == _reference(params, config,
                                                      fork, 8)
        admits = [e for e in engine.events if e[0] == 'admit']
        assert admits[0][2] == 0
        assert 16 <= admits[1][2] <= 23
        assert admits[-1][2] == 20       # 16 full-block + 4 via COW
    finally:
        engine.close()
    assert engine.pool.free_blocks == engine.pool.usable_blocks


def test_preemption_stays_exact_without_leaks(setup):
    """6 usable blocks of 8 cannot hold three requests that grow to 25
    tokens (4 blocks) each: the engine preempts and requeues, and every
    output is still exact."""
    config, params = setup
    engine = _engine(params, config, slots=3, steps_per_dispatch=4,
                     num_blocks=7, prefill_chunk=512,
                     max_num_batched_tokens=2048)
    try:
        cases = [([1, 2, 3, 4, 5], 20), ([6, 7, 8, 9, 1], 20),
                 ([2, 4, 6, 8, 3], 20)]
        qs = [engine.submit(p, m) for p, m in cases]
        for (p, m), q in zip(cases, qs):
            assert _drain(q) == _reference(params, config, p, m)
        assert any(e[0] == 'preempt' for e in engine.events)
    finally:
        engine.close()
    assert engine.pool.free_blocks == engine.pool.usable_blocks


def test_prompt_larger_than_the_pool_fails_alone(setup):
    config, params = setup
    engine = _engine(params, config, num_blocks=3)
    try:
        with pytest.raises(exceptions.KVPoolExhaustedError):
            engine.generate(list(range(1, 30)), 4)
        assert engine.generate([1, 2, 3], 4) == _reference(
            params, config, [1, 2, 3], 4)
    finally:
        engine.close()


def test_speculation_on_equals_off_with_live_verifies(loopy_setup):
    config, params = loopy_setup
    rng = np.random.default_rng(3)
    cases = []
    for i in range(4):
        pat = [int(x) for x in rng.integers(1, config.vocab_size, size=5)]
        cases.append(((pat * 6)[:12 + i], int(rng.integers(12, 30))))

    def run(spec):
        eng = _engine(params, config, slots=3, max_seq=96,
                      steps_per_dispatch=4, prefill_chunk=16,
                      max_num_batched_tokens=64, speculative=spec,
                      draft_k=8)
        try:
            qs = [eng.submit(p, m) for p, m in cases]
            return [_drain(q) for q in qs], list(eng.events)
        finally:
            eng.close()

    (off, _), (on, events) = run(False), run(True)
    assert on == off
    for (prompt, m), toks in zip(cases, on):
        assert toks == _reference(params, config, prompt, m, max_seq=96)
    verifies = [e for e in events if e[0] == 'verify']
    assert verifies, 'no verify dispatch fired on a loop-heavy stream'
    assert any(e[3] > 0 for e in verifies), 'nothing accepted'


@pytest.mark.parametrize('kw,slice_name', [
    (dict(adapter_registry=object()), 'multi-LoRA slice'),
    (dict(max_queued_requests=4), 'overload slice'),
    (dict(max_queued_tokens=64), 'overload slice'),
    (dict(default_timeout_s=1.0), 'overload slice'),
    (dict(tenant_weights={'a': 2.0}), 'overload slice'),
    (dict(adapter_capacity=2), 'multi-LoRA slice'),
    (dict(adapter_preload=['a']), 'multi-LoRA slice'),
])
def test_deferred_engine_knobs_raise(setup, kw, slice_name):
    """The overload and multi-LoRA knobs, which raised until their slices
    were ported, are taken as the JAX engine takes them: the engine
    serves greedy tokens exactly; an adapter knob without both a
    registry and a capacity builds no adapter set, so an adapter request
    is refused typed (``AdapterCapacityError``) and nothing raises at
    construction."""
    config, params = setup
    engine = _engine(params, config, **kw)
    try:
        for name, value in kw.items():
            if name in ('max_queued_requests', 'max_queued_tokens',
                        'default_timeout_s'):
                assert getattr(engine, name) == value
        assert engine.tenant_weights == kw.get('tenant_weights', {})
        assert engine._adapters is None, slice_name
        assert engine.generate([1, 2, 3], 4) == _reference(
            params, config, [1, 2, 3], 4)
        q = engine.submit([1, 2, 3], 4, adapter='a')
        assert isinstance(q.get(timeout=30),
                          exceptions.AdapterCapacityError)
    finally:
        engine.close()


@pytest.mark.parametrize('kw,slice_name', [
    (dict(adapter='tenant-a'), 'multi-LoRA slice'),
    (dict(tenant='a'), 'overload slice'),
    (dict(priority='batch'), 'overload slice'),
    (dict(deadline=1e12), 'overload slice'),
])
def test_deferred_request_knobs_raise(setup, kw, slice_name):
    """The request knobs of the two slices, which raised until they were
    ported: ``tenant``, ``priority`` and a far ``deadline`` are served
    token-exact; an ``adapter`` on an engine without an adapter set is
    refused typed; a priority outside ``PRIORITIES`` raises."""
    config, params = setup
    engine = _engine(params, config)
    try:
        q = engine.submit([1, 2, 3], 4, **kw)
        if 'adapter' in kw:
            assert isinstance(q.get(timeout=30),
                              exceptions.AdapterCapacityError), slice_name
            assert q.get(timeout=30) is None
        else:
            assert _drain(q) == _reference(params, config, [1, 2, 3], 4)
        with pytest.raises(ValueError, match='priority'):
            engine.submit([1, 2, 3], 4, **dict(kw, priority='urgent'))
    finally:
        engine.close()


# ---------------------------------------------------------------------
# Sampled and grammar-constrained decoding
# ---------------------------------------------------------------------

# Vocab-16 grammar vocab for the loopy config: digits at 1..10, then
# '[' ']' ',' '-', EOS at 15 (tests/test_sampling.py's).
GV16 = ([None] + [str(d) for d in range(10)]
        + ['[', ']', ',', '-', None])
GV16_EOS = 15
LIST_RE = r'\[[0-9](,[0-9]){0,3}\]'
GV512_EOS = 40


def _grammar_vocab_512():
    """Token texts for the tiny (512) vocab: a JSON lexicon at ids 1..,
    everything else without text, EOS at 40."""
    gv = [None] * 512
    syms = list('0123456789{}[],:."ab') + ['true', 'false', 'null']
    for i, sym in enumerate(syms, start=1):
        gv[i] = sym
    return gv


def _text(gv, toks, eos):
    return ''.join(gv[t] or '' for t in toks if t != eos)


# (prompt, max_new, temperature, top_p, seed): a greedy rider, seeds of
# both signs and above 2**31.
SAMPLED = [([3, 1, 4, 1, 5, 9], 14, 0.8, 0.9, 11),
           ([2, 7, 1, 8, 2, 8], 14, 0.7, 0.8, -22),
           ([1, 6, 1, 8, 9, 3], 14, 1.0, 1.0, 2 ** 31 + 3),
           ([3, 1, 4, 1, 5, 9], 14, 0.0, 1.0, 0)]
LOOPY = [([1, 2, 3, 4] * 3, 20, 0.3, 0.9, 5),
         ([6, 7, 8, 6, 7, 8], 20, 0.3, 0.9, 6),
         ([1, 2, 3, 1, 2, 3], 20, 0.0, 1.0, 0)]


def _shared(vocab_size=None):
    """JAX and port params holding the same weights (JAX's init)."""
    kw = {} if vocab_size is None else dict(vocab_size=vocab_size)
    jcfg = dataclasses.replace(
        jllama.get_config('tiny', dtype=jnp.float32), **kw)
    tcfg = dataclasses.replace(
        llama.get_config('tiny', dtype=torch.float32), **kw)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg, device='cpu'))


@pytest.fixture(scope='module')
def shared_tiny():
    return _shared()


@pytest.fixture(scope='module')
def shared_loopy():
    return _shared(16)


def _run_cases(engine, cases, constrained=()):
    """Submit every case at once (then the constrained requests) and
    drain them all."""
    qs = [engine.submit(p, m, temperature=t, top_p=tp, seed=sd)
          for p, m, t, tp, sd in cases]
    qs += [engine.submit(p, m, temperature=t, seed=sd, response_format=rf,
                         eos_id=eos)
           for p, m, t, sd, rf, eos in constrained]
    return [_drain(q, timeout=120) for q in qs]


def _both_engines(shared, kw, cases, constrained=()):
    jcfg, tcfg, jp, tp = shared
    jeng = jbatching.BatchingEngine(jp, jcfg, **kw)
    teng = BatchingEngine(tp, tcfg, **kw)
    try:
        want = _run_cases(jeng, cases, constrained)
        got = _run_cases(teng, cases, constrained)
        return want, got, list(teng.events)
    finally:
        jeng.close()
        teng.close()


@pytest.mark.parametrize('speculative', [False, True])
def test_sampled_and_constrained_match_the_jax_engine(shared_tiny,
                                                      speculative):
    gv = _grammar_vocab_512()
    constrained = [([1, 2, 3], 24, 0.8, 3,
                    {'type': 'regex', 'pattern': r'\{"a":[0-9]{1,4}\}'},
                    GV512_EOS)]
    want, got, _ = _both_engines(
        shared_tiny, dict(slots=4, max_seq=64, draft_k=4,
                          speculative=speculative, grammar_vocab=gv),
        SAMPLED, constrained)
    assert got == want
    assert re.fullmatch(r'\{"a":[0-9]{1,4}\}',
                        _text(gv, got[-1], GV512_EOS))


def test_sampled_verify_matches_the_jax_engine(shared_loopy):
    """The loopy vocab drafts, so sampled verify dispatches run, with a
    constrained row whose drafts are cut by its grammar."""
    constrained = [([1, 2, 3], 12, 0.7, 9,
                    {'type': 'regex', 'pattern': LIST_RE}, GV16_EOS)]
    want, got, events = _both_engines(
        shared_loopy, dict(slots=4, max_seq=64, steps_per_dispatch=4,
                           draft_k=8, grammar_vocab=GV16),
        LOOPY, constrained)
    assert got == want
    assert any(e[0] == 'verify' and e[3] > 0 for e in events), events


def test_int8_engine_sampled_matches_the_jax_engine(shared_tiny):
    want, got, _ = _both_engines(
        shared_tiny, dict(slots=4, max_seq=64, draft_k=4, kv_int8=True),
        SAMPLED[:3])
    assert got == want


@pytest.fixture(scope='module')
def solo_sampled(setup):
    """Each SAMPLED case decoded alone (one row, no speculation)."""
    config, params = setup
    eng = BatchingEngine(params, config, slots=1, max_seq=64,
                         speculative=False)
    try:
        return [_run_cases(eng, [c])[0] for c in SAMPLED]
    finally:
        eng.close()


@pytest.mark.parametrize('slots,speculative', [(2, False), (4, True),
                                               (16, False), (16, True)])
def test_sampled_rows_are_batch_invariant(setup, solo_sampled, slots,
                                          speculative):
    config, params = setup
    eng = BatchingEngine(params, config, slots=slots, max_seq=64,
                         speculative=speculative, draft_k=4)
    try:
        assert _run_cases(eng, SAMPLED) == solo_sampled
    finally:
        eng.close()
    # Not vacuous: the greedy rider is greedy_generate's stream, and a
    # sampled stream on the same prompt differs from it.
    assert solo_sampled[3] == _reference(params, config, SAMPLED[3][0], 14)
    assert solo_sampled[0] != solo_sampled[3]


def test_sampled_spec_on_equals_spec_off(shared_loopy):
    _, config, _, params = shared_loopy
    constrained = [([1, 2, 3], 12, 0.7, 9,
                    {'type': 'regex', 'pattern': LIST_RE}, GV16_EOS)]

    def run(spec):
        eng = BatchingEngine(params, config, slots=4, max_seq=64,
                             steps_per_dispatch=4, speculative=spec,
                             draft_k=8, grammar_vocab=GV16)
        try:
            return _run_cases(eng, LOOPY, constrained), list(eng.events)
        finally:
            eng.close()

    (on, events), (off, _) = run(True), run(False)
    assert on == off
    assert any(e[0] == 'verify' and e[3] > 0 for e in events), events
    assert re.fullmatch(LIST_RE, _text(GV16, on[-1], GV16_EOS))


def test_sampled_preempt_resume_equals_the_solo_run(loopy_setup):
    """Pool pressure preempts mid-decode; every request, sampled and
    constrained, still equals its own run alone on a roomy engine."""
    config, params = loopy_setup
    cases = [([1, 2, 3, 4] * 3, 12, 0.6, 0.9, 5),
             ([6, 7, 8, 6, 7, 8], 12, 0.6, 0.9, 6),
             ([2, 4, 2, 4, 2], 12, 0.6, 0.9, 7)]
    constrained = [([1, 2, 3], 12, 0.7, 9,
                    {'type': 'regex', 'pattern': LIST_RE}, GV16_EOS)]
    kw = dict(slots=4, max_seq=64, steps_per_dispatch=4, block_size=8,
              draft_k=8, grammar_vocab=GV16)
    tight = BatchingEngine(params, config, num_blocks=7, **kw)
    try:
        got = _run_cases(tight, cases, constrained)
        events = list(tight.events)
    finally:
        tight.close()
    assert any(e[0] == 'preempt' for e in events), events
    solo = BatchingEngine(params, config, **dict(kw, slots=1))
    try:
        want = [_run_cases(solo, [c])[0] for c in cases]
        want += [_run_cases(solo, [], [c])[0] for c in constrained]
    finally:
        solo.close()
    assert got == want
    assert re.fullmatch(LIST_RE, _text(GV16, got[-1], GV16_EOS))
    assert tight.pool.free_blocks == tight.pool.usable_blocks


def test_grammar_outputs_full_match(setup):
    """A regex and a json_schema request beside a free sampled row
    (speculation on): a full match, and JSON that parses and fits its
    schema."""
    config, params = setup
    gv = _grammar_vocab_512()
    schema = {'type': 'object', 'properties': {'a': {'type': 'boolean'}}}
    eng = BatchingEngine(params, config, slots=3, max_seq=64,
                         grammar_vocab=gv)
    try:
        outs = _run_cases(eng, [([7, 8, 9], 12, 0.9, 1.0, 5)], [
            ([1, 2, 3], 24, 0.8, 3,
             {'type': 'regex', 'pattern': r'\{"a":[0-9]{1,4}\}'},
             GV512_EOS),
            ([4, 5, 6], 24, 0.9, 4,
             {'type': 'json_schema', 'schema': schema}, GV512_EOS)])
    finally:
        eng.close()
    assert re.fullmatch(r'\{"a":[0-9]{1,4}\}',
                        _text(gv, outs[1], GV512_EOS))
    assert outs[1][-1] == GV512_EOS and outs[2][-1] == GV512_EOS
    parsed = json.loads(_text(gv, outs[2], GV512_EOS))
    assert isinstance(parsed, dict) and isinstance(parsed.get('a'), bool)


@pytest.mark.parametrize('kw,field', [
    (dict(temperature=-0.5), 'temperature'),
    (dict(top_p=0.0), 'top_p'),
    (dict(top_p=1.5), 'top_p'),
    (dict(seed=True), 'seed'),
    (dict(seed=1.5), 'seed'),
])
def test_knob_errors_name_the_field(setup, kw, field):
    config, params = setup
    engine = _engine(params, config)
    try:
        with pytest.raises(ValueError, match=field):
            engine.submit([1, 2], 4, **kw)
    finally:
        engine.close()


@pytest.mark.parametrize('kw,needle', [
    (dict(response_format={'type': 'regex', 'pattern': 'a+'}), 'eos_id'),
    (dict(response_format={'type': 'xml'}, eos_id=GV512_EOS), 'type'),
    (dict(response_format={'type': 'json_schema', 'schema': 'nope'},
          eos_id=GV512_EOS), 'schema'),
])
def test_grammar_refusals_are_typed(setup, kw, needle):
    """A bad grammar fails that request with the GrammarError on its
    queue (the replica answers 400); the engine stays up."""
    config, params = setup
    engine = _engine(params, config, grammar_vocab=_grammar_vocab_512())
    try:
        req = engine.submit_request([1, 2], 4, temperature=0.5, **kw)
        item = req.out.get(timeout=60)
        assert isinstance(item, GrammarError), item
        assert needle in str(item)
        assert req.out.get(timeout=60) is None
        assert engine.generate([1, 2, 3], 4) == _reference(
            params, config, [1, 2, 3], 4)
    finally:
        engine.close()


def test_vocab_less_engine_refuses_response_format(setup):
    config, params = setup
    engine = _engine(params, config)
    try:
        req = engine.submit_request(
            [1, 2], 4, temperature=0.5,
            response_format={'type': 'regex', 'pattern': 'a'}, eos_id=1)
        item = req.out.get(timeout=60)
        assert isinstance(item, GrammarError) and \
            'grammar_vocab' in str(item)
        assert req.out.get(timeout=60) is None
    finally:
        engine.close()


def test_grammar_vocab_must_match_the_model_vocab(setup):
    config, params = setup
    with pytest.raises(ValueError, match='grammar_vocab'):
        BatchingEngine(params, config, grammar_vocab=['a'] * 511)


def test_huge_and_negative_seeds_never_kill_the_engine(setup):
    """Seeds count mod 2**32: congruent seeds are the same stream, and
    none of them may overflow inside the scheduler thread."""
    config, params = setup
    engine = _engine(params, config)

    def sample(seed):
        return engine.generate([1, 2, 3], 8, temperature=0.8, top_p=0.9,
                               seed=seed)
    try:
        assert len(sample(2746413216)) == 8
        assert sample(-1) == sample(2 ** 32 - 1)
        assert sample(2 ** 32 + 7) == sample(7)
    finally:
        engine.close()


@pytest.mark.parametrize('kw', [
    dict(temperature=0.5),
    dict(response_format={'type': 'regex', 'pattern': 'a'}, eos_id=1)])
def test_sampling_off_engine_refuses_sampled_work(setup, kw):
    config, params = setup
    engine = _engine(params, config, sampling=False)
    try:
        with pytest.raises(ValueError, match='sampling=False'):
            engine.submit([1, 2], 4, **kw)
        # top_p and seed alone leave a greedy request.
        assert engine.generate([1, 2, 3], 4, top_p=0.5, seed=3) == \
            _reference(params, config, [1, 2, 3], 4)
    finally:
        engine.close()
