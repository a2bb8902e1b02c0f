"""The port's continuous-batching engine (skypilot_torch/serve/batching.py
BatchingEngine) on the CPU at ``tiny`` in f32: its greedy outputs must
equal the port's single-stream ``greedy_generate`` token for token —
with requests outnumbering slots, eos retirement, chunked prefill,
prefix-cache hits, a copy-on-write divergence, preemption and live
speculative verifies — and, in one test, the JAX ``BatchingEngine`` on
the same weights. Knobs of features not ported yet raise."""
import dataclasses

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
    (dict(grammar_vocab=['a'] * 512), 'sampling slice'),
])
def test_deferred_engine_knobs_raise(setup, kw, slice_name):
    config, params = setup
    with pytest.raises(NotImplementedError, match=slice_name):
        BatchingEngine(params, config, **kw)


@pytest.mark.parametrize('kw,slice_name', [
    (dict(temperature=0.7), 'sampling slice'),
    (dict(top_p=0.9), 'sampling slice'),
    (dict(seed=3), 'sampling slice'),
    (dict(response_format={'type': 'regex', 'pattern': 'a'}),
     'sampling slice'),
    (dict(adapter='tenant-a'), 'multi-LoRA slice'),
    (dict(tenant='a'), 'overload slice'),
    (dict(priority='batch'), 'overload slice'),
    (dict(deadline=1e12), 'overload slice'),
])
def test_deferred_request_knobs_raise(setup, kw, slice_name):
    config, params = setup
    engine = _engine(params, config)
    try:
        with pytest.raises(NotImplementedError, match=slice_name):
            engine.submit([1, 2, 3], 4, **kw)
    finally:
        engine.close()
