"""The port's multi-LoRA serving (skypilot_torch/serve/adapters/,
models/decode.lora_gather_delta, the adapter path of forward_paged and
the device steps, the engine's adapter rows, the replica's ``adapter``
field) held to the JAX package on the CPU, on ``tiny`` with vocab 61 in
f32 and JAX's weights carried across as numpy:

- the gathered delta within rtol 1e-6 (atol 1e-6 of its scale) of JAX's
  on the same factors and slots, and exactly 0 on slot 0;
- adapter ``forward_paged`` logits within 1e-4 of JAX's, the decode and
  verify steps' tokens, ``pos`` and ``accepted`` equal;
- a mixed ``[a, base, b, b]`` engine batch token-equal to the JAX engine
  on the same weights and JAX-written adapter lineages; each row equal
  to its run alone, base rows equal to an adapterless engine, and an
  adapter request preempted and resumed equal to its solo run;
- the registry and resident-set cases of ``tests/test_adapters.py``;
- lineages written by the port read back through JAX's registry, and
  the reverse, with equal arrays and content hashes (bf16 leaves too);
- the replica's 404, 413 and ``X-Skytpu-Adapter-*`` headers.
"""
import dataclasses
import http.client
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.checkpoint.native import NativeCheckpointManager
from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import adapters as jadapters
from skypilot_tpu.serve import batching as jbatching
from skypilot_torch import checkpoint as tcheckpoint
from skypilot_torch import exceptions
from skypilot_torch.models import convert
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.recipes import serve_model
from skypilot_torch.serve import batching as tbatching
from skypilot_torch.serve import prefix_hash
from skypilot_torch.serve.adapters import (AdapterRegistry,
                                           ResidentAdapterSet)

VOCAB = 61
BS = 8
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE_KW = dict(slots=4, max_seq=96, steps_per_dispatch=3, block_size=8,
                 prefill_chunk=16, max_num_batched_tokens=128)
PROMPTS = [[7, 3, 9, 4] * 4, [5, 5, 2, 8] * 4, [1, 2, 3, 4] * 4]


@pytest.fixture(scope='module')
def models():
    jcfg = dataclasses.replace(jllama.get_config('tiny', dtype=jnp.float32),
                               vocab_size=VOCAB)
    tcfg = dataclasses.replace(tllama.get_config('tiny',
                                                 dtype=torch.float32),
                               vocab_size=VOCAB)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg, device='cpu'))


def _shapes(tcfg):
    return (tcfg.n_layers, tcfg.dim, tcfg.n_heads * tcfg.head_dim,
            tcfg.n_kv_heads * tcfg.head_dim)


def _factors(shapes, rank, seed, scale=0.05):
    num_layers, dim, q_out, v_out = shapes
    rng = np.random.default_rng(seed)
    out = {}
    for name, width in (('wq', q_out), ('wv', v_out)):
        out[f'{name}_a'] = rng.standard_normal(
            (num_layers, dim, rank)).astype(np.float32) * scale
        out[f'{name}_b'] = rng.standard_normal(
            (num_layers, rank, width)).astype(np.float32) * scale
    return out


def _write_jax(base_dir, adapter_id, shapes, rank=4, seed=0, step=1,
               dtype=np.float32):
    """A committed lineage holding a q/v LoRA subtree, written by the JAX
    package's checkpoint manager (the finetune recipe's artifact)."""
    factors = {k: jnp.asarray(v, dtype)
               for k, v in _factors(shapes, rank, seed).items()}
    mgr = NativeCheckpointManager(os.path.join(str(base_dir), adapter_id),
                                  process_index=0, process_count=1)
    mgr.save(step, {'lora': factors})
    mgr.wait()
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in
            factors.items()}


def _write_port(base_dir, adapter_id, shapes, rank=4, seed=0, step=1,
                dtype=torch.float32, scale=0.05):
    """The same lineage written by the port's checkpoint copies."""
    factors = {k: torch.from_numpy(v).to(dtype)
               for k, v in _factors(shapes, rank, seed, scale).items()}
    tcheckpoint.save_tree(os.path.join(str(base_dir), adapter_id), step,
                          {'lora': factors})
    return {k: v.float().numpy() for k, v in factors.items()}


def _drain(q, timeout=120):
    toks = []
    while True:
        t = q.get(timeout=timeout)
        if t is None:
            return toks
        assert not isinstance(t, BaseException), t
        toks.append(int(t))


@pytest.fixture(scope='module')
def tenants(models, tmp_path_factory):
    """JAX-written lineages (ranks 4 and 8, so a batch mixes ranks) and a
    registry of each package over the same directory."""
    _, tcfg, _, _ = models
    base = tmp_path_factory.mktemp('adapters')
    _write_jax(base, 'tenant-a', _shapes(tcfg), rank=4, seed=1)
    _write_jax(base, 'tenant-b', _shapes(tcfg), rank=8, seed=2)
    return (jadapters.AdapterRegistry(base_dir=str(base)),
            AdapterRegistry(base_dir=str(base)), str(base))


def _engine(params, config, registry, capacity=4, preload=None, **kw):
    return tbatching.BatchingEngine(
        params, config, adapter_registry=registry,
        adapter_capacity=capacity, adapter_preload=preload,
        **dict(ENGINE_KW, **kw))


def _solo(params, config, registry, prompt, adapter, max_new, **kw):
    engine = _engine(params, config, registry,
                     preload=[adapter] if adapter else None, **kw)
    try:
        return _drain(engine.submit(prompt, max_new, adapter=adapter))
    finally:
        engine.close()


# ---------------------------------------------------------------------
# The gathered delta and the device steps against JAX
# ---------------------------------------------------------------------


def test_lora_gather_delta_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 64, 16)).astype(np.float32)
    b = rng.standard_normal((3, 16, 48)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    h = rng.standard_normal((4, 3, 64)).astype(np.float32)
    idx = np.asarray([2, 0, 1, 1], np.int32)
    want = np.asarray(jdecode.lora_gather_delta(
        jnp.asarray(h), jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx)))
    got = tdecode.lora_gather_delta(torch.from_numpy(h), torch.from_numpy(a),
                                    torch.from_numpy(b),
                                    torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # Slot 0: a delta of exactly 0, whatever h holds.
    assert not got[1].any()


@pytest.mark.parametrize('d', [64, 300])
def test_lora_delta_phases_match_jax_einsums(d):
    """The CUDA kernel's two phases in their plain versions: ``h @ A``
    over d-chunks added in order (d 300: a ragged last chunk) against
    JAX's first einsum, then ``mid @ B`` against its second, and the two
    chained against JAX's delta; slot 0's rows exactly 0 in each."""
    from skypilot_torch.ops import matmul_invariant as tmi
    rng = np.random.default_rng(d)
    a = rng.standard_normal((3, d, 16)).astype(np.float32)
    b = rng.standard_normal((3, 16, 40)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    h = rng.standard_normal((4, 5, d)).astype(np.float32)
    idx = np.asarray([1, 0, 2, 1], np.int32)
    ja, jb = jnp.asarray(a)[idx], jnp.asarray(b)[idx]
    want_mid = np.asarray(jnp.einsum('btd,bdr->btr', jnp.asarray(h), ja))
    tidx = torch.from_numpy(idx)
    mid = tmi._lora_mid_plain(torch.from_numpy(h), torch.from_numpy(a),
                              tidx)
    np.testing.assert_allclose(mid.numpy(), want_mid, rtol=1e-5,
                               atol=1e-5 * np.abs(want_mid).max())
    want_out = np.asarray(jnp.einsum('btr,bro->bto', jnp.asarray(mid.numpy()),
                                     jb))
    out = tmi._lora_out_plain(mid, torch.from_numpy(b), tidx)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-6,
                               atol=1e-6 * np.abs(want_out).max())
    want = np.asarray(jdecode.lora_gather_delta(
        jnp.asarray(h), jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert not mid[1].any() and not out[1].any()


def _resident_pair(models, tenants):
    """The JAX and port resident sets over the same lineages, both
    adapters preloaded (same slots: claimed in the same order)."""
    _, tcfg, _, _ = models
    jreg, treg, _ = tenants
    shapes = _shapes(tcfg)
    jrs = jadapters.ResidentAdapterSet(jreg, 2, shapes, rank_bucket=16)
    trs = ResidentAdapterSet(treg, 2, shapes, rank_bucket=16,
                             device='cpu')
    for rs in (jrs, trs):
        rs.preload(['tenant-a', 'tenant-b'])
    assert [jrs.slot(a) for a in ('tenant-a', 'tenant-b')] == \
        [trs.slot(a) for a in ('tenant-a', 'tenant-b')] == [1, 2]
    for name, buf in trs.buffers().items():
        np.testing.assert_array_equal(buf.numpy(),
                                      np.asarray(jrs.buffers()[name]))
    return jrs.buffers(), trs.buffers()


def _t(x):
    return torch.from_numpy(np.array(x))


def test_forward_paged_with_adapters_matches_jax(models, tenants):
    """Chunked prefill under each adapter (and slot 0), logits and pool
    rows against JAX's forward_paged with the same stacked factors."""
    jcfg, tcfg, jp, tp = models
    jbuf, tbuf = _resident_pair(models, tenants)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, VOCAB, 20).astype(np.int32)
    shape = (jcfg.n_layers, 6, BS, jcfg.n_kv_heads, jcfg.head_dim)
    row = np.asarray([3, 1, 5, 0], np.int32)
    for slot in (1, 2, 0):
        jc = tuple(jnp.zeros(shape, jnp.float32) for _ in range(2)) + \
            (None, None)
        tc = tuple(torch.zeros(shape) for _ in range(2)) + (None, None)
        for start in (0, 8, 16):
            real = min(8, len(prompt) - start)
            chunk = np.zeros((1, 8), np.int32)
            chunk[0, :real] = prompt[start:start + real]
            jl, jc = jdecode.forward_paged(
                jp, jnp.asarray(chunk), jc, jnp.asarray(row),
                jnp.asarray(start), jnp.asarray(real), jcfg, BS, jbuf,
                jnp.asarray([slot], jnp.int32))
            tl, tc = tdecode.forward_paged(
                tp, _t(chunk).long(), tc, _t(row), start, real, tcfg, BS,
                adapters=tbuf, adapter_idx=_t([slot]))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
        for got, exp in zip(tc[:2], jc[:2]):
            np.testing.assert_allclose(got.numpy()[:, 1:],
                                       np.asarray(exp)[:, 1:], rtol=1e-5,
                                       atol=1e-5)
    # Each adapter changes the logits (so the equalities above are not
    # those of the base model alone).
    base, _ = tdecode.forward_paged(
        tp, _t(chunk).long(), tc, _t(row), 16, real, tcfg, BS)
    ad, _ = tdecode.forward_paged(
        tp, _t(chunk).long(), tc, _t(row), 16, real, tcfg, BS,
        adapters=tbuf, adapter_idx=_t([1]))
    assert (base - ad).abs().max() > 1e-3


def test_decode_and_verify_steps_with_adapters_match_jax(models, tenants):
    """Both steps over one random pool, rows on slots [1, 0, 2]: tokens,
    positions and acceptances equal to JAX's."""
    jcfg, tcfg, jp, tp = models
    jbuf, tbuf = _resident_pair(models, tenants)
    rng = np.random.default_rng(4)
    shape = (jcfg.n_layers, 13, BS, jcfg.n_kv_heads, jcfg.head_dim)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    tables = rng.permutation(np.arange(1, 13)).reshape(3, 4).astype(
        np.int32)
    pos = np.asarray([9, 17, 4], np.int32)
    first = np.asarray([5, 11, 40], np.int32)
    idx = np.asarray([1, 0, 2], np.int32)
    active = np.asarray([True, True, True])
    jt, _, jpos = jbatching.decode_steps_paged(
        jp, jnp.asarray(first), (jnp.asarray(k_pool), jnp.asarray(v_pool),
                                 None, None),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(active), jcfg,
        4, BS, jbuf, jnp.asarray(idx))
    tt, _, tpos = tbatching.decode_steps_paged(
        tp, _t(first), (_t(k_pool), _t(v_pool), None, None), _t(tables),
        _t(pos), _t(active), tcfg, 4, BS, adapters=tbuf,
        adapter_idx=_t(idx))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    # Verify the decode step's own tokens as drafts: all accepted.
    toks = np.concatenate([first[:, None], np.asarray(jt)[:, :3]],
                          1).astype(np.int32)
    n_real = np.asarray([4, 2, 1], np.int32)
    jout = jbatching.verify_step_paged(
        jp, jnp.asarray(toks), (jnp.asarray(k_pool), jnp.asarray(v_pool),
                                None, None),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(n_real), jcfg,
        4, BS, jbuf, jnp.asarray(idx))
    tout = tbatching.verify_step_paged(
        tp, _t(toks), (_t(k_pool), _t(v_pool), None, None), _t(tables),
        _t(pos), _t(n_real), tcfg, 4, BS, adapters=tbuf,
        adapter_idx=_t(idx))
    for got, exp in zip(tout[:4], jout[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert tout[1].tolist() == [3, 1, 0]


# ---------------------------------------------------------------------
# The engine: the JAX engine's tokens, mixed = alone, base = adapterless
# ---------------------------------------------------------------------


MIXED = (['tenant-a', None, 'tenant-b', 'tenant-b'],
         PROMPTS + [PROMPTS[0]])


def test_mixed_batch_matches_the_jax_engine(models, tenants):
    """[a, base, b, b] in one batch (prefix caching and speculation on):
    the port's tokens equal the JAX engine's on the same weights and
    lineages, and the adapters change the output."""
    jcfg, tcfg, jp, tp = models
    jreg, treg, _ = tenants
    adapters, prompts = MIXED
    jeng = jbatching.BatchingEngine(
        jp, jcfg, adapter_registry=jreg, adapter_capacity=4,
        adapter_preload=['tenant-a', 'tenant-b'], **ENGINE_KW)
    teng = _engine(tp, tcfg, treg, preload=['tenant-a', 'tenant-b'])
    try:
        want = [_drain(jeng.submit(p, 24, adapter=a))
                for p, a in zip(prompts, adapters)]
        tqs = [teng.submit(p, 24, adapter=a)
               for p, a in zip(prompts, adapters)]
        got = [_drain(q) for q in tqs]
        events = list(teng.events)
    finally:
        jeng.close()
        teng.close()
    assert got == want
    assert got[0] != got[1] and got[0] != got[3]
    assert any(e[0] == 'verify' for e in events), 'no verify ran'


def test_adapter_rank_bucket_matches_the_jax_engine(models, tmp_path):
    """``adapter_rank_bucket`` sizes the resident rank axis as the JAX
    engine's knob does: ranks 4 and 8 pad to a bucket of 8 and serve the
    JAX engine's tokens, and a rank-16 adapter, above the bucket, is
    refused typed by both engines."""
    jcfg, tcfg, jp, tp = models
    shapes = _shapes(tcfg)
    _write_jax(tmp_path, 'r4', shapes, rank=4, seed=3)
    _write_jax(tmp_path, 'r8', shapes, rank=8, seed=4)
    _write_jax(tmp_path, 'r16', shapes, rank=16, seed=5)
    jeng = jbatching.BatchingEngine(
        jp, jcfg, adapter_registry=jadapters.AdapterRegistry(
            base_dir=str(tmp_path)), adapter_capacity=2,
        adapter_rank_bucket=8, **ENGINE_KW)
    teng = _engine(tp, tcfg, AdapterRegistry(base_dir=str(tmp_path)),
                   capacity=2, adapter_rank_bucket=8)
    try:
        assert teng._adapters.rank_bucket == 8
        assert teng._adapters.buffers()['wq_a'].shape[-1] == 8
        for adapter, prompt in (('r4', PROMPTS[0]), ('r8', PROMPTS[1])):
            want = _drain(jeng.submit(prompt, 12, adapter=adapter))
            assert _drain(teng.submit(prompt, 12, adapter=adapter)) == want
        jq = jeng.submit(PROMPTS[2], 4, adapter='r16')
        tq = teng.submit(PROMPTS[2], 4, adapter='r16')
        assert type(jq.get(timeout=60)).__name__ == 'AdapterCapacityError'
        assert isinstance(tq.get(timeout=60),
                          exceptions.AdapterCapacityError)
    finally:
        jeng.close()
        teng.close()


def test_mixed_rows_equal_each_row_alone(models, tenants):
    """The port's exactness contract on the CPU: each row of the mixed
    batch emits what a dedicated engine emits for it alone."""
    _, tcfg, _, tp = models
    _, treg, _ = tenants
    adapters, prompts = MIXED
    engine = _engine(tp, tcfg, treg, preload=['tenant-a', 'tenant-b'])
    try:
        qs = [engine.submit(p, 24, adapter=a)
              for p, a in zip(prompts, adapters)]
        got = [_drain(q) for q in qs]
    finally:
        engine.close()
    want = [_solo(tp, tcfg, treg, p, a, 24)
            for p, a in zip(prompts, adapters)]
    assert got == want


def test_base_rows_match_the_adapterless_engine(models, tenants):
    """A base request on an adapter engine (slot 0's zero delta) equals
    the same request on an engine without an adapter set."""
    _, tcfg, _, tp = models
    _, treg, _ = tenants
    plain = tbatching.BatchingEngine(tp, tcfg, **dict(ENGINE_KW, slots=2))
    try:
        want = [_drain(plain.submit(p, 24)) for p in PROMPTS[:2]]
    finally:
        plain.close()
    engine = _engine(tp, tcfg, treg, preload=['tenant-a'])
    try:
        qs = [engine.submit(PROMPTS[0], 24),
              engine.submit(PROMPTS[0], 24, adapter='tenant-a'),
              engine.submit(PROMPTS[1], 24)]
        got = [_drain(q) for q in qs]
    finally:
        engine.close()
    assert [got[0], got[2]] == want
    assert got[1] != got[0]


def test_preempt_resume_equals_the_solo_run(models, tenants):
    """A pool sized to force preemption: each adapter request resumes
    (prompt + generated re-prefilled under its adapter) and equals its
    own run alone on a roomy engine. Six usable blocks: the two
    admissions take three each, so the first growth preempts whatever
    the timing (``tests/test_adapters.py``'s ten-block pool does not
    always run dry: an accepted draft can finish a row first)."""
    _, tcfg, _, tp = models
    _, treg, _ = tenants
    cases = list(zip(PROMPTS[:2], ['tenant-a', 'tenant-b']))
    engine = _engine(tp, tcfg, treg, preload=['tenant-a', 'tenant-b'],
                     slots=2, num_blocks=7)
    try:
        qs = [engine.submit(p, 28, adapter=a) for p, a in cases]
        got = [_drain(q) for q in qs]
        events = list(engine.events)
        free = engine.pool.free_blocks == engine.pool.usable_blocks
    finally:
        engine.close()
    assert any(e[0] == 'preempt' for e in events), \
        'the pool never ran dry: preempt-resume is not exercised'
    assert got == [_solo(tp, tcfg, treg, p, a, 28) for p, a in cases]
    assert free


def test_adapter_prefix_chains_never_reuse_base_blocks(models, tenants):
    """A base request's blocks are never a hit for an adapter request
    with the same prefix; a second request under that adapter hits."""
    _, tcfg, _, tp = models
    _, treg, _ = tenants
    prompt = PROMPTS[2] + [9, 9]
    engine = _engine(tp, tcfg, treg, preload=['tenant-a'])
    try:
        reqs = []
        for adapter in (None, 'tenant-a', 'tenant-a'):
            reqs.append(engine.submit_request(prompt, 4, adapter=adapter))
            _drain(reqs[-1].out)
    finally:
        engine.close()
    assert [r.prefix_hit_blocks for r in reqs] == [0, 0, 2]
    assert prefix_hash.adapter_root('tenant-a') != prefix_hash.ROOT


# ---------------------------------------------------------------------
# Cold loads and typed refusals
# ---------------------------------------------------------------------


def test_cold_load_admits_and_evicts_the_lru(models, tenants):
    """Capacity 1, nothing preloaded: the first tenant-a request waits on
    the load (adapter_hit False), the second hits warm; tenant-b's load
    then evicts tenant-a (idle, so unpinned), and the outputs equal the
    solo runs."""
    _, tcfg, _, tp = models
    _, treg, _ = tenants
    prompt = [9, 1, 4, 4] * 4
    engine = _engine(tp, tcfg, treg, capacity=1)
    try:
        cold = engine.submit_request(prompt, 12, adapter='tenant-a')
        got_a = _drain(cold.out)
        warm = engine.submit_request(prompt, 12, adapter='tenant-a')
        got_a2 = _drain(warm.out)
        other = engine.submit_request(prompt, 12, adapter='tenant-b')
        got_b = _drain(other.out)
        events = list(engine.events)
        zero = all(not buf[:, 0].any()
                   for buf in engine._adapters.buffers().values())
        times = engine._adapters.load_times
    finally:
        engine.close()
    assert (cold.adapter_hit, warm.adapter_hit, other.adapter_hit) == \
        (False, True, False)
    assert ('adapter_load', ('tenant-a',)) in events
    assert ('adapter_evict', ('tenant-a',)) in events
    assert zero, 'slot 0 must stay all zeros'
    assert times['tenant-b']['read_s'] >= 0 and \
        times['tenant-b']['upload_s'] >= 0
    assert got_a == got_a2 == _solo(tp, tcfg, treg, prompt, 'tenant-a', 12)
    assert got_b == _solo(tp, tcfg, treg, prompt, 'tenant-b', 12)


@pytest.mark.parametrize('adapter,exc', [
    ('nope', exceptions.AdapterNotFoundError),
    ('../escape', exceptions.AdapterNotFoundError),
    ('wide', exceptions.AdapterCapacityError),
])
def test_unservable_adapters_fail_typed(models, tenants, tmp_path,
                                        adapter, exc):
    _, tcfg, _, tp = models
    _write_port(tmp_path, 'wide', _shapes(tcfg), rank=32)
    engine = _engine(tp, tcfg, AdapterRegistry(base_dir=str(tmp_path)),
                     capacity=2)
    try:
        q = engine.submit([1, 2, 3], 8, adapter=adapter)
        assert isinstance(q.get(timeout=30), exc)
        assert q.get(timeout=30) is None
        assert engine.generate([1, 2, 3], 2)    # still serving
    finally:
        engine.close()


def test_adapterless_engine_refuses_adapters(models):
    _, tcfg, _, tp = models
    engine = tbatching.BatchingEngine(tp, tcfg, **dict(ENGINE_KW, slots=2))
    try:
        q = engine.submit([1, 2, 3], 8, adapter='any')
        assert isinstance(q.get(timeout=30),
                          exceptions.AdapterCapacityError)
    finally:
        engine.close()


def test_failed_cold_load_fails_the_waiter(models, tmp_path):
    """The spec reads fine at submit but the shard files are gone before
    the host read: the parked request gets a typed AdapterError."""
    _, tcfg, _, tp = models
    _write_port(tmp_path, 'doomed', _shapes(tcfg))
    reg = AdapterRegistry(base_dir=str(tmp_path))
    engine = _engine(tp, tcfg, reg, capacity=2)
    try:
        reg.spec('doomed')                  # prime the spec cache
        shutil.rmtree(tmp_path / 'doomed')
        q = engine.submit([1, 2, 3], 8, adapter='doomed')
        assert isinstance(q.get(timeout=60), exceptions.AdapterError)
    finally:
        engine.close()


# ---------------------------------------------------------------------
# Registry (tests/test_adapters.py TestRegistry, on the port's copies)
# ---------------------------------------------------------------------


class TestRegistry:

    def test_round_trip_spec_and_host_load(self, models, tmp_path):
        _, tcfg, _, _ = models
        factors = _write_jax(tmp_path, 'tenant-a', _shapes(tcfg), rank=4,
                             seed=1)
        reg = AdapterRegistry(base_dir=str(tmp_path))
        assert reg.list_ids() == ['tenant-a']
        spec = reg.spec('tenant-a')
        assert (spec.rank, spec.num_layers, spec.step) == \
            (4, tcfg.n_layers, 1)
        assert len(spec.content_hash) == 64
        host = reg.load_host('tenant-a')
        assert sorted(host) == ['wq_a', 'wq_b', 'wv_a', 'wv_b']
        np.testing.assert_array_equal(host['wq_a'], factors['wq_a'])
        # DEFAULT_SCALE (alpha / rank) folded into B at host load.
        np.testing.assert_allclose(host['wq_b'], factors['wq_b'] * 2.0,
                                   rtol=1e-6)

    def test_new_step_changes_content_hash(self, models, tmp_path):
        _, tcfg, _, _ = models
        _write_port(tmp_path, 'a', _shapes(tcfg), seed=1, step=1)
        reg = AdapterRegistry(base_dir=str(tmp_path))
        h1 = reg.spec('a').content_hash
        _write_port(tmp_path, 'a', _shapes(tcfg), seed=2, step=2)
        spec2 = reg.spec('a')
        assert spec2.step == 2 and spec2.content_hash != h1

    def test_unknown_and_escaping_ids_are_typed(self, tmp_path):
        reg = AdapterRegistry(base_dir=str(tmp_path))
        for bad in ('nope', '../outside', '..'):
            with pytest.raises(exceptions.AdapterNotFoundError):
                reg.spec(bad)

    def test_empty_lineage_is_not_found(self, tmp_path):
        os.makedirs(tmp_path / 'empty')
        with pytest.raises(exceptions.AdapterNotFoundError):
            AdapterRegistry(base_dir=str(tmp_path)).spec('empty')

    def test_non_lora_checkpoint_is_manifest_error(self, tmp_path):
        tcheckpoint.save_tree(str(tmp_path / 'model'), 1,
                              {'w': np.zeros((2, 2), np.float32)})
        with pytest.raises(exceptions.AdapterManifestError,
                           match='missing'):
            AdapterRegistry(base_dir=str(tmp_path)).spec('model')

    def test_inconsistent_rank_is_manifest_error(self, models, tmp_path):
        _, tcfg, _, _ = models
        n, dim, q_out, v_out = _shapes(tcfg)
        tcheckpoint.save_tree(str(tmp_path / 'bad'), 1, {'lora': {
            'wq_a': np.zeros((n, dim, 4), np.float32),
            'wq_b': np.zeros((n, 4, q_out), np.float32),
            'wv_a': np.zeros((n, dim, 8), np.float32),
            'wv_b': np.zeros((n, 8, v_out), np.float32)}})
        with pytest.raises(exceptions.AdapterManifestError, match='rank'):
            AdapterRegistry(base_dir=str(tmp_path)).spec('bad')

    def test_explicit_registration_outside_base_dir(self, models,
                                                    tmp_path):
        _, tcfg, _, _ = models
        _write_port(tmp_path / 'elsewhere', 'x', _shapes(tcfg))
        reg = AdapterRegistry(base_dir=None)
        reg.register('x', str(tmp_path / 'elsewhere' / 'x'))
        assert reg.spec('x').rank == 4


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_lineages_cross_read_between_packages(models, tmp_path, writer,
                                              dtype):
    """A lineage written by either package reads back through both
    registries: equal arrays (bf16 widened exactly), equal specs and
    content hashes, and the same manifest keys."""
    _, tcfg, _, _ = models
    shapes = _shapes(tcfg)
    if writer == 'port':
        want = _write_port(tmp_path, 'x', shapes, rank=8, seed=5,
                           dtype=getattr(torch, dtype))
    else:
        want = _write_jax(tmp_path, 'x', shapes, rank=8, seed=5,
                          dtype=getattr(jnp, dtype))
    jreg = jadapters.AdapterRegistry(base_dir=str(tmp_path))
    treg = AdapterRegistry(base_dir=str(tmp_path))
    jspec, tspec = jreg.spec('x'), treg.spec('x')
    assert (tspec.rank, tspec.step, tspec.num_layers) == \
        (jspec.rank, jspec.step, jspec.num_layers) == (8, 1, shapes[0])
    assert tspec.content_hash == jspec.content_hash
    jhost, thost = jreg.load_host('x'), treg.load_host('x')
    for name in want:
        scale = 2.0 if name.endswith('_b') else 1.0
        np.testing.assert_array_equal(thost[name], jhost[name])
        np.testing.assert_array_equal(thost[name],
                                      want[name] * np.float32(scale))
    with open(os.path.join(tmp_path, 'x', 'step_00000001',
                           'manifest.json'), encoding='utf-8') as f:
        leaves = json.load(f)['leaves']
    assert sorted(leaves) == ['lora/wq_a', 'lora/wq_b', 'lora/wv_a',
                              'lora/wv_b']
    assert {e['dtype'] for e in leaves.values()} == {dtype}


def test_save_tree_keys_are_the_jax_key_strings():
    """``checkpoint.flatten``'s keys equal ``format.key_str`` of JAX tree
    paths (both packages' copies) over nested dicts and lists."""
    from skypilot_tpu.checkpoint import format as jformat
    from skypilot_torch.checkpoint import format as tformat
    tree = {'lora': {'wq_a': 1, 'wv_b': 2}, 'opt': [{'mu': 3}, 4],
            'step': 5}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = sorted(jformat.key_str(path) for path, _ in flat)
    assert want == sorted(tformat.key_str(path) for path, _ in flat)
    assert sorted(tcheckpoint.flatten(tree)) == want
    assert tformat.dtype_from_name('bfloat16') == np.dtype('<u2')


# ---------------------------------------------------------------------
# Resident set (tests/test_adapters.py TestResidentSet, on the port)
# ---------------------------------------------------------------------


class TestResidentSet:

    def _resident(self, models, tmp_path, capacity=2, n=3, bucket=16):
        _, tcfg, _, _ = models
        for i in range(n):
            _write_port(tmp_path, f't{i}', _shapes(tcfg),
                        rank=4 + 4 * (i % 2), seed=i)
        return ResidentAdapterSet(AdapterRegistry(base_dir=str(tmp_path)),
                                  capacity, _shapes(tcfg),
                                  rank_bucket=bucket, device='cpu')

    @staticmethod
    def _load(rs, adapter_id, timeout=30):
        rs.ensure_loading(adapter_id)
        deadline = time.time() + timeout
        while time.time() < deadline:
            ready, evicted, _ = rs.poll()
            if adapter_id in ready:
                return evicted
            assert rs.take_failure(adapter_id) is None
            time.sleep(0.01)
        raise AssertionError(f'{adapter_id} never became resident')

    def test_slots_and_zero_identity(self, models, tmp_path):
        rs = self._resident(models, tmp_path)
        bufs = {k: v.data_ptr() for k, v in rs.buffers().items()}
        assert rs.slot(None) == 0 and rs.slot('t0') is None
        assert self._load(rs, 't0') == []
        assert rs.slot('t0') in (1, 2)
        assert not rs.buffers()['wq_a'][:, 0].any()
        # Installed in place: the same four tensors.
        assert {k: v.data_ptr() for k, v in rs.buffers().items()} == bufs

    def test_rank_padding_is_zero_fill(self, models, tmp_path):
        rs = self._resident(models, tmp_path)
        self._load(rs, 't0')                  # rank 4
        a = rs.buffers()['wq_a'][:, rs.slot('t0')]
        assert not a[..., 4:].any() and a[..., :4].abs().max() > 0

    def test_lru_evicts_coldest_unpinned(self, models, tmp_path):
        rs = self._resident(models, tmp_path)
        self._load(rs, 't0')
        self._load(rs, 't1')
        rs.pin('t0')
        rs.unpin('t0')                        # t0 warm, t1 coldest
        assert self._load(rs, 't2') == ['t1']
        assert rs.resident_ids() == ['t0', 't2']

    def test_pinned_is_never_evicted(self, models, tmp_path):
        rs = self._resident(models, tmp_path)
        self._load(rs, 't0')
        self._load(rs, 't1')
        rs.pin('t1')
        rs.pin('t0')
        rs.unpin('t0')
        assert self._load(rs, 't2') == ['t0']
        assert 't1' in rs.resident_ids()

    def test_all_pinned_parks_the_load(self, models, tmp_path):
        rs = self._resident(models, tmp_path, capacity=1, n=2)
        self._load(rs, 't0')
        rs.pin('t0')
        rs.ensure_loading('t1')
        deadline = time.time() + 30
        while time.time() < deadline:
            ready, _, _ = rs.poll()
            assert ready == []               # parked, not an error
            if rs.slot('t1') is None and not rs._loading:
                break
            time.sleep(0.01)
        rs.unpin('t0')
        assert rs.poll()[:2] == (['t1'], ['t0'])

    def test_over_rank_is_capacity_error(self, models, tmp_path):
        _, tcfg, _, _ = models
        _write_port(tmp_path, 'wide', _shapes(tcfg), rank=32)
        rs = ResidentAdapterSet(AdapterRegistry(base_dir=str(tmp_path)), 2,
                                _shapes(tcfg), rank_bucket=16,
                                device='cpu')
        with pytest.raises(exceptions.AdapterCapacityError, match='rank'):
            rs.check_fits('wide')

    def test_failed_load_surfaces_via_take_failure(self, models, tmp_path):
        rs = self._resident(models, tmp_path)
        rs.registry.register('ghost', str(tmp_path / 'missing'))
        rs.ensure_loading('ghost')
        deadline = time.time() + 30
        failure = None
        while time.time() < deadline and failure is None:
            rs.poll()
            failure = rs.take_failure('ghost')
            time.sleep(0.01)
        assert isinstance(failure, exceptions.AdapterNotFoundError)

    def test_preload_over_capacity_raises(self, models, tmp_path):
        rs = self._resident(models, tmp_path)
        rs.preload(['t0', 't1', 't2'])       # eviction allowed
        assert rs.resident_count() == 2
        rs.pin('t1')
        rs.pin('t2')
        with pytest.raises(exceptions.AdapterCapacityError):
            rs.preload(['t0'])


# ---------------------------------------------------------------------
# The replica
# ---------------------------------------------------------------------


def test_replica_adapter_statuses_and_headers(tmp_path):
    """The ``--slots`` replica with an adapter dir: a cold adapter answers
    with ``X-Skytpu-Adapter-Loads: 1``, the repeat ``Hits: 1`` and the
    same tokens; base requests carry no adapter headers; an unknown id
    answers 404 and an adapter over the rank bucket 413."""
    tcfg = tllama.get_config('tiny')
    # A large delta: the bf16 tiny model's greedy stream is one repeated
    # token that a small one does not move.
    _write_port(tmp_path, 'tenant-e2e', _shapes(tcfg), rank=4, seed=7,
                scale=0.5)
    _write_port(tmp_path, 'wide', _shapes(tcfg), rank=32, seed=8)
    args = serve_model.parse_args(
        ['--model', 'tiny', '--port', '0', '--device', 'cpu', '--slots',
         '2', '--adapter-dir', str(tmp_path), '--adapter-capacity', '2'])
    server, _ = serve_model.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def post(body):
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
        try:
            conn.request('POST', '/generate', body=json.dumps(body))
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), \
                json.loads(resp.read())
        finally:
            conn.close()

    try:
        body = {'prompt_ids': [5, 9, 2, 7] * 4, 'max_new_tokens': 8,
                'adapter': 'tenant-e2e'}
        status, heads, out = post(body)
        assert status == 200, out
        assert heads[prefix_hash.ADAPTER_LOADS_HEADER] == '1'
        assert heads[prefix_hash.ADAPTER_HITS_HEADER] == '0'
        status, heads, warm = post(body)
        assert status == 200
        assert heads[prefix_hash.ADAPTER_HITS_HEADER] == '1'
        assert heads[prefix_hash.ADAPTER_LOADS_HEADER] == '0'
        assert warm == out
        status, heads, base = post({'prompt_ids': [5, 9, 2, 7] * 4,
                                    'max_new_tokens': 8})
        assert status == 200
        assert prefix_hash.ADAPTER_HITS_HEADER not in heads
        assert base != out
        for name, code in (('ghost', 404), ('../escape', 404),
                           ('wide', 413)):
            status, _, err = post(dict(body, adapter=name))
            assert status == code, (name, err)
    finally:
        server.shutdown()
        server.server_close()
        server.engine.close()
        thread.join(timeout=10)
