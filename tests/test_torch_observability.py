"""The port's observability through its loops, on the CPU at ``tiny``:

- engine parity: the JAX engine and the port's engine, on the same
  weights and JAX-written adapter lineages, step through one scripted
  traffic (a shared prefix, a drafting prompt, a sampled and a
  constrained request, an adapter cold load that evicts, a shed by each
  reason, a cancel, deadlines at submit and mid-decode, a preemption),
  and every deterministic counter and gauge of their registries ends
  equal, with equal histogram counts (the loop is stepped by hand, one
  ``_loop_inner`` iteration at a time, so both see the same schedule);
- the on-demand profiler: a trigger armed on the CPU is consumed by the
  instrumented train step and by the engine's decode loop, and the
  summary they write is read by the JAX package's ``load_summary`` and
  ``format_summary_payload``;
- ``instrument_train_step`` on the port's tiny LoRA step: steps, tokens
  and step-time series as the JAX wrapper's, the ``train.step`` span over
  the histogram's own intervals, goodput buckets, and MFU against the
  card table's peak;
- the finetune recipe and the replica publish their registries to the
  textfile dir the JAX agent reads."""
import dataclasses
import importlib
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu import trace as jtrace
from skypilot_tpu.checkpoint.native import NativeCheckpointManager
from skypilot_tpu.metrics import exposition as jexposition
from skypilot_tpu.metrics import goodput as jgoodput
from skypilot_tpu.metrics import publish as jpublish
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel.train import instrument_train_step as jinstrument
from skypilot_tpu.serve import adapters as jadapters
from skypilot_tpu.serve import batching as jbatching
from skypilot_tpu.utils import profiling as jprofiling
from skypilot_torch import metrics as tmetrics
from skypilot_torch import trace
from skypilot_torch.metrics import goodput
from skypilot_torch.models import convert, llama
from skypilot_torch.parallel import train as train_lib
from skypilot_torch.recipes import finetune, serve_model
from skypilot_torch.serve import batching
from skypilot_torch.serve.adapters import AdapterRegistry
from skypilot_torch.utils import profiling

JREG = importlib.import_module('skypilot_tpu.metrics.registry')
TREG = importlib.import_module('skypilot_torch.metrics.registry')
TTRACER = importlib.import_module('skypilot_torch.trace.tracer')


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Fresh registries and accountants on both sides, the port tracer's
    sink closed, and ``HOME`` in the test's directory (the recipe's step
    callbacks write under it): all process-global."""
    monkeypatch.setattr(JREG, '_default_registry', JREG.Registry())
    monkeypatch.setattr(TREG, '_default_registry', TREG.Registry())
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    monkeypatch.setattr(TTRACER, '_component', TTRACER._component)
    jgoodput.reset_accountant()
    goodput.reset_accountant()
    trace.reset_sink()
    yield
    jgoodput.reset_accountant()
    goodput.reset_accountant()
    trace.reset_sink()


def _values(reg):
    """{(family, labels): value} with histograms as their counts (the
    windowed ratios left out: RATIOS)."""
    out = {}
    for fam in reg.families():
        if fam.name in RATIOS:
            continue
        for labels, child in fam.collect():
            if fam.kind == 'histogram':
                out[(fam.name + '_count', labels)] = child.count
            else:
                out[(fam.name, labels)] = child.value
    return out


# ---------------------------------------------------------------------
# Engine parity under one scripted traffic
# ---------------------------------------------------------------------

GV_EOS = 40
REGEX = r'\{"a":[0-9]{1,4}\}'
# Timing series: equal in kind, not in value.
TIMED = ('skytpu_batch_decode_tokens_per_sec',)
# The windowed ratio gauges are process-global and unlabeled (last
# writer wins): any engine alive in this process writes the registry's
# copy, so they are held through each engine's own window state.
RATIOS = ('skytpu_batch_prefix_hit_ratio', 'skytpu_batch_spec_accept_ratio')


def _grammar_vocab():
    gv = [None] * 512
    syms = list('0123456789{}[],:."ab') + ['true', 'false', 'null']
    for i, sym in enumerate(syms, start=1):
        gv[i] = sym
    return gv


@pytest.fixture(scope='module')
def shared(tmp_path_factory):
    """JAX and port params holding JAX's tiny weights, and a registry of
    each package over two JAX-written q/v LoRA lineages."""
    jcfg = jllama.get_config('tiny', dtype=jnp.float32)
    tcfg = llama.get_config('tiny', dtype=torch.float32)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    base = tmp_path_factory.mktemp('adapters')
    rng = np.random.default_rng(0)
    dims = {'wq': tcfg.n_heads * tcfg.head_dim,
            'wv': tcfg.n_kv_heads * tcfg.head_dim}
    for name in ('a', 'b'):
        lora = {}
        for w, out in dims.items():
            lora[f'{w}_a'] = jnp.asarray(rng.standard_normal(
                (tcfg.n_layers, tcfg.dim, 4)).astype(np.float32) * 0.05)
            lora[f'{w}_b'] = jnp.asarray(rng.standard_normal(
                (tcfg.n_layers, 4, out)).astype(np.float32) * 0.05)
        mgr = NativeCheckpointManager(str(base / name), process_index=0,
                                      process_count=1)
        mgr.save(1, {'lora': lora})
        mgr.wait()
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, tcfg, device='cpu'),
            jadapters.AdapterRegistry(base_dir=str(base)),
            AdapterRegistry(base_dir=str(base)))


def _stepped(engine):
    """Stop the engine's loop thread and take over its iterations."""
    engine.close()
    engine._stop = False
    engine._prefix_window.clear()
    engine._spec_window.clear()
    engine._set_gauges()
    return engine


def _iterate(engine):
    """One iteration of ``_loop_inner``, as both engines run it."""
    engine._sweep_overload()
    engine._poll_adapter_loads()
    engine._admit_pending()
    engine._run_prefill_chunks()
    engine._dispatch_decode()
    engine._set_gauges()


def _finished(req):
    return req.out.queue and req.out.queue[-1] is None


def _outcome(req):
    """What the client got: token ids, a failure as (type, message)."""
    return [(type(t).__name__, str(t)) if isinstance(t, BaseException)
            else t for t in req.out.queue]


def _until(engine, pred, limit=300):
    for _ in range(limit):
        if pred():
            return
        _iterate(engine)
    raise AssertionError('the script never reached its next point')


def _script(engine):
    """The scripted traffic on a stepped engine; returns its requests."""
    far = time.time() + 3600
    prefix = [(i * 7) % 250 + 1 for i in range(16)]
    sub = engine.submit_request
    # Bounded admission (3 queued): an interactive arrival evicts the
    # queued batch request, then a batch arrival is shed.
    r = {'shared': sub(prefix + [3, 9], 6, deadline=far),
         'draft': sub([1, 2, 3, 4] * 4, 10),
         'batch': sub([5, 4, 3], 4, priority='batch')}
    r['inter'] = sub([6, 6, 6], 4)
    r['shed'] = sub([7, 7], 4, priority='batch')
    r['late'] = sub([8, 8], 4, deadline=time.time() - 1.0)
    _until(engine, lambda: _finished(r['shared']))
    # The shared prefix's blocks are cached: this one hits them.
    r['hit'] = sub(prefix + [1], 5)
    # A sampled row cool enough to fall into the greedy row's loop, so
    # it drafts and verifies under the sampled rule.
    r['sampled'] = sub([1, 2, 3, 4] * 4 + [1], 12, temperature=0.02,
                       top_p=0.9, seed=11)
    _until(engine, lambda: not engine.pending)
    r['json'] = sub([1, 2, 3], 24, temperature=0.8, seed=3, eos_id=GV_EOS,
                    response_format={'type': 'regex', 'pattern': REGEX})
    _until(engine, lambda: all(_finished(x) for x in r.values()))
    # A cold adapter: its load evicts the preloaded one.
    r['cold'] = sub([9, 8, 7, 6], 6, adapter='b')
    _until(engine, lambda: engine._adapter_wait)
    deadline = time.time() + 30
    while engine._adapters._loading and time.time() < deadline:
        time.sleep(0.01)
    # A cancel and a deadline that lapses mid-decode.
    r['cancel'] = sub([4, 4, 4], 30)
    r['expire'] = sub([2, 2, 2], 30, deadline=far)
    _until(engine, lambda: r['expire'].generated and r['cancel'].generated)
    engine.cancel(r['cancel'])
    r['expire'].deadline = time.time() - 1.0
    _until(engine, lambda: all(_finished(x) for x in r.values()))
    # Two long rows outgrow the pool: the younger is preempted.
    r['long1'] = sub([11] * 30, 30)
    r['long2'] = sub([12] * 30, 30)
    _until(engine, lambda: all(_finished(x) for x in r.values()))
    _iterate(engine)          # the idle sweep after the last retirement
    return r


def test_engine_counters_and_gauges_equal_the_jax_engines(shared):
    jcfg, tcfg, jp, tp, jreg, treg = shared
    kw = dict(slots=2, max_seq=64, steps_per_dispatch=3, block_size=8,
              prefill_chunk=8, max_num_batched_tokens=16, draft_k=4,
              num_blocks=12, max_queued_requests=3,
              grammar_vocab=_grammar_vocab(), adapter_capacity=1,
              adapter_preload=['a'])
    jeng = _stepped(jbatching.BatchingEngine(jp, jcfg, adapter_registry=jreg,
                                             **kw))
    teng = _stepped(batching.BatchingEngine(tp, tcfg, adapter_registry=treg,
                                            **kw))
    want_reqs = _script(jeng)
    got_reqs = _script(teng)
    for name in got_reqs:
        assert _outcome(got_reqs[name]) == _outcome(want_reqs[name]), name
    got = _values(tmetrics.registry())
    want = _values(JREG.registry())
    assert set(got) == set(want)
    for key in got:
        if key[0] not in TIMED:
            assert got[key] == want[key], key
    # The script reached every site it was written for.
    v = {k[0] + ''.join(f'{{{x}}}' for _, x in k[1]): val
         for k, val in got.items()}
    assert v['skytpu_batch_shed_total{priority_evict}'] == 1
    assert v['skytpu_batch_shed_total{max_queued_requests}'] == 1
    assert v['skytpu_batch_deadline_exceeded_total'] == 2
    assert v['skytpu_batch_cancelled_total'] == 1
    assert v['skytpu_batch_preemptions_total'] >= 1
    assert v['skytpu_batch_prefix_hits_total'] >= 2
    assert v['skytpu_batch_spec_proposed_total'] > 0
    assert v['skytpu_batch_spec_accept_rate_count{greedy}'] > 0
    assert v['skytpu_batch_spec_accept_rate_count{sampled}'] > 0
    assert v['skytpu_batch_sampled_requests_total'] == 2
    assert v['skytpu_batch_constrained_requests_total'] == 1
    assert v['skytpu_batch_adapter_loads_total'] == 2
    assert v['skytpu_batch_adapter_evictions_total'] == 1
    assert v['skytpu_batch_adapter_load_seconds_count'] == 1
    assert v['skytpu_batch_requests_total'] == 11
    assert v['skytpu_batch_ttft_seconds_count'] == 11
    assert v['skytpu_batch_queue_wait_seconds_count'] == 11
    assert v['skytpu_batch_decode_tokens_total'] == sum(
        len([t for t in q.out.queue if isinstance(t, int)])
        for q in got_reqs.values())
    assert v['skytpu_batch_slots_occupied'] == 0
    assert v['skytpu_batch_kv_blocks_used'] == 0
    # The windowed ratios: both gauges live (all traffic is inside the
    # window, whose first snapshot is the zero the script started from)
    # over the same cumulatives on both engines.
    for eng in (teng, jeng):
        assert eng._hit_ratio_gauge is not None
        assert eng._spec_ratio_gauge is not None
        assert eng._prefix_window[0][1:] == eng._spec_window[0][1:] == \
            (0, 0)
    assert [(e._prefix_hits_local, e._prefix_misses_local,
             e._spec_proposed_local, e._spec_accepted_local)
            for e in (teng, jeng)] == 2 * [(
                v['skytpu_batch_prefix_hits_total'],
                v['skytpu_batch_prefix_misses_total'],
                v['skytpu_batch_spec_proposed_total'],
                v['skytpu_batch_spec_accepted_total'])]
    # The engine's own record agrees with its counters.
    events = list(teng.events)
    assert v['skytpu_batch_preemptions_total'] == sum(
        e[0] == 'preempt' for e in events)
    verifies = [e for e in events if e[0] == 'verify']
    assert v['skytpu_batch_spec_proposed_total'] == sum(
        e[2] for e in verifies)
    assert v['skytpu_batch_spec_accepted_total'] == sum(
        e[3] for e in verifies)
    assert re.fullmatch(REGEX, ''.join(
        _grammar_vocab()[t] or '' for t in got_reqs['json'].generated
        if t != GV_EOS))


# ---------------------------------------------------------------------
# On-demand profiling
# ---------------------------------------------------------------------


def test_train_trigger_capture_is_read_by_the_jax_reader():
    x = torch.randn(64, 64)

    def step(state, batch):
        return state, {'loss': (x @ x).relu().sum()}

    wrapped = train_lib.instrument_train_step(step)
    profiling.write_trigger(steps=2)
    for _ in range(4):
        wrapped(None, {'tokens': torch.zeros(2, 9)})
    assert not os.path.exists(os.path.join(profiling.profile_dir(),
                                           profiling.TRIGGER_FILE))
    payload = jprofiling.load_summary()
    assert payload is not None, 'the armed loop wrote no summary'
    assert (payload['kind'], payload['steps']) == ('train', 2)
    assert payload['rows'] and all(r['category'] == 'cpu_op'
                                   for r in payload['rows'])
    names = [r['name'] for r in payload['rows']]
    assert 'aten::mm' in names
    mm = payload['rows'][names.index('aten::mm')]
    assert mm['count'] == 2
    table = jprofiling.format_summary_payload(payload)
    assert 'total ms' in table and 'aten::mm' in table
    assert profiling.load_summary() == payload


def test_engine_decode_loop_consumes_a_trigger():
    profiling.write_trigger(steps=2)
    cfg = llama.get_config('tiny', dtype=torch.float32)
    engine = batching.BatchingEngine(llama.init_params(cfg, device='cpu'),
                                     cfg, slots=2, max_seq=64,
                                     steps_per_dispatch=2)
    try:
        assert len(engine.generate([1, 2, 3], 9)) == 9
        deadline = time.time() + 20
        payload = None
        while time.time() < deadline:
            payload = jprofiling.load_summary()
            if payload is not None:
                break
            engine.generate([1, 2, 3], 5)
    finally:
        engine.close()
    assert payload is not None, 'the decode loop never profiled'
    assert payload['kind'] == 'decode' and payload['rows']


def test_capture_trace_and_its_summary():
    with profiling.capture_trace() as d:
        torch.randn(32, 32) @ torch.randn(32, 32)
    rows = profiling.summarize_trace(d, device_only=False)
    assert 'aten::mm' in [r.name for r in rows]
    assert profiling.summarize_trace(d) == []     # no card here
    assert 'aten::mm' in profiling.format_summary(rows)


@pytest.mark.parametrize('env', [
    {'SKYTPU_PROFILE_DIR': 'P', 'SKYTPU_RUNTIME_DIR': 'R'},
    {'SKYTPU_RUNTIME_DIR': 'R'}, {}])
def test_profile_dir_and_trigger_protocol_match(env, tmp_path, monkeypatch):
    for k in ('SKYTPU_PROFILE_DIR', 'SKYTPU_RUNTIME_DIR'):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(tmp_path / v))
    assert profiling.profile_dir() == jprofiling.profile_dir()
    jprofiling.write_trigger(steps=3)
    assert profiling.consume_trigger() == 3
    profiling.write_trigger(steps=0)
    assert jprofiling.consume_trigger() == jprofiling.DEFAULT_PROFILE_STEPS
    d = tmp_path / 'torn'
    d.mkdir()
    (d / 'trigger.json').write_text('{"steps": ')
    assert profiling.consume_trigger(str(d)) is None
    assert not (d / 'trigger.json').exists()


# ---------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------


def test_instrumented_lora_step_records_as_the_jax_wrapper(monkeypatch):
    monkeypatch.setenv('SKYTPU_ACCELERATOR', 'H100-SXM')
    cfg = llama.get_config('tiny', dtype=torch.float32)
    state = train_lib.init_train_state(cfg, lora_rank=4, device='cpu')
    tokens_per_step = 2 * 16
    step = train_lib.instrument_train_step(
        train_lib.build_train_step(cfg), tokens_per_step=tokens_per_step,
        model_config=cfg)
    batch = {'tokens': torch.randint(0, cfg.vocab_size, (2, 17))}
    jstep = jinstrument(lambda s, b: (s, {}),
                        tokens_per_step=tokens_per_step)
    with trace.span('job.run', new_trace=True) as root:
        for _ in range(3):
            state, m = step(state, batch)
            float(m['loss'])
            jstep(None, batch)
    reg = tmetrics.registry()
    assert reg.counter('skytpu_train_steps_total').value == 3
    assert reg.counter('skytpu_train_tokens_total').value == \
        3 * tokens_per_step
    hist = {f.name: f for f in reg.families()}[
        'skytpu_train_step_seconds'].collect()[0][1]
    assert hist.count == 2
    # The JAX wrapper over the same calls: the same series, the same
    # counts (its step times are its own).
    jv, tv = _values(JREG.registry()), _values(reg)
    assert {k for k in tv if k[0] != 'skytpu_mfu_ratio'} == set(jv)
    for key in ('skytpu_train_steps_total', 'skytpu_train_tokens_total',
                'skytpu_train_step_seconds_count'):
        assert tv[(key, ())] == jv[(key, ())]
    # The spans cover the histogram's own intervals.
    spans = sorted((s for s in jtrace.collect.load_spans(
        [trace.sink_dir()], trace_id=root.context.trace_id)
        if s['name'] == 'train.step'), key=lambda s: s['start'])
    # (Span ends are epoch floats: a few 1e-7 s of rounding.)
    durs = [s['end'] - s['start'] for s in spans]
    assert len(durs) == 2
    assert sum(durs) == pytest.approx(hist.sum, abs=1e-6)
    snap = goodput.accountant().snapshot()
    assert snap['compile'] == pytest.approx(durs[0], abs=1e-6)
    assert snap['compute'] == pytest.approx(durs[1], abs=1e-6)
    assert snap['compile'] + snap['compute'] == pytest.approx(hist.sum)
    # MFU of the last compute step: 4 N (frozen base) over one card.
    mfu = reg.gauge('skytpu_mfu_ratio').value
    assert mfu == pytest.approx(
        4 * cfg.num_params() * tokens_per_step / (snap['compute'] * 989e12))


def test_finetune_recipe_instruments_and_publishes(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv('SKYTPU_METRICS_DIR', str(tmp_path / 'm'))
    seen = []
    real = jpublish.read_textfiles
    pub_cls = finetune.publish_lib.MetricsPublisher

    class Publisher(pub_cls):
        def close(self):
            self.publish_once()
            seen.append(real(str(tmp_path / 'm')))
            super().close()
    monkeypatch.setattr(finetune.publish_lib, 'MetricsPublisher', Publisher)
    finetune.main(['--model', 'tiny', '--device', 'cpu', '--seq', '32',
                   '--batch', '2', '--steps', '3'])
    fams = jexposition.parse_text(seen[0])
    proc = f'train-{os.getpid()}'
    assert [(dict(s.labels)['proc'], s.value) for s in
            fams['skytpu_train_steps_total'].samples] == [(proc, 3)]
    assert fams['skytpu_train_tokens_total'].samples[0].value == 3 * 64
    assert real(str(tmp_path / 'm')) == ''       # removed at close
    cb = os.path.join(os.environ['HOME'], 'sky_benchmark_dir',
                      'skytpu_callback.json')
    assert os.path.exists(cb)
    assert 'finetune done.' in capsys.readouterr().out


def test_replica_publishes_its_engine_series(tmp_path, monkeypatch):
    monkeypatch.setenv('SKYTPU_METRICS_DIR', str(tmp_path / 'm'))
    args = serve_model.parse_args(['--model', 'tiny', '--port', '0',
                                   '--device', 'cpu', '--slots', '2'])
    server, _ = serve_model.build_server(args)
    try:
        server.publisher.publish_once()
        fams = jexposition.parse_text(
            jpublish.read_textfiles(str(tmp_path / 'm')))
        proc = f'replica-{os.getpid()}'
        slots = fams['skytpu_batch_slots_total'].samples[0]
        assert dict(slots.labels) == {'proc': proc} and slots.value == 2
        # The warm-up: one greedy and one sampled request.
        assert fams['skytpu_batch_requests_total'].samples[0].value == 2
        assert fams['skytpu_batch_sampled_requests_total'].samples[
            0].value == 1
        assert trace.component() == 'replica'
    finally:
        server.server_close()
        server.engine.close()
    assert jpublish.read_textfiles(str(tmp_path / 'm')) == ''
