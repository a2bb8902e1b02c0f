"""The port's tracer (skypilot_torch/trace/) against the JAX package's, on
the CPU: the same ``traceparent`` format and env contract
(``SKYTPU_TRACE_CONTEXT``, ``SKYTPU_TRACE``, ``SKYTPU_TRACE_SAMPLE``,
``SKYTPU_TRACE_DIR``, ``SKYTPU_STATE_DIR``), sink files the JAX
collector assembles into the same trees, and — for a traced request —
the same span names, tree shape and attribute keys from the port's
engine as from the JAX engine, and from the port's replica as from the
JAX replica (``replica.generate`` → ``batch.queue_wait``,
``batch.prefill``, ``batch.first_token``, ``batch.decode``). The
trainer's ``train.step`` spans nest and close as the JAX wrapper's."""
import http.client
import json
import os
import socket
import sys
import threading
import time

import pytest
import torch

import jax

from skypilot_tpu import trace as jtrace
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import batching as jbatching
from skypilot_torch import trace
from skypilot_torch.models import llama
from skypilot_torch.parallel import train as train_lib
from skypilot_torch.recipes import serve_model
from skypilot_torch.serve import batching

JTRACER = sys.modules['skypilot_tpu.trace.tracer']
TTRACER = sys.modules['skypilot_torch.trace.tracer']
BATCH_SPANS = ('batch.queue_wait', 'batch.prefill', 'batch.first_token',
               'batch.decode')


@pytest.fixture(autouse=True)
def _fresh_tracers(monkeypatch):
    """Each test's spans land in its own state dir; both tracers' sink
    handles and component names are restored afterwards (both are
    process-global)."""
    for mod in (JTRACER, TTRACER):
        monkeypatch.setattr(mod, '_component', mod._component)
        mod.reset_sink()
    monkeypatch.delenv('SKYTPU_TRACE_CONTEXT', raising=False)
    monkeypatch.delenv('SKYTPU_TRACE_DIR', raising=False)
    yield
    for mod in (JTRACER, TTRACER):
        mod.reset_sink()


def _spans(trace_id=None, root=None):
    """Spans under ``root`` (default: the sink dir), read by the JAX
    collector."""
    return jtrace.collect.load_spans([root or trace.sink_dir()],
                                     trace_id=trace_id)


def _shape(spans):
    """The tree shape: {(name, parent's name, attr keys)}."""
    names = {s['span_id']: s['name'] for s in spans}
    return {(s['name'], names.get(s['parent_id']),
             tuple(sorted(s['attrs']))) for s in spans}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------
# The span model and the env contract
# ---------------------------------------------------------------------


def _program(tr):
    with tr.span('launch', new_trace=True, attrs={'cluster': 'c1'}) as root:
        with tr.span('launch.optimize'):
            pass
        with tr.span('launch.provision'):
            with tr.span('agent.rpc', attrs={'path': '/run'}):
                pass
        ctx = tr.current()
        tr.record_span('ckpt.save', time.time(), time.time(), ctx,
                       attrs={'step': 0})
        with pytest.raises(RuntimeError):
            with tr.span('boom'):
                raise RuntimeError('x')
    return root.context.trace_id


def test_jax_collector_builds_the_same_tree_from_port_sinks(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path / 'port'))
    tid = _program(trace)
    port = _spans(tid, str(tmp_path / 'port'))
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path / 'jax'))
    jtid = _program(jtrace)
    want = _spans(jtid, str(tmp_path / 'jax'))
    assert _shape(port) == _shape(want)
    assert len(port) == len(want) == 6
    roots = jtrace.collect.build_tree(port)
    assert len(roots) == 1 and roots[0]['name'] == 'launch'
    boom = [s for s in port if s['name'] == 'boom'][0]
    assert boom['status'] == 'ERROR' and 'x' in boom['attrs']['error']
    files = os.listdir(tmp_path / 'port')
    assert files == [f'spans-{trace.component()}-{os.getpid()}.jsonl']


def test_sink_defaults_under_the_state_dir_and_component(monkeypatch):
    trace.set_component('replica')
    with trace.span('x', new_trace=True):
        pass
    d = os.path.join(os.environ['SKYTPU_STATE_DIR'], 'trace')
    assert trace.sink_dir() == jtrace.sink_dir() == d
    assert os.listdir(d) == [f'spans-replica-{os.getpid()}.jsonl']


@pytest.mark.parametrize('value', [
    '00-' + 'ab' * 16 + '-' + 'cd' * 8 + '-01', 'ab' * 16 + '-' + 'cd' * 8,
    '00-xyz-12-01', 'garbage', '', None, '00--12-01', '00-12-34-01-05'])
def test_traceparent_parse_and_format_match(value):
    got = trace.parse_traceparent(value)
    assert got == jtrace.parse_traceparent(value)
    assert trace.format_traceparent(got) == jtrace.format_traceparent(got)


def test_env_stamp_and_attach_barrier(monkeypatch):
    ctx = trace.SpanContext('ab' * 16, 'cd' * 8)
    env = trace.context_env(ctx)
    assert env == jtrace.context_env(jtrace.SpanContext(*ctx))
    monkeypatch.setenv(*next(iter(env.items())))
    assert trace.current() == jtrace.current() == ctx
    with trace.span('child') as sp:
        assert sp.recording and sp.parent_id == ctx.span_id
    with trace.attach(None):
        assert trace.current() is None
        with trace.span('orphan') as sp:
            assert not sp.recording


@pytest.mark.parametrize('trace_on, sample, want', [
    ('1', '1', True), ('1', '0', False), ('1', 'junk', True),
    ('0', '1', False), ('1', '2.5', True), ('1', '-1', False)])
def test_sampling_and_the_kill_switch(trace_on, sample, want, monkeypatch):
    monkeypatch.setenv('SKYTPU_TRACE', trace_on)
    monkeypatch.setenv('SKYTPU_TRACE_SAMPLE', sample)
    assert trace.sample_root() == jtrace.sample_root() == want
    assert trace.enabled() == jtrace.enabled()
    with trace.span('x', new_trace=True):
        pass
    written = _spans()
    assert (written != []) == (trace_on == '1')


def test_sink_rotates_at_its_size_cap(monkeypatch):
    monkeypatch.setenv('SKYTPU_TRACE_MAX_MB', '0.001')
    for i in range(40):
        with trace.span('x', new_trace=True, attrs={'i': i}):
            pass
    d = trace.sink_dir()
    assert sorted(os.listdir(d))[-1].endswith('.jsonl.1')


# ---------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------


def _engine_spans(engine, tr, prompt, max_new):
    try:
        with tr.span('replica.generate', new_trace=True) as root:
            out = engine.generate(prompt, max_new)
    finally:
        engine.close()
    assert len(out) == max_new
    return root, _spans(root.context.trace_id)


def test_engine_span_tree_equals_the_jax_engines():
    # The replica's engine shape (--slots 2 --sampling off), so the JAX
    # replica below reuses these compiles.
    tcfg = llama.get_config('tiny')
    root, port = _engine_spans(
        batching.BatchingEngine(llama.init_params(tcfg, device='cpu'),
                                tcfg, slots=2, sampling=False),
        trace, [1, 2, 3], 20)
    jcfg = jllama.get_config('tiny')
    _, want = _engine_spans(
        jbatching.BatchingEngine(
            jllama.init_params(jcfg, jax.random.PRNGKey(0)), jcfg, slots=2,
            sampling=False), jtrace, [1, 2, 3], 20)
    assert _shape(port) == _shape(want)
    names = [s['name'] for s in port]
    for name in BATCH_SPANS[:3]:
        assert names.count(name) == 1, names
    # 20 tokens: 1 from the prefill, 19 over >= 3 dispatches of <= 8.
    decodes = [s for s in port if s['name'] == 'batch.decode']
    assert len(decodes) >= 3
    assert sum(s['attrs']['tokens'] for s in decodes) == 19
    for s in port:
        if s['name'].startswith('batch.'):
            assert s['parent_id'] == root.context.span_id
    ft = [s for s in port if s['name'] == 'batch.first_token'][0]
    qw = [s for s in port if s['name'] == 'batch.queue_wait'][0]
    assert ft['start'] == pytest.approx(qw['start'])
    assert ft['end'] >= qw['end']


def test_untraced_submit_records_nothing():
    tcfg = llama.get_config('tiny', dtype=torch.float32)
    engine = batching.BatchingEngine(llama.init_params(tcfg, device='cpu'),
                                     tcfg, slots=2, max_seq=64)
    try:
        engine.generate([1, 2, 3], 4)
    finally:
        engine.close()
    assert _spans() == []


# ---------------------------------------------------------------------
# Replicas
# ---------------------------------------------------------------------


def _post(port, body, headers):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    try:
        conn.request('POST', '/generate', body=json.dumps(body),
                     headers=dict({'Content-Type': 'application/json'},
                                  **headers))
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _replica_spans(port, stream):
    tid, sid = os.urandom(16).hex(), os.urandom(8).hex()
    status, body = _post(port, {'prompt_ids': [5, 6, 7], 'max_new_tokens': 6,
                                'stream': stream},
                         {'traceparent': f'00-{tid}-{sid}-01'})
    assert status == 200, body
    # replica.generate closes after the response is written.
    deadline = time.time() + 10
    while True:
        spans = _spans(tid)
        if any(s['name'] == 'replica.generate' for s in spans) or \
                time.time() > deadline:
            return sid, spans
        time.sleep(0.02)


@pytest.fixture
def jax_replica(monkeypatch):
    """The JAX replica's ``main`` in this process (its server and engine
    captured to stop them), ``--slots 2`` on ``tiny``."""
    from skypilot_tpu.recipes import serve_model as jserve
    servers, engines = [], []

    class Server(jserve.ThreadingHTTPServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            servers.append(self)

    class Engine(jbatching.BatchingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)
    monkeypatch.setattr(jserve, 'ThreadingHTTPServer', Server)
    monkeypatch.setattr(jbatching, 'BatchingEngine', Engine)
    port = _free_port()
    monkeypatch.setattr(sys, 'argv', [
        'serve_model', '--model', 'tiny', '--port', str(port), '--slots',
        '2', '--sampling', 'off'])
    thread = threading.Thread(target=jserve.main, daemon=True)
    thread.start()
    deadline = time.time() + 120
    while not servers:
        assert thread.is_alive() and time.time() < deadline
        time.sleep(0.05)
    try:
        yield port
    finally:
        servers[0].shutdown()
        servers[0].server_close()
        for e in engines:
            e.close()
        thread.join(timeout=30)


@pytest.fixture
def port_replica():
    args = serve_model.parse_args(
        ['--model', 'tiny', '--port', '0', '--device', 'cpu', '--slots',
         '2', '--sampling', 'off'])
    server, _ = serve_model.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        server.engine.close()
        thread.join(timeout=10)


@pytest.mark.parametrize('stream', [False, True])
def test_replica_span_tree_equals_the_jax_replicas(stream, jax_replica,
                                                   port_replica, tmp_path,
                                                   monkeypatch):
    """The load balancer's traceparent is adopted: ``replica.generate``
    (attrs prompt_len, max_new) is its child and the engine's spans are
    ``replica.generate``'s, on both replicas."""
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path / 'port'))
    sid, port = _replica_spans(port_replica, stream)
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path / 'jax'))
    _, want = _replica_spans(jax_replica, stream)
    monkeypatch.delenv('SKYTPU_TRACE_DIR')
    assert _shape(port) == _shape(want)
    gen = [s for s in port if s['name'] == 'replica.generate']
    assert len(gen) == 1 and gen[0]['parent_id'] == sid
    assert gen[0]['attrs'] == {'prompt_len': 3, 'max_new': 6}
    assert {s['name'] for s in port} == {'replica.generate', *BATCH_SPANS}
    assert all(s['parent_id'] == gen[0]['span_id'] for s in port
               if s['name'] != 'replica.generate')
    assert os.listdir(tmp_path / 'port') == [
        f'spans-replica-{os.getpid()}.jsonl']


def test_untraced_replica_request_records_nothing(port_replica):
    status, _ = _post(port_replica, {'prompt_ids': [1, 2], 'max_new_tokens': 3},
                      {})
    assert status == 200
    assert _spans() == []


# ---------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------


def test_train_step_spans_nest_and_close_as_the_jax_wrapper():
    def my_step(state, batch):
        """Step docs."""
        return state, {}

    wrapped = train_lib.instrument_train_step(my_step, tokens_per_step=64)
    with trace.span('job.run', new_trace=True) as root:
        tid = root.context.trace_id
        wrapped(None, {'tokens': None})
        # Between steps the OPEN step span is ambient: work recorded
        # here nests under it.
        trace.record_span('ckpt.save', time.time(), time.time(),
                          trace.current(), attrs={'step': 0, 'bytes': 1})
        wrapped(None, {'tokens': None})
        wrapped(None, {'tokens': None})
    spans = _spans(tid)
    steps = sorted((s for s in spans if s['name'] == 'train.step'),
                   key=lambda s: s['start'])
    # 3 calls close 2 intervals (the histogram observes the same 2).
    assert len(steps) == 2
    assert all(s['parent_id'] == root.context.span_id for s in steps)
    save = [s for s in spans if s['name'] == 'ckpt.save']
    assert len(save) == 1 and save[0]['parent_id'] == steps[0]['span_id']
    assert [s['attrs'] for s in steps] == [{'step': 0, 'tokens': 64},
                                           {'step': 1, 'tokens': 64}]


def test_wrapper_preserves_name_and_doc():
    def my_step(state, batch):
        """Step docs."""
        return state, {}

    w = train_lib.instrument_train_step(my_step)
    assert (w.__name__, w.__doc__, w.inner, w.__wrapped__) == \
        ('my_step', 'Step docs.', my_step, my_step)

    class StepObj:
        def __call__(self, state, batch):
            return state, {}
    assert train_lib.instrument_train_step(StepObj()).__name__ == 'StepObj'


def test_untraced_loop_records_nothing():
    wrapped = train_lib.instrument_train_step(lambda s, b: (s, {}),
                                              tokens_per_step=8)
    for _ in range(3):
        wrapped(None, {})
    assert _spans() == []
