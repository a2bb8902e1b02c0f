"""The port's overload control (skypilot_torch/serve/batching.py and the
replica, skypilot_torch/recipes/serve_model.py) on the CPU at ``tiny``
in f32: the cases of ``tests/test_overload_engine.py`` re-targeted at the
port. Where those read the engine's metric counters (which come with the
metrics slice), these hold the typed outcome, the freed blocks and the
``events`` entries instead. Deadlines refuse and reap typed, a cancel
frees KV at the next iteration boundary, bounded admission sheds typed
with a Retry-After, an interactive arrival evicts a queued batch
request, preemption takes the lowest-priority-youngest row, and the
(tenant, priority) deficit round-robin over the prefill budget charges
the same rows in the same order as the JAX engine's. Every request that
completes equals ``greedy_generate``. Over HTTP: 429 with ``Retry-After``,
504 for an expired ``X-Skytpu-Deadline``, 400 for a bad priority, and a
dropped stream cancels its request."""
import http.client
import json
import socket
import threading
import time

import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.serve import batching as jbatching
from skypilot_torch import exceptions
from skypilot_torch.models import decode, llama
from skypilot_torch.recipes import serve_model
from skypilot_torch.serve import batching
from skypilot_torch.serve import overload


@pytest.fixture(scope='module')
def setup():
    config = llama.get_config('tiny', dtype=torch.float32)
    return config, llama.init_params(config, seed=0, device='cpu')


def _reference(params, config, prompt, max_new, max_seq=64):
    return decode.greedy_generate(params, torch.tensor([prompt]), config,
                                  max_new, max_seq=max_seq)[0].tolist()


def _drain(q, timeout=120):
    toks, err = [], None
    while True:
        t = q.get(timeout=timeout)
        if t is None:
            return toks, err
        if isinstance(t, BaseException):
            err = t
            continue
        toks.append(t)


def _engine(params, config, **kw):
    return batching.BatchingEngine(
        params, config, **dict(dict(slots=2, max_seq=64,
                                    steps_per_dispatch=2), **kw))


def _occupy_rows(engine, n, gen=56):
    """Fill the ``n`` decode rows with long requests and wait until they
    are admitted, so later submits QUEUE."""
    qs = [engine.submit([90 + i, 91 + i], gen) for i in range(n)]
    deadline = time.time() + 30
    while engine.pending and time.time() < deadline:
        time.sleep(0.005)
    assert not engine.pending, 'row-fillers never admitted'
    return qs


def _wait_idle(engine, timeout=10):
    deadline = time.time() + timeout
    while engine.pool.used_blocks and time.time() < deadline:
        time.sleep(0.02)
    return engine.pool.used_blocks == 0


class TestDeadlines:

    def test_pre_expired_deadline_refused_typed(self, setup):
        config, params = setup
        engine = _engine(params, config)
        try:
            toks, err = _drain(engine.submit([1, 2, 3], 4,
                                             deadline=time.time() - 1.0),
                               timeout=10)
            assert toks == []
            assert isinstance(err, exceptions.DeadlineExceededError)
            # Never held a row or a block.
            assert engine.pool.used_blocks == 0
            assert not any(e[0] == 'admit' for e in engine.events)
            assert engine.generate([5, 6], 4) == _reference(
                params, config, [5, 6], 4)
        finally:
            engine.close()

    def test_default_timeout_stamps_deadline(self, setup):
        config, params = setup
        engine = _engine(params, config, default_timeout_s=0.0001)
        try:
            toks, err = _drain(engine.submit([1, 2, 3], 60), timeout=30)
            assert isinstance(err, exceptions.DeadlineExceededError)
            assert len(toks) < 60
        finally:
            engine.close()

    def test_mid_decode_expiry_reclaims_blocks(self, setup):
        """A stalled engine loop (each decode dispatch held 0.3 s) blows
        an admitted request's deadline: the sweep fails it typed with a
        ``deadline`` event, reclaims its blocks and keeps serving."""
        config, params = setup
        engine = _engine(params, config)
        dispatch = engine._dispatch_decode

        def stalled():
            ran = dispatch()
            if ran:
                time.sleep(0.3)
            return ran
        engine._dispatch_decode = stalled
        try:
            toks, err = _drain(engine.submit(
                [1, 2, 3], 60, deadline=time.time() + 0.2), timeout=30)
            assert isinstance(err, exceptions.DeadlineExceededError)
            assert toks, 'the request never started decoding'
            assert any(e[0] == 'deadline' for e in engine.events)
            assert _wait_idle(engine)
            engine._dispatch_decode = dispatch
            assert engine.generate([5, 6], 4) == _reference(
                params, config, [5, 6], 4)
        finally:
            engine.close()


class TestCancellation:

    def test_cancel_frees_blocks_and_keeps_neighbors_exact(self, setup):
        config, params = setup
        engine = _engine(params, config)
        try:
            want = _reference(params, config, [9, 8, 7], 24)
            req = engine.submit_request([1, 2, 3], 60)
            survivor = engine.submit([9, 8, 7], 24)
            assert not isinstance(req.out.get(timeout=60), BaseException)
            engine.cancel(req.id)
            toks, err = _drain(req.out, timeout=30)
            assert err is None              # a cancel is silent
            assert len(toks) < 59
            out, err2 = _drain(survivor)
            assert err2 is None and out == want
            assert any(e[0] == 'cancel' for e in engine.events)
            assert _wait_idle(engine)
        finally:
            engine.close()

    def test_cancel_queued_request_never_admits(self, setup):
        config, params = setup
        engine = _engine(params, config)
        try:
            fillers = _occupy_rows(engine, 2)
            req = engine.submit_request([1, 2, 3], 8)
            engine.cancel(req)                # the object form too
            assert _drain(req.out, timeout=30) == ([], None)
            assert engine._queued_tokens == 0
            for q in fillers:
                _drain(q)
            assert not any(e[0] == 'admit' and e[3] == 3
                           for e in engine.events)
        finally:
            engine.close()


class TestBoundedAdmission:

    def test_queue_bound_sheds_typed_with_retry_after(self, setup):
        config, params = setup
        engine = _engine(params, config, max_queued_requests=2)
        try:
            fillers = _occupy_rows(engine, 2)
            held = [engine.submit_request([i + 1, i + 2], 4)
                    for i in range(2)]
            toks, err = _drain(engine.submit_request([7, 8], 4).out,
                               timeout=10)
            assert toks == []
            assert isinstance(err, exceptions.EngineOverloadedError)
            assert 'max_queued_requests' in str(err)
            assert err.retry_after_s >= 1.0
            for i, req in enumerate(held):
                out, err2 = _drain(req.out)
                assert err2 is None
                assert out == _reference(params, config, [i + 1, i + 2], 4)
            for q in fillers:
                _drain(q)
        finally:
            engine.close()

    def test_token_bound_admits_into_empty_queue(self, setup):
        """One oversized request degrades to FIFO (admitted into an empty
        queue); a second queued request trips the token bound."""
        config, params = setup
        engine = _engine(params, config, max_queued_tokens=4)
        try:
            fillers = _occupy_rows(engine, 2)
            big = engine.submit_request([1] * 16, 2)
            toks, err = _drain(engine.submit_request([2, 3], 2).out,
                               timeout=10)
            assert toks == []
            assert isinstance(err, exceptions.EngineOverloadedError)
            assert 'max_queued_tokens' in str(err)
            out, err2 = _drain(big.out)
            assert err2 is None and len(out) == 2
            for q in fillers:
                _drain(q)
        finally:
            engine.close()


class TestPriorities:

    def test_invalid_priority_rejected(self, setup):
        config, params = setup
        engine = _engine(params, config)
        try:
            with pytest.raises(ValueError, match='priority'):
                engine.submit([1, 2], 2, priority='best-effort')
        finally:
            engine.close()

    def test_interactive_arrival_evicts_queued_batch(self, setup):
        config, params = setup
        engine = _engine(params, config, max_queued_requests=2)
        try:
            fillers = _occupy_rows(engine, 2)
            batch_reqs = [engine.submit_request([i + 1, i + 2], 4,
                                                priority='batch')
                          for i in range(2)]
            inter = engine.submit_request([7, 8], 4)
            # The YOUNGEST queued batch request was evicted typed...
            toks, err = _drain(batch_reqs[1].out, timeout=10)
            assert toks == []
            assert isinstance(err, exceptions.EngineOverloadedError)
            assert err.retry_after_s >= 1.0
            # ...and the interactive one took its place.
            out, err2 = _drain(inter.out)
            assert err2 is None
            assert out == _reference(params, config, [7, 8], 4)
            out0, err0 = _drain(batch_reqs[0].out)
            assert err0 is None
            assert out0 == _reference(params, config, [1, 2], 4)
            for q in fillers:
                _drain(q)
        finally:
            engine.close()

    def test_interactive_sheds_when_no_batch_queued(self, setup):
        """Priority is not an unbounded bypass."""
        config, params = setup
        engine = _engine(params, config, max_queued_requests=1)
        try:
            fillers = _occupy_rows(engine, 2)
            engine.submit_request([1, 2], 4)
            toks, err = _drain(engine.submit_request([3, 4], 4).out,
                               timeout=10)
            assert toks == []
            assert isinstance(err, exceptions.EngineOverloadedError)
            for q in fillers:
                _drain(q)
        finally:
            engine.close()

    def test_pool_preemption_completes_both_classes_exact(self, setup):
        """Pool exhaustion under mixed priorities: whoever is bumped is
        requeued and recomputed, and both requests end token-exact (the
        victim order is held below)."""
        config, params = setup
        engine = _engine(params, config, max_seq=48, block_size=16,
                         num_blocks=4, prefix_caching=False,
                         speculative=False)
        try:
            want_b = _reference(params, config, [1] * 14, 24, max_seq=48)
            want_i = _reference(params, config, [2] * 14, 24, max_seq=48)
            batch_q = engine.submit([1] * 14, 24, priority='batch')
            inter_q = engine.submit([2] * 14, 24)
            out_b, err_b = _drain(batch_q)
            out_i, err_i = _drain(inter_q)
            events = list(engine.events)
        finally:
            engine.close()
        assert err_i is None and err_b is None
        assert out_i == want_i and out_b == want_b
        assert any(e[0] == 'preempt' for e in events), events

    def test_pick_victim_lowest_priority_youngest(self, setup):
        """``_pick_victim`` on a stopped engine with hand-set rows, beside
        the JAX engine's on the same rows."""
        config, params = setup
        engine = _engine(params, config, slots=4)
        engine.close()
        rows = [('interactive', 1.0), ('batch', 2.0), ('batch', 3.0),
                ('interactive', 4.0)]

        def victim(eng, cls):
            for i, (prio, t) in enumerate(rows):
                req = cls([1], 1, priority=prio)
                req.submitted_at = t
                eng.slot_req[i] = req
                eng.slot_seq[i] = i
            return eng._pick_victim()
        assert victim(engine, batching._Request) == 2
        jcfg = jllama.get_config('tiny', dtype=jnp.float32)
        jeng = jbatching.BatchingEngine(
            jllama.init_params(jcfg, jax.random.PRNGKey(0)), jcfg, slots=4,
            max_seq=64, speculative=False, prefix_caching=False)
        jeng.close()
        assert victim(jeng, jbatching._Request) == 2
        rows[1:3] = [('interactive', 2.0), ('interactive', 3.0)]
        assert victim(engine, batching._Request) == \
            victim(jeng, jbatching._Request) == 3


def test_prefill_drr_charges_rows_as_the_jax_engine(setup):
    """The (tenant, priority) deficit round-robin on stopped engines with
    the same hand-set rows, budget and weights: over five iterations the
    port charges the same rows, in the same order, as the JAX engine
    (chunk runs recorded, not executed)."""
    config, params = setup
    jcfg = jllama.get_config('tiny', dtype=jnp.float32)
    kw = dict(slots=4, max_seq=256, max_num_batched_tokens=32,
              prefill_chunk=16, tenant_weights={'a': 3.0, 'b': 1.0},
              speculative=False, prefix_caching=False)
    teng = batching.BatchingEngine(params, config, **kw)
    jeng = jbatching.BatchingEngine(
        jllama.init_params(jcfg, jax.random.PRNGKey(0)), jcfg, **kw)
    teng.close()
    jeng.close()
    rows = [('a', 'interactive', 200), ('b', 'interactive', 200),
            ('a', 'batch', 200), ('', 'interactive', 40)]

    def trace(eng, cls):
        eng._stop = False
        charged = []

        def run_row(row):
            bucket = eng._chunk_bucket(eng.slot_total[row] -
                                       eng.slot_off[row])
            eng.slot_off[row] += min(bucket, eng.slot_total[row] -
                                     eng.slot_off[row])
            charged.append(row)
            return bucket
        eng._run_prefill_row = run_row
        for i, (tenant, prio, n) in enumerate(rows):
            eng.slot_req[i] = cls([1] * n, 4, tenant=tenant or None,
                                  priority=prio)
            eng.slot_off[i], eng.slot_total[i], eng.slot_seq[i] = 0, n, i
        for _ in range(5):
            eng._run_prefill_chunks()
            charged.append('|')
        return charged
    got = trace(teng, batching._Request)
    assert got == trace(jeng, jbatching._Request)
    first = got[:got.index('|')]
    assert set(first) <= {0, 1, 2, 3} and len(first) >= 2
    # Interactive tenant a is weighted 3 x 4 against batch a's 1 x 1.
    assert got.count(0) > got.count(2)


# ---------------------------------------------------------------------
# The replica
# ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def replica():
    args = serve_model.parse_args(
        ['--model', 'tiny', '--port', '0', '--device', 'cpu', '--slots',
         '2', '--max-queued-requests', '1'])
    server, _ = serve_model.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1], server.engine
    finally:
        server.shutdown()
        server.server_close()
        server.engine.close()
        thread.join(timeout=10)


def _post(port, body, headers=None):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    try:
        conn.request('POST', '/generate', body=json.dumps(body),
                     headers=dict({'Content-Type': 'application/json'},
                                  **(headers or {})))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def test_replica_overload_flags_and_env(monkeypatch):
    """The flags take their SKYTPU_ENGINE_OVERLOAD_* env stamps as
    defaults; explicit flags win."""
    monkeypatch.setenv('SKYTPU_ENGINE_OVERLOAD_MAX_QUEUED_REQUESTS', '7')
    monkeypatch.setenv('SKYTPU_ENGINE_OVERLOAD_MAX_QUEUED_TOKENS', '900')
    monkeypatch.setenv('SKYTPU_ENGINE_OVERLOAD_DEFAULT_TIMEOUT_S', '2.5')
    args = serve_model.parse_args([])
    assert (args.max_queued_requests, args.max_queued_tokens,
            args.default_timeout_s) == (7, 900, 2.5)
    args = serve_model.parse_args(['--max-queued-requests', '3'])
    assert args.max_queued_requests == 3
    assert overload.DEADLINE_HEADER == 'X-Skytpu-Deadline'
    assert [overload.parse_timeout_s(x) for x in
            ('1.5', 0, -1, 'nan', 'inf', 'x', None)] == \
        [1.5, None, None, None, None, None, None]


def test_replica_answers_429_with_retry_after(replica):
    port, engine = replica
    assert engine.max_queued_requests == 1
    # Once both rows are taken the engine loop waits before its next
    # decode dispatch until the 429 is in: the fillers cannot finish
    # and let the queued request in, however slowly this test's own
    # threads run.
    release = threading.Event()
    dispatch = engine._dispatch_decode  # pylint: disable=protected-access

    def held_dispatch():
        if all(r is not None for r in engine.slot_req):
            release.wait(timeout=60)
        return dispatch()

    engine._dispatch_decode = held_dispatch  # pylint: disable=protected-access
    fillers = [threading.Thread(target=_post, args=(
        port, {'prompt_ids': [90 + i, 91 + i], 'max_new_tokens': 56}))
        for i in range(2)]
    queued = None
    try:
        for t in fillers:
            t.start()
        deadline = time.time() + 30
        while sum(r is not None for r in engine.slot_req) < 2:
            assert time.time() < deadline
            time.sleep(0.005)
        queued = threading.Thread(target=_post, args=(
            port, {'prompt_ids': [1, 2], 'max_new_tokens': 4,
                   'priority': 'batch', 'tenant': 'team-b'}))
        queued.start()
        while not engine.pending:
            assert time.time() < deadline
            time.sleep(0.005)
        status, heads, err = _post(port, {'prompt_ids': [3, 4],
                                          'max_new_tokens': 4,
                                          'priority': 'batch'})
        assert status == 429, err
        assert int(heads['Retry-After']) >= 1
    finally:
        release.set()
        del engine._dispatch_decode  # pylint: disable=protected-access
        for t in fillers + ([queued] if queued else []):
            t.join(timeout=120)


@pytest.mark.parametrize('how', ['header', 'body'])
def test_replica_answers_504_for_an_expired_deadline(replica, how):
    port, _ = replica
    body = {'prompt_ids': [1, 2, 3], 'max_new_tokens': 40}
    headers = None
    if how == 'header':
        headers = {overload.DEADLINE_HEADER: '0.001'}
    else:
        body['timeout_s'] = 0.001
    status, _, err = _post(port, body, headers)
    assert status == 504, err


def test_replica_fields_are_served_and_bad_priority_is_400(replica):
    port, _ = replica
    status, _, out = _post(port, {'prompt_ids': [1, 2, 3],
                                  'max_new_tokens': 3, 'tenant': 'team-a',
                                  'priority': 'batch', 'timeout_s': 60})
    assert status == 200 and len(out['output_ids']) == 3
    status, _, err = _post(port, {'prompt_ids': [1, 2],
                                  'priority': 'best-effort'})
    assert status == 400 and 'priority' in err['error']


def test_replica_dropped_stream_cancels(replica):
    """A client that reads four token events and closes its socket: the
    replica cancels the request (a ``cancel`` event) and its blocks come
    back."""
    port, engine = replica
    sock = socket.create_connection(('127.0.0.1', port), timeout=60)
    body = json.dumps({'prompt_ids': [5, 6, 7], 'max_new_tokens': 60,
                       'stream': True}).encode()
    sock.sendall(b'POST /generate HTTP/1.1\r\nHost: x\r\n'
                 b'Content-Type: application/json\r\n'
                 + f'Content-Length: {len(body)}\r\n\r\n'.encode() + body)
    buf = b''
    while buf.count(b'data: ') < 4:
        chunk = sock.recv(4096)
        assert chunk, 'stream ended early'
        buf += chunk
    sock.close()
    deadline = time.time() + 60
    while not any(e[0] == 'cancel' for e in list(engine.events)):
        assert time.time() < deadline, 'no cancel event'
        time.sleep(0.01)
    assert _wait_idle(engine, timeout=30)
