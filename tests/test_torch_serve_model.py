"""The port's serving replica (skypilot_torch/recipes/serve_model.py)
on the CPU at ``tiny``: built on port 0, served from a thread, driven
over HTTP, and shut down. Outputs must equal the port's own
``greedy_generate`` under the replica's power-of-two bucketing; with
the engine, sampled and constrained requests must equal the engine's
own answer for the same knobs, and bad knobs, bad grammars and a
``--sampling off`` replica answer 400; the overload and adapter fields
are served (their statuses are held in test_torch_overload.py and
test_torch_adapters.py). ``--checkpoint-dir`` warm-starts from a lineage
the JAX engine wrote, token-equal to the JAX replica's merged params,
and a directory with no committed step exits naming it."""
import http.client
import json
import re
import threading

import pytest
import torch

from skypilot_torch.models import decode, llama
from skypilot_torch.recipes import serve_model


@pytest.fixture(scope='module')
def replica():
    args = serve_model.parse_args(['--model', 'tiny', '--port', '0',
                                   '--device', 'cpu'])
    server, generate = serve_model.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1], generate
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
    try:
        data = body if isinstance(body, (bytes, type(None))) else \
            json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        return resp.status, resp.getheader('Content-Type'), resp.read()
    finally:
        conn.close()


def _expected(prompt_ids, max_new):
    """The replica's greedy path: seed-0 weights, bucket = next power
    of two, truncated to max_new."""
    config = llama.get_config('tiny')
    params = llama.init_params(config, seed=0, device='cpu')
    bucket = 1
    while bucket < max_new:
        bucket *= 2
    out = decode.greedy_generate(params, torch.tensor([prompt_ids]),
                                 config, bucket)
    return out[0, :max_new].tolist()


def test_readiness(replica):
    port, _ = replica
    status, _, body = _request(port, 'GET', '/')
    assert status == 200
    assert json.loads(body) == {'status': 'ok', 'model': 'tiny'}


def test_generate_matches_greedy_generate(replica):
    port, _ = replica
    prompt = [5, 9, 700, 3, 1]  # 700 is taken modulo the vocab (512)
    status, ctype, body = _request(port, 'POST', '/generate',
                                   {'prompt_ids': prompt,
                                    'max_new_tokens': 5})
    assert status == 200 and ctype == 'application/json'
    want = _expected([t % 512 for t in prompt], 5)
    assert json.loads(body) == {'output_ids': want}
    # eos_id truncates after the first eos, inclusive.
    status, _, body = _request(port, 'POST', '/generate',
                               {'prompt_ids': prompt, 'max_new_tokens': 5,
                                'eos_id': want[2]})
    assert json.loads(body)['output_ids'] == want[:want.index(want[2]) + 1]


def test_stream_burst_format(replica):
    port, generate = replica
    status, ctype, body = _request(port, 'POST', '/generate',
                                   {'prompt_ids': [1, 2, 3],
                                    'max_new_tokens': 3, 'stream': True})
    assert status == 200 and ctype == 'text/event-stream'
    want = generate([1, 2, 3], 3)
    assert body.decode() == ''.join(f'data: {t}\n\n' for t in want) + \
        'data: [DONE]\n\n'


@pytest.mark.parametrize('body,needle', [
    (b'not json', 'bad request'),
    ({'max_new_tokens': 3}, 'bad request'),
    ({'prompt_ids': []}, 'bad request'),
    ({'prompt_ids': [1], 'temperature': 'hot'}, 'bad request'),
    ({'prompt_ids': [1], 'temperature': 0.7},
     serve_model.SAMPLED_REQUIRES_ENGINE),
    ({'prompt_ids': [1], 'response_format': {'type': 'json_object'}},
     serve_model.SAMPLED_REQUIRES_ENGINE),
    ({'prompt_ids': [1], 'adapter': 'tenant-a'},
     serve_model.ADAPTER_REQUIRES_ENGINE),
])
def test_bad_requests_answer_400(replica, body, needle):
    port, _ = replica
    status, _, raw = _request(port, 'POST', '/generate', body)
    assert status == 400
    assert needle in json.loads(raw)['error']


def test_unknown_paths_answer_404(replica):
    port, _ = replica
    assert _request(port, 'GET', '/nope')[0] == 404
    assert _request(port, 'POST', '/nope', {'prompt_ids': [1]})[0] == 404


def test_refusal_texts_match_the_jax_replica():
    """The engine-off refusals keep the JAX replica's wording, which
    clients and the load balancer already see."""
    import inspect

    from skypilot_tpu.recipes import serve_model as jax_serve
    src = ' '.join(inspect.getsource(jax_serve).split())
    for text in (serve_model.SAMPLED_REQUIRES_ENGINE,
                 serve_model.ADAPTER_REQUIRES_ENGINE):
        words = text.split()
        # The JAX source splits each message over string literals.
        assert all(w in src for w in words), text


# ---------------------------------------------------------------------
# The --slots replica: requests share the batching engine
# ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def engine_replica():
    args = serve_model.parse_args(['--model', 'tiny', '--port', '0',
                                   '--device', 'cpu', '--slots', '4'])
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
    assert not thread.is_alive()
    assert not server.engine.thread.is_alive()


def _greedy(prompt_ids, max_new):
    config = llama.get_config('tiny')
    params = llama.init_params(config, seed=0, device='cpu')
    return decode.greedy_generate(params, torch.tensor([prompt_ids]),
                                  config, max_new)[0].tolist()


def test_engine_replica_answers_concurrent_requests(engine_replica):
    port, engine = engine_replica
    prompts = [[(i * 37 + j * 11) % 500 + 1 for j in range(3 + 5 * i)]
               for i in range(6)]
    results = [None] * len(prompts)

    def post(i):
        results[i] = _request(port, 'POST', '/generate',
                              {'prompt_ids': prompts[i],
                               'max_new_tokens': 6 + i,
                               'stream': i % 2 == 1})

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, (status, ctype, body) in enumerate(results):
        assert status == 200
        want = _greedy(prompts[i], 6 + i)
        if i % 2:
            assert ctype == 'text/event-stream'
            assert body.decode() == ''.join(
                f'data: {t}\n\n' for t in want) + 'data: [DONE]\n\n'
        else:
            assert json.loads(body) == {'output_ids': want}
    # More requests than slots at once: some waited for a free row.
    assert sum(e[0] == 'admit' for e in engine.events) >= len(prompts)


def test_engine_replica_sets_prefix_headers(engine_replica):
    port, _ = engine_replica
    prompt = [(i * 13) % 400 + 2 for i in range(40)]
    heads = []
    for _ in range(2):
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
        try:
            conn.request('POST', '/generate',
                         body=json.dumps({'prompt_ids': prompt,
                                          'max_new_tokens': 3}),
                         headers={'Content-Type': 'application/json'})
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read()
            heads.append((int(resp.getheader('X-Skytpu-Prefix-Hits')),
                          int(resp.getheader('X-Skytpu-Prefix-Misses'))))
        finally:
            conn.close()
    # 40 tokens in blocks of 16: the repeat reuses both full blocks.
    assert heads == [(0, 3), (2, 1)]


@pytest.mark.parametrize('field,slice_name', [
    ({'adapter': 'tenant-a'}, 'multi-LoRA slice'),
    ({'priority': 'batch'}, 'overload slice'),
    ({'timeout_s': 5}, 'overload slice'),
    ({'tenant': 'team-b'}, 'overload slice'),
])
def test_engine_replica_refuses_deferred_fields(engine_replica, field,
                                                slice_name):
    """The fields of the overload and multi-LoRA slices, answered 400
    until those slices were ported, are served as the JAX replica serves
    them: ``priority``, ``timeout_s`` and ``tenant`` get the greedy
    answer, and an ``adapter`` on a replica without ``--adapter-dir`` is
    refused 413 (the engine can never serve it)."""
    port, _ = engine_replica
    status, _, raw = _request(port, 'POST', '/generate',
                              dict({'prompt_ids': [1, 2],
                                    'max_new_tokens': 2}, **field))
    if 'adapter' in field:
        assert status == 413, slice_name
        assert 'serves no adapters' in json.loads(raw)['error']
    else:
        assert status == 200, slice_name
        assert json.loads(raw) == {'output_ids': _greedy([1, 2], 2)}
    # Greedy defaults stay served.
    status, _, _ = _request(port, 'POST', '/generate',
                            {'prompt_ids': [1, 2], 'temperature': 0,
                             'tenant': None, 'max_new_tokens': 2})
    assert status == 200


# ---------------------------------------------------------------------
# Sampled and constrained requests through the engine
# ---------------------------------------------------------------------

GV_EOS = 40


def _grammar_vocab():
    """Token texts for the tiny (512) vocab: a JSON lexicon at ids 1..,
    everything else without text, EOS at 40."""
    gv = [None] * 512
    syms = list('0123456789{}[],:."ab') + ['true', 'false', 'null']
    for i, sym in enumerate(syms, start=1):
        gv[i] = sym
    return gv


def _replica(argv):
    args = serve_model.parse_args(['--model', 'tiny', '--port', '0',
                                   '--device', 'cpu', '--slots', '3']
                                  + argv)
    server, _ = serve_model.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    server.engine.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.fixture(scope='module')
def grammar_replica(tmp_path_factory):
    path = tmp_path_factory.mktemp('vocab') / 'vocab.json'
    path.write_text(json.dumps(_grammar_vocab()))
    server, thread = _replica(['--grammar-vocab', str(path)])
    try:
        yield server.server_address[1], server.engine
    finally:
        _stop(server, thread)


def _events(body: bytes):
    events = [e[len('data: '):] for e in body.decode().split('\n\n') if e]
    assert events[-1] == '[DONE]', events
    return [int(e) for e in events[:-1]]


@pytest.mark.parametrize('stream', [False, True])
def test_engine_replica_serves_sampling_fields(engine_replica, stream):
    port, engine = engine_replica
    knobs = dict(temperature=0.9, top_p=0.8, seed=2 ** 31 + 17)
    status, ctype, body = _request(port, 'POST', '/generate', dict(
        {'prompt_ids': [4, 8, 15, 16], 'max_new_tokens': 9,
         'stream': stream}, **knobs))
    assert status == 200
    got = _events(body) if stream else json.loads(body)['output_ids']
    assert got == engine.generate([4, 8, 15, 16], 9, **knobs)
    greedy = engine.generate([4, 8, 15, 16], 9)
    assert got != greedy


def test_unseeded_sampled_requests_draw_their_own_seed(engine_replica):
    port, _ = engine_replica
    outs = []
    for _ in range(2):
        status, _, body = _request(port, 'POST', '/generate', {
            'prompt_ids': [1, 2, 3], 'max_new_tokens': 12,
            'temperature': 1.0})
        assert status == 200
        outs.append(json.loads(body)['output_ids'])
    assert outs[0] != outs[1]


@pytest.mark.parametrize('field', [
    {'temperature': -1}, {'temperature': 'hot'}, {'temperature': True},
    {'top_p': 0}, {'top_p': 1.5}, {'top_p': 'x'}, {'seed': 1.5},
    {'seed': True}, {'response_format': 'json'},
])
def test_engine_replica_answers_bad_knobs_400(engine_replica, field):
    port, _ = engine_replica
    status, _, raw = _request(port, 'POST', '/generate',
                              dict({'prompt_ids': [1, 2]}, **field))
    assert status == 400
    assert next(iter(field)) in json.loads(raw)['error']


@pytest.mark.parametrize('stream', [False, True])
def test_vocab_less_replica_answers_response_format_400(engine_replica,
                                                        stream):
    port, _ = engine_replica
    status, _, raw = _request(port, 'POST', '/generate', {
        'prompt_ids': [1, 2], 'eos_id': 3, 'stream': stream,
        'response_format': {'type': 'regex', 'pattern': 'a'}})
    assert status == 400
    assert 'grammar_vocab' in json.loads(raw)['error']


@pytest.mark.parametrize('stream', [False, True])
def test_grammar_replica_serves_response_format(grammar_replica, stream):
    port, _ = grammar_replica
    gv = _grammar_vocab()
    status, _, body = _request(port, 'POST', '/generate', {
        'prompt_ids': [1, 2, 3], 'max_new_tokens': 24, 'eos_id': GV_EOS,
        'temperature': 0.8, 'seed': 3, 'stream': stream,
        'response_format': {'type': 'regex',
                            'pattern': r'\{"a":[0-9]{1,4}\}'}})
    assert status == 200
    toks = _events(body) if stream else json.loads(body)['output_ids']
    text = ''.join(gv[t] or '' for t in toks if t != GV_EOS)
    assert re.fullmatch(r'\{"a":[0-9]{1,4}\}', text), text


def test_grammar_replica_serves_json_schema_greedy(grammar_replica):
    """An unseeded constrained request at temperature 0 (greedy under
    the mask) gives JSON that fits its schema."""
    port, _ = grammar_replica
    gv = _grammar_vocab()
    status, _, body = _request(port, 'POST', '/generate', {
        'prompt_ids': [4, 5, 6], 'max_new_tokens': 24, 'eos_id': GV_EOS,
        'response_format': {'type': 'json_schema', 'schema': {
            'type': 'object', 'properties': {'a': {'type': 'boolean'}}}}})
    assert status == 200
    toks = json.loads(body)['output_ids']
    parsed = json.loads(''.join(gv[t] or '' for t in toks if t != GV_EOS))
    assert isinstance(parsed.get('a'), bool)


@pytest.mark.parametrize('rf,extra,needle', [
    ({'type': 'xml'}, {'eos_id': GV_EOS}, 'type'),
    ({'type': 'regex', 'pattern': ''}, {'eos_id': GV_EOS}, 'pattern'),
    ({'type': 'regex', 'pattern': 'a+'}, {}, 'eos_id'),
])
def test_grammar_replica_answers_bad_grammars_400(grammar_replica, rf,
                                                  extra, needle):
    port, engine = grammar_replica
    status, _, raw = _request(port, 'POST', '/generate', dict(
        {'prompt_ids': [1, 2], 'response_format': rf}, **extra))
    assert status == 400
    assert needle in json.loads(raw)['error']
    assert engine.thread.is_alive()


def test_sampling_off_replica_refuses_sampled_requests():
    server, thread = _replica(['--sampling', 'off'])
    try:
        port = server.server_address[1]
        for field in ({'temperature': 0.7},
                      {'response_format': {'type': 'regex',
                                           'pattern': 'a'},
                       'eos_id': 3}):
            status, _, raw = _request(port, 'POST', '/generate',
                                      dict({'prompt_ids': [1, 2]},
                                           **field))
            assert status == 400
            assert 'sampling=False' in json.loads(raw)['error']
        status, _, body = _request(port, 'POST', '/generate', {
            'prompt_ids': [1, 2, 3], 'max_new_tokens': 4, 'seed': 5,
            'top_p': 0.5})
        assert status == 200
        assert json.loads(body)['output_ids'] == _greedy([1, 2, 3], 4)
    finally:
        _stop(server, thread)


def test_sampling_flags_read_their_env(monkeypatch, tmp_path):
    monkeypatch.delenv('SKYTPU_ENGINE_SAMPLING', raising=False)
    monkeypatch.delenv('SKYTPU_ENGINE_SAMPLING_GRAMMAR_VOCAB',
                       raising=False)
    args = serve_model.parse_args([])
    assert args.sampling == 'on' and args.grammar_vocab == ''
    monkeypatch.setenv('SKYTPU_ENGINE_SAMPLING', 'off')
    monkeypatch.setenv('SKYTPU_ENGINE_SAMPLING_GRAMMAR_VOCAB', '/v.json')
    args = serve_model.parse_args([])
    assert args.sampling == 'off' and args.grammar_vocab == '/v.json'
    bad = tmp_path / 'vocab.json'
    bad.write_text('{"a": 1}')
    with pytest.raises(SystemExit):
        serve_model._load_grammar_vocab(str(bad))


# ---------------------------------------------------------------------
# --checkpoint-dir: the warm start from a finetune lineage
# ---------------------------------------------------------------------


def _jax_lineage(path):
    """A LoRA TrainState written by the JAX package's checkpoint engine
    (the JAX finetune recipe's artifact) with non-zero adapters, and the
    greedy tokens the JAX replica serves from it: its
    ``restore_latest_raw`` + ``merge_lora_host`` + cast, then
    ``greedy_generate``."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from skypilot_tpu.data import checkpoint as jfacade
    from skypilot_tpu.models import decode as jdecode
    from skypilot_tpu.models import llama as jllama
    from skypilot_tpu.parallel import lora as jlora
    from skypilot_tpu.parallel import mesh as jmesh
    from skypilot_tpu.parallel import train as jtrain
    jcfg = jllama.get_config('tiny')
    mesh = jmesh.make_mesh(jmesh.MeshConfig(), devices=jax.devices()[:1])
    state, _ = jtrain.init_train_state(jcfg, mesh, jax.random.PRNGKey(5),
                                       lora_rank=4)
    rng = np.random.default_rng(6)
    lora = {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.05, v.dtype)
                if k.endswith('_b') else v) for k, v in state.lora.items()}
    state = dataclasses.replace(state, lora=lora)
    ckpt = jfacade.CheckpointManager(path, use_task_namespace=False,
                                     process_index=0, process_count=1)
    ckpt.maybe_save(0, state)
    ckpt.wait()
    ckpt.close()
    raw = jfacade.CheckpointManager(
        path, use_task_namespace=False).restore_latest_raw(
            keys=('params', 'lora'))
    merged = jlora.merge_lora_host(raw['params'], raw['lora'])
    merged = jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x).astype(jcfg.dtype)), merged)
    prompt = jnp.asarray([[5, 9, 200, 3, 1, 77]])
    base = jdecode.greedy_generate(state.params, prompt, jcfg, 8)
    want = jdecode.greedy_generate(merged, prompt, jcfg, 8)
    return np.asarray(prompt)[0].tolist(), np.asarray(want)[0].tolist(), \
        np.asarray(base)[0].tolist()


@pytest.mark.parametrize('slots', ['0', '2'])
def test_checkpoint_dir_warm_start_matches_the_jax_replica(tmp_path, slots):
    lineage = str(tmp_path / 'managed-2-0')
    prompt, want, base = _jax_lineage(lineage)
    assert want != base  # the adapters move the tokens
    args = serve_model.parse_args(['--model', 'tiny', '--port', '0',
                                   '--device', 'cpu', '--slots', slots,
                                   '--checkpoint-dir', lineage])
    server, generate = serve_model.build_server(args)
    try:
        assert generate(prompt, 8) == want
    finally:
        server.server_close()
        if server.engine is not None:
            server.engine.close()


def test_checkpoint_dir_without_a_step_names_the_resolved_dir(tmp_path):
    (tmp_path / 'managed-3-0').mkdir()
    args = serve_model.parse_args(['--model', 'tiny', '--port', '0',
                                   '--device', 'cpu', '--checkpoint-dir',
                                   str(tmp_path)])
    with pytest.raises(SystemExit) as excinfo:
        serve_model.build_server(args)
    msg = str(excinfo.value)
    assert f'no committed checkpoint found in {tmp_path}' in msg
    assert 'managed-3-0' in msg and 'task-id subdirectory' in msg
