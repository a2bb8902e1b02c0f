"""The port's serving replica (skypilot_torch/recipes/serve_model.py)
on the CPU at ``tiny``: built on port 0, served from a thread, driven
over HTTP, and shut down. Outputs must equal the port's own
``greedy_generate`` under the replica's power-of-two bucketing."""
import http.client
import json
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
    ({'temperature': 0.7}, 'sampling slice'),
    ({'top_p': 0.9}, 'sampling slice'),
    ({'seed': 1}, 'sampling slice'),
    ({'response_format': {'type': 'json_object'}}, 'sampling slice'),
    ({'adapter': 'tenant-a'}, 'multi-LoRA slice'),
    ({'priority': 'batch'}, 'overload slice'),
    ({'timeout_s': 5}, 'overload slice'),
    ({'tenant': 'team-b'}, 'overload slice'),
])
def test_engine_replica_refuses_deferred_fields(engine_replica, field,
                                                slice_name):
    port, _ = engine_replica
    status, _, raw = _request(port, 'POST', '/generate',
                              dict({'prompt_ids': [1, 2]}, **field))
    assert status == 400
    assert slice_name in json.loads(raw)['error']
    # Greedy defaults stay served.
    status, _, _ = _request(port, 'POST', '/generate',
                            {'prompt_ids': [1, 2], 'temperature': 0,
                             'tenant': None, 'max_new_tokens': 2})
    assert status == 200
