"""Model serving replica (stdlib HTTP) — the port of
``skypilot_tpu/recipes/serve_model.py``, engine-off greedy path.

Exposes ``GET /`` (readiness) and ``POST /generate`` (greedy decode
through ``models/decode.greedy_generate``: K1-cuda prefill, K4-cuda
decode on the card). Weights are random, made from seed 0. The port
listens on ``--port``, default ``SKYTPU_REPLICA_PORT`` or 8080.

    python -m skypilot_torch.recipes.serve_model --model llama3-8b

The batching engine (``--slots``), ``--tp``, ``--quant``,
``--kv-int8``, ``--checkpoint-dir``, tracing spans and the metrics
publisher are not ported yet (ROADMAP.md).
"""
import argparse
import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple

import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import decode, llama

MAX_NEW_TOKENS_CAP = 512

SAMPLED_REQUIRES_ENGINE = (
    'sampled/structured decoding (temperature > 0 or response_format) '
    'requires the batching engine — start the replica with --slots > 0')
ADAPTER_REQUIRES_ENGINE = ('adapter requests require the batching engine '
                           '(--slots > 0)')


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='tiny')
    parser.add_argument('--port', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_REPLICA_PORT', '8080')))
    parser.add_argument('--max-new-tokens', type=int, default=32)
    parser.add_argument('--device', default=device_lib.DEFAULT_DEVICE,
                        help="where the model runs: 'cuda' (the kernels;"
                             " raises without CUDA) or 'cpu' (the plain "
                             'PyTorch path)')
    return parser.parse_args(argv)


def _parse_body(body, config: llama.LlamaConfig, default_max_new: int):
    """The request fields of the engine-off path; raises ValueError,
    KeyError or TypeError on a malformed body (answered 400)."""
    if not isinstance(body, dict):
        raise TypeError(f'body must be a JSON object, got '
                        f'{type(body).__name__}')
    prompt_ids = [int(t) % config.vocab_size for t in body['prompt_ids']]
    if not prompt_ids:
        raise ValueError('prompt_ids must not be empty')
    max_new = min(int(body.get('max_new_tokens', default_max_new)),
                  MAX_NEW_TOKENS_CAP)
    temperature = body.get('temperature')
    if temperature is not None:
        if isinstance(temperature, bool) or \
                not isinstance(temperature, (int, float)):
            raise ValueError(f'temperature must be a number, got '
                             f'{temperature!r}')
        temperature = float(temperature)
        if temperature < 0.0:
            raise ValueError(f'temperature must be >= 0, got '
                             f'{temperature}')
    top_p = body.get('top_p')
    if top_p is not None:
        if isinstance(top_p, bool) or not isinstance(top_p, (int, float)):
            raise ValueError(f'top_p must be a number, got {top_p!r}')
        if not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f'top_p must be in (0, 1], got {top_p}')
    seed = body.get('seed')
    if seed is not None and (isinstance(seed, bool)
                             or not isinstance(seed, int)):
        raise ValueError(f'seed must be an integer, got {seed!r}')
    response_format = body.get('response_format')
    if response_format is not None and \
            not isinstance(response_format, dict):
        raise ValueError(f'response_format must be an object, got '
                         f'{type(response_format).__name__}')
    eos_id = body.get('eos_id')
    if eos_id is not None:
        eos_id = int(eos_id)
    adapter = body.get('adapter')
    return dict(prompt_ids=prompt_ids, max_new=max_new,
                temperature=temperature, response_format=response_format,
                eos_id=eos_id, adapter=adapter,
                stream=bool(body.get('stream')))


def build_server(args: argparse.Namespace
                 ) -> Tuple[ThreadingHTTPServer,
                            Callable[..., List[int]]]:
    """Build the model, warm it up, and bind the HTTP server on
    ``args.port`` (0 picks a free one). Returns (server, generate);
    the caller runs ``server.serve_forever()`` and shuts it down."""
    dev = device_lib.resolve_device(args.device)
    config = llama.get_config(args.model)
    params = llama.init_params(config, seed=0, device=dev)
    lock = threading.Lock()

    def generate(prompt_ids, max_new, eos_id=None) -> List[int]:
        """Greedy generation. Requested lengths are bucketed to powers
        of two (as the JAX replica does, where each length is a
        compile) and truncated; the eos rule is applied on the host to
        the full bucket, which yields the same ids as decoding with
        ``eos_id``."""
        tokens = torch.tensor([prompt_ids], dtype=torch.long, device=dev)
        max_new = min(max_new, config.max_seq_len - tokens.shape[1])
        if max_new <= 0:
            return []
        bucket = 1
        while bucket < max_new:
            bucket *= 2
        bucket = min(bucket, config.max_seq_len - tokens.shape[1])
        with lock:
            out = decode.greedy_generate(params, tokens, config,
                                         max_new_tokens=bucket)
        out = out[0, :max_new].tolist()
        if eos_id is not None and eos_id in out:
            out = out[:out.index(eos_id) + 1]
        return out

    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, fmt, *largs):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == '/':
                self._json({'status': 'ok', 'model': args.model})
            else:
                self._json({'error': 'not found'}, 404)

        def do_POST(self):  # noqa: N802
            if self.path != '/generate':
                self._json({'error': 'not found'}, 404)
                return
            length = int(self.headers.get('Content-Length', '0'))
            try:
                req = _parse_body(json.loads(self.rfile.read(length)),
                                  config, args.max_new_tokens)
            except (ValueError, KeyError, TypeError) as e:
                self._json({'error': f'bad request: {e}'}, 400)
                return
            sampled = ((req['temperature'] is not None and
                        req['temperature'] > 0.0) or
                       req['response_format'] is not None)
            if sampled:
                self._json({'error': SAMPLED_REQUIRES_ENGINE}, 400)
                return
            if req['adapter'] is not None:
                self._json({'error': ADAPTER_REQUIRES_ENGINE}, 400)
                return
            try:
                out = generate(req['prompt_ids'], req['max_new'],
                               eos_id=req['eos_id'])
            except Exception as e:  # pylint: disable=broad-except
                # A replica fault: answer 500 (with the traceback on
                # stderr) instead of tearing the connection down.
                traceback.print_exc()
                self._json({'error': f'{type(e).__name__}: {e}'}, 500)
                return
            if req['stream']:
                self._stream_burst(out)
                return
            self._json({'output_ids': out})

        def _stream_burst(self, out):
            # No engine: stream-compatible response with the whole
            # generation as one event burst.
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            payload = b''.join(f'data: {t}\n\n'.encode()
                               for t in out) + b'data: [DONE]\n\n'
            self.send_header('Content-Length', str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    # Warm up before declaring readiness: the first request would
    # otherwise pay the kernel build and the allocator's first growth.
    generate([1, 2, 3], 2)
    server = ThreadingHTTPServer(('0.0.0.0', args.port), Handler)
    server.daemon_threads = True
    return server, generate


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    server, _ = build_server(args)
    print(f'serve_model ready on :{server.server_address[1]} '
          f'(model {args.model}, device {args.device})', flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == '__main__':
    main()
