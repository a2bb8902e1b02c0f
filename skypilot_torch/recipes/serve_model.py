"""Model serving replica (stdlib HTTP) — the port of
``skypilot_tpu/recipes/serve_model.py``.

Exposes ``GET /`` (readiness) and ``POST /generate`` (greedy, sampled
and grammar-constrained decode; ``"stream": true`` for server-sent
events). Weights are random, made from seed 0. The port listens on
``--port``, default ``SKYTPU_REPLICA_PORT`` or 8080.

    python -m skypilot_torch.recipes.serve_model --model llama3-8b --slots 8

With ``--slots N > 0`` requests share the continuous-batching engine
(``serve/batching.BatchingEngine``: paged KV pool, chunked prefill,
prefix caching, speculative verify; K5 and K4-paged on the card), tokens
stream as the engine emits them, and each engine response carries the
``X-Skytpu-Prefix-Hits/Misses`` headers. The engine serves the body's
``temperature``, ``top_p``, ``seed`` and ``response_format`` (``--sampling
on``, the default; ``--grammar-vocab`` names the JSON list of token
texts that ``response_format`` needs); an unseeded sampled request draws
its seed from ``os.urandom`` here, and a bad knob or grammar is answered
400.

Overload control (the JAX replica's): the body's ``timeout_s`` or the
``X-Skytpu-Deadline`` header (seconds remaining, which wins) becomes an
absolute deadline on this process's clock; ``tenant`` and ``priority``
(``interactive`` or ``batch``) ride to the engine; ``--max-queued-
requests``/``--max-queued-tokens``/``--default-timeout-s`` (env
``SKYTPU_ENGINE_OVERLOAD_*``) bound it. A shed request answers 429 with
``Retry-After`` (at least 1 s), an expired one 504, and a streaming
client that drops its connection cancels its request. Multi-LoRA:
``--adapter-dir``/``--adapter-capacity``/``--preload-adapters`` (env
``SKYTPU_ENGINE_ADAPTER_*``) give the engine an adapter registry and
resident set; the body's ``adapter`` picks one (404 for an unknown id,
413 for one the engine can never serve), and an adapter response carries
``X-Skytpu-Adapter-Hits``/``-Loads``.

With ``--slots 0`` each request runs alone through
``models/decode.greedy_generate`` (K1-cuda prefill, K4-cuda decode), and
sampled, constrained or adapter requests are refused 400, as the JAX
replica does.

``--quant int8`` serves int8 weights (``models/quant.init_quantized``,
leaf by leaf on the device); ``--kv-int8`` gives the engine an int8 KV
pool (K4 and K5 run their int8 forms). ``--tp > 1``,
``--checkpoint-dir``, tracing spans and the metrics publisher are not
ported yet (ROADMAP.md).
"""
import argparse
import json
import os
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple

import torch

from skypilot_torch import device as device_lib
from skypilot_torch import exceptions
from skypilot_torch.models import decode, llama, quant
from skypilot_torch.serve import batching
from skypilot_torch.serve import overload as overload_lib
from skypilot_torch.serve import prefix_hash
from skypilot_torch.serve.adapters import AdapterRegistry
from skypilot_torch.serve.sampling import GrammarError

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
    parser.add_argument('--tp', type=int, default=1,
                        help='tensor-parallel degree for models too '
                             'big for one chip (shards params + KV '
                             'cache over the tp mesh axis); not ported '
                             'yet: only 1 runs')
    parser.add_argument('--quant', choices=['none', 'int8'],
                        default='none',
                        help='weight-only quantization (halves '
                             'decode weight bandwidth)')
    parser.add_argument('--kv-int8', action='store_true',
                        help='int8 KV cache for the batching engine '
                             '(halves decode HBM traffic)')
    parser.add_argument('--device', default=device_lib.DEFAULT_DEVICE,
                        help="where the model runs: 'cuda' (the kernels;"
                             " raises without CUDA) or 'cpu' (the plain "
                             'PyTorch path)')
    parser.add_argument('--slots', type=int, default=0,
                        help='enable continuous batching with this many '
                             'concurrent decode rows (0: one request at '
                             'a time through greedy_generate)')
    parser.add_argument('--block-size', type=int, default=16,
                        help='paged-KV block granularity in tokens')
    parser.add_argument('--num-blocks', type=int, default=0,
                        help='KV pool size in blocks; 0 sizes the pool so '
                             'every row reaches max_seq (no preemption)')
    parser.add_argument('--max-batched-tokens', type=int, default=2048,
                        help='per-iteration prefill token budget between '
                             'decode dispatches')
    parser.add_argument('--prefix-caching', choices=['on', 'off'],
                        default='on',
                        help='automatic prefix caching on the paged pool')
    parser.add_argument('--speculative', choices=['on', 'off'],
                        default='on',
                        help='self-speculative n-gram drafting + batched '
                             'multi-token verify')
    parser.add_argument('--draft-k', type=int, default=8,
                        help='max drafted tokens per row per verify (0 '
                             'disables speculation)')
    parser.add_argument('--sampling', choices=['on', 'off'],
                        default=('on' if os.environ.get(
                            'SKYTPU_ENGINE_SAMPLING', '1')
                            not in ('0', 'off', 'false') else 'off'),
                        help='batch-invariant sampled decode on the '
                             'engine: per-request temperature/top_p/'
                             'seed as per-row tensors, keyed (seed, '
                             'position) (off: the engine refuses sampled '
                             'and constrained requests)')
    parser.add_argument('--grammar-vocab',
                        default=os.environ.get(
                            'SKYTPU_ENGINE_SAMPLING_GRAMMAR_VOCAB', ''),
                        help='path to a JSON list mapping token id -> '
                             'token string (null for ids with no text); '
                             'enables response_format grammar-constrained '
                             'decoding (empty: such requests are '
                             'refused)')
    # Overload control (service YAML `overload:`, stamped as
    # SKYTPU_ENGINE_OVERLOAD_*): 0 = unbounded / no default deadline.
    parser.add_argument('--max-queued-requests', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_ENGINE_OVERLOAD_MAX_QUEUED_REQUESTS',
                            '0')),
                        help='bounded admission: refuse (429) past this '
                             'many queued requests (0: unbounded)')
    parser.add_argument('--max-queued-tokens', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_ENGINE_OVERLOAD_MAX_QUEUED_TOKENS',
                            '0')),
                        help='bounded admission: refuse (429) past this '
                             'many queued prompt tokens (0: unbounded)')
    parser.add_argument('--default-timeout-s', type=float,
                        default=float(os.environ.get(
                            'SKYTPU_ENGINE_OVERLOAD_DEFAULT_TIMEOUT_S',
                            '0')),
                        help='deadline stamped on requests that carry '
                             'none; expired requests answer 504 (0: no '
                             'default deadline)')
    # Multi-LoRA (service YAML `engine.adapters:`, stamped as
    # SKYTPU_ENGINE_ADAPTER_*).
    parser.add_argument('--adapter-dir',
                        default=os.environ.get('SKYTPU_ENGINE_ADAPTER_DIR',
                                               ''),
                        help='adapter registry base dir: every '
                             'subdirectory holding a committed LoRA '
                             'checkpoint is a servable adapter named by '
                             'the subdirectory')
    parser.add_argument('--adapter-capacity', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_ENGINE_ADAPTER_CAPACITY', '0')),
                        help='device-resident adapter slots (LRU with '
                             'in-flight pinning; 0 disables adapter '
                             'serving)')
    parser.add_argument('--preload-adapters',
                        default=os.environ.get(
                            'SKYTPU_ENGINE_ADAPTER_PRELOAD', ''),
                        help='comma-separated adapter ids to load before '
                             'readiness')
    args = parser.parse_args(argv)
    if args.quant == 'int8' and args.tp > 1:
        # Reject before the (expensive) init, as the JAX replica does.
        parser.error('--quant int8 with --tp > 1 is not supported yet')
    return args


def _number(body, name):
    x = body.get(name)
    if x is not None and (isinstance(x, bool)
                          or not isinstance(x, (int, float))):
        raise ValueError(f'{name} must be a number, got {x!r}')
    return x


def _parse_body(body, config: llama.LlamaConfig, default_max_new: int):
    """The request fields; raises ValueError, KeyError or TypeError on a
    malformed body (answered 400)."""
    if not isinstance(body, dict):
        raise TypeError(f'body must be a JSON object, got '
                        f'{type(body).__name__}')
    prompt_ids = [int(t) % config.vocab_size for t in body['prompt_ids']]
    if not prompt_ids:
        raise ValueError('prompt_ids must not be empty')
    max_new = min(int(body.get('max_new_tokens', default_max_new)),
                  MAX_NEW_TOKENS_CAP)
    temperature = _number(body, 'temperature')
    if temperature is not None:
        temperature = float(temperature)
        if temperature < 0.0:
            raise ValueError(f'temperature must be >= 0, got '
                             f'{temperature}')
    top_p = _number(body, 'top_p')
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
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
    tenant = body.get('tenant')
    adapter = body.get('adapter')
    priority = str(body.get('priority', 'interactive'))
    if priority not in batching.PRIORITIES:
        raise ValueError(f'priority must be one of {batching.PRIORITIES}, '
                         f'got {priority!r}')
    return dict(prompt_ids=prompt_ids, max_new=max_new,
                temperature=temperature, top_p=top_p, seed=seed,
                response_format=response_format, eos_id=eos_id,
                adapter=None if adapter is None else str(adapter),
                tenant=None if tenant is None else str(tenant),
                priority=priority,
                timeout_s=overload_lib.parse_timeout_s(
                    body.get('timeout_s')),
                stream=bool(body.get('stream')))


def _deadline(headers, req) -> Optional[float]:
    """The request's absolute deadline on this process's clock: the
    ``X-Skytpu-Deadline`` header (the load balancer's remaining budget,
    already decremented for the hop) wins over the body's
    ``timeout_s``; both are seconds from now, so the balancer's and this
    replica's clocks never need to agree."""
    budget = overload_lib.parse_timeout_s(
        headers.get(overload_lib.DEADLINE_HEADER))
    if budget is None:
        budget = req['timeout_s']
    return None if budget is None else time.time() + budget


def _submit_kwargs(req) -> dict:
    """The engine's request knobs from a parsed body. An unseeded
    sampled request draws a fresh seed here, on the host: identical
    requests must not return identical samples, while a client's seed
    stays reproducible."""
    seed = req['seed']
    if seed is None and ((req['temperature'] or 0.0) > 0.0
                         or req['response_format'] is not None):
        seed = int.from_bytes(os.urandom(4), 'little')
    return dict(eos_id=req['eos_id'], tenant=req['tenant'],
                deadline=req['deadline'], priority=req['priority'],
                adapter=req['adapter'],
                temperature=req['temperature'] or 0.0,
                top_p=1.0 if req['top_p'] is None else float(req['top_p']),
                seed=0 if seed is None else seed,
                response_format=req['response_format'])


def _load_grammar_vocab(path: str) -> Optional[list]:
    """The ``--grammar-vocab`` file: a JSON list indexed by token id
    (null: no text, never legal under a grammar). A malformed file is
    refused at startup, not on the first constrained request."""
    if not path:
        return None
    with open(path, encoding='utf-8') as f:
        vocab = json.load(f)
    if not isinstance(vocab, list):
        raise SystemExit(
            f'--grammar-vocab {path} must hold a JSON list (token id -> '
            f'string or null), got {type(vocab).__name__}')
    return vocab


def build_server(args: argparse.Namespace
                 ) -> Tuple[ThreadingHTTPServer,
                            Callable[..., List[int]]]:
    """Build the model (and the batching engine with ``--slots > 0``),
    warm it up, and bind the HTTP server on ``args.port`` (0 picks a
    free one). Returns (server, generate); ``server.engine`` is the
    engine or None. The caller runs ``server.serve_forever()``, then
    shuts the server down and closes the engine."""
    if args.tp > 1:
        raise NotImplementedError(
            f'--tp {args.tp}: tensor-parallel serving is not ported yet; '
            'it comes with the sharding items of ROADMAP.md (Queue 1, '
            'items 15-16)')
    dev = device_lib.resolve_device(args.device)
    config = llama.get_config(args.model)
    if args.quant == 'int8':
        params = quant.init_quantized(config, seed=0, device=dev)
    else:
        params = llama.init_params(config, seed=0, device=dev)
    lock = threading.Lock()
    engine = None
    if args.slots > 0:
        registry = None
        if args.adapter_dir and args.adapter_capacity > 0:
            registry = AdapterRegistry(base_dir=args.adapter_dir)
        preload = [a.strip() for a in args.preload_adapters.split(',')
                   if a.strip()]
        engine = batching.BatchingEngine(
            params, config, slots=args.slots, kv_int8=args.kv_int8,
            block_size=args.block_size,
            num_blocks=args.num_blocks or None,
            max_num_batched_tokens=args.max_batched_tokens,
            prefix_caching=args.prefix_caching == 'on',
            speculative=args.speculative == 'on', draft_k=args.draft_k,
            max_queued_requests=args.max_queued_requests or None,
            max_queued_tokens=args.max_queued_tokens or None,
            default_timeout_s=args.default_timeout_s or None,
            adapter_registry=registry,
            adapter_capacity=args.adapter_capacity,
            adapter_preload=preload or None,
            sampling=args.sampling == 'on',
            grammar_vocab=_load_grammar_vocab(args.grammar_vocab))

    def generate(prompt_ids, max_new, eos_id=None) -> List[int]:
        """Greedy generation. On the engine, concurrent requests share
        the decode batch. Without it, requested lengths are bucketed to
        powers of two (as the JAX replica does, where each length is a
        compile) and truncated; the eos rule is applied on the host to
        the full bucket, which yields the same ids as decoding with
        ``eos_id``."""
        if engine is not None:
            return engine.generate(prompt_ids, max_new, eos_id=eos_id)
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

        def _json(self, obj, code=200, extra_headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _engine_error(self, err):
            """A typed engine failure as an HTTP error, as the JAX
            replica maps it: client-shaped refusals answer non-5xx so
            they never trip the balancer's 5xx page — 400 for a
            response_format the grammar compiler refused, 404 for an
            unknown adapter, 413 for an adapter the engine can never
            serve or a request the pool can never hold, 429 with
            ``Retry-After`` (the engine's drain-rate estimate, at least
            1 s) for a shed request, 504 for an expired deadline; 500
            for anything else (engine death is a replica fault)."""
            headers = None
            if isinstance(err, GrammarError):
                code = 400
            elif isinstance(err, exceptions.AdapterNotFoundError):
                code = 404
            elif isinstance(err, exceptions.AdapterCapacityError):
                code = 413
            elif isinstance(err, exceptions.EngineOverloadedError):
                code = 429
                headers = {'Retry-After': str(max(1, int(round(
                    getattr(err, 'retry_after_s', 1.0)))))}
            elif isinstance(err, exceptions.DeadlineExceededError):
                code = 504
            elif isinstance(err, exceptions.KVPoolExhaustedError):
                code = 413
            else:
                code = 500
            self._json({'error': str(err)}, code, extra_headers=headers)

        def _submit(self, body):
            """The engine request for a parsed body, or None after
            answering 400 for a knob the engine refuses (a sampled
            request on a ``--sampling off`` replica)."""
            try:
                return engine.submit_request(body['prompt_ids'],
                                             body['max_new'],
                                             **_submit_kwargs(body))
            except ValueError as e:
                self._json({'error': f'bad request: {e}'}, 400)
                return None

        @staticmethod
        def _prefix_headers(req):
            """Per-request prefix-cache accounting, and for an adapter
            request its residency (hit: resident at admission; load:
            waited on a cold load), as the JAX replica sends them to
            the load balancer."""
            headers = {prefix_hash.PREFIX_HITS_HEADER:
                       str(req.prefix_hit_blocks),
                       prefix_hash.PREFIX_MISSES_HEADER:
                       str(req.prefix_miss_blocks)}
            if req.adapter is not None:
                hit = req.adapter_hit is True
                headers[prefix_hash.ADAPTER_HITS_HEADER] = str(int(hit))
                headers[prefix_hash.ADAPTER_LOADS_HEADER] = \
                    str(int(not hit))
            return headers

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
            if engine is not None:
                req['deadline'] = _deadline(self.headers, req)
                if req['stream']:
                    self._engine_stream(req)
                else:
                    self._engine_json(req)
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

        def _engine_json(self, body):
            req = self._submit(body)
            if req is None:
                return
            out, err = [], None
            while True:
                tok = req.out.get()
                if tok is None:
                    break
                if isinstance(tok, BaseException):
                    err = tok
                    continue
                out.append(tok)
            if err is not None:
                self._engine_error(err)
                return
            self._json({'output_ids': out},
                       extra_headers=self._prefix_headers(req))

        def _engine_stream(self, body):
            """SSE: tokens leave as the engine emits them (per decode
            dispatch). The status line waits, bounded, for the first
            queue item: admission (which fills the prefix-cache headers)
            precedes the first token, and a typed failure can still be
            answered as an HTTP error."""
            req = self._submit(body)
            if req is None:
                return
            pending = object()
            try:
                first = req.out.get(timeout=90)
            except queue.Empty:
                first = pending
            if isinstance(first, BaseException):
                self._engine_error(first)
                return
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            self.send_header('Transfer-Encoding', 'chunked')
            if first is not pending:
                for k, v in self._prefix_headers(req).items():
                    self.send_header(k, v)
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f'{len(data):x}\r\n'.encode())
                self.wfile.write(data + b'\r\n')
                self.wfile.flush()

            tok = req.out.get() if first is pending else first
            try:
                while tok is not None:
                    if isinstance(tok, BaseException):
                        # Mid-stream failure: one-line SSE error event.
                        msg = ' '.join(str(tok).split())
                        chunk(f'event: error\ndata: {msg}\n\n'.encode())
                    else:
                        chunk(f'data: {tok}\n\n'.encode())
                    tok = req.out.get()
                chunk(b'data: [DONE]\n\n')
                self.wfile.write(b'0\r\n\r\n')
                self.wfile.flush()
            except OSError:
                # The client went away: cancel the request (its blocks
                # are freed at the next iteration boundary), then drain
                # its queue so this thread ends. Bounded gets: the
                # sentinel may already have been read.
                engine.cancel(req.id)
                try:
                    while tok is not None:
                        tok = req.out.get(timeout=30)
                except queue.Empty:
                    pass

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
    # max_new=2 so the engine runs a decode dispatch too, greedy and
    # sampled.
    generate([1, 2, 3], 2)
    if engine is not None and engine.sampling:
        engine.generate([1, 2, 3], 2, temperature=1.0, top_p=0.9, seed=0)
    server = ThreadingHTTPServer(('0.0.0.0', args.port), Handler)
    server.daemon_threads = True
    server.engine = engine
    return server, generate


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    server, _ = build_server(args)
    print(f'serve_model ready on :{server.server_address[1]} '
          f'(model {args.model}, device {args.device}, slots '
          f'{args.slots}, quant {args.quant}, kv_int8 {args.kv_int8})',
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if server.engine is not None:
            server.engine.close()


if __name__ == '__main__':
    main()
