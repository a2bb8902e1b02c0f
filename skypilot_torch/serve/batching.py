"""Continuous batching over a PAGED KV cache — the port of
``skypilot_tpu/serve/batching.py`` (its core, sampled decode,
grammar-constrained decoding, overload control and multi-LoRA).

Concurrent requests share ONE decode batch: new requests are admitted
between decode dispatches, finished ones retire at once, and KV lives
in a pool of fixed-size blocks mapped per request through block tables
(``serve/kv_pool.py``), so admission is bounded by free blocks, not by
whole free slots. As in the JAX engine:

- prefill is CHUNKED and writes straight into the request's blocks
  (``models/decode.forward_paged``), interleaved with decode
  dispatches under a per-iteration token budget;
- pool exhaustion PREEMPTS the youngest request (blocks freed, request
  requeued at the front; resume re-prefills prompt + generated, which
  reproduces the continuation: greedy rows by the argmax, sampled rows
  by their (seed, position) keys);
- automatic PREFIX CACHING pins matching cached blocks at admission
  and prefills only the suffix (copy-on-write past a mid-block
  divergence);
- self-speculative n-gram drafting verifies draft_k + 1 positions per
  row in one forward (``verify_step_paged``), accepting through the one
  rule in ``serve/sampling/accept.py``;
- greedy outputs equal single-stream ``greedy_generate`` token for
  token (exactly on the CPU in f32; on the card bf16 kernels can flip
  a near-tie);
- SAMPLED decode (``serve/sampling/``): per-request temperature, top_p
  and seed ride the device steps as per-row tensors, and every draw is
  keyed by the request's (seed, absolute position) alone, so a
  request's tokens do not depend on its neighbours, its slot, a
  preempt-resume or speculation (the verify step realizes each
  position with the key plain decode would use there). While no
  admitted row samples or is constrained the steps run greedy, as
  before;
- STRUCTURED decoding: a ``response_format`` (regex or JSON schema) is
  compiled to a character DFA whose per-state token masks the steps
  gather from a device table (one row per slot, row 0 all-allowed);
  the host walks the DFA over every emitted token, so a constrained
  row forces 1-token decode dispatches, and drafts are cut at the first
  token the grammar refuses;
- int8 KV (``kv_int8``): each new row is quantized per (position, kv
  head) as it is written, codes and scales, and attention reads the
  codes. Equality with the dense int8 path holds for prompts within
  ONE prefill chunk (and up to a prefix-cache hit): a later chunk
  attends earlier chunks' int8 round trip where a whole-prompt prefill
  attends exact rows, so multi-chunk int8 prompts track it closely.
  Weights may be int8 ``{'q', 's'}`` pairs (``models/quant.py``);
- OVERLOAD CONTROL: per-request deadlines (absolute epoch seconds, or
  the engine's ``default_timeout_s``) refuse typed
  (``DeadlineExceededError``) at submit and admission and reap between
  dispatches; ``cancel`` frees a row's blocks at the next iteration
  boundary through the preemption reclaim path; ``max_queued_requests``
  / ``max_queued_tokens`` bound the pending queue with a typed
  ``EngineOverloadedError`` carrying a drain-rate Retry-After, an
  interactive arrival evicting the youngest queued batch request
  first; priority classes pick the preemption victim (lowest priority,
  youngest) and weight a (tenant, priority) deficit round-robin over
  the prefill budget;
- MULTI-LORA: a ``ResidentAdapterSet`` (``serve/adapters/``) holds
  stacked q/v factors ``[L, C+1, ...]`` (slot 0 all zeros); each row
  carries its adapter's slot, the three device steps add the
  row-gathered deltas (``models/decode.lora_gather_delta``) to q and v
  after the base projections, cold loads read on a thread and install
  in place between dispatches, a row pins its adapter for its lifetime,
  and adapter requests' prefix chains are salted by the adapter id
  (``prefix_hash.adapter_root``) so they never reuse base-model or
  other adapters' KV. An engine without an adapter set runs exactly the
  adapterless steps; a base row in an adapter engine gathers slot 0's
  delta of exactly 0.

The device steps, on the card: each layer rotates, quantizes (int8
pools) and writes its new K/V rows with K5F
(``ops.decode_attention.rope_cache_write``, one launch a layer, cos and
sin made once per step) and attends with K4-paged
(``paged_decode_attention``, W = 1, or ``paged_verify_attention``,
W = draft_k + 1), reading the block table directly; the contiguous
``decode_steps_rows`` twin runs K5F and dense K4; a prefill chunk
(``decode.forward_paged``) writes with K5F too and attends with
K4-prefill. Over int8 caches the same calls take the scales and
launch the kernels' int8 forms. Every row op of these steps is
batch-invariant on the card: a row's tokens and K/V do not depend on
B, W, its slot or the chunk it was prefilled in (the products through
``ops/matmul_invariant.py``, each residual add and the norm after
it in one launch of ``ops/rms_norm.py``,
K4's fixed key order, the sampler's nucleus threshold in
``ops/top_p.py``). The pool
tensors are updated IN PLACE, so the in-layer write is also the
persisted state
(the JAX steps write once in the layer and again after the layer
scan), and a rejected draft needs no undo: its rows sit past the new
``pos`` and are masked. The host reads tokens once per dispatch; pos
and tokens stay on the device, and block tables go up as one small
copy per change.

Observability, as the JAX engine's (docs/observability.md): the
``skytpu_batch_*`` families of ``_engine_metrics`` (and
``_adapter_metrics`` on an engine with an adapter registry) are updated
where the JAX engine updates them, the per-iteration gauge sweep
(``_set_gauges``) refreshes occupancy, queue, KV-pool and adapter gauges
and the two windowed ratio gauges, a request submitted inside a trace
gets ``batch.queue_wait``, ``batch.prefill``, ``batch.first_token`` and
``batch.decode`` spans under the context captured at submit, and a
``StepProfiler('decode')`` ticks once per decode or verify dispatch. The
``events`` log stays beside them.
"""
import array
import collections
import itertools
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from skypilot_torch import exceptions
from skypilot_torch import metrics as metrics_lib
from skypilot_torch import trace as trace_lib
from skypilot_torch.models import decode, llama
from skypilot_torch.ops import decode_attention as da
from skypilot_torch.ops import matmul_invariant as mi
from skypilot_torch.serve import kv_pool as kv_pool_lib
from skypilot_torch.serve import prefix_hash
from skypilot_torch.serve.adapters import ResidentAdapterSet
from skypilot_torch.serve.sampling import accept_tokens
from skypilot_torch.serve.sampling import grammar as grammar_lib
from skypilot_torch.serve.sampling import sample as sample_lib
from skypilot_torch.utils import profiling as profiling_lib

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

# Trailing windows of the exported prefix hit-ratio and speculative
# accept-ratio gauges: the evaluation windows of the alert rules that
# read them.
PREFIX_RATIO_WINDOW_SECONDS = 900.0
SPEC_RATIO_WINDOW_SECONDS = 900.0

# Self-speculative n-gram drafting (prompt lookup): longest suffix
# n-gram tried first down to a bigram minimum, and the history scan is
# bounded so a long prompt cannot turn every proposal into an
# O(prompt) walk on the engine loop.
SPEC_MAX_NGRAM = 6
SPEC_MIN_NGRAM = 2
SPEC_MATCH_WINDOW = 1024

# Adaptive per-request draft length: trailing acceptance window
# (verify rounds), shrink/grow thresholds, and the emitted-token
# cooldown before a collapsed (k=0) request re-probes.
SPEC_WINDOW_ROUNDS = 8
SPEC_SHRINK_BELOW = 0.4
SPEC_COLLAPSE_BELOW = 0.15
SPEC_GROW_ABOVE = 0.8
SPEC_REPROBE_TOKENS = 16
# Re-probe cooldowns double per failed probe, capped at
# 2**SPEC_BACKOFF_MAX_EXP * SPEC_REPROBE_TOKENS.
SPEC_BACKOFF_MAX_EXP = 4
SPEC_PROBE_K = 2
# Probe-mode proposals (k <= SPEC_PROBE_K) demand a 4-gram match; a
# request with no verify history yet a trigram.
SPEC_PROBE_MIN_NGRAM = 4
SPEC_FIRST_MIN_NGRAM = 3
# A verify dispatch must carry at least this many drafted tokens, or
# the batch takes the plain multi-step decode path instead.
SPEC_MIN_DISPATCH_TOKENS = 4


# ---------------------------------------------------------------------
# Per-row decode primitives
# ---------------------------------------------------------------------


def _attend_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 pos: torch.Tensor, scale: float, k_scale=None,
                 v_scale=None) -> torch.Tensor:
    """q [B, 1, H, hd]; k/v [B, S, Hkv, hd] (int8 with scales [B, S,
    Hkv]); pos [B] = the index the current token was just written at.
    Row b attends keys [0, pos_b] (dense K4 on the card: reads scale
    with each row's context)."""
    return da.decode_attention(q[:, 0], k, v, pos + 1, scale, k_scale,
                               v_scale)[:, None]


def _next_tokens(logits: torch.Tensor, cur: torch.Tensor,
                 sampling) -> torch.Tensor:
    """Each row's next token from its logits [B, V] at position ``cur``
    [B] (the index of the token these logits consumed): the argmax when
    ``sampling`` is None, else ``sample_rows`` keyed (seed, cur) under
    the row's grammar mask."""
    if sampling is None:
        return logits.argmax(-1).to(torch.int32)
    allowed = sample_lib.gather_masks(sampling['mask_table'],
                                      sampling['mask_idx'])
    return sample_lib.sample_rows(logits, sampling['temps'],
                                  sampling['top_ps'], sampling['seeds'],
                                  cur, allowed)


def _loras(adapters, adapter_idx, config: llama.LlamaConfig) -> list:
    """Each layer's ``lora`` argument of ``decode.qkv_projections``:
    (the layer's factors, adapter_idx), or None throughout when the
    step has no adapter set."""
    if (adapters is None) != (adapter_idx is None):
        raise ValueError('adapters and adapter_idx go together')
    return [None if ad is None else (ad, adapter_idx)
            for ad in decode.adapter_layers(adapters, config.n_layers)]


def _logits(cparams: Params, config: llama.LlamaConfig,
            x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The last layer's MLP residual (``delta``), the final norm and the
    LM head."""
    x = decode.final_norm(config, cparams, x, delta)
    return mi.matmul(x, llama.output_head(cparams, config)).float()


def decode_steps_rows(params: Params, tokens: torch.Tensor, caches,
                      pos: torch.Tensor, active: torch.Tensor,
                      config: llama.LlamaConfig, num_steps: int,
                      sampling=None):
    """Decode ``num_steps`` tokens for every row at PER-ROW positions.

    tokens [B] int32 (each row's most recent token); ``caches`` =
    (k, v, k_scale, v_scale) with k/v [L, B, S, Hkv, hd] (int8 with
    bf16 scales [L, B, S, Hkv], or the scales None), written in place;
    pos [B] int32 = next write index per row; active [B] bool —
    inactive rows still compute but their pos does not advance and
    their writes keep landing on the same parked cell (a pos outside
    [0, S) writes nothing). Each layer rotates, quantizes and writes its
    new row with K5F and attends with dense K4 on the card.

    ``sampling``: None keeps the greedy argmax; else a dict of per-row
    knobs (``temps``/``top_ps``/``seeds`` [B]) plus the grammar mask
    table (``mask_table`` [M, V] bool, ``mask_idx`` [B]; row 0 is
    all-allowed), and each step's token is ``sample_rows`` keyed
    (seed, position); ``temperature <= 0`` rows still take the argmax.

    This is the CONTIGUOUS-cache twin of ``decode_steps_paged``.
    Returns (out_tokens [B, num_steps] int32, caches, new_pos).
    """
    k_cache, v_cache, ks_cache, vs_cache = caches
    quantized = ks_cache is not None
    cparams = llama.compute_params(params, config)
    layers = decode.layer_list(cparams, config)
    b, s = k_cache.shape[1:3]
    nkv, hd = config.n_kv_heads, config.head_dim
    tok, cur = tokens, pos
    out = []
    for _ in range(num_steps):
        cos, sin = decode.rope_table(config, cur)            # [B, hd/2]
        x = llama.embed_tokens(cparams, tok.long(), config)[:, None]
        dst = da.rows_dst(cur, s)
        delta = None
        for i, lp in enumerate(layers):
            x, q, k, v = decode.qkv_projections(config, x, lp, delta=delta)
            scales = ((ks_cache[i], vs_cache[i]) if quantized
                      else (None, None))
            q = da.rope_cache_write(
                q[:, 0], k[:, 0], v[:, 0], cos, sin,
                k_cache[i].view(b * s, nkv, hd),
                v_cache[i].view(b * s, nkv, hd), dst,
                *(None if sc is None else sc.view(b * s, nkv)
                  for sc in scales))[:, None]
            attn = _attend_rows(q, k_cache[i], v_cache[i], cur,
                                hd ** -0.5, *scales)
            x, delta = decode.attn_out_and_mlp(config, x, attn, lp)
        nxt = _next_tokens(_logits(cparams, config, x, delta)[:, -1], cur,
                           sampling)
        # Inactive rows: hold the last token and do NOT advance.
        tok = torch.where(active, nxt, tok)
        cur = torch.where(active, cur + 1, cur)
        out.append(tok)
    return torch.stack(out, dim=1), caches, cur


def _flat_pools(caches, block_size: int, config: llama.LlamaConfig):
    """The pool 4-tuple as flat [L, NB * bs, ...] row views (scales
    None for a bf16/f32 pool)."""
    k_pool, v_pool, ks_pool, vs_pool = caches
    nl, nb, bs = k_pool.shape[:3]
    if bs != block_size:
        raise ValueError(f'pool block size {bs} != {block_size}')
    nkv, hd = config.n_kv_heads, config.head_dim
    kp = k_pool.view(nl, nb * bs, nkv, hd)
    vp = v_pool.view(nl, nb * bs, nkv, hd)
    if ks_pool is None:
        return kp, vp, None, None
    return (kp, vp, ks_pool.view(nl, nb * bs, nkv),
            vs_pool.view(nl, nb * bs, nkv))


def decode_steps_paged(params: Params, tokens: torch.Tensor, caches,
                       block_tables: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor, config: llama.LlamaConfig,
                       num_steps: int, block_size: int,
                       adapters=None, adapter_idx=None, sampling=None):
    """Block-table-indirected twin of ``decode_steps_rows`` with
    identical numerics: ``caches`` = (k, v, k_scale, v_scale) with k/v
    [L, num_blocks, block_size, Hkv, hd] (int8 with bf16 scales
    [L, num_blocks, block_size, Hkv], or the scales None),
    ``block_tables`` [B, MB] int32. Writes go through
    ``kv_pool.write_index`` (parked rows and overrun positions land in
    the scratch block) with K5F, the new rows' RoPE, int8 quantization
    and write in one launch a layer; attention is
    ``paged_decode_attention`` (K4-paged, W = 1) over each row's own
    length, so recycled-block garbage past it contributes exactly 0;
    an inactive row attends its first key only. ``sampling`` as in
    ``decode_steps_rows``.

    Multi-adapter serving: ``adapters`` is the resident set's stacked
    factor dict (``[L, C+1, ...]``) and ``adapter_idx`` [B] each row's
    slot; the row-gathered LoRA deltas go onto q and v after the base
    projections (``decode.qkv_projections``). None for both runs exactly
    the adapterless math.

    Returns (out_tokens [B, num_steps] int32, caches, new_pos).
    """
    kp, vp, ksp, vsp = _flat_pools(caches, block_size, config)
    quantized = ksp is not None
    cparams = llama.compute_params(params, config)
    layers = decode.layer_list(cparams, config)
    loras = _loras(adapters, adapter_idx, config)
    hd = config.head_dim
    tok, cur = tokens, pos
    out = []
    for _ in range(num_steps):
        cos, sin = decode.rope_table(config, cur)            # [B, hd/2]
        x = llama.embed_tokens(cparams, tok.long(), config)[:, None]
        widx = kv_pool_lib.write_index(block_tables, cur, block_size)
        # Inactive rows' outputs are discarded: they attend one key, not
        # the span their parked position would give them.
        lens = torch.where(active, cur + 1, 1)
        delta = None
        for i, lp in enumerate(layers):
            x, q, k, v = decode.qkv_projections(config, x, lp, loras[i],
                                                delta=delta)
            scales = (ksp[i], vsp[i]) if quantized else (None, None)
            q = da.rope_cache_write(q[:, 0], k[:, 0], v[:, 0], cos, sin,
                                    kp[i], vp[i], widx, *scales)
            attn = da.paged_decode_attention(
                q, kp[i], vp[i], block_tables,
                lens, hd ** -0.5, block_size, *scales)[:, None]
            x, delta = decode.attn_out_and_mlp(config, x, attn, lp)
        nxt = _next_tokens(_logits(cparams, config, x, delta)[:, -1], cur,
                           sampling)
        # Inactive rows: hold the last token and do NOT advance, so
        # their next (scratch-redirected) write stays parked.
        tok = torch.where(active, nxt, tok)
        cur = torch.where(active, cur + 1, cur)
        out.append(tok)
    return torch.stack(out, dim=1), caches, cur


def verify_step_paged(params: Params, tokens: torch.Tensor, caches,
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      n_real: torch.Tensor, config: llama.LlamaConfig,
                      width: int, block_size: int, adapters=None,
                      adapter_idx=None, sampling=None):
    """Batched multi-token VERIFY forward — the speculative twin of
    ``decode_steps_paged``: ONE forward carries ``width`` = draft_k + 1
    query positions per row (the row's current token at ``pos[b]``
    plus its drafted continuation).

    tokens [B, W] int32 (only the first n_real[b] real — padded lanes
    write scratch and their outputs are ignored). The drafted K/V is
    rotated, quantized (int8 pools) and written into the row's blocks up
    front with K5F, one launch a layer; a rejection later
    just leaves those rows past the committed ``pos``, where the
    length-masked attention never reads them. Attention is
    ``paged_verify_attention`` (K4-paged, W > 1; query j attends
    [0, pos + j]).

    Returns (preds [B, W] int32, accepted [B] int32 from
    ``accept_tokens``, new_pos [B], new_tokens [B], caches): ``preds[b,
    j]`` is the target model's token after position pos[b] + j — the
    argmax when ``sampling`` is None, else ``verify_targets``' draw
    with the key plain decode would use at that position (``sampling``
    as in ``decode_steps_rows``, but its mask table is per position,
    [M, W, V]). Live rows advance by accepted + 1, parked rows (n_real
    0) stay. A parked row attends only its first key, so its preds
    carry no meaning. ``adapters``/``adapter_idx`` as in
    ``decode_steps_paged``: verify applies the identical delta, or
    speculation would accept drafts against another model.
    """
    kp, vp, ksp, vsp = _flat_pools(caches, block_size, config)
    quantized = ksp is not None
    cparams = llama.compute_params(params, config)
    nh, nkv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    b = tokens.shape[0]
    positions = pos[:, None] + torch.arange(width, dtype=torch.int32,
                                            device=pos.device)[None, :]
    cos, sin = decode.rope_table(config,
                                 positions.reshape(-1))     # [B*W, hd/2]
    x = llama.embed_tokens(cparams, tokens.long(), config)   # [B, W, D]
    widx = kv_pool_lib.verify_write_indices(
        block_tables, pos, n_real, width, block_size).reshape(-1)
    live = n_real > 0
    # Parked rows' predictions are never read: they attend from one key.
    lens = torch.where(live, pos + 1, 1)
    loras = _loras(adapters, adapter_idx, config)
    delta = None
    for i, lp in enumerate(decode.layer_list(cparams, config)):
        x, q, k, v = decode.qkv_projections(config, x, lp, loras[i],
                                            delta=delta)
        scales = (ksp[i], vsp[i]) if quantized else (None, None)
        # Padded lanes collide harmlessly on the scratch slot.
        q = da.rope_cache_write(
            q.reshape(b * width, nh, hd), k.reshape(b * width, nkv, hd),
            v.reshape(b * width, nkv, hd), cos, sin, kp[i], vp[i], widx,
            *scales).reshape(b, width, nh, hd)
        attn = da.paged_verify_attention(q, kp[i], vp[i], block_tables,
                                         lens, hd ** -0.5, block_size,
                                         *scales)
        x, delta = decode.attn_out_and_mlp(config, x, attn, lp)
    logits = _logits(cparams, config, x, delta)             # [B, W, V]
    if sampling is None:
        preds = logits.argmax(-1).to(torch.int32)
    else:
        # Realizations drawn with the keys plain decode would use at each
        # position: the maximal-coupling half of accept.py's rule.
        allowed = sample_lib.gather_masks(sampling['mask_table'],
                                          sampling['mask_idx'])
        preds = sample_lib.verify_targets(
            logits, sampling['temps'], sampling['top_ps'],
            sampling['seeds'], pos, allowed)
    accepted = accept_tokens(tokens, preds, n_real)
    new_pos = torch.where(live, pos + accepted + 1, pos)
    new_tok = torch.where(
        live, torch.gather(preds, 1, accepted[:, None].long())[:, 0],
        tokens[:, 0])
    return preds, accepted, new_pos, new_tok, caches


# ---------------------------------------------------------------------
# Speculative decoding: n-gram drafting + adaptive draft length (host)
# ---------------------------------------------------------------------


def propose_ngram_draft(tokens: List[int], k: int,
                        max_ngram: int = SPEC_MAX_NGRAM,
                        min_ngram: int = SPEC_MIN_NGRAM,
                        window: int = SPEC_MATCH_WINDOW) -> List[int]:
    """Self-speculative prompt-lookup drafting: find the most recent
    EARLIER occurrence of the longest n-gram ending at the current
    suffix of ``tokens`` (the request's own prompt + generated stream)
    and propose up to ``k`` tokens that followed it. SEQUENTIAL: each
    drafted token re-anchors the lookup on the suffix including the
    tokens drafted so far. The scan is bounded to the trailing
    ``window`` tokens, searched as a flat int32 byte string with
    ``bytearray.rfind``. Returns [] when nothing matches."""
    if k <= 0 or len(tokens) < 2:
        return []
    lo = max(0, len(tokens) - window)
    hist = list(tokens[lo:])
    buf = bytearray(array.array('i', hist).tobytes())
    item = array.array('i', [0]).itemsize
    out: List[int] = []
    for _ in range(k):
        n_hist = len(hist)
        nxt = None
        for n in range(min(max_ngram, n_hist - 1),
                       min_ngram - 1, -1):
            pat = array.array('i', hist[-n:]).tobytes()
            # The match must END at or before the last-but-one token.
            idx = buf.rfind(pat, 0, (n_hist - 1) * item)
            while idx != -1 and idx % item:
                # Byte-level hits straddling item boundaries are not
                # token matches — keep searching earlier.
                idx = buf.rfind(pat, 0, idx + len(pat) - 1)
            if idx != -1:
                nxt = hist[idx // item + n]
                break
        if nxt is None:
            break
        out.append(nxt)
        hist.append(nxt)
        buf += array.array('i', [nxt]).tobytes()
    return out


def update_spec_k(cur_k: int, window, draft_k: int) -> int:
    """Adaptive per-request draft length from a trailing window of
    (proposed, accepted) verify rounds: collapse to 0 on near-nothing
    accepted over real evidence, halve under ``SPEC_SHRINK_BELOW``,
    double (capped at ``draft_k``) above ``SPEC_GROW_ABOVE``."""
    proposed = sum(p for p, _ in window)
    if proposed <= 0:
        return cur_k
    rate = sum(a for _, a in window) / proposed
    if proposed >= 8 and rate < SPEC_COLLAPSE_BELOW:
        return 0
    if rate < SPEC_SHRINK_BELOW:
        return cur_k // 2
    if rate > SPEC_GROW_ABOVE and cur_k < draft_k:
        return min(draft_k, max(1, cur_k * 2))
    return cur_k


# ---------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------


# Priority classes layered on the tenant DRR (overload control):
# shedding takes batch first, pool-exhaustion preemption takes the
# lowest-priority-youngest row, and the prefill budget weights
# interactive classes ahead of batch ones.
PRIORITIES = ('interactive', 'batch')
PRIORITY_PREFILL_WEIGHTS = {'interactive': 4.0, 'batch': 1.0}

_REQ_SEQ = itertools.count(1)


class _Request:
    def __init__(self, prompt_ids: List[int], max_new: int,
                 eos_id: Optional[int] = None,
                 tenant: Optional[str] = None,
                 deadline: Optional[float] = None,
                 priority: str = 'interactive',
                 adapter: Optional[str] = None,
                 temperature: float = 0.0,
                 top_p: float = 1.0,
                 seed: int = 0,
                 response_format: Optional[dict] = None):
        self.prompt_ids = prompt_ids
        self.max_new = max_new
        self.eos_id = eos_id
        # Sampling knobs: temperature 0 is greedy; every draw of this
        # request is keyed (seed, absolute position) and nothing else.
        # ``grammar`` (compiled from ``response_format`` at submit) is
        # walked on the host: ``grammar_state`` is the DFA state after
        # every EMITTED token, re-derived from ``generated`` at each
        # admission, so a preempt-resume lands in the same state.
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.response_format = response_format
        self.grammar = None
        self.grammar_state = None
        # Multi-LoRA: the adapter this request decodes under (None = the
        # base model); ``adapter_hit`` is filled at admission: True when
        # the adapter was already resident, False when the request
        # waited on a cold load (None for base requests). serve_model
        # sends it as the X-Skytpu-Adapter-* response headers.
        self.adapter = adapter
        self.adapter_hit: Optional[bool] = None
        # Fair-share key (None = the default tenant) of the prefill
        # budget's deficit round-robin.
        self.tenant = tenant
        # Overload control: ``id`` is the handle ``cancel`` takes,
        # ``deadline`` an ABSOLUTE epoch second (None = none) enforced
        # at submit, admission and between dispatches, ``priority`` the
        # shed/preempt/prefill class.
        self.id = next(_REQ_SEQ)
        self.deadline = deadline
        self.priority = priority
        self.cancelled = False
        # Prefix-cache accounting, filled at admission (cumulative
        # across re-admissions after preemption): whole KV blocks
        # reused from the cache vs freshly prefilled; serve_model
        # sends them as X-Skytpu-Prefix-* response headers.
        self.prefix_hit_blocks = 0
        self.prefix_miss_blocks = 0
        # Admission-time hash chain, reused by _register_prefix.
        self.chain_hashes: List[bytes] = []
        self.chain_t0 = -1
        # Speculative-decoding state: current draft length (None until
        # admission seeds it), trailing (proposed, accepted) window,
        # the emitted-token cooldown before a collapsed request
        # re-probes, and its failed-probe streak. Only EMITTED tokens
        # ever enter ``generated``.
        self.spec_k: Optional[int] = None
        self.spec_window: 'collections.deque' = collections.deque(
            maxlen=SPEC_WINDOW_ROUNDS)
        self.spec_cooldown = 0
        self.spec_fail_streak = 0
        self.out: 'queue.Queue' = queue.Queue()
        self.submitted_at = time.time()
        # Tokens already emitted — preemption resume state: a requeued
        # request re-prefills prompt + generated.
        self.generated: List[int] = []
        self.admitted_once = False
        self.preemptions = 0
        # Trace context captured at submit: the engine loop runs on its
        # own thread, which contextvars do not reach, so the request's
        # spans are recorded under this (None: untraced, no spans).
        self.trace_ctx = trace_lib.current()


def _engine_metrics():
    """The engine's metric families, letter for letter the JAX
    engine's (get-or-create: several engines in one process share
    them; see docs/observability.md)."""
    reg = metrics_lib.registry()
    return {
        'queue_wait': reg.histogram(
            'skytpu_batch_queue_wait_seconds',
            'submit() to admission (first prefill chunk).'),
        'ttft': reg.histogram(
            'skytpu_batch_ttft_seconds',
            'submit() to first generated token.'),
        'tokens': reg.counter(
            'skytpu_batch_decode_tokens_total',
            'Generated tokens emitted to clients.'),
        'requests': reg.counter(
            'skytpu_batch_requests_total',
            'Requests admitted into the decode batch.'),
        'tok_s': reg.gauge(
            'skytpu_batch_decode_tokens_per_sec',
            'Decode throughput of the latest dispatch '
            '(active rows * steps / wall time).'),
        'occupancy': reg.gauge(
            'skytpu_batch_slots_occupied',
            'Decode rows currently holding a request.'),
        'slots': reg.gauge(
            'skytpu_batch_slots_total',
            'Fixed decode row count of the engine.'),
        'kv_bytes': reg.gauge(
            'skytpu_batch_kv_cache_bytes',
            'Resident KV block-pool allocation of the engine '
            '(codes + scales) — the HBM the pool pins whether or '
            'not its blocks are allocated.'),
        'kv_used': reg.gauge(
            'skytpu_batch_kv_cache_used_bytes',
            'Bytes of KV blocks currently allocated to admitted '
            'requests — real block accounting (allocated blocks x '
            'bytes/block), not a slot-occupancy estimate.'),
        'kv_blocks_total': reg.gauge(
            'skytpu_batch_kv_blocks_total',
            'Allocatable KV blocks in the pool (excludes the '
            'reserved scratch block).'),
        'kv_blocks_used': reg.gauge(
            'skytpu_batch_kv_blocks_used',
            'KV blocks currently allocated to admitted requests.'),
        'preemptions': reg.counter(
            'skytpu_batch_preemptions_total',
            'Requests preempted (blocks reclaimed, request '
            'requeued) because the KV pool ran out of free blocks.'),
        'kv_cached': reg.gauge(
            'skytpu_batch_kv_cache_cached_bytes',
            'Bytes of refcount-0 prefix-cache blocks — RECLAIMABLE '
            'capacity holding reusable KV content. A pool reading '
            'full on kv_cache_bytes but mostly cached here is '
            'healthy, not exhausted.'),
        'prefix_hits': reg.counter(
            'skytpu_batch_prefix_hits_total',
            'KV blocks reused from the prefix cache at admission '
            '(prefill skipped for their tokens).'),
        'prefix_misses': reg.counter(
            'skytpu_batch_prefix_misses_total',
            'KV blocks freshly allocated and prefilled at admission '
            '(no cache hit).'),
        'prefix_cached_blocks': reg.gauge(
            'skytpu_batch_prefix_cached_blocks',
            'Refcount-0 blocks currently holding registered '
            '(reusable) prefix-cache content.'),
        'spec_proposed': reg.counter(
            'skytpu_batch_spec_proposed_total',
            'Draft tokens proposed by the self-speculative n-gram '
            'drafter and carried into a verify dispatch.'),
        'spec_accepted': reg.counter(
            'skytpu_batch_spec_accepted_total',
            'Proposed draft tokens accepted by verification — the '
            'argmax match for greedy rows, the speculative-'
            'sampling rule for sampled rows (each accepted draft '
            'is one decode forward the engine did not have to '
            'run).'),
        'spec_tokens_per_forward': reg.gauge(
            'skytpu_batch_spec_tokens_per_forward',
            'Tokens emitted per row by the latest verify dispatch '
            '(accepted drafts + the bonus token; 1.0 == plain '
            'decode, draft_k+1 == full acceptance).'),
        'spec_accept_rate': reg.histogram(
            'skytpu_batch_spec_accept_rate',
            'Per-row accepted/proposed fraction of each verify '
            'round, labeled by decode mode — sampled rows accept '
            'by the speculative-sampling rule '
            '(serve/sampling/accept.py), greedy rows by argmax '
            'match. A sampled-mode distribution sitting far below '
            'greedy on the same traffic means drafts are being '
            'rejected by randomness, not by model disagreement.',
            ('mode',),
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0)),
        'sampled_requests': reg.counter(
            'skytpu_batch_sampled_requests_total',
            'Admitted requests decoding with temperature > 0 '
            '(counter-keyed sampled decode, serve/sampling/).'),
        'constrained_requests': reg.counter(
            'skytpu_batch_constrained_requests_total',
            'Admitted requests decoding under a response_format '
            'grammar (structured decoding, serve/sampling/'
            'grammar.py).'),
        'shed': reg.counter(
            'skytpu_batch_shed_total',
            'Requests refused typed at submit() by bounded '
            'admission, by reason: which overload knob tripped '
            '(max_queued_requests / max_queued_tokens) or '
            'priority_evict (a queued batch request shed to make '
            'room for an arriving interactive one).',
            ('reason',)),
        'cancelled': reg.counter(
            'skytpu_batch_cancelled_total',
            'Requests cancelled by the client (broken connection) '
            '— their KV blocks reclaimed at the next iteration '
            'boundary through the preemption release path.'),
        'deadline_exceeded': reg.counter(
            'skytpu_batch_deadline_exceeded_total',
            'Requests aborted typed because their end-to-end '
            'deadline expired at admission or between decode '
            'iterations (serve_model answers 504).'),
        'loop_hang': reg.counter(
            'skytpu_batch_loop_hang_total',
            'close() observed the engine loop thread still alive '
            'after its join timeout — a wedged dispatch is holding '
            'the loop (likely a hung device call).'),
        'queued_requests': reg.gauge(
            'skytpu_batch_queued_requests',
            'Requests waiting in the pending (pre-admission) '
            'queue.'),
        'queued_tokens': reg.gauge(
            'skytpu_batch_queued_tokens',
            'Prompt + resume tokens held by the pending queue — '
            'the currency of the max_queued_tokens admission '
            'bound.'),
    }


def _adapter_metrics():
    """Adapter-serving metric families (serve/adapters/), registered
    ONLY by engines built with an adapter registry — an engine
    serving no adapters must not export fake zero series (the
    hit-ratio-gauge precedent in _engine_metrics)."""
    reg = metrics_lib.registry()
    return {
        'resident': reg.gauge(
            'skytpu_batch_adapters_resident',
            'LoRA adapters currently device-loaded in the stacked '
            'gather buffers (slot 0, the base-model identity, not '
            'counted).'),
        'capacity': reg.gauge(
            'skytpu_batch_adapters_capacity',
            'Adapter slots in the stacked gather buffers (fixed at '
            'engine build; resident == capacity means the next cold '
            'load must evict).'),
        'loads': reg.counter(
            'skytpu_batch_adapter_loads_total',
            'Adapter cold loads completed and installed into a '
            'device slot (each one had requests waiting on it or '
            'was an operator preload).'),
        'evictions': reg.counter(
            'skytpu_batch_adapter_evictions_total',
            'Resident adapters evicted (LRU over refcount-0 '
            'adapters only — a pinned, in-flight adapter is never '
            'evicted) to make room for a cold load. A high rate '
            'with a steady working set is thrash: capacity is too '
            'small for the adapter mix (the adapter-thrash alert).'),
        'load_seconds': reg.histogram(
            'skytpu_batch_adapter_load_seconds',
            'Cold-load wall time: ensure_loading kick to device '
            'install — the latency a cold-adapter request pays on '
            'top of normal queueing (its TTFT floor).'),
    }


class BatchingEngine:
    """Paged-KV continuous batching around ``decode_steps_paged``.

    ``submit()`` returns a Queue yielding generated token ids (ints)
    then ``None`` (a typed exception object precedes the ``None`` if
    the request failed). A background thread admits pending requests
    into free decode rows when the block pool has room, runs chunked
    prefill interleaved with whole-batch decode dispatches
    (``steps_per_dispatch`` tokens each), retires rows the moment they
    hit their budget (freeing their blocks), and preempts-and-requeues
    the youngest request when the pool runs dry.

    Knobs (the JAX engine's, same defaults): ``slots`` (decode batch
    width), ``block_size``, ``num_blocks`` (default: every row can
    reach ``max_seq``), ``max_num_batched_tokens`` (per-iteration
    prefill token budget), ``prefill_chunk``, ``prefix_caching``,
    ``speculative``, ``draft_k``, ``kv_int8`` (an int8 pool: codes and
    bf16 scales), ``sampling`` (sampled and constrained decode; off
    refuses such requests at submit) and ``grammar_vocab`` (each token
    id's text, None for ids with none; needed to serve
    ``response_format`` and as long as the model vocab). Params may be
    int8-quantized (``models/quant.py``). The engine runs on the params'
    device.

    Overload control: ``tenant_weights`` (per-tenant weights of the
    prefill budget's deficit round-robin; absent tenants weigh 1.0),
    ``max_queued_requests`` / ``max_queued_tokens`` (bounded admission:
    past either bound ``submit`` refuses with a typed
    ``EngineOverloadedError``; None = unbounded) and
    ``default_timeout_s`` (the deadline stamped on requests that carry
    none). Multi-LoRA: ``adapter_registry`` (an ``AdapterRegistry``),
    ``adapter_capacity`` (device-resident adapter slots; 0 serves no
    adapters), ``adapter_rank_bucket`` (the resident set's shared rank
    axis: smaller ranks pad to it, a larger one is refused with
    ``AdapterCapacityError``) and ``adapter_preload`` (ids installed
    before the loop starts). MoE configs run the routed experts in every
    device step (``models/decode.moe_mlp``); a prefill chunk's bucket is
    part of its capacity, so with a binding ``moe_capacity_factor`` a
    chunked prompt can drop other tokens than a whole-prompt prefill, as
    in the JAX engine.
    """

    def __init__(self, params: Params, config: llama.LlamaConfig,
                 slots: int = 8, max_seq: Optional[int] = None,
                 steps_per_dispatch: int = 8,
                 kv_int8: bool = False,
                 block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 max_num_batched_tokens: Optional[int] = 2048,
                 prefill_chunk: int = 512,
                 prefix_caching: bool = True,
                 speculative: bool = True,
                 draft_k: int = 8,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 max_queued_requests: Optional[int] = None,
                 max_queued_tokens: Optional[int] = None,
                 default_timeout_s: Optional[float] = None,
                 adapter_registry=None,
                 adapter_capacity: int = 0,
                 adapter_rank_bucket: int = 16,
                 adapter_preload: Optional[List[str]] = None,
                 sampling: bool = True,
                 grammar_vocab: Optional[List[Optional[str]]] = None):
        self.params = params
        self.config = config
        self.device = params['embed'].device
        self.slots = slots
        # max_seq must be block-aligned: the table maps whole blocks.
        self.max_seq = max_seq or config.max_seq_len
        self.max_seq = -(-self.max_seq // block_size) * block_size
        self.block_size = block_size
        self.max_blocks_per_req = self.max_seq // block_size
        if num_blocks is None:
            # Capacity for every row to reach max_seq (+1 for the
            # scratch block); a smaller pool oversubscribes and the
            # engine preempts on exhaustion.
            num_blocks = slots * self.max_blocks_per_req + 1
        self.steps = steps_per_dispatch
        self.prefill_chunk = max(1, prefill_chunk)
        self.max_batched_tokens = max_num_batched_tokens
        self.prefix_caching = prefix_caching
        # The verify width is fixed at draft_k + 1 (shorter drafts pad
        # their lanes to scratch).
        self.speculative = speculative and draft_k > 0
        self.draft_k = max(0, draft_k)
        # Prefill tokens spent in the CURRENT scheduler iteration — the
        # verify dispatch budgets its draft grants against the rest.
        self._prefill_spent_iter = 0
        # Engine-local cumulatives and trailing windows of (ts, a, b)
        # snapshots (~1/s) behind the two windowed ratio gauges: the
        # counter FAMILIES are process-global, the ratios this engine's.
        self._spec_proposed_local = 0
        self._spec_accepted_local = 0
        self._spec_window: 'collections.deque' = collections.deque()
        self._spec_ratio_gauge = None
        self._prefix_hits_local = 0
        self._prefix_misses_local = 0
        self._prefix_window: 'collections.deque' = collections.deque()
        self._hit_ratio_gauge = None
        # Weighted deficit round-robin over the prefill token budget,
        # by (tenant, priority) class.
        self.tenant_weights = dict(tenant_weights or {})
        self._tenant_deficit: Dict[tuple, float] = {}
        self._tenant_rr = 0
        self.kv_int8 = kv_int8
        # Sampled and structured decoding: while every admitted row is
        # greedy and unconstrained, ``_sampling_args`` is None and the
        # steps run their greedy argmax. The mask table [slots + 1, V]
        # (row 0 all-allowed) is the device half of the grammar
        # pipeline: the host refreshes a constrained row's line per
        # emitted token, the steps gather lines by per-row index.
        self.sampling = bool(sampling)
        self._grammar_vocab = (tuple(grammar_vocab)
                               if grammar_vocab else None)
        if self._grammar_vocab is not None and \
                len(self._grammar_vocab) != config.vocab_size:
            raise ValueError(
                f'grammar_vocab has {len(self._grammar_vocab)} '
                f'entries but the model vocab is {config.vocab_size}')
        self._mask_table = torch.ones(
            (slots + 1, config.vocab_size), dtype=torch.bool,
            device=self.device) if self.sampling else None
        self.pool = kv_pool_lib.KVBlockPool(config, num_blocks,
                                            block_size, kv_int8=kv_int8,
                                            device=self.device)
        # The engine owns the device tensors; the pool keeps only the
        # allocator.
        self.caches = self.pool.caches
        self.pool.caches = None
        # Host mirror of the block tables: rows change on the host and
        # go up as one copy before the next device step that reads them.
        self._tables_host = torch.zeros(
            (slots, self.max_blocks_per_req), dtype=torch.int32)
        self._tables_dirty = False
        self.block_tables = self._to_device(self._tables_host)
        self.pos = torch.zeros((slots,), dtype=torch.int32,
                               device=self.device)
        self.tokens = torch.zeros((slots,), dtype=torch.int32,
                                  device=self.device)
        # Host-side per-row bookkeeping.
        self.slot_req: List[Optional[_Request]] = [None] * slots
        self.slot_left = [0] * slots
        self.slot_len = [0] * slots          # written prompt+generated
        self.slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        self.slot_off = [0] * slots          # prompt tokens prefilled
        self.slot_total = [0] * slots        # prompt length this pass
        self.slot_seq = [0] * slots          # admission order
        self._admit_seq = 0
        # batch.prefill span state: first chunk's wall start, chunks.
        self._prefill_t0: List[Optional[float]] = [None] * slots
        self._prefill_chunks = [0] * slots
        self.pending: 'collections.deque[_Request]' = \
            collections.deque()
        self._pending_lock = threading.Lock()
        # Multi-LoRA: the resident set, each row's gather slot (0 = the
        # all-zeros base identity) and the requests parked on a cold
        # load (engine-loop state: _poll_adapter_loads re-queues them
        # the iteration their weights land).
        self._adapters: Optional[ResidentAdapterSet] = None
        self._adapter_metrics = None
        self.slot_adapter = [0] * slots
        self._adapter_wait: List[_Request] = []
        if adapter_registry is not None and adapter_capacity > 0:
            wq = params['layers']['wq']
            wv = params['layers']['wv']
            if isinstance(wq, dict):     # int8-quantized leaves
                wq, wv = wq['q'], wv['q']
            self._adapters = ResidentAdapterSet(
                adapter_registry, adapter_capacity,
                (wq.shape[0], wq.shape[1], wq.shape[2], wv.shape[2]),
                rank_bucket=adapter_rank_bucket, device=self.device)
            self._adapter_metrics = _adapter_metrics()
            self._adapter_metrics['capacity'].set(adapter_capacity)
            if adapter_preload:
                # Before the loop starts: a preload list names adapters
                # the operator expects live at ready time, so anything
                # unusable raises HERE.
                self._adapters.preload(adapter_preload)
                self._adapter_metrics['loads'].inc(
                    self._adapters.resident_count())
        # Overload control: bounded admission and a default deadline.
        # _queued_tokens mirrors the pending queue's token content
        # (updated under _pending_lock wherever the deque changes);
        # _admit_times feeds the drain-rate Retry-After; _cancel_ids
        # holds ids handed to cancel() until the loop's sweep acts.
        self.max_queued_requests = max_queued_requests
        self.max_queued_tokens = max_queued_tokens
        self.default_timeout_s = default_timeout_s
        self._queued_tokens = 0
        self._admit_times: 'collections.deque' = collections.deque(
            maxlen=256)
        self._cancel_ids: set = set()
        # Scheduler event log (bounded): admissions, prefill chunks,
        # decode and verify dispatches, preemptions, cancels, deadlines,
        # adapter loads and evictions.
        self.events: 'collections.deque' = collections.deque(
            maxlen=4096)
        self.wake = threading.Event()
        self._stop = False
        # Set on engine DEATH (never on clean close): submits after
        # the loop died get it ahead of their sentinel.
        self._death_exc: Optional[BaseException] = None
        self._metrics = _engine_metrics()
        self._metrics['slots'].set(slots)
        self._cache_bytes = self.pool.nbytes
        self._metrics['kv_bytes'].set(self._cache_bytes)
        self._metrics['kv_blocks_total'].set(self.pool.usable_blocks)
        self._profiler = profiling_lib.StepProfiler('decode')
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    # -- client API -----------------------------------------------------

    def submit(self, prompt_ids: List[int], max_new: int,
               eos_id: Optional[int] = None, **deferred) -> 'queue.Queue':
        """Returns a Queue yielding generated ids then None. With
        ``eos_id``, the row retires the moment it emits that id (the
        EOS itself is emitted, matching greedy_generate). A request the
        pool can never hold yields a typed ``KVPoolExhaustedError``
        before its None. ``deferred`` takes the JAX engine's other
        request knobs: ``temperature > 0`` samples with keys (seed,
        position); ``response_format`` ({'type': 'json_schema' |
        'regex', ...}) constrains decoding to the grammar (it needs the
        engine's ``grammar_vocab`` and an ``eos_id``; a bad grammar
        yields a typed ``GrammarError`` before the None). A refused
        (bounded-admission) request yields a typed
        ``EngineOverloadedError``, an expired one a
        ``DeadlineExceededError``, an adapter the engine cannot serve an
        ``AdapterNotFoundError`` or ``AdapterCapacityError``."""
        return self.submit_request(prompt_ids, max_new, eos_id=eos_id,
                                   **deferred).out

    def submit_request(self, prompt_ids: List[int], max_new: int,
                       eos_id: Optional[int] = None,
                       tenant: Optional[str] = None,
                       deadline: Optional[float] = None,
                       priority: str = 'interactive',
                       adapter: Optional[str] = None,
                       temperature: float = 0.0,
                       top_p: float = 1.0,
                       seed: int = 0,
                       response_format: Optional[dict] = None
                       ) -> _Request:
        """``submit`` returning the request object itself: ``.out`` is
        the token queue, ``.id`` the handle ``cancel`` takes, and after
        admission (by the first token)
        ``.prefix_hit_blocks``/``.prefix_miss_blocks`` carry the
        prefix-cache accounting and ``.adapter_hit`` the adapter's
        residency. ``deadline`` is an absolute epoch second (None falls
        back to ``default_timeout_s``). Bad knobs raise ``ValueError``
        here (the replica validates the HTTP body itself, to answer a
        400 naming the field)."""
        if priority not in PRIORITIES:
            raise ValueError(f'priority must be one of {PRIORITIES}, '
                             f'got {priority!r}')
        if not isinstance(seed, int) or isinstance(seed, bool):
            raise ValueError(f'seed must be an integer, got {seed!r}')
        # Keys take uint32(seed), so any int counts mod 2**32; it is kept
        # as the int32 two's complement of that value, the form the
        # per-row seed tensor holds.
        seed &= 0xFFFFFFFF
        if seed >= 1 << 31:
            seed -= 1 << 32
        temperature = float(temperature)
        top_p = float(top_p)
        if temperature < 0.0:
            raise ValueError(
                f'temperature must be >= 0, got {temperature}')
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f'top_p must be in (0, 1], got {top_p}')
        if not self.sampling and (temperature > 0.0
                                  or response_format is not None):
            raise ValueError(
                'this engine was built with sampling=False and '
                'cannot serve sampled or constrained requests')
        if deadline is None and self.default_timeout_s is not None:
            deadline = time.time() + self.default_timeout_s
        max_new = min(max_new, self.max_seq - len(prompt_ids) - 1)
        req = _Request(list(prompt_ids), max(0, max_new), eos_id=eos_id,
                       tenant=tenant, deadline=deadline,
                       priority=priority, adapter=adapter,
                       temperature=temperature, top_p=top_p, seed=seed,
                       response_format=response_format)
        if response_format is not None:
            # Compiled (cached by grammar hash) here, so a bad grammar
            # fails this request typed before any KV is touched.
            try:
                if self._grammar_vocab is None:
                    raise grammar_lib.GrammarError(
                        'this engine serves no structured decoding '
                        '(start it with a grammar_vocab to serve '
                        'response_format requests)')
                if eos_id is None:
                    raise grammar_lib.GrammarError(
                        'response_format requires an eos_id (the '
                        'grammar decides completion by allowing '
                        'EOS only at accepting states)')
                req.grammar = grammar_lib.compile_grammar(
                    response_format, self._grammar_vocab, eos_id)
            except grammar_lib.GrammarError as e:
                self._fail_request(
                    req, f'response_format refused: {e}', exc=e)
                return req
        if adapter is not None:
            # Typed refusal for adapters this engine can NEVER serve: no
            # adapter set, an unknown id, or a rank over the bucket.
            # Residency is not required: a known adapter cold-loads and
            # the request is admitted the iteration its weights land.
            try:
                if self._adapters is None:
                    raise exceptions.AdapterCapacityError(
                        'this engine serves no adapters (start it with '
                        'an adapter registry and capacity >= 1 to serve '
                        'LoRA requests)')
                self._adapters.check_fits(adapter)
            except exceptions.AdapterError as e:
                self._fail_request(
                    req, f'adapter {adapter!r} refused: {e}', exc=e)
                return req
        if req.deadline is not None and time.time() >= req.deadline:
            # Already past its deadline: refuse now rather than queue
            # work nobody waits for.
            self._metrics['deadline_exceeded'].inc()
            self._fail_request(
                req, 'deadline expired before admission',
                exc=exceptions.DeadlineExceededError(
                    'deadline expired before admission'))
            return req
        if req.max_new == 0 or self._stop:
            # A DEAD engine fails post-death submits typed.
            if self._stop and self._death_exc is not None:
                req.out.put(self._death_exc)
            req.out.put(None)
            return req
        if self.pool.blocks_for(len(prompt_ids) + 1) > \
                self.pool.usable_blocks:
            # This prompt alone exceeds the whole pool: fail THIS
            # request now; transient exhaustion preempts instead.
            self._fail_request(
                req, f'prompt of {len(prompt_ids)} tokens needs '
                f'{self.pool.blocks_for(len(prompt_ids) + 1)} KV '
                f'blocks but the pool has only '
                f'{self.pool.usable_blocks} usable '
                f'(block_size={self.block_size})')
            return req
        cost = len(req.prompt_ids)
        victim = None
        with self._pending_lock:
            reason = self._shed_reason(cost)
            if reason is not None and req.priority == 'interactive':
                # Shedding takes batch first: an interactive arrival
                # evicts the YOUNGEST queued batch request rather than
                # being refused itself.
                victim = self._evict_queued_batch()
                if victim is not None:
                    reason = None
            if reason is not None:
                retry_after = self._retry_after_locked()
            else:
                self.pending.append(req)
                self._queued_tokens += cost
        if victim is not None:
            self._metrics['shed'].labels(reason='priority_evict').inc()
            msg = 'shed from the pending queue to admit an interactive ' \
                  'request'
            self._fail_request(victim, msg,
                               exc=exceptions.EngineOverloadedError(
                                   msg, retry_after_s=self._retry_after()))
        if reason is not None:
            self._metrics['shed'].labels(reason=reason).inc()
            self._fail_request(
                req, f'pending queue full ({reason})',
                exc=exceptions.EngineOverloadedError(
                    f'pending queue full ({reason})',
                    retry_after_s=retry_after))
            return req
        self.wake.set()
        # close()/death may have stopped the loop between the _stop
        # check above and the append: sentinel it here.
        if self._stop:
            if self._death_exc is not None:
                req.out.put(self._death_exc)
            req.out.put(None)
        return req

    def generate(self, prompt_ids: List[int], max_new: int,
                 eos_id: Optional[int] = None, **knobs) -> List[int]:
        """Blocking convenience: collect the full generation. Raises
        the typed error if the request failed."""
        q = self.submit(prompt_ids, max_new, eos_id=eos_id, **knobs)
        out: List[int] = []
        while True:
            tok = q.get()
            if tok is None:
                return out
            if isinstance(tok, BaseException):
                raise tok
            out.append(tok)

    def cancel(self, request_id) -> None:
        """Tear down an in-flight or queued request: its KV blocks are
        freed at the next iteration boundary through the reclaim path
        preemption uses, and its token queue gets the None sentinel.
        Takes the ``_Request`` from ``submit_request`` or its ``.id``;
        an unknown or finished request is a no-op."""
        if isinstance(request_id, _Request):
            request_id.cancelled = True
        else:
            with self._pending_lock:
                self._cancel_ids.add(request_id)
        self.wake.set()

    def close(self):
        self._stop = True
        self.wake.set()
        self.thread.join(timeout=10)
        if self.thread.is_alive():
            # A wedged dispatch is holding the loop past the join.
            self._metrics['loop_hang'].inc()
            logger.error(
                'Batching engine loop thread still alive after close() '
                'join timeout — a dispatch is likely wedged.')

    # -- device state -----------------------------------------------------

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A device copy of a host tensor that never waits on the
        device: on CUDA, a pinned snapshot copied asynchronously (the
        caching host allocator keeps it until the copy has run)."""
        if self.device.type != 'cuda':
            return host.clone()
        return host.pin_memory().to(self.device, non_blocking=True)

    def _h2d(self, data, dtype: torch.dtype) -> torch.Tensor:
        return self._to_device(torch.tensor(data, dtype=dtype))

    def _sync_tables(self) -> None:
        if self._tables_dirty:
            self.block_tables = self._to_device(self._tables_host)
            self._tables_dirty = False

    def _adapter_args(self, idx: Optional[List[int]] = None) -> dict:
        """The device steps' ``adapters``/``adapter_idx`` keywords:
        empty while the engine has no adapter set (the steps then run
        exactly the adapterless math), else the resident set's buffers
        and each row's slot (``idx`` defaults to the whole batch's;
        prefill passes its one row's ``[slot]``)."""
        if self._adapters is None:
            return {}
        if idx is None:
            idx = self.slot_adapter
        return {'adapters': self._adapters.buffers(),
                'adapter_idx': self._h2d(idx, torch.int32)}

    # -- sampling and grammar ---------------------------------------------

    def _sampling_needed(self) -> bool:
        return self.sampling and any(
            r is not None and (r.temperature > 0.0
                               or r.grammar is not None)
            for r in self.slot_req)

    def _knob_rows(self) -> Dict[str, torch.Tensor]:
        """Per-slot temps, top_ps and seeds on the device: empty rows
        get greedy-neutral values (their lanes are parked, their draws
        never emitted)."""
        reqs = self.slot_req
        return {'temps': self._h2d([r.temperature if r else 0.0
                                    for r in reqs], torch.float32),
                'top_ps': self._h2d([r.top_p if r else 1.0
                                     for r in reqs], torch.float32),
                'seeds': self._h2d([r.seed if r else 0 for r in reqs],
                                   torch.int32)}

    def _sampling_args(self):
        """The decode step's ``sampling`` argument: None while every
        admitted row is greedy and unconstrained (the greedy step runs),
        else the per-row knobs and the mask table, constrained rows
        pointing ``mask_idx`` at their slot's line."""
        if not self._sampling_needed():
            return None
        idx = [i + 1 if r is not None and r.grammar is not None else 0
               for i, r in enumerate(self.slot_req)]
        return dict(self._knob_rows(), mask_table=self._mask_table,
                    mask_idx=self._h2d(idx, torch.int32))

    def _verify_sampling_args(self, toks: List[List[int]],
                              n_real: List[int]):
        """The verify step's ``sampling`` argument: the same knobs, but
        the grammar masks are PER POSITION ([M, W, V]): row r's mask at
        lane j is the DFA state after its drafts 1..j, walked here
        along the (grammar-filtered) draft. With no constrained row the
        table is one all-allowed line, every index 0."""
        if not self._sampling_needed():
            return None
        w = self.draft_k + 1
        con = [i for i, r in enumerate(self.slot_req)
               if r is not None and r.grammar is not None]
        idx = [0] * self.slots
        if not con:
            table = torch.ones((1, w, self.config.vocab_size),
                               dtype=torch.bool, device=self.device)
        else:
            host = np.ones((self.slots + 1, w, self.config.vocab_size),
                           dtype=bool)
            for i in con:
                req = self.slot_req[i]
                idx[i] = i + 1
                if n_real[i] <= 0:
                    continue
                st = req.grammar_state
                host[i + 1, 0] = req.grammar.allowed(st)
                for j in range(1, n_real[i]):
                    st = req.grammar.advance(st, toks[i][j])
                    host[i + 1, j] = req.grammar.allowed(st)
            table = self._to_device(torch.from_numpy(host))
        return dict(self._knob_rows(), mask_table=table,
                    mask_idx=self._h2d(idx, torch.int32))

    def _refresh_mask_row(self, row: int) -> None:
        """Copy the row's current grammar mask into its line of the
        device mask table (one [V] upload per constrained row per
        emitting dispatch)."""
        req = self.slot_req[row]
        if req is None or req.grammar is None:
            return
        self._mask_table[row + 1].copy_(self._to_device(torch.from_numpy(
            req.grammar.allowed(req.grammar_state))))

    @staticmethod
    def _filter_draft_grammar(req: _Request,
                              draft: List[int]) -> List[int]:
        """Cut an n-gram draft at the first token the request's grammar
        refuses: the verify mask would force the realization off it, so
        it could only burn lanes."""
        st = req.grammar_state
        out: List[int] = []
        for t in draft:
            if not req.grammar.allowed(st)[t]:
                break
            st = req.grammar.advance(st, t)
            out.append(t)
        return out

    # -- scheduling helpers ---------------------------------------------

    @staticmethod
    def _queue_cost(req: _Request) -> int:
        """Tokens a PENDING request will prefill when admitted (prompt
        plus resume tokens): the currency of ``max_queued_tokens``.
        Stable while queued, so append/pop accounting stays
        symmetric."""
        return len(req.prompt_ids) + len(req.generated)

    def _pop_pending(self) -> Optional[_Request]:
        with self._pending_lock:
            try:
                req = self.pending.popleft()
            except IndexError:
                return None
            self._queued_tokens -= self._queue_cost(req)
            return req

    def _push_front(self, req: _Request) -> None:
        with self._pending_lock:
            self.pending.appendleft(req)
            self._queued_tokens += self._queue_cost(req)

    def _shed_reason(self, cost: int) -> Optional[str]:
        """Which admission bound a ``cost``-token arrival would trip
        (None = admit). Caller holds ``_pending_lock``. An empty queue
        always admits whatever the token bound: one oversized request
        degrades to FIFO progress, never a permanent refusal."""
        n_q = len(self.pending)
        if self.max_queued_requests is not None \
                and n_q >= self.max_queued_requests:
            return 'max_queued_requests'
        if self.max_queued_tokens is not None and n_q > 0 \
                and self._queued_tokens + cost > self.max_queued_tokens:
            return 'max_queued_tokens'
        return None

    def _evict_queued_batch(self) -> Optional[_Request]:
        """Remove and return the YOUNGEST queued batch-priority request
        (None if only interactive ones are queued). Caller holds
        ``_pending_lock``."""
        for idx in range(len(self.pending) - 1, -1, -1):
            cand = self.pending[idx]
            if cand.priority == 'batch':
                del self.pending[idx]
                self._queued_tokens -= self._queue_cost(cand)
                return cand
        return None

    def _retry_after_locked(self) -> float:
        """Retry-After from the recent admission drain rate: queue
        depth over admissions per second in the trailing 30 s, clamped
        to [1, 60]. Caller holds ``_pending_lock``."""
        now = time.time()
        times = [t for t in self._admit_times if t > now - 30.0]
        if len(times) >= 2 and now > times[0]:
            rate = len(times) / (now - times[0])
            est = (len(self.pending) + 1) / max(rate, 1e-6)
        else:
            est = 1.0
        return min(60.0, max(1.0, est))

    def _retry_after(self) -> float:
        with self._pending_lock:
            return self._retry_after_locked()

    def _fail_request(self, req: _Request, msg: str,
                      exc: Optional[BaseException] = None) -> None:
        """Typed per-request failure: the REQUEST fails; every other
        in-flight request keeps decoding. ``exc`` overrides the default
        ``KVPoolExhaustedError``."""
        logger.warning('Batching engine failing request: %s', msg)
        req.out.put(exc if exc is not None
                    else exceptions.KVPoolExhaustedError(msg))
        req.out.put(None)

    def _set_table_row(self, row: int) -> None:
        blocks = self.slot_blocks[row]
        self._tables_host[row] = kv_pool_lib.SCRATCH_BLOCK
        if blocks:
            self._tables_host[row, :len(blocks)] = torch.tensor(
                blocks, dtype=torch.int32)
        self._tables_dirty = True

    def _release_row(self, row: int) -> None:
        req = self.slot_req[row]
        if self._adapters is not None and req is not None \
                and req.adapter is not None and self.slot_adapter[row]:
            # Drop the admission-time pin: the last in-flight row of an
            # adapter makes it evictable again (still resident, at the
            # warm end of the LRU).
            self._adapters.unpin(req.adapter)
        self.slot_adapter[row] = 0
        if self.slot_blocks[row]:
            # One decrement per held block — shared (pinned) prefix
            # blocks stay alive for their other holders. DEEPEST first,
            # so released chains enter the cached LRU leaf-first.
            self.pool.free(list(reversed(self.slot_blocks[row])))
        self.slot_blocks[row] = []
        self.slot_req[row] = None
        self.slot_left[row] = 0
        self._set_table_row(row)  # stale entries must not alias
        #                           blocks recycled to other rows

    def _retire(self, row: int) -> None:
        self._release_row(row)

    def _preempt(self, row: int) -> None:
        """Reclaim the row's blocks and requeue its request at the
        FRONT of the pending queue (it keeps its submit time, so it
        ages toward never-preempted oldest)."""
        req = self.slot_req[row]
        req.preemptions += 1
        self._metrics['preemptions'].inc()
        self.events.append(('preempt', row, len(req.generated)))
        logger.info(
            'KV pool exhausted: preempting request in row %d (%d blocks '
            'reclaimed, %d tokens generated so far).', row,
            len(self.slot_blocks[row]), len(req.generated))
        self._release_row(row)
        self._push_front(req)

    def _pick_victim(self) -> Optional[int]:
        """The LOWEST-PRIORITY-YOUNGEST admitted row: every batch row
        goes before any interactive one, and within a class the
        youngest (latest submit time; admission order breaks ties).
        None while only one row is admitted: the oldest request of the
        highest admitted class is never preempted while any other row
        exists, and a preempted request keeps its submit time, so it
        ages into that protection."""
        rows = [i for i in range(self.slots)
                if self.slot_req[i] is not None]
        if len(rows) <= 1:
            return None
        return max(rows, key=lambda i: (
            PRIORITIES.index(self.slot_req[i].priority),
            self.slot_req[i].submitted_at, self.slot_seq[i]))

    def _ensure_blocks(self, row: int, target_tokens: int) -> bool:
        """Grow the row's allocation to cover ``target_tokens``
        positions, preempting the youngest request on exhaustion.
        Returns False if the row itself was preempted or failed."""
        need = self.pool.blocks_for(target_tokens)
        extra = need - len(self.slot_blocks[row])
        if extra <= 0:
            return True
        while True:
            got = self.pool.try_alloc(extra)
            if got is not None:
                self.slot_blocks[row].extend(got)
                self._set_table_row(row)
                return True
            victim = self._pick_victim()
            if victim is None:
                # The only admitted request still cannot grow: the pool
                # can never satisfy it.
                req = self.slot_req[row]
                self._release_row(row)
                self._fail_request(
                    req, f'request needs {need} KV blocks but the '
                    f'pool has only {self.pool.usable_blocks} '
                    f'usable (block_size={self.block_size})')
                return False
            self._preempt(victim)
            if victim == row:
                return False

    # -- admission and prefill --------------------------------------------

    def _match_prefix(self, req: _Request, tokens_all: List[int],
                      t0: int):
        """Prefix-cache lookup for an admission: returns
        (pinned_blocks, cow, cached_tokens) — the full-block chain hits
        (already pinned) and an optional (src_block, shared_tokens)
        partial hit past them. Reuse is capped at t0 - 1 tokens: the
        LAST prompt token is always recomputed so its logits seed
        decoding."""
        if not self.prefix_caching or t0 < 2:
            return [], None, 0
        root = prefix_hash.adapter_root(req.adapter)
        if req.chain_t0 == t0 and req.chain_hashes:
            # Re-admission after _unwind_admission: same tokens.
            hashes = req.chain_hashes
        else:
            # Adapter-salted root: KV content depends on the adapter
            # (the v rows carry its delta), so per-adapter chains never
            # alias each other's or the base model's.
            hashes = prefix_hash.chain_hashes(tokens_all,
                                              self.block_size, root=root)
            req.chain_hashes = hashes
            req.chain_t0 = t0
        matched = self.pool.match(hashes)
        matched = matched[:(t0 - 1) // self.block_size]
        cached_tokens = len(matched) * self.block_size
        parent = hashes[len(matched) - 1] if matched else root
        cow = None
        rest = tokens_all[cached_tokens:
                          min(cached_tokens + self.block_size, t0 - 1)]
        if rest:
            cow = self.pool.partial_match(parent, rest)
        if matched:
            self.pool.pin(matched)
        return matched, cow, cached_tokens

    def _unwind_admission(self, req: _Request,
                          blocks: List[int]) -> None:
        """Admission could not complete (pool momentarily full):
        release whatever was pinned/allocated — exactly once — and
        requeue the request at the front."""
        if blocks:
            self.pool.free(list(reversed(blocks)))
        self._push_front(req)

    def _poll_adapter_loads(self) -> None:
        """Engine-loop tick of the adapter subsystem: install completed
        cold loads (logging ``adapter_load``/``adapter_evict`` events),
        fail the waiters of a failed load typed, drop cancelled and
        expired waiters, and re-queue the waiters whose adapter just
        became resident, at the FRONT in their order."""
        if self._adapters is None:
            return
        ready, evicted, durations = self._adapters.poll()
        if ready:
            self._adapter_metrics['loads'].inc(len(ready))
            for sec in durations:
                self._adapter_metrics['load_seconds'].observe(sec)
            self.events.append(('adapter_load', tuple(ready)))
        if evicted:
            self._adapter_metrics['evictions'].inc(len(evicted))
            self.events.append(('adapter_evict', tuple(evicted)))
        if not self._adapter_wait:
            return
        now = time.time()
        failures: Dict[str, BaseException] = {}
        still_waiting: List[_Request] = []
        admit: List[_Request] = []
        for req in self._adapter_wait:
            if req.cancelled:
                self._metrics['cancelled'].inc()
                req.out.put(None)
                continue
            if req.deadline is not None and now >= req.deadline:
                self._metrics['deadline_exceeded'].inc()
                self._fail_request(
                    req, 'deadline expired waiting for adapter cold load',
                    exc=exceptions.DeadlineExceededError(
                        f'deadline expired waiting for adapter '
                        f'{req.adapter!r} to load'))
                continue
            if req.adapter not in failures:
                exc = self._adapters.take_failure(req.adapter)
                if exc is not None:
                    failures[req.adapter] = exc if isinstance(
                        exc, exceptions.AdapterError) else \
                        exceptions.AdapterError(
                            f'adapter {req.adapter!r} failed to load: '
                            f'{exc!r}')
            if req.adapter in failures:
                self._fail_request(
                    req, f'adapter {req.adapter!r} cold load failed',
                    exc=failures[req.adapter])
                continue
            if self._adapters.slot(req.adapter) is not None:
                admit.append(req)
            else:
                # Still loading, or its parked install lost a slot race:
                # re-kick (idempotent) and keep waiting.
                self._adapters.ensure_loading(req.adapter)
                still_waiting.append(req)
        self._adapter_wait = still_waiting
        for req in reversed(admit):
            self._push_front(req)

    def _admit_pending(self) -> None:
        """Token-budget admission: a request is admitted when a decode
        row is free AND the pool has blocks for its whole prompt (+1
        for the first generated token). With prefix caching the
        prompt's hash chain is matched first: hit blocks are PINNED and
        only the suffix past them is prefilled."""
        for row in range(self.slots):
            if self._stop:
                return
            if self.slot_req[row] is not None:
                continue
            req = self._pop_pending()
            if req is None:
                return
            if req.cancelled:
                # Client gone before admission: sentinel only, no pool.
                self._metrics['cancelled'].inc()
                req.out.put(None)
                continue
            if req.deadline is not None and time.time() >= req.deadline:
                self._metrics['deadline_exceeded'].inc()
                self._fail_request(
                    req, 'deadline expired before admission',
                    exc=exceptions.DeadlineExceededError(
                        'deadline expired before admission'))
                continue
            if req.adapter is not None and \
                    self._adapters.slot(req.adapter) is None:
                # Cold adapter: start the host read and park the request
                # aside; admission keeps flowing behind it, and
                # _poll_adapter_loads re-queues it when the weights land.
                if req.adapter_hit is None:
                    req.adapter_hit = False
                self._adapters.ensure_loading(req.adapter)
                self._adapter_wait.append(req)
                continue
            tokens_all = req.prompt_ids + req.generated
            t0 = len(tokens_all)
            need = self.pool.blocks_for(t0 + 1)
            if need > self.pool.usable_blocks:
                # A preempted request that grew past a small pool.
                self._fail_request(
                    req, f'request of {t0} tokens needs {need} KV '
                    f'blocks but the pool has only '
                    f'{self.pool.usable_blocks} usable')
                continue
            matched, cow, cached_tokens = self._match_prefix(
                req, tokens_all, t0)
            blocks = list(matched)
            if cow is not None:
                # Copy-on-write: duplicate the partially-matching cached
                # block into a private one; prefill resumes at the first
                # divergent token, overwriting the rest.
                src, shared = cow
                self.pool.pin([src])     # eviction-proof during copy
                got = self.pool.try_alloc(1)
                if got is None:
                    self.pool.free([src])
                    self._unwind_admission(req, blocks)
                    return
                kv_pool_lib.copy_pool_block(self.caches, src, got[0])
                self.pool.free([src])
                blocks.append(got[0])
                cached_tokens += shared
            extra = need - len(blocks)
            got = self.pool.try_alloc(extra) if extra > 0 else []
            if got is None:
                # Not enough free blocks yet: in-flight rows progress
                # every iteration, so waiting cannot deadlock.
                self._unwind_admission(req, blocks)
                return
            blocks.extend(got)
            if self.prefix_caching:
                # Over PROMPT blocks only; a COW partial hit counts as a
                # miss (the block is copied and partly re-prefilled).
                hit = len(matched)
                miss = max(0, self.pool.blocks_for(t0) - hit)
                self._metrics['prefix_hits'].inc(hit)
                self._metrics['prefix_misses'].inc(miss)
                self._prefix_hits_local += hit
                self._prefix_misses_local += miss
                req.prefix_hit_blocks += hit
                req.prefix_miss_blocks += miss
            if not req.admitted_once:
                # First admission only: a preempted request's
                # re-admission delay is service disruption, not queueing.
                t_admit = time.time()
                self._metrics['queue_wait'].observe(
                    t_admit - req.submitted_at)
                trace_lib.record_span('batch.queue_wait',
                                      req.submitted_at, t_admit,
                                      req.trace_ctx, attrs={'slot': row})
                req.admitted_once = True
                self._metrics['requests'].inc()
                if self.sampling and req.temperature > 0.0:
                    self._metrics['sampled_requests'].inc()
                if req.grammar is not None:
                    self._metrics['constrained_requests'].inc()
            # Drain-rate sample for the Retry-After estimate.
            self._admit_times.append(time.time())
            if req.adapter is not None:
                # Pinned for the row's lifetime, so its slot stays valid
                # until _release_row unpins. No eviction slips in between
                # the residency check above and this pin: evictions only
                # happen in _poll_adapter_loads, on this thread.
                self.slot_adapter[row] = self._adapters.pin(req.adapter)
                if req.adapter_hit is None:
                    req.adapter_hit = True
            else:
                self.slot_adapter[row] = 0
            self.slot_req[row] = req
            self.slot_blocks[row] = blocks
            # Cache-hit tokens are ALREADY in the row's blocks.
            self.slot_off[row] = cached_tokens
            self.slot_total[row] = t0
            self.slot_left[row] = 0
            self.slot_len[row] = 0
            self._prefill_t0[row] = None
            self._prefill_chunks[row] = 0
            self._admit_seq += 1
            self.slot_seq[row] = self._admit_seq
            self._set_table_row(row)
            if req.grammar is not None:
                # The DFA state from the EMITTED stream (empty at first
                # admission): a resumed request constrains from the state
                # it was preempted in.
                st = req.grammar.start
                for t in req.generated:
                    st = req.grammar.advance(st, t)
                req.grammar_state = st
                self._refresh_mask_row(row)
            self.events.append(('admit', row, cached_tokens, t0))
            # Park the lane OUT OF RANGE until prefill finishes: decode
            # dispatches treat the row as inactive but still write, and
            # write_index sends past-capacity positions to scratch.
            self.pos[row] = self.max_seq

    def _chunk_bucket(self, remaining: int) -> int:
        """Chunk length for a prefill dispatch: the smallest power of
        two >= the real chunk, capped at ``prefill_chunk``."""
        real = min(remaining, self.prefill_chunk)
        bucket = 1
        while bucket < real:
            bucket *= 2
        return min(bucket, self.prefill_chunk)

    def _run_prefill_row(self, row: int) -> int:
        """One prefill chunk for ``row``; returns the bucket tokens
        charged (0 if the row has nothing left)."""
        req = self.slot_req[row]
        t0 = self.slot_total[row]
        off = self.slot_off[row]
        if off >= t0:
            return 0
        bucket = self._chunk_bucket(t0 - off)
        real = min(t0 - off, bucket)
        if self._prefill_t0[row] is None:
            self._prefill_t0[row] = time.time()
        # The logical prompt is prompt_ids + generated.
        n_p = len(req.prompt_ids)
        if off + real <= n_p:
            chunk = req.prompt_ids[off:off + real]
        elif off >= n_p:
            chunk = req.generated[off - n_p:off - n_p + real]
        else:
            chunk = (req.prompt_ids[off:] +
                     req.generated[:off + real - n_p])
        padded = chunk + [0] * (bucket - real)
        self._sync_tables()
        logits, self.caches = decode.forward_paged(
            self.params, self._h2d([padded], torch.long), self.caches,
            self.block_tables[row], off, real, self.config,
            self.block_size, **self._adapter_args([self.slot_adapter[row]]))
        self.slot_off[row] = off + real
        self._prefill_chunks[row] += 1
        self.events.append(('prefill_chunk', row, off + real, t0))
        if self.slot_off[row] >= t0:
            self._finish_prefill(row, logits)
        return bucket

    def _tenant_weight(self, tenant: str) -> float:
        w = self.tenant_weights.get(tenant, 1.0)
        return w if w > 0 else 1.0

    def _class_weight(self, key: tuple) -> float:
        """Weight of a ``(tenant, priority)`` DRR class: the tenant's
        fair-share weight times the priority's prefill weight
        (interactive ahead of batch)."""
        tenant, priority = key
        return (self._tenant_weight(tenant) *
                PRIORITY_PREFILL_WEIGHTS.get(priority, 1.0))

    def _run_prefill_chunks(self) -> bool:
        """Run prefill chunks for admitted-but-unprefilled rows within
        this iteration's token budget. Chunks beyond the budget wait for
        the NEXT iteration — a decode dispatch runs in between (the
        chunked-prefill interleaving).

        The budget is split across (tenant, priority) classes by
        weighted deficit round-robin: each class with pending prefill
        accrues a weighted share per iteration and spends it in
        admission order; unspent credit carries over (capped at two
        budgets), so one tenant's long prompts cannot starve another's
        TTFT. The first chunk of an iteration may overdraft, so a budget
        smaller than one chunk still makes progress, and a second,
        deficit-blind pass keeps the scheduler work-conserving."""
        budget = self.max_batched_tokens or float('inf')
        self._prefill_spent_iter = 0
        rows = sorted(
            (i for i in range(self.slots)
             if self.slot_req[i] is not None
             and self.slot_off[i] < self.slot_total[i]),
            key=lambda i: self.slot_seq[i])
        if not rows:
            return False
        by_class: Dict[tuple, List[int]] = {}
        for i in rows:
            req = self.slot_req[i]
            by_class.setdefault((req.tenant or '', req.priority),
                                []).append(i)
        # Interactive ahead of batch within a tenant; the rotation below
        # still takes turns across iterations.
        classes = sorted(by_class,
                         key=lambda k: (k[0], PRIORITIES.index(k[1])))
        metered = budget != float('inf')
        if metered:
            total_w = sum(self._class_weight(c) for c in classes)
            for c in classes:
                self._tenant_deficit[c] = min(
                    self._tenant_deficit.get(c, 0.0)
                    + budget * self._class_weight(c) / total_w,
                    2.0 * budget)
            # A class with nothing pending banks no credit.
            for c in list(self._tenant_deficit):
                if c not in by_class:
                    del self._tenant_deficit[c]
        start = self._tenant_rr % len(classes)
        self._tenant_rr += 1
        order = classes[start:] + classes[:start]
        spent = 0.0
        ran_any = False
        for deficit_blind in (False, True):
            for c in order:
                for row in by_class[c]:
                    while (self.slot_req[row] is not None
                           and self.slot_off[row] < self.slot_total[row]
                           and not self._stop):
                        if spent >= budget:
                            return ran_any
                        if metered and not deficit_blind and ran_any \
                                and self._tenant_deficit.get(c, 0.0) < \
                                self._chunk_bucket(self.slot_total[row] -
                                                   self.slot_off[row]):
                            # Credit exhausted: this class waits (its
                            # credit carries over) while others run.
                            break
                        charged = self._run_prefill_row(row)
                        if charged <= 0:
                            break
                        spent += charged
                        self._prefill_spent_iter = int(spent)
                        if metered and not deficit_blind:
                            self._tenant_deficit[c] = \
                                self._tenant_deficit.get(c, 0.0) - charged
                        ran_any = True
            if not metered:
                break
        return ran_any

    def _register_prefix(self, row: int) -> None:
        """Publish the row's FULL prompt blocks into the prefix cache.
        The trailing partial block (still written by decode) is never
        registered — registered blocks are immutable from here on."""
        if not self.prefix_caching:
            return
        req = self.slot_req[row]
        t0 = self.slot_total[row]
        tokens_all = (req.prompt_ids + req.generated)[:t0]
        root = prefix_hash.adapter_root(req.adapter)
        if req.chain_t0 == t0 and req.chain_hashes:
            hashes = req.chain_hashes
        else:
            hashes = prefix_hash.chain_hashes(tokens_all,
                                              self.block_size, root=root)
        blocks = self.slot_blocks[row]
        parent = root
        for i, h in enumerate(hashes):
            self.pool.register(
                blocks[i], h, parent,
                tokens_all[i * self.block_size:(i + 1) * self.block_size])
            parent = h

    def _finish_prefill(self, row: int, logits: torch.Tensor) -> None:
        """Last prompt chunk done: its logits seed decoding — the first
        generated token comes from the prefill itself. A sampled or
        constrained row draws it keyed at position t0 - 1 (the last
        prompt token's index), the key decode would use there."""
        req = self.slot_req[row]
        t0 = self.slot_total[row]
        self._register_prefix(row)
        if self.sampling and (req.temperature > 0.0
                              or req.grammar is not None):
            allowed = None
            if req.grammar is not None:
                allowed = self._to_device(torch.from_numpy(
                    req.grammar.allowed(req.grammar_state)))
            first = int(sample_lib.sample_first(
                logits, req.temperature, req.top_p, req.seed, t0 - 1,
                allowed))
        else:
            first = int(logits[0].argmax())   # waits for the prefill
        # The int() above synchronizes, so these are real wall times.
        t_first = time.time()
        trace_lib.record_span('batch.prefill', self._prefill_t0[row],
                              t_first, req.trace_ctx,
                              attrs={'prompt_len': t0,
                                     'chunks': self._prefill_chunks[row]})
        if not req.generated:
            # A first admission (a resumed request's first token went
            # out before its preemption).
            trace_lib.record_span('batch.first_token', req.submitted_at,
                                  t_first, req.trace_ctx)
            self._metrics['ttft'].observe(t_first - req.submitted_at)
        self.pos[row] = t0
        self.tokens[row] = first
        self.slot_len[row] = t0
        self._metrics['tokens'].inc()
        req.out.put(first)
        req.generated.append(first)
        if req.grammar is not None:
            req.grammar_state = req.grammar.advance(req.grammar_state,
                                                    first)
        self.slot_left[row] = req.max_new - len(req.generated)
        if self.slot_left[row] <= 0 or first == req.eos_id:
            req.out.put(None)
            self._retire(row)
        elif req.grammar is not None:
            self._refresh_mask_row(row)

    # -- decode and speculation ---------------------------------------------

    def _spec_k_for(self, req: _Request) -> int:
        """Current draft length for a request, seeding new requests at
        the engine draft_k and re-probing collapsed ones with a
        1-token draft once their cooldown expires."""
        if req.spec_k is None:
            req.spec_k = self.draft_k
        if req.spec_k == 0 and req.spec_cooldown <= 0:
            req.spec_k = 1
            req.spec_window.clear()
        return req.spec_k

    def _collect_drafts(self, rows: List[int]) -> Dict[int, List[int]]:
        """Propose n-gram drafts for this dispatch's decode rows under
        what remains of the per-iteration token budget: every row costs
        its 1 base token, drafts are granted oldest-first from the
        remainder after prefill spending (a verify row costs drafted+1
        budget tokens)."""
        if not rows:
            return {}
        if self.max_batched_tokens is None:
            left = float('inf')
        else:
            left = (self.max_batched_tokens -
                    self._prefill_spent_iter - len(rows))

        def row_cap(row: int, k: int) -> int:
            cap = min(k, self.slot_left[row] - 1,
                      self.max_seq - self.slot_len[row] - 2)
            if left != float('inf'):
                cap = min(cap, int(left))
            return cap

        def draft_stream(req: _Request) -> List[int]:
            # Only the trailing match window matters.
            tail = req.generated[-SPEC_MATCH_WINDOW:]
            short = SPEC_MATCH_WINDOW - len(tail)
            if short > 0 and req.prompt_ids:
                tail = req.prompt_ids[-short:] + tail
            return tail

        drafts: Dict[int, List[int]] = {}
        min_k = self.draft_k
        for row in sorted(rows, key=lambda i: self.slot_seq[i]):
            if left <= 0:
                break
            req = self.slot_req[row]
            k = self._spec_k_for(req)
            cap = row_cap(row, k)
            if cap <= 0:
                continue
            # Evidence bars: 4-gram for nearly-collapsed requests,
            # trigram for first-ever proposals, bigram otherwise.
            if k <= SPEC_PROBE_K:
                bar = SPEC_PROBE_MIN_NGRAM
            elif not req.spec_window:
                bar = SPEC_FIRST_MIN_NGRAM
            else:
                bar = SPEC_MIN_NGRAM
            d = propose_ngram_draft(draft_stream(req), cap,
                                    min_ngram=bar)
            if d and req.grammar is not None:
                d = self._filter_draft_grammar(req, d)
            if d:
                drafts[row] = d
                left -= len(d)
                min_k = min(min_k, req.spec_k)
        # Low-value gate, relaxed to the smallest drafting row's k so a
        # cooldown re-probe (k=1) is never gated out of existence.
        if drafts and sum(map(len, drafts.values())) < \
                min(SPEC_MIN_DISPATCH_TOKENS, min_k):
            return {}
        if drafts:
            # Ride-along probes: collapsed rows re-probe for free inside
            # a verify dispatch that happens anyway.
            for row in rows:
                req = self.slot_req[row]
                if row in drafts or req.spec_k != 0 or left <= 0:
                    continue
                cap = row_cap(row, SPEC_PROBE_K)
                if cap <= 0:
                    continue
                d = propose_ngram_draft(draft_stream(req), cap,
                                        min_ngram=SPEC_PROBE_MIN_NGRAM)
                if d and req.grammar is not None:
                    d = self._filter_draft_grammar(req, d)
                if d:
                    drafts[row] = d
                    left -= len(d)
        return drafts

    def _trim_blocks(self, row: int) -> None:
        """Free the row's whole blocks past its committed frontier
        (keeping coverage for the next write position): a rejected
        draft can leave blocks holding nothing but abandoned rows. The
        table row is re-padded to scratch."""
        keep = self.pool.blocks_for(min(self.slot_len[row] + 1,
                                        self.max_seq))
        extra = self.slot_blocks[row][keep:]
        if not extra:
            return
        self.pool.free(list(reversed(extra)))
        del self.slot_blocks[row][keep:]
        self._set_table_row(row)

    def _dispatch_decode(self) -> bool:
        """One whole-batch dispatch over every row whose prefill is
        complete: a VERIFY dispatch (width draft_k+1) when any row
        carries a live n-gram draft, the plain ``steps_per_dispatch``
        decode otherwise."""
        def decode_rows():
            return [i for i in range(self.slots)
                    if self.slot_req[i] is not None
                    and self.slot_off[i] >= self.slot_total[i]]

        drafts = self._collect_drafts(decode_rows()) \
            if self.speculative else {}
        n = self.steps
        if any(self.slot_req[i].grammar is not None
               for i in decode_rows()):
            # Grammar masks advance on the host per emitted token, so a
            # constrained row forces 1-token dispatches.
            n = 1
        # Grow allocations for this dispatch's writes up front;
        # exhaustion preempts the youngest request (possibly a row in
        # this very list, which then sits the dispatch out).
        for i in decode_rows():
            if self.slot_req[i] is None:
                continue
            need = min(self.slot_left[i], n)
            if i in drafts:
                need = max(need, len(drafts[i]) + 1)
            self._ensure_blocks(
                i, min(self.slot_len[i] + need, self.max_seq))
        active_rows = decode_rows()
        if not active_rows:
            return False
        drafts = {i: d for i, d in drafts.items()
                  if self.slot_req[i] is not None}
        if drafts:
            return self._run_verify_dispatch(active_rows, drafts)
        # On-demand profiling: one "step" per decode dispatch.
        self._profiler.on_step()
        # Fixed dispatch length: rows that finish mid-dispatch overrun
        # harmlessly — their extra tokens are never emitted and their
        # overrun writes go to unallocated-table/scratch slots.
        active = self._h2d(
            [self.slot_req[i] is not None
             and self.slot_off[i] >= self.slot_total[i]
             and self.slot_left[i] > 0
             for i in range(self.slots)], torch.bool)
        self._sync_tables()
        t_dispatch = time.perf_counter()
        toks, self.caches, self.pos = decode_steps_paged(
            self.params, self.tokens, self.caches, self.block_tables,
            self.pos, active, self.config, n, self.block_size,
            **self._adapter_args(), sampling=self._sampling_args())
        self.tokens = toks[:, -1].contiguous()
        for i in active_rows:
            if self.slot_left[i] > 0:
                self.slot_len[i] = min(self.slot_len[i] + n,
                                       self.max_seq)
        host_toks = toks.cpu().tolist()   # the dispatch's one sync
        dispatch_s = time.perf_counter() - t_dispatch
        if dispatch_s > 0:
            # The sync above makes this real decode wall time for
            # len(active_rows) * n tokens.
            self._metrics['tok_s'].set(len(active_rows) * n / dispatch_s)
        self.events.append(('decode', len(active_rows), n))
        # One batch.decode span per traced request per dispatch, all on
        # the dispatch's wall window.
        t_chunk_end = time.time()
        t_chunk_start = t_chunk_end - dispatch_s
        emitted = 0
        for i in active_rows:
            emitted += self._emit_tokens(i, host_toks[i][:n],
                                         t_chunk_start, t_chunk_end)
        if emitted:
            self._metrics['tokens'].inc(emitted)
        return True

    def _emit_tokens(self, row: int, toks, t_start: float,
                     t_end: float) -> int:
        """Shared emission tail for decode AND verify dispatches: push
        tokens to the client in order until EOS or the request's
        budget, record the request's ``batch.decode`` span over
        [t_start, t_end], tick the speculation re-probe cooldown, and
        retire the row when done. Returns the number of tokens
        emitted."""
        req = self.slot_req[row]
        done = False
        row_emitted = 0
        for t in toks:
            if self.slot_left[row] <= 0:
                break
            req.out.put(int(t))
            req.generated.append(int(t))
            if req.grammar is not None:
                # The host half of structured decoding (a None state
                # falls back to unconstrained).
                req.grammar_state = req.grammar.advance(
                    req.grammar_state, int(t))
            row_emitted += 1
            self.slot_left[row] -= 1
            if int(t) == req.eos_id:
                done = True
                break
        if row_emitted:
            trace_lib.record_span(
                'batch.decode', t_start, t_end, req.trace_ctx,
                attrs={'tokens': row_emitted, 'slot': row})
        req.spec_cooldown = max(0, req.spec_cooldown - row_emitted)
        if done or self.slot_left[row] <= 0:
            req.out.put(None)
            self._retire(row)
        elif row_emitted and req.grammar is not None:
            self._refresh_mask_row(row)
        return row_emitted

    def _run_verify_dispatch(self, active_rows: List[int],
                             drafts: Dict[int, List[int]]) -> bool:
        """One speculative VERIFY dispatch: every decode-ready row
        rides the same ``verify_step_paged`` forward — rows with a
        draft verify draft+1 positions, draft-less rows decode their 1
        base token. A rejection at draft position a advances the row's
        ``pos`` by only a+1, and whole blocks past the committed
        frontier go back to the pool (``_trim_blocks``). Emission is
        ``preds[0..a]``."""
        w = self.draft_k + 1
        toks = [[0] * w for _ in range(self.slots)]
        n_real = [0] * self.slots
        for i in active_rows:
            req = self.slot_req[i]
            d = drafts.get(i, ())
            # generated[-1] is the row's current input token (the host
            # mirror of self.tokens[i]).
            toks[i][0] = req.generated[-1]
            toks[i][1:1 + len(d)] = d
            n_real[i] = 1 + len(d)
        self._profiler.on_step()
        self._sync_tables()
        t_dispatch = time.perf_counter()
        preds, accepted, self.pos, self.tokens, self.caches = \
            verify_step_paged(
                self.params, self._h2d(toks, torch.int32), self.caches,
                self.block_tables, self.pos,
                self._h2d(n_real, torch.int32), self.config, w,
                self.block_size, **self._adapter_args(),
                sampling=self._verify_sampling_args(toks, n_real))
        # The dispatch's one sync: predictions and counts together.
        host = torch.cat([preds, accepted[:, None]], dim=1).cpu().tolist()
        dispatch_s = time.perf_counter() - t_dispatch
        t_chunk_end = time.time()
        t_chunk_start = t_chunk_end - dispatch_s
        emitted = 0
        proposed_total = 0
        accepted_total = 0
        for i in active_rows:
            req = self.slot_req[i]
            d = drafts.get(i, [])
            a = int(host[i][w])
            if d:
                proposed_total += len(d)
                accepted_total += a
                self._metrics['spec_accept_rate'].labels(
                    mode='sampled' if (self.sampling
                                       and req.temperature > 0.0)
                    else 'greedy').observe(a / len(d))
                req.spec_window.append((len(d), a))
                new_k = update_spec_k(req.spec_k, req.spec_window,
                                      self.draft_k)
                if new_k != req.spec_k:
                    grew = new_k > req.spec_k
                    req.spec_k = new_k
                    if new_k == 0:
                        # Backed-off cooldown: repeated failed probes
                        # stretch the next one out exponentially.
                        req.spec_cooldown = (
                            SPEC_REPROBE_TOKENS *
                            (2 ** min(req.spec_fail_streak,
                                      SPEC_BACKOFF_MAX_EXP)))
                        req.spec_fail_streak += 1
                        req.spec_window.clear()
                    elif grew and new_k >= 2:
                        req.spec_fail_streak = 0
            # Committed KV: the base token + a accepted drafts; the
            # device already advanced pos/tokens by exactly this.
            self.slot_len[i] = min(self.slot_len[i] + a + 1,
                                   self.max_seq)
            emitted += self._emit_tokens(i, host[i][:a + 1],
                                         t_chunk_start, t_chunk_end)
            if self.slot_req[i] is not None and a < len(d):
                self._trim_blocks(i)
        if dispatch_s > 0:
            self._metrics['tok_s'].set(emitted / dispatch_s)
        if proposed_total:
            self._metrics['spec_proposed'].inc(proposed_total)
            self._spec_proposed_local += proposed_total
        if accepted_total:
            self._metrics['spec_accepted'].inc(accepted_total)
        self._spec_accepted_local += accepted_total
        self._metrics['spec_tokens_per_forward'].set(
            emitted / max(1, len(active_rows)))
        # 'decode' first for the interleaving contract (a verify IS
        # this iteration's decode dispatch); 'verify' carries the
        # speculation accounting.
        self.events.append(('decode', len(active_rows)))
        self.events.append(('verify', len(drafts), proposed_total,
                            accepted_total))
        if emitted:
            self._metrics['tokens'].inc(emitted)
        return True

    # -- overload sweep ---------------------------------------------------

    def _sweep_overload(self) -> None:
        """Iteration-boundary enforcement of cancellation and deadlines:
        a cancelled row frees its KV blocks through the reclaim path
        preemption uses (``_release_row``) and gets its sentinel (a
        ``cancel`` event); an expired row also gets the typed
        ``DeadlineExceededError`` (a ``deadline`` event). Queued and
        adapter-waiting requests are swept by the same rules."""
        now = time.time()
        cancel_ids = ()
        if self._cancel_ids:
            with self._pending_lock:
                cancel_ids, self._cancel_ids = self._cancel_ids, set()
        for row in range(self.slots):
            req = self.slot_req[row]
            if req is None:
                continue
            if req.id in cancel_ids:
                req.cancelled = True
            if req.cancelled:
                self.events.append(('cancel', row, len(req.generated)))
                self._metrics['cancelled'].inc()
                self._release_row(row)
                req.out.put(None)
            elif req.deadline is not None and now >= req.deadline:
                self.events.append(('deadline', row, len(req.generated)))
                self._metrics['deadline_exceeded'].inc()
                self._release_row(row)
                self._fail_request(
                    req, 'deadline expired mid-decode',
                    exc=exceptions.DeadlineExceededError(
                        f'deadline expired after {len(req.generated)} '
                        'generated tokens'))
        # Requests parked on an adapter cold load sit in neither a slot
        # nor the queue: mark them; _poll_adapter_loads drops them.
        for req in self._adapter_wait:
            if req.id in cancel_ids:
                req.cancelled = True
        dropped: List[_Request] = []
        with self._pending_lock:
            if self.pending:
                kept: 'collections.deque[_Request]' = collections.deque()
                for req in self.pending:
                    if req.id in cancel_ids:
                        req.cancelled = True
                    if req.cancelled or (req.deadline is not None
                                         and now >= req.deadline):
                        dropped.append(req)
                    else:
                        kept.append(req)
                if dropped:
                    self.pending = kept
                    self._queued_tokens = sum(
                        self._queue_cost(r) for r in kept)
        for req in dropped:
            if req.cancelled:
                self._metrics['cancelled'].inc()
                req.out.put(None)
            else:
                self._metrics['deadline_exceeded'].inc()
                self._fail_request(
                    req, 'deadline expired while queued',
                    exc=exceptions.DeadlineExceededError(
                        'deadline expired while queued'))

    # -- gauges -----------------------------------------------------------

    def _set_gauges(self) -> None:
        """The per-iteration gauge sweep: occupancy, the pending queue,
        the pool (used = referenced blocks; cached = refcount-0,
        reclaimable), resident adapters and the two windowed ratios."""
        self._metrics['occupancy'].set(sum(
            1 for r in self.slot_req if r is not None))
        with self._pending_lock:
            queued_reqs = len(self.pending)
            queued_toks = self._queued_tokens
        self._metrics['queued_requests'].set(queued_reqs)
        self._metrics['queued_tokens'].set(queued_toks)
        self._metrics['kv_blocks_used'].set(self.pool.used_blocks)
        self._metrics['kv_used'].set(
            self.pool.used_blocks * self.pool.block_bytes)
        self._metrics['kv_cached'].set(
            self.pool.cached_blocks * self.pool.block_bytes)
        self._metrics['prefix_cached_blocks'].set(
            self.pool.cached_blocks)
        if self._adapters is not None:
            self._adapter_metrics['resident'].set(
                self._adapters.resident_count())
        if self.prefix_caching:
            self._hit_ratio_gauge = self._windowed_ratio(
                self._prefix_window, self._prefix_hits_local,
                self._prefix_hits_local + self._prefix_misses_local,
                PREFIX_RATIO_WINDOW_SECONDS, self._hit_ratio_gauge,
                'skytpu_batch_prefix_hit_ratio',
                'Fraction of prompt KV blocks served from the prefix '
                'cache at admission over the trailing window (a '
                'windowed rate, not a since-boot cumulative — the '
                'prefix-hit-ratio-low alert needs regressions visible '
                'within its window).')
        if self.speculative:
            self._spec_ratio_gauge = self._windowed_ratio(
                self._spec_window, self._spec_accepted_local,
                self._spec_proposed_local, SPEC_RATIO_WINDOW_SECONDS,
                self._spec_ratio_gauge, 'skytpu_batch_spec_accept_ratio',
                'Accepted/proposed draft tokens over the trailing '
                'window (a windowed rate — the spec-accept-rate-low '
                'alert needs collapses visible within its window). '
                'LAZY: only exported by a speculative engine that '
                'proposed drafts in-window.')

    @staticmethod
    def _windowed_ratio(win, num: int, den: int, window_s: float, gauge,
                        name: str, help_text: str):
        """One windowed ratio gauge (the JAX engine's contract): append
        a (ts, num, den) snapshot at most once a second, prune to
        ``window_s``, and set ``name`` to the in-window delta ratio.
        Created lazily (no fake 0 before traffic), re-resolved by
        get-or-create on every write (a sibling engine's idle sweep may
        have unregistered the process-global family), and unregistered
        once the window holds no traffic, so an idle replica exports no
        frozen ratio. Returns the gauge, or None while idle."""
        now = time.time()
        if not win or now - win[-1][0] >= 1.0:
            win.append((now, num, den))
        horizon = now - window_s
        while len(win) > 1 and win[1][0] <= horizon:
            win.popleft()
        d_num = num - win[0][1]
        d_den = den - win[0][2]
        if d_den <= 0:
            if gauge is not None:
                metrics_lib.registry().unregister(name)
            return None
        gauge = metrics_lib.registry().gauge(name, help_text)
        gauge.set(d_num / d_den)
        return gauge

    # -- loop -----------------------------------------------------------

    def _fail_all(self, exc: BaseException) -> None:
        """Fail-stop for ENGINE death (an unexpected loop exception):
        unblock every waiter with the fatal exception ahead of its
        sentinel. Pool exhaustion never comes here."""
        logger.error('Batching engine died: %r', exc, exc_info=exc)
        self._drain_all(exc=exc)

    def _drain_all(self, exc: Optional[BaseException] = None) -> None:
        """Put the None sentinel (after ``exc`` on engine death) on
        every active and pending request, so no waiter blocks past
        loop exit; stash ``exc`` for requests submitted later."""
        if exc is not None:
            self._death_exc = exc
        self._stop = True
        for i, req in enumerate(self.slot_req):
            if req is not None:
                if exc is not None:
                    req.out.put(exc)
                req.out.put(None)
                self.slot_req[i] = None
        waiting, self._adapter_wait = self._adapter_wait, []
        for req in waiting:
            if exc is not None:
                req.out.put(exc)
            req.out.put(None)
        while True:
            req = self._pop_pending()
            if req is None:
                return
            if exc is not None:
                req.out.put(exc)
            req.out.put(None)

    def _loop(self) -> None:
        try:
            # Grad mode is per thread: the caller's inference_mode does
            # not reach this one.
            with torch.inference_mode():
                self._loop_inner()
            self._drain_all()
        except BaseException as e:  # pylint: disable=broad-except
            self._fail_all(e)

    def _loop_inner(self) -> None:
        while not self._stop:
            self._sweep_overload()
            self._poll_adapter_loads()
            self._admit_pending()
            progressed = self._run_prefill_chunks()
            ran = self._dispatch_decode()
            self._set_gauges()
            if not progressed and not ran:
                self.wake.wait(timeout=0.5)
                self.wake.clear()
