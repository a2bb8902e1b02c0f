"""KV-cache incremental decoding — the port of
``skypilot_tpu/models/decode.py`` (dense bf16/f32 or int8 cache,
greedy and sampled).

Prefill runs causal flash attention over the prompt's local q/k/v
(K1-cuda on the card); each decode step runs ``decode_attention`` over
the valid cache prefix (K4-cuda on the card). Differences from the JAX
module, by design:

- the cache is updated IN PLACE: ``KVCache`` holds mutable tensors and
  ``forward_cached`` writes the new rows into them, where JAX's
  ``dynamic_update_slice`` returns new arrays (donated by its jit);
- ``pos`` is a Python int, so slicing the cache and building the
  decode lengths never waits on the device;
- ``decode_tokens_scan`` is a Python loop (no ``lax.scan``) whose
  argmax stays on the device: no host sync per token;
- ``forward_paged`` (the batching engine's prefill chunk) writes the
  chunk's rows into the pool once: that write is both what this chunk's
  attention reads and the persisted state, where JAX writes in the layer
  and again after the layer scan;
- every forward's RoPE, int8 quantization and K/V write are one
  ``da.rope_cache_write`` a layer (K5F on the card), from a cos/sin
  table made once per forward (``rope_table``), where the JAX layer
  rotates, quantizes and updates the cache in turn for XLA to fuse.

int8 KV (``init_cache(kv_int8=True)``, int8 pools in ``forward_paged``)
follows the JAX contract: each new row is quantized per (position, kv
head) as it is written (``_quantize_kv``, codes bit-equal to JAX's); a
prefill attends its own exact rows (K1 over the local q/k/v, or the
chunk's rows spliced over their int8 round trip in ``forward_paged``),
and later steps read the codes (K4 on codes + scales on the card).
Weights may be int8 too (``models/quant.py``): the serving products
(``ops/matmul_invariant.matmul``, the M-invariant GEMM on the card; the
engine-off prompt on ``llama.matmul``) take both forms, with
``llama.matmul``'s rounding points.

Sampling (``sample_generate``) draws from one ``jax.random`` key split
per step, as the JAX module does, with the port's threefry
(``serve/sampling/prng.py``): the same key gives JAX's tokens.
MoE configs run the routed experts in every forward (``moe_mlp``: the
routing kernel, then each expert's products). Multi-LoRA serving:
``lora_gather_delta`` is the per-row gathered q/v
delta that ``forward_paged`` and the engine's device steps add (f32;
on the card a fixed-order kernel). ``decode_tokens_windowed`` comes with
a later slice (ROADMAP.md).
"""
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama
from skypilot_torch.ops import attention as attention_ops
from skypilot_torch.ops import decode_attention as da
from skypilot_torch.ops import matmul_invariant as mi
from skypilot_torch.ops import moe_route as moe_route_ops
from skypilot_torch.ops import rms_norm as rn
from skypilot_torch.serve.sampling import prng

Params = Dict[str, Any]
_NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """Mutable KV cache. k/v: [L, B, max_seq, Hkv, hd] in the compute
    dtype (bf16 or f32), or int8 codes with per-(position, head) bf16
    ``k_scale``/``v_scale`` [L, B, max_seq, Hkv] when quantized;
    ``pos`` — number of positions already written (the same for every
    row; ragged batches left-pad). ``forward_cached`` writes new rows
    into k/v (and the scales) in place and advances ``pos``."""
    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(config: llama.LlamaConfig, batch: int,
               max_seq: Optional[int] = None,
               device=None, kv_int8: bool = False,
               layout=None) -> KVCache:
    """A zeroed cache on ``device`` (default: cuda; raises without
    it); ``kv_int8``: int8 codes with bf16 scales. With a serving
    ``layout`` (:func:`serving_layout`) it holds this rank's
    ``n_kv_heads / tp`` kv heads (``decode_shardings``' cache spec)."""
    if config.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f'KV cache dtype {config.dtype}: only bf16/f32 (or int8 '
            'with kv_int8) are ported')
    dev = device_lib.resolve_device(device)
    max_seq = max_seq or config.max_seq_len
    nkv = (config.n_kv_heads if layout is None
           else layout.heads(config)[1])
    shape = (config.n_layers, batch, max_seq, nkv, config.head_dim)
    if kv_int8:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                device=dev))
    return KVCache(k=torch.zeros(shape, dtype=config.dtype, device=dev),
                   v=torch.zeros(shape, dtype=config.dtype, device=dev))


# Per-(batch, position, head) int8 codes and bf16 scales, and back.
_quantize_kv = da.quantize_kv
_dequant_kv = da.dequant_kv


def layer_list(cparams: Params, config: llama.LlamaConfig) -> list:
    """Per-layer views of the stacked ``[L, ...]`` params (int8
    ``{'q', 's'}`` pairs sliced pair-wise)."""
    layers = {name: llama.unbind_layers(w)
              for name, w in cparams['layers'].items()}
    return [{name: w[i] for name, w in layers.items()}
            for i in range(config.n_layers)]


# Per-row LoRA delta for mixed-adapter batches (the S-LoRA/Punica
# gather, ``serve/adapters/``): row b picks ITS adapter's stacked factors
# by slot index and applies ``(h @ A) @ B`` in float32, cast by the
# caller; slot 0 is all zeros, so a base-model row's delta is exactly 0.
# On the card a row's delta does not depend on its batch-mates, bit for
# bit (``ops/matmul_invariant.py``).
lora_gather_delta = mi.lora_gather_delta


def adapter_layers(adapters: Optional[Params],
                   n_layers: int) -> list:
    """Per-layer views of the resident set's stacked ``[L, C+1, ...]``
    factors (``ResidentAdapterSet.buffers()``); ``None`` per layer when
    ``adapters`` is None."""
    if adapters is None:
        return [None] * n_layers
    return [{name: buf[i] for name, buf in adapters.items()}
            for i in range(n_layers)]


def qkv_projections(config: llama.LlamaConfig, x: torch.Tensor,
                    lp: Params, lora=None, matmul=mi.matmul, delta=None,
                    layout=None):
    """A layer's residual add and attention norm, and its q/k/v
    projections (+ biases): x [B, T, D] -> (x + delta, q [B, T, H, hd],
    k/v [B, T, Hkv, hd]), before RoPE. ``delta``: the residual still to
    add to x (the previous layer's MLP output, ``attn_out_and_mlp``), or
    None for the first layer; the add and the norm are one
    ``ops/rms_norm.add_rms_norm``. Shared by every cached and paged layer
    body, as the JAX package's four layer-body variants share this math.
    ``lora``: None, or
    (this layer's adapter factors, adapter_idx [B]): the row-gathered
    deltas (``lora_gather_delta``) are added to q and v after the base
    projections and before the biases, as in every JAX step; None runs
    exactly the adapterless math. The products are the M-invariant GEMM
    (``ops/matmul_invariant.py``) and the norms ``ops/rms_norm.py``, as in
    every serving helper here: on the card a row's bits do not depend on
    the other rows of x. ``matmul``: the engine-off prompt passes
    ``llama.matmul`` (see ``_layer_cached``). ``layout``: a serving
    layout at ``tp`` > 1, whose weights are the rank's q/k/v columns:
    the rank's heads come back."""
    b, t, _ = x.shape
    hd = config.head_dim
    nh, nkv = ((config.n_heads, config.n_kv_heads) if layout is None
               else layout.heads(config))
    x, h = rn.add_rms_norm(x, delta, lp['attn_norm'], config.norm_eps,
                           config.norm_offset)
    q = matmul(h, lp['wq'])
    k = matmul(h, lp['wk'])
    v = matmul(h, lp['wv'])
    if lora is not None:
        ad, idx = lora
        q = q + lora_gather_delta(h, ad['wq_a'], ad['wq_b'],
                                  idx).to(q.dtype)
        v = v + lora_gather_delta(h, ad['wv_a'], ad['wv_b'],
                                  idx).to(v.dtype)
    if config.qkv_bias:
        q = q + lp['bq']
        k = k + lp['bk']
        v = v + lp['bv']
    return (x, q.reshape(b, t, nh, hd), k.reshape(b, t, nkv, hd),
            v.reshape(b, t, nkv, hd))


def _expert(w, e: int):
    """Expert ``e``'s [in, out] slice of a layer's expert stack, plain or
    int8 (``{'q': q[e], 's': s[e]}``)."""
    if isinstance(w, dict):
        return {'q': w['q'][e], 's': w['s'][e]}
    return w[e]


def moe_mlp(config: llama.LlamaConfig, h: torch.Tensor, lp: Params,
            matmul=mi.matmul, layout=None) -> torch.Tensor:
    """The routed expert MLP of every serving forward: h [B, T, D] ->
    [B, T, D], ``llama._moe_mlp``'s output without its aux. Each row of h
    is one routing group of capacity ``llama.moe_capacity(config, T)``, as
    in the JAX package (a prefill chunk's bucket is part of T).

    ``ops/moe_route.moe_route`` (one launch a layer on the card) gives
    each (token, choice) its expert, bf16 gate and capacity slot; the kept
    tokens are copied into a ``[E, B * C, D]`` dispatch buffer, row
    ``b * C + slot`` of their expert (dropped ones onto one scratch row
    past it); each expert's gate, up and down products run on its rows
    (``matmul``: the invariant GEMM, 3 E launches a layer; the engine-off
    prompt passes ``llama.matmul``), the activation once over all experts'
    rows; empty slots are never zeroed, since
    rows are independent and the combine never reads them. The combine
    adds the k products ``expert output * gate`` in f32 in ascending
    choice order and rounds once: each product is exact in f32, so for
    k = 2 the sum is the JAX einsum's. The dense ``[E, B * C]`` form keeps
    the launch count fixed and needs no host sync on expert counts.
    ``layout`` (``tp`` > 1): the expert stacks are the rank's ffn columns
    of gate and up and rows of down; the router runs whole on every rank,
    and the combined output is summed over ``tp`` once
    (``layout.reduce_from_tp``)."""
    b, t, d = h.shape
    n_exp, k = config.n_experts, config.moe_top_k
    cap = llama.moe_capacity(config, t)
    idx, gate, slot = moe_route_ops.moe_route(h, lp['router'], k, cap)
    rows = b * cap
    first = torch.arange(b, dtype=torch.int32, device=h.device) * cap
    dest = torch.where(slot >= 0, idx * rows + first[:, None, None] + slot,
                       n_exp * rows).view(-1).long()
    xin = h.new_empty((n_exp * rows + 1, d))
    xin.index_copy_(0, dest, h[:, :, None].expand(b, t, k, d).reshape(-1, d))
    xe = xin[:n_exp * rows].view(n_exp, rows, d)
    g = torch.stack([matmul(xe[e], _expert(lp['w_gate'], e))
                     for e in range(n_exp)])
    up = torch.stack([matmul(xe[e], _expert(lp['w_up'], e))
                      for e in range(n_exp)])
    act = llama.mlp_act(config)(g.float()).to(h.dtype) * up
    outs = [matmul(act[e], _expert(lp['w_down'], e)) for e in range(n_exp)]
    outs.append(h.new_zeros((1, d)))      # what a dropped choice reads
    picked = torch.cat(outs)[dest].view(b, t, k, d)
    acc = picked[:, :, 0].float() * gate[..., :1].float()
    for j in range(1, k):
        acc = acc + picked[:, :, j].float() * gate[..., j:j + 1].float()
    acc = acc.to(h.dtype)
    return acc if layout is None else layout.reduce_from_tp(acc)


def attn_out_and_mlp(config: llama.LlamaConfig, x: torch.Tensor,
                     attn: torch.Tensor, lp: Params, matmul=mi.matmul,
                     layout=None):
    """The rest of the layer: output projection and its residual add with
    the MLP's norm (one ``add_rms_norm``), then the gated MLP (f32 norm,
    the gate activation in f32 then cast back), or for MoE configs the
    routed experts (``moe_mlp``). attn [B, T, H, hd] -> (x [B, T, D]
    after the attention's residual, the MLP's output [B, T, D]): the
    MLP's residual is left to the next norm to add (``qkv_projections``'
    ``delta``, or ``final_norm``). ``layout`` (``tp`` > 1): the rank's
    heads, rows of wo and w_down and columns of gate and up; each
    row-parallel product is summed over ``tp``
    (``layout.reduce_from_tp``)."""
    b, t = attn.shape[:2]
    g = (lambda y: y) if layout is None else layout.reduce_from_tp
    x, h = rn.add_rms_norm(x, g(matmul(attn.reshape(b, t, -1), lp['wo'])),
                           lp['mlp_norm'], config.norm_eps,
                           config.norm_offset)
    if config.n_experts:
        return x, moe_mlp(config, h, lp, matmul, layout)
    gate = llama.mlp_act(config)(
        matmul(h, lp['w_gate']).float()).to(h.dtype)
    up = matmul(h, lp['w_up'])
    return x, g(matmul(gate * up, lp['w_down']))


def final_norm(config: llama.LlamaConfig, cparams: Params, x: torch.Tensor,
               delta: torch.Tensor) -> torch.Tensor:
    """The last layer's MLP residual and the final norm, in one
    ``add_rms_norm``: the normed rows the LM head reads."""
    return rn.add_rms_norm(x, delta, cparams['final_norm'],
                           config.norm_eps, config.norm_offset)[1]


def rope_table(config: llama.LlamaConfig, positions: torch.Tensor):
    """cos and sin [R, hd/2] f32 at ``positions`` [R]: made once per
    forward, read by every layer's ``rope_cache_write``."""
    angles = llama._rope_frequencies(config, positions)
    return torch.cos(angles), torch.sin(angles)


def _layer_cached(config: llama.LlamaConfig, x: torch.Tensor,
                  delta: Optional[torch.Tensor],
                  layer_params: Params, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: int, cos: torch.Tensor,
                  sin: torch.Tensor, dst: torch.Tensor,
                  prefill: bool = False,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None, layout=None):
    """One transformer layer over ``T`` new positions. x: [B, T, D] and
    ``delta``, the residual still to add to it (None at layer 0);
    k_cache/v_cache: this layer's [B, S, Hkv, hd] views (int8 with
    ``k_scale``/``v_scale`` [B, S, Hkv] when quantized), written in
    place at [pos, pos + T): row b * T + t of the layer's
    ``rope_cache_write`` goes to flat row ``dst`` = b * S + pos + t, its
    RoPE from row t of the [T, hd/2] ``cos``/``sin``. Returns (x, delta)
    for the next layer (``attn_out_and_mlp``). Same cast points as
    the JAX layer: f32 norms, the gate activation in f32 then cast
    back. The prompt (``prefill``) runs its products on ``llama.matmul``
    (cuBLAS on the card): no batch-invariance contract covers the
    engine-off path, and at its thousands of rows the invariant GEMM
    takes about three times as long. ``layout``: a serving layout; the
    layer runs on the rank's heads (``attn_out_and_mlp``)."""
    b, t, _ = x.shape
    s, nkv, hd = k_cache.shape[1:]
    matmul = llama.matmul if prefill else mi.matmul
    x, q, k, v = qkv_projections(config, x, layer_params, matmul=matmul,
                                 delta=delta, layout=layout)
    # The prompt attends its exact rotated k (quantization error only
    # enters later steps); the other forms read the cache.
    k_rot = torch.empty_like(k) if prefill else None
    q = da.rope_cache_write(
        q.view(b * t, -1, hd), k.view(b * t, nkv, hd),
        v.view(b * t, nkv, hd), cos, sin, k_cache.view(b * s, nkv, hd),
        v_cache.view(b * s, nkv, hd), dst,
        *(None if sc is None else sc.view(b * s, nkv)
          for sc in (k_scale, v_scale)),
        k_out=None if k_rot is None else k_rot.view(b * t, nkv, hd)
    ).view(b, t, -1, hd)

    scale = config.head_dim ** -0.5
    if t == 1:
        # Decode step: length-aware attention over the valid prefix
        # (the int8 codes and scales as they are; the new row included).
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=x.device)
        attn = da.decode_attention(q[:, 0], k_cache, v_cache, lengths,
                                   scale, k_scale, v_scale)[:, None]
    elif prefill:
        # Prefill at pos 0: the cache holds exactly this chunk, so
        # causal flash over the LOCAL q/k/v is the whole attention; it
        # reads the exact rows (quantization error only enters later
        # decode steps).
        attn = attention_ops.flash_attention(q, k_rot, v, causal=True,
                                             scale=scale)
    else:
        # A chunk after earlier positions: query i sees keys [0, pos + i]
        # of the cache, its own rows as written (K4-prefill's dense form on
        # the card, as ``forward_paged``).
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=x.device)
        attn = da.verify_attention(
            q, _dequant_kv(k_cache, k_scale, k.dtype),
            _dequant_kv(v_cache, v_scale, v.dtype), lengths, scale)
    return attn_out_and_mlp(config, x, attn, layer_params, matmul, layout)


def forward_cached(params: Params, tokens: torch.Tensor, cache: KVCache,
                   config: llama.LlamaConfig, last_only: bool = False,
                   prefill: bool = False, layout=None
                   ) -> Tuple[torch.Tensor, KVCache]:
    """Run ``tokens`` [B, T] at absolute positions
    [cache.pos, cache.pos + T), writing their K/V into ``cache`` in
    place. Returns (logits [B, T or 1, vocab] f32, cache) with
    ``cache.pos`` advanced by T.

    ``last_only``: project only the final position through the LM
    head. ``prefill``: promise that ``cache.pos == 0`` — the prompt
    then runs causal flash attention over its local q/k/v.

    ``layout`` (:func:`serving_layout`): ``params`` are this rank's
    blocks and ``cache`` holds its kv heads (``init_cache(layout=)``);
    each layer's dims sharded over a data axis are gathered whole for
    the layer (as ``llama._gathered_layer`` does), the layers run on the
    rank's heads and ffn columns, the embedding on its vocabulary
    window, and the logits come back as this rank's vocabulary columns
    (``layout.vocab_window``; :func:`greedy_token` picks across them)."""
    if prefill and cache.pos != 0:
        raise ValueError(f'prefill=True needs an empty cache, pos is '
                         f'{cache.pos}')
    b, t = tokens.shape
    s = cache.k.shape[2]
    if cache.pos + t > s:
        raise ValueError(f'cache overflow: pos {cache.pos} + {t} tokens '
                         f'> max_seq {s}')
    cparams = llama.compute_params(params, config)
    pos = cache.pos
    dev = tokens.device
    steps = torch.arange(t, dtype=torch.int32, device=dev)
    cos, sin = rope_table(config, pos + steps)                  # [T, hd/2]
    dst = (torch.arange(b, dtype=torch.int32, device=dev)[:, None] * s +
           pos + steps).view(-1)                                # [B * T]

    x = llama.embed_tokens(cparams, tokens, config, layout)
    specs = None if layout is None else layout.layer_specs()[0]
    delta = None
    for i, layer_params in enumerate(layer_list(cparams, config)):
        if layout is not None:
            layer_params = layout.gather(layer_params, specs)
        x, delta = _layer_cached(
            config, x, delta, layer_params, cache.k[i], cache.v[i], pos,
            cos, sin, dst, prefill=prefill,
            k_scale=None if cache.k_scale is None else cache.k_scale[i],
            v_scale=None if cache.v_scale is None else cache.v_scale[i],
            layout=layout)
    cache.pos = pos + t
    if last_only:
        x, delta = x[:, -1:], delta[:, -1:]
    x = final_norm(config, cparams, x, delta)
    matmul = llama.matmul if prefill else mi.matmul
    logits = matmul(x, llama.output_head(cparams, config, layout)).float()
    return logits, cache


def serving_layout(config: llama.LlamaConfig, mesh):
    """The params' place on ``mesh`` for serving (``decode_shardings``'
    param specs): raises where ``tp`` does not split the heads."""
    from skypilot_torch.parallel import sharding
    sharding.tp_heads(config, mesh.shape['tp'])
    return sharding.Layout(mesh, decode_shardings(config)[0])


def decode_shardings(config: llama.LlamaConfig, shard_batch: bool = True,
                     kv_int8: bool = False):
    """(param specs, cache specs) for sharded serving — the JAX
    ``decode_shardings`` (``skypilot_tpu/models/decode.py:518``) as spec
    tuples: the params on ``llama.param_sharding_rules`` (heads and ffn
    over ``tp``, the fsdp group ZeRO-style), the cache's kv-head axis
    over ``tp`` and, with ``shard_batch``, its batch over the data axes
    (False for a single-request replica). ``pos`` is replicated."""
    batch_axes = ('dp', 'fsdp', 'ep') if shard_batch else None
    kv = (None, batch_axes, None, 'tp', None)
    scale = (None, batch_axes, None, 'tp') if kv_int8 else None
    return (llama.param_sharding_rules(config),
            KVCache(k=kv, v=kv, pos=(), k_scale=scale, v_scale=scale))


def greedy_token(logits: torch.Tensor, layout=None) -> torch.Tensor:
    """The greedy ids of ``logits`` [..., V] as int32 (``argmax``; the
    first of equal maxima). With a ``layout`` at ``tp`` > 1 the logits
    are this rank's vocabulary columns: the maximum is all-reduced over
    ``tp``, then the lowest global id that holds it (MIN), so every rank
    gets ``argmax``'s id over the whole vocabulary."""
    if layout is None or layout.tp == 1:
        return logits.argmax(-1).to(torch.int32)
    top = layout.tp_max(logits.amax(-1))
    hit = logits == top[..., None]
    lo = layout.vocab_window(logits.shape[-1] * layout.tp)[0]
    first = torch.where(hit.any(-1), hit.int().argmax(-1) + lo,
                        logits.shape[-1] * layout.tp)
    return layout.tp_min(first).to(torch.int32)


def forward_paged(params: Params, tokens: torch.Tensor, pools,
                  block_row: torch.Tensor, start: int, real_len: int,
                  config: llama.LlamaConfig, block_size: int,
                  adapters=None, adapter_idx=None):
    """One PREFILL CHUNK of one request, written directly into its
    paged KV-pool blocks (``serve/kv_pool.py``).

    tokens [1, T] — positions [start, start + T) of the prompt, of
    which the first ``real_len`` are real (the rest pad the chunk to
    its bucket; their K/V writes go to the scratch block and their
    logits are never formed). ``pools`` is the engine's 4-tuple
    (k, v, k_scale, v_scale) with k/v [L, num_blocks, block_size, Hkv,
    hd] (int8 codes with bf16 scales [L, num_blocks, block_size, Hkv],
    or the scales None), updated in place; ``block_row`` [MB] int32 is
    THIS request's block table; ``start``/``real_len`` are host ints.

    Per layer the chunk's rows are rotated and written first (one
    ``rope_cache_write``, K5F on the card, from the chunk's cos/sin table
    made once), then the chunk attends causally from its start
    (``da.prefill_attention`` with lengths = start + 1: query i sees keys
    [0, start + i]) over the pool through ``block_row`` (in int8 its own
    rows from the chunk's exact k/v). Chunk c sees every earlier chunk's
    keys plus itself
    causally, and a prefix-cache hit is just a chunk that starts at the
    hit's offset. On the card that is one K4-prefill launch a layer, with
    no gathered view, and a position's bits equal K4-paged's decode step
    at the same position, whatever the chunk's bucket or start; the
    einsum-and-softmax form of the JAX step took other bits per chunk
    shape. Padded queries past ``real_len`` see the padding's keys; their
    outputs are never read.

    int8 pools: the chunk attends its exact rows (the JAX package's
    splice over their int8 round trip), while a LATER chunk reads earlier
    chunks' codes, so the engine equals the dense int8 path exactly for
    single-chunk prompts and tracks it past them, as in the JAX
    package.

    Adapters (``serve/adapters/``): ``adapters`` is the resident set's
    stacked factor dict (``[L, C+1, ...]``) and ``adapter_idx`` [1] this
    row's slot; the q and v deltas are the decode and verify steps'
    (``qkv_projections``), so prefill under an adapter writes the K/V
    its decode implies. None for both runs the adapterless math.

    Returns (logits [1, vocab] f32 at the chunk's last real position,
    pools). Layer math mirrors ``_layer_cached``."""
    if (adapters is None) != (adapter_idx is None):
        raise ValueError('forward_paged: adapters and adapter_idx go '
                         'together')
    from skypilot_torch.serve import kv_pool as kv_pool_lib
    k_pool, v_pool, ks_pool, vs_pool = pools
    quantized = ks_pool is not None
    nl, nb, bs = k_pool.shape[:3]
    if bs != block_size:
        raise ValueError(f'pool block size {bs} != block_size '
                         f'{block_size}')
    nkv, hd = config.n_kv_heads, config.head_dim
    _, t = tokens.shape
    if not 0 < real_len <= t:
        raise ValueError(f'real_len {real_len} outside (0, {t}]')
    cparams = llama.compute_params(params, config)
    dev = tokens.device
    cos, sin = rope_table(config, torch.arange(start, start + t,
                                               device=dev))
    x = llama.embed_tokens(cparams, tokens, config)

    kp = k_pool.view(nl, nb * bs, nkv, hd)
    vp = v_pool.view(nl, nb * bs, nkv, hd)
    ksp = ks_pool.view(nl, nb * bs, nkv) if quantized else None
    vsp = vs_pool.view(nl, nb * bs, nkv) if quantized else None
    gw = kv_pool_lib.chunk_write_indices(block_row, start, real_len, t,
                                         block_size)              # [T]
    table = block_row[None]
    ads = adapter_layers(adapters, config.n_layers)
    q_start = torch.full((1,), start + 1, dtype=torch.int32, device=dev)
    delta = None
    for i, lp in enumerate(layer_list(cparams, config)):
        x, q, k, v = qkv_projections(
            config, x, lp,
            None if ads[i] is None else (ads[i], adapter_idx), delta=delta)
        # The chunk attends its own exact rows: in bf16 as just written, in
        # int8 not their round trip (``k_rot``; later chunks and decode
        # read the codes).
        k_rot = torch.empty_like(k[0]) if quantized else None
        q = da.rope_cache_write(
            q[0], k[0], v[0], cos, sin, kp[i], vp[i], gw,
            *((ksp[i], vsp[i]) if quantized else (None, None)),
            k_out=k_rot)[None]
        q8 = dict(k_new=k_rot[None], v_new=v, k_scale=ksp[i],
                  v_scale=vsp[i]) if quantized else {}
        attn = da.prefill_attention(q, kp[i], vp[i], q_start, hd ** -0.5,
                                    block_table=table, block_size=bs, **q8)
        x, delta = attn_out_and_mlp(config, x, attn, lp)
    last = slice(real_len - 1, real_len)
    x_last = final_norm(config, cparams, x[:, last], delta[:, last])
    logits = mi.matmul(x_last,
                       llama.output_head(cparams, config)).float()
    return logits[:, 0], pools


def decode_tokens_scan(params: Params, first: torch.Tensor,
                       cache: KVCache, config: llama.LlamaConfig,
                       num_tokens: int, layout=None
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Greedy-decode ``num_tokens`` further tokens: one cached forward
    per token, the argmax kept on the device (the loop never waits on
    it). first: [B] the most recent token per row. Returns
    ([B, num_tokens] int32 generated ids, cache). ``layout``: as
    ``forward_cached``'s."""
    tok = first
    out = []
    for _ in range(num_tokens):
        logits, cache = forward_cached(params, tok[:, None], cache,
                                       config, layout=layout)
        tok = greedy_token(logits[:, -1], layout)
        out.append(tok)
    if not out:
        return torch.zeros((first.shape[0], 0), dtype=torch.int32,
                           device=first.device), cache
    return torch.stack(out, dim=1), cache


@torch.inference_mode()
def greedy_generate(params: Params, prompt: torch.Tensor,
                    config: llama.LlamaConfig, max_new_tokens: int,
                    max_seq: Optional[int] = None,
                    eos_id: Optional[int] = None,
                    kv_int8: bool = False, layout=None) -> torch.Tensor:
    """Greedy decode: prefill the prompt once, then one cached step
    per token. prompt: [B, T0] int on the params' device ->
    [B, <=max_new_tokens] int32 generated ids (rows that hit ``eos_id``
    are padded with it thereafter). ``kv_int8``: an int8 KV cache.
    ``layout`` (:func:`serving_layout`): ``params`` are this rank's
    blocks, and every rank of the mesh runs this call in lockstep on the
    same prompt; each gets the ids."""
    max_seq = max_seq or config.max_seq_len
    b, t0 = prompt.shape
    if t0 + max_new_tokens > max_seq:
        raise ValueError(f'prompt {t0} + max_new_tokens {max_new_tokens}'
                         f' > max_seq {max_seq}')
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int32,
                           device=prompt.device)
    cache = init_cache(config, b, max_seq, device=prompt.device,
                       kv_int8=kv_int8, layout=layout)
    logits, cache = forward_cached(params, prompt, cache, config,
                                   last_only=True, prefill=True,
                                   layout=layout)
    nxt = greedy_token(logits[:, -1], layout)
    if eos_id is None:
        toks, _ = decode_tokens_scan(params, nxt, cache, config,
                                     max_new_tokens - 1, layout)
        return torch.cat([nxt[:, None], toks], dim=1)
    done = nxt == eos_id
    out = [nxt]
    for _ in range(max_new_tokens - 1):
        if bool(done.all()):
            break
        logits, cache = forward_cached(params, nxt[:, None], cache,
                                       config, last_only=True,
                                       layout=layout)
        nxt = greedy_token(logits[:, -1], layout)
        # Per-row: once a row emitted EOS it keeps emitting EOS.
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        done = done | (nxt == eos_id)
        out.append(nxt)
    return torch.stack(out, dim=1)


def _filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row (ties at the k-th kept),
    NEG_INF the rest."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, _NEG_INF, logits)


def _filter_top_p(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering over the last axis: keep the smallest prefix
    of the descending-probability order whose cumulative probability
    reaches top_p (ties at the cut kept). The top-1 token is always
    kept (top_p is clamped above 0)."""
    # Clamped and compared in f32, as the JAX filter does.
    top_p = torch.tensor(max(float(top_p), 1e-6), dtype=torch.float32).item()
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    e = torch.exp(sorted_desc - sorted_desc[..., :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    outside = (cum - probs) >= top_p
    kth = torch.where(outside, float('inf'), sorted_desc).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < kth, _NEG_INF, logits)


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float, top_k: int = 0,
                 top_p: Optional[float] = None) -> torch.Tensor:
    """Next ids from [B, V] logits with one key [2] for the whole batch
    (``jax.random.categorical`` over [B, V]); ``top_k`` 0 is off, and
    ``temperature <= 0`` is the greedy argmax. Returns int32 [B]."""
    filtered = logits.float()
    if top_k:
        filtered = _filter_top_k(filtered, top_k)
    if top_p is not None:
        filtered = _filter_top_p(filtered, top_p)
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    t_safe = max(float(temperature), 1e-6)
    # Divided in f32 by the f32 temperature, as the JAX step does.
    t32 = torch.tensor(t_safe, dtype=torch.float32).item()
    return prng.categorical(key, filtered / t32).to(torch.int32)


def sample_tokens_scan(params: Params, first: torch.Tensor,
                       cache: KVCache, config: llama.LlamaConfig,
                       num_tokens: int, key: torch.Tensor,
                       temperature: float, top_k: int = 0,
                       top_p: Optional[float] = None
                       ) -> Tuple[torch.Tensor, KVCache]:
    """The sampling twin of ``decode_tokens_scan``: one cached forward
    per token, the key split per step (the JAX scan's order). Returns
    ([B, num_tokens] int32, cache)."""
    tok = first
    out = []
    for _ in range(num_tokens):
        key, sub = prng.split(key)
        logits, cache = forward_cached(params, tok[:, None], cache,
                                       config)
        tok = sample_token(logits[:, -1], sub, temperature, top_k=top_k,
                           top_p=top_p)
        out.append(tok)
    if not out:
        return torch.zeros((first.shape[0], 0), dtype=torch.int32,
                           device=first.device), cache
    return torch.stack(out, dim=1), cache


@torch.inference_mode()
def sample_generate(params: Params, prompt: torch.Tensor,
                    config: llama.LlamaConfig, max_new_tokens: int,
                    key: torch.Tensor, temperature: float = 1.0,
                    top_k: int = 0, top_p: Optional[float] = None,
                    max_seq: Optional[int] = None,
                    kv_int8: bool = False) -> torch.Tensor:
    """Sampled generation: prefill once, then one cached step per token.
    ``key`` is a ``jax.random`` key as int64 [2] (``prng.seed_key(s)``
    is ``PRNGKey(s)``); ``top_p`` None skips the nucleus filter (a
    full-vocab sort per token is not free). prompt [B, T0] ->
    [B, max_new_tokens] int32."""
    max_seq = max_seq or config.max_seq_len
    b, t0 = prompt.shape
    if t0 + max_new_tokens > max_seq:
        raise ValueError(f'prompt {t0} + max_new_tokens {max_new_tokens}'
                         f' > max_seq {max_seq}')
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int32,
                           device=prompt.device)
    key = torch.as_tensor(key, dtype=torch.int64, device=prompt.device)
    cache = init_cache(config, b, max_seq, device=prompt.device,
                       kv_int8=kv_int8)
    logits, cache = forward_cached(params, prompt, cache, config,
                                   last_only=True, prefill=True)
    key, sub = prng.split(key)
    nxt = sample_token(logits[:, -1], sub, temperature, top_k=top_k,
                       top_p=top_p)
    toks, _ = sample_tokens_scan(params, nxt, cache, config,
                                 max_new_tokens - 1, key, temperature,
                                 top_k, top_p)
    return torch.cat([nxt[:, None], toks], dim=1)
