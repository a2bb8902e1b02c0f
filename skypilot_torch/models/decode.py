"""KV-cache incremental decoding — the port of
``skypilot_tpu/models/decode.py`` (dense bf16/f32 cache, greedy).

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
  argmax stays on the device: no host sync per token.

``kv_int8``, ``forward_paged``, sampling and ``decode_tokens_windowed``
come with later slices (ROADMAP.md).
"""
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama
from skypilot_torch.ops import attention as attention_ops
from skypilot_torch.ops import decode_attention as da

Params = Dict[str, Any]
_NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """Mutable KV cache. k/v: [L, B, max_seq, Hkv, hd] in the compute
    dtype (bf16 or f32); ``pos`` — number of positions already written
    (the same for every row; ragged batches left-pad).
    ``forward_cached`` writes new rows into k/v in place and advances
    ``pos``."""
    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0


def init_cache(config: llama.LlamaConfig, batch: int,
               max_seq: Optional[int] = None,
               device=None) -> KVCache:
    """A zeroed cache on ``device`` (default: cuda; raises without
    it)."""
    if config.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f'KV cache dtype {config.dtype}: only bf16/f32 are ported '
            '(int8 KV comes with the int8 slice, ROADMAP.md)')
    dev = device_lib.resolve_device(device)
    max_seq = max_seq or config.max_seq_len
    shape = (config.n_layers, batch, max_seq, config.n_kv_heads,
             config.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=config.dtype, device=dev),
                   v=torch.zeros(shape, dtype=config.dtype, device=dev))


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: int, kv_len: int,
                      scale: float) -> torch.Tensor:
    """q: [B, T, H, hd]; k/v: [B, S, Hkv, hd] (only ``kv_len``
    positions valid). Causal within the valid window: query at
    absolute position ``q_pos + i`` sees keys [0, q_pos + i]."""
    b, t, h, hd = q.shape
    s = k.shape[1]
    hkv = k.shape[2]
    qg = q.reshape(b, t, hkv, h // hkv, hd)
    logits = torch.einsum('bthgd,bshd->bhgts', qg.float(),
                          k.float()) * scale
    key_idx = torch.arange(s, device=q.device)[None, :]
    query_abs = q_pos + torch.arange(t, device=q.device)[:, None]
    mask = (key_idx <= query_abs) & (key_idx < kv_len)
    logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhgts,bshd->bthgd', probs.to(v.dtype), v)
    return out.reshape(b, t, h, hd)


def _layer_cached(config: llama.LlamaConfig, x: torch.Tensor,
                  layer_params: Params, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: int,
                  angles: torch.Tensor,
                  prefill: bool = False) -> torch.Tensor:
    """One transformer layer over ``T`` new positions. x: [B, T, D];
    k_cache/v_cache: this layer's [B, S, Hkv, hd] views, written in
    place at [pos, pos + T). Returns y [B, T, D]. Same cast points as
    the JAX layer: f32 norms, the gate activation in f32 then cast
    back."""
    b, t, _ = x.shape
    nh, nkv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    mm = llama.matmul

    h = llama._rms_norm(x, layer_params['attn_norm'], config.norm_eps,
                        config.norm_offset)
    q = mm(h, layer_params['wq'])
    k = mm(h, layer_params['wk'])
    v = mm(h, layer_params['wv'])
    if config.qkv_bias:
        q = q + layer_params['bq']
        k = k + layer_params['bk']
        v = v + layer_params['bv']
    q = attention_ops.apply_rope(q.reshape(b, t, nh, hd), angles)
    k = attention_ops.apply_rope(k.reshape(b, t, nkv, hd), angles)
    v = v.reshape(b, t, nkv, hd)

    k_cache[:, pos:pos + t] = k
    v_cache[:, pos:pos + t] = v

    scale = hd ** -0.5
    if t == 1:
        # Decode step: length-aware attention over the valid prefix.
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=x.device)
        attn = da.decode_attention(q[:, 0], k_cache, v_cache, lengths,
                                   scale)[:, None]
    elif prefill:
        # Prefill at pos 0: the cache holds exactly this chunk, so
        # causal flash over the LOCAL q/k/v is the whole attention.
        attn = attention_ops.flash_attention(q, k, v, causal=True,
                                             scale=scale)
    else:
        attn = _masked_attention(q, k_cache, v_cache, q_pos=pos,
                                 kv_len=pos + t, scale=scale)
    x = x + mm(attn.reshape(b, t, nh * hd), layer_params['wo'])

    h = llama._rms_norm(x, layer_params['mlp_norm'], config.norm_eps,
                        config.norm_offset)
    gate = llama.mlp_act(config)(
        mm(h, layer_params['w_gate']).float()).to(h.dtype)
    up = mm(h, layer_params['w_up'])
    return x + mm(gate * up, layer_params['w_down'])


def forward_cached(params: Params, tokens: torch.Tensor, cache: KVCache,
                   config: llama.LlamaConfig, last_only: bool = False,
                   prefill: bool = False
                   ) -> Tuple[torch.Tensor, KVCache]:
    """Run ``tokens`` [B, T] at absolute positions
    [cache.pos, cache.pos + T), writing their K/V into ``cache`` in
    place. Returns (logits [B, T or 1, vocab] f32, cache) with
    ``cache.pos`` advanced by T.

    ``last_only``: project only the final position through the LM
    head. ``prefill``: promise that ``cache.pos == 0`` — the prompt
    then runs causal flash attention over its local q/k/v."""
    llama.require_dense(config)
    if prefill and cache.pos != 0:
        raise ValueError(f'prefill=True needs an empty cache, pos is '
                         f'{cache.pos}')
    _, t = tokens.shape
    if cache.pos + t > cache.k.shape[2]:
        raise ValueError(f'cache overflow: pos {cache.pos} + {t} tokens '
                         f'> max_seq {cache.k.shape[2]}')
    cparams = llama.compute_params(params, config)
    pos = cache.pos
    positions = torch.arange(pos, pos + t, device=tokens.device)
    angles = llama._rope_frequencies(config, positions)

    x = cparams['embed'][tokens]
    if config.scale_embeddings:
        x = x * torch.tensor(math.sqrt(config.dim), dtype=x.dtype)
    layers = cparams['layers']
    for i in range(config.n_layers):
        layer_params = {name: w[i] for name, w in layers.items()}
        x = _layer_cached(config, x, layer_params, cache.k[i],
                          cache.v[i], pos, angles, prefill=prefill)
    cache.pos = pos + t
    if last_only:
        x = x[:, -1:]
    x = llama._rms_norm(x, cparams['final_norm'], config.norm_eps,
                        config.norm_offset)
    logits = llama.matmul(x, llama.output_head(cparams, config)).float()
    return logits, cache


def decode_tokens_scan(params: Params, first: torch.Tensor,
                       cache: KVCache, config: llama.LlamaConfig,
                       num_tokens: int
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Greedy-decode ``num_tokens`` further tokens: one cached forward
    per token, the argmax kept on the device (the loop never waits on
    it). first: [B] the most recent token per row. Returns
    ([B, num_tokens] int32 generated ids, cache)."""
    tok = first
    out = []
    for _ in range(num_tokens):
        logits, cache = forward_cached(params, tok[:, None], cache,
                                       config)
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        out.append(tok)
    if not out:
        return torch.zeros((first.shape[0], 0), dtype=torch.int32,
                           device=first.device), cache
    return torch.stack(out, dim=1), cache


@torch.inference_mode()
def greedy_generate(params: Params, prompt: torch.Tensor,
                    config: llama.LlamaConfig, max_new_tokens: int,
                    max_seq: Optional[int] = None,
                    eos_id: Optional[int] = None) -> torch.Tensor:
    """Greedy decode: prefill the prompt once, then one cached step
    per token. prompt: [B, T0] int on the params' device ->
    [B, <=max_new_tokens] int32 generated ids (rows that hit ``eos_id``
    are padded with it thereafter)."""
    max_seq = max_seq or config.max_seq_len
    b, t0 = prompt.shape
    if t0 + max_new_tokens > max_seq:
        raise ValueError(f'prompt {t0} + max_new_tokens {max_new_tokens}'
                         f' > max_seq {max_seq}')
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int32,
                           device=prompt.device)
    cache = init_cache(config, b, max_seq, device=prompt.device)
    logits, cache = forward_cached(params, prompt, cache, config,
                                   last_only=True, prefill=True)
    nxt = logits[:, -1].argmax(-1).to(torch.int32)
    if eos_id is None:
        toks, _ = decode_tokens_scan(params, nxt, cache, config,
                                     max_new_tokens - 1)
        return torch.cat([nxt[:, None], toks], dim=1)
    done = nxt == eos_id
    out = [nxt]
    for _ in range(max_new_tokens - 1):
        if bool(done.all()):
            break
        logits, cache = forward_cached(params, nxt[:, None], cache,
                                       config, last_only=True)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        # Per-row: once a row emitted EOS it keeps emitting EOS.
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        done = done | (nxt == eos_id)
        out.append(nxt)
    return torch.stack(out, dim=1)
