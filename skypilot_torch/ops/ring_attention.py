"""Ring attention: causal attention over a sequence split on the ``sp``
ranks — the port of ``skypilot_tpu/ops/ring_attention.py``.

Each rank holds ``T / n`` positions of every row (rank ``i`` the
positions ``[i T / n, (i + 1) T / n)``), its q, k and v ``[B, T / n, H,
D]``. The K/V blocks go round the ring (``comm.ring_exchange``:
to the next rank, from the previous one), and the rank
attends to each block it sees: its own (the diagonal block, causal) and
those of the ranks before it (full). The blocks of the ranks after it
are masked out whole in causal attention; JAX computes them and masks
them with ``where`` (its loop is one traced program), and here they are
not computed at all, since the port runs eagerly.

A block runs on the flash kernels: K1 (``ops/attention.
flash_attention_fwd``) forward, which gives the block's out and its
log2-domain lse, and the blocks merge by their lse values in f32 (the
online softmax of JAX's ``_combine``). The backward is the flash
backward per block against the GLOBAL out and lse: the pre-pass, K2 and
K3 rebuild each block's probabilities as ``exp2(s - lse)``, which with
the global lse are the block's share of the global softmax, and delta
is the global row's; so each block's dq, dk and dv are its exact share
of the gradient. The K/V blocks go round again with their dK/dV sums,
each rank adding its share, and after a last step each sum is back with
the rank that holds the block. On CPU tensors the same code runs the
kernels' plain versions.

Launches a call, on rank ``i``: ``i + 1`` K1 forward; ``i + 1`` of
each of the pre-pass, K2 and K3 backward. Point-to-point: ``n - 1``
exchanges of (k, v) forward; ``n - 1`` of (k, v, dk, dv) and one of
(dk, dv) backward.
"""
from typing import Optional

import torch
import torch.distributed as dist

from skypilot_torch import comm
from skypilot_torch.ops import attention as attention_ops


def merge(out: torch.Tensor, lse: torch.Tensor, out_b: torch.Tensor,
          lse_b: torch.Tensor):
    """The online-softmax merge (JAX's ``_combine``) of two normalized
    blocks: ``out`` f32 ``[B, T, H, D]`` and ``lse`` f32 ``[B, H, T]``
    (log2 domain) with a block's ``out_b`` and ``lse_b``. Returns the
    merged (out f32, lse)."""
    m = torch.maximum(lse, lse_b)
    w = torch.exp2(lse - m)
    w_b = torch.exp2(lse_b - m)
    total = w + w_b
    scale = (w / total).transpose(1, 2)[..., None]
    scale_b = (w_b / total).transpose(1, 2)[..., None]
    return out * scale + out_b.float() * scale_b, m + torch.log2(total)


class _RingAttention(torch.autograd.Function):
    """Forward: one K1 launch a block the rank sees, merged in f32.
    Saved: q, the rank's own k and v, the global out (in q's dtype) and
    lse. Backward: the blocks again, the pre-pass, K2 and K3 on each with
    the global out and lse, dK/dV carried round with their blocks."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        i, n, _, _ = comm.neighbours(group)
        if q.shape[1] != k.shape[1]:
            # The diagonal block must be square: with T > S its first
            # rows would see no key (K1's lse = +1e30), which would win
            # every merge.
            raise ValueError(f'ring_attention: q has {q.shape[1]} positions '
                             f'a rank, k/v {k.shape[1]}; they must agree')
        out = lse = None
        kv = (k, v)
        for step in range(n):
            if step <= i:   # the block of rank i - step: causal on the
                # diagonal, full before it
                o_b, l_b = attention_ops.flash_attention_fwd(
                    q, kv[0], kv[1], causal=step == 0, scale=scale)
                if out is None:
                    out, lse = o_b.float(), l_b
                else:
                    out, lse = merge(out, lse, o_b, l_b)
            if step < n - 1:
                kv = comm.ring_exchange(kv, group)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        i, n, _, _ = comm.neighbours(group)
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kv = (k, v)
        for step in range(n):
            if step <= i:
                dq_b, dk_b, dv_b = attention_ops.flash_attention_bwd(
                    q, kv[0], kv[1], out, lse, do, causal=step == 0,
                    scale=scale)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            # The sums travel with their block; after the n-th exchange
            # each is with the rank whose block it is.
            if step < n - 1:
                k_b, v_b, dk, dv = comm.ring_exchange((*kv, dk, dv),
                                                          group)
                kv = (k_b, v_b)
            elif n > 1:
                dk, dv = comm.ring_exchange((dk, dv), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention over global positions of the rank's shards: q
    ``[B, T / n, H, D]``, k/v ``[B, T / n, Hkv, D]`` (GQA native) on the
    ``n`` ranks of ``group`` (the ``sp`` group; the default group if
    None), RoPE already applied at the global positions. Returns the
    rank's ``[B, T / n, H, D]``; gradients flow through
    :class:`_RingAttention`."""
    if group is None:
        group = dist.group.WORLD
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, group, float(scale))
