"""The MoE router of the serving path (``moe_route``), with a token's
experts and gates independent of the other tokens of the call.

For each token of ``h [G, T, D]`` and a layer's ``router [D, E]``: the
f32 logits, softmax, the top k with ties to the lower expert index
(``lax.top_k``'s order), the gates normalized by ``max(sum, 1e-9)`` and
rounded to h's dtype, and each (token, choice)'s capacity slot: its
place in the chosen expert's buffer of its routing group (a row g of h),
token-major, or -1 once ``cap`` earlier entries chose that expert. This
is the router and capacity of the JAX package's ``llama._moe_mlp``.

CUDA tensors launch ``csrc/moe_route.cu`` (one launch; the logits in an
order set by D alone, the slots by the group's last block); CPU tensors
take the plain version (``top_k_lower``, ``capacity_slots``).

The training forward routes through :func:`route_for_training`, which
also returns the f32 probabilities (the aux loss reads them) and carries
the gradients of the f32 gates and of the probabilities back to h and
the router. On the card it is :class:`_RouteForTraining`: the forward
kernel with its ``probs`` output, and the backward kernel
``moe_route_bwd`` (the gates' normalization and the softmax's vjp, then
h's gradient through the router, one launch), the router's gradient a
plain product after it. It is deterministic, so a layer's recompute
under ``config.remat`` routes as its forward did. On the CPU the same
function is autograd over the plain ops (:func:`_route_train_plain`).
Neither falls back to the other: on a CUDA tensor the kernels run or
the call raises (f32 h, an E the kernels do not take, k > 8).
"""
import ctypes

import torch
import torch.nn.functional as F

from skypilot_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
MOE_ROUTE = _build.Kernel('moe_route', 'skypilot_moe_route',
                          [_P] * 8 + [_I] * 6 + [_P])
MOE_ROUTE_BWD = _build.Kernel('moe_route', 'skypilot_moe_route_bwd',
                              [_P] * 7 + [ctypes.c_longlong] + [_I] * 3
                              + [_P])
# The kernel's instantiations (E) and its largest k; its grid's groups.
MOE_ROUTE_EXPERTS = (2, 4, 8, 16)
MOE_ROUTE_MAX_K = 8
MOE_ROUTE_MAX_GROUPS = 65535
_COUNTERS = {}


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernels (a CUDA tensor) rather than the
    plain versions (a CPU tensor); any other device raises."""
    if x.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'moe_route: unsupported device {x.device}')
    return x.device.type == 'cuda'


def top_k_lower(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [..., k] of the k largest of ``probs`` [..., E] in
    descending order, ties to the lower index (``lax.top_k``):
    ``argmax`` returns the first maximum."""
    p = probs.detach().clone()
    out = []
    for _ in range(k):
        i = p.argmax(-1)
        out.append(i)
        p.scatter_(-1, i[..., None], float('-inf'))
    return torch.stack(out, -1)


def capacity_slots(idx: torch.Tensor, n_experts: int,
                   cap: int) -> torch.Tensor:
    """idx [G, T, k] -> int32 slots [G, T, k]: the number of earlier
    (token, choice) entries of the group, token-major, that chose the
    same expert (JAX's ``cumsum(sel) - sel``), or -1 where that is
    ``cap`` or more."""
    g, t, k = idx.shape
    sel = F.one_hot(idx.reshape(g, t * k).long(), n_experts)
    pos = ((sel.cumsum(1) - sel) * sel).sum(-1)
    return torch.where(pos < cap, pos, -1).to(torch.int32).view(g, t, k)


def _route_plain(h, router, k, cap):
    """(idx int32, gate in h's dtype, slot int32, f32 gates, f32 probs),
    differentiable through the gates and the probabilities."""
    logits = h.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    idx = top_k_lower(probs, k)
    g = probs.gather(-1, idx)
    g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
    slot = capacity_slots(idx, router.shape[-1], cap)
    return idx.to(torch.int32), g.to(h.dtype), slot, g, probs


def _moe_route_plain(h, router, k, cap):
    return _route_plain(h, router, k, cap)[:4]


def _counters(dev: torch.device) -> torch.Tensor:
    """One int32 counter per group, 0 between calls (the group's last
    block resets it). One buffer per device, made zeroed on its first
    call and never replaced; calls on a device run one after another."""
    key = (dev.type, dev.index)
    buf = _COUNTERS.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError('moe_route: the group counters are made on '
                               "the device's first call, which may not be "
                               'captured')
        buf = torch.zeros(MOE_ROUTE_MAX_GROUPS, dtype=torch.int32,
                          device=dev)
        _COUNTERS[key] = buf
    return buf


def _moe_route_cuda(h, router, k, cap, with_probs=False):
    """Launch the kernel; raises on anything it does not take. Returns
    (idx, gate, slot, gate_f32, probs or None)."""
    if (h.dtype != torch.bfloat16 or router.dtype != torch.bfloat16
            or h.dim() != 3 or router.dim() != 2
            or h.shape[-1] != router.shape[0] or h.device != router.device):
        raise TypeError(f'moe_route: bf16 h [G, T, D] and router [D, E] on '
                        f'one device expected, got {h.dtype} '
                        f'{tuple(h.shape)}, {router.dtype} '
                        f'{tuple(router.shape)}')
    g, t, d = h.shape
    e = router.shape[1]
    if (e not in MOE_ROUTE_EXPERTS or not 1 <= k <= min(e, MOE_ROUTE_MAX_K)
            or cap < 1 or g > MOE_ROUTE_MAX_GROUPS):
        raise ValueError(f'moe_route: E {e} (one of {MOE_ROUTE_EXPERTS}), '
                         f'k {k} (1..{MOE_ROUTE_MAX_K}), cap {cap} (>= 1) '
                         f'or G {g} (at most {MOE_ROUTE_MAX_GROUPS}) outside '
                         'the kernel')
    x = h.contiguous()
    r = router.contiguous()
    if r.data_ptr() % 16:
        raise ValueError('moe_route: the router must be 16-byte aligned '
                         '(its rows load as vectors)')
    dev = x.device
    idx = torch.empty((g, t, k), dtype=torch.int32, device=dev)
    gate = torch.empty((g, t, k), dtype=torch.bfloat16, device=dev)
    gate_f32 = torch.empty((g, t, k), dtype=torch.float32, device=dev)
    slot = torch.empty((g, t, k), dtype=torch.int32, device=dev)
    probs = (torch.empty((g, t, e), dtype=torch.float32, device=dev)
             if with_probs else None)
    if g and t:
        MOE_ROUTE(x.data_ptr(), r.data_ptr(), idx.data_ptr(),
                  gate.data_ptr(), gate_f32.data_ptr(), slot.data_ptr(),
                  None if probs is None else probs.data_ptr(),
                  _counters(dev).data_ptr(), g, t, d, e, k, cap,
                  torch.cuda.current_stream(dev).cuda_stream)
    return idx, gate, slot, gate_f32, probs


def moe_route(h: torch.Tensor, router: torch.Tensor, k: int, cap: int,
              with_f32: bool = False):
    """Route ``h [G, T, D]`` over ``router [D, E]``: returns (idx int32,
    gate in h's dtype, slot int32), each [G, T, k], and with
    ``with_f32`` the gates in f32 before their rounding too. A row g of
    h is one routing group of per-expert capacity ``cap``."""
    out = (_moe_route_cuda(h, router, k, cap)[:4] if _on_card(h)
           else _moe_route_plain(h, router, k, cap))
    return out if with_f32 else out[:3]


def _moe_route_bwd_plain(probs, idx, dgate, dprobs, router, dtype):
    """The backward kernel's function in plain torch: (dlogits [.., E]
    f32, dh [.., D] in ``dtype``) from the probabilities, the experts,
    the f32 gates' gradient and the probabilities' (None: zeros)."""
    sel = probs.gather(-1, idx.long())
    s = sel.sum(-1, keepdim=True)
    gp = (dgate * sel).sum(-1, keepdim=True)
    dp = torch.zeros_like(probs) if dprobs is None else dprobs.float()
    dp = dp.scatter_add(-1, idx.long(), dgate / s - gp / (s * s))
    dlogits = probs * (dp - (probs * dp).sum(-1, keepdim=True))
    return dlogits, (dlogits @ router.float().T).to(dtype)


def _moe_route_bwd_cuda(probs, idx, dgate, dprobs, router, dtype):
    """Launch ``moe_route_bwd``; raises on anything it does not take."""
    n_exp = router.shape[-1]
    d = router.shape[0]
    k = idx.shape[-1]
    lead = probs.shape[:-1]
    if (dtype != torch.bfloat16 or router.dtype != torch.bfloat16
            or probs.dtype != torch.float32 or dgate.dtype != torch.float32
            or idx.dtype != torch.int32 or probs.shape[-1] != n_exp
            or idx.shape[:-1] != lead or dgate.shape != idx.shape
            or (dprobs is not None and (dprobs.shape != probs.shape or
                                        dprobs.dtype != torch.float32))):
        raise TypeError(
            f'moe_route_bwd: f32 probs [.., E], int32 idx and f32 dgate '
            f'[.., k], bf16 router [D, E] and dh expected, got probs '
            f'{probs.dtype} {tuple(probs.shape)}, idx {idx.dtype} '
            f'{tuple(idx.shape)}, dgate {dgate.dtype}, router '
            f'{router.dtype} {tuple(router.shape)}, dh {dtype}')
    if (n_exp not in MOE_ROUTE_EXPERTS or not 1 <= k <= min(
            n_exp, MOE_ROUTE_MAX_K) or d % 4):
        raise ValueError(f'moe_route_bwd: E {n_exp} (one of '
                         f'{MOE_ROUTE_EXPERTS}), k {k} (1..'
                         f'{MOE_ROUTE_MAX_K}) or D {d} (a multiple of 4) '
                         'outside the kernel')
    r = router.contiguous()
    if r.data_ptr() % 16:
        raise ValueError('moe_route_bwd: the router must be 16-byte '
                         'aligned (its rows load as vectors)')
    dev = probs.device
    n = probs.numel() // n_exp
    p = probs.contiguous()
    ix = idx.contiguous()
    dg = dgate.contiguous()
    dpr = None if dprobs is None else dprobs.contiguous()
    dlogits = torch.empty(lead + (n_exp,), dtype=torch.float32, device=dev)
    dh = torch.empty(lead + (d,), dtype=dtype, device=dev)
    if n:
        MOE_ROUTE_BWD(p.data_ptr(), ix.data_ptr(), dg.data_ptr(),
                      None if dpr is None else dpr.data_ptr(), r.data_ptr(),
                      dlogits.data_ptr(), dh.data_ptr(), n, d, n_exp, k,
                      torch.cuda.current_stream(dev).cuda_stream)
    return dlogits, dh


def moe_route_bwd(probs: torch.Tensor, idx: torch.Tensor,
                  dgate: torch.Tensor, dprobs, router: torch.Tensor,
                  dtype: torch.dtype):
    """The router's backward from the training forward's outputs:
    (dlogits f32 [.., E], dh [.., D] in ``dtype``), from ``probs`` [..,
    E] f32, ``idx`` [.., k], the f32 gates' gradient ``dgate`` [.., k]
    and the probabilities' ``dprobs`` [.., E] (None: zeros). One launch
    of ``moe_route_bwd`` on the card; the plain version on the CPU."""
    if _on_card(probs):
        return _moe_route_bwd_cuda(probs, idx, dgate, dprobs, router, dtype)
    return _moe_route_bwd_plain(probs, idx, dgate, dprobs, router, dtype)


class _RouteForTraining(torch.autograd.Function):
    """The router of the training forward on the kernels: forward
    ``moe_route`` with its probabilities, backward ``moe_route_bwd``,
    then the router's gradient ``h^T @ dlogits`` in f32 (the JAX
    package leaves both products to XLA). Returns (idx, gate f32, slot,
    probs f32); idx and slot carry no gradient."""

    @staticmethod
    def forward(ctx, h, router, k, cap):
        if _on_card(h):
            idx, _, slot, gate, probs = _moe_route_cuda(h, router, k, cap,
                                                        with_probs=True)
        else:
            idx, _, slot, gate, probs = (
                x.detach() for x in _route_plain(h, router, k, cap))
        ctx.save_for_backward(h, router, probs, idx)
        ctx.mark_non_differentiable(idx, slot)
        return idx, gate, slot, probs

    @staticmethod
    def backward(ctx, _didx, dgate, _dslot, dprobs):
        h, router, probs, idx = ctx.saved_tensors
        dlogits, dh = moe_route_bwd(probs, idx, dgate, dprobs, router,
                                    h.dtype)
        n_exp = router.shape[-1]
        drouter = (h.reshape(-1, h.shape[-1]).float().T @
                   dlogits.reshape(-1, n_exp)).to(router.dtype)
        return dh, drouter, None, None


def _route_train_plain(h, router, k, cap):
    """:func:`route_for_training` on the CPU: autograd over the plain
    ops."""
    idx, _, slot, gate, probs = _route_plain(h, router, k, cap)
    return idx, gate, slot, probs


def route_for_training(h: torch.Tensor, router: torch.Tensor, k: int,
                       cap: int):
    """Route ``h [G, T, D]`` over ``router [D, E]`` for training:
    (idx int32 [G, T, k], the f32 gates [G, T, k], slot int32 [G, T, k],
    the f32 probabilities [G, T, E]). The gates and the probabilities
    carry gradients to h and the router: on the card through the two
    kernels (:class:`_RouteForTraining`), on the CPU by autograd over the
    plain ops."""
    if _on_card(h):
        return _RouteForTraining.apply(h, router, k, cap)
    return _route_train_plain(h, router, k, cap)
