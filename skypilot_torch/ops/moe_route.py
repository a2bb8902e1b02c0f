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
take the plain version, which the training forward's differentiable
router shares (``top_k_lower``, ``capacity_slots``).
"""
import ctypes

import torch
import torch.nn.functional as F

from skypilot_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
MOE_ROUTE = _build.Kernel('moe_route', 'skypilot_moe_route',
                          [_P] * 7 + [_I] * 6 + [_P])
# The kernel's instantiations (E) and its largest k; its grid's groups.
MOE_ROUTE_EXPERTS = (2, 4, 8, 16)
MOE_ROUTE_MAX_K = 8
MOE_ROUTE_MAX_GROUPS = 65535
_COUNTERS = {}


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


def _moe_route_plain(h, router, k, cap):
    logits = h.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    idx = top_k_lower(probs, k)
    g = probs.gather(-1, idx)
    g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
    slot = capacity_slots(idx, router.shape[-1], cap)
    return idx.to(torch.int32), g.to(h.dtype), slot, g


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


def _moe_route_cuda(h, router, k, cap):
    """Launch the kernel; raises on anything it does not take."""
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
    if g and t:
        MOE_ROUTE(x.data_ptr(), r.data_ptr(), idx.data_ptr(),
                  gate.data_ptr(), gate_f32.data_ptr(), slot.data_ptr(),
                  _counters(dev).data_ptr(), g, t, d, e, k, cap,
                  torch.cuda.current_stream(dev).cuda_stream)
    return idx, gate, slot, gate_f32


def moe_route(h: torch.Tensor, router: torch.Tensor, k: int, cap: int,
              with_f32: bool = False):
    """Route ``h [G, T, D]`` over ``router [D, E]``: returns (idx int32,
    gate in h's dtype, slot int32), each [G, T, k], and with
    ``with_f32`` the gates in f32 before their rounding too. A row g of
    h is one routing group of per-expert capacity ``cap``."""
    if h.device.type == 'cuda':
        out = _moe_route_cuda(h, router, k, cap)
    elif h.device.type == 'cpu':
        out = _moe_route_plain(h, router, k, cap)
    else:
        raise ValueError(f'moe_route: unsupported device {h.device}')
    return out if with_f32 else out[:3]
