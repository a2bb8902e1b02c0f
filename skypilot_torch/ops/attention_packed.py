"""Head-paired flash-attention forward — the port of
``skypilot_tpu/ops/attention_packed.py``.

``packed_flash_attention_fwd`` takes the JAX function's layout, q
``[B, H, T, D]`` (H even) and k/v ``[B, Hkv, S, D]``, and returns
``(out [B, H, T, D], lse f32 [B, H, T])``: a causal (bottom-right
aligned) or full forward without RoPE, lse in the log2 domain as the
port's K1 returns it (the TPU kernel's ``[B, H, 8, T]`` sublane axis is
not carried over). CUDA tensors launch K6-cuda (``PACKED_FWD``, over
``csrc/attention_packed.cu``, which replaces ``_packed_fwd_kernel``),
CPU tensors run ``_packed_fwd_plain``, a dense f32 computation under
the same contract; any other device raises, and a CUDA tensor the
kernel cannot take raises.

The reference kernel is K1's result only for GQA groups that are even
or 1, causal T <= S, and T and S that are multiples of their blocks.
Outside that it computes something else (module faults 1-3 below), so
the entry refuses those inputs instead of copying the results:

1. odd groups > 1: the reference pairs kv heads ``2hp, 2hp + 1`` for
   q heads ``2hp, 2hp + 1``, right only when groups == 1;
2. causal T > S: rows that see no key are not fixed up (K1 gives them
   out 0 and lse +1e30);
3. T or S not a multiple of its block: the grid and the key loop drop
   the tail silently.

``block_q``/``block_k`` are validated as the reference sizes them
(``min(block, length)``); the CUDA kernel picks its own tiles, since the
result does not depend on them. ``python -m
skypilot_torch.ops.attention_packed`` runs ``bench_main``: K6 against
the port's K1 at the LoRA headline's attention shapes.
"""
import ctypes
import math
import time
from typing import Optional, Tuple

import torch

from skypilot_torch import device as device_lib
from skypilot_torch.ops import _build
from skypilot_torch.ops import attention as attention_ops

LOG2E = attention_ops.LOG2E

PACKED_FWD = _build.Kernel(
    'attention_packed', 'skypilot_packed_flash_fwd',
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12 +
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_contract(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, block_q: int, block_k: int
                    ) -> Tuple[int, ...]:
    """Shapes, and the reference faults the entry refuses."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError('packed_flash_attention_fwd: q [B,H,T,D], k/v '
                         f'[B,Hkv,S,D] expected, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    b, h, t, d = q.shape
    bk, hkv, s, dk = k.shape
    if bk != b or dk != d or hkv < 1 or h % hkv or t < 1 or s < 1:
        raise ValueError('packed_flash_attention_fwd: incompatible shapes '
                         f'q {tuple(q.shape)}, k/v {tuple(k.shape)}')
    if h % 2:
        raise ValueError(f'packed_flash_attention_fwd: H = {h} is odd; '
                         'the kernel pairs q heads and needs an even H')
    groups = h // hkv
    if groups % 2 and groups > 1:
        raise ValueError(
            f'packed_flash_attention_fwd: GQA groups = {groups} (H {h}, '
            f'Hkv {hkv}) is odd and > 1; the reference pairs kv heads '
            '2hp, 2hp+1 with q heads 2hp, 2hp+1, which is right only for '
            'groups == 1 (reference fault 1: odd GQA groups above 1 are '
            'paired wrongly)')
    if causal and t > s:
        raise ValueError(
            f'packed_flash_attention_fwd: causal T = {t} > S = {s}; rows '
            'that see no key are not fixed up by the reference (reference '
            'fault 2: causal rows that see no key)')
    bq, bkk = min(block_q, t), min(block_k, s)
    if bq < 1 or bkk < 1 or t % bq or s % bkk:
        raise ValueError(
            f'packed_flash_attention_fwd: T = {t} / S = {s} are not '
            f'multiples of block_q = {bq} / block_k = {bkk}; the '
            'reference drops the tail silently (reference fault 3: '
            'ragged lengths are truncated)')
    return b, h, t, s, hkv, d


def _packed_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense f32 (out [B,H,T,D] in q.dtype, lse f32 [B,H,T] log2)
    under K6's contract: q scaled by ``scale * log2e`` in f32 and
    rounded to its dtype before the first dot (the kernel's fold), head
    h reading kv head ``h // groups``, bottom-right causal masking."""
    b, h, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    logits = torch.einsum('bhgtd,bhsd->bhgts',
                          qs.reshape(b, hkv, h // hkv, t, d), k.float())
    if causal:
        logits = logits.masked_fill(
            ~attention_ops._causal_visible(t, s, q.device), -math.inf)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp2(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum('bhgts,bhsd->bhgtd', p / l, v.float())
    lse = (m + torch.log2(l))[..., 0]
    return (out.reshape(b, h, t, d).to(q.dtype), lse.reshape(b, h, t))


def _packed_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6-cuda; raises on anything the kernel does not take."""
    what = 'packed_flash_attention_fwd'
    b, h, t, s, hkv, d = (q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                          k.shape[1], q.shape[3])
    if d not in attention_ops.FLASH_HEAD_DIMS:
        raise ValueError(f'{what}: head_dim {d} not supported by the CUDA '
                         f'kernel (it takes {attention_ops.FLASH_HEAD_DIMS})')
    attention_ops._check_cuda(what, (('q', q), ('k', k), ('v', v)))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    strides = [st for x in (q, k, v, out) for st in x.stride()[:3]]
    PACKED_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(), b, t, s, h, hkv, d, *strides, scale * LOG2E,
               int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def packed_flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               scale: Optional[float] = None,
                               block_q: int = 512, block_k: int = 512
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,H,T,D], lse f32 [B,H,T] log2 domain) for q [B,H,T,D]
    (H even), k/v [B,Hkv,S,D]. CUDA tensors go to K6-cuda, CPU tensors
    to ``_packed_fwd_plain``; any other device raises. Raises on the
    reference's faults (module docstring)."""
    _check_contract(q, k, v, causal, block_q, block_k)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == 'cuda':
        return _packed_fwd_cuda(q, k, v, causal, float(scale))
    if q.device.type == 'cpu':
        return _packed_fwd_plain(q, k, v, causal, scale)
    raise ValueError(f'packed_flash_attention_fwd: unsupported device '
                     f'{q.device}')


def bench_main(device=None, iters: int = 20, seed: int = 0) -> dict:
    """Micro-bench, as the JAX entry's: K6 (packed) against the port's
    K1 (``flash_attention_fwd`` on a ``[B,T,H,D]`` view of the same
    tensors) at the LoRA headline's attention shapes, B 8, T 2048,
    32/8 heads, head_dim 64, causal. Inputs come from a
    ``torch.Generator`` seeded with ``seed``. Prints ms per forward and
    the effective TFLOP/s, both counted as ``4*B*H*T^2*D/2``, and
    returns them. Runs on the card: raises ``DeviceError`` without
    one."""
    dev = device_lib.resolve_device(device)
    if dev.type != 'cuda':
        raise device_lib.DeviceError(
            f'bench_main times the CUDA kernels; got device {str(dev)!r}')
    b, h, hkv, t, d = 8, 32, 8, 2048, 64
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    q, k, v = randn(b, h, t, d), randn(b, hkv, t, d), randn(b, hkv, t, d)
    scale = d ** -0.5

    def plain():
        return attention_ops.flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, scale=scale)

    def packed():
        return packed_flash_attention_fwd(q, k, v, causal=True,
                                          block_q=512, block_k=512)

    flops = 4 * b * h * t * t * d / 2  # causal qk+pv MACs*2 / 2
    result = {}
    for name, fn in (('plain', plain), ('packed', packed)):
        fn()  # build and warm up
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / iters
        result[name] = {'ms': dt * 1e3, 'tflops': flops / dt / 1e12}
        print(f'{name}: {dt * 1e3:.3f} ms/fwd  '
              f'{flops / dt / 1e12:.1f} TFLOP/s effective', flush=True)
    return result


if __name__ == '__main__':
    bench_main()
