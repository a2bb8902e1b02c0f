"""The serving path's products with a row's bits independent of its
batch: ``matmul`` (``x @ w`` for bf16 or int8 ``{'q', 's'}`` weights)
and ``lora_gather_delta`` (the row-gathered LoRA delta, f32).

On the card both launch ``csrc/matmul_invariant.cu``: one tile shape,
one MMA instruction and one K order for every M, the K splits set by
(N, K) alone (``matmul_splits``) and summed in split order in the same
launch, so a row gets the same bits at decode (M = B), verify
(M = B * W) and in a prefill chunk of any bucket. cuBLAS picks its
kernel and its K split by the whole shape, and did not (PERF.md). On
the CPU each takes its plain version, the math the JAX package leaves
to XLA. The training forward keeps ``llama.matmul``.
"""
import ctypes

import torch

from skypilot_torch.models import llama
from skypilot_torch.ops import _build

# The kernel's tile (csrc/matmul_invariant.cu kBM = kBN = kBK) and the
# blocks a call aims at: about two waves over the H100's 132 SMs.
MATMUL_TILE = 64
MATMUL_WAVE_BLOCKS = 264
# A split never gets fewer k-tiles than this.
MATMUL_MIN_K_TILES = 4
MATMUL_MAX_COUNTERS = 1 << 16
LORA_MAX_RANK = 64

MATMUL = _build.Kernel(
    'matmul_invariant', 'skypilot_matmul_invariant',
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 +
    [ctypes.c_int] * 3 + [ctypes.c_void_p])
MATMUL_Q8 = _build.Kernel(
    'matmul_invariant', 'skypilot_matmul_invariant_q8',
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 +
    [ctypes.c_int] * 2 + [ctypes.c_void_p])
LORA_DELTA = _build.Kernel(
    'matmul_invariant', 'skypilot_lora_delta',
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def matmul_splits(n: int, k: int):
    """``(splits, k_chunk)`` of a [*, K] @ [K, N] call from (N, K) alone,
    never from M: K is halved while the call's 64-column tiles times
    its splits stay within ``MATMUL_WAVE_BLOCKS`` and each split keeps
    at least ``MATMUL_MIN_K_TILES`` whole k-tiles."""
    n_tiles = -(-n // MATMUL_TILE)
    k_tiles = -(-k // MATMUL_TILE)
    s = 1
    while (n_tiles * 2 * s <= MATMUL_WAVE_BLOCKS and k_tiles % (2 * s) == 0
           and k_tiles // (2 * s) >= MATMUL_MIN_K_TILES):
        s *= 2
    return s, k_tiles // s * MATMUL_TILE


# The plain version: ``x @ w``, or ``(x @ q.to(x.dtype)) * s`` for an
# int8 ``{'q', 's'}`` weight, as the training forward computes it.
_matmul_plain = llama.matmul


_COUNTERS = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The int32 counters of the split sums, one per output tile, 0
    between calls (the last block of each tile resets its own). One
    buffer per device, made on its first call and never replaced."""
    if n > MATMUL_MAX_COUNTERS:
        raise ValueError(f'matmul: {n} output tiles with split K exceed '
                         f'the {MATMUL_MAX_COUNTERS} counters')
    key = (dev.type, dev.index)
    buf = _COUNTERS.get(key)
    if buf is None:
        if dev.type == 'cuda' and torch.cuda.is_current_stream_capturing():
            raise RuntimeError('matmul: the split counters are made on the '
                               "device's first call, which may not be "
                               'captured')
        buf = torch.zeros(MATMUL_MAX_COUNTERS, dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0


def _matmul_cuda(x: torch.Tensor, w) -> torch.Tensor:
    """Launch the invariant GEMM; raises on anything it does not take."""
    q8 = isinstance(w, dict)
    mat = w['q'] if q8 else w
    if x.dtype != torch.bfloat16 or x.device != mat.device:
        raise TypeError(f'matmul: the CUDA kernel takes bf16 x on the '
                        f"weight's device, got {x.dtype} on {x.device}")
    if mat.dim() != 2 or x.shape[-1] != mat.shape[0]:
        raise ValueError(f'matmul: x [..., K] @ w [K, N] expected, got '
                         f'{tuple(x.shape)} @ {tuple(mat.shape)}')
    k, n = mat.shape
    if q8:
        s = w['s']
        if (mat.dtype != torch.int8 or not mat.is_contiguous()
                or s.dtype != torch.bfloat16 or s.numel() != n
                or not s.is_contiguous() or n % 16):
            raise TypeError('matmul: an int8 weight needs contiguous int8 '
                            'codes [K, N] (N a multiple of 16) and N bf16 '
                            f'scales, got {mat.dtype} {tuple(mat.shape)}, '
                            f'{s.dtype} {tuple(s.shape)}')
        wt, ldw = False, n
    else:
        if mat.dtype != torch.bfloat16:
            raise TypeError(f'matmul: the CUDA kernel takes bf16 weights, '
                            f'got {mat.dtype}')
        if mat.stride() == (n, 1):
            wt, ldw = False, n
        elif mat.stride() == (1, k):    # the transpose of an [N, K] matrix
            wt, ldw = True, k
        else:
            raise ValueError('matmul: w must be a contiguous [K, N] or the '
                             f'transpose of one, strides {mat.stride()}')
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if (k % 8 or n % 8 or x2.stride(1) != 1 or x2.stride(0) % 8
            or not _aligned(x2) or not _aligned(mat)):
        raise ValueError('matmul: K and N must be multiples of 8, and x and '
                         'w 16-byte aligned rows for the copies (K '
                         f'{k}, N {n}, x strides {x2.stride()})')
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    splits, k_chunk = matmul_splits(n, k)
    tiles = -(-m // MATMUL_TILE) * -(-n // MATMUL_TILE)
    counters = _counters(x.device, tiles if splits > 1 else 0)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    part_ptr = 0 if part is None else part.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if q8:
        MATMUL_Q8(x2.data_ptr(), mat.data_ptr(), w['s'].data_ptr(),
                  y.data_ptr(), part_ptr, counters.data_ptr(), m, n, k,
                  x2.stride(0), ldw, n, splits, k_chunk, stream)
    else:
        MATMUL(x2.data_ptr(), mat.data_ptr(), y.data_ptr(), part_ptr,
               counters.data_ptr(), m, n, k, x2.stride(0), ldw, n, splits,
               k_chunk, int(wt), stream)
    return y.reshape(*x.shape[:-1], n)


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a bf16 [K, N] weight (or the transpose of an [N, K]
    one, a tied LM head) or an int8 ``{'q', 's'}`` pair, JAX's rounding
    points. CUDA: the invariant GEMM (a row's bits do not depend on the
    other rows of x); CPU: the plain version."""
    if x.device.type == 'cuda':
        return _matmul_cuda(x, w)
    if x.device.type != 'cpu':
        raise ValueError(f'matmul: unsupported device {x.device}')
    return _matmul_plain(x, w)


def _lora_plain(h, a_slots, b_slots, adapter_idx):
    idx = adapter_idx.long()
    mid = torch.bmm(h.float(), a_slots[idx])            # [B, T, R]
    return torch.bmm(mid, b_slots[idx])                  # [B, T, out]


def _lora_cuda(h, a_slots, b_slots, adapter_idx):
    b, t, d = h.shape
    _, d_a, r = a_slots.shape
    n_out = b_slots.shape[-1]
    dev = h.device
    if (h.dtype != torch.bfloat16 or a_slots.dtype != torch.float32
            or b_slots.dtype != torch.float32
            or any(x.device != dev for x in (a_slots, b_slots, adapter_idx))):
        raise TypeError('lora_gather_delta: the CUDA kernel takes bf16 h '
                        'and f32 factors on one device, got '
                        f'{h.dtype}, {a_slots.dtype}, {b_slots.dtype}')
    if (d_a != d or b_slots.shape[:2] != (a_slots.shape[0], r)
            or r > LORA_MAX_RANK or adapter_idx.shape != (b,)
            or not all(x.is_contiguous() for x in (a_slots, b_slots))):
        raise ValueError('lora_gather_delta: h [B, T, d], contiguous A '
                         f'[C+1, d, R <= {LORA_MAX_RANK}], B [C+1, R, out], '
                         f'adapter_idx [B] expected, got {tuple(h.shape)}, '
                         f'{tuple(a_slots.shape)}, {tuple(b_slots.shape)}, '
                         f'{tuple(adapter_idx.shape)}')
    out = torch.empty((b, t, n_out), dtype=torch.float32, device=dev)
    if b * t == 0:
        return out
    # Bound to names: a temporary's memory could be handed out again
    # before the kernel reads it.
    h_c = h.contiguous()
    slots = adapter_idx.to(torch.int32).contiguous()
    LORA_DELTA(h_c.data_ptr(), slots.data_ptr(),
               a_slots.data_ptr(), b_slots.data_ptr(), out.data_ptr(),
               b * t, t, d, r, n_out,
               torch.cuda.current_stream(dev).cuda_stream)
    return out


def lora_gather_delta(h: torch.Tensor, a_slots: torch.Tensor,
                      b_slots: torch.Tensor,
                      adapter_idx: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta ``(h @ A[slot]) @ B[slot]`` in f32: h [B, T, d],
    a_slots [C+1, d, R], b_slots [C+1, R, out], adapter_idx [B] (slot 0
    all zeros). CUDA: blocks of one row's output columns, sums in an
    order set by (d, R) alone; CPU: two batched products, as the JAX
    package's einsums."""
    if h.device.type == 'cuda':
        return _lora_cuda(h, a_slots, b_slots, adapter_idx)
    if h.device.type != 'cpu':
        raise ValueError(f'lora_gather_delta: unsupported device {h.device}')
    return _lora_plain(h, a_slots, b_slots, adapter_idx)
