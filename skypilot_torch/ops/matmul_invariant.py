"""The serving path's products with a row's bits independent of its
batch: ``matmul`` (``x @ w`` for bf16 or int8 ``{'q', 's'}`` weights)
and ``lora_gather_delta`` (the row-gathered LoRA delta, f32).

On the card both launch ``csrc/matmul_invariant.cu``. The GEMM runs
TMA + wgmma with one instruction (m64n128k16) and one K order at every
M: K is cut into segments fixed by (N, K) alone (``matmul_plan``), each
segment's partial starts fresh and the partials are summed in one fixed
order, whether a call runs its segments across blocks or one after the
other in a block (``matmul_launch`` picks by M; a tile's blocks are one
cluster and sum over DSMEM), so a row gets the same
bits at decode (M = B), verify (M = B * W) and in a prefill chunk of any
bucket. cuBLAS picks its kernel and its K split by the whole shape, and
did not (PERF.md). The LoRA delta makes each row's ``h @ A`` once, in an
order set by (d, R), then its product with B. On the CPU each takes its
plain version, the math the JAX package leaves to XLA. The training
forward keeps ``llama.matmul``.
"""
import ctypes
import functools
import weakref

import torch

from skypilot_torch.models import llama
from skypilot_torch.ops import _build

# The kernel's tile (csrc/matmul_invariant.cu kBN, kBK, kWgRows): 128
# output columns a block, 64 k a stage, 64 rows a consumer warpgroup.
MATMUL_BN = 128
MATMUL_BK = 64
MATMUL_WG_ROWS = 64
# The blocks of an output tile are one thread-block cluster. The clusters
# of each size the H100 holds at once with one block an SM
# (cudaOccupancyMaxActiveClusters; chip_smoke.py's MATMUL_BUILD line
# asserts the card holds at least these): a call whose clusters exceed it
# runs a second wave. Size 8 is the portable limit (csrc kMaxCluster).
MATMUL_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
# K splits into segments (doubling) while the call's column tiles still
# fit in one wave of clusters of that many blocks and each segment keeps
# at least MATMUL_MIN_K_TILES k-tiles.
MATMUL_MIN_K_TILES = 8
# Segments are grouped so that a prefill chunk of the engine's default
# size (serve/batching.BatchingEngine's prefill_chunk, 512 rows: this
# many m-tiles of 128 rows), one block a group, fits in one wave of
# clusters. A tuning constant that follows the engine's: another chunk
# size changes only the waves, never a row's bits (the segments are
# fixed by (N, K)); a CPU test holds the two equal.
MATMUL_PREFILL_M_TILES = 4
# Weight tensor maps kept before the maps of freed weights are swept (a
# weight's map is encoded on its first call).
MATMUL_MAX_MAPS = 4096
LORA_MAX_RANK = 64
# csrc kLoraChunk, kLoraOutRows: the first phase's d-chunk; the second
# phase's row group, whose chunk partials it stages (at most
# LORA_OUT_SMEM bytes).
LORA_CHUNK = 128
LORA_OUT_ROWS = 16
LORA_OUT_SMEM = 232448 - 48 * 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
MATMUL = _build.Kernel(
    'matmul_invariant', 'skypilot_matmul_invariant',
    [_P, _LL, _P, _P, _I, _I, _I, _LL] + [_I] * 6 + [_P])
MATMUL_Q8 = _build.Kernel(
    'matmul_invariant', 'skypilot_matmul_invariant_q8',
    [_P, _LL, _P, _P, _P, _I, _I, _I, _LL] + [_I] * 5 + [_P])
LORA_MID = _build.Kernel(
    'matmul_invariant', 'skypilot_lora_mid', [_P] * 4 + [_I] * 4 + [_P])
LORA_DELTA = _build.Kernel(
    'matmul_invariant', 'skypilot_lora_delta', [_P] * 4 + [_I] * 5 + [_P])

# csrc enum Form
FORM_BF16, FORM_BF16_T, FORM_Q8 = 0, 1, 2


def matmul_plan(n: int, k: int):
    """``(seg_tiles, n_segs, group)`` of a [*, K] @ [K, N] call from (N,
    K) alone, never from M: K's k-tiles in ``n_segs`` segments of
    ``seg_tiles`` (doubled while the column tiles fit in one wave of
    clusters of ``n_segs`` blocks and each segment keeps
    ``MATMUL_MIN_K_TILES``), summed ``group`` consecutive segments at a
    time, then group by group (the fewest segments a group that lets a
    512-row chunk's clusters of one block a group fit in one wave)."""
    n_tiles = -(-n // MATMUL_BN)
    k_tiles = -(-k // MATMUL_BK)
    s = 1
    while (2 * s in MATMUL_CLUSTERS and n_tiles <= MATMUL_CLUSTERS[2 * s]
           and k_tiles % (2 * s) == 0
           and k_tiles // (2 * s) >= MATMUL_MIN_K_TILES):
        s *= 2
    groups = s
    while (groups > 1 and
           MATMUL_PREFILL_M_TILES * n_tiles > MATMUL_CLUSTERS[groups]):
        groups //= 2
    return k_tiles // s, s, s // groups


def matmul_bucket(m: int) -> int:
    """Consumer warpgroups of a block (64 rows each): one up to 64 rows
    (decode), two above (verify's B x W rows are then one m-tile)."""
    return 1 if m <= MATMUL_WG_ROWS else 2


def matmul_launch(m: int, n: int, k: int) -> dict:
    """How a call of M rows runs: its bucket, its tiles, the plan's
    segments, and the form (``run`` segments a block: 1 for split, the
    group for serial): split while its clusters of ``n_segs`` blocks fit
    in one wave (decode, verify), else serial; 'single' when one segment
    covers K (the two forms are one)."""
    seg_tiles, n_segs, group = matmul_plan(n, k)
    nwg = matmul_bucket(m)
    m_tiles = -(-m // (nwg * MATMUL_WG_ROWS))
    n_tiles = -(-n // MATMUL_BN)
    serial = m_tiles * n_tiles > MATMUL_CLUSTERS[n_segs]
    run = group if serial else 1
    return dict(nwg=nwg, tile=[nwg * MATMUL_WG_ROWS, MATMUL_BN, MATMUL_BK],
                m_tiles=m_tiles, n_tiles=n_tiles, seg_tiles=seg_tiles,
                n_segs=n_segs, group=group, run=run,
                blocks_per_tile=n_segs // run,
                form=('single' if n_segs == 1 else
                      'serial' if serial else 'split'))


@functools.lru_cache(maxsize=4096)
def _launch_args(m: int, n: int, k: int):
    """``matmul_launch``'s kernel arguments (seg_tiles, n_segs, group,
    run, nwg), kept per shape: the engine calls a few shapes many times
    a step."""
    p = matmul_launch(m, n, k)
    return p['seg_tiles'], p['n_segs'], p['group'], p['run'], p['nwg']


def _stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as a raw handle (the cheap
    getter torch's own compiled kernels use)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


# The plain version: ``x @ w``, or ``(x @ q.to(x.dtype)) * s`` for an
# int8 ``{'q', 's'}`` weight, as the training forward computes it.
_matmul_plain = llama.matmul


def _capturing(dev: torch.device) -> bool:
    return dev.type == 'cuda' and torch.cuda.is_current_stream_capturing()


# Weight tensor maps: (device, pointer, shape, strides, dtype, form) ->
# [map, weak reference to the weight's base tensor].
_MAPS = {}


def _encode_map(mat: torch.Tensor, form: int, k: int, n: int, ld: int):
    """A weight's TMA tensor map (``skypilot_matmul_weight_map``), in a
    host buffer of the map's size."""
    lib = _build.load('matmul_invariant')
    size_of = lib.skypilot_matmul_map_bytes
    size_of.argtypes, size_of.restype = [], _I
    fn = lib.skypilot_matmul_weight_map
    fn.argtypes, fn.restype = [_P, _P, _I, _I, _LL, _I], _I
    buf = ctypes.create_string_buffer(size_of())
    code = fn(ctypes.addressof(buf), mat.data_ptr(), k, n, ld, form)
    if code != 0:
        raise _build.KernelError(f'skypilot_matmul_weight_map: CUDA error '
                                 f'{code}')
    return buf


def _sweep_maps():
    """Drop the maps of weights that are gone. A live weight's map stays,
    so a graph captured after a sweep still finds every map it needs."""
    for key in [key for key, (_, owner) in _MAPS.items() if owner() is None]:
        del _MAPS[key]


def _weight_map(mat: torch.Tensor, form: int, k: int, n: int, ld: int):
    """The weight's tensor map, encoded on its first call and kept while
    the weight lives: a map is fixed by (device, pointer, shape, strides,
    dtype, form), so a freed weight's key names the same map for whatever
    takes its place. Past ``MATMUL_MAX_MAPS`` maps the dead weights' are
    swept. Never encoded inside a CUDA-graph capture."""
    key = (mat.device.index, mat.data_ptr(), tuple(mat.shape), mat.stride(),
           mat.dtype, form)
    # A view (the tied head's transpose) lives as long as its base.
    base = mat if mat._base is None else mat._base
    entry = _MAPS.get(key)
    if entry is None:
        if _capturing(mat.device):
            raise RuntimeError('matmul: a weight\'s tensor map is encoded on '
                               'its first call, which may not be captured')
        if len(_MAPS) >= MATMUL_MAX_MAPS:
            _sweep_maps()
        entry = [_encode_map(mat, form, k, n, ld), weakref.ref(base)]
        _MAPS[key] = entry
    elif entry[1]() is not base:
        entry[1] = weakref.ref(base)   # a new weight where a freed one was
    return entry[0]


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
        form, ldw = FORM_Q8, n
    else:
        if mat.dtype != torch.bfloat16:
            raise TypeError(f'matmul: the CUDA kernel takes bf16 weights, '
                            f'got {mat.dtype}')
        if mat.stride() == (n, 1):
            form, ldw = FORM_BF16, n
        elif mat.stride() == (1, k):    # the transpose of an [N, K] matrix
            form, ldw = FORM_BF16_T, k
        else:
            raise ValueError('matmul: w must be a contiguous [K, N] or the '
                             f'transpose of one, strides {mat.stride()}')
    x2 = x if x.dim() == 2 else x.reshape(-1, k)
    m = x2.shape[0]
    # TMA: 16-byte aligned bases and row strides that are multiples of
    # 16 bytes (8 bf16).
    if (k % 8 or n % 8 or x2.stride(1) != 1 or x2.stride(0) % 8
            or not _aligned(x2) or not _aligned(mat)):
        raise ValueError('matmul: K and N must be multiples of 8, and x and '
                         'w 16-byte aligned with 16-byte row strides for '
                         f'TMA (K {k}, N {n}, x strides {x2.stride()})')
    y = x2.new_empty((m, n))
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    plan = _launch_args(m, n, k)
    wmap = _weight_map(mat, form, k, n, ldw)
    stream = _stream(x.device)
    if q8:
        MATMUL_Q8(x2.data_ptr(), x2.stride(0), ctypes.addressof(wmap),
                  w['s'].data_ptr(), y.data_ptr(), m, n, k, n, *plan, stream)
    else:
        MATMUL(x2.data_ptr(), x2.stride(0), ctypes.addressof(wmap),
               y.data_ptr(), m, n, k, n, *plan, int(form == FORM_BF16_T),
               stream)
    return y if x.dim() == 2 else y.view(*x.shape[:-1], n)


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


def _lora_mid_plain(h, a_slots, adapter_idx):
    """The kernels' first phase in their grouping of sums: ``h @ A[slot]``
    over d-chunks of ``LORA_CHUNK``, the chunks' partials added in
    order. [B, T, R] f32."""
    a = a_slots[adapter_idx.long()]
    hf = h.float()
    mid = None
    for d0 in range(0, h.shape[-1], LORA_CHUNK):
        p = torch.bmm(hf[..., d0:d0 + LORA_CHUNK], a[:, d0:d0 + LORA_CHUNK])
        mid = p if mid is None else mid + p
    return mid


def _lora_out_plain(mid, b_slots, adapter_idx):
    """The second phase: ``mid @ B[slot]``. [B, T, out] f32."""
    return torch.bmm(mid, b_slots[adapter_idx.long()])


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
    if (d_a != d or d % 2 or b_slots.shape[:2] != (a_slots.shape[0], r)
            or r > LORA_MAX_RANK or adapter_idx.shape != (b,)
            or LORA_OUT_ROWS * -(-d // LORA_CHUNK) * r * 4 > LORA_OUT_SMEM
            or not all(x.is_contiguous() for x in (a_slots, b_slots))):
        raise ValueError('lora_gather_delta: h [B, T, d] (d even, its '
                         'chunk partials within the staging), '
                         f'contiguous A [C+1, d, R <= {LORA_MAX_RANK}], B '
                         '[C+1, R, out], adapter_idx [B] expected, got '
                         f'{tuple(h.shape)}, '
                         f'{tuple(a_slots.shape)}, {tuple(b_slots.shape)}, '
                         f'{tuple(adapter_idx.shape)}')
    out = torch.empty((b, t, n_out), dtype=torch.float32, device=dev)
    rows = b * t
    if rows == 0:
        return out
    # Bound to names: a temporary's memory could be handed out again
    # before the kernel reads it.
    h_c = h.contiguous()
    slots = adapter_idx.to(torch.int32).contiguous()
    part = torch.empty((rows, -(-d // LORA_CHUNK), r), dtype=torch.float32,
                       device=dev)
    stream = _stream(dev)
    LORA_MID(h_c.data_ptr(), slots.data_ptr(), a_slots.data_ptr(),
             part.data_ptr(), rows, t, d, r, stream)
    LORA_DELTA(part.data_ptr(), slots.data_ptr(), b_slots.data_ptr(),
               out.data_ptr(), rows, t, d, r, n_out, stream)
    return out


def lora_gather_delta(h: torch.Tensor, a_slots: torch.Tensor,
                      b_slots: torch.Tensor,
                      adapter_idx: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta ``(h @ A[slot]) @ B[slot]`` in f32: h [B, T, d],
    a_slots [C+1, d, R], b_slots [C+1, R, out], adapter_idx [B] (slot 0
    all zeros). CUDA: two launches, each row's ``h @ A`` once and then
    its product with B, each slot's factors read once per block, sums in
    an order set by (d, R) alone; CPU: two batched products, as the JAX
    package's einsums."""
    if h.device.type == 'cuda':
        return _lora_cuda(h, a_slots, b_slots, adapter_idx)
    if h.device.type != 'cpu':
        raise ValueError(f'lora_gather_delta: unsupported device {h.device}')
    return _lora_plain(h, a_slots, b_slots, adapter_idx)
