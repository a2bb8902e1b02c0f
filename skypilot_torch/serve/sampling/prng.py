"""Counter-based per-request PRNG — the port of
``skypilot_tpu/serve/sampling/prng.py``, with the threefry2x32
machinery of ``jax.random`` written in torch integer ops.

Every random draw the serve plane makes is keyed by
``(request_seed, absolute_position)`` and nothing else, so a request
sees the same draws alone or beside neighbours (batch invariance), a
resumed request re-derives its keys, and a verify column draws with the
key plain decode would use at that position (spec-on is spec-off).

The port carries JAX's key derivation bit for bit, as JAX 0.9 computes
it with ``jax_threefry_partitionable`` on (its default):

- ``PRNGKey(uint32 s)`` is the key pair ``(0, s)``;
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- ``split(key, n)`` hashes the 2x32 counters ``(0, i)`` for i < n, and
  key i is the pair of the two hash outputs;
- 32-bit ``random_bits(key, shape)`` hashes the 2x32 counters
  ``(i >> 32, i & 0xFFFFFFFF)`` of the flat index i and XORs the two
  outputs;
- ``uniform`` fills the 23 mantissa bits of a float in [1, 2) from the
  top bits and subtracts 1; ``gumbel`` (mode "low") is
  ``-log(-log(uniform(tiny, 1)))``; ``categorical`` is the argmax of
  gumbel noise plus logits (first index on ties).

uint32 values are held in int64 tensors and masked with ``& 0xFFFFFFFF``
after every add and rotate, so nothing depends on ``torch.uint32``
arithmetic. A key is an int64 tensor ``[..., 2]``; leading dimensions
are a batch of keys (JAX's ``vmap`` over keys).
"""
import math
from typing import Sequence, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
# Threefry-2x32, 20 rounds: the rotation schedule and key-parity
# constant of Salmon et al. (2011), as jax._src.prng uses them.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# np.finfo(np.float32).tiny: gumbel's lower bound for the uniform.
_F32_TINY = 2.0 ** -126

IntLike = Union[int, torch.Tensor]


def _u32(x: IntLike, device=None) -> torch.Tensor:
    """An int64 tensor of ``x`` taken mod 2**32 (negative ints wrap as
    their two's complement, as a cast to uint32 does)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2); all int64 tensors of uint32 values, broadcast together.
    Returns the two uint32 output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = (a ^ ((b << r) | (b >> (32 - r)))) & _M32
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def seed_key(seed: IntLike, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(uint32(seed))``: the key pair (0, seed)."""
    s = _u32(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` [..., 2] and the
    uint32 of ``data`` (a scalar, or one value per key)."""
    d = _u32(data, key.device)
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key [2] into ``num`` keys [num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def row_key(seed: IntLike, position: IntLike) -> torch.Tensor:
    """Key [2] for the single draw at ``(seed, position)``: ``fold_in``
    of the position into the request's root key — stateless and
    order-free. ``seed`` is taken as uint32 (the engine stores it as the
    int32 two's complement of ``seed mod 2**32``)."""
    dev = position.device if isinstance(position, torch.Tensor) else None
    return fold_in(seed_key(seed, dev), position)


def row_keys(seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Vectorized ``row_key`` over per-row [B] seeds and positions:
    keys [B, 2]."""
    return fold_in(seed_key(seeds, positions.device), positions)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)``: int64 [..., *shape] of
    uint32 values for keys [..., 2]."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    a, b = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (a ^ b).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 ``jax.random.uniform``: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [minval, maxval) in f32 and
    clamped below at minval."""
    bits = random_bits(key, shape)
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    # The bounds and their difference rounded to f32 on the host, so no
    # scalar is copied to the device.
    lo32 = torch.tensor(minval, dtype=torch.float32)
    lo = lo32.item()
    scale = (torch.tensor(maxval, dtype=torch.float32) - lo32).item()
    return torch.clamp_min(floats * scale + lo, lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """f32 ``jax.random.gumbel`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the argmax of
    gumbel noise plus logits. ``key`` [..., 2] is a batch of keys
    matching ``logits``' leading dimensions; each key draws the noise of
    the shape that follows them (one key over [B, V] logits is JAX's
    single-key call, keys [B, 2] over [B, V] its ``vmap`` over rows).
    Returns int64 [logits.shape[:-1]]."""
    shape = logits.shape[key.dim() - 1:]
    return (gumbel(key, shape) + logits).argmax(dim=-1)
