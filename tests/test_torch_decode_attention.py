"""Parity of the port's decode attention
(skypilot_torch/ops/decode_attention.py) with the JAX package on the
CPU: the port's CPU path, the plain version of K4-cuda, against the
JAX Pallas kernel in interpret mode and against the dense reference.
Inputs from a numpy seed; f32 under the conftest's 'highest' matmul
precision. Tolerance 2e-5, the JAX package's own for these two (the
kernel's online softmax over 512-key chunks sums in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.ops import decode_attention as jda
from skypilot_torch.ops import decode_attention as tda

TOL = dict(rtol=2e-5, atol=2e-5)
HQ, HKV, HD, S = 8, 2, 64, 1024


@pytest.fixture(scope='module')
def qkv():
    rng = np.random.default_rng(0)
    b = 4
    q = rng.standard_normal((b, HQ, HD)).astype(np.float32)
    k = rng.standard_normal((b, S, HKV, HD)).astype(np.float32)
    v = rng.standard_normal((b, S, HKV, HD)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize('lengths', [[1, 500, 513, 1024],
                                     [0, 2, 511, 512]])
def test_matches_pallas_kernel(qkv, lengths):
    """Lengths straddling the kernel's 512-key chunks; a 0 length is
    clamped to 1 by both."""
    q, k, v = qkv
    scale = HD ** -0.5
    lens = np.asarray(lengths, np.int32)
    ref = jda._decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        scale, jda._BLOCK_S, interpret=True)
    before = tda.DECODE_ATTENTION.launches
    out = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens),
                               scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tda.DECODE_ATTENTION.launches == before


def test_matches_dense_reference(qkv):
    q, k, v = qkv
    scale = HD ** -0.5
    lens = np.asarray([1, 500, 513, 1024], np.int32)
    ref = jda._reference_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        scale)
    out = tda._reference_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_unsupported_device_raises():
    q = torch.empty((1, HQ, HD), device='meta')
    k = torch.empty((1, 8, HKV, HD), device='meta')
    lens = torch.ones((1,), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tda.decode_attention(q, k, k, lens, 1.0)
