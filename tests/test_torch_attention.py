"""Parity of the port's attention ops (skypilot_torch/ops/attention.py)
with the JAX package on the CPU.

The port's CPU path is ``_flash_fwd_plain``, the plain version of
K1-cuda; it is held to the JAX Pallas forward kernel run in interpret
mode (out and the log2-domain lse, including the rows that see no key
when T > S) and to the dense XLA reference. Inputs are made with numpy
from a seed and handed to both sides. All in f32 under the conftest's
'highest' matmul precision: the two sides differ only in summation
order and where the softmax scale is applied (before vs after the
dot), a few f32 ulps on O(10) logits, hence rtol = atol = 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.ops import attention as jattn
from skypilot_torch.models import llama as tllama
from skypilot_torch.ops import attention as tattn

TOL = dict(rtol=1e-5, atol=1e-5)
H, HKV, D = 4, 2, 64


def _qkv(seed, b, t, s, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, H, d)).astype(np.float32)
    k = rng.standard_normal((b, s, HKV, d)).astype(np.float32)
    v = rng.standard_normal((b, s, HKV, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize('t,s', [(256, 256), (128, 256), (256, 128)])
def test_plain_matches_pallas_fwd_kernel(t, s):
    q, k, v = _qkv(t + 3 * s, 2, t, s)
    scale = D ** -0.5
    j_out, j_lse = jattn._fwd_pallas(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
        scale=scale, causal=True, block_q=128, block_k=128,
        interpret=True)
    t_out, t_lse = tattn._flash_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        scale=scale)
    np.testing.assert_allclose(t_out.numpy(),
                               np.asarray(j_out).transpose(0, 2, 1, 3),
                               **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[:, :, 0, :],
                               **TOL)
    if t > s:
        # Rows q_pos < t - s see no key: out 0, lse +1e30 on both sides.
        assert (t_lse.numpy()[:, :, :t - s] == tattn.EMPTY_ROW_LSE).all()
        assert (t_out.numpy()[:, :t - s] == 0).all()


@pytest.mark.parametrize('t,s,causal', [(256, 256, True),
                                        (128, 256, True),
                                        (17, 17, True),
                                        (64, 96, False)])
def test_flash_attention_cpu_matches_dense_reference(t, s, causal):
    q, k, v = _qkv(7 * t + s, 2, t, s)
    before = tattn.FLASH_FWD.launches
    out = tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal)
    ref = jattn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # A CPU tensor runs the plain version; the kernel is never touched.
    assert tattn.FLASH_FWD.launches == before


def test_dot_product_attention_matches_jax():
    q, k, v = _qkv(5, 2, 32, 48)
    out = tattn.dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    ref = jattn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 4, 64)).astype(np.float32)
    pos = np.arange(100, 140)
    jcfg = jllama.get_config('llama3.2-1b', head_dim_override=64)
    tcfg = tllama.get_config('llama3.2-1b', head_dim_override=64)
    j_ang = jllama._rope_frequencies(jcfg, jnp.asarray(pos))
    t_ang = tllama._rope_frequencies(tcfg, torch.from_numpy(pos))
    out = tattn.apply_rope(torch.from_numpy(x), t_ang)
    ref = jattn.apply_rope(jnp.asarray(x), j_ang)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_unsupported_device_raises():
    q = torch.empty((1, 4, H, D), device='meta')
    k = torch.empty((1, 4, HKV, D), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tattn.flash_attention(q, k, k)
