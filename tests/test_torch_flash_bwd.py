"""Parity of the port's training attention (skypilot_torch/ops/
attention.py) with the JAX package on the CPU: the fused-RoPE forward,
the backward and the autograd Function.

``_flash_fwd_plain`` with RoPE and ``_flash_bwd_plain`` (the plain
versions of K1-cuda's RoPE entry and of K2/K3-cuda) are held to the
Pallas kernels ``_fwd_pallas`` / ``_bwd_pallas`` run in interpret mode:
H 4, Hkv 2, D 64, blocks of 128, (T, S) in {(256, 256), (128, 256),
(256, 64)}. RoPE runs only where T == S: the JAX kernels index their
[T, D] tables by key position too, so T != S is outside their contract.
(256, 64) has rows that see no key, whose gradients must be exactly 0.
``flash_attention(..., rope_angles=)`` and its autograd gradients are
held to ``jax.grad`` of the JAX ``flash_attention`` forced onto the
Pallas kernels in interpret mode. Inputs are made with numpy from a
seed, in f32 under the conftest's 'highest' matmul precision; the sides
differ only in summation order and where the scale is applied, a few
f32 ulps on O(10) values, so rtol = atol = 1e-4. Both backwards also
hold, relative to 1e-4, the sums the card's backward is held to:
sum_keys dV = sum of dO over the rows that see a key, and without RoPE
sum_keys dK = 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jattn
from skypilot_torch.ops import attention as tattn

TOL = dict(rtol=1e-4, atol=1e-4)
H, HKV, D = 4, 2, 64
SCALE = D ** -0.5
CASES = [(256, 256, True), (256, 256, False), (128, 256, False),
         (256, 64, False)]


def _inputs(seed, b, t, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, H, D)).astype(np.float32)
    k = rng.standard_normal((b, s, HKV, D)).astype(np.float32)
    v = rng.standard_normal((b, s, HKV, D)).astype(np.float32)
    do = rng.standard_normal((b, t, H, D)).astype(np.float32)
    # Llama-style angles: position times per-pair frequencies.
    freqs = 1.0 / 10000.0 ** (np.arange(0, D, 2) / D)
    angles = (np.arange(t)[:, None] * freqs[None, :]).astype(np.float32)
    return q, k, v, do, angles


def _jax_tables(angles):
    full = jnp.concatenate([angles, angles], axis=-1)
    return jnp.cos(full), jnp.sin(full)


def _bhtd(x):
    return jnp.asarray(x.transpose(0, 2, 1, 3))


def _tbhd(x):
    return np.array(x).transpose(0, 2, 1, 3)  # a writable copy


def _pallas_fwd(q, k, v, cos, sin):
    return jattn._fwd_pallas(_bhtd(q), _bhtd(k), _bhtd(v), cos, sin,
                             scale=SCALE, causal=True, block_q=128,
                             block_k=128, interpret=True)


@pytest.mark.parametrize('t,s,rope', CASES)
def test_plain_fwd_matches_pallas_fwd(t, s, rope):
    q, k, v, _, angles = _inputs(t + 5 * s, 2, t, s)
    cos = sin = tcos = tsin = None
    if rope:
        cos, sin = _jax_tables(angles)
        tcos, tsin = tattn.rope_tables(torch.from_numpy(angles))
    j_out, j_lse = _pallas_fwd(q, k, v, cos, sin)
    t_out, t_lse = tattn._flash_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), True, SCALE, tcos, tsin)
    np.testing.assert_allclose(t_out.numpy(), _tbhd(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse)[:, :, 0],
                               **TOL)


@pytest.mark.parametrize('t,s,rope', CASES)
def test_plain_bwd_matches_pallas_bwd(t, s, rope):
    q, k, v, do, angles = _inputs(3 * t + s, 2, t, s)
    cos = sin = tcos = tsin = None
    if rope:
        cos, sin = _jax_tables(angles)
        tcos, tsin = tattn.rope_tables(torch.from_numpy(angles))
    j_out, j_lse = _pallas_fwd(q, k, v, cos, sin)
    j_grads = jattn._bwd_pallas(
        _bhtd(q), _bhtd(k), _bhtd(v), j_out, j_lse[:, :, 0], _bhtd(do),
        cos, sin, scale=SCALE, causal=True, block_q=128, block_k=128,
        interpret=True)
    # The same saved forward (out, lse) on both sides.
    t_grads = tattn._flash_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(_tbhd(j_out)),
        torch.from_numpy(np.array(j_lse)[:, :, 0]), torch.from_numpy(do),
        tcos, tsin, True, SCALE)
    for got, want in zip(t_grads, j_grads):
        np.testing.assert_allclose(got.numpy(), _tbhd(want), **TOL)
    if t > s:
        # Rows q_pos < T - S see no key (lse = +1e30): zero gradients.
        assert (t_grads[0].numpy()[:, :t - s] == 0).all()
        assert (np.asarray(j_lse)[:, :, 0, :t - s]
                == tattn.EMPTY_ROW_LSE).all()


def _dv_and_dk_sums(dk, dv, do, t, s):
    """(sum over keys of dV - sum of dO over the group's rows that see a
    key, per (b, kv head); sum over keys of dK), both in [B, S, Hkv, D]
    layout. The first is 0 when P's rows sum to 1; the second when, in
    addition, out = P V (delta = rowsum(dO out)) and no RoPE turns dK."""
    b, _, h, d = do.shape
    hkv = dv.shape[2]
    seen = (np.arange(t) + (s - t) >= 0)[None, :, None, None]
    rhs = (do * seen).sum(1).reshape(b, hkv, h // hkv, d).sum(2)
    return dv.sum(1) - rhs, rhs, dk.sum(1)


@pytest.mark.parametrize('t,s,rope', CASES)
def test_bwd_sums_hold_for_plain_and_pallas(t, s, rope):
    """The invariants the card's backward is held to, with no reference:
    sum_keys dV = sum over the rows that see a key of dO (exactly when
    P's rows sum to 1), and, without RoPE, sum_keys dK = 0; for the
    plain version and for the Pallas kernels on the same inputs."""
    q, k, v, do, angles = _inputs(7 * t + s, 2, t, s)
    cos = sin = tcos = tsin = None
    if rope:
        cos, sin = _jax_tables(angles)
        tcos, tsin = tattn.rope_tables(torch.from_numpy(angles))
    j_out, j_lse = _pallas_fwd(q, k, v, cos, sin)
    _, j_dk, j_dv = jattn._bwd_pallas(
        _bhtd(q), _bhtd(k), _bhtd(v), j_out, j_lse[:, :, 0], _bhtd(do),
        cos, sin, scale=SCALE, causal=True, block_q=128, block_k=128,
        interpret=True)
    _, t_dk, t_dv = tattn._flash_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(_tbhd(j_out)),
        torch.from_numpy(np.array(j_lse)[:, :, 0]), torch.from_numpy(do),
        tcos, tsin, True, SCALE)
    for dk, dv in ((t_dk.numpy(), t_dv.numpy()),
                   (_tbhd(j_dk), _tbhd(j_dv))):
        dv_err, rhs, dk_sum = _dv_and_dk_sums(dk, dv, do, t, s)
        assert np.abs(dv_err).max() <= 1e-4 * np.abs(rhs).max()
        if not rope:
            assert np.abs(dk_sum).max() <= 1e-4 * np.abs(dk).max()


@pytest.mark.parametrize('rope', [True, False])
def test_autograd_matches_jax_grad(rope):
    t = s = 256
    q, k, v, do, angles = _inputs(11 + rope, 2, t, s)
    j_ang = jnp.asarray(angles) if rope else None

    def j_loss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=True, rope_angles=j_ang,
                                    force_pallas=True, interpret=True)
        return (out * jnp.asarray(do)).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    launches = (tattn.FLASH_FWD_ROPE.launches, tattn.FLASH_BWD_DQ.launches,
                tattn.FLASH_BWD_DKV.launches)
    out = tattn.flash_attention(
        tq, tk, tv, causal=True,
        rope_angles=torch.from_numpy(angles) if rope else None)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    for got, want in zip((tq, tk, tv), j_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **TOL)
    # CPU tensors run the plain versions; no kernel is touched.
    assert launches == (tattn.FLASH_FWD_ROPE.launches,
                        tattn.FLASH_BWD_DQ.launches,
                        tattn.FLASH_BWD_DKV.launches)


def test_no_grad_call_skips_the_autograd_function():
    q, k, v, _, angles = _inputs(4, 1, 64, 64)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    ang = torch.from_numpy(angles)
    with torch.no_grad():
        plain = tattn.flash_attention(*args, rope_angles=ang)
    recorded = tattn.flash_attention(
        *(x.clone().requires_grad_(True) for x in args), rope_angles=ang)
    assert plain.grad_fn is None
    assert recorded.grad_fn is not None
    torch.testing.assert_close(recorded.detach(), plain, rtol=0, atol=0)


def test_rope_needs_aligned_lengths():
    q, k, v, _, angles = _inputs(6, 1, 128, 256)
    with pytest.raises(ValueError, match='aligned self-attention'):
        tattn.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              rope_angles=torch.from_numpy(angles))


def test_rope_tables_are_duplicated_angles():
    angles = torch.linspace(0, 50, 3 * 4).reshape(3, 4)
    cos, sin = tattn.rope_tables(angles)
    assert cos.shape == sin.shape == (3, 8)
    assert cos.dtype == torch.float32 and cos.is_contiguous()
    torch.testing.assert_close(cos[:, :4], cos[:, 4:], rtol=0, atol=0)
    torch.testing.assert_close(sin[:, 4:], torch.sin(angles), rtol=0,
                               atol=0)


def test_backward_on_unsupported_device_raises():
    q = torch.empty((1, 4, H, D), device='meta')
    k = torch.empty((1, 4, HKV, D), device='meta')
    lse = torch.empty((1, H, 4), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tattn.flash_attention_bwd(q, k, k, q, lse, q)
