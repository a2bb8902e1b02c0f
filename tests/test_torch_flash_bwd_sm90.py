"""The CPU side of the sm_90a backward: the pre-pass kernel's plain
version ``_bwd_prep_plain`` and the checks in front of the backward's
tensor maps, held to the JAX package on the same numpy inputs.

- delta = rowsum(do * out) in f32, ``[B, H, T]``, against the JAX
  expression in ``_bwd_pallas`` (skypilot_tpu/ops/attention.py) on the
  same bf16 inputs: the sums differ only in order, so rtol = 1e-6.
- The rotated q and k are the forward's plain rotation ``_rot``, bit for
  bit (the kernel rounds as ``_rot`` does, and the card's check holds it
  bit-equal to this plain version), and within 1 bf16 ulp of the JAX
  kernels' ``_rot``, as ``test_torch_flash_fwd_sm90.py`` holds the
  forward's pre-pass: both rotate in f32 and round once to bf16, but
  XLA may fuse a product into an FMA where PyTorch rounds it first.
  Head_dim 64 and 128, a ragged T of 129, llama3 tables.
- ``_flash_bwd_plain``, rebuilt on ``_bwd_prep_plain``, gives what its
  direct formula (delta and the rotation computed inline) gives, to f32
  rounding (1e-6).
- The wrapper refuses a ``do`` or ``out`` that TMA cannot map (a stride
  that is not a whole number of 16-byte units, a base that is not
  16-byte aligned, a head_dim that is not unit-stride) before anything
  launches; CPU tensors never reach a kernel.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jattn
from skypilot_torch.models import llama as tllama
from skypilot_torch.ops import attention as tattn

H, HKV = 4, 2


def _tables(length: int, d: int):
    name = {128: 'llama3-8b', 64: 'llama3.2-1b'}[d]
    config = tllama.get_config(name)
    angles = tllama._rope_frequencies(config, torch.arange(length))
    return tattn.rope_tables(angles)


def _bf16(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _ordered_bf16_bits(x: torch.Tensor) -> np.ndarray:
    b = x.view(torch.int16).numpy().astype(np.int32)
    mag = b & 0x7FFF
    return np.where(b < 0, -mag, mag)


@pytest.mark.parametrize('d', [64, 128])
def test_prep_plain_delta_matches_jax_expression(d):
    b, t = 2, 129
    rng = np.random.default_rng(d + 1)
    q, out, do = (_bf16(rng, (b, t, H, d)) for _ in range(3))
    k = _bf16(rng, (b, t, HKV, d))
    delta, qr, kr = tattn._bwd_prep_plain(q, k, out, do)
    # Without tables q and k come back as given.
    assert qr is q and kr is k
    j_do = jnp.asarray(do.float().numpy().transpose(0, 2, 1, 3)).astype(
        jnp.bfloat16)
    j_out = jnp.asarray(out.float().numpy().transpose(0, 2, 1, 3)).astype(
        jnp.bfloat16)
    want = jnp.sum(j_do.astype(jnp.float32) * j_out.astype(jnp.float32),
                   axis=-1)
    assert delta.dtype == torch.float32 and delta.shape == (b, H, t)
    assert delta.is_contiguous()
    np.testing.assert_allclose(delta.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize('d', [64, 128])
def test_prep_plain_rotation_is_the_forward_rotation(d):
    b, t = 1, 129
    rng = np.random.default_rng(d + 2)
    q, out, do = (_bf16(rng, (b, t, H, d), 4.0) for _ in range(3))
    k = _bf16(rng, (b, t, HKV, d), 4.0)
    cos, sin = _tables(t, d)
    delta, qr, kr = tattn._bwd_prep_plain(q, k, out, do, cos, sin)
    assert qr.dtype == kr.dtype == torch.bfloat16
    assert torch.equal(qr, tattn._rot(q, cos, sin))
    assert torch.equal(kr, tattn._rot(k, cos, sin))
    jc, js = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    for got, x in ((qr, q), (kr, k)):
        xb = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        want = np.stack([np.asarray(jattn._rot(xb[0, :, h], jc, js))
                         for h in range(x.shape[2])], axis=1)[None]
        dist = np.abs(_ordered_bf16_bits(got) -
                      _ordered_bf16_bits(torch.from_numpy(
                          want.view(np.int16)).view(torch.bfloat16)))
        assert dist.max() <= 1, dist.max()
        assert (dist == 0).mean() > 0.99


def _bwd_direct(q, k, v, out, lse, do, cos, sin, causal, scale):
    """The plain backward with delta and the rotation computed inline,
    as it was before the pre-pass had a plain version of its own."""
    b, t, h, d = q.shape
    _, s, hkv, _ = k.shape
    g = h // hkv
    qr, kr = q, k
    if cos is not None:
        qr, kr = tattn._rot(q, cos, sin), tattn._rot(k, cos, sin)
    qf = qr.float().reshape(b, t, hkv, g, d)
    kf, vf = kr.float(), v.float()
    dof = do.float().reshape(b, t, hkv, g, d)
    logits = torch.einsum('bthgd,bshd->bhgts', qf, kf) * (
        scale * tattn.LOG2E)
    if causal:
        logits = logits.masked_fill(
            ~tattn._causal_visible(t, s, q.device), -math.inf)
    p = torch.exp2(logits - lse.float().reshape(b, hkv, g, t)[..., None])
    delta = (do.float() * out.float()).sum(-1)
    delta = delta.permute(0, 2, 1).reshape(b, hkv, g, t)[..., None]
    dp = torch.einsum('bthgd,bshd->bhgts', dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum('bhgts,bshd->bthgd', ds, kf).reshape(b, t, h, d)
    dk = torch.einsum('bhgts,bthgd->bshd', ds, qf)
    dv = torch.einsum('bhgts,bthgd->bshd', p, dof)
    dq, dk = dq * scale, dk * scale
    if cos is not None:
        dq, dk = tattn._rot_inv(dq, cos, sin), tattn._rot_inv(dk, cos, sin)
    return dq, dk, dv


@pytest.mark.parametrize('t,s,rope,causal', [
    (129, 129, True, True), (129, 129, False, False), (96, 64, False, True)],
    ids=['rope', 'full', 'empty-rows'])
def test_plain_bwd_on_prep_matches_direct_formula(t, s, rope, causal):
    d = 64
    rng = np.random.default_rng(t + s + rope)
    q, do = (torch.from_numpy(rng.standard_normal((2, t, H, d)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, s, HKV, d)).astype(
        np.float32)) for _ in range(2))
    cos = sin = None
    if rope:
        cos, sin = _tables(t, d)
    scale = d ** -0.5
    out, lse = tattn._flash_fwd_plain(q, k, v, causal, scale, cos, sin)
    got = tattn._flash_bwd_plain(q, k, v, out, lse, do, cos, sin, causal,
                                 scale)
    want = _bwd_direct(q, k, v, out, lse, do, cos, sin, causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))


def _bad_layouts():
    return {
        'stride': torch.zeros(1, 16, 4, 132,
                              dtype=torch.bfloat16)[..., :128],
        'base': torch.zeros(1 * 16 * 4 * 128 + 4,
                            dtype=torch.bfloat16)[4:].view(1, 16, 4, 128),
        'head-dim': torch.zeros(1, 16, 128, 4,
                                dtype=torch.bfloat16).transpose(2, 3),
    }


@pytest.mark.parametrize('layout', ['stride', 'base', 'head-dim'])
@pytest.mark.parametrize('which', ['do', 'out'])
def test_backward_wrapper_refuses_what_tma_cannot_map(which, layout):
    bad = _bad_layouts()[layout]
    assert bad.shape == (1, 16, 4, 128)
    q = torch.zeros(1, 16, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 16)
    args = dict(q=q, k=k, v=k.clone(), out=q.clone(), lse=lse, do=q.clone())
    args[which] = bad
    launches = (tattn.FLASH_BWD_PREP.launches, tattn.FLASH_BWD_DQ.launches,
                tattn.FLASH_BWD_DKV.launches)
    with pytest.raises(ValueError, match=f'{which} needs .*16-byte'):
        tattn._flash_bwd_cuda(**args, cos=None, sin=None, causal=True,
                              scale=128 ** -0.5)
    assert launches == (tattn.FLASH_BWD_PREP.launches,
                        tattn.FLASH_BWD_DQ.launches,
                        tattn.FLASH_BWD_DKV.launches)


def test_backward_wrapper_refuses_do_of_another_shape():
    q = torch.zeros(1, 16, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 16, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='out/do must match q'):
        tattn._flash_bwd_cuda(q, k, k, q, torch.zeros(1, 4, 16),
                              q[:, :8], None, None, True, 128 ** -0.5)


def test_cpu_backward_runs_the_plain_prep_not_the_kernel():
    rng = np.random.default_rng(9)
    q, k, v = (_bf16(rng, shape) for shape in
               ((1, 64, H, 64), (1, 64, HKV, 64), (1, 64, HKV, 64)))
    out, lse = tattn.flash_attention_fwd(q, k, v)
    before = tattn.FLASH_BWD_PREP.launches
    grads = tattn.flash_attention_bwd(q, k, v, out, lse, q.clone())
    assert tattn.FLASH_BWD_PREP.launches == before
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
