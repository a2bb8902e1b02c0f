"""The CPU side of the sm_90a attention forward (K1-cuda and K6-cuda on
``csrc/flash_fwd_sm90.cuh``): what the kernels' results are held to on
the card, checked here against the JAX package on the same numpy inputs.

- The RoPE pre-pass of K1-cuda's fused-RoPE entry rotates every q and k
  row once; its plain version is ``attention._rot``. It is held to the
  JAX kernels' ``_rot`` on bf16 inputs and llama3 tables to within 1
  bf16 ulp: both rotate in f32 and round once to bf16, but XLA may fuse
  ``x cos + swap sin`` into one FMA where PyTorch rounds the product
  first, which can move a result that lies on a rounding boundary by
  one ulp.
- The tile edges and shapes the card checks (T = S of 127, 128 and 129
  against 128-key tiles, head_dim 64 and 128, causal and full, GQA
  groups 4, a q that is a strided view into a fused qkv buffer): the
  plain version ``_flash_fwd_plain`` against the JAX dense reference,
  f32, rtol = atol = 1e-5 (summation order only, as
  ``test_torch_attention.py``).
- K6's new cases (GQA groups 2 at head_dim 128; T = S = 192, a length
  the reference's block min(512, T) allows and the kernel's 128-key tile
  does not divide): its plain version against the JAX entry in interpret
  mode, tolerance 2e-3 as ``test_torch_attention_packed.py``.
- The layout checks in front of the tensor maps: a stride that is not a
  whole number of 16-byte units, a base that is not 16-byte aligned and
  a head_dim that is not unit-stride are refused; the fused-buffer view
  is taken.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.ops import attention as jattn
from skypilot_tpu.ops import attention_packed as jpacked
from skypilot_torch.models import llama as tllama
from skypilot_torch.ops import attention as tattn
from skypilot_torch.ops import attention_packed as tpacked

TOL = dict(rtol=1e-5, atol=1e-5)
PACKED_TOL = dict(atol=2e-3, rtol=2e-3)


def _ordered_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (int16) -> integers ordered like the values, so
    neighbouring bf16 values differ by 1."""
    b = bits.astype(np.int32)
    mag = b & 0x7FFF
    return np.where(b < 0, -mag, mag)


def _llama3_tables(length: int, d: int):
    """The port's llama3 RoPE tables at head_dim d (llama3-8b's at 128,
    llama3.2-1b's, with the llama3.1 frequency scaling, at 64)."""
    name = {128: 'llama3-8b', 64: 'llama3.2-1b'}[d]
    config = tllama.get_config(name)
    assert config.head_dim == d
    angles = tllama._rope_frequencies(config, torch.arange(length))
    return tattn.rope_tables(angles)


@pytest.mark.parametrize('d', [64, 128])
def test_rope_prepass_plain_matches_jax_rot(d):
    length, heads = 300, 3
    rng = np.random.default_rng(d)
    x32 = (rng.standard_normal((1, length, heads, d)) * 4).astype(
        np.float32)
    cos, sin = _llama3_tables(length, d)
    got = tattn._rot(torch.from_numpy(x32).to(torch.bfloat16), cos, sin)
    xb = jnp.asarray(x32).astype(jnp.bfloat16)
    jc, js = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    # The JAX _rot takes one [R, D] block: one head's rows.
    want = np.stack([np.asarray(jattn._rot(xb[0, :, h], jc, js))
                     for h in range(heads)], axis=1)[None]
    got_bits = got.view(torch.int16).numpy()
    want_bits = want.view(np.int16)
    dist = np.abs(_ordered_bf16_bits(got_bits) -
                  _ordered_bf16_bits(want_bits))
    assert dist.max() <= 1, dist.max()
    # Nearly every element is bit-equal; the ulp is the rare boundary.
    assert (dist == 0).mean() > 0.99


def _qkv(seed, b, t, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, t, h, d), (b, s, hkv, d),
                               (b, s, hkv, d)))


@pytest.mark.parametrize('t', [127, 128, 129])
@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
def test_plain_at_tile_edges_matches_dense_reference(t, d, causal):
    q, k, v = _qkv(t + d, 1, t, t, 8, 2, d)
    out, lse = tattn.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    ref = jattn.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert lse.shape == (1, 8, t) and bool(torch.isfinite(lse).all())


def test_fused_qkv_view_equals_contiguous_inputs():
    """q, k and v as strided views into one [B, T, H + 2 Hkv, D] buffer,
    the layout a fused qkv projection leaves, give what contiguous
    copies give, and pass the checks in front of the tensor maps."""
    b, t, h, hkv, d = 2, 129, 8, 2, 128
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.standard_normal(
        (b, t, h + 2 * hkv, d)).astype(np.float32))
    q, k, v = buf[:, :, :h], buf[:, :, h:h + hkv], buf[:, :, h + hkv:]
    assert not q.is_contiguous() and q.stride() == (
        t * (h + 2 * hkv) * d, (h + 2 * hkv) * d, d, 1)
    out, lse = tattn.flash_attention_fwd(q, k, v, causal=True)
    ref_out, ref_lse = tattn.flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    bf = buf.to(torch.bfloat16)
    tattn._check_cuda('flash_attention', (
        ('q', bf[:, :, :h]), ('k', bf[:, :, h:h + hkv]),
        ('v', bf[:, :, h + hkv:])))


@pytest.mark.parametrize('what,make', [
    ('row stride of 132 elements (264 bytes)',
     lambda: torch.zeros(1, 16, 4, 132, dtype=torch.bfloat16)[..., :128]),
    ('base 8 bytes past a 16-byte boundary',
     lambda: torch.zeros(1 * 16 * 4 * 128 + 4,
                         dtype=torch.bfloat16)[4:].view(1, 16, 4, 128)),
    ('head_dim not unit-stride',
     lambda: torch.zeros(1, 16, 128, 4,
                         dtype=torch.bfloat16).transpose(2, 3)),
], ids=['stride', 'base', 'head-dim'])
def test_layout_checks_refuse_what_tma_cannot_map(what, make):
    x = make()
    assert x.shape == (1, 16, 4, 128), what
    good = torch.zeros(1, 16, 4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='16-byte'):
        tattn._check_cuda('flash_attention', (('q', x), ('k', good)))


@pytest.mark.parametrize('h,hkv,t,d', [(8, 4, 256, 128), (4, 2, 192, 64),
                                       (4, 4, 192, 128)],
                         ids=['groups-2-d128', 'T=S=192', 'T=S=192-paired'])
def test_packed_new_cases_match_jax_interpret(h, hkv, t, d):
    rng = np.random.default_rng(t + d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, h, t, d), (1, hkv, t, d), (1, hkv, t, d)))
    jout, jlse = jpacked.packed_flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True)
    out, lse = tpacked.packed_flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **PACKED_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0],
                               **PACKED_TOL)
