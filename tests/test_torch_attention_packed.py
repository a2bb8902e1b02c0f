"""The port's head-paired flash forward (skypilot_torch/ops/
attention_packed.py, K6) on the CPU: its plain version against the JAX
package's ``packed_flash_attention_fwd`` in interpret mode, on the same
numpy inputs, in f32. Tolerance 2e-3 absolute and relative on out and
lse, as the JAX package's own test of the kernel: the two sides sum in
other orders (blockwise online softmax against one dense softmax). The
entry refuses the reference's three faults and an odd H; its bench
entry needs the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.ops import attention_packed as jpacked
from skypilot_torch import device as device_lib
from skypilot_torch.ops import attention as tattention
from skypilot_torch.ops import attention_packed as tpacked

TOL = dict(atol=2e-3, rtol=2e-3)


def _inputs(b, h, hkv, t, s, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, t, d), (b, hkv, s, d), (b, hkv, s, d)))


@pytest.mark.parametrize('h,hkv', [(8, 2), (4, 4)],
                         ids=['gqa-shared-kv', 'mha-paired-kv'])
@pytest.mark.parametrize('t,s,causal', [(256, 256, True), (128, 256, True),
                                        (128, 256, False)],
                         ids=['causal-T=S', 'causal-T<S', 'full'])
def test_plain_matches_jax_interpret(h, hkv, t, s, causal):
    q, k, v = _inputs(2, h, hkv, t, s)
    jout, jlse = jpacked.packed_flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128, interpret=True)
    out, lse = tpacked.packed_flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=128, block_k=128)
    assert out.shape == q.shape and lse.shape == (2, h, t)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    # The reference broadcasts lse over 8 sublanes: [B, H, 8, T].
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0],
                               **TOL)


def test_plain_equals_k1_plain():
    """K6's result is K1's where the reference is right: the port's K1
    plain version on a [B, T, H, D] view gives the same out and lse."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 8, 2, 128, 256,
                                                    seed=1))
    out, lse = tpacked.packed_flash_attention_fwd(q, k, v, block_q=64,
                                                  block_k=64)
    k1_out, k1_lse = tattention._flash_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True)
    np.testing.assert_allclose(out.numpy(), k1_out.transpose(1, 2).numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), k1_lse.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('h,hkv,t,s,causal,blocks,match', [
    (3, 3, 64, 64, True, (64, 64), 'needs an even H'),
    (9, 3, 64, 64, True, (64, 64), 'needs an even H'),
    (6, 2, 64, 64, True, (64, 64), 'fault 1'),
    (12, 4, 64, 64, True, (64, 64), 'fault 1'),
    (4, 2, 128, 64, True, (64, 64), 'fault 2'),
    (4, 2, 96, 96, True, (64, 64), 'fault 3'),
    (4, 2, 64, 96, False, (64, 64), 'fault 3'),
], ids=['odd-H-mha', 'odd-H-gqa', 'groups-3', 'groups-3-wide',
        'causal-T>S', 'ragged-T', 'ragged-S'])
def test_reference_faults_raise(h, hkv, t, s, causal, blocks, match):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, h, hkv, t, s))
    with pytest.raises(ValueError, match=match):
        tpacked.packed_flash_attention_fwd(q, k, v, causal=causal,
                                           block_q=blocks[0],
                                           block_k=blocks[1])


def test_blocks_clamp_to_the_lengths():
    """block sizes are min(block, length), as the reference sizes them:
    the default 512 blocks take T = S = 64."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 64, 64))
    out, lse = tpacked.packed_flash_attention_fwd(q, k, v)
    assert out.shape == q.shape and bool(torch.isfinite(lse).all())


def test_bench_main_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the bench would run')
    with pytest.raises(device_lib.DeviceError):
        tpacked.bench_main()
    with pytest.raises(device_lib.DeviceError):
        tpacked.bench_main(device='cpu')
