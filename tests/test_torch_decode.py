"""Parity of skypilot_torch/models/decode.py with the JAX package on
the CPU. The same weights (JAX's init, carried across as numpy) and
the same prompts go through both sides' ``forward_cached`` (prefill,
one decode step, and a multi-token chunk over the masked path) and
``greedy_generate``. f32 throughout under the conftest's 'highest'
matmul precision; logits agree to 1e-4 absolute (two layers of f32
matmuls summed in different orders, logits of magnitude ~5), and
greedy tokens must be exactly equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_torch.models import convert
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
_SHRINK = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4,
               n_kv_heads=2, ffn_hidden=256, max_seq_len=512,
               remat=False)


def _models(name):
    """JAX and port params holding the same weights (random q/k/v
    biases where the config has them: JAX inits them to zero)."""
    kw = {} if name == 'tiny' else dict(_SHRINK)
    jcfg = jllama.get_config(name, dtype=jnp.float32, **kw)
    tcfg = tllama.get_config(name, dtype=torch.float32, **kw)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for b in ('bq', 'bk', 'bv'):
        if b in tree['layers']:
            tree['layers'][b] = (0.1 * rng.standard_normal(
                tree['layers'][b].shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_numpy(tree, tcfg, device='cpu')
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize('name', ['tiny', 'qwen2.5-1.5b', 'llama3.2-1b'])
def test_forward_cached_logits_match(name):
    jcfg, tcfg, jp, tp = _models(name)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    step = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    chunk = rng.integers(0, jcfg.vocab_size, (2, 3)).astype(np.int32)
    max_seq = 64

    jc = jdecode.init_cache(jcfg, 2, max_seq)
    tc = tdecode.init_cache(tcfg, 2, max_seq, device='cpu')
    for tokens, kw in ((prompt, dict(prefill=True)), (step, {}),
                       (chunk, {})):
        jl, jc = jdecode.forward_cached(jp, jnp.asarray(tokens), jc, jcfg,
                                        prefill=kw.get('prefill', False))
        tl, tc = tdecode.forward_cached(tp, torch.from_numpy(tokens).long(),
                                        tc, tcfg, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc.pos == int(jc.pos) == 24 + 1 + 3
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('kv_int8', [False, True], ids=['f32', 'int8'])
def test_forward_cached_writes_through_rope_cache_write(monkeypatch,
                                                       kv_int8):
    """The prompt, a decode step and a later chunk each write their rows
    with one ``rope_cache_write`` a layer (K5F on the card), no
    ``cache_write``."""
    from skypilot_torch.ops import decode_attention as tda
    _, tcfg, _, tp = _models('tiny')
    calls = {'rope_cache_write': 0, 'cache_write': 0}
    for name in calls:
        real = getattr(tda, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tda, name, counted)
    cache = tdecode.init_cache(tcfg, 2, 32, device='cpu', kv_int8=kv_int8)
    for n, (t, kw) in enumerate(((7, dict(prefill=True)), (1, {}),
                                 (3, {})), 1):
        tdecode.forward_cached(tp, torch.ones((2, t), dtype=torch.long),
                               cache, tcfg, **kw)
        assert calls == {'rope_cache_write': n * tcfg.n_layers,
                         'cache_write': 0}
    assert cache.pos == 11


def test_forward_cached_last_only():
    jcfg, tcfg, jp, tp = _models('tiny')
    prompt = np.arange(10, dtype=np.int32)[None] * 7
    tc = tdecode.init_cache(tcfg, 1, 32, device='cpu')
    full, _ = tdecode.forward_cached(tp, torch.from_numpy(prompt).long(),
                                     tc, tcfg, prefill=True)
    tc = tdecode.init_cache(tcfg, 1, 32, device='cpu')
    last, tc = tdecode.forward_cached(tp, torch.from_numpy(prompt).long(),
                                      tc, tcfg, last_only=True,
                                      prefill=True)
    assert last.shape == (1, 1, tcfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), full[:, -1:].numpy(),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match='empty cache'):
        tdecode.forward_cached(tp, torch.zeros((1, 2), dtype=torch.long),
                               tc, tcfg, prefill=True)


@pytest.fixture(scope='module')
def tiny_greedy():
    jcfg, tcfg, jp, tp = _models('tiny')
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    ref = np.asarray(jdecode.greedy_generate(jp, jnp.asarray(prompt), jcfg,
                                             16, max_seq=64))
    return jcfg, tcfg, jp, tp, prompt, ref


def test_greedy_tokens_exactly_equal(tiny_greedy):
    _, tcfg, _, tp, prompt, ref = tiny_greedy
    out = tdecode.greedy_generate(tp, torch.from_numpy(prompt).long(),
                                  tcfg, 16, max_seq=64)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_greedy_tokens_exactly_equal_with_eos(tiny_greedy):
    jcfg, tcfg, jp, tp, prompt, ref = tiny_greedy
    eos = int(ref[0, 3])  # row 0 stops early; rows pad with eos after
    jout = np.asarray(jdecode.greedy_generate(jp, jnp.asarray(prompt), jcfg,
                                              16, max_seq=64, eos_id=eos))
    tout = tdecode.greedy_generate(tp, torch.from_numpy(prompt).long(),
                                   tcfg, 16, max_seq=64, eos_id=eos)
    np.testing.assert_array_equal(tout.numpy(), jout)
    assert (tout[0, 3:] == eos).all()


def test_greedy_edge_cases():
    _, tcfg, _, tp = _models('tiny')
    prompt = torch.ones((1, 4), dtype=torch.long)
    assert tdecode.greedy_generate(tp, prompt, tcfg, 0).shape == (1, 0)
    with pytest.raises(ValueError, match='max_seq'):
        tdecode.greedy_generate(tp, prompt, tcfg, 10, max_seq=8)
