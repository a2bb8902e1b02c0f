"""The port's int8 weights (skypilot_torch/models/quant.py, the int8
forms of ``llama.matmul``/``output_head`` and the weight bridge) against
the JAX package's ``models/quant.py`` on the CPU, on the same numpy
weights.

Codes and scales must be bit-equal (the same f32 amax, bf16-rounded
scale and round-half-to-even). Logits of a quantized ``tiny`` in f32
agree to 1e-4 absolute (the same two f32 layers summed in other
orders, logits of magnitude ~5), and greedy tokens must be equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import quant as jquant
from skypilot_torch.models import convert
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.models import quant as tquant

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
_QWEN = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_hidden=256, max_seq_len=512, remat=False)


def _np(tree):
    """A JAX tree as numpy: int8 codes stay int8, the rest f32."""
    return jax.tree.map(
        lambda x: np.asarray(x) if x.dtype == jnp.int8
        else np.asarray(x.astype(jnp.float32)), tree)


def _bits(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize('shape', [(64, 48), (3, 96, 40)],
                         ids=['matrix', 'stacked'])
@pytest.mark.parametrize('dtype', ['bf16', 'f32'])
def test_quantize_weight_bit_equal_to_jax(shape, dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) *
         rng.uniform(0.01, 3.0, shape[-1])).astype(np.float32)
    w[..., 0, 3] = 0.0
    w[..., :, 5] = 0.0                         # an all-zero channel
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == 'bf16'
                else (jnp.float32, torch.float32))
    jw = jnp.asarray(w).astype(jdt)
    want = jquant.quantize_weight(jw)
    got = tquant.quantize_weight(torch.from_numpy(w).to(tdt))
    assert got['q'].dtype == torch.int8 and got['s'].dtype == torch.bfloat16
    assert tuple(got['s'].shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(got['q'].numpy(), np.asarray(want['q']))
    np.testing.assert_array_equal(_bits(got['s']), _bits(want['s']))


def _jax_params(name):
    if name == 'tiny':
        jcfg = jllama.get_config('tiny', dtype=jnp.float32)
        tcfg = tllama.get_config('tiny', dtype=torch.float32)
    else:
        jcfg = jllama.get_config(name, dtype=jnp.float32, **_QWEN)
        tcfg = tllama.get_config(name, dtype=torch.float32, **_QWEN)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, tree


@pytest.mark.parametrize('name', ['tiny', 'qwen2.5-1.5b'],
                         ids=['untied', 'tied-head'])
def test_quantize_params_tree_matches_jax(name):
    """Same structure as the JAX tree, every code and scale bit-equal;
    the tied head (the embedding) stays wide, as do norms and biases."""
    jcfg, tcfg, tree = _jax_params(name)
    want = _np(jquant.quantize_params(jax.tree.map(jnp.asarray, tree),
                                      jcfg))
    tp = convert.params_from_numpy(tree, tcfg, device='cpu')
    got = tquant.quantize_params(tp, tcfg)
    assert tquant.is_quantized(got) and not tquant.is_quantized(tp)
    got_np = convert.params_to_numpy(got)
    assert (jax.tree_util.tree_structure(got_np) ==
            jax.tree_util.tree_structure(want))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g = got_np
        for k in path:
            g = g[k.key]
        assert g.dtype == leaf.dtype, path
        np.testing.assert_array_equal(g, leaf)
    assert ('lm_head' in got) == (not tcfg.tie_embeddings)
    for name_ in ('bq', 'attn_norm'):
        if name_ in got['layers']:
            assert not isinstance(got['layers'][name_], dict)
    assert got['embed'] is tp['embed']


def test_init_quantized_is_quantize_of_init_params():
    """init_quantized draws init_params's weights (same generator, same
    order) and quantizes each layer slice as it is drawn."""
    cfg = tllama.get_config('tiny')
    got = tquant.init_quantized(cfg, seed=3, device='cpu')
    want = tquant.quantize_params(
        tllama.init_params(cfg, seed=3, dtype=torch.bfloat16,
                           device='cpu'), cfg)
    for (pg, g), (pw, w) in zip(_flat(got), _flat(want)):
        assert pg == pw and g.dtype == w.dtype
        assert torch.equal(g, w), pg
    assert got['embed'].dtype == torch.bfloat16


def _flat(tree, prefix=()):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _flat(tree[k], prefix + (k,))
        else:
            out.append((prefix + (k,), tree[k]))
    return out


def test_quantize_params_streamed_equals_quantize_params():
    cfg = tllama.get_config('tiny')
    host = tllama.init_params(cfg, seed=1, dtype=torch.bfloat16,
                              device='cpu')
    got = tquant.quantize_params_streamed(host, cfg, device='cpu')
    want = tquant.quantize_params(host, cfg)
    for (pg, g), (pw, w) in zip(_flat(got), _flat(want)):
        assert pg == pw
        if g.dtype == torch.int8 or pg[-1] == 's':
            assert torch.equal(g, w), pg
        else:
            assert g.dtype == cfg.dtype and torch.equal(g, w.to(cfg.dtype))


def test_convert_round_trips_int8_pairs():
    cfg = tllama.get_config('tiny')
    q = tquant.init_quantized(cfg, seed=2, device='cpu')
    back = convert.params_from_numpy(convert.params_to_numpy(q), cfg,
                                     device='cpu')
    assert back['layers']['wq']['q'].dtype == torch.int8
    assert back['layers']['wq']['s'].dtype == torch.bfloat16
    for (pg, g), (_, w) in zip(_flat(back), _flat(q)):
        assert torch.equal(g.to(w.dtype), w), pg
    with pytest.raises(TypeError, match='int8 codes'):
        convert.params_from_numpy(
            {'w': {'q': np.ones(3, np.float32), 's': np.ones(1)}}, cfg,
            device='cpu')


@pytest.fixture(scope='module')
def quantized_tiny():
    jcfg, tcfg, tree = _jax_params('tiny')
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), jcfg)
    tq = convert.params_from_numpy(_np(jq), tcfg, device='cpu')
    return jcfg, tcfg, jq, tq


def test_quantized_logits_match_jax(quantized_tiny):
    jcfg, tcfg, jq, tq = quantized_tiny
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    want = np.asarray(jllama.forward(jq, jnp.asarray(tokens), jcfg))
    got = tllama.forward(tq, torch.from_numpy(tokens).long(), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)
    # The same through the cached path (prefill, then one step).
    jc = jdecode.init_cache(jcfg, 2, 32)
    tc = tdecode.init_cache(tcfg, 2, 32, device='cpu')
    jl, _ = jdecode.forward_cached(jq, jnp.asarray(tokens), jc, jcfg,
                                   prefill=True)
    tl, _ = tdecode.forward_cached(tq, torch.from_numpy(tokens).long(), tc,
                                   tcfg, prefill=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_quantized_greedy_tokens_equal_jax(quantized_tiny):
    jcfg, tcfg, jq, tq = quantized_tiny
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    want = np.asarray(jdecode.greedy_generate(jq, jnp.asarray(prompt), jcfg,
                                              12, max_seq=48))
    got = tdecode.greedy_generate(tq, torch.from_numpy(prompt).long(), tcfg,
                                  12, max_seq=48)
    np.testing.assert_array_equal(got.numpy(), want)


def test_matmul_applies_the_scale_after_the_product():
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    qw = tquant.quantize_weight(w)
    want = (x @ qw['q'].float()) * qw['s'].float()
    assert torch.equal(tllama.matmul(x, qw), want)
    assert tquant.matmul is tllama.matmul


def test_expert_einsum_names_the_moe_slice():
    with pytest.raises(NotImplementedError, match='MoE slice'):
        tquant.expert_einsum('ed,edo->eo', torch.ones(1), {})
