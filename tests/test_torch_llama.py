"""Parity of skypilot_torch/models/llama.py and models/convert.py with
the JAX package on the CPU: the config table field for field, the
norm/RoPE/activation helpers, the output head, the params layout, and
the numpy weight bridge. Inputs from a numpy seed, f32. Elementwise
helpers agree to a few f32 ulps (rtol 1e-6); RoPE angles reach a few
hundred radians, where one ulp of a frequency is ~1e-5 absolute.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skypilot_tpu.models import llama as jllama
from skypilot_torch.models import convert
from skypilot_torch.models import llama as tllama

_DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
_SHRINK = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4,
               n_kv_heads=2, ffn_hidden=256, max_seq_len=512)


def shrunk(name, **extra):
    """The same shrunk variant of a named config on both sides (f32)."""
    kw = dict(_SHRINK, **extra)
    return (jllama.get_config(name, dtype=jnp.float32, **kw),
            tllama.get_config(name, dtype=torch.float32, **kw))


@pytest.mark.parametrize('name', sorted(jllama.CONFIGS))
def test_config_fields_match(name):
    j = dataclasses.asdict(jllama.CONFIGS[name])
    t = dataclasses.asdict(tllama.CONFIGS[name])
    assert set(j) == set(t)
    for field, value in j.items():
        if field == 'dtype':
            assert t[field] == _DTYPES[value], name
        else:
            assert t[field] == value, (name, field)
    assert tllama.CONFIGS[name].head_dim == jllama.CONFIGS[name].head_dim
    assert (tllama.CONFIGS[name].num_params() ==
            jllama.CONFIGS[name].num_params())


@pytest.mark.parametrize('offset', [False, True])
def test_rms_norm_matches(offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    ref = jllama._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    out = tllama._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                           offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('name', ['tiny', 'llama3.2-1b'])
def test_rope_frequencies_match(name):
    """tiny: plain RoPE; llama3.2-1b: the Llama-3.1 scaling branch."""
    jcfg, tcfg = shrunk(name)
    assert jcfg.rope_scaling == (name == 'llama3.2-1b')
    pos = np.arange(0, 512)
    ref = jllama._rope_frequencies(jcfg, jnp.asarray(pos))
    out = tllama._rope_frequencies(tcfg, torch.from_numpy(pos))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize('act', ['silu', 'gelu_tanh'])
def test_mlp_act_matches(act):
    jcfg, tcfg = shrunk('tiny', mlp_activation=act)
    x = np.random.default_rng(2).standard_normal((3, 50)).astype(
        np.float32) * 4
    ref = jllama.mlp_act(jcfg)(jnp.asarray(x))
    out = tllama.mlp_act(tcfg)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('name', ['tiny', 'qwen2.5-1.5b'])
def test_params_layout_and_output_head(name):
    """Same keys and shapes from both inits; the output head (tied to
    the embedding for qwen2.5-1.5b) carried across equals JAX's."""
    jcfg, tcfg = shrunk(name)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tllama.init_params(tcfg, seed=0, device='cpu')
    j_shapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    t_shapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                    if isinstance(v, dict) else tuple(v.shape))
                for k, v in tp.items()}
    assert t_shapes == j_shapes
    carried = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                        tcfg, device='cpu')
    head = tllama.output_head(carried, tcfg)
    np.testing.assert_array_equal(
        head.numpy(), np.asarray(jllama.output_head(jp, jcfg)))
    assert ('lm_head' in tp) == (not tcfg.tie_embeddings)


def test_init_scale_and_norms():
    _, tcfg = shrunk('tiny')
    tp = tllama.init_params(tcfg, seed=0, device='cpu')
    # normal / sqrt(fan_in): std of w_down is 1/sqrt(ffn).
    std = tp['layers']['w_down'].std().item()
    assert abs(std * np.sqrt(tcfg.ffn_hidden) - 1) < 0.02
    assert bool((tp['layers']['attn_norm'] == 1).all())
    _, gcfg = shrunk('gemma-2b', head_dim_override=32)
    assert bool((tllama.init_params(gcfg, device='cpu')['final_norm']
                 == 0).all())
    assert torch.equal(tllama.init_params(tcfg, seed=3, device='cpu')['embed'],
                       tllama.init_params(tcfg, seed=3, device='cpu')['embed'])


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16])
def test_numpy_bridge_round_trip(dtype):
    name = 'qwen2.5-1.5b'  # qkv biases and a tied head
    jcfg = jllama.get_config(name, dtype=dtype, **_SHRINK)
    tcfg = tllama.get_config(name, dtype=_DTYPES[dtype], **_SHRINK)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, jp)
    tp = convert.params_from_numpy(tree, tcfg, device='cpu')
    assert tp['layers']['wq'].dtype == _DTYPES[dtype]
    back = convert.params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat_j:
        got = back
        for key in path:
            got = got[key.key]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, leaf.astype(np.float32))


def test_moe_config_raises(tmp_path):
    """MoE configs are ported: ``init_params('tiny-moe')`` gives the JAX
    layout, leaf for leaf (``router [L, D, E]``, expert stacks ``[L, E,
    in, out]``), in shape and dtype (f32 and bf16). No refusal is left
    for a MoE config: over a one-rank layout (a gloo group of one) the
    forward equals the unsharded one, its aux too."""
    for dtype in (jnp.float32, jnp.bfloat16):
        jcfg = jllama.get_config('tiny-moe', dtype=dtype)
        tcfg = tllama.get_config('tiny-moe', dtype=_DTYPES[dtype])
        want = jax.eval_shape(lambda: jllama.init_params(
            jcfg, jax.random.PRNGKey(0)))
        got = tllama.init_params(tcfg, device='cpu')
        flat = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat) == len(jax.tree_util.tree_leaves(
            jax.tree.map(lambda x: 0, got)))
        for path, leaf in flat:
            node = got
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert leaf.dtype == dtype, path
            assert node.dtype == _DTYPES[dtype], path
        assert got['layers']['router'].shape == (2, 128, 4)
        assert got['layers']['w_down'].shape == (2, 4, 256, 128)
    import torch.distributed as dist

    from skypilot_torch.parallel import mesh as tmesh
    from skypilot_torch.parallel import train as ttrain
    cfg = tllama.get_config('tiny-moe')
    params = tllama.init_params(cfg, seed=2, device='cpu')
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)))
    want, want_aux = tllama.forward_hidden(params, tokens, cfg,
                                           with_aux=True)
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/store',
                            rank=0, world_size=1)
    try:
        layout = ttrain._layout(cfg, tmesh.make_mesh(tmesh.MeshConfig()),
                                False)
        got, aux = tllama.forward_hidden(params, tokens, cfg, with_aux=True,
                                         layout=layout)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


def test_int8_weights_raise():
    """A {q, s} weight whose codes are not int8 is refused (int8 pairs
    themselves are ported: tests/test_torch_quant.py)."""
    with pytest.raises(TypeError, match='int8'):
        tllama.matmul(torch.ones(2, 2), {'q': None, 's': None})
    with pytest.raises(TypeError, match='int8'):
        tllama.matmul(torch.ones(2, 2), {'q': torch.ones(2, 2),
                                         's': torch.ones(1, 2)})
