"""Parity of the port's training path with the JAX package on the CPU:
``llama.forward``/``loss_fn`` and their gradients (skypilot_torch/
models/llama.py), LoRA (parallel/lora.py), the one-device train step
(parallel/train.py) and the TrainState bridge (models/convert.py).

JAX's weights are carried across with ``convert``; tokens and adapters
are made with numpy from a seed. The JAX side runs its CPU path (XLA
attention with RoPE applied outside), the port its plain flash
versions. Tolerances, each from the arithmetic that differs:

- loss and gradients in f32: summation order only, ~1e-6 relative to
  the largest entry of each leaf; held at 2e-5;
- three train steps in f32: losses and grad norms to rtol 1e-5; params
  to atol 1e-4, a third of one step's update (lr 3e-4), because Adam's
  mu / sqrt(nu) turns f32-rounding differences of near-zero gradients
  into visible update differences;
- bf16 LoRA params: the per-step update is below one bf16 ulp of most
  A entries, so the rounding decides, and a gradient within bf16
  rounding of zero can flip sign, turning Adam's ~lr-sized step the
  other way; params to two bf16 ulps (rtol 2^-7) plus two steps' size
  (atol 6e-4), losses to rtol 1e-4, grad norms (bf16, as optax computes
  them) to one bf16 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import lora as jlora
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import train as jtrain
from skypilot_torch.models import convert
from skypilot_torch.models import llama as tllama
from skypilot_torch.parallel import lora as tlora
from skypilot_torch.parallel import train as ttrain

GRAD_REL_TOL = 2e-5
_SHRINK = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4,
               n_kv_heads=2, ffn_hidden=256, max_seq_len=512)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


def _configs(name, **kw):
    if name == 'tiny':
        return jllama.get_config(name, **kw), tllama.get_config(name, **kw)
    kw = dict(_SHRINK, **kw)
    return (jllama.get_config(name, dtype=jnp.float32, **kw),
            tllama.get_config(name, dtype=torch.float32, **kw))


def _lora_np(rng, config, rank=8):
    """Adapters with a non-zero B, so every factor gets a gradient."""
    L, d = config.n_layers, config.dim
    q_out = config.n_heads * config.head_dim
    v_out = config.n_kv_heads * config.head_dim
    return {
        'wq_a': rng.standard_normal((L, d, rank)) / np.sqrt(d),
        'wq_b': rng.standard_normal((L, rank, q_out)) * 0.05,
        'wv_a': rng.standard_normal((L, d, rank)) / np.sqrt(d),
        'wv_b': rng.standard_normal((L, rank, v_out)) * 0.05,
    }


def _assert_tree_close(got, want, rel_tol):
    """Per leaf: max |err| <= rel_tol * max |ref|."""
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(ttrain._leaves(got))
    for path, ref in flat:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        leaf = leaf.detach().float().numpy() if torch.is_tensor(
            leaf) else leaf
        err = np.abs(leaf - ref).max()
        assert err <= rel_tol * np.abs(ref).max(), (path, err)


@pytest.mark.parametrize('name,lora,remat,masked', [
    ('tiny', False, False, False),
    ('tiny', False, True, False),
    ('tiny', True, False, False),
    ('tiny', True, True, True),
    ('qwen2.5-1.5b', False, False, True),  # qkv biases, tied head
    # norm offset, tied head, scaled embeddings, gelu_tanh, head_dim 256
    ('gemma-2b', True, True, False),
])
def test_loss_and_grads_match_jax(name, lora, remat, masked):
    jcfg, tcfg = _configs(name, remat=remat)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 65)).astype(np.int32)
    batch_np = {'tokens': tokens}
    if masked:
        batch_np['loss_mask'] = (rng.random((2, 65)) > 0.3).astype(
            np.int32)
    jbatch = jax.tree.map(jnp.asarray, batch_np)
    tbatch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    tp = convert.params_from_numpy(_np(jp), tcfg, device='cpu')
    if lora:
        lo = _lora_np(rng, jcfg)
        jloss, jgrads = jax.value_and_grad(
            lambda a: jllama.loss_fn(jp, jbatch, jcfg, lora=a,
                                     lora_scale=2.0))(
            jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), lo))
        trainable = convert.tree_from_numpy(lo, torch.float32, 'cpu')
        for x in trainable.values():
            x.requires_grad_(True)
        tloss = tllama.loss_fn(tp, tbatch, tcfg, lora=trainable,
                               lora_scale=2.0)
    else:
        jloss, jgrads = jax.value_and_grad(
            lambda p: jllama.loss_fn(p, jbatch, jcfg))(jp)
        trainable = tp
        for _, x in ttrain._leaves(tp):
            x.requires_grad_(True)
        tloss = tllama.loss_fn(tp, tbatch, tcfg)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    grads = ttrain._tree((p, x.grad) for p, x in ttrain._leaves(trainable))
    _assert_tree_close(grads, _np(jgrads), GRAD_REL_TOL)


def test_forward_logits_match_jax():
    jcfg, tcfg = _configs('tiny')
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    tokens = np.random.default_rng(6).integers(0, 512, (2, 40)).astype(
        np.int32)
    ref = jllama.forward(jp, jnp.asarray(tokens), jcfg)
    out = tllama.forward(convert.params_from_numpy(_np(jp), tcfg, 'cpu'),
                         torch.from_numpy(tokens), tcfg)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


_STEP_CASES = {
    'lora-bf16': (8, jnp.bfloat16, torch.bfloat16),
    'lora-f32': (8, jnp.float32, torch.float32),
    'full-f32': (None, jnp.float32, torch.float32),
}


@pytest.mark.parametrize('case', sorted(_STEP_CASES))
def test_train_step_matches_jax(case):
    """Three steps of the port's build_train_step against the JAX step
    on a 1-device CPU mesh, from the same converted state and batches:
    losses, grad norms and the trained params after step 3."""
    rank, jdt, tdt = _STEP_CASES[case]
    jcfg, tcfg = _configs('tiny')
    mesh = jmesh.make_mesh(jmesh.MeshConfig(), devices=jax.devices()[:1])
    jstate, shardings = jtrain.init_train_state(
        jcfg, mesh, jax.random.PRNGKey(0), param_dtype=jdt, lora_rank=rank)
    jstep = jtrain.build_train_step(jcfg, mesh, shardings, donate=False)
    tstate = convert.train_state_from_numpy(
        _np(jstate.params), None if rank is None else _np(jstate.lora),
        tdt, device='cpu')
    tstep = ttrain.build_train_step(tcfg)
    bf16 = tdt == torch.bfloat16
    rng = np.random.default_rng(7)
    for _ in range(3):
        tokens = rng.integers(0, 512, (2, 65)).astype(np.int32)
        jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {'tokens': torch.from_numpy(tokens)})
        np.testing.assert_allclose(tm['loss'].item(), float(jm['loss']),
                                   rtol=1e-4 if bf16 else 1e-5)
        np.testing.assert_allclose(tm['grad_norm'].float().item(),
                                   float(jm['grad_norm']),
                                   rtol=2 ** -8 if bf16 else 1e-5)
    assert tstate.step == 3 and tstate.opt_state.count == 3
    got = convert.train_state_to_numpy(tstate)
    key = 'params' if rank is None else 'lora'
    want = _np(jstate.params if rank is None else jstate.lora)
    for path, ref in jax.tree_util.tree_leaves_with_path(want):
        leaf = got[key]
        for k in path:
            leaf = leaf[k.key]
        if bf16:
            np.testing.assert_allclose(leaf, ref, rtol=2 ** -7, atol=6e-4)
        else:
            np.testing.assert_allclose(leaf, ref, rtol=0, atol=1e-4)
    if rank is not None:
        # The frozen base never moves.
        for (_, a), (_, b) in zip(ttrain._leaves(got['params']),
                                  ttrain._leaves(_np(jstate.params))):
            np.testing.assert_array_equal(a, b)


def test_optimizer_state_dtypes_follow_optax():
    """mu is f32 and nu takes the param dtype, as optax.adamw(mu_dtype=
    f32) keeps them; the moments mirror the trainable tree."""
    _, tcfg = _configs('tiny')
    state = ttrain.init_train_state(tcfg, seed=0,
                                    param_dtype=torch.bfloat16, lora_rank=4,
                                    device='cpu')
    assert set(state.opt_state.mu) == set(state.lora)
    for name, x in state.lora.items():
        assert x.dtype == torch.bfloat16
        assert state.opt_state.mu[name].dtype == torch.float32
        assert state.opt_state.nu[name].dtype == torch.bfloat16
        assert not bool(state.opt_state.mu[name].any())


def test_clip_applies_above_the_limit_only():
    opt = ttrain.default_optimizer(learning_rate=1.0, weight_decay=0.0)
    p = {'w': torch.zeros(4)}
    for scale, clipped in ((0.1, False), (10.0, True)):
        g = {'w': torch.full((4,), scale)}
        norm = ttrain.global_norm([g['w']])
        np.testing.assert_allclose(norm.item(), 2 * scale, rtol=1e-6)
        _, state = opt.update(g, opt.init(p), p, norm)
        # First Adam step: mu = (1 - b1) * g_clipped.
        want = (1 - opt.b1) * (scale / norm.item() if clipped else scale)
        np.testing.assert_allclose(state.mu['w'].numpy(), want, rtol=1e-6)


def test_init_lora_shapes_and_zero_b():
    _, tcfg = _configs('tiny')
    jcfg = jllama.get_config('tiny')
    lo = tlora.init_lora(tcfg, seed=1, rank=4, device='cpu')
    ref = jlora.init_lora(jcfg, jax.random.PRNGKey(1), rank=4)
    assert {k: tuple(v.shape) for k, v in lo.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert not bool(lo['wq_b'].any()) and not bool(lo['wv_b'].any())
    std = lo['wq_a'].std().item() * np.sqrt(tcfg.dim)
    assert abs(std - 1) < 0.1
    again = tlora.init_lora(tcfg, seed=1, rank=4, device='cpu')
    assert torch.equal(lo['wq_a'], again['wq_a'])


def test_merge_lora_matches_jax():
    jcfg, tcfg = _configs('tiny')
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(8))
    lo = _lora_np(np.random.default_rng(9), jcfg, rank=4)
    ref = jlora.merge_lora(jp, jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32), lo), scale=2.0)
    got = tlora.merge_lora(convert.params_from_numpy(_np(jp), tcfg, 'cpu'),
                           convert.tree_from_numpy(lo, torch.float32,
                                                   'cpu'), scale=2.0)
    host = tlora.merge_lora_host(_np(jp), lo, scale=2.0)
    for w in ('wq', 'wv', 'wk'):
        np.testing.assert_allclose(got['layers'][w].numpy(),
                                   np.asarray(ref['layers'][w]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(host['layers'][w],
                                   np.asarray(ref['layers'][w]),
                                   rtol=1e-5, atol=1e-6)


def test_train_state_bridge_round_trip():
    jcfg, _ = _configs('tiny')
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(10),
                            dtype=jnp.bfloat16)
    lo = jlora.init_lora(jcfg, jax.random.PRNGKey(11), rank=4,
                         dtype=jnp.bfloat16)
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, lo),
        torch.bfloat16, device='cpu')
    assert state.lora['wq_a'].dtype == torch.bfloat16
    assert state.opt_state.count == 0 and set(state.opt_state.nu) == set(lo)
    back = convert.train_state_to_numpy(state)
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np(lo)):
        np.testing.assert_array_equal(back['lora'][path[0].key], leaf)
    np.testing.assert_array_equal(back['params']['embed'],
                                  _np(jp)['embed'])


def test_unported_remat_saves_and_moe_raise():
    _, tcfg = _configs('tiny')
    tokens = {'tokens': torch.zeros((1, 9), dtype=torch.long)}
    params = tllama.init_params(tcfg, device='cpu')
    mlp_saves = dataclasses.replace(tcfg, remat=True, remat_saves='attn+mlp')
    with pytest.raises(NotImplementedError, match='remat_saves'):
        tllama.loss_fn(params, tokens, mlp_saves)
    with pytest.raises(NotImplementedError, match='MoE'):
        tllama.loss_fn(params, tokens, tllama.get_config('tiny-moe'))
