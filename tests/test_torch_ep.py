"""Expert parallelism (``ep``; skypilot_torch/parallel/sharding.py's
all-to-all and the expert axis kept local, models/llama.py's ``_moe_mlp``
over a layout with the aux loss's global means, parallel/train.py) on
gloo ranks at ``tiny-moe``, against the JAX package's sharded step on the
same mesh shape over ``jax.devices()[:n]`` and against the port's
one-process step, and the sharded checkpoints across ep shapes.

Two process groups (``_torch_dist.run``): 2 ranks at ``ep=2`` (the LoRA,
full and QLoRA steps and the LoRA step with per-layer checkpointing,
each saved; the aux loss of a forward; a whole save restored onto the
ranks) and 4 ranks at ``fsdp=2 x ep=2`` and ``ep=2 x tp=2`` (LoRA and
full, and at ``ep=2 x tp=2`` the LoRA step under remat, as
``tests/test_moe.py`` holds JAX's ``fsdp 2 x ep 2 x tp 2`` step to its
``fsdp 8`` step). 2 steps a case, an uneven ``loss_mask``
but for QLoRA; the full steps at capacity factor 1.0, so tokens drop.
Tolerances are ``test_torch_tp.py``'s: losses and grad norms to rtol
1e-5 and params to atol 1e-4 in f32; the QLoRA adapters (bf16) to rtol
2^-7 + atol 6e-4, losses to rtol 1e-4 and grad norms to one bf16 ulp of
the reference; the aux of a forward to rtol 1e-5 (f32 sums in another
order).

Run alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ep.py
-q``."""
import dataclasses
import functools
import json
import os

import _torch_dist
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import train as jtrain
from skypilot_torch import checkpoint as tcheckpoint
from skypilot_torch.models import convert
from skypilot_torch.models import llama as tllama
from skypilot_torch.parallel import mesh as tmesh
from skypilot_torch.parallel import train as ttrain

MODEL = 'tiny-moe'
STEPS = 2
BATCH, T = 4, 33
DROPS = dict(moe_capacity_factor=1.0)
# name -> (kind, config overrides) for each mesh.
CASES = {
    'ep2': {'lora': ('lora', {}), 'full': ('full', DROPS),
            'qlora': ('qlora', {}), 'lora_remat': ('lora', {})},
    'fsdp2_ep2': {'lora': ('lora', {}), 'full': ('full', DROPS)},
    'ep2_tp2': {'lora': ('lora', {}), 'full': ('full', DROPS),
                'lora_remat': ('lora', {})},
}
MESHES = {'ep2': dict(ep=2), 'fsdp2_ep2': dict(fsdp=2, ep=2),
          'ep2_tp2': dict(ep=2, tp=2)}
GROUPS = {'ep2': ('ep2',), 'four': ('fsdp2_ep2', 'ep2_tp2')}
PARAMETRIZED = [(m, c) for m in sorted(CASES) for c in sorted(CASES[m])]


def _np(tree):
    """f32 numpy leaves; int8 codes stay int8."""
    return jax.tree.map(lambda x: np.asarray(
        x if x.dtype == jnp.int8 else x.astype(jnp.float32)), tree)


def _jax_case(mesh_kw, kind, cfg_kw, seed):
    """(JAX mesh, config, state, shardings, numpy state, batches)."""
    cfg = jllama.get_config(MODEL, **cfg_kw)
    n = tmesh.MeshConfig(**mesh_kw).num_devices
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**mesh_kw),
                           devices=jax.devices()[:n])
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(seed)
    if kind == 'qlora':
        state, shardings = jtrain.init_qlora_state(cfg, mesh, key,
                                                   lora_rank=4)
        dtype, tdt = jnp.bfloat16, torch.bfloat16
    else:
        state, shardings = jtrain.init_train_state(
            cfg, mesh, key, lora_rank=None if kind == 'full' else 4)
        dtype, tdt = jnp.float32, torch.float32
    if state.lora is not None:
        # A non-zero B, so every factor has a gradient from step 1.
        lora = {k: (rng.standard_normal(v.shape) *
                    (0.05 if k.endswith('_b') else 1 / np.sqrt(128)))
                for k, v in state.lora.items()}
        state = dataclasses.replace(state, lora=jax.device_put(
            jax.tree.map(lambda x: jnp.asarray(x, dtype), lora),
            shardings.lora))
    batches = []
    for _ in range(STEPS):
        batch = {'tokens': rng.integers(0, 512, (BATCH, T)).astype(
            np.int32)}
        if kind != 'qlora':
            keep = np.array([[0.1], [0.6], [0.9], [0.3]])
            batch['loss_mask'] = (rng.random((BATCH, T)) > keep).astype(
                np.int32)
        batches.append(batch)
    state_np = {'params': _np(state.params),
                'lora': None if state.lora is None else _np(state.lora),
                'dtype': tdt}
    return mesh, cfg, state, shardings, state_np, batches


def _reference(mesh_name, name):
    """JAX's steps and the port's one-process steps of one case, and the
    case as the ranks take it."""
    kind, cfg_kw = CASES[mesh_name][name]
    mesh, cfg, state, shardings, state_np, batches = _jax_case(
        MESHES[mesh_name], kind, cfg_kw, len(name) + len(mesh_name))
    step = jtrain.build_train_step(cfg, mesh, shardings, donate=False)
    jax_metrics = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        jax_metrics.append((float(m['loss']), float(m['grad_norm'])))
    whole = convert.train_state_from_numpy(
        state_np['params'], state_np['lora'], state_np['dtype'],
        device='cpu')
    tstep = ttrain.build_train_step(tllama.get_config(MODEL, **cfg_kw))
    metrics = []
    for b in batches:
        whole, m = tstep(whole, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
        metrics.append((m['loss'].item(), m['grad_norm'].float().item()))
    return ({'jax': {'metrics': jax_metrics,
                     'trainable': _np(state.lora if kind != 'full'
                                      else state.params),
                     'params': _np(state.params)},
             'one_proc': {'metrics': metrics,
                          'state': convert.train_state_to_numpy(whole)}},
            (name, state_np, batches, dict(cfg_kw, model=MODEL)))


def _aux_reference(seed):
    """(numpy params, global tokens, JAX's aux of a forward on them)."""
    cfg = jllama.get_config(MODEL)
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed).integers(
        0, 512, (BATCH, T - 1)).astype(np.int32)
    _, aux = jllama.forward_hidden(params, jnp.asarray(tokens), cfg,
                                   with_aux=True)
    return jax.tree.map(np.asarray, params), tokens, float(aux)


@functools.lru_cache(maxsize=None)
def _group(group, tmp):
    """The references of every case of the group's meshes, then one
    process group running them (and, for ep 2, the aux of a forward and
    a whole save restored onto the ranks)."""
    refs, calls = {}, []
    meshes = GROUPS[group]
    n = tmesh.MeshConfig(**MESHES[meshes[0]]).num_devices
    for mesh_name in meshes:
        cases = []
        for name in sorted(CASES[mesh_name]):
            refs[mesh_name, name], case = _reference(mesh_name, name)
            cases.append(case)
        calls.append((_torch_dist.train_steps, (
            MESHES[mesh_name], cases, os.path.join(tmp, 'saved', mesh_name))))
    params_np, tokens, aux = _aux_reference(11)
    calls += [(_torch_dist.moe_aux, (MESHES[m], params_np, tokens))
              for m in meshes]
    out = {'refs': refs, 'saved': os.path.join(tmp, 'saved'), 'aux': aux}
    restore_dir = os.path.join(tmp, 'restore')
    if group == 'ep2':
        whole_save(restore_dir)
        calls.append((_torch_dist.restore_blocks,
                      (MESHES['ep2'], 'lora', restore_dir, MODEL)))
        out['whole'] = restore_dir
    ranks = _torch_dist.run(n, os.path.join(tmp, 'store'), *calls)
    for i, mesh_name in enumerate(meshes):
        out[mesh_name] = [r[i] for r in ranks]
        out['aux', mesh_name] = [r[len(meshes) + i] for r in ranks]
    if group == 'ep2':
        out['restore'] = [r[-1] for r in ranks]
    return out


def whole_save(path):
    """A one-process tiny-moe LoRA state with every float leaf redrawn,
    saved whole at step 4."""
    whole = ttrain.init_train_state(tllama.get_config(MODEL), seed=3,
                                    lora_rank=4, device='cpu')
    rng = np.random.default_rng(1)

    def draw(_, x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return torch.from_numpy(rng.standard_normal(
                tuple(x.shape)).astype(np.float32)).to(x.dtype)
        return x
    tree = tcheckpoint.native._map_leaves(  # noqa: SLF001
        whole.checkpoint_tree(), draw)
    tcheckpoint.save_tree(path, 4,
                          ttrain.TrainState.from_checkpoint_tree(tree))


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    base = str(tmp_path_factory.mktemp('ep'))
    return lambda group: _group(group, os.path.join(base, group))


def _group_of(mesh_name):
    return next(g for g, meshes in GROUPS.items() if mesh_name in meshes)


def _assemble(ranks, key):
    """The whole leaf ``key`` from every rank's (window, block); blocks
    of one window (replicas) must be bit-equal."""
    parts = [r[key] for r in ranks]
    shape = [max(w[d][1] for w, _ in parts) for d in
             range(len(parts[0][0]))]
    out = np.zeros(shape, parts[0][1].dtype)
    seen = {}
    for win, data in parts:
        at = tuple(map(tuple, win))
        if at in seen:
            np.testing.assert_array_equal(data, seen[at])
        seen[at] = data
        out[tuple(slice(a, b) for a, b in win)] = data
    return out


def _leaves(tree, prefix):
    return {prefix + '/' + '/'.join(p): x
            for p, x in ttrain._leaves(tree)}  # noqa: SLF001


def _close(kind, got, want):
    if kind == 'qlora':
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=6e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _bf16_ulp(x):
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _metrics_close(kind, got, want):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-4 if kind == 'qlora'
                                   else 1e-5)
        if kind == 'qlora':  # a bf16 norm: to one ulp
            assert abs(gn - wn) <= _bf16_ulp(wn), (gn, wn)
        else:
            np.testing.assert_allclose(gn, wn, rtol=1e-5)


@pytest.mark.parametrize('mesh_name,name', PARAMETRIZED)
def test_ep_steps_match_jax_and_one_process(results, mesh_name, name):
    res = results(_group_of(mesh_name))
    kind = CASES[mesh_name][name][0]
    ref = res['refs'][mesh_name, name]
    ranks = [r[name] for r in res[mesh_name]]
    for r in ranks:  # every rank reports the global loss and norm
        assert r['metrics'] == ranks[0]['metrics']
    _metrics_close(kind, ranks[0]['metrics'], ref['jax']['metrics'])
    _metrics_close(kind, ranks[0]['metrics'], ref['one_proc']['metrics'])
    blocks = [r['blocks'] for r in ranks]
    top = 'params' if kind == 'full' else 'lora'
    one = _leaves(ref['one_proc']['state'][top], top)
    for key, want in _leaves(ref['jax']['trainable'], top).items():
        got = _assemble(blocks, key)
        _close(kind, got, want)
        _close(kind, got, one[key])
    if kind != 'full':
        # The frozen base never moves (int8 codes included).
        for key, want in _leaves(ref['jax']['params'], 'params').items():
            np.testing.assert_array_equal(
                _assemble(blocks, key).astype(np.float32), want)


# The collectives of one step at tiny-moe (L = 2 MoE layers), as
# (gathers, reduce_scatters, all_reduces, tp_reduces, all_to_alls):
# - gathers: a layer's dense leaves sharded over fsdp x ep (wq, wk, wv,
#   wo, router; QLoRA also wo's scale), the expert stacks over fsdp only
#   (their expert axis stays local), the adapters' A factors over fsdp;
#   + embed and head; twice a layer under remat;
# - reduce_scatters: those of the trainable leaves;
# - all_reduces: the token count, the loss, the aux statistics of each
#   layer forward and backward (and in a recompute), one per trainable
#   leaf (all are replicated over dp), one per group of shard axes in
#   the norm (the router's lacks tp);
# - tp_reduces: test_torch_tp.py's identity, plus one a layer backward
#   for the gates' *f* (the MoE layer's *f* and *g* take the dense
#   MLP's places);
# - all_to_alls: dispatch and combine a layer forward and backward, and
#   again in a recompute: 4 L, 6 L under remat.
L = 2
COLLECTIVES = {
    ('ep2', 'lora'): (5 * L + 2, 0, 2 + 2 * L + 4 + 1, 0, 4 * L),
    ('ep2', 'full'): (5 * L + 2, 5 * L + 2, 2 + 2 * L + 13 + 1, 0, 4 * L),
    ('ep2', 'qlora'): (6 * L + 2, 0, 2 + 2 * L + 4 + 1, 0, 4 * L),
    ('ep2', 'lora_remat'): (2 * 5 * L + 2, 0, 2 + 3 * L + 4 + 1, 0, 6 * L),
    ('fsdp2_ep2', 'lora'): ((5 + 3 + 2) * L + 2, 2 * L, 2 + 2 * L + 4 + 1,
                            0, 4 * L),
    ('fsdp2_ep2', 'full'): ((5 + 3) * L + 2, (5 + 3) * L + 2,
                            2 + 2 * L + 13 + 1, 0, 4 * L),
    ('ep2_tp2', 'lora'): (5 * L + 2, 0, 2 + 2 * L + 4 + 2,
                          1 + 2 * L + (3 * L - 1) + 2 + 1, 4 * L),
    ('ep2_tp2', 'full'): (5 * L + 2, 5 * L + 2, 2 + 2 * L + 13 + 2,
                          1 + 2 * L + 3 * L + 2 + 1, 4 * L),
    # Under remat the recompute sums over tp after wo but not after the
    # combine (the checkpoint stops once the tensors the backward keeps
    # are rebuilt), and exchanges over ep both ways.
    ('ep2_tp2', 'lora_remat'): (2 * 5 * L + 2, 0, 2 + 3 * L + 4 + 2,
                                1 + 2 * L + L + (3 * L - 1) + 2 + 1, 6 * L),
}


@pytest.mark.parametrize('mesh_name,name', PARAMETRIZED)
def test_ep_collectives_per_step(results, mesh_name, name):
    assert tllama.get_config(MODEL).n_layers == L
    want = dict(zip(('gathers', 'reduce_scatters', 'all_reduces',
                     'tp_reduces', 'all_to_alls'),
                    COLLECTIVES[mesh_name, name]),
                ring_sends=0, pp_sends=0, host_staged=0)
    for r in results(_group_of(mesh_name))[mesh_name]:
        assert r[name]['collectives'] == want


@pytest.mark.parametrize('mesh_name', sorted(MESHES))
def test_aux_is_the_global_batch_aux(results, mesh_name):
    """Each rank's aux share of a forward, summed over a data group,
    is JAX's aux of the whole batch (the ranks of a tp group hold the
    same share); a forward exchanges 2 L times over ep."""
    res = results(_group_of(mesh_name))
    ranks = res['aux', mesh_name]
    mesh_kw = MESHES[mesh_name]
    tp = mesh_kw.get('tp', 1)
    total = sum(r['aux'] for r in ranks) / tp
    np.testing.assert_allclose(total, res['aux'], rtol=1e-5)
    L = tllama.get_config(MODEL).n_layers
    for r in ranks:
        assert r['collectives']['all_to_alls'] == 2 * L


@pytest.mark.parametrize('name', sorted(CASES['ep2']))
def test_ep_save_restores_whole(results, name):
    """The ep 2 ranks' saves restore whole into a one-process state,
    bit-equal to the assembled blocks; each block was written once, and
    the expert stacks split over ep (ep 2 -> 1)."""
    res = results('ep2')
    kind, cfg_kw = CASES['ep2'][name]
    blocks = [r[name]['blocks'] for r in res['ep2']]
    cfg = tllama.get_config(MODEL, **cfg_kw)
    if kind == 'qlora':
        template = ttrain.init_qlora_state(cfg, lora_rank=4, device='cpu')
    else:
        template = ttrain.init_train_state(
            cfg, seed=0, lora_rank=None if kind == 'full' else 4,
            device='cpu')
    path = os.path.join(res['saved'], 'ep2', name)
    mgr = tcheckpoint.NativeCheckpointManager(path, process_index=0,
                                              process_count=1)
    try:
        state, start = mgr.restore_or(template)
    finally:
        mgr.close()
    assert start == 2 and state.layout is None
    assert mgr.last_restore['resharded'] is True
    assert mgr.last_restore['saved_device_count'] == 2
    flat = tcheckpoint.flatten(state.checkpoint_tree())
    for key in blocks[0]:
        leaf = flat[key]
        got = leaf.numpy() if leaf.dtype == torch.int8 else \
            leaf.float().numpy()
        np.testing.assert_array_equal(got, _assemble(blocks, key))
    with open(os.path.join(path, 'step_00000001', 'manifest.json'),
              encoding='utf-8') as f:
        doc = json.load(f)
    for key, entry in doc['leaves'].items():
        windows = [tuple(map(tuple, s['index'])) for s in entry['shards']]
        assert len(windows) == len(set(windows)), key
    up = 'params/layers/w_up' + ('/q' if kind == 'qlora' else '')
    assert [s['index'][1] for s in doc['leaves'][up]['shards']] == [
        [0, 2], [2, 4]]


def test_whole_save_restores_onto_ep_ranks(results):
    """A one-process tiny-moe save restored onto the 2 ep ranks (1 -> ep
    2): the assembled blocks are the saved leaves, each rank holding two
    of the four experts."""
    res = results('ep2')
    mgr = tcheckpoint.NativeCheckpointManager(res['whole'], process_index=0,
                                              process_count=1)
    try:
        template = ttrain.init_train_state(tllama.get_config(MODEL),
                                           lora_rank=4, device='cpu')
        whole, _ = mgr.restore_or(template)
    finally:
        mgr.close()
    want = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else
                np.asarray(v))
            for k, v in tcheckpoint.flatten(whole.checkpoint_tree()).items()}
    blocks = [r[0] for r in res['restore']]
    for _, info in res['restore']:
        assert info['resharded'] is True and info['step'] == 4
    assert set(blocks[0]) == {k for k, v in want.items() if v.ndim}
    for key in blocks[0]:
        np.testing.assert_array_equal(_assemble(blocks, key), want[key])
    assert blocks[0]['params/layers/w_gate'][1].shape == (2, 2, 128, 256)


def test_expert_stacks_stay_local_in_the_gather():
    """The expert axis (spec entry ``ep`` alone) is never gathered; the
    dense leaves' ``('fsdp', 'ep')`` fold is."""
    from skypilot_torch.parallel import sharding
    rules = tllama.param_sharding_rules(tllama.get_config(MODEL))
    assert sharding.is_expert_axis(rules['layers']['w_gate'][1])
    assert not sharding.is_expert_axis(rules['layers']['router'][1])
    assert not any(sharding.is_expert_axis(e) for e in rules['embed'])


def test_mixtral_lora_plan_at_ep4():
    """mixtral-8x7b's bf16 LoRA state on the meta device at ep 4: two of
    the eight experts a device (~22.5 GB of expert stacks), the dense
    leaves split four ways over fsdp x ep: under 25 GB a device."""
    cfg = tllama.get_config('mixtral-8x7b')
    plan = ttrain.plan_train_state(cfg, tmesh.MeshConfig(ep=4),
                                   param_dtype=torch.bfloat16, lora_rank=16)
    assert plan['leaves']['params/layers/w_up']['local_shape'] == (
        32, 2, 4096, 14336)
    assert plan['leaves']['params/layers/wq']['local_shape'] == (
        32, 4096 // 4, 4096)
    assert 22e9 < plan['device_bytes'] < 25e9
