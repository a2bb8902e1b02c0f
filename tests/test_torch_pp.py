"""Pipeline parallelism (``pp``; skypilot_torch/parallel/pipeline.py's
GPipe and 1F1B schedules, the stage exchange of parallel/sharding.py,
the ``pipeline=`` sharding rules) on gloo ranks, against the JAX
package's sharded step on the same mesh shape and schedule over
``jax.devices()[:n]`` and against the port's one-process step, and the
``pp``-sharded checkpoints against JAX's engine both ways.

Three process groups (``_torch_dist.run``): 2 ranks at ``pp=2`` (GPipe:
LoRA, full, QLoRA, remat LoRA, a tied-embedding full step, MoE; 1F1B:
full and LoRA; a JAX ``pp=2`` save restored onto the ranks, and their
saves), 4 ranks (GPipe MoE at ``pp=2 x ep=2``, LoRA at ``pp=2 x sp=2``;
at ``pp=4`` on a 4-layer ``tiny``, 1F1B and GPipe over 3 microbatches)
and 8 ranks (LoRA at ``pp=2 x sp=2 x tp=2``); the recipe at ``--pp 2
--microbatches 4`` as spawned workers. Tolerances are
``_torch_parity``'s (``test_torch_tp.py``'s); an MoE pipeline's aux loss
is microbatch-local, in JAX as here, so it is held to the unpipelined
step at JAX's own rtol 1e-3."""
import functools
import os

import _torch_dist
import _torch_parity as parity
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.checkpoint import NativeCheckpointManager as JaxManager
from skypilot_tpu.checkpoint import format as jformat
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import train as jtrain
from skypilot_torch import checkpoint as tcheckpoint
from skypilot_torch.models import llama as tllama
from skypilot_torch.parallel import mesh as tmesh
from skypilot_torch.parallel import pipeline as tpipeline
from skypilot_torch.parallel import train as ttrain

M4 = dict(pipeline_microbatches=4)
F1B = dict(pipeline_microbatches=4, pipeline_schedule='1f1b')
PP4 = dict(n_layers=4, pipeline_microbatches=3)
# name -> (mesh, kind, overrides: config, model and step).
CASES = {
    'pp2': {'lora': ('lora', M4), 'full': ('full', M4),
            'qlora': ('qlora', M4), 'lora_remat': ('lora', M4),
            'full_tied': ('full', dict(M4, tie_embeddings=True)),
            'moe_full': ('full', dict(M4, model='tiny-moe')),
            'full_1f1b': ('full', F1B), 'lora_1f1b': ('lora', F1B)},
    'pp2_ep2': {'moe_full': ('full', dict(M4, model='tiny-moe'))},
    'pp2_sp2': {'lora': ('lora', M4)},
    'pp4': {'full_1f1b': ('full', dict(PP4, pipeline_schedule='1f1b')),
            'full': ('full', PP4)},
    'pp2_sp2_tp2': {'lora': ('lora', dict(pipeline_microbatches=2))},
}
MESHES = {'pp2': dict(pp=2), 'pp2_ep2': dict(pp=2, ep=2),
          'pp2_sp2': dict(pp=2, sp=2), 'pp4': dict(pp=4),
          'pp2_sp2_tp2': dict(pp=2, tp=2, sp=2)}
# Global batch rows: divisible by the microbatches times the data axes.
BATCH = {'pp4': 6, 'pp2_ep2': 8}
GROUPS = {2: ('pp2',), 4: ('pp2_ep2', 'pp2_sp2', 'pp4'),
          8: ('pp2_sp2_tp2',)}
# 1F1B's kept stage inputs over pp 4, at these microbatch counts.
KEPT_MICRO = (4, 12)
PARAMETRIZED = [(m, c) for m in sorted(CASES) for c in sorted(CASES[m])]


def jax_pp2_save(path):
    """A JAX LoRA state over ``pp=2`` with every leaf redrawn, saved by
    the JAX engine at step 6; returns its leaves by key."""
    jm = parity.jax_mesh(dict(pp=2))
    state, shard = jtrain.init_train_state(
        jllama.get_config('tiny'), jm, jax.random.PRNGKey(7), lora_rank=4)
    assert state.params['layers']['wq'].sharding.spec[0] == 'pp'
    rng = np.random.default_rng(2)
    state = jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(
            rng.standard_normal(x.shape), x.dtype) if x.ndim else x, s),
        state, shard)
    mgr = JaxManager(path, process_index=0, process_count=1)
    try:
        mgr.save(6, state)
        mgr.wait()
    finally:
        mgr.close()
    return _jax_flat(state)


def _jax_flat(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jformat.key_str(p): np.asarray(x) for p, x in flat}


@functools.lru_cache(maxsize=None)
def _group(n, tmp):
    refs, calls = {}, []
    for mesh_name in GROUPS[n]:
        cases, seen = [], {}
        for name in sorted(CASES[mesh_name]):
            kind, kw = CASES[mesh_name][name]
            # One JAX run a (kind, overrides): remat changes no number.
            key = (kind, repr(sorted(kw.items())))
            if key not in seen:
                seen[key] = parity.reference(
                    name, MESHES[mesh_name], kind, kw, len(mesh_name),
                    batch=BATCH.get(mesh_name, 4))
            refs[mesh_name, name], case = seen[key]
            cases.append((name,) + case[1:])
        calls.append((_torch_dist.train_steps, (
            MESHES[mesh_name], cases, os.path.join(tmp, 'saved', mesh_name))))
    out = {'refs': refs, 'saved': os.path.join(tmp, 'saved')}
    if n == 2:
        out['jax_save'] = jax_pp2_save(os.path.join(tmp, 'jax_save'))
        out['jax_save_dir'] = os.path.join(tmp, 'jax_save')
        calls.append((_torch_dist.restore_blocks, (
            MESHES['pp2'], 'lora', out['jax_save_dir'])))
    if n == 4:
        calls += [(_torch_dist.pipeline_kept, (4, m)) for m in KEPT_MICRO]
    ranks = _torch_dist.run(n, os.path.join(tmp, 'store'), *calls)
    for i, mesh_name in enumerate(GROUPS[n]):
        out[mesh_name] = [r[i] for r in ranks]
    if n == 2:
        out['restore'] = [r[-1] for r in ranks]
    if n == 4:
        out['kept'] = {m: [r[len(GROUPS[n]) + j] for r in ranks]
                       for j, m in enumerate(KEPT_MICRO)}
    return out


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    base = str(tmp_path_factory.mktemp('pp'))
    return lambda n: _group(n, os.path.join(base, str(n)))


def _n_of(mesh_name):
    return next(n for n, meshes in GROUPS.items() if mesh_name in meshes)


@pytest.mark.parametrize('mesh_name,name', PARAMETRIZED)
def test_pp_steps_match_jax_and_one_process(results, mesh_name, name):
    res = results(_n_of(mesh_name))
    kind, kw = CASES[mesh_name][name]
    ranks = [r[name] for r in res[mesh_name]]
    parity.check_case(kind, res['refs'][mesh_name, name], ranks,
                      microbatch_aux=kw.get('model') == 'tiny-moe')


@pytest.mark.parametrize('mesh_name,name', PARAMETRIZED)
def test_pp_sends_per_step(results, mesh_name, name):
    """A step's stage traffic, whatever the schedule: each microbatch's
    activation forward and its gradient back over every boundary between
    stages, so the first and last stages send M tensors and an inner
    one 2 M; where the stages are over sp, the ring's as
    ``test_torch_sp.py`` counts them, a layer a microbatch."""
    kind, kw = CASES[mesh_name][name]
    pp, micro = MESHES[mesh_name]['pp'], kw['pipeline_microbatches']
    layers = kw.get('n_layers', 2) // pp
    colls = [r[name]['collectives'] for r in
             results(_n_of(mesh_name))[mesh_name]]
    assert {c['pp_sends'] for c in colls} == (
        {micro, 2 * micro} if pp > 2 else {micro})
    for c in colls:
        if 'sp' in MESHES[mesh_name]:
            assert c['ring_sends'] == micro * layers * (2 + 4 + 2)
        else:
            assert c['ring_sends'] == 0


@pytest.mark.parametrize('micro', KEPT_MICRO)
def test_one_f_one_b_keeps_at_most_its_bound_of_inputs(results, micro):
    """1F1B's stage inputs live at once on stage i: at most 2 (pp - i) - 1
    (JAX's bound) and never more than the microbatches, so at 12
    microbatches over pp 4 as many as at 7; the last stage keeps none (it
    runs each microbatch forward and backward in one round)."""
    got = results(4)['kept'][micro]
    want = [min(micro, 2 * (4 - i) - 1) for i in range(3)] + [0]
    assert got == want, (micro, got)


def test_jax_pp2_save_restores_onto_pp2_and_one_process(results):
    """A JAX save over ``pp=2`` (the layers' stacked axis split over the
    stages) restored onto the port's two stages, each holding its layers'
    window, and whole onto one process: both equal the saved leaves."""
    res = results(2)
    want = res['jax_save']
    blocks = [r[0] for r in res['restore']]
    for _, info in res['restore']:
        assert info['step'] == 6 and info['resharded'] is True
    assert blocks[0]['params/layers/wq'][0][0] in ([0, 1], [1, 2])
    for key in blocks[0]:
        np.testing.assert_array_equal(parity.assemble(blocks, key),
                                      want[key].astype(np.float32))
    mgr = tcheckpoint.NativeCheckpointManager(
        res['jax_save_dir'], process_index=0, process_count=1)
    try:
        whole, start = mgr.restore_or(ttrain.init_train_state(
            tllama.get_config('tiny'), lora_rank=4, device='cpu'))
    finally:
        mgr.close()
    assert start == 7
    for key, leaf in tcheckpoint.flatten(whole.checkpoint_tree()).items():
        got = leaf.float().numpy() if isinstance(leaf, torch.Tensor) else \
            np.asarray(leaf)
        np.testing.assert_array_equal(got, want[key].astype(got.dtype))


@pytest.mark.parametrize('jax_pp', [2, 1])
def test_port_pp2_save_restores_into_jax(results, jax_pp):
    """The port's ``pp=2`` LoRA save (each stage wrote its layers'
    window) restored by JAX's engine onto a JAX ``pp=2`` state and onto a
    one-device one: equal to the stages' assembled blocks."""
    res = results(2)
    blocks = [r['lora']['blocks'] for r in res['pp2']]
    jm = parity.jax_mesh(dict(pp=jax_pp))
    template, _ = jtrain.init_train_state(
        jllama.get_config('tiny'), jm, jax.random.PRNGKey(0), lora_rank=4)
    mgr = JaxManager(os.path.join(res['saved'], 'pp2', 'lora'),
                     process_index=0, process_count=1)
    try:
        restored, start = mgr.restore_or(template)
    finally:
        mgr.close()
    assert start == 2
    flat = _jax_flat(restored)
    for key in blocks[0]:
        np.testing.assert_array_equal(
            flat[key].astype(np.float32), parity.assemble(blocks, key))


def test_pipeline_config_errors_are_jax_s():
    """``validate_pipeline_config`` and the schedule checks raise JAX's
    errors: layers that pp does not split, MoE with sp inside a
    pipeline, 1F1B with MoE or sp, and an unknown schedule."""
    tiny, moe = tllama.get_config('tiny'), tllama.get_config('tiny-moe')
    shape = tmesh.MeshConfig(pp=4, dp=2).shape()
    with pytest.raises(ValueError, match='divisible'):
        tpipeline.validate_pipeline_config(tiny, shape)
    with pytest.raises(ValueError, match='divisible'):
        ttrain.plan_train_state(tiny, tmesh.MeshConfig(pp=4, dp=2))
    with pytest.raises(NotImplementedError, match='sequence'):
        ttrain.plan_train_state(moe, tmesh.MeshConfig(pp=2, fsdp=2, sp=2))
    pp2 = tmesh.MeshConfig(pp=2, fsdp=4).shape()
    with pytest.raises(NotImplementedError, match='MoE'):
        tpipeline.check_schedule(moe, pp2, '1f1b')
    with pytest.raises(NotImplementedError, match='sequence'):
        tpipeline.check_schedule(tiny, dict(pp2, sp=2), '1f1b')
    with pytest.raises(ValueError, match="unknown pipeline_schedule 'zb'"):
        tpipeline.check_schedule(tiny, pp2, 'zb')
    fake = type('M', (), {'shape': pp2})()
    with pytest.raises(ValueError, match='unknown pipeline_schedule'):
        ttrain.build_train_step(tiny, mesh=fake, pipeline_schedule='zb')
    assert callable(ttrain.build_train_step(tiny, mesh=fake,
                                            pipeline_schedule='1f1b'))


def test_stage_params_are_sharded_over_pp():
    """At pp 2 each stage holds half the layers of every stacked leaf
    (adapters and their moments too), the embedding and head whole."""
    plan = ttrain.plan_train_state(tllama.get_config('llama3-8b'),
                                   tmesh.MeshConfig(pp=2, fsdp=2),
                                   lora_rank=16)
    leaf = plan['leaves']['params/layers/wq']
    assert leaf['spec'][0] == 'pp'
    assert leaf['local_shape'] == (16, 2048, 4096)
    assert plan['leaves']['lora/wq_a']['local_shape'] == (16, 2048, 16)
    assert plan['leaves']['opt_state/1/0/mu/wq_a']['local_shape'] == (
        16, 2048, 16)
    assert plan['leaves']['params/embed']['local_shape'] == (128256, 2048)


def test_recipe_trains_over_pp(tmp_path):
    """``--pp 2 --microbatches 4`` on two gloo workers: each holds one of
    tiny's two layers; rank 0's losses are the one-process run's."""
    argv = ['--model', 'tiny', '--device', 'cpu', '--seq', '32',
            '--batch', '4', '--steps', '2', '--log-every', '1']
    head, pp = parity.recipe_losses(
        tmp_path, argv + ['--pp', '2', '--microbatches', '4'], 2)
    assert head.startswith('devices=2 device=cpu model=tiny')
    assert head.endswith('mesh=2c:pp2')
    _, one = parity.recipe_losses(tmp_path, argv, 1)
    assert len(pp) == 2
    np.testing.assert_allclose(pp, one, rtol=1e-5)
