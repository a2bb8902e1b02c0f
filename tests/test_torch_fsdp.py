"""FSDP/DP training over a mesh (skypilot_torch/parallel/sharding.py,
train.py, models/llama.py's gathered layers, the sharded checkpoint
engine, recipes/finetune.py) on gloo ranks, against the JAX package's
sharded step on the same mesh shape over ``jax.devices()[:n]`` and
against the port's own one-process step.

Each mesh shape (2 ranks ``fsdp=2``; 4 ranks ``dp=2 x fsdp=2``) is one
process group (``_torch_dist.run``) that runs the LoRA, full-finetune
and QLoRA cases (2 steps each; the LoRA and full cases with an uneven
``loss_mask``, so the ranks' token counts differ) and saves each
final state. Tolerances are ``test_torch_train.py``'s: losses and grad
norms to rtol 1e-5 and params to atol 1e-4 in f32; the QLoRA adapters
(bf16) to rtol 2^-7 + atol 6e-4, losses to rtol 1e-4 and grad norms to
one bf16 ulp. Checkpoints: a sharded save restored whole, a whole save
restored onto 2 ranks, and a JAX 8-device save restored onto 2 ranks,
all bit-equal."""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys

import _torch_dist
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.checkpoint import NativeCheckpointManager as JaxManager
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import lora as jlora
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import train as jtrain
from skypilot_torch import checkpoint as tcheckpoint
from skypilot_torch.models import convert
from skypilot_torch.models import llama as tllama
from skypilot_torch.parallel import lora as tlora
from skypilot_torch.parallel import mesh as tmesh
from skypilot_torch.parallel import sharding
from skypilot_torch.parallel import train as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {'fsdp2': dict(fsdp=2), 'dp2_fsdp2': dict(dp=2, fsdp=2)}
# 'lora_remat': the LoRA case with per-layer checkpointing (the card's
# llama3-8b configs remat): each layer is gathered again in its
# recompute, its gradients reduce-scattered once.
KINDS = ('lora', 'full', 'qlora', 'lora_remat')
STEPS = 2
BATCH, T = 4, 33


def _np(tree):
    """f32 numpy leaves; int8 codes stay int8."""
    return jax.tree.map(lambda x: np.asarray(
        x if x.dtype == jnp.int8 else x.astype(jnp.float32)), tree)


def _configs(kind):
    remat = kind.endswith('_remat')
    return (jllama.get_config('tiny', remat=remat),
            tllama.get_config('tiny', remat=remat))


def _jax_case(mesh_kw, kind):
    """(JAX state, shardings, numpy state for the port, batches)."""
    cfg = _configs(kind)[0]
    n = tmesh.MeshConfig(**mesh_kw).num_devices
    mesh = jmesh.make_mesh(jmesh.MeshConfig(**mesh_kw),
                           devices=jax.devices()[:n])
    key = jax.random.PRNGKey(2)
    rng = np.random.default_rng(len(kind) + n)
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
    return mesh, state, shardings, state_np, batches


@functools.lru_cache(maxsize=None)
def _results(name, tmp):
    """JAX's steps, the port's one-process steps and the port's ranks'
    steps for every kind on mesh ``name``."""
    mesh_kw = MESHES[name]
    jax_out, one_proc, cases = {}, {}, []
    for kind in KINDS:
        cfg, tcfg = _configs(kind)
        mesh, state, shardings, state_np, batches = _jax_case(mesh_kw, kind)
        step = jtrain.build_train_step(cfg, mesh, shardings, donate=False)
        metrics = []
        for b in batches:
            state, m = step(state, jax.tree.map(jnp.asarray, b))
            metrics.append((float(m['loss']), float(m['grad_norm'])))
        jax_out[kind] = {'metrics': metrics,
                         'trainable': _np(state.lora if kind != 'full'
                                          else state.params),
                         'params': _np(state.params)}
        whole = convert.train_state_from_numpy(
            state_np['params'], state_np['lora'], state_np['dtype'],
            device='cpu')
        tstep = ttrain.build_train_step(tcfg)
        metrics = []
        for b in batches:
            whole, m = tstep(whole, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
            metrics.append((m['loss'].item(), m['grad_norm'].float().item()))
        one_proc[kind] = {'metrics': metrics,
                          'state': convert.train_state_to_numpy(whole)}
        cases.append((kind, state_np, batches))
    n = tmesh.MeshConfig(**mesh_kw).num_devices
    ranks = _torch_dist.run(
        n, os.path.join(tmp, 'store'),
        (_torch_dist.mesh_facts, (mesh_kw, [('fsdp',), ('dp',),
                                            ('fsdp', 'ep'),
                                            ('dp', 'fsdp', 'ep')])),
        (_torch_dist.train_steps, (mesh_kw, cases,
                                   os.path.join(tmp, 'saved'))))
    return {'jax': jax_out, 'one_proc': one_proc,
            'facts': [r[0] for r in ranks], 'ranks': [r[1] for r in ranks],
            'saved': os.path.join(tmp, 'saved')}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    base = str(tmp_path_factory.mktemp('fsdp'))
    return lambda name: _results(name, os.path.join(base, name))


def _assemble(ranks, key):
    """The whole leaf ``key`` from every rank's (window, block)."""
    parts = [r[key] for r in ranks]
    shape = [max(w[d][1] for w, _ in parts) for d in
             range(len(parts[0][0]))]
    out = np.zeros(shape, parts[0][1].dtype)
    for win, data in parts:
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


def _metrics_close(kind, got, want):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-4 if kind == 'qlora'
                                   else 1e-5)
        np.testing.assert_allclose(gn, wn, rtol=2 ** -8 if kind == 'qlora'
                                   else 1e-5)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('name', sorted(MESHES))
def test_sharded_steps_match_jax_and_one_process(results, name, kind):
    res = results(name)
    ranks = [r[kind] for r in res['ranks']]
    for r in ranks:  # every rank reports the global loss and norm
        assert r['metrics'] == ranks[0]['metrics']
    _metrics_close(kind, ranks[0]['metrics'], res['jax'][kind]['metrics'])
    _metrics_close(kind, ranks[0]['metrics'],
                   res['one_proc'][kind]['metrics'])
    blocks = [r['blocks'] for r in ranks]
    top = 'params' if kind == 'full' else 'lora'
    want = _leaves(res['jax'][kind]['trainable'], top)
    one = res['one_proc'][kind]['state'][top]
    for key, ref in want.items():
        got = _assemble(blocks, key)
        _close(kind, got, ref)
        _close(kind, got, _leaves(one, top)[key])
    if kind != 'full':
        # The frozen base never moves (int8 codes included).
        for key, ref in _leaves(res['jax'][kind]['params'],
                                'params').items():
            np.testing.assert_array_equal(
                _assemble(blocks, key).astype(np.float32), ref)


# Collectives of one step of ``tiny`` (2 layers, no remat) over a mesh:
# a gather per fsdp-sharded leaf a layer (7 base matmuls, + wq_a and wv_a
# for LoRA; QLoRA also gathers the scales of wo and w_down, whose output
# dim is the fsdp one) and for embed and lm_head; a reduce-scatter per
# trainable gathered leaf; all-reduces: the token count, the loss, one
# per trainable leaf replicated over a data axis, one for the norm's
# group. No exchange over ep (a dense model), and nothing point to point.
NO_P2P = {'ring_sends': 0, 'pp_sends': 0, 'host_staged': 0}
COLLECTIVES = {
    'lora': {'gathers': 9 * 2 + 2, 'reduce_scatters': 2 * 2,
             'all_reduces': 2 + 4 + 1, 'tp_reduces': 0,
             'all_to_alls': 0, **NO_P2P},
    'full': {'gathers': 7 * 2 + 2, 'reduce_scatters': 7 * 2 + 2,
             'all_reduces': 2 + 12 + 1, 'tp_reduces': 0,
             'all_to_alls': 0, **NO_P2P},
    'qlora': {'gathers': 11 * 2 + 2, 'reduce_scatters': 2 * 2,
              'all_reduces': 2 + 4 + 1, 'tp_reduces': 0,
              'all_to_alls': 0, **NO_P2P},
    'lora_remat': {'gathers': 2 * 9 * 2 + 2, 'reduce_scatters': 2 * 2,
                   'all_reduces': 2 + 4 + 1, 'tp_reduces': 0,
                   'all_to_alls': 0, **NO_P2P},
}


@pytest.mark.parametrize('name', sorted(MESHES))
def test_collectives_per_step(results, name):
    for r in results(name)['ranks']:
        assert {k: r[k]['collectives'] for k in KINDS} == COLLECTIVES


@pytest.mark.parametrize('name', sorted(MESHES))
def test_mesh_groups_over_ranks(results, name):
    """Each rank's coordinate is its place in the rank grid; a group
    holds the ranks that differ on its axes, in rank order; the gather
    reassembles the tensor and its backward sums every rank's gradient
    into the block (``(1 + 2 + ... + n_group)`` per element)."""
    cfg = tmesh.MeshConfig(**MESHES[name])
    grid = tmesh.rank_grid(cfg)
    for rank, f in enumerate(results(name)['facts']):
        where = np.argwhere(grid == rank)[0]
        assert f['coordinate'] == dict(zip(tmesh.AXES, map(int, where)))
        for axes, ranks in f['groups'].items():
            keep = [tmesh.AXES.index(a) for a in axes]
            same = [r for r in range(cfg.num_devices) if all(
                np.argwhere(grid == r)[0][i] == where[i]
                for i in range(6) if i not in keep)]
            assert ranks == same, axes
            assert ranks.index(rank) == f['index'][axes]
        assert f['gathered_equal']
        group = f['groups'][('fsdp', 'ep')]
        np.testing.assert_array_equal(
            f['block_grad'], np.full(f['block_grad'].shape,
                                     float(sum(r + 1 for r in group))))


@pytest.mark.parametrize('name', sorted(MESHES))
def test_sharded_save_restores_whole(results, name):
    """The ranks' saves (fsdp 2, and dp 2 x fsdp 2 where each block has
    two replicas and the first writes it) restore whole into a
    one-process state, bit-equal to the assembled blocks, recorded as
    resharded."""
    res = results(name)
    for kind in KINDS:
        blocks = [r[kind]['blocks'] for r in res['ranks']]
        template = ttrain.init_train_state(
            tllama.get_config('tiny'), seed=0,
            lora_rank=None if kind == 'full' else 4, device='cpu')
        if kind == 'qlora':
            template = ttrain.init_qlora_state(tllama.get_config('tiny'),
                                               lora_rank=4, device='cpu')
        mgr = tcheckpoint.NativeCheckpointManager(
            os.path.join(res['saved'], kind), process_index=0,
            process_count=1)
        try:
            state, start = mgr.restore_or(template)
        finally:
            mgr.close()
        assert start == 2 and state.layout is None
        assert mgr.last_restore['resharded'] is True
        assert mgr.last_restore['saved_device_count'] == \
            tmesh.MeshConfig(**MESHES[name]).num_devices
        flat = tcheckpoint.flatten(state.checkpoint_tree())
        for key in blocks[0]:
            leaf = flat[key]
            got = leaf.numpy() if leaf.dtype == torch.int8 else \
                leaf.float().numpy()
            np.testing.assert_array_equal(got, _assemble(blocks, key))
        # Replica 0 of each block wrote it: no shard twice on disk.
        with open(os.path.join(res['saved'], kind, 'step_00000001',
                               'manifest.json'), encoding='utf-8') as f:
            doc = json.load(f)
        for key, entry in doc['leaves'].items():
            windows = [tuple(map(tuple, s['index']))
                       for s in entry['shards']]
            assert len(windows) == len(set(windows)), key


@pytest.fixture(scope='module')
def restores(tmp_path_factory):
    """2 ranks (fsdp=2) restoring a one-process port save and a JAX
    8-device save, and their mesh init's blocks."""
    base = tmp_path_factory.mktemp('restores')
    cfg = tllama.get_config('tiny')
    whole = ttrain.init_train_state(cfg, seed=3, lora_rank=4, device='cpu')
    whole = ttrain.TrainState.from_checkpoint_tree(native_randomized(
        whole.checkpoint_tree(), np.random.default_rng(1)))
    port_dir = str(base / 'port')
    tcheckpoint.save_tree(port_dir, 4, whole)
    jcfg = jllama.get_config('tiny')
    jm = jmesh.make_mesh(jmesh.MeshConfig(fsdp=8), devices=jax.devices())
    jstate, jshard = jtrain.init_train_state(jcfg, jm, jax.random.PRNGKey(7),
                                             lora_rank=4)
    rng = np.random.default_rng(2)
    jstate = jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(
            rng.standard_normal(x.shape), x.dtype) if x.ndim else x, s),
        jstate, jshard)
    jax_dir = str(base / 'jax')
    jmgr = JaxManager(jax_dir, process_index=0, process_count=1)
    try:
        jmgr.save(6, jstate)
        jmgr.wait()
    finally:
        jmgr.close()
    ranks = _torch_dist.run(
        2, str(base / 'store'),
        (_torch_dist.restore_blocks, ({'fsdp': 2}, 'lora', port_dir)),
        (_torch_dist.restore_blocks, ({'fsdp': 2}, 'lora', jax_dir)),
        *[(_torch_dist.init_blocks, ({'fsdp': 2}, kind, 5))
          for kind in KINDS])
    return {'whole': whole, 'jax': jstate, 'ranks': ranks}


def native_randomized(tree, rng):
    """A port checkpoint tree with every float leaf redrawn."""
    from skypilot_torch.checkpoint import native

    def draw(_, x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return torch.from_numpy(rng.standard_normal(
                tuple(x.shape)).astype(np.float32)).to(x.dtype)
        return x
    return native._map_leaves(tree, draw)  # noqa: SLF001


def _flat_np(tree):
    from skypilot_torch.checkpoint import native
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) else
                np.asarray(v)) for k, v in native.flatten(tree).items()}


def test_whole_save_restores_onto_two_ranks(restores):
    want = _flat_np(restores['whole'].checkpoint_tree())
    blocks = [r[0][0] for r in restores['ranks']]
    for r in restores['ranks']:
        assert r[0][1]['resharded'] is True and r[0][1]['step'] == 4
        assert r[0][1]['device_count'] == 2
    assert set(blocks[0]) == {k for k, v in want.items() if v.ndim}
    for key in blocks[0]:
        np.testing.assert_array_equal(_assemble(blocks, key), want[key])


def test_jax_8_device_save_restores_onto_two_ranks(restores):
    from skypilot_tpu.checkpoint import format as jformat
    flat, _ = jax.tree_util.tree_flatten_with_path(restores['jax'])
    want = {jformat.key_str(p): np.asarray(x) for p, x in flat}
    blocks = [r[1][0] for r in restores['ranks']]
    for r in restores['ranks']:
        info = r[1][1]
        assert info['resharded'] is True and info['saved_device_count'] == 8
    for key in blocks[0]:
        np.testing.assert_array_equal(_assemble(blocks, key),
                                      want[key].astype(np.float32))


@pytest.mark.parametrize('kind', KINDS)
def test_mesh_init_equals_the_unsharded_init(restores, kind):
    """init over the mesh keeps, on each rank, its block of the
    one-device init with the same seed."""
    cfg = tllama.get_config('tiny')
    if kind == 'qlora':
        whole = ttrain.init_qlora_state(cfg, seed=5, lora_rank=4,
                                        device='cpu')
    else:
        whole = ttrain.init_train_state(
            cfg, seed=5, lora_rank=None if kind == 'full' else 4,
            device='cpu')
    want = {k: (v.numpy() if v.dtype == torch.int8 else v.float().numpy())
            for k, v in tcheckpoint.flatten(whole.checkpoint_tree()).items()
            if isinstance(v, torch.Tensor)}
    blocks = [r[2 + KINDS.index(kind)] for r in restores['ranks']]
    assert set(blocks[0]) == set(want)
    for key in want:
        np.testing.assert_array_equal(_assemble(blocks, key), want[key])
    # The fsdp-sharded leaves are halves on each rank.
    assert blocks[0]['params/embed'][1].shape == (512, 64)


def test_sharding_rules_equal_jax():
    from jax.sharding import PartitionSpec as P

    def same(port, ref):
        if isinstance(ref, P):
            assert tuple(port) == tuple(ref)
        else:
            assert set(port) == set(ref)
            for k in ref:
                same(port[k], ref[k])
    for name in ('tiny', 'qwen2.5-1.5b', 'gemma-2b', 'mixtral-8x7b'):
        for pipeline in (False, True):
            same(tllama.param_sharding_rules(tllama.get_config(name),
                                             pipeline=pipeline),
                 jllama.param_sharding_rules(jllama.get_config(name),
                                             pipeline=pipeline))
            same(ttrain.quantized_sharding_rules(tllama.get_config(name),
                                                 pipeline=pipeline),
                 jtrain.quantized_sharding_rules(jllama.get_config(name),
                                                 pipeline=pipeline))
    cfg = tllama.get_config('tiny')
    for pipeline in (False, True):
        same(tlora.lora_sharding_rules(cfg, pipeline=pipeline),
             jlora.lora_sharding_rules(jllama.get_config('tiny'),
                                       pipeline=pipeline))
    assert ttrain._scale_spec((None, ('fsdp', 'ep'), 'tp')) == \
        tuple(jtrain._scale_spec(P(None, ('fsdp', 'ep'), 'tp')))


def test_moments_take_their_params_spec_by_path():
    """wq and wo share a shape but not a spec: each moment takes its
    param's spec by tree path (JAX ``opt_state_shardings``), in the
    layout the checkpoint and the plan read."""
    specs = ttrain.opt_state_shardings(
        tllama.param_sharding_rules(tllama.get_config('tiny')))
    assert specs['mu']['layers']['wq'] != specs['mu']['layers']['wo']
    assert specs['nu']['layers']['wo'] == (None, 'tp', ('fsdp', 'ep'))
    assert specs['count'] == ()
    cfg = tllama.get_config('tiny')
    for lora in (False, True):
        layout = ttrain._layout(cfg, tmesh.MeshConfig(fsdp=2), lora=lora)
        assert layout.trainable is (layout.lora if lora else layout.params)
    plan = ttrain.plan_train_state(cfg, tmesh.MeshConfig(fsdp=2))
    for m in ('mu', 'nu'):
        for k in ('wq', 'wo'):
            assert plan['leaves'][f'opt_state/1/0/{m}/layers/{k}']['spec'] \
                == plan['leaves'][f'params/layers/{k}']['spec']


def test_spec_arithmetic_raises_as_jax_does():
    shape = {'pp': 1, 'dp': 1, 'fsdp': 3, 'ep': 1, 'tp': 1, 'sp': 1}
    with pytest.raises(ValueError, match='not divisible'):
        sharding.local_shape((8, 4), (('fsdp', 'ep'), None), shape)
    with pytest.raises(ValueError, match='mesh order'):
        sharding.dim_axes(('ep', 'fsdp'))
    assert sharding.local_shape((9, 4), ('fsdp', None), shape) == (3, 4)


@pytest.mark.parametrize('fsdp,fits', [(8, True), (1, False)])
def test_8b_full_finetune_plan(fsdp, fits):
    """The llama3-8b bf16 full finetune on the meta device: at fsdp 8 a
    device holds ~8 GB of state and ~2 GB of gradients, under 80 GB;
    whole on one device it is over."""
    plan = ttrain.plan_train_state(
        tllama.get_config('llama3-8b'), tmesh.MeshConfig(fsdp=fsdp),
        param_dtype=torch.bfloat16)
    n = tllama.get_config('llama3-8b').num_params()
    whole = n * (2 + 4 + 2)  # bf16 params, f32 mu, bf16 nu
    assert plan['state_bytes'] == pytest.approx(whole / fsdp, rel=1e-3)
    assert plan['grad_bytes'] == pytest.approx(2 * n / fsdp, rel=1e-3)
    assert (plan['device_bytes'] < 80e9) == fits
    leaf = plan['leaves']['opt_state/1/0/mu/layers/wo']
    assert leaf['spec'] == (None, 'tp', ('fsdp', 'ep'))
    assert leaf['local_shape'] == (32, 4096, 4096 // fsdp)
    assert leaf['dtype'] == 'torch.float32'


def test_step_refuses_model_axes():
    """The step takes every mesh axis (ep, sp, pp and their products); it
    refuses only what JAX refuses: 1F1B with MoE or sp, MoE with sp
    inside a pipeline, and layers that pp does not split."""
    cfg, moe = tllama.get_config('tiny'), tllama.get_config('tiny-moe')

    def fake(**axes):
        return type('M', (), {'shape': tmesh.MeshConfig(**axes).shape()})()
    for axes in (dict(ep=2), dict(sp=2), dict(pp=2), dict(pp=2, sp=2),
                 dict(pp=2, tp=2, sp=2)):
        assert callable(ttrain.build_train_step(cfg, mesh=fake(**axes)))
    assert callable(ttrain.build_train_step(moe, mesh=fake(sp=2, ep=2)))
    for model, axes, schedule, match in (
            (moe, dict(pp=2), '1f1b', 'MoE'),
            (cfg, dict(pp=2, sp=2), '1f1b', 'sequence parallelism'),
            (moe, dict(pp=2, sp=2), 'gpipe', 'sequence parallelism')):
        with pytest.raises(NotImplementedError, match=match):
            ttrain.build_train_step(model, mesh=fake(**axes),
                                    pipeline_schedule=schedule)
    with pytest.raises(ValueError, match='n_layers=2 not divisible by pp=4'):
        ttrain.build_train_step(cfg, mesh=fake(pp=4))


def test_recipe_spawns_one_worker_per_device(tmp_path):
    """``SKYTPU_NUM_CHIPS_PER_NODE=2 python -m ...finetune --device cpu``
    spawns two gloo workers that train FSDP over a 2-rank mesh; rank 0
    alone prints, and its losses are the one-process run's (the same
    global batches)."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ('SKYTPU_', 'JAX', 'XLA'))}
    env.update(SKYTPU_NUM_CHIPS_PER_NODE='2', HOME=str(tmp_path),
               SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
               SKYTPU_STATE_DIR=str(tmp_path / 'state'),
               PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    argv = ['--model', 'tiny', '--device', 'cpu', '--seq', '32',
            '--batch', '4', '--steps', '2', '--log-every', '1']
    out = subprocess.run(
        [sys.executable, '-m', 'skypilot_torch.recipes.finetune'] + argv,
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO,
        check=True).stdout.splitlines()
    assert out[0].startswith('devices=2 device=cpu model=tiny')
    assert out[0].endswith('mesh=2c:fsdp2')
    assert out[-1] == 'finetune done.' and out.count('finetune done.') == 1
    losses = [float(re.search(r'loss=(\S+)', line).group(1))
              for line in out if line.startswith('step ')]
    env['SKYTPU_NUM_CHIPS_PER_NODE'] = '1'
    one = subprocess.run(
        [sys.executable, '-m', 'skypilot_torch.recipes.finetune'] + argv,
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO,
        check=True).stdout.splitlines()
    assert one[0].startswith('devices=1 device=cpu model=tiny')
    want = [float(re.search(r'loss=(\S+)', line).group(1))
            for line in one if line.startswith('step ')]
    assert len(losses) == 2
    np.testing.assert_allclose(losses, want, rtol=1e-5)
