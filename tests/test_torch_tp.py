"""Tensor-parallel training (``tp``; skypilot_torch/parallel/sharding.py's
*f* and *g*, models/llama.py's Megatron layers, vocab-sharded embedding
and fused CE, parallel/train.py) on gloo ranks, against the JAX
package's sharded step on the same mesh shape over
``jax.devices()[:n]`` and against the port's one-process step, and the
sharded checkpoints across tp shapes.

Two process groups (``_torch_dist.run``): 2 ranks at ``tp=2`` (the
primitives against autograd of the unsharded products; the LoRA, full
and QLoRA steps, the LoRA step with per-layer checkpointing, and a full
step of a ``tie_embeddings`` + ``qkv_bias`` override of ``tiny``, each
saved; a whole save restored onto the ranks) and 4 ranks at ``fsdp=2 x
tp=2`` (LoRA, full, QLoRA) and at ``tp=4`` (LoRA on a ``tiny`` override
with 8 / 4 heads), restoring a JAX ``(fsdp 2, tp 2)`` save; the recipe
at ``--tp 2`` as spawned workers. 2 steps a case; the LoRA and full
cases with an uneven ``loss_mask``. Tolerances are
``test_torch_fsdp.py``'s
(``test_torch_train.py``'s): losses and grad norms to rtol 1e-5 and
params to atol 1e-4 in f32; the QLoRA adapters (bf16) to rtol 2^-7 +
atol 6e-4, losses to rtol 1e-4 and grad norms to one bf16 ulp of the
reference."""
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

from skypilot_tpu.checkpoint import NativeCheckpointManager as JaxManager
from skypilot_tpu.checkpoint import format as jformat
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import train as jtrain
from skypilot_torch import checkpoint as tcheckpoint
from skypilot_torch.models import convert
from skypilot_torch.models import llama as tllama
from skypilot_torch.parallel import mesh as tmesh
from skypilot_torch.parallel import sharding
from skypilot_torch.parallel import train as ttrain

STEPS = 2
BATCH, T = 4, 33
# name -> (mesh, kind, config overrides): the kind is the state's
# ('lora', 'full' or 'qlora').
CASES = {
    'tp2': {'lora': ('lora', {}), 'full': ('full', {}),
            'qlora': ('qlora', {}), 'lora_remat': ('lora', {}),
            'full_tied_bias': ('full', dict(tie_embeddings=True,
                                            qkv_bias=True))},
    'fsdp2_tp2': {'lora': ('lora', {}), 'full': ('full', {}),
                  'qlora': ('qlora', {})},
    'tp4': {'lora_8_4_heads': ('lora', dict(n_heads=8, n_kv_heads=4))},
}
MESHES = {'tp2': dict(tp=2), 'fsdp2_tp2': dict(fsdp=2, tp=2),
          'tp4': dict(tp=4)}
GROUPS = {'tp2': ('tp2',), 'four': ('fsdp2_tp2', 'tp4')}
PARAMETRIZED = [(m, c) for m in sorted(CASES) for c in sorted(CASES[m])]
INIT_KINDS = ('lora', 'full', 'qlora')


def _np(tree):
    """f32 numpy leaves; int8 codes stay int8."""
    return jax.tree.map(lambda x: np.asarray(
        x if x.dtype == jnp.int8 else x.astype(jnp.float32)), tree)


def _jax_case(mesh_kw, kind, cfg_kw, seed):
    """(JAX state, shardings, numpy state for the port, batches)."""
    cfg = jllama.get_config('tiny', **cfg_kw)
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
    if cfg.qkv_bias:
        # JAX inits the biases to zero: random ones, so the column
        # split of each bias shows.
        layers = dict(state.params['layers'])
        for b in ('bq', 'bk', 'bv'):
            layers[b] = jax.device_put(jnp.asarray(
                0.1 * rng.standard_normal(layers[b].shape), jnp.float32),
                shardings.params['layers'][b])
        state = dataclasses.replace(state, params=dict(state.params,
                                                       layers=layers))
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
    mesh_kw = MESHES[mesh_name]
    mesh, cfg, state, shardings, state_np, batches = _jax_case(
        mesh_kw, kind, cfg_kw, len(name) + len(mesh_name))
    step = jtrain.build_train_step(cfg, mesh, shardings, donate=False)
    jax_metrics = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        jax_metrics.append((float(m['loss']), float(m['grad_norm'])))
    tcfg = tllama.get_config('tiny', **cfg_kw)
    whole = convert.train_state_from_numpy(
        state_np['params'], state_np['lora'], state_np['dtype'],
        device='cpu')
    tstep = ttrain.build_train_step(tcfg)
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
            (name, state_np, batches, cfg_kw))


@functools.lru_cache(maxsize=None)
def _group(group, tmp):
    """The references of every case of the group's meshes, then one
    process group running them (and the group's checkpoint restores)."""
    refs, calls = {}, []
    n = tmesh.MeshConfig(**MESHES[GROUPS[group][0]]).num_devices
    if group == 'tp2':
        calls.append((_torch_dist.tp_primitives, ()))
    for mesh_name in GROUPS[group]:
        cases = []
        for name in sorted(CASES[mesh_name]):
            refs[mesh_name, name], case = _reference(mesh_name, name)
            cases.append(case)
        calls.append((_torch_dist.train_steps, (
            MESHES[mesh_name], cases, os.path.join(tmp, 'saved', mesh_name))))
    restore_dir = os.path.join(tmp, 'restore')
    if group == 'tp2':
        calls += [(_torch_dist.init_blocks, (MESHES['tp2'], kind, 5))
                  for kind in INIT_KINDS]
        whole_save(restore_dir)
        calls.append((_torch_dist.restore_blocks,
                      (MESHES['tp2'], 'lora', restore_dir)))
    else:
        want = jax_save(restore_dir)
        calls.append((_torch_dist.restore_blocks,
                      (MESHES['fsdp2_tp2'], 'lora', restore_dir)))
    ranks = _torch_dist.run(n, os.path.join(tmp, 'store'), *calls)
    out = {'refs': refs, 'saved': os.path.join(tmp, 'saved'),
           'restore': [r[-1] for r in ranks]}
    steps = [r[1:2] for r in ranks] if group == 'tp2' else \
        [r[:-1] for r in ranks]
    for i, mesh_name in enumerate(GROUPS[group]):
        out[mesh_name] = [s[i] for s in steps]
    if group == 'tp2':
        out['primitives'] = [r[0] for r in ranks]
        out['init'] = {kind: [r[2 + i] for r in ranks]
                       for i, kind in enumerate(INIT_KINDS)}
        out['whole'] = restore_dir
    else:
        out['jax_save'] = want
    return out


def _randomized(tree, rng):
    """A port checkpoint tree with every float leaf redrawn."""
    def draw(_, x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return torch.from_numpy(rng.standard_normal(
                tuple(x.shape)).astype(np.float32)).to(x.dtype)
        return x
    return tcheckpoint.native._map_leaves(tree, draw)  # noqa: SLF001


def whole_save(path):
    """A one-process LoRA state with every float leaf redrawn, saved
    whole at step 4."""
    whole = ttrain.init_train_state(tllama.get_config('tiny'), seed=3,
                                    lora_rank=4, device='cpu')
    tcheckpoint.save_tree(path, 4, ttrain.TrainState.from_checkpoint_tree(
        _randomized(whole.checkpoint_tree(),
                          np.random.default_rng(1))))


def jax_save(path):
    """A JAX LoRA state over ``(fsdp 2, tp 2)`` with every leaf redrawn,
    saved by the JAX engine at step 6; returns its leaves by key."""
    jm = jmesh.make_mesh(jmesh.MeshConfig(fsdp=2, tp=2),
                         devices=jax.devices()[:4])
    state, shard = jtrain.init_train_state(
        jllama.get_config('tiny'), jm, jax.random.PRNGKey(7), lora_rank=4)
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
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jformat.key_str(p): np.asarray(x) for p, x in flat}


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    base = str(tmp_path_factory.mktemp('tp'))
    return lambda group: _group(group, os.path.join(base, group))


def _group_of(mesh_name):
    return next(g for g, meshes in GROUPS.items() if mesh_name in meshes)


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
def test_tp_steps_match_jax_and_one_process(results, mesh_name, name):
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


def tp_identity(config, kind, remat, chunks=1):
    """The ``tp`` all-reduces of one step: the lookup's sum; *g* after wo
    and w_down in each layer's forward, and under remat the one after wo
    again in its recompute (the checkpoint stops recomputing once the
    tensors the backward keeps are rebuilt: the sum after w_down feeds
    none of them); in its backward *f* before the attention's and the
    MLP's products, but for the first layer's attention when nothing
    before it trains (LoRA, QLoRA); a chunk's max and its (sum of exps,
    target logit) pair; the CE's dhidden once."""
    L = config.n_layers
    backward = 2 * L - (kind != 'full')
    return 1 + 2 * L + L * remat + backward + 2 * chunks + 1


# The data-axis collectives of one step: gathers over fsdp (9 leaves a
# layer for LoRA: 7 matmuls + wq_a and wv_a; QLoRA also the scales of wo
# and w_down; + embed and head; none where fsdp is 1), their
# reduce-scatters for trainable leaves; all-reduces: the token count,
# the loss, one per trainable leaf replicated over a data axis (the A
# factors over tp as well, in the same call), one per group of shard
# axes in the norm.
DATA_COLLECTIVES = {
    ('tp2', 'lora'): (0, 0, 2 + 4 + 2),
    ('tp2', 'full'): (0, 0, 2 + 12 + 1),
    ('tp2', 'qlora'): (0, 0, 2 + 4 + 2),
    ('tp2', 'lora_remat'): (0, 0, 2 + 4 + 2),
    ('tp2', 'full_tied_bias'): (0, 0, 2 + 14 + 2),
    ('fsdp2_tp2', 'lora'): (9 * 2 + 2, 2 * 2, 2 + 4 + 2),
    ('fsdp2_tp2', 'full'): (7 * 2 + 2, 7 * 2 + 2, 2 + 12 + 1),
    ('fsdp2_tp2', 'qlora'): (11 * 2 + 2, 2 * 2, 2 + 4 + 2),
    ('tp4', 'lora_8_4_heads'): (0, 0, 2 + 4 + 2),
}


@pytest.mark.parametrize('mesh_name,name', PARAMETRIZED)
def test_tp_collectives_per_step(results, mesh_name, name):
    kind, cfg_kw = CASES[mesh_name][name]
    gathers, scatters, reduces = DATA_COLLECTIVES[mesh_name, name]
    want = {'gathers': gathers, 'reduce_scatters': scatters,
            'all_reduces': reduces,
            'tp_reduces': tp_identity(tllama.get_config('tiny', **cfg_kw),
                                      kind, name.endswith('_remat')),
            'all_to_alls': 0, 'ring_sends': 0, 'pp_sends': 0,
            'host_staged': 0}
    for r in results(_group_of(mesh_name))[mesh_name]:
        assert r[name]['collectives'] == want


def test_f_and_g_match_autograd_of_the_unsharded_products(results):
    """*f* is the identity forward and sums the ranks' input gradients
    backward; *g* sums the row-parallel partial products forward and
    passes the gradient through: each rank's outputs and gradients are
    the unsharded products' (its columns where they are cut)."""
    facts = results('tp2')['primitives']
    gen = torch.Generator().manual_seed(0)
    x, w, c = (torch.randn(s, generator=gen) for s in ((4, 6), (6, 8),
                                                       (4, 8)))
    big_x, w2, c2 = (torch.randn(s, generator=gen) for s in (
        (4, 8), (8, 6), (4, 6)))
    for t in (x, w, big_x, w2):
        t.requires_grad_(True)
    ((x @ w) * c).sum().backward()
    ((big_x @ w2) * c2).sum().backward()
    y, y2 = (x @ w).detach(), (big_x @ w2).detach()
    for f in facts:
        cols = slice(*f['cols'])
        assert (f['f_forward'], f['f_backward']) == (0, 1)
        assert (f['g_forward'], f['g_backward']) == (1, 0)
        for got, want in ((f['col_y'], y[:, cols]), (f['col_dx'], x.grad),
                          (f['col_dw'], w.grad[:, cols]),
                          (f['row_y'], y2), (f['row_dx'], big_x.grad[:, cols]),
                          (f['row_dw'], w2.grad[cols])):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert sorted(f['cols'] for f in facts) == [(0, 4), (4, 8)]


@pytest.mark.parametrize('name', sorted(CASES['tp2']))
def test_tp_save_restores_whole(results, name):
    """The tp 2 ranks' saves restore whole into a one-process state,
    bit-equal to the assembled blocks; each block was written once, by
    its first replica (tp 2 -> 1)."""
    res = results('tp2')
    kind, cfg_kw = CASES['tp2'][name]
    blocks = [r[name]['blocks'] for r in res['tp2']]
    cfg = tllama.get_config('tiny', **cfg_kw)
    if kind == 'qlora':
        template = ttrain.init_qlora_state(cfg, lora_rank=4, device='cpu')
    else:
        template = ttrain.init_train_state(
            cfg, seed=0, lora_rank=None if kind == 'full' else 4,
            device='cpu')
    path = os.path.join(res['saved'], 'tp2', name)
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
    # The vocabulary-sharded embedding: one block a tp rank.
    assert len(doc['leaves']['params/embed']['shards']) == 2


def test_whole_save_restores_onto_tp_ranks(results):
    """A one-process save restored onto the 2 tp ranks (1 -> tp 2): the
    assembled blocks are the saved leaves."""
    res = results('tp2')
    mgr = tcheckpoint.NativeCheckpointManager(res['whole'], process_index=0,
                                              process_count=1)
    try:
        template = ttrain.init_train_state(tllama.get_config('tiny'),
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
    # wq_b's columns are split over tp.
    assert blocks[0]['lora/wq_b'][1].shape == (2, 4, 64)


@pytest.mark.parametrize('kind', INIT_KINDS)
def test_tp_mesh_init_equals_the_unsharded_init(results, kind):
    """init over the tp 2 mesh keeps, on each rank, its block of the
    one-device init with the same seed: the vocabulary rows and head
    columns of the unsharded draw."""
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
    blocks = results('tp2')['init'][kind]
    assert set(blocks[0]) == set(want)
    for key in want:
        np.testing.assert_array_equal(_assemble(blocks, key), want[key])
    assert blocks[0]['params/embed'][1].shape == (256, 128)


def test_jax_fsdp2_tp2_save_restores_onto_four_ranks(results):
    res = results('four')
    want = res['jax_save']
    blocks = [r[0] for r in res['restore']]
    for _, info in res['restore']:
        # JAX records its process's 8 devices and its own sharding names.
        assert info['step'] == 6 and info['resharded'] is True
        assert info['saved_device_count'] == 8
    for key in blocks[0]:
        np.testing.assert_array_equal(_assemble(blocks, key),
                                      want[key].astype(np.float32))


def test_head_counts_must_split_over_tp():
    """A Megatron layer runs whole heads: gemma-2b's single kv head
    cannot split over tp 2 (JAX's GSPMD would cut inside it)."""
    with pytest.raises(ValueError, match='gemma-2b: 8 query / 1 kv heads'):
        ttrain.plan_train_state(tllama.get_config('gemma-2b'),
                                tmesh.MeshConfig(tp=2))
    assert sharding.tp_heads(tllama.get_config('llama3-8b'), 4) == (8, 2)


def test_8b_full_finetune_plan_at_fsdp2_tp4():
    """The llama3-8b bf16 full finetune on the meta device at fsdp 2 x
    tp 4: every big leaf splits 8 ways (~10 GB of state and gradients a
    device), the norms stay whole."""
    plan = ttrain.plan_train_state(
        tllama.get_config('llama3-8b'), tmesh.MeshConfig(fsdp=2, tp=4),
        param_dtype=torch.bfloat16)
    n = tllama.get_config('llama3-8b').num_params()
    assert plan['device_bytes'] == pytest.approx(n * 10 / 8, rel=1e-3)
    leaf = plan['leaves']['params/layers/wq']
    assert leaf['local_shape'] == (32, 4096 // 2, 4096 // 4)
    assert plan['leaves']['params/embed']['local_shape'] == (128256 // 4,
                                                             4096 // 2)
    assert plan['leaves']['params/layers/attn_norm']['local_shape'] == (
        32, 4096)


def test_recipe_trains_over_tp(tmp_path):
    """``SKYTPU_NUM_CHIPS_PER_NODE=2 python -m ...finetune --device cpu
    --tp 2`` spawns two gloo workers on the mesh ``tp=2``; rank 0 alone
    prints, and its losses are the one-process run's (the same global
    batches, every rank of the tp group on all of them)."""
    import re
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ('SKYTPU_', 'JAX', 'XLA'))}
    env.update(SKYTPU_NUM_CHIPS_PER_NODE='2', HOME=str(tmp_path),
               SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
               SKYTPU_STATE_DIR=str(tmp_path / 'state'),
               PYTHONPATH=repo, OMP_NUM_THREADS='1')
    argv = ['--model', 'tiny', '--device', 'cpu', '--seq', '32',
            '--batch', '4', '--steps', '2', '--log-every', '1']

    def losses(extra, chips):
        env['SKYTPU_NUM_CHIPS_PER_NODE'] = chips
        out = subprocess.run(
            [sys.executable, '-m', 'skypilot_torch.recipes.finetune'] +
            argv + extra, capture_output=True, text=True, env=env,
            timeout=120, cwd=repo, check=True).stdout.splitlines()
        assert out[-1] == 'finetune done.' and \
            out.count('finetune done.') == 1
        return out[0], [float(re.search(r'loss=(\S+)', line).group(1))
                        for line in out if line.startswith('step ')]
    head, tp = losses(['--tp', '2'], '2')
    assert head.startswith('devices=2 device=cpu model=tiny')
    assert head.endswith('mesh=2c:tp2')
    _, one = losses([], '1')
    assert len(tp) == 2
    np.testing.assert_allclose(tp, one, rtol=1e-5)
