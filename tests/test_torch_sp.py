"""Sequence parallelism (``sp``; skypilot_torch/ops/ring_attention.py,
the ring exchange and token sums of parallel/sharding.py, models/
llama.py's global RoPE positions and row-global MoE slots) on gloo
ranks, against the JAX package's ``ring_attention_sharded`` and its
sharded step on the same mesh shape over ``jax.devices()[:n]``, and
against the port's one-process step.

Two process groups (``_torch_dist.run``): 2 ranks at ``sp=2`` (the ring
alone with GQA; the LoRA, full, QLoRA and remat-LoRA steps; the MoE full
step at a capacity that drops; the MoE slots) and 4 ranks (the ring at
``sp=4``; the LoRA step at ``fsdp=2 x sp=2`` and ``sp=2 x tp=2``); the
recipe at ``--sp 2`` as spawned workers. Tolerances are
``_torch_parity``'s (``test_torch_tp.py``'s); the ring's outputs and
gradients in f32 to 2e-5 / 5e-5 (``tests/test_ring_attention.py``'s)."""
import functools
import os

import _torch_dist
import _torch_parity as parity
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skypilot_tpu.ops import ring_attention as jring
from skypilot_torch.models import llama as tllama

# name -> (mesh, kind, overrides).
CASES = {
    'sp2': {'lora': ('lora', {}), 'full': ('full', {}),
            'qlora': ('qlora', {}), 'lora_remat': ('lora', {}),
            'moe_full': ('full', dict(model='tiny-moe',
                                      moe_capacity_factor=0.5))},
    'fsdp2_sp2': {'lora': ('lora', {})},
    'sp2_tp2': {'lora': ('lora', {})},
}
MESHES = {'sp2': dict(sp=2), 'fsdp2_sp2': dict(fsdp=2, sp=2),
          'sp2_tp2': dict(tp=2, sp=2)}
GROUPS = {2: ('sp2',), 4: ('fsdp2_sp2', 'sp2_tp2')}
PARAMETRIZED = [(m, c) for m in sorted(CASES) for c in sorted(CASES[m])]
# The ring's inputs: B, T, H, Hkv, D (GQA).
RING = (2, 32, 4, 2, 16)
MOE_SHAPE, MOE_CF = (2, 32, 128), 0.5


def _ring_inputs():
    b, t, h, hkv, d = RING
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (b, t, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, h, d)))


def _moe_inputs():
    rng = np.random.default_rng(1)
    h = rng.standard_normal(MOE_SHAPE).astype(np.float32)
    router = (rng.standard_normal((MOE_SHAPE[2], 4)) / 8).astype(np.float32)
    return h, router


@functools.lru_cache(maxsize=None)
def _group(n, tmp):
    refs, calls = {}, [(_torch_dist.ring_rank, _ring_inputs())]
    if n == 2:
        h, router = _moe_inputs()
        cfg = tllama.get_config('tiny-moe', moe_capacity_factor=MOE_CF)
        calls.append((_torch_dist.moe_row_slots, (
            h, router, cfg.moe_top_k, tllama.moe_capacity(cfg,
                                                          MOE_SHAPE[1]))))
    for mesh_name in GROUPS[n]:
        cases, seen = [], {}
        for name in sorted(CASES[mesh_name]):
            kind, kw = CASES[mesh_name][name]
            # One JAX run a (kind, overrides): remat changes no number.
            key = (kind, repr(sorted(kw.items())))
            if key not in seen:
                seen[key] = parity.reference(
                    name, MESHES[mesh_name], kind, kw, len(mesh_name))
            refs[mesh_name, name], case = seen[key]
            cases.append((name,) + case[1:])
        calls.append((_torch_dist.train_steps, (MESHES[mesh_name], cases)))
    ranks = _torch_dist.run(n, os.path.join(tmp, 'store'), *calls)
    out = {'refs': refs, 'ring': [r[0] for r in ranks]}
    first = 1
    if n == 2:
        out['moe_slots'] = [r[1] for r in ranks]
        first = 2
    for i, mesh_name in enumerate(GROUPS[n]):
        out[mesh_name] = [r[first + i] for r in ranks]
    return out


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    base = str(tmp_path_factory.mktemp('sp'))
    return lambda n: _group(n, os.path.join(base, str(n)))


def _n_of(mesh_name):
    return next(n for n, meshes in GROUPS.items() if mesh_name in meshes)


@pytest.mark.parametrize('n', [2, 4])
def test_ring_matches_jax_ring_attention(results, n):
    """The port's ring on the flash kernels' plain versions against
    ``ring_attention_sharded`` over an ``sp = n`` mesh: the output and
    the gradients of ``sum(out * dout)``, at GQA (4 heads, 2 kv heads);
    each rank's launches are those of its ``sp_index + 1`` blocks and its
    point-to-point sends the ring's."""
    q, k, v, dout = _ring_inputs()
    mesh = parity.jax_mesh(dict(sp=n))

    def loss(q, k, v):
        out = jring.ring_attention_sharded(mesh, q, k, v)
        return jnp.sum(out * dout), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    want = {'out': out, 'dq': grads[0], 'dk': grads[1], 'dv': grads[2]}
    for r in results(n)['ring']:
        at = slice(*r['window'])
        np.testing.assert_allclose(r['out'], np.asarray(want['out'])[:, at],
                                   rtol=2e-5, atol=2e-5)
        for g in ('dq', 'dk', 'dv'):
            np.testing.assert_allclose(r[g], np.asarray(want[g])[:, at],
                                       rtol=5e-5, atol=5e-5)
        # Forward: (k, v) n - 1 times; backward: (k, v, dk, dv) n - 1
        # times and (dk, dv) once more.
        assert r['forward']['ring_sends'] == 2 * (n - 1)
        assert r['total']['ring_sends'] == 6 * (n - 1) + 2
    assert sorted(r['window'] for r in results(n)['ring']) == [
        (i * RING[1] // n, (i + 1) * RING[1] // n) for i in range(n)]


def test_moe_at_sp_drops_the_entries_jax_drops(results):
    """MoE routing at ``sp = 2`` routes each whole row as JAX does: the
    capacity of the global T, slots token-major along the row (the
    ranks' counts before it), so the same (token, choice) entries are
    kept and dropped as in JAX's ``_moe_mlp`` on the whole sequence."""
    h, router = _moe_inputs()
    cfg = tllama.get_config('tiny-moe', moe_capacity_factor=MOE_CF)
    k, e, t = cfg.moe_top_k, cfg.n_experts, MOE_SHAPE[1]
    cap = tllama.moe_capacity(cfg, t)
    # JAX's routing, its lines of skypilot_tpu/models/llama.py _moe_mlp.
    probs = jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(idx, e, dtype=jnp.float32).reshape(
        h.shape[0], t * k, e)
    pos = (jnp.cumsum(sel, axis=1) - sel).astype(jnp.int32)
    keep = np.asarray((sel * (pos < cap)).sum(-1)).reshape(h.shape[0], t,
                                                           k) > 0
    ranks = results(2)['moe_slots']
    got_idx = np.concatenate([r[0] for r in ranks], axis=1)
    got_slot = np.concatenate([r[1] for r in ranks], axis=1)
    np.testing.assert_array_equal(got_idx, np.asarray(idx))
    np.testing.assert_array_equal(got_slot >= 0, keep)
    want_slot = np.asarray((pos * sel).sum(-1)).reshape(h.shape[0], t, k)
    np.testing.assert_array_equal(got_slot[keep], want_slot[keep])
    assert 0 < (~keep).sum() < keep.size   # the capacity binds


@pytest.mark.parametrize('mesh_name,name', PARAMETRIZED)
def test_sp_steps_match_jax_and_one_process(results, mesh_name, name):
    res = results(_n_of(mesh_name))
    kind = CASES[mesh_name][name][0]
    ranks = [r[name] for r in res[mesh_name]]
    parity.check_case(kind, res['refs'][mesh_name, name], ranks)


@pytest.mark.parametrize('mesh_name,name', PARAMETRIZED)
def test_sp_ring_sends_per_step(results, mesh_name, name):
    """A step's ring traffic over sp 2: each layer's ring forward (k, v)
    once, its backward (k, v, dk, dv) and (dk, dv), and with per-layer
    checkpointing the forward again in the recompute."""
    res = results(_n_of(mesh_name))
    cfg = tllama.get_config('tiny')
    remat = name.endswith('_remat')
    per_layer = 2 * (1 + remat) + 4 + 2
    for r in res[mesh_name]:
        assert r[name]['collectives']['ring_sends'] == \
            cfg.n_layers * per_layer
        assert r[name]['collectives']['pp_sends'] == 0


def test_recipe_trains_over_sp(tmp_path):
    """``--sp 2`` on two gloo workers: each takes its half of every row
    of the global batch; rank 0's losses are the one-process run's."""
    argv = ['--model', 'tiny', '--device', 'cpu', '--seq', '32',
            '--batch', '4', '--steps', '2', '--log-every', '1']
    head, sp = parity.recipe_losses(tmp_path, argv + ['--sp', '2'], 2)
    assert head.startswith('devices=2 device=cpu model=tiny')
    assert head.endswith('mesh=2c:sp2')
    _, one = parity.recipe_losses(tmp_path, argv, 1)
    assert len(sp) == 2
    np.testing.assert_allclose(sp, one, rtol=1e-5)
