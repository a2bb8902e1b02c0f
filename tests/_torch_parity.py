"""The JAX side of the parallel step tests of ``test_torch_sp.py`` and
``test_torch_pp.py``: a case's JAX state on a mesh over
``jax.devices()[:n]`` with numpy-seeded adapters and batches, JAX's
sharded steps, the port's one-process steps on the same numpy state,
and the comparisons. The tolerances are ``test_torch_tp.py``'s: losses
and grad norms to rtol 1e-5 and params to atol 1e-4 in f32; the QLoRA
adapters (bf16) to rtol 2^-7 + atol 6e-4, losses to rtol 1e-4 and grad
norms to one bf16 ulp of the reference."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import train as jtrain
from skypilot_torch.models import convert
from skypilot_torch.models import llama as tllama
from skypilot_torch.parallel import train as ttrain

# Case overrides that go to the steps rather than to the config.
STEP_KEYS = ('pipeline_microbatches', 'pipeline_schedule')


def np_tree(tree):
    """f32 numpy leaves; int8 codes stay int8."""
    return jax.tree.map(lambda x: np.asarray(
        x if x.dtype == jnp.int8 else x.astype(jnp.float32)), tree)


def split_kw(kw):
    """(config overrides with the model, step overrides)."""
    kw = dict(kw)
    step = {k: kw.pop(k) for k in STEP_KEYS if k in kw}
    return kw, step


def jax_mesh(mesh_kw):
    n = jmesh.MeshConfig(**mesh_kw).num_devices
    return jmesh.make_mesh(jmesh.MeshConfig(**mesh_kw),
                           devices=jax.devices()[:n])


def jax_case(mesh_kw, kind, kw, seed, batch=4, t=33, steps=2):
    """(mesh, config, JAX state, shardings, numpy state for the port,
    batches): ``kind`` 'lora', 'full' or 'qlora' on ``kw``'s model
    (``tiny``) and config overrides; non-zero adapters; ``steps`` global
    batches of ``[batch, t]`` tokens, with an uneven ``loss_mask`` but
    for QLoRA."""
    cfg_kw, _ = split_kw(kw)
    cfg = jllama.get_config(cfg_kw.pop('model', 'tiny'), **cfg_kw)
    mesh = jax_mesh(mesh_kw)
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
    for _ in range(steps):
        b = {'tokens': rng.integers(0, 512, (batch, t)).astype(np.int32)}
        if kind != 'qlora':
            keep = rng.random((batch, 1)) * 0.9
            b['loss_mask'] = (rng.random((batch, t)) > keep).astype(
                np.int32)
        batches.append(b)
    state_np = {'params': np_tree(state.params),
                'lora': None if state.lora is None else np_tree(state.lora),
                'dtype': tdt}
    return mesh, cfg, state, shardings, state_np, batches


def reference(name, mesh_kw, kind, kw, seed, **case_kw):
    """JAX's sharded steps and the port's one-process steps of a case,
    and the case ``name`` as ``_torch_dist.train_steps`` takes it (a
    name ending in ``_remat`` checkpoints each layer on the ranks)."""
    mesh, cfg, state, shardings, state_np, batches = jax_case(
        mesh_kw, kind, kw, seed, **case_kw)
    cfg_kw, step_kw = split_kw(kw)
    step = jtrain.build_train_step(cfg, mesh, shardings, donate=False,
                                   **step_kw)
    jax_metrics = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        jax_metrics.append((float(m['loss']), float(m['grad_norm'])))
    model = cfg_kw.pop('model', 'tiny')
    whole = convert.train_state_from_numpy(
        state_np['params'], state_np['lora'], state_np['dtype'],
        device='cpu')
    tstep = ttrain.build_train_step(tllama.get_config(model, **cfg_kw))
    metrics = []
    for b in batches:
        whole, m = tstep(whole, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
        metrics.append((m['loss'].item(), m['grad_norm'].float().item()))
    return ({'jax': {'metrics': jax_metrics,
                     'trainable': np_tree(state.lora if kind != 'full'
                                          else state.params),
                     'params': np_tree(state.params)},
             'one_proc': {'metrics': metrics,
                          'state': convert.train_state_to_numpy(whole)}},
            (name, state_np, batches, dict(kw)))


def assemble(ranks, key):
    """The whole leaf ``key`` from every rank's (window, block); the
    replicas of a window must be bit-equal."""
    parts = [r[key] for r in ranks]
    shape = [max(w[d][1] for w, _ in parts) for d in
             range(len(parts[0][0]))]
    out = np.full(shape, np.nan, np.float32)
    for win, data in parts:
        at = tuple(slice(a, b) for a, b in win)
        seen = out[at]
        assert np.isnan(seen).all() or np.array_equal(seen, data), key
        out[at] = data
    assert not np.isnan(out).any(), key
    return out


def leaves(tree, prefix):
    return {prefix + '/' + '/'.join(p): x
            for p, x in ttrain._leaves(tree)}  # noqa: SLF001


def close(kind, got, want):
    if kind == 'qlora':
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=6e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def bf16_ulp(x):
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def metrics_close(kind, got, want):
    for (gl, gn), (wl, wn) in zip(got, want, strict=True):
        np.testing.assert_allclose(gl, wl, rtol=1e-4 if kind == 'qlora'
                                   else 1e-5)
        if kind == 'qlora':  # a bf16 norm: to one ulp
            assert abs(gn - wn) <= bf16_ulp(wn), (gn, wn)
        else:
            np.testing.assert_allclose(gn, wn, rtol=1e-5)


def check_case(kind, ref, ranks, microbatch_aux=False):
    """Every rank's metrics equal; they, the assembled trainable blocks
    and (LoRA, QLoRA) the untouched base match JAX's and the one-process
    step's. ``microbatch_aux``: an MoE pipeline, whose aux loss is
    microbatch-local in JAX as here, so only its losses are held to the
    unpipelined one-process step's, at JAX's own rtol 1e-3
    (``tests/test_pipeline.py::test_pp_with_moe_matches_reference``)."""
    for r in ranks:  # every rank reports the global loss and norm
        assert r['metrics'] == ranks[0]['metrics']
    metrics_close(kind, ranks[0]['metrics'], ref['jax']['metrics'])
    if microbatch_aux:
        np.testing.assert_allclose(
            [m[0] for m in ranks[0]['metrics']],
            [m[0] for m in ref['one_proc']['metrics']], rtol=1e-3)
    else:
        metrics_close(kind, ranks[0]['metrics'],
                      ref['one_proc']['metrics'])
    blocks = [r['blocks'] for r in ranks]
    top = 'params' if kind == 'full' else 'lora'
    one = leaves(ref['one_proc']['state'][top], top)
    for key, want in leaves(ref['jax']['trainable'], top).items():
        got = assemble(blocks, key)
        close(kind, got, want)
        if not microbatch_aux:
            close(kind, got, one[key])
    if kind != 'full':
        # The frozen base never moves (int8 codes included).
        for key, want in leaves(ref['jax']['params'], 'params').items():
            np.testing.assert_array_equal(assemble(blocks, key), want)


def recipe_losses(tmp_path, argv, chips):
    """``python -m skypilot_torch.recipes.finetune argv`` with
    ``SKYTPU_NUM_CHIPS_PER_NODE=chips`` (gloo workers on the CPU): its
    first line and the losses rank 0 printed."""
    import os
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
    env.update(SKYTPU_NUM_CHIPS_PER_NODE=str(chips), HOME=str(tmp_path),
               SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
               SKYTPU_STATE_DIR=str(tmp_path / 'state'),
               PYTHONPATH=repo, OMP_NUM_THREADS='1')
    out = subprocess.run(
        [sys.executable, '-m', 'skypilot_torch.recipes.finetune'] + argv,
        capture_output=True, text=True, env=env, timeout=120, cwd=repo,
        check=True).stdout.splitlines()
    assert out[-1] == 'finetune done.' and out.count('finetune done.') == 1
    return out[0], [float(re.search(r'loss=(\S+)', line).group(1))
                    for line in out if line.startswith('step ')]
