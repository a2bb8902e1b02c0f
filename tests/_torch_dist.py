"""Multi-process runs of the port on the CPU for the parallel tests:
``run(n, tmp_path, (fn, args), ...)`` starts ``n`` gloo ranks (one
process each, from a fork server), which meet through a ``file://`` store under
``tmp_path`` (no ports, so no races between test workers), call each
``fn(*args)`` in turn in one process group and return the results
through a file. Imports torch and the port only: the ranks never load
JAX."""
import multiprocessing
import os
import time
import traceback

import torch

JOIN_SECONDS = 60


def _entry(rank, world, tmp, calls):
    os.environ.update({'SKYTPU_NUM_NODES': '1', 'SKYTPU_NODE_RANK': '0',
                       'SKYTPU_NUM_CHIPS_PER_NODE': str(world)})
    torch.set_num_threads(1)
    from skypilot_torch.parallel import distributed
    out = os.path.join(tmp, f'rank{rank}.pt')
    try:
        distributed.initialize(force=True, local_rank=rank, device='cpu',
                               init_method=f'file://{tmp}/store',
                               timeout_s=JOIN_SECONDS)
        result = [fn(*args) for fn, args in calls]
        torch.save({'ok': result}, out)
    except BaseException:  # reported to the parent, then re-raised
        torch.save({'error': traceback.format_exc()}, out)
        raise
    finally:
        distributed.shutdown()


def run(n, tmp_path, *calls):
    """``[[fn(*args) for fn, args in calls] on rank r for r in
    range(n)]``; raises with a rank's traceback if one failed, and if
    any is still running ``JOIN_SECONDS`` after the start (then
    killed)."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    # A fork server: started from a fresh interpreter (nothing of this
    # process, which may run JAX's threads, is forked), it imports torch
    # and the port once and forks each rank from there, so a rank starts
    # without importing them again.
    ctx = multiprocessing.get_context('forkserver')
    ctx.set_forkserver_preload(['torch', 'skypilot_torch.parallel',
                                'skypilot_torch.checkpoint', __name__])
    procs = [ctx.Process(target=_entry, args=(r, n, tmp, calls),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        stuck = [p for p in procs if p.is_alive()]
        for p in stuck:
            p.kill()
            p.join(5)
    results = []
    for r in range(n):
        path = os.path.join(tmp, f'rank{r}.pt')
        got = torch.load(path, weights_only=False) if os.path.exists(
            path) else {'error': 'no result'}
        if 'error' in got:
            raise AssertionError(f'rank {r} failed:\n{got["error"]}')
        results.append(got['ok'])
    assert not stuck, f'{len(stuck)} ranks still running after ' \
        f'{JOIN_SECONDS} s'
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results


def blocks(state):
    """{checkpoint key: (window, f32 numpy block)} of a sharded state's
    tensor leaves: the parent reassembles the whole leaves."""
    from skypilot_torch.checkpoint import native
    out = {}
    for key, leaf in native.flatten(state.checkpoint_tree()).items():
        if hasattr(leaf, 'index'):
            data = leaf.data.detach()
            data = data if data.dtype == torch.int8 else data.float()
            out[key] = (leaf.index, data.numpy())
    return out


def _mesh(mesh_kw):
    from skypilot_torch.parallel import mesh as mesh_lib
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))


def mesh_facts(mesh_kw, axes_sets):
    """This rank's coordinate, its index and group ranks for each set
    of axes, and a gather round trip: a [4 n, 3] tensor cut to this
    rank's block over ``('fsdp', 'ep')`` on dim 0 and gathered whole,
    and the block's gradient of ``sum(whole * (rank + 1))``."""
    import torch.distributed as dist
    from skypilot_torch.parallel import sharding
    mesh = _mesh(mesh_kw)
    n = mesh.size(('fsdp', 'ep'))
    full = torch.arange(12 * n, dtype=torch.float32).reshape(4 * n, 3)
    spec = (('fsdp', 'ep'), None)
    block = sharding.local_slice(mesh, spec, full).requires_grad_(True)
    whole = sharding.gather(block, mesh, spec)
    (whole * (dist.get_rank() + 1)).sum().backward()
    return {'coordinate': mesh.coordinate,
            'index': {a: mesh.index(a) for a in axes_sets},
            'groups': {a: dist.get_process_group_ranks(mesh.group(a))
                       for a in axes_sets},
            'gathered_equal': bool(torch.equal(whole.detach(), full)),
            'block_grad': block.grad.numpy(),
            'window': sharding.window(mesh, spec, full.shape)}


def init_blocks(mesh_kw, kind, seed, model='tiny'):
    """This rank's blocks of ``init_train_state`` (``kind`` 'lora',
    'full') or ``init_qlora_state`` ('qlora') over the mesh."""
    from skypilot_torch.models import llama
    from skypilot_torch.parallel import train
    cfg = llama.get_config(model)
    mesh = _mesh(mesh_kw)
    if kind == 'qlora':
        state = train.init_qlora_state(cfg, seed=seed, lora_rank=4,
                                       device='cpu', mesh=mesh)
    else:
        state = train.init_train_state(
            cfg, seed=seed, lora_rank=None if kind == 'full' else 4,
            device='cpu', mesh=mesh)
    return blocks(state)


def restore_blocks(mesh_kw, kind, path, model='tiny'):
    """The latest step under ``path`` restored into this rank's
    ``kind`` template over the mesh: (blocks, ``last_restore``)."""
    from skypilot_torch import checkpoint
    from skypilot_torch.models import llama
    from skypilot_torch.parallel import train
    cfg = llama.get_config(model)
    template = train.init_train_state(
        cfg, seed=0, lora_rank=None if kind == 'full' else 4, device='cpu',
        mesh=_mesh(mesh_kw))
    mgr = checkpoint.NativeCheckpointManager(path, barrier_timeout=30)
    try:
        state, _ = mgr.restore_or(template)
    finally:
        mgr.close()
    assert state.layout is not None
    return blocks(state), mgr.last_restore


def shard_state(state, cfg, mesh):
    """A whole (one-device) train state placed on ``mesh``: every leaf
    cut to this rank's block, the values ``init_train_state(mesh=...)``
    would hold."""
    from skypilot_torch.models import quant
    from skypilot_torch.parallel import sharding, train
    layout = train._layout(cfg, mesh, state.lora is not None,
                           quantized=quant.is_quantized(state.params))

    def cut(tree, specs):
        return None if tree is None else sharding.map_specs(
            lambda _, x, spec: sharding.local_slice(mesh, spec, x),
            tree, specs)

    opt = state.opt_state
    opt_specs = train.opt_state_shardings(layout.trainable)
    return train.TrainState(
        step=state.step, params=cut(state.params, layout.params),
        opt_state=train.AdamState(opt.count, cut(opt.mu, opt_specs['mu']),
                                  cut(opt.nu, opt_specs['nu'])),
        lora=cut(state.lora, layout.lora), layout=layout)


# Overrides of a ``train_steps`` case that go to ``build_train_step``.
STEP_KEYS = ('pipeline_microbatches', 'pipeline_schedule')


def train_steps(mesh_kw, cases, save_dir=None):
    """For each ``(name, state_np, batches)`` case (or ``(name, state_np,
    batches, config overrides)``): the whole state (numpy
    ``params``/``lora`` trees, ``dtype``) placed on the mesh
    ``MeshConfig(**mesh_kw)``, then one ``build_train_step`` step per
    global batch (on ``tiny``, or the overrides' ``model``; with
    per-layer checkpointing where the name ends in ``_remat``; the
    overrides' ``STEP_KEYS`` go to the step). Returns per case the
    losses, grad norms, this rank's blocks after the steps and the
    collectives of the last step. With
    ``save_dir`` each case's last state is saved (step 1) under
    ``save_dir/<name>``, every rank writing its part."""
    from skypilot_torch.models import convert, llama
    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import sharding, train
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))
    out = {}
    for name, state_np, batches, *kw in cases:
        kw = dict(kw[0]) if kw else {}
        step_kw = {k: kw.pop(k) for k in STEP_KEYS if k in kw}
        cfg = llama.get_config(kw.pop('model', 'tiny'),
                               remat=name.endswith('_remat'), **kw)
        whole = convert.train_state_from_numpy(
            state_np['params'], state_np['lora'], state_np['dtype'],
            device='cpu')
        state = shard_state(whole, cfg, mesh)
        step = train.build_train_step(cfg, mesh=mesh, **step_kw)
        metrics = []
        for batch in batches:
            sharding.COLLECTIVES.reset()
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
            metrics.append((m['loss'].item(), m['grad_norm'].float().item()))
        out[name] = {'metrics': metrics, 'blocks': blocks(state),
                     'collectives': sharding.COLLECTIVES.counts()}
        if save_dir is not None:
            from skypilot_torch import checkpoint
            mgr = checkpoint.NativeCheckpointManager(
                f'{save_dir}/{name}', barrier_timeout=30)
            try:
                mgr.save(1, state)
                mgr.wait()
            finally:
                mgr.close()
    return out


def tp_primitives(n_rows=4, n_in=6, n_out=8, seed=0):
    """Megatron's *f* and *g* over this rank's ``tp`` group (the mesh
    ``tp`` = world): a column-parallel product ``f(x) @ W[:, cols]`` and
    a row-parallel one ``g(X[:, cols] @ W2[cols])`` on the same seeded
    tensors on every rank, each loss ``sum(y * c)`` with ``c`` cut like
    ``y``. Returns the rank's outputs and gradients, its window and the
    collectives each pass issued."""
    import torch.distributed as dist
    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import sharding
    tp = dist.get_world_size()
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=tp))
    layout = sharding.Layout(mesh, {})
    gen = torch.Generator().manual_seed(seed)
    x, w, c = (torch.randn(s, generator=gen) for s in (
        (n_rows, n_in), (n_in, n_out), (n_rows, n_out)))
    big_x, w2, c2 = (torch.randn(s, generator=gen) for s in (
        (n_rows, n_out), (n_out, n_in), (n_rows, n_in)))
    r, k = layout.tp_index, n_out // tp
    cols = slice(r * k, (r + 1) * k)
    out = {'cols': (cols.start, cols.stop)}
    x = x.requires_grad_(True)
    w_r = w[:, cols].clone().requires_grad_(True)
    sharding.COLLECTIVES.reset()
    y = layout.copy_to_tp(x) @ w_r
    out['f_forward'] = sharding.COLLECTIVES.counts()['tp_reduces']
    (y * c[:, cols]).sum().backward()
    out['f_backward'] = sharding.COLLECTIVES.counts()['tp_reduces'] - \
        out['f_forward']
    out.update(col_y=y.detach(), col_dx=x.grad, col_dw=w_r.grad)
    x_r = big_x[:, cols].clone().requires_grad_(True)
    w2_r = w2[cols].clone().requires_grad_(True)
    sharding.COLLECTIVES.reset()
    y2 = layout.reduce_from_tp(x_r @ w2_r)
    out['g_forward'] = sharding.COLLECTIVES.counts()['tp_reduces']
    (y2 * c2).sum().backward()
    out['g_backward'] = sharding.COLLECTIVES.counts()['tp_reduces'] - \
        out['g_forward']
    out.update(row_y=y2.detach(), row_dx=x_r.grad, row_dw=w2_r.grad)
    return out


def moe_aux(mesh_kw, params_np, tokens):
    """``tiny-moe``'s whole numpy params cut to this rank's blocks on the
    mesh: ``forward_hidden(with_aux=True, layout=)`` on this rank's rows
    of the global ``tokens``. Returns the rank's aux share and the
    exchanges it issued."""
    from skypilot_torch.models import convert, llama
    from skypilot_torch.parallel import sharding, train
    cfg = llama.get_config('tiny-moe')
    mesh = _mesh(mesh_kw)
    layout = train._layout(cfg, mesh, False)
    params = sharding.map_specs(
        lambda _, x, spec: sharding.local_slice(mesh, spec, x),
        convert.params_from_numpy(params_np, cfg, device='cpu'),
        layout.params)
    rows = layout.local_batch({'t': torch.from_numpy(tokens)})['t']
    sharding.COLLECTIVES.reset()
    with torch.no_grad():
        _, aux = llama.forward_hidden(params, rows, cfg, with_aux=True,
                                      layout=layout)
    return {'aux': aux.item(), 'collectives': sharding.COLLECTIVES.counts()}


def serve_ranks(mesh_kw, params_np, prompt, n_new, cfg_kw=None,
                model='tiny'):
    """The whole numpy params cut to this rank's blocks on the mesh
    ``MeshConfig(**mesh_kw)``; ``forward_cached(layout=)`` on the prompt
    (prefill), then one decode step, and ``greedy_generate(layout=)``.
    Returns this rank's vocabulary window, both logits (its columns),
    the ids and each call's ``tp`` all-reduces."""
    from skypilot_torch.models import convert, decode, llama
    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import sharding
    cfg = llama.get_config(model, **(cfg_kw or {}))
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))
    layout = decode.serving_layout(cfg, mesh)
    params = sharding.map_specs(
        lambda _, x, spec: sharding.local_slice(mesh, spec, x),
        convert.params_from_numpy(params_np, cfg, device='cpu'),
        layout.params)
    tokens = torch.tensor(prompt, dtype=torch.long)
    out = {'window': layout.vocab_window(cfg.vocab_size)}
    with torch.inference_mode():
        cache = decode.init_cache(cfg, tokens.shape[0], 64, device='cpu',
                                  layout=layout)
        out['cache_heads'] = cache.k.shape[3]
        sharding.COLLECTIVES.reset()
        logits, cache = decode.forward_cached(params, tokens, cache, cfg,
                                              prefill=True, layout=layout)
        out['prefill_tp_reduces'] = sharding.COLLECTIVES.tp_reduces
        step = decode.greedy_token(logits[:, -1], layout)
        out['first'] = step
        step_logits, _ = decode.forward_cached(params, step[:, None], cache,
                                               cfg, layout=layout)
        sharding.COLLECTIVES.reset()
        out['ids'] = decode.greedy_generate(params, tokens, cfg, n_new,
                                            max_seq=64, layout=layout)
        out['generate_tp_reduces'] = sharding.COLLECTIVES.tp_reduces
    out.update(prefill=logits, step=step_logits)
    return out


def ring_rank(q, k, v, dout):
    """Ring attention over the ``sp = world`` group on this rank's
    positions of the whole numpy q, k, v ``[B, T, H(kv), D]``: its out
    and the gradients of ``sum(out * dout)`` for its q, k and v, with the
    kernels' launches and the point-to-point counts of the call."""
    import torch.distributed as dist
    from skypilot_torch.ops import ring_attention
    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import sharding
    n = dist.get_world_size()
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(sp=n))
    t = q.shape[1] // n
    at = slice(mesh.coordinate['sp'] * t, (mesh.coordinate['sp'] + 1) * t)
    ql, kl, vl = (torch.from_numpy(np_x[:, at].copy()).requires_grad_(True)
                  for np_x in (q, k, v))
    sharding.COLLECTIVES.reset()
    out = ring_attention.ring_attention(ql, kl, vl, mesh.group(('sp',)))
    forward = sharding.COLLECTIVES.counts()
    (out * torch.from_numpy(dout[:, at].copy())).sum().backward()
    return {'window': (at.start, at.stop), 'out': out.detach().numpy(),
            'dq': ql.grad.numpy(), 'dk': kl.grad.numpy(),
            'dv': vl.grad.numpy(), 'forward': forward,
            'total': sharding.COLLECTIVES.counts()}


def moe_row_slots(h, router, k, cap):
    """The MoE routing of this rank's ``sp = world`` shard of the whole
    numpy ``h [B, T, D]`` over ``router [D, E]``: (idx, slot) with slots
    in the whole rows (``llama._row_slots``), -1 where dropped."""
    import torch.distributed as dist
    from skypilot_torch.models import llama
    from skypilot_torch.ops import moe_route
    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import sharding
    n = dist.get_world_size()
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(sp=n))
    layout = sharding.Layout(mesh, {})
    t = h.shape[1] // n
    hl = torch.from_numpy(h[:, layout.sp_index * t:
                            (layout.sp_index + 1) * t].copy())
    idx, _, slot, _ = moe_route.route_for_training(
        hl, torch.from_numpy(router), k, t)
    slot = llama._row_slots(layout, idx, slot, router.shape[1], cap)
    return idx.numpy(), slot.numpy()


def pipeline_kept(n_layers, micro):
    """The 1F1B rounds of a full step of ``tiny`` at ``n_layers`` over
    ``pp = world`` and ``micro`` microbatches of one row, as
    ``build_train_step`` runs them: the most stage inputs this rank kept
    at once (``pipeline._one_f_one_b``'s result)."""
    import torch.distributed as dist
    from skypilot_torch.models import llama
    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import pipeline, train
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(pp=dist.get_world_size()))
    cfg = llama.get_config('tiny', n_layers=n_layers)
    state = train.init_train_state(cfg, seed=0, device='cpu', mesh=mesh)
    tokens = torch.randint(0, cfg.vocab_size, (micro, 17),
                           generator=torch.Generator().manual_seed(0))
    layout = state.layout
    batch = layout.local_batch({'tokens': tokens}, micro)
    layout.make_groups()
    leaves = [(p, x.detach().requires_grad_(True))
              for p, x in train._leaves(state.params)]
    stage = pipeline._Stage(cfg, train._tree(leaves), None, batch, layout,
                            micro, 2.0, [x for _, x in leaves])
    return pipeline._one_f_one_b(stage, mesh.group(('pp',)), cfg.dtype,
                                 tokens.device)
