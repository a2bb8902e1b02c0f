"""The port's MoE (skypilot_torch/models/llama.py ``_moe_mlp``, the
routing function ``ops/moe_route.py``, the serving form
``models/decode.moe_mlp`` through ``forward_cached``, ``greedy_generate``
and the paged engine, the int8 expert stacks of ``models/quant.py``)
against the JAX package on the CPU at ``tiny-moe`` in f32, on JAX's
weights carried across by ``convert`` and numpy-seeded inputs.

Tolerances, each from the arithmetic that differs:

- ``_moe_mlp`` outputs and aux: f32 summation order of the router dot,
  the softmax and the expert einsums only; rtol 1e-5 (outputs also atol
  1e-6, since a dropped token's output is an exact 0 on both sides);
- expert indices, capacity slots and the drop pattern: equal;
- loss and LoRA gradients, and one LoRA train step: test_torch_train.py's
  (rtol 1e-6 on the loss, 2e-5 of each leaf's largest entry on the
  gradients; one step's loss and grad norm rtol 1e-5, params atol 1e-4);
- logits: rtol and atol 1e-5, as test_torch_train.py's forward;
- greedy tokens: equal; int8 codes and scales: bit-equal.

No test here materializes mixtral-8x7b's weights (93 GB in bf16): its
counts are config arithmetic.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.models import quant as jquant
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import train as jtrain
from skypilot_tpu.serve import batching as jbatching
from skypilot_torch.models import convert
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.models import quant as tquant
from skypilot_torch.ops import moe_route
from skypilot_torch.parallel import train as ttrain
from skypilot_torch.recipes import serve_model
from skypilot_torch.serve import batching as tbatching

MLP_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_TOL = 2e-5


def _np(tree):
    return jax.tree.map(
        lambda x: np.asarray(x) if x.dtype == jnp.int8
        else np.asarray(x.astype(jnp.float32)), tree)


def _configs(**kw):
    return (jllama.get_config('tiny-moe', **kw),
            tllama.get_config('tiny-moe', **kw))


@pytest.fixture(scope='module')
def moe():
    jcfg, tcfg = _configs()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = _np(jp)
    return jcfg, tcfg, jp, convert.params_from_numpy(tree, tcfg, 'cpu')


def _hidden(rng, b, t, d):
    return rng.standard_normal((b, t, d)).astype(np.float32)


def _jax_route(h, router, config):
    """The router and capacity of the JAX ``_moe_mlp``, step for step:
    expert indices [B, T, k] and each (token, choice)'s slot, -1 where
    ``keep`` drops it."""
    b, t, _ = h.shape
    E, k = config.n_experts, config.moe_top_k
    logits = h.astype(jnp.float32) @ router.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    sel = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    cap = min(int(np.ceil(k * t * config.moe_capacity_factor / E)), t)
    sel_flat = sel.reshape(b, t * k, E)
    pos = (jnp.cumsum(sel_flat, axis=1) - sel_flat).astype(jnp.int32)
    keep = sel_flat * (pos < cap)
    slot = jnp.where(keep.sum(-1) > 0, (pos * sel_flat).sum(-1).astype(
        jnp.int32), -1)
    return (np.asarray(idx), np.asarray(gate),
            np.asarray(slot).reshape(b, t, k))


@pytest.mark.parametrize('cf,drops', [(2.0, False), (0.5, True)],
                         ids=['no-drops', 'drops'])
def test_moe_mlp_matches_jax(moe, cf, drops):
    jcfg, tcfg, jp, tp = moe
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    h = _hidden(np.random.default_rng(1), 3, 24, jcfg.dim)
    jl = {k: v[0] for k, v in jp['layers'].items()}
    tl = {k: v[0] for k, v in tp['layers'].items()}
    want, want_aux = jllama._moe_mlp(jcfg, jnp.asarray(h), jl)
    got, aux = tllama._moe_mlp(tcfg, torch.from_numpy(h), tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MLP_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    _, _, jslot = _jax_route(jnp.asarray(h), jl['router'], jcfg)
    cap = tllama.moe_capacity(tcfg, 24)
    _, _, tslot = moe_route.moe_route(torch.from_numpy(h), tl['router'],
                                      tcfg.moe_top_k, cap)
    np.testing.assert_array_equal(tslot.numpy() < 0, jslot < 0)
    assert bool((jslot < 0).any()) == drops
    # The serving form (routing kernel's plain version, dispatch buffer,
    # per-expert products, f32 combine) gives the same output.
    serve = tdecode.moe_mlp(tcfg, torch.from_numpy(h), tl)
    np.testing.assert_allclose(serve.numpy(), np.asarray(want), **MLP_TOL)


@pytest.mark.parametrize('shape,cf', [((1, 64), 2.0), ((4, 9), 0.5),
                                      ((8, 1), 2.0), ((2, 33), 1.0)])
def test_route_indices_and_slots_match_jax(moe, shape, cf):
    jcfg, tcfg, jp, tp = moe
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
    b, t = shape
    h = _hidden(np.random.default_rng(b * 100 + t), b, t, jcfg.dim)
    router = np.array(jp['layers']['router'][1])
    jidx, jgate, jslot = _jax_route(jnp.asarray(h), jnp.asarray(router),
                                    jcfg)
    cap = tllama.moe_capacity(dataclasses.replace(
        tcfg, moe_capacity_factor=cf), t)
    idx, gate, slot = moe_route.moe_route(
        torch.from_numpy(h), torch.from_numpy(router), jcfg.moe_top_k, cap)
    assert idx.dtype == torch.int32 and slot.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_allclose(gate.numpy(), jgate, rtol=1e-5)


def _jax_router(h, router, k):
    """JAX ``_moe_mlp``'s f32 router up to the normalized gates: (gate
    [B, T, k], probs [B, T, E]) as functions of h and the router."""
    logits = h.astype(jnp.float32) @ router.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, _ = jax.lax.top_k(probs, k)
    return gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9), probs


@pytest.mark.parametrize('case', ['random', 'near-tie-overflow'])
def test_router_backward_matches_jax_vjp(moe, case):
    """The router's backward (``moe_route_bwd``'s plain version, then
    the router product) against ``jax.vjp`` of JAX's router at random
    gate and probability cotangents; the Function (on the CPU: the
    kernels' plain versions) and the plain autograd chain give the same.
    ``near-tie-overflow``: expert 3's router column is expert 1's plus
    1e-4 noise and the capacity is 2, so choices overflow. Gradients
    within 1e-5 of each leaf's largest entry (f32 sums in another
    order); idx and slots equal."""
    jcfg, tcfg, jp, _ = moe
    rng = np.random.default_rng(21)
    b, t, k = 2, 12, jcfg.moe_top_k
    h = _hidden(rng, b, t, jcfg.dim)
    router = np.array(jp['layers']['router'][0])
    cap = 6
    if case != 'random':
        router[:, 3] = router[:, 1] + 1e-4 * rng.standard_normal(jcfg.dim)
        cap = 2
    dgate = rng.standard_normal((b, t, k)).astype(np.float32)
    dprobs = rng.standard_normal((b, t, jcfg.n_experts)).astype(np.float32)
    (jgate, jprobs), vjp = jax.vjp(
        lambda x, r: _jax_router(x, r, k), jnp.asarray(h),
        jnp.asarray(router))
    jdh, jdr = vjp((jnp.asarray(dgate), jnp.asarray(dprobs)))
    _, _, jslot = _jax_route(jnp.asarray(h), jnp.asarray(router),
                             dataclasses.replace(
                                 jcfg, moe_capacity_factor=cap * jcfg.n_experts
                                 / (k * t)))
    th, tr = torch.from_numpy(h), torch.from_numpy(router)
    routes = {'function': lambda x, r: moe_route._RouteForTraining.apply(
        x, r, k, cap), 'plain': lambda x, r: moe_route.route_for_training(
            x, r, k, cap)}
    for name, route in routes.items():
        x, r = th.clone().requires_grad_(True), tr.clone().requires_grad_(
            True)
        idx, gate, slot, probs = route(x, r)
        np.testing.assert_array_equal(slot.numpy(), jslot)
        np.testing.assert_allclose(gate.detach().numpy(), np.asarray(jgate),
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(probs.detach().numpy(),
                                   np.asarray(jprobs), rtol=1e-5, atol=1e-7)
        ((gate * torch.from_numpy(dgate)).sum() +
         (probs * torch.from_numpy(dprobs)).sum()).backward()
        for got, want in ((x.grad, jdh), (r.grad, jdr)):
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (name, err)
    # The backward kernel's plain version alone, with no dprobs.
    dl, dh = moe_route.moe_route_bwd(probs.detach(), idx,
                                     torch.from_numpy(dgate), None, tr,
                                     torch.float32)
    (_, _), vjp = jax.vjp(lambda x: _jax_router(x, jnp.asarray(router), k),
                          jnp.asarray(h))
    (want,) = vjp((jnp.asarray(dgate), jnp.zeros_like(jprobs)))
    want = np.asarray(want)
    assert np.abs(dh.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert dl.shape == (b, t, jcfg.n_experts)


def test_route_ties_go_to_the_lower_expert(moe):
    """Experts 1 and 3 carry the same router column, so every token's
    probabilities tie exactly between them: ``lax.top_k`` keeps the
    lower index first, and so does the port."""
    jcfg, _, jp, _ = moe
    router = np.asarray(jp['layers']['router'][0]).copy()
    router[:, 3] = router[:, 1]
    router[:, 0] = router[:, 1]            # a three-way tie
    h = _hidden(np.random.default_rng(5), 2, 16, jcfg.dim)
    jidx, _, jslot = _jax_route(jnp.asarray(h), jnp.asarray(router), jcfg)
    idx, _, slot = moe_route.moe_route(
        torch.from_numpy(h), torch.from_numpy(router), jcfg.moe_top_k,
        tllama.moe_capacity(tllama.get_config('tiny-moe'), 16))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(slot.numpy(), jslot)


def test_capacity_matches_the_jax_expression():
    for name in ('tiny-moe', 'mixtral-8x7b'):
        for cf in (0.5, 1.0, 1.25, 2.0, 4.0):
            cfg = tllama.get_config(name, moe_capacity_factor=cf)
            for t in (1, 3, 7, 64, 100, 128, 512):
                want = min(int(np.ceil(cfg.moe_top_k * t * cf /
                                       cfg.n_experts)), t)
                assert tllama.moe_capacity(cfg, t) == want


@pytest.mark.parametrize('lora', [False, True], ids=['full', 'lora'])
def test_loss_and_grads_match_jax(moe, lora):
    """``loss_fn`` with the aux term, and its gradients (every leaf of the
    full tree, router and expert stacks included; or the LoRA factors)."""
    jcfg, tcfg, jp, _ = moe
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    jbatch = {'tokens': jnp.asarray(tokens)}
    tbatch = {'tokens': torch.from_numpy(tokens)}
    tp = convert.params_from_numpy(_np(jp), tcfg, device='cpu')
    if lora:
        L, d = jcfg.n_layers, jcfg.dim
        lo = {'wq_a': rng.standard_normal((L, d, 8)) / np.sqrt(d),
              'wq_b': rng.standard_normal((L, 8, d)) * 0.05,
              'wv_a': rng.standard_normal((L, d, 8)) / np.sqrt(d),
              'wv_b': rng.standard_normal((L, 8, jcfg.n_kv_heads *
                                           jcfg.head_dim)) * 0.05}
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
    want = _np(jgrads)
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(ttrain._leaves(trainable))
    for path, ref in flat:
        leaf = trainable
        for key in path:
            leaf = leaf[key.key]
        err = np.abs(leaf.grad.numpy() - ref).max()
        assert err <= GRAD_REL_TOL * np.abs(ref).max(), (path, err)


def test_forward_hidden_returns_the_layer_mean_aux(moe):
    jcfg, tcfg, jp, tp = moe
    tokens = np.random.default_rng(3).integers(0, 512, (2, 20)).astype(
        np.int32)
    jh, jaux = jllama.forward_hidden(jp, jnp.asarray(tokens), jcfg,
                                     with_aux=True)
    th, taux = tllama.forward_hidden(tp, torch.from_numpy(tokens), tcfg,
                                     with_aux=True)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               **LOGIT_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    # A dense config's aux is exactly 0.
    dense = tllama.get_config('tiny')
    _, zero = tllama.forward_hidden(
        tllama.init_params(dense, device='cpu'),
        torch.from_numpy(tokens), dense, with_aux=True)
    assert zero.item() == 0.0


def test_lora_train_step_matches_jax():
    """One LoRA step of the port's ``build_train_step`` against the JAX
    step on a 1-device CPU mesh, from the same converted state."""
    jcfg, tcfg = _configs()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(), devices=jax.devices()[:1])
    jstate, shardings = jtrain.init_train_state(
        jcfg, mesh, jax.random.PRNGKey(0), param_dtype=jnp.float32,
        lora_rank=8)
    jstep = jtrain.build_train_step(jcfg, mesh, shardings, donate=False)
    tstate = convert.train_state_from_numpy(
        _np(jstate.params), _np(jstate.lora), torch.float32, device='cpu')
    tstep = ttrain.build_train_step(tcfg)
    tokens = np.random.default_rng(7).integers(0, 512, (2, 33)).astype(
        np.int32)
    jstate, jm = jstep(jstate, {'tokens': jnp.asarray(tokens)})
    tstate, tm = tstep(tstate, {'tokens': torch.from_numpy(tokens)})
    np.testing.assert_allclose(tm['loss'].item(), float(jm['loss']),
                               rtol=1e-5)
    np.testing.assert_allclose(tm['grad_norm'].item(),
                               float(jm['grad_norm']), rtol=1e-5)
    got = convert.train_state_to_numpy(tstate)['lora']
    for name, ref in _np(jstate.lora).items():
        np.testing.assert_allclose(got[name], ref, rtol=0, atol=1e-4)


def test_moe_training_on_cuda_names_the_roadmap_item(moe, monkeypatch):
    """A CUDA MoE forward for training routes through the kernels'
    Function (``moe_route`` with its probabilities forward,
    ``moe_route_bwd`` backward), never the plain autograd chain, and the
    kernels' wrappers raise on what they do not take. The tensors here
    are on the CPU, so the card is stood in for: ``_on_card`` says yes,
    and each wrapper's launch is replaced by its plain version,
    recorded."""
    jcfg, tcfg, jp, tp = moe
    calls = []

    def fwd(h, router, k, cap, with_probs=False):
        calls.append(('moe_route', with_probs))
        return moe_route._route_plain(h, router, k, cap)

    def bwd(*args):
        calls.append(('moe_route_bwd',))
        return moe_route._moe_route_bwd_plain(*args)

    def plain(*_):
        raise AssertionError('the plain chain ran for a card tensor')
    monkeypatch.setattr(moe_route, '_on_card', lambda x: True)
    monkeypatch.setattr(moe_route, '_moe_route_cuda', fwd)
    monkeypatch.setattr(moe_route, '_moe_route_bwd_cuda', bwd)
    monkeypatch.setattr(moe_route, '_route_train_plain', plain)
    h = torch.from_numpy(_hidden(np.random.default_rng(2), 2, 16,
                                 tcfg.dim)).requires_grad_(True)
    layer = {k: v[0].detach().clone().requires_grad_(True)
             for k, v in tp['layers'].items()}
    out, aux = tllama._moe_mlp(tcfg, h, layer)
    (out.square().sum() + aux).backward()
    assert calls == [('moe_route', True), ('moe_route_bwd',)]
    assert h.grad is not None and layer['router'].grad is not None
    monkeypatch.undo()
    # The wrappers' refusals, checked before anything reaches the card.
    bf = torch.zeros((1, 4, 64), dtype=torch.bfloat16)
    r8 = torch.zeros((64, 8), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match='bf16 h'):
        moe_route._moe_route_cuda(bf.float(), r8, 2, 4)
    with pytest.raises(ValueError, match='E 3'):
        moe_route._moe_route_cuda(bf, r8[:, :3], 2, 4)
    with pytest.raises(ValueError, match='k 9'):
        moe_route._moe_route_cuda(bf, torch.zeros((64, 16),
                                                  dtype=torch.bfloat16), 9, 4)
    probs = torch.full((1, 4, 8), 0.125)
    idx = torch.zeros((1, 4, 2), dtype=torch.int32)
    with pytest.raises(TypeError, match='moe_route_bwd'):
        moe_route._moe_route_bwd_cuda(probs, idx, torch.zeros(1, 4, 2),
                                      None, r8, torch.float32)
    with pytest.raises(ValueError, match='E 3'):
        moe_route._moe_route_bwd_cuda(probs[..., :3], idx,
                                      torch.zeros(1, 4, 2), None, r8[:, :3],
                                      torch.bfloat16)


@pytest.mark.parametrize('quantized', [False, True], ids=['f32', 'int8'])
def test_forward_cached_prefill_matches_jax_forward(moe, quantized):
    jcfg, tcfg, jp, _ = moe
    if quantized:
        jp = jquant.quantize_params(jp, jcfg)
    tp = convert.params_from_numpy(_np(jp), tcfg, device='cpu')
    tokens = np.random.default_rng(8).integers(0, 512, (2, 24)).astype(
        np.int32)
    want = jllama.forward(jp, jnp.asarray(tokens), jcfg)
    cache = tdecode.init_cache(tcfg, 2, 32, device='cpu')
    got, cache = tdecode.forward_cached(tp, torch.from_numpy(tokens), cache,
                                        tcfg, prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert cache.pos == 24
    # The steps after it (a 3-token chunk, then one token) against JAX's
    # cached forward over the same cache.
    jcache = jdecode.init_cache(jcfg, 2, 32)
    _, jcache = jdecode.forward_cached(jp, jnp.asarray(tokens), jcache,
                                       jcfg, prefill=True)
    more = np.random.default_rng(9).integers(0, 512, (2, 4)).astype(
        np.int32)
    for sl in (slice(0, 3), slice(3, 4)):
        want, jcache = jdecode.forward_cached(jp, jnp.asarray(more[:, sl]),
                                              jcache, jcfg)
        got, cache = tdecode.forward_cached(
            tp, torch.from_numpy(more[:, sl]), cache, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)


@pytest.mark.parametrize('kv_int8', [False, True], ids=['kv-f32', 'kv-int8'])
def test_greedy_and_engine_tokens_match_jax(moe, kv_int8):
    """The twin of the JAX package's MoE engine test: the port's
    ``greedy_generate`` and its paged engine give JAX's greedy tokens,
    with chunked prefill and speculation on; nothing drops at tiny-moe's
    capacity factor."""
    jcfg, tcfg, jp, tp = moe
    prompts = [[7, 3, 5], [(i * 7) % 500 + 1 for i in range(21)],
               [1, 2, 3, 1, 2, 3, 1, 2]]
    want = [np.asarray(jdecode.greedy_generate(
        jp, jnp.asarray([p], jnp.int32), jcfg, 10, max_seq=64,
        kv_int8=kv_int8))[0].tolist() for p in prompts]
    got = [tdecode.greedy_generate(tp, torch.tensor([p]), tcfg, 10,
                                   max_seq=64, kv_int8=kv_int8)[0].tolist()
           for p in prompts]
    assert got == want
    kw = dict(slots=2, max_seq=64, steps_per_dispatch=3, block_size=8,
              prefill_chunk=8, max_num_batched_tokens=16, kv_int8=kv_int8)
    jeng = jbatching.BatchingEngine(jp, jcfg, **kw)
    teng = tbatching.BatchingEngine(tp, tcfg, **kw)
    try:
        jq = [jeng.submit(p, 10) for p in prompts]
        tq = [teng.submit(p, 10) for p in prompts]
        jtoks = [_drain(q) for q in jq]
        ttoks = [_drain(q) for q in tq]
    finally:
        jeng.close()
        teng.close()
    assert ttoks == jtoks
    if not kv_int8:
        # Single-chunk prompts equal greedy_generate (the JAX engine
        # test's contract; int8 KV across chunks only tracks it).
        assert ttoks[0] == want[0]


def test_device_steps_match_jax(moe):
    """``decode_steps_rows``, ``decode_steps_paged`` and
    ``verify_step_paged`` on tiny-moe against the JAX steps from the same
    prefilled caches: tokens, positions and acceptances equal, the K/V
    written within 1e-5 (rows 0 and 1 live, row 2 parked)."""
    jcfg, tcfg, jp, tp = moe
    bs, nl, b = 8, jcfg.n_layers, 3
    prompts = jnp.asarray([[1, 2, 3, 4], [9, 8, 7, 6], [5, 5, 5, 5]],
                          jnp.int32)
    cache = jdecode.init_cache(jcfg, b, max_seq=32)
    logits, cache = jdecode.forward_cached(jp, prompts, cache, jcfg, True)
    first = np.asarray(logits[:, -1].argmax(-1).astype(jnp.int32))
    dk, dv = np.asarray(cache.k), np.asarray(cache.v)
    tail = dk.shape[3:]
    # Block 0 is scratch; row r holds blocks 4 r + 1 .. 4 r + 4.
    pool = [np.concatenate([np.zeros((nl, 1, bs) + tail, np.float32),
                            x.reshape(nl, b * 4, bs, *tail)], 1)
            for x in (dk, dv)]
    tables = np.arange(1, 13, dtype=np.int32).reshape(b, 4)
    pos = np.asarray([4, 4, 32], np.int32)
    active = np.asarray([True, True, False])

    def both(x):
        return jnp.asarray(x), torch.from_numpy(np.array(x))
    (jf, tf), (jt, tt), (jpos, tpos), (ja, ta) = map(
        both, (first, tables, pos, active))
    jcache = tuple(jnp.asarray(x) for x in pool) + (None, None)
    tcache = tuple(torch.from_numpy(x.copy()) for x in pool) + (None, None)
    want, jc, want_pos = jbatching.decode_steps_paged(
        jp, jf, jcache, jt, jpos, ja, jcfg, 4, bs)
    got, tc, got_pos = tbatching.decode_steps_paged(
        tp, tf, tcache, tt, tpos, ta, tcfg, 4, bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    for g, w in zip(tc[:2], jc[:2]):
        np.testing.assert_allclose(g.numpy()[:, 1:], np.asarray(w)[:, 1:],
                                   rtol=1e-5, atol=1e-5)
    jrows = jbatching.decode_steps_rows(
        jp, jf, (jnp.asarray(dk), jnp.asarray(dv), None, None), jpos, ja,
        jcfg, 4)
    trows = tbatching.decode_steps_rows(
        tp, tf, (torch.from_numpy(dk.copy()), torch.from_numpy(dv.copy()),
                 None, None), tpos, ta, tcfg, 4)
    np.testing.assert_array_equal(trows[0].numpy(), np.asarray(jrows[0]))
    toks = np.concatenate([first[:, None], np.asarray(want)[:, :3]],
                          1).astype(np.int32)
    n_real = np.asarray([4, 2, 0], np.int32)
    jcache = tuple(jnp.asarray(x) for x in pool) + (None, None)
    tcache = tuple(torch.from_numpy(x.copy()) for x in pool) + (None, None)
    jout = jbatching.verify_step_paged(
        jp, jnp.asarray(toks), jcache, jt, jpos, jnp.asarray(n_real), jcfg,
        4, bs)
    tout = tbatching.verify_step_paged(
        tp, torch.from_numpy(toks), tcache, tt, tpos,
        torch.from_numpy(n_real), tcfg, 4, bs)
    live = n_real > 0
    np.testing.assert_array_equal(tout[0].numpy()[live],
                                  np.asarray(jout[0])[live])
    for g, w in zip(tout[1:4], jout[1:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tout[1].tolist() == [3, 1, 0]


def _drain(q, timeout=120):
    toks = []
    while True:
        t = q.get(timeout=timeout)
        if t is None:
            return toks
        assert not isinstance(t, BaseException), t
        toks.append(int(t))


def test_engine_speculation_on_equals_off():
    """A vocab-restricted tiny-moe loops quickly, so drafts verify: with
    capacity T (no drops) every request's tokens equal its run with
    speculation off and ``greedy_generate``'s."""
    cfg = dataclasses.replace(
        tllama.get_config('tiny-moe'), vocab_size=16,
        moe_capacity_factor=2.0)
    params = tllama.init_params(cfg, seed=1, device='cpu')
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8]]
    kw = dict(slots=2, max_seq=64, steps_per_dispatch=3, block_size=8,
              prefill_chunk=8, max_num_batched_tokens=16)
    outs = {}
    for spec in (True, False):
        eng = tbatching.BatchingEngine(params, cfg, speculative=spec, **kw)
        try:
            outs[spec] = [_drain(q) for q in
                          [eng.submit(p, 24) for p in prompts]]
            if spec:
                assert any(e[0] == 'verify' for e in eng.events)
        finally:
            eng.close()
    assert outs[True] == outs[False]
    for p, got in zip(prompts, outs[False]):
        assert got == tdecode.greedy_generate(
            params, torch.tensor([p]), cfg, 24, max_seq=64)[0].tolist()


def test_quantize_params_experts_bit_equal_to_jax(moe):
    jcfg, tcfg, jp, tp = moe
    want = _np(jquant.quantize_params(jp, jcfg))
    got = convert.params_to_numpy(tquant.quantize_params(tp, tcfg))
    for name in ('w_gate', 'w_up', 'w_down'):
        assert got['layers'][name]['q'].shape == (2, 4) + tuple(
            tp['layers'][name].shape[-2:])
        assert got['layers'][name]['s'].shape == (2, 4, 1, tp['layers'][
            name].shape[-1])
        for part in ('q', 's'):
            np.testing.assert_array_equal(got['layers'][name][part],
                                          want['layers'][name][part])
    assert not isinstance(got['layers']['router'], dict)
    np.testing.assert_array_equal(got['layers']['router'],
                                  want['layers']['router'])
    streamed = convert.params_to_numpy(
        tquant.quantize_params_streamed(tp, tcfg, device='cpu'))
    for name in ('w_gate', 'w_up', 'w_down'):
        for part in ('q', 's'):
            np.testing.assert_array_equal(streamed['layers'][name][part],
                                          want['layers'][name][part])


def test_init_quantized_equals_quantize_params_of_init_params():
    cfg = tllama.get_config('tiny-moe', dtype=torch.bfloat16)
    wide = tllama.init_params(cfg, seed=3, device='cpu')
    want = tquant.quantize_params(wide, cfg)
    got = tquant.init_quantized(cfg, seed=3, device='cpu')
    assert set(got['layers']) == set(want['layers'])
    for name, leaf in got['layers'].items():
        ref = want['layers'][name]
        if isinstance(ref, dict):
            assert torch.equal(leaf['q'], ref['q'])
            assert torch.equal(leaf['s'], ref['s'])
        else:
            assert torch.equal(leaf, ref)
    assert got['layers']['router'].dtype == torch.bfloat16


def test_mixtral_counts_equal_jax():
    """Config arithmetic only: nothing is materialized."""
    for name in ('mixtral-8x7b', 'tiny-moe', 'llama3-8b'):
        j = jllama.get_config(name)
        t = tllama.get_config(name)
        assert t.num_params() == j.num_params()
        assert t.num_active_params() == j.num_active_params()
    assert tllama.get_config('mixtral-8x7b').num_params() > 46 * 10 ** 9


def test_convert_carries_the_moe_keys(moe):
    jcfg, tcfg, jp, tp = moe
    assert tp['layers']['router'].shape == (2, 128, 4)
    back = convert.params_to_numpy(tp)
    for name, leaf in _np(jp)['layers'].items():
        np.testing.assert_array_equal(back['layers'][name], leaf)
    jq = _np(jquant.quantize_params(jp, jcfg))
    tq = convert.params_from_numpy(jq, tcfg, device='cpu')
    assert tq['layers']['w_up']['q'].dtype == torch.int8
    assert tq['layers']['w_up']['s'].dtype == torch.bfloat16
    np.testing.assert_array_equal(tq['layers']['w_up']['q'].numpy(),
                                  jq['layers']['w_up']['q'])


def test_replica_refuses_wide_mixtral_before_allocating():
    """bf16 mixtral-8x7b (93 GB) is refused on one card; int8 on one
    card and bf16 at ``--tp 2`` (46.7 GB a rank) are taken."""
    with pytest.raises(SystemExit):
        serve_model.parse_args(['--model', 'mixtral-8x7b', '--device',
                                'cpu'])
    args = serve_model.parse_args(['--model', 'mixtral-8x7b', '--quant',
                                   'int8', '--device', 'cpu'])
    assert args.quant == 'int8'
    args = serve_model.parse_args(['--model', 'mixtral-8x7b', '--tp', '2',
                                   '--device', 'cpu'])
    assert args.tp == 2 and args.quant != 'int8'


def test_replica_serves_tiny_moe_from_a_checkpoint(moe, tmp_path):
    """The warm start carries the MoE keys: a tiny-moe TrainState saved
    by the port's checkpoint manager serves the tokens of the same
    weights, engine-off and on the engine, wide and int8."""
    from skypilot_torch.data.checkpoint import CheckpointManager
    jcfg, tcfg, jp, tp = moe
    state = ttrain.TrainState(step=0, params=tp, opt_state=ttrain
                              .default_optimizer().init(tp), lora=None)
    ckpt = CheckpointManager(str(tmp_path), use_task_namespace=False)
    assert ckpt.maybe_save(0, state)
    ckpt.wait()
    ckpt.close()
    prompt = [5, 9, 200, 3, 1, 77]
    for quant in ('none', 'int8'):
        params = tp if quant == 'none' else tquant.quantize_params(tp, tcfg)
        want = tdecode.greedy_generate(params, torch.tensor([prompt]), tcfg,
                                       8)[0].tolist()
        for slots in ('0', '2'):
            args = serve_model.parse_args(
                ['--model', 'tiny-moe', '--port', '0', '--device', 'cpu',
                 '--slots', slots, '--quant', quant,
                 '--checkpoint-dir', str(tmp_path)])
            server, generate = serve_model.build_server(args)
            try:
                assert generate(prompt, 8) == want, (quant, slots)
            finally:
                server.server_close()
                if server.engine is not None:
                    server.engine.close()
