"""Tensor-parallel serving (``models/decode.py``'s ``layout=`` paths,
``serve/kv_pool.pool_shardings``, ``recipes/serve_model.py --tp``) on
gloo ranks, against the JAX package's sharded ``forward_cached`` and
the port's one-process (tp 1) path, with the weights exported to numpy;
``tiny`` and the MoE ``tiny-moe`` (the router whole on every rank, each
expert's ffn columns split, one *g* after the combine).

One process group of 4 ranks runs the mesh ``dp=2 x tp=2`` (each data
replica a tp 2 pair) and ``fsdp=2 x tp=2`` (each layer's blocks
gathered over fsdp): prefill and decode-step logits within
``tests/test_decode.py``'s rtol/atol 2e-4 of JAX's sharded forward on
the same mesh shape and of tp 1, greedy ids equal to tp 1's, and the
``tp`` all-reduces against their identity (2 L + 1 a forward, 2 a
token). The replica runs twice as ``--tp 2 --device cpu`` processes
(rank 0 spawns rank 1): random weights, and a LoRA checkpoint read
through each rank's windows; each request's ``output_ids`` equal tp
1's."""
import functools
import json
import os
import signal
import subprocess
import sys
import urllib.request

import _torch_dist
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import decode as jdecode
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.serve import kv_pool as jpool
from skypilot_torch import checkpoint as tcheckpoint
from skypilot_torch.models import convert
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.parallel import distributed as tdistributed
from skypilot_torch.parallel import train as ttrain
from skypilot_torch.recipes import serve_model
from skypilot_torch.serve import kv_pool as tpool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_decode.py:139
MESHES = {'dp2_tp2': dict(dp=2, tp=2), 'fsdp2_tp2': dict(fsdp=2, tp=2)}
# The JAX reference of each: tp 2 alone (its dp replicas compute the
# same) and fsdp 2 x tp 2.
JAX_MESHES = {'dp2_tp2': dict(tp=2), 'fsdp2_tp2': dict(fsdp=2, tp=2)}
N_NEW = 6


MODELS = ('tiny', 'tiny-moe')


@functools.lru_cache(maxsize=None)
def _results(tmp):
    prompt = np.random.default_rng(3).integers(0, 512, (2, 10)).astype(
        np.int32)
    refs = {model: _reference(model, prompt) for model in MODELS}
    ranks = _torch_dist.run(
        4, os.path.join(tmp, 'store'),
        *[(_torch_dist.serve_ranks, (MESHES[name], refs[model][0], prompt,
                                     N_NEW, None, model))
          for model in MODELS for name in sorted(MESHES)])
    out = {}
    for i, (model, name) in enumerate(
            (m, n) for m in MODELS for n in sorted(MESHES)):
        out.setdefault(model, {'one': refs[model][1], 'jax': refs[model][2],
                               'ranks': {}})
        out[model]['ranks'][name] = [r[i] for r in ranks]
    return out


def _reference(model, prompt):
    """(numpy params, the port's tp 1 logits and ids, JAX's sharded
    logits on each mesh shape) of ``model``."""
    jcfg = jllama.get_config(model)
    tcfg = tllama.get_config(model)
    params_np = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.PRNGKey(0)))
    # The port at tp 1.
    whole = convert.params_from_numpy(params_np, tcfg, device='cpu')
    tokens = torch.from_numpy(prompt).long()
    with torch.inference_mode():
        cache = tdecode.init_cache(tcfg, 2, 64, device='cpu')
        pre, cache = tdecode.forward_cached(whole, tokens, cache, tcfg,
                                            prefill=True)
        first = pre[:, -1].argmax(-1)
        step, _ = tdecode.forward_cached(whole, first[:, None], cache, tcfg)
        ids = tdecode.greedy_generate(whole, tokens, tcfg, N_NEW,
                                      max_seq=64)
    one = {'prefill': pre.numpy(), 'step': step.numpy(), 'ids': ids.numpy()}
    # JAX's sharded forward on each mesh shape.
    jax_out = {}
    for name, kw in JAX_MESHES.items():
        n = jmesh.MeshConfig(**kw).num_devices
        mesh = jmesh.make_mesh(jmesh.MeshConfig(**kw),
                               devices=jax.devices()[:n])
        param_sh, cache_sh = jdecode.decode_shardings(jcfg, mesh,
                                                      shard_batch=False)
        fwd = jax.jit(jdecode.forward_cached, static_argnums=(3,),
                      in_shardings=(param_sh, None, cache_sh),
                      out_shardings=(None, cache_sh))
        params = jax.device_put(params_np, param_sh)
        cache = jax.device_put(jdecode.init_cache(jcfg, 2, max_seq=64),
                               cache_sh)
        pre, cache = fwd(params, jnp.asarray(prompt), cache, jcfg)
        step, _ = fwd(params, jnp.asarray(first.numpy()[:, None],
                                          jnp.int32), cache, jcfg)
        jax_out[name] = {'prefill': np.asarray(pre), 'step': np.asarray(step)}
    return params_np, one, jax_out


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    return _results(str(tmp_path_factory.mktemp('tp_serve')))


def _assemble(ranks, key):
    """The whole vocabulary's logits from the ranks' windows; ranks that
    hold the same window (data replicas) must agree bit for bit."""
    out = {}
    for r in ranks:
        lo, hi = r['window']
        got = r[key].numpy()
        if (lo, hi) in out:
            np.testing.assert_array_equal(got, out[lo, hi])
        out[lo, hi] = got
    return np.concatenate([out[w] for w in sorted(out)], axis=-1)


@pytest.mark.parametrize('key', ['prefill', 'step'])
@pytest.mark.parametrize('name', sorted(MESHES))
def test_sharded_forward_cached_matches_jax_and_tp1(results, name, key):
    res = results['tiny']
    got = _assemble(res['ranks'][name], key)
    np.testing.assert_allclose(got, res['jax'][name][key], **LOGIT_TOL)
    np.testing.assert_allclose(got, res['one'][key], **LOGIT_TOL)


@pytest.mark.parametrize('key', ['prefill', 'step'])
@pytest.mark.parametrize('name', sorted(MESHES))
def test_moe_forward_cached_and_greedy_match_jax_and_tp1(results, name,
                                                         key):
    """tiny-moe at tp 2: logits as ``tiny``'s are held, greedy ids equal
    tp 1's, and 2 L + 1 tp all-reduces a forward (the MoE layer's *g*
    after its combine in the place of the dense one)."""
    res = results['tiny-moe']
    got = _assemble(res['ranks'][name], key)
    np.testing.assert_allclose(got, res['jax'][name][key], **LOGIT_TOL)
    np.testing.assert_allclose(got, res['one'][key], **LOGIT_TOL)
    L = tllama.get_config('tiny-moe').n_layers
    for r in res['ranks'][name]:
        np.testing.assert_array_equal(r['ids'].numpy(), res['one']['ids'])
        assert r['prefill_tp_reduces'] == 2 * L + 1


@pytest.mark.parametrize('name', sorted(MESHES))
def test_greedy_ids_equal_tp1(results, name):
    res = results['tiny']
    for r in res['ranks'][name]:
        np.testing.assert_array_equal(r['ids'].numpy(), res['one']['ids'])
        np.testing.assert_array_equal(r['first'].numpy(),
                                      res['one']['ids'][:, 0])


@pytest.mark.parametrize('name', sorted(MESHES))
def test_tp_reduces_and_cache_heads(results, name):
    """2 L + 1 all-reduces over tp a forward (the lookup, then wo and
    w_down each layer) and 2 a token (the max, then its lowest id); the
    cache holds a rank's n_kv_heads / tp heads."""
    L = tllama.get_config('tiny').n_layers
    for r in results['tiny']['ranks'][name]:
        assert r['prefill_tp_reduces'] == 2 * L + 1
        assert r['generate_tp_reduces'] == N_NEW * (2 * L + 1 + 2)
        assert r['cache_heads'] == 1


def test_decode_and_pool_shardings_equal_jax():
    jcfg = jllama.get_config('tiny')
    mesh = jmesh.make_mesh(jmesh.MeshConfig(fsdp=4, tp=2))
    for shard_batch in (False, True):
        for kv_int8 in (False, True):
            jparams, jcache = jdecode.decode_shardings(
                jcfg, mesh, shard_batch=shard_batch, kv_int8=kv_int8)
            tparams, tcache = tdecode.decode_shardings(
                tllama.get_config('tiny'), shard_batch=shard_batch,
                kv_int8=kv_int8)
            assert jax.tree.map(lambda s: tuple(s.spec), jparams) == \
                jax.tree.map(tuple, tparams,
                             is_leaf=lambda x: isinstance(x, tuple))
            for f in ('k', 'v', 'pos', 'k_scale', 'v_scale'):
                want = getattr(jcache, f)
                assert getattr(tcache, f) == (
                    None if want is None else tuple(want.spec)), f
            jp = jpool.pool_shardings(jcfg, mesh, kv_int8=kv_int8)
            tp = tpool.pool_shardings(tllama.get_config('tiny'),
                                      kv_int8=kv_int8)
            assert tp == tuple(None if s is None else tuple(s.spec)
                               for s in jp)


def test_replica_tp_refusals():
    """bf16 mixtral-8x7b at ``--tp 2`` is taken (46.7 GB a rank); at tp 1
    it is refused (93 GB)."""
    for argv in (['--slots', '2', '--tp', '2'],
                 ['--quant', 'int8', '--tp', '2'],
                 ['--model', 'mixtral-8x7b', '--tp', '1']):
        with pytest.raises(SystemExit):
            serve_model.parse_args(argv)
    assert serve_model.parse_args(['--model', 'mixtral-8x7b', '--tp',
                                   '2']).tp == 2
    fake = type('M', (), {'shape': {'tp': 2}})()
    with pytest.raises(ValueError, match='gemma-2b: 8 query / 1 kv heads'):
        tdecode.serving_layout(tllama.get_config('gemma-2b'), fake)


def _replica_ids(tmp_path, extra, prompts):
    """``--tp 2 --device cpu`` as a process (it spawns its second rank),
    each prompt's ``output_ids`` over HTTP, then SIGINT: the replica
    closes, stopping its other rank, and every process that holds its
    pipes has ended within the limit."""
    port = tdistributed.free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ('SKYTPU_', 'JAX', 'XLA'))}
    env.update(SKYTPU_NUM_CHIPS_PER_NODE='2', HOME=str(tmp_path),
               SKYTPU_STATE_DIR=str(tmp_path / 'state'), PYTHONPATH=REPO,
               OMP_NUM_THREADS='1')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_torch.recipes.serve_model',
         '--model', 'tiny', '--device', 'cpu', '--tp', '2', '--port',
         str(port)] + extra, env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready = proc.stdout.readline()
        assert 'tp 2' in ready, (ready, proc.stderr.read()
                                 if proc.poll() is not None else '')
        out = []
        for prompt, n in prompts:
            req = urllib.request.Request(
                f'http://127.0.0.1:{port}/generate',
                data=json.dumps({'prompt_ids': prompt,
                                 'max_new_tokens': n}).encode(),
                headers={'Content-Type': 'application/json'})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out.append(json.loads(resp.read())['output_ids'])
        proc.send_signal(signal.SIGINT)
        proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return out


PROMPTS = [([5, 6, 7, 8], 7), ([100, 3, 9, 250, 11, 12, 13, 1, 2], 4)]


def test_replica_tp2_returns_tp1_ids(tmp_path):
    cfg = tllama.get_config('tiny')
    params = tllama.init_params(cfg, seed=0, device='cpu')
    want = [tdecode.greedy_generate(params, torch.tensor([p]), cfg, n)[0]
            .tolist() for p, n in PROMPTS]
    assert _replica_ids(tmp_path, [], PROMPTS) == want


def test_replica_tp2_warm_starts_from_a_lora_checkpoint(tmp_path):
    """A LoRA lineage (adapters non-zero) served at --tp 2: each rank
    reads its windows of the base and merges its windows of the
    adapters on the host; the ids are tp 1's over the same lineage."""
    cfg = tllama.get_config('tiny')
    state = ttrain.init_train_state(cfg, seed=4, lora_rank=4, device='cpu')
    rng = np.random.default_rng(5)
    state.lora = {k: torch.from_numpy(0.05 * rng.standard_normal(
        tuple(v.shape))).float() for k, v in state.lora.items()}
    path = str(tmp_path / 'lineage')
    tcheckpoint.save_tree(path, 2, state)
    args = serve_model.parse_args(['--model', 'tiny', '--device', 'cpu',
                                   '--checkpoint-dir', path])
    params = serve_model.load_params(args, cfg, torch.device('cpu'))
    want = [tdecode.greedy_generate(params, torch.tensor([p]), cfg, n)[0]
            .tolist() for p, n in PROMPTS]
    assert _replica_ids(tmp_path, ['--checkpoint-dir', path],
                        PROMPTS) == want
