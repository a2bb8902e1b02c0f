"""The serving path's row ops on the CPU: the fused residual add + RMSNorm
(``ops/rms_norm.add_rms_norm``) and the nucleus threshold's cluster plan
(``ops/top_p.top_p_plan``).

- ``add_rms_norm``'s plain version is the JAX package's ``x + d`` followed
  by ``llama._rms_norm`` on the same numpy inputs: bf16 bit-equal, f32
  within 1e-6, with and without ``offset`` and ``delta``.
- ``norm_plan`` and ``top_p_plan`` read the row's length alone and cover
  the row exactly once, in order.
- Every serving forward (decode and verify steps, a prefill chunk, the
  dense cache with and without its prompt) norms its first layer alone and
  every later norm with the residual add before it: 1 and 2 L calls.
- The wrappers refuse what the kernels do not take before anything
  launches.
No test here touches CUDA.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skypilot_tpu.models import llama as jllama
from skypilot_torch.models import decode as tdecode
from skypilot_torch.models import llama as tllama
from skypilot_torch.ops import rms_norm as trn
from skypilot_torch.ops import top_p as ttp
from skypilot_torch.serve import batching as tbatching

F32_TOL = dict(rtol=1e-6, atol=1e-6)


def _launches():
    return (trn.RMS_NORM.launches, trn.ADD_RMS_NORM.launches,
            ttp.TOP_P_KTH.launches)


def _refused(fn, exc, match):
    before = _launches()
    with pytest.raises(exc, match=match):
        fn()
    assert _launches() == before


# ---------------------------------------------------------------------
# add_rms_norm's plain version against the JAX package
# ---------------------------------------------------------------------


@pytest.mark.parametrize('with_delta', [True, False])
@pytest.mark.parametrize('offset', [False, True])
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_add_rms_norm_plain_matches_jax(dtype, offset, with_delta):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    d = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jd, jw = (jnp.asarray(a).astype(jdt) for a in (x, d, w))
    # The same rounded inputs on both sides (bf16 rounds alike).
    tx, td, tw = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(tdt) for a in (jx, jd, jw))
    js = jx + jd if with_delta else jx
    jy = jllama._rms_norm(js, jw, 1e-5, offset)
    s, y = trn.add_rms_norm(tx, td if with_delta else None, tw, 1e-5,
                            offset)
    got_s, got_y = s.float().numpy(), y.float().numpy()
    want_s = np.asarray(js.astype(jnp.float32))
    want_y = np.asarray(jy.astype(jnp.float32))
    assert y.dtype == s.dtype == tdt and y.shape == s.shape == tx.shape
    if dtype == 'bfloat16':
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got_y, want_y)
    else:
        np.testing.assert_allclose(got_s, want_s, **F32_TOL)
        np.testing.assert_allclose(got_y, want_y, **F32_TOL)
    # The norm alone is the fused form's y on the same sum.
    assert torch.equal(trn.rms_norm(s, tw, 1e-5, offset), y)


# ---------------------------------------------------------------------
# The plans read the row's length alone
# ---------------------------------------------------------------------


@pytest.mark.parametrize('elem_bytes', [2, 4])
@pytest.mark.parametrize('d', [8, 64, 128, 1536, 2048, 3072, 3584, 4096,
                               5120, 8192])
def test_norm_plan_covers_the_row_from_d_alone(d, elem_bytes):
    """Thread t holds vectors t, t + NT, ...: every 16-byte vector of the
    row once, whole warps, an instantiated VPT, and nothing of the rows
    in the rule."""
    assert list(inspect.signature(trn.norm_plan).parameters) == [
        'd', 'elem_bytes']
    threads, vpt = trn.norm_plan(d, elem_bytes)
    per = 16 // elem_bytes
    nvec = d // per
    assert vpt in trn.NORM_VPT
    assert threads % 32 == 0 and 32 <= threads <= trn.NORM_MAX_THREADS
    held = sorted(t + k * threads for t in range(threads)
                  for k in range(vpt) if t + k * threads < nvec)
    assert held == list(range(nvec))
    assert (threads - 32) * vpt < nvec or threads == 32
    if d == 4096 and elem_bytes == 2:
        assert (threads, vpt) == (256, 2)


@pytest.mark.parametrize('d,elem_bytes', [(60, 2), (6, 4), (0, 2),
                                          (65536, 2)])
def test_norm_plan_refuses_rows_the_kernel_cannot_take(d, elem_bytes):
    with pytest.raises(ValueError):
        trn.norm_plan(d, elem_bytes)


@pytest.mark.parametrize('v', [1, 7, 4096, 32000, 128256, 152064, 256000])
def test_top_p_plan_covers_the_row_from_v_alone(v):
    """Block r of the cluster takes [r P, (r + 1) P), thread t of it
    [t L, (t + 1) L) of that slice: every logit once, in order, and
    nothing of the rows in the rule."""
    assert list(inspect.signature(ttp.top_p_plan).parameters) == ['v']
    cluster, per_cta, threads = ttp.top_p_plan(v)
    assert cluster == ttp.TOP_P_CLUSTER == 8
    assert threads % 32 == 0
    assert threads <= ttp.TOP_P_MAX_THREADS
    per = ttp.TOP_P_PER_THREAD
    assert per % 4 == 0 and (per // 4) % 2 == 1
    taken = []
    for r in range(cluster):
        lo = min(v, r * per_cta)
        n = min(v, lo + per_cta) - lo
        assert n <= threads * per
        for t in range(threads):
            a, b = min(n, t * per), min(n, (t + 1) * per)
            taken += range(lo + a, lo + b)
    assert taken == list(range(v))
    if v == 128256:
        assert (cluster, per_cta, threads) == (8, 16032, 448)


def test_top_p_plan_refusals():
    with pytest.raises(ValueError, match='logits'):
        ttp.top_p_plan(0)
    with pytest.raises(ValueError, match='threads'):
        ttp.top_p_plan(8 * 1024 * 36 + 1)


# ---------------------------------------------------------------------
# Every serving forward: one norm alone, 2 L with their residual adds
# ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def tiny():
    cfg = tllama.get_config('tiny', dtype=torch.float32)
    return cfg, tllama.init_params(cfg, seed=3, device='cpu')


def _count_norms(monkeypatch):
    calls = {'alone': 0, 'fused': 0}
    real = trn.add_rms_norm

    def counted(x, delta, *args, **kwargs):
        calls['alone' if delta is None else 'fused'] += 1
        return real(x, delta, *args, **kwargs)
    monkeypatch.setattr(trn, 'add_rms_norm', counted)
    return calls


def _paged(cfg, nb=9, bs=8):
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape), torch.zeros(shape), None, None)


@pytest.mark.parametrize('path', ['decode_paged', 'decode_rows', 'verify',
                                  'chunk', 'dense_prompt', 'dense_step'])
def test_serving_forwards_fuse_every_residual_add(tiny, monkeypatch, path):
    cfg, params = tiny
    nl, bs = cfg.n_layers, 8
    calls = _count_norms(monkeypatch)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    tokens = torch.tensor([1, 2], dtype=torch.int32)
    active = torch.tensor([True, True])
    forwards = 1
    with torch.inference_mode():
        if path == 'decode_paged':
            forwards = 2
            tbatching.decode_steps_paged(params, tokens, _paged(cfg), tables,
                                         pos, active, cfg, forwards, bs)
        elif path == 'decode_rows':
            caches = tdecode.init_cache(cfg, 2, max_seq=16, device='cpu')
            tbatching.decode_steps_rows(params, tokens, (caches.k, caches.v,
                                                         None, None),
                                        pos, active, cfg, 1)
        elif path == 'verify':
            tbatching.verify_step_paged(
                params, torch.ones((2, 3), dtype=torch.int32), _paged(cfg),
                tables, pos, torch.tensor([3, 2], dtype=torch.int32), cfg,
                3, bs)
        elif path == 'chunk':
            tdecode.forward_paged(params, torch.ones((1, 8), dtype=torch.long),
                                  _paged(cfg), tables[0], 0, 5, cfg, bs)
        else:
            cache = tdecode.init_cache(cfg, 2, max_seq=16, device='cpu')
            forwards = 2
            tdecode.forward_cached(params, torch.ones((2, 4), dtype=torch.long),
                                   cache, cfg, last_only=True,
                                   prefill=path == 'dense_prompt')
            tdecode.forward_cached(params, torch.ones((2, 1), dtype=torch.long),
                                   cache, cfg)
    assert calls == {'alone': forwards, 'fused': 2 * nl * forwards}


# ---------------------------------------------------------------------
# The wrappers' refusals
# ---------------------------------------------------------------------


def test_add_rms_norm_refusals():
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    w = torch.zeros(64, dtype=torch.bfloat16)
    # delta of another shape, dtype: refused on every device.
    _refused(lambda: trn.add_rms_norm(x, x[:2], w, 1e-5), ValueError,
             'delta must match')
    _refused(lambda: trn.add_rms_norm(x, x.float(), w, 1e-5), ValueError,
             'delta must match')
    _refused(lambda: trn.add_rms_norm(x.to('meta'), None, w, 1e-5),
             ValueError, 'unsupported device')
    # What the CUDA kernel has no form for.
    _refused(lambda: trn._add_rms_norm_cuda(x.half(), x.half(), w, 1e-5,
                                            False), TypeError, 'bf16/f32')
    _refused(lambda: trn._add_rms_norm_cuda(x, x, w.half(), 1e-5, False),
             TypeError, 'bf16/f32')
    _refused(lambda: trn._add_rms_norm_cuda(x, x, w[:32], 1e-5, False),
             TypeError, r'\[D\] weight')
    _refused(lambda: trn._add_rms_norm_cuda(
        x, x, torch.zeros((64, 2), dtype=torch.bfloat16)[:, 0], 1e-5, False),
        ValueError, 'contiguous')
    _refused(lambda: trn._add_rms_norm_cuda(x[:, :60], x[:, :60], w[:60],
                                            1e-5, False), ValueError,
             'multiple of 8')
    # A row base 2 bytes off 16.
    flat = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)
    _refused(lambda: trn._add_rms_norm_cuda(flat[1:].view(4, 64), None, w,
                                            1e-5, False), ValueError,
             '16-byte')


def test_top_p_kth_refusals():
    _refused(lambda: ttp._top_p_kth_cuda(torch.zeros((2, 8)),
                                         torch.zeros((3,))), TypeError,
             'f32')
    _refused(lambda: ttp._top_p_kth_cuda(torch.zeros((1, 8 * 1024 * 36 + 1)),
                                         torch.zeros((1,))), ValueError,
             'threads')
    _refused(lambda: ttp._top_p_kth_cuda(torch.zeros((65536, 1)),
                                         torch.zeros((65536,))), ValueError,
             'rows')
    _refused(lambda: ttp.top_p_kth(torch.zeros((2, 8), device='meta'),
                                   torch.zeros((2,), device='meta')),
             ValueError, 'unsupported device')
