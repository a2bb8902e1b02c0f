"""The port's boundaries: skypilot_torch and chip_smoke.py import
nothing of JAX, the JAX package or ``ml_dtypes`` (a JAX dependency the
card's machine lacks); entry points never quietly run on
the CPU; a kernel build that cannot happen raises."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

import skypilot_torch
from skypilot_torch import device as device_lib
from skypilot_torch.models import convert, decode, llama, quant
from skypilot_torch.ops import _build
from skypilot_torch.parallel import train as train_lib
from skypilot_torch.recipes import finetune, serve_model
from skypilot_torch.serve import kv_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(skypilot_torch.__file__)
FORBIDDEN = ('jax', 'jaxlib', 'skypilot_tpu', 'ml_dtypes')


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)
    yield os.path.join(REPO, 'chip_smoke.py')


def test_importing_every_module_loads_no_jax():
    script = f'''
import importlib, json, pkgutil, sys
sys.path.insert(0, {REPO!r})
import skypilot_torch
names = [m.name for m in pkgutil.walk_packages(skypilot_torch.__path__,
                                               'skypilot_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in {FORBIDDEN!r})
print(json.dumps({{'modules': names, 'bad': bad}}))
'''
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', script], check=True,
                         capture_output=True, text=True, env=env,
                         timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['bad'] == []
    for mod in ('skypilot_torch.device', 'skypilot_torch.models.llama',
                'skypilot_torch.checkpoint',
                'skypilot_torch.checkpoint.commit',
                'skypilot_torch.checkpoint.format',
                'skypilot_torch.serve.adapters',
                'skypilot_torch.serve.adapters.registry',
                'skypilot_torch.serve.adapters.resident',
                'skypilot_torch.serve.overload',
                'skypilot_torch.models.convert',
                'skypilot_torch.models.decode',
                'skypilot_torch.models.quant', 'skypilot_torch.ops._build',
                'skypilot_torch.ops.attention',
                'skypilot_torch.ops.attention_packed',
                'skypilot_torch.ops.decode_attention',
                'skypilot_torch.parallel.lora',
                'skypilot_torch.parallel.train',
                'skypilot_torch.recipes.finetune',
                'skypilot_torch.recipes.serve_model',
                'skypilot_torch.exceptions',
                'skypilot_torch.serve.batching',
                'skypilot_torch.serve.kv_pool',
                'skypilot_torch.serve.prefix_hash',
                'skypilot_torch.serve.sampling',
                'skypilot_torch.serve.sampling.accept',
                'skypilot_torch.serve.sampling.grammar',
                'skypilot_torch.serve.sampling.prng',
                'skypilot_torch.serve.sampling.sample',
                'skypilot_torch.callbacks', 'skypilot_torch.metrics',
                'skypilot_torch.metrics.device',
                'skypilot_torch.metrics.exposition',
                'skypilot_torch.metrics.goodput',
                'skypilot_torch.metrics.publish',
                'skypilot_torch.metrics.registry', 'skypilot_torch.trace',
                'skypilot_torch.trace.tracer', 'skypilot_torch.utils',
                'skypilot_torch.utils.profiling'):
        assert mod in res['modules']


@pytest.mark.parametrize('path', list(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_statement_names_jax(path):
    """Also catches imports inside functions, which the subprocess test
    above never executes."""
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for n in names:
            assert n.split('.')[0] not in FORBIDDEN, (path, n)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid here')
    cfg = llama.get_config('tiny')
    with pytest.raises(device_lib.DeviceError):
        device_lib.resolve_device()
    with pytest.raises(device_lib.DeviceError):
        llama.init_params(cfg)
    with pytest.raises(device_lib.DeviceError):
        decode.init_cache(cfg, 1)
    with pytest.raises(device_lib.DeviceError):
        convert.params_from_numpy({'final_norm': [1.0]}, cfg)
    with pytest.raises(device_lib.DeviceError):
        serve_model.build_server(serve_model.parse_args(['--port', '0']))
    with pytest.raises(device_lib.DeviceError):
        serve_model.build_server(serve_model.parse_args(
            ['--port', '0', '--slots', '2']))
    with pytest.raises(device_lib.DeviceError):
        kv_pool.KVBlockPool(cfg, 4, 4)
    with pytest.raises(device_lib.DeviceError):
        finetune.build(finetune.parse_args(['--model', 'tiny']))
    with pytest.raises(device_lib.DeviceError):
        quant.init_quantized(cfg)
    with pytest.raises(device_lib.DeviceError):
        train_lib.init_qlora_state(cfg, seed=0, lora_rank=4)
    with pytest.raises(device_lib.DeviceError):
        serve_model.build_server(serve_model.parse_args(
            ['--port', '0', '--quant', 'int8']))


def test_unknown_device_type_raises():
    with pytest.raises(device_lib.DeviceError, match='unsupported'):
        device_lib.resolve_device('meta')


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if os.path.isfile('/usr/local/cuda/bin/nvcc'):
        pytest.skip('nvcc is installed at its default path')
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(_build.BuildError, match='nvcc not found'):
        _build.build_all()


def test_every_kernel_source_is_a_library():
    assert set(_build.sources()) == {'flash_fwd', 'flash_bwd',
                                     'decode_attention',
                                     'prefill_attention',
                                     'attention_packed',
                                     'matmul_invariant', 'top_p',
                                     'rms_norm'}
    paths = {_build.library_path(n) for n in _build.sources()}
    assert len(paths) == 8
    assert all(p.startswith(_build.BUILD_DIR) for p in paths)


def test_shared_header_change_rebuilds_every_library(tmp_path,
                                                     monkeypatch):
    """The kernels include csrc/*.cuh; a library's name hashes them, so
    an edited header cannot leave a stale build in place."""
    before = {n: _build.library_path(n) for n in _build.sources()}
    headers = [os.path.basename(p) for p in
               glob.glob(os.path.join(_build.CSRC_DIR, '*.cuh'))]
    assert {'flash_common.cuh', 'sm90_common.cuh',
            'flash_fwd_sm90.cuh'} <= set(headers)
    for name in ['flash_fwd.cu'] + headers:
        with open(os.path.join(_build.CSRC_DIR, name), 'rb') as f:
            (tmp_path / name).write_bytes(f.read())
    monkeypatch.setattr(_build, 'CSRC_DIR', str(tmp_path))
    same = _build.library_path('flash_fwd')
    with open(tmp_path / 'flash_common.cuh', 'ab') as f:
        f.write(b'\n// edited\n')
    assert same == before['flash_fwd']
    assert _build.library_path('flash_fwd') != before['flash_fwd']
