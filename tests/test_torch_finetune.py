"""The port's finetune recipe (skypilot_torch/recipes/finetune.py) on
the CPU: it prints the reference recipe's step lines, refuses the
options this slice does not run, and draws the same batches as the JAX
recipe's data iterator."""
import re
import types

import numpy as np
import pytest
import torch

from skypilot_tpu.recipes import finetune as jfinetune
from skypilot_torch import device as device_lib
from skypilot_torch.recipes import finetune

STEP_LINE = re.compile(r'^step (\d+) loss=([\d.]+) grad_norm=([\d.]+) '
                       r'tokens/s=(\d+) tokens/s/chip=(\d+)$')
TINY = ['--model', 'tiny', '--device', 'cpu', '--seq', '64', '--batch', '2']


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    """The recipe's step callbacks write under ``~/sky_benchmark_dir``:
    keep them in the test's own directory."""
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))


@pytest.mark.parametrize('extra', [[], ['--full-ft', '--param-dtype',
                                        'f32']])
def test_main_prints_step_lines(extra, capsys):
    finetune.main(TINY + ['--steps', '3', '--log-every', '1'] + extra)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith('devices=1 device=cpu model=tiny')
    steps = [STEP_LINE.match(line) for line in lines[1:-1]]
    assert all(steps), lines
    assert [int(m.group(1)) for m in steps] == [0, 1, 2]
    assert all(np.isfinite(float(m.group(2))) for m in steps)
    assert lines[-1] == 'finetune done.'


def test_log_every_keeps_first_and_last_step(capsys):
    finetune.main(TINY + ['--steps', '4', '--log-every', '3'])
    steps = [STEP_LINE.match(line).group(1)
             for line in capsys.readouterr().out.splitlines()
             if line.startswith('step ')]
    assert steps == ['0', '3']


@pytest.mark.parametrize('argv,match', [
    (['--tp', '2'], 'items 15-18'),
    (['--sp', '2'], 'one device'),
    (['--microbatches', '4'], 'item 18'),
    (['--checkpoint-dir', '/nonexistent/ckpt'], 'items 13-14'),
])
def test_unported_options_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        finetune.main(TINY + ['--steps', '1'] + argv)


def test_checkpoint_dir_env_raises(monkeypatch):
    monkeypatch.setenv('SKYTPU_CHECKPOINT_DIR', '/nonexistent/ckpt')
    with pytest.raises(NotImplementedError, match='SKYTPU_CHECKPOINT_DIR'):
        finetune.main(TINY + ['--steps', '1'])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid here')
    with pytest.raises(device_lib.DeviceError):
        finetune.main(['--model', 'tiny', '--steps', '1'])


@pytest.mark.parametrize('use_file', [False, True])
def test_data_iterator_matches_jax(use_file, tmp_path):
    path = None
    if use_file:
        path = str(tmp_path / 'tokens.npy')
        np.save(path, np.arange(5000, dtype=np.uint16))
    args = types.SimpleNamespace(data=path, seq=16, batch=3)
    ours = finetune.data_iterator(args, 512, np.random.default_rng(5))
    ref = jfinetune.data_iterator(args, 512, np.random.default_rng(5))
    for _ in range(3):
        got, want = next(ours), next(ref)
        assert got.shape == (3, 17) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_data_file_trains(tmp_path, capsys):
    path = str(tmp_path / 'tokens.npy')
    np.save(path, np.random.default_rng(0).integers(
        0, 512, 4096).astype(np.int32))
    finetune.main(TINY + ['--steps', '2', '--data', path])
    assert capsys.readouterr().out.strip().endswith('finetune done.')
