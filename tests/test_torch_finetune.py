"""The port's finetune recipe (skypilot_torch/recipes/finetune.py) on
the CPU: it prints the reference recipe's step lines, refuses the
options this slice does not run, draws the same batches as the JAX
recipe's data iterator, saves committed steps under ``--checkpoint-dir``
(default ``$SKYTPU_CHECKPOINT_DIR``), resumes from the latest one, and
keeps the JAX recipe's elastic ``design.json``."""
import json
import os
import re
import types

import numpy as np
import pytest
import torch

from skypilot_tpu.recipes import finetune as jfinetune
from skypilot_torch import checkpoint as tcheckpoint
from skypilot_torch import device as device_lib
from skypilot_torch.checkpoint import native
from skypilot_torch.data import checkpoint as ckpt_facade
from skypilot_torch.models import llama
from skypilot_torch.parallel import train as train_lib
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


@pytest.mark.parametrize('argv,error,match', [
    (['--model', 'tiny-moe', '--pp', '2', '--sp', '2'], NotImplementedError,
     'MoE \\+ sequence parallelism inside a pipeline'),
    (['--pp', '4'], ValueError, 'n_layers=2 not divisible by pp=4'),
    (['--model', 'tiny-moe', '--pp', '3', '--sp', '2'], ValueError,
     'n_layers=2 not divisible by pp=3'),
], ids=['argv0-items 15-18', 'argv1-one device', 'argv2-item 18'])
def test_unported_options_raise(argv, error, match):
    """``--sp``, ``--pp`` and ``--microbatches`` run (the gloo runs of
    ``test_torch_sp.py`` and ``test_torch_pp.py``); the recipe refuses,
    before a worker starts, the pipelines JAX refuses."""
    with pytest.raises(error, match=match):
        finetune.main(TINY + ['--steps', '1'] + argv)


def test_recipe_trains_tiny_moe_over_ep(tmp_path):
    """``SKYTPU_NUM_CHIPS_PER_NODE=2 python -m ...finetune --model tiny-moe
    --device cpu --ep 2`` spawns two gloo workers on the mesh ``ep=2``
    (two of the four experts each); rank 0 alone prints, and its losses
    are the one-process run's within rtol 1e-5 (the same global
    batches)."""
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ('SKYTPU_', 'JAX', 'XLA'))}
    env.update(HOME=str(tmp_path),
               SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
               SKYTPU_STATE_DIR=str(tmp_path / 'state'),
               PYTHONPATH=repo, OMP_NUM_THREADS='1')
    argv = ['--model', 'tiny-moe', '--device', 'cpu', '--seq', '32',
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
    head, ep = losses(['--ep', '2'], '2')
    assert head.startswith('devices=2 device=cpu model=tiny-moe')
    assert head.endswith('mesh=2c:ep2')
    _, one = losses([], '1')
    assert len(ep) == 2
    np.testing.assert_allclose(ep, one, rtol=1e-5)


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


# ---------------------------------------------------------------------
# Checkpoint and resume
# ---------------------------------------------------------------------


@pytest.fixture
def task(monkeypatch):
    monkeypatch.setenv('SKYTPU_TASK_ID', 'managed-4-0-1')
    monkeypatch.delenv('SKYTPU_CHECKPOINT_DIR', raising=False)
    monkeypatch.delenv('SKYTPU_ELASTIC_RESIZED', raising=False)
    return 'managed-4-0'


def test_checkpoint_dir_commits_steps(tmp_path, task, capsys):
    finetune.main(TINY + ['--steps', '3', '--checkpoint-dir',
                          str(tmp_path), '--checkpoint-interval', '2'])
    lineage = str(tmp_path / task)
    assert tcheckpoint.committed_steps(lineage) == [0, 2]
    with open(os.path.join(lineage, 'design.json'), encoding='utf-8') as f:
        assert json.load(f) == {'device_count': 1, 'global_batch': 2}
    assert 'resumed' not in capsys.readouterr().out


def _assert_same_bits(got, want):
    got = tcheckpoint.flatten(got.checkpoint_tree())
    want = tcheckpoint.flatten(want.checkpoint_tree())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(native.host_leaf(got[key])[0],
                                      native.host_leaf(want[key])[0],
                                      err_msg=key)


def test_rerun_resumes_from_the_latest_step(tmp_path, task, monkeypatch,
                                            capsys):
    """A rerun restores the latest committed step (the state bit-equal
    to the saved one), goes on from the next step on the restarted
    iterator's first batch, and its step equals the port's step on that
    state and batch."""
    argv = TINY + ['--checkpoint-dir', str(tmp_path),
                   '--checkpoint-interval', '1', '--log-every', '1']
    finetune.main(argv + ['--steps', '2'])
    capsys.readouterr()
    lineage = str(tmp_path / task)
    assert tcheckpoint.committed_steps(lineage) == [0, 1]
    restored = []
    real_restore_or = ckpt_facade.CheckpointManager.restore_or

    def spy(self, state):
        out = real_restore_or(self, state)
        restored.append(out[0])
        return out

    monkeypatch.setattr(ckpt_facade.CheckpointManager, 'restore_or', spy)
    finetune.main(argv + ['--steps', '3'])
    lines = capsys.readouterr().out.splitlines()
    assert 'resumed from checkpoint at step 2' in lines
    steps = [STEP_LINE.match(line) for line in lines
             if line.startswith('step ')]
    assert [m.group(1) for m in steps] == ['2']
    assert tcheckpoint.committed_steps(lineage) == [0, 1, 2]
    # The restored state is the saved step 1, bit for bit.
    state = restored[0]
    assert state.step == 2 and state.opt_state.count == 2
    saved = tcheckpoint.NativeCheckpointManager(lineage)
    try:
        _assert_same_bits(state, saved.restore(1, state))
        # The next step: the port's step on that state and on the first
        # batch of the iterator (which restarts from its seed, as the
        # JAX recipe's does).
        args = finetune.parse_args(argv + ['--steps', '3'])
        config = llama.get_config('tiny', max_seq_len=args.seq)
        batch = next(finetune.data_iterator(args, config.vocab_size,
                                            np.random.default_rng(0)))
        step = train_lib.build_train_step(
            config, optimizer=train_lib.default_optimizer(args.lr))
        want, metrics = step(state, {'tokens': torch.from_numpy(batch)})
        assert steps[0].group(2) == f'{float(metrics["loss"]):.4f}'
        assert steps[0].group(3) == f'{float(metrics["grad_norm"]):.3f}'
        _assert_same_bits(saved.restore(2, state), want)
    finally:
        saved.close()


def test_checkpoint_dir_defaults_to_the_env(tmp_path, task, monkeypatch,
                                            capsys):
    monkeypatch.setenv('SKYTPU_CHECKPOINT_DIR', str(tmp_path))
    assert finetune.parse_args([]).checkpoint_dir == str(tmp_path)
    finetune.main(TINY + ['--steps', '1', '--checkpoint-interval', '1'])
    assert tcheckpoint.committed_steps(str(tmp_path / task)) == [0]
    finetune.main(TINY + ['--steps', '2', '--checkpoint-interval', '1'])
    assert 'resumed from checkpoint at step 1' in capsys.readouterr().out


@pytest.mark.parametrize('case', ['fresh', 'existing', 'resized'])
def test_elastic_design_matches_jax(tmp_path, monkeypatch, case):
    """``_elastic_design`` writes, reads and guesses the design as the
    JAX recipe's does; the port's single device then rescales the global
    batch (and with --elastic-scale-lr the learning rate)."""
    monkeypatch.delenv('SKYTPU_ELASTIC_RESIZED', raising=False)
    dirs = {name: str(tmp_path / name) for name in ('jax', 'port')}
    for lineage in dirs.values():
        if case == 'existing':
            os.makedirs(lineage)
            with open(os.path.join(lineage, 'design.json'), 'w',
                      encoding='utf-8') as f:
                json.dump({'device_count': 4, 'global_batch': 8}, f)
        if case == 'resized':
            tcheckpoint.save_tree(lineage, 0, {'w': np.zeros(2, np.float32)})
            with open(os.path.join(lineage, 'step_00000000',
                                   'manifest.json'), encoding='utf-8') as f:
                doc = json.load(f)
            doc['device_count'] = 8
            with open(os.path.join(lineage, 'step_00000000',
                                   'manifest.json'), 'w',
                      encoding='utf-8') as f:
                json.dump(doc, f)
    if case == 'resized':
        monkeypatch.setenv('SKYTPU_ELASTIC_RESIZED', 'v5p-16 -> v5p-8')
    want = jfinetune._elastic_design(dirs['jax'], 1, 6)  # noqa: SLF001
    got = finetune._elastic_design(dirs['port'], 1, 6)  # noqa: SLF001
    assert got == want
    assert (os.path.exists(os.path.join(dirs['port'], 'design.json')) ==
            os.path.exists(os.path.join(dirs['jax'], 'design.json')))
    if case == 'fresh':
        return
    monkeypatch.setenv('SKYTPU_TASK_ID', 'port')
    args = finetune.parse_args(TINY + ['--checkpoint-dir', str(tmp_path),
                                       '--batch', '6', '--lr', '0.008',
                                       '--elastic-scale-lr'])
    finetune.build(args)
    n_design = want['device_count']
    assert args.batch == max(1, want['global_batch'] // n_design)
    assert args.lr == pytest.approx(0.008 / n_design)
    args = finetune.parse_args(TINY + ['--checkpoint-dir', str(tmp_path),
                                       '--batch', '6', '--no-elastic'])
    finetune.build(args)
    assert args.batch == 6
