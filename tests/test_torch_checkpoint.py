"""The port's native checkpoint engine (skypilot_torch/checkpoint/,
data/checkpoint.py, resilience/faults.py) on the CPU, case by case
against tests/test_checkpoint.py, and across engines: a TrainState the
JAX engine wrote restores into the port and the reverse (LoRA, full
finetune and QLoRA on ``tiny``, every leaf bit-equal), a JAX state saved
on the 8-device CPU mesh restores whole into the port, and the port's
keys are ``format.key_str`` of the JAX tree. Every barrier and writer
wait runs under its own short timeout, and every manager is closed."""
import functools
import os
import threading
import time

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
from skypilot_torch import metrics as tmetrics
from skypilot_torch.checkpoint import commit as commit_lib
from skypilot_torch.checkpoint import format as format_lib
from skypilot_torch.checkpoint import native
from skypilot_torch.checkpoint import retention as retention_lib
from skypilot_torch.checkpoint import writer as writer_lib
from skypilot_torch.checkpoint.format import (CheckpointError,
                                              CheckpointRestoreError)
from skypilot_torch.data import checkpoint as facade
from skypilot_torch.models import llama as tllama
from skypilot_torch.parallel import train as ttrain
from skypilot_torch.resilience import faults as tfaults

TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def port_faults():
    """The port's fault registry, fresh around each test (conftest
    resets only the JAX package's)."""
    tfaults.reset()
    yield tfaults
    tfaults.reset()


@pytest.fixture
def make_mgr(tmp_path):
    """Port managers that are closed at teardown whatever the test
    did."""
    made = []

    def make(path=None, **kwargs):
        kwargs.setdefault('save_interval_steps', 1)
        kwargs.setdefault('process_index', 0)
        kwargs.setdefault('process_count', 1)
        mgr = tcheckpoint.NativeCheckpointManager(
            str(path or tmp_path), **kwargs)
        made.append(mgr)
        return mgr

    yield make
    for mgr in made:
        try:
            _bounded(mgr.close)
        except BaseException:  # pylint: disable=broad-except
            pass


def _bounded(fn, timeout=TIMEOUT):
    """``fn()`` on a daemon thread: fails the test instead of hanging
    the worker if it does not return within ``timeout``; re-raises what
    it raised."""
    box = {}

    def run():
        try:
            box['value'] = fn()
        except BaseException as e:  # pylint: disable=broad-except
            box['error'] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f'{fn} did not return within {timeout} s'
    if 'error' in box:
        raise box['error']
    return box.get('value')


def _age_dir(path, seconds=120):
    """Backdate a torn-write dir past the GC's live-writer grace."""
    past = time.time() - seconds
    for name in os.listdir(path):
        os.utime(os.path.join(path, name), (past, past))
    os.utime(path, (past, past))


def _tree():
    return {
        'params': {'w': torch.arange(32, dtype=torch.float32).reshape(8, 4),
                   'b': torch.ones(4, dtype=torch.bfloat16)},
        'step': np.int64(7),
    }


def _bits(x):
    """Host bits of a leaf of either engine: bfloat16 as uint16."""
    if isinstance(x, torch.Tensor):
        return native.host_leaf(x)[0]
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == 'bfloat16' else arr


def _assert_bits_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = _bits(got[key]), _bits(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


# ---------------------------------------------------------------------
# The engine on its own (tests/test_checkpoint.py, case by case)
# ---------------------------------------------------------------------


def test_checksum_detects_corruption(make_mgr, tmp_path):
    mgr = make_mgr()
    mgr.save(0, _tree())
    _bounded(mgr.wait)
    step_dir = tmp_path / commit_lib.step_dir_name(0)
    shard = next(p for p in step_dir.iterdir() if p.name.endswith('.bin'))
    data = bytearray(shard.read_bytes())
    data[0] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(CheckpointRestoreError, match='checksum'):
        mgr.restore_latest_raw()
    # No fallback to the template either.
    with pytest.raises(CheckpointRestoreError, match='checksum'):
        mgr.restore_or(_tree())


def test_train_state_round_trip_into_another_seed(tmp_path):
    """The facade saves a LoRA TrainState; a template drawn from another
    seed gets every leaf back from disk, on its own device and dtype."""
    cfg = tllama.get_config('tiny')
    state = ttrain.init_train_state(cfg, seed=0, lora_rank=4,
                                    device='cpu')
    state = ttrain.build_train_step(cfg)(state, {'tokens': torch.randint(
        0, 512, (2, 17), generator=torch.Generator().manual_seed(0))})[0]
    ckpt = facade.CheckpointManager(str(tmp_path / 'ck'),
                                    save_interval_steps=1,
                                    use_task_namespace=False)
    assert ckpt.engine == 'native'
    assert ckpt.maybe_save(3, state)
    _bounded(ckpt.wait)
    _bounded(ckpt.close)
    other = ttrain.init_train_state(cfg, seed=9, lora_rank=4, device='cpu')
    ckpt2 = facade.CheckpointManager(str(tmp_path / 'ck'),
                                     use_task_namespace=False)
    try:
        restored, next_step = ckpt2.restore_or(other)
        assert next_step == 4
        assert isinstance(restored, ttrain.TrainState)
        assert restored.step == 1 and restored.opt_state.count == 1
        _assert_bits_equal(tcheckpoint.flatten(restored.checkpoint_tree()),
                           tcheckpoint.flatten(state.checkpoint_tree()))
        assert ckpt2.last_restore['resharded'] is False
        assert ckpt2.last_restore['saved_device_count'] == 1
        raw = ckpt2.restore_latest_raw(keys=('params', 'lora'))
        assert set(raw) == {'params', 'lora'}
        assert torch.equal(raw['lora']['wq_b'], state.lora['wq_b'])
        assert ckpt2.restore_latest_raw(keys=('nonexistent',)) is None
    finally:
        _bounded(ckpt2.close)


def test_empty_dir_restores_template_at_step_zero(make_mgr):
    mgr = make_mgr()
    tree = _tree()
    out, start = mgr.restore_or(tree)
    assert start == 0 and out is tree
    assert mgr.restore_latest_raw() is None


def test_save_interval(make_mgr):
    mgr = make_mgr(save_interval_steps=2, max_to_keep=None)
    for step in range(5):
        assert mgr.maybe_save(step, _tree()) == (step % 2 == 0)
    _bounded(mgr.wait)
    assert mgr.all_steps() == [0, 2, 4]


def test_template_mismatch_is_loud(make_mgr):
    mgr = make_mgr()
    mgr.save(0, _tree())
    _bounded(mgr.wait)
    with pytest.raises(CheckpointRestoreError, match='missing'):
        mgr.restore(0, {'params': {'w': torch.zeros(8, 4),
                                   'UNKNOWN': torch.zeros(2)},
                        'step': np.int64(0)})
    with pytest.raises(CheckpointRestoreError, match='saved shape'):
        mgr.restore(0, {'params': {'w': torch.zeros(4, 8),
                                   'b': torch.zeros(4)},
                        'step': np.int64(0)})


def test_snapshot_is_a_copy(make_mgr):
    """The loop may update the state in place once maybe_save returns."""
    mgr = make_mgr()
    tree = _tree()
    want = tree['params']['w'].clone()
    mgr.save(0, tree)
    tree['params']['w'].add_(1.0)
    _bounded(mgr.wait)
    assert torch.equal(mgr.restore_latest_raw()['params']['w'], want)


@pytest.mark.parametrize('armed_by', ['arm', 'env'])
def test_torn_write_is_never_visible(make_mgr, tmp_path, monkeypatch,
                                     armed_by):
    mgr = make_mgr()
    tree = _tree()
    mgr.save(1, tree)
    _bounded(mgr.wait)
    assert mgr.latest_step() == 1
    if armed_by == 'arm':
        tfaults.arm('checkpoint.save', 'preempt', 1.0, 1)
    else:
        monkeypatch.setenv('SKYTPU_FAULTS', 'checkpoint.save:preempt:1.0:1')
        tfaults.reset()  # the env is read at the next fire
    mgr.save(2, tree)
    _bounded(mgr.wait)  # abandoned silently, like a dead process
    assert mgr.latest_step() == 1
    torn = tmp_path / commit_lib.tmp_dir_name(2)
    assert torn.is_dir()
    # A fresh torn dir may belong to a live writer: spared.
    assert commit_lib.gc_orphaned_tmp(str(tmp_path)) == []
    _age_dir(str(torn))
    # A restore-only consumer never sweeps ...
    mgr2 = make_mgr()
    assert torn.is_dir() and mgr2.latest_step() == 1
    raw = mgr2.restore_latest_raw()
    assert torch.equal(raw['params']['w'], tree['params']['w'])
    # ... the relaunched writer sweeps before its first save.
    mgr2.save(3, tree)
    _bounded(mgr2.wait)
    assert not torn.exists()
    assert mgr2.all_steps() == [1, 3]


def test_injected_error_surfaces_on_wait_and_the_step_retries(make_mgr):
    mgr = make_mgr()
    tfaults.arm('checkpoint.save', 'error', 1.0, 1)
    mgr.save(0, _tree())
    with pytest.raises(CheckpointError, match='checkpoint.save'):
        _bounded(mgr.wait)
    assert mgr.latest_step() is None
    assert mgr.save(0, _tree())  # the failed step is retried, not deduped
    _bounded(mgr.wait)
    assert mgr.latest_step() == 0


def test_uncommitted_dir_is_not_a_checkpoint(make_mgr, tmp_path):
    fake = tmp_path / commit_lib.step_dir_name(5)
    fake.mkdir(parents=True)
    (fake / 'h0_00000_0.bin').write_bytes(b'\x00' * 16)
    assert commit_lib.committed_steps(str(tmp_path)) == []
    _age_dir(str(fake))
    mgr = make_mgr()
    assert mgr.latest_step() is None and fake.exists()
    mgr.save(0, _tree())  # the first save sweeps it
    _bounded(mgr.wait)
    assert not fake.exists()
    assert mgr.latest_step() == 0


def test_retention_plan_and_gc(make_mgr, tmp_path):
    steps = [1, 2, 3, 4, 5]
    assert retention_lib.plan_retention(steps, None) == []
    assert retention_lib.plan_retention(steps, 2) == [1, 2, 3]
    assert retention_lib.plan_retention(steps, 2, keep_period=2) == [1]
    assert retention_lib.plan_retention(steps, 1) == [1, 2, 3, 4]
    assert retention_lib.plan_retention([7], 1) == []
    mgr = make_mgr(tmp_path / 'a', max_to_keep=2, keep_period=10)
    for step in range(12):
        mgr.save(step, _tree())
    _bounded(mgr.wait)
    assert mgr.all_steps() == [0, 9, 10, 11]
    other = make_mgr(tmp_path / 'b', max_to_keep=None)
    for step in (1, 2, 3):
        other.save(step, _tree())
    _bounded(other.wait)
    assert tcheckpoint.apply_retention(str(tmp_path / 'b'), 1) == [1, 2]
    assert commit_lib.committed_steps(str(tmp_path / 'b')) == [3]


def test_submit_blocks_at_queue_depth():
    release = threading.Event()
    taken = []

    def slow_write(step, payload):
        taken.append(step)
        assert release.wait(timeout=TIMEOUT)
        return 0

    writer = writer_lib.AsyncWriter(slow_write, queue_depth=1)
    try:
        writer.submit(0, None)
        deadline = time.monotonic() + 5
        while not taken and time.monotonic() < deadline:
            time.sleep(0.01)
        assert taken == [0]      # the writer thread holds snapshot 0
        writer.submit(1, None)   # fills the depth-1 queue
        third_done = threading.Event()
        t = threading.Thread(target=lambda: (writer.submit(2, None),
                                             third_done.set()),
                             daemon=True)
        t.start()
        assert not third_done.wait(0.3)  # blocked: the queue is full
        release.set()
        assert third_done.wait(5)        # drained -> unblocked
    finally:
        release.set()
        _bounded(writer.close)
    assert taken == [0, 1, 2]


def test_queue_depth_gauge_bounded(make_mgr):
    mgr = make_mgr(queue_depth=2, max_to_keep=None)
    for step in range(6):
        mgr.save(step, _tree())
    _bounded(mgr.wait)
    gauge = writer_lib.ckpt_metrics()['queue_depth']
    assert 0 <= gauge.value <= 2
    assert mgr.all_steps() == list(range(6))


def test_rank0_commits_only_after_every_manifest(make_mgr, tmp_path):
    tree = _tree()
    m0 = make_mgr(process_index=0, process_count=2, barrier_timeout=20.0)
    m1 = make_mgr(process_index=1, process_count=2)
    done0 = threading.Event()
    t = threading.Thread(target=lambda: (m0.save(0, tree), m0.wait(),
                                         done0.set()), daemon=True)
    t.start()
    assert not done0.wait(0.5)
    assert commit_lib.latest_committed_step(str(tmp_path)) is None
    m1.save(0, tree)
    _bounded(m1.wait)
    assert done0.wait(TIMEOUT)
    assert commit_lib.latest_committed_step(str(tmp_path)) == 0
    # Rank 1 holds every leaf whole, so only rank 0 wrote shards.
    assert m0.restore_latest_raw()['params']['w'].shape == (8, 4)


def test_a_manifest_appears_whole(tmp_path, monkeypatch):
    """Rank 0's barrier reads another rank's manifest as soon as its name
    exists, so the name must appear only with the whole file."""
    real_dump = format_lib.json.dump
    half_written = threading.Event()

    def slow_dump(doc, f):
        f.write('{')
        f.flush()
        half_written.set()
        time.sleep(0.3)
        f.seek(0)
        real_dump(doc, f)

    monkeypatch.setattr(format_lib.json, 'dump', slow_dump)
    path = tmp_path / format_lib.HOST_MANIFEST_FMT.format(proc=1)
    t = threading.Thread(target=format_lib.write_host_manifest,
                         args=(str(tmp_path), 1, {}, 2), daemon=True)
    t.start()
    assert half_written.wait(TIMEOUT)
    assert not path.exists()
    t.join(TIMEOUT)
    assert not t.is_alive()
    monkeypatch.setattr(format_lib.json, 'dump', real_dump)
    assert format_lib.json.loads(path.read_text())['process_index'] == 1


def test_barrier_timeout_leaves_step_uncommitted(make_mgr, tmp_path):
    m0 = make_mgr(process_index=0, process_count=2, barrier_timeout=0.2)
    m0.save(0, _tree())
    with pytest.raises(CheckpointError, match='never wrote'):
        _bounded(m0.wait)
    assert commit_lib.latest_committed_step(str(tmp_path)) is None


def test_complementary_shards_assemble(make_mgr, tmp_path):
    """Two hosts each wrote half of one leaf (the JAX engine's
    multi-host layout); the merged manifest assembles it whole."""
    step_tmp = tmp_path / commit_lib.tmp_dir_name(0)
    step_tmp.mkdir()
    full = np.arange(32, dtype=np.float32).reshape(8, 4)
    for proc, (lo, hi) in ((0, (0, 4)), (1, (4, 8))):
        entry = format_lib.leaf_entry(full.dtype, full.shape)
        size, crc = format_lib.write_shard_file(
            str(step_tmp), f'h{proc}_w.bin', full[lo:hi])
        entry['shards'].append({'file': f'h{proc}_w.bin',
                                'index': [[lo, hi], [0, 4]],
                                'nbytes': size, 'checksum': crc})
        format_lib.write_host_manifest(str(step_tmp), proc, {'w': entry}, 2)
    merged = format_lib.merge_host_manifests(str(step_tmp), 2)
    format_lib.write_manifest(str(step_tmp), 0, merged, 2)
    commit_lib.commit(str(tmp_path), 0)
    mgr = make_mgr()
    np.testing.assert_array_equal(mgr.restore_latest_raw()['w'].numpy(),
                                  full)
    out, start = mgr.restore_or({'w': torch.zeros(8, 4)})
    assert start == 1 and torch.equal(out['w'], torch.from_numpy(full))
    assert mgr.last_restore['resharded'] is True


@pytest.mark.parametrize('first,retried,lineage', [
    ('managed-7-0-3', 'managed-7-0-12', 'managed-7-0'),
    ('exp-1', 'exp-1', 'exp-1'),
    ('sky-2026-08-03-12-00-00-77-1-mytask', None,
     'sky-2026-08-03-12-00-00-77-1-mytask'),
])
def test_task_lineage_strip(monkeypatch, tmp_path, first, retried,
                            lineage):
    """Managed-job retries share a lineage; a user's trailing counter
    is not a retry counter."""
    from skypilot_tpu.data import checkpoint as jfacade
    base = str(tmp_path)
    for task_id in filter(None, (first, retried)):
        monkeypatch.setenv('SKYTPU_TASK_ID', task_id)
        assert facade.task_checkpoint_dir(base) == \
            os.path.join(base, lineage) == jfacade.task_checkpoint_dir(base)
    monkeypatch.delenv('SKYTPU_TASK_ID')
    monkeypatch.delenv('SKYPILOT_TASK_ID', raising=False)
    assert facade.task_checkpoint_dir(base) == os.path.join(base, 'default')


def test_lineage_shared_across_retries(monkeypatch, tmp_path):
    monkeypatch.setenv('SKYTPU_TASK_ID', 'managed-1-0-1')
    mgr = facade.CheckpointManager(str(tmp_path), save_interval_steps=1)
    mgr.maybe_save(4, _tree())
    _bounded(mgr.wait)
    _bounded(mgr.close)
    monkeypatch.setenv('SKYTPU_TASK_ID', 'managed-1-0-2')
    mgr2 = facade.CheckpointManager(str(tmp_path))
    try:
        _, start = mgr2.restore_or(_tree())
        assert start == 5
        assert mgr2.saved_device_count() == 1
    finally:
        _bounded(mgr2.close)


def test_engine_selection(monkeypatch, tmp_path):
    assert facade.selected_engine() == 'native'
    monkeypatch.setenv('SKYTPU_CKPT_ENGINE', 'bogus')
    with pytest.raises(ValueError, match='bogus'):
        facade.selected_engine()
    monkeypatch.setenv('SKYTPU_CKPT_ENGINE', 'orbax')
    assert facade.selected_engine() == 'orbax'
    with pytest.raises(NotImplementedError, match='item 22'):
        facade.CheckpointManager(str(tmp_path))
    # No fallback to native: nothing was made.
    assert os.listdir(tmp_path) == []


def test_metrics_export(make_mgr):
    fams = writer_lib.ckpt_metrics()
    saves = fams['saves_total'].labels(outcome='ok').value
    nbytes = fams['bytes_total'].value
    restores = fams['restores_total'].labels(outcome='ok').value
    mgr = make_mgr()
    mgr.save(0, _tree())
    _bounded(mgr.wait)
    assert mgr.restore_latest_raw() is not None
    assert fams['saves_total'].labels(outcome='ok').value == saves + 1
    assert fams['bytes_total'].value == nbytes + 32 * 4 + 4 * 2 + 8
    assert fams['last_committed_step'].value == 0
    assert fams['restores_total'].labels(outcome='ok').value == restores + 1
    text = tmetrics.render_text(tmetrics.registry())
    for name in ('skytpu_ckpt_save_seconds', 'skytpu_ckpt_bytes_total',
                 'skytpu_ckpt_queue_depth', 'skytpu_ckpt_saves_total',
                 'skytpu_ckpt_restores_total',
                 'skytpu_ckpt_last_committed_step'):
        assert name in text


# ---------------------------------------------------------------------
# Across engines
# ---------------------------------------------------------------------

KINDS = ('lora', 'full', 'qlora')


def _randomized(tree, rng):
    """``tree`` (a JAX TrainState or the port's checkpoint tree) with
    every leaf redrawn from ``rng``, dtype and placement kept."""
    def draw(name, shape):
        if name == 'int8':
            return rng.integers(-127, 128, size=shape).astype(np.int8)
        if name.startswith('int'):
            return rng.integers(1, 1000, size=shape).astype(name)
        return rng.standard_normal(shape).astype(np.float32)

    def jax_leaf(x):
        return jax.device_put(jnp.asarray(
            draw(np.dtype(x.dtype).name, x.shape), x.dtype), x.sharding)

    def port_leaf(_, x):
        if isinstance(x, torch.Tensor):
            name = str(x.dtype).replace('torch.', '')
            return torch.from_numpy(draw(name, tuple(x.shape))).to(x.dtype)
        return draw(x.dtype.name, x.shape)

    if isinstance(tree, jtrain.TrainState):
        return jax.tree.map(jax_leaf, tree)
    return native._map_leaves(tree, port_leaf)  # noqa: SLF001


@functools.lru_cache(maxsize=None)
def _jax_state(kind: str, fsdp: int = 1):
    cfg = jllama.get_config('tiny')
    devices = jax.devices()[:fsdp]
    mesh = jmesh.make_mesh(jmesh.MeshConfig(fsdp=fsdp), devices=devices)
    key = jax.random.PRNGKey(3)
    if kind == 'qlora':
        state, _ = jtrain.init_qlora_state(cfg, mesh, key, lora_rank=4)
    else:
        state, _ = jtrain.init_train_state(
            cfg, mesh, key, lora_rank=None if kind == 'full' else 4)
    return _randomized(state, np.random.default_rng(fsdp))


def _port_state(kind: str, seed: int = 9):
    cfg = tllama.get_config('tiny')
    if kind == 'qlora':
        return ttrain.init_qlora_state(cfg, seed=seed, lora_rank=4,
                                       device='cpu')
    return ttrain.init_train_state(
        cfg, seed=seed, lora_rank=None if kind == 'full' else 4,
        device='cpu')


def _jax_flat(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jformat.key_str(path): leaf for path, leaf in flat}


@pytest.mark.parametrize('kind', KINDS)
def test_port_keys_are_the_jax_key_strings(kind):
    want = sorted(_jax_flat(_jax_state(kind)))
    got = tcheckpoint.flatten(_port_state(kind).checkpoint_tree())
    assert sorted(got) == want
    assert 'opt_state/1/0/count' in want and 'step' in want
    # Dtypes on disk are JAX's: int32 counters, the same float types.
    jleaves = _jax_flat(_jax_state(kind))
    for key, leaf in got.items():
        assert native.host_leaf(leaf)[1] == np.dtype(
            jleaves[key].dtype).name, key


@pytest.mark.parametrize('kind', KINDS)
def test_jax_written_state_restores_into_the_port(kind, make_mgr,
                                                  tmp_path):
    jstate = _jax_state(kind)
    jmgr = JaxManager(str(tmp_path), process_index=0, process_count=1)
    try:
        jmgr.save(5, jstate)
        _bounded(jmgr.wait)
    finally:
        _bounded(jmgr.close)
    mgr = make_mgr()
    restored, start = mgr.restore_or(_port_state(kind))
    assert start == 6
    _assert_bits_equal(tcheckpoint.flatten(restored.checkpoint_tree()),
                       _jax_flat(jstate))
    assert mgr.last_restore['resharded'] is False


@pytest.mark.parametrize('kind', KINDS)
def test_port_written_state_restores_into_jax(kind, make_mgr, tmp_path):
    state = ttrain.TrainState.from_checkpoint_tree(_randomized(
        _port_state(kind, seed=1).checkpoint_tree(),
        np.random.default_rng(4)))
    mgr = make_mgr()
    mgr.save(2, state)
    _bounded(mgr.wait)
    jmgr = JaxManager(str(tmp_path), process_index=0, process_count=1)
    try:
        restored, start = jmgr.restore_or(_jax_state(kind))
    finally:
        _bounded(jmgr.close)
    assert start == 3
    _assert_bits_equal(_jax_flat(restored),
                       tcheckpoint.flatten(state.checkpoint_tree()))


def test_jax_state_saved_on_the_8_device_mesh_restores_whole(make_mgr,
                                                             tmp_path):
    jstate = _jax_state('lora', fsdp=8)
    wq = jstate.params['layers']['wq']
    assert len({s.index for s in wq.addressable_shards}) > 1
    jmgr = JaxManager(str(tmp_path), process_index=0, process_count=1)
    try:
        jmgr.save(0, jstate)
        _bounded(jmgr.wait)
    finally:
        _bounded(jmgr.close)
    mgr = make_mgr()
    restored, start = mgr.restore_or(_port_state('lora'))
    assert start == 1
    _assert_bits_equal(tcheckpoint.flatten(restored.checkpoint_tree()),
                       _jax_flat(jstate))
    assert mgr.last_restore['resharded'] is True
    assert mgr.last_restore['saved_device_count'] == 8
    assert mgr.last_restore['device_count'] == 1
