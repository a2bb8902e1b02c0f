"""The port's mesh arithmetic and bootstrap (skypilot_torch/parallel/
mesh.py, distributed.py) against the JAX package's: the plan functions
over a grid of device counts and axes, the rank layout of ``make_mesh``
against JAX's reshape of the 8-device CPU list, and ``initialize``'s
reading of the env contract (``init_process_group`` recorded, not
run). The mesh's groups over real ranks are held in
``test_torch_fsdp.py``."""
import itertools

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.parallel import distributed as jdistributed
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_torch.parallel import distributed
from skypilot_torch.parallel import mesh

AXIS_GRID = [dict(zip(('tp', 'sp', 'dp', 'ep', 'pp'), v))
             for v in itertools.product((1, 2), (1, 2), (1, 2, 4), (1, 2),
                                        (1, 2))]


def _outcome(fn, *args, **kwargs):
    """fn's result, or the type and message of what it raised."""
    try:
        return fn(*args, **kwargs)
    except ValueError as e:
        return ('ValueError', str(e))


def _cfg(c):
    return None if isinstance(c, tuple) else c.shape()


@pytest.mark.parametrize('n', [1, 2, 4, 6, 8, 16])
@pytest.mark.parametrize('num_slices', [1, 2])
def test_auto_mesh_config_equals_jax(n, num_slices):
    for axes in AXIS_GRID:
        want = _outcome(jmesh.auto_mesh_config, n, num_slices=num_slices,
                        **axes)
        got = _outcome(mesh.auto_mesh_config, n, num_slices=num_slices,
                       **axes)
        if isinstance(want, tuple):
            assert got == want, axes
        else:
            assert got.shape() == want.shape(), axes


def test_auto_mesh_config_defaults_to_the_world_size():
    assert not distributed.is_initialized()
    assert mesh.auto_mesh_config() == mesh.MeshConfig()
    assert _outcome(mesh.auto_mesh_config, dp=2) == _outcome(
        jmesh.auto_mesh_config, 1, dp=2)


CONFIGS = [dict(fsdp=8), dict(dp=2, fsdp=4), dict(dp=8), dict(tp=2, fsdp=4),
           dict(pp=2, dp=2, fsdp=2), dict(ep=2, fsdp=2, tp=2),
           dict(sp=2, fsdp=2, dp=2), dict(dp=4, fsdp=3), dict(fsdp=6, tp=2)]


@pytest.mark.parametrize('kw', CONFIGS, ids=lambda kw: '.'.join(
    f'{k}{v}' for k, v in kw.items()))
def test_plan_functions_equal_jax(kw):
    jc, tc = jmesh.MeshConfig(**kw), mesh.MeshConfig(**kw)
    assert mesh.describe_config(tc) == jmesh.describe_config(jc)
    assert tc.num_devices == jc.num_devices
    for n in range(1, 33):
        want = _outcome(jmesh.replan_mesh_config, jc, n)
        got = _outcome(mesh.replan_mesh_config, tc, n)
        assert _cfg(got) == _cfg(want) and (
            not isinstance(want, tuple) or got == want), n
        if isinstance(want, tuple):
            continue
        for batch in (8, 12, 24, 48, 96):
            assert _outcome(mesh.rescale_global_batch, batch, tc, got) == \
                _outcome(jmesh.rescale_global_batch, batch, jc, want)
    assert mesh.data_axes() == jmesh.data_axes()


@pytest.mark.parametrize('kw', [dict(fsdp=8), dict(dp=2, fsdp=4),
                                dict(pp=2, dp=2, fsdp=2),
                                dict(dp=2, ep=2, tp=2),
                                dict(fsdp=2, tp=2, sp=2), dict(fsdp=4)],
                         ids=str)
def test_rank_layout_is_jax_device_reshape(kw):
    """make_mesh's ranks sit where JAX's reshape puts the devices of
    the same index (CPU device ids are 0..7 in list order)."""
    tc = mesh.MeshConfig(**kw)
    devices = jax.devices()[:tc.num_devices]
    jm = jmesh.make_mesh(jmesh.MeshConfig(**kw), devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(jm.devices)
    np.testing.assert_array_equal(mesh.rank_grid(tc), ids)
    assert tuple(jm.axis_names) == mesh.AXES
    for b in (8, 16, 12):
        assert _outcome(mesh.batch_size_per_device, b,
                        type('M', (), {'shape': tc.shape()})) == \
            _outcome(jmesh.batch_size_per_device, b, jm)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match='process group'):
        mesh.make_mesh(mesh.MeshConfig())


@pytest.fixture
def one_rank(tmp_path):
    """A gloo group of this process alone (file store), left at
    teardown."""
    distributed.initialize(force=True, device='cpu',
                           init_method=f'file://{tmp_path}/store',
                           timeout_s=30)
    try:
        yield
    finally:
        distributed.shutdown()


def test_make_mesh_errors_and_one_rank_groups(one_rank):
    with pytest.raises(ValueError, match='Mesh needs 2 devices, got 1'):
        mesh.make_mesh(mesh.MeshConfig(fsdp=2))
    with pytest.raises(ValueError, match='multiple of num_slices'):
        mesh.make_mesh(mesh.MeshConfig(), num_slices=2)
    m = mesh.make_mesh()
    assert m.shape == mesh.MeshConfig().shape()
    assert m.coordinate == dict.fromkeys(mesh.AXES, 0)
    np.testing.assert_array_equal(m.grid, mesh.rank_grid(m.config))
    import torch.distributed as dist
    for axes in (('fsdp',), ('fsdp', 'ep'), ('dp', 'fsdp', 'ep')):
        assert dist.get_process_group_ranks(m.group(axes)) == [0]
        assert m.index(axes) == 0
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    # A second call is ignored.
    assert distributed.initialize(force=True, device='cpu') is False


CONTRACT = ('SKYTPU_NODE_RANK', 'SKYTPU_NUM_NODES', 'SKYTPU_NODE_IPS',
            'SKYTPU_COORDINATOR_PORT', 'SKYTPU_COORDINATOR_ADDRESS',
            'SKYTPU_NUM_CHIPS_PER_NODE')


@pytest.fixture
def recorded(monkeypatch):
    """``init_process_group`` replaced by a recorder; the contract's
    variables cleared."""
    for name in CONTRACT:
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(distributed.dist, 'init_process_group',
                        lambda backend, **kw: calls.append(
                            dict(backend=backend, **kw)))
    return calls


@pytest.mark.parametrize('env', [
    {},
    {'SKYTPU_NUM_NODES': '1', 'SKYTPU_NODE_IPS': '10.0.0.1'},
    {'SKYTPU_NUM_NODES': '2', 'SKYTPU_NODE_RANK': '1',
     'SKYTPU_NODE_IPS': '10.0.0.1\n10.0.0.2'},
    {'SKYTPU_NUM_NODES': '4', 'SKYTPU_NODE_IPS': 'a b c d',
     'SKYTPU_COORDINATOR_PORT': '9000'},
])
def test_env_helpers_equal_jax(env, monkeypatch):
    for name in CONTRACT:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.env_is_multihost() == jdistributed.env_is_multihost()
    assert distributed.coordinator_address() == \
        jdistributed.coordinator_address()
    assert distributed.COORDINATOR_PORT_DEFAULT == \
        jdistributed.COORDINATOR_PORT_DEFAULT


def test_initialize_is_a_no_op_for_one_process(recorded):
    assert distributed.initialize(device='cpu') is False
    assert recorded == []


def test_initialize_reads_the_contract_on_cpu(recorded, monkeypatch):
    monkeypatch.setenv('SKYTPU_NUM_NODES', '2')
    monkeypatch.setenv('SKYTPU_NODE_RANK', '1')
    monkeypatch.setenv('SKYTPU_NODE_IPS', '10.0.0.1\n10.0.0.2')
    monkeypatch.setenv('SKYTPU_COORDINATOR_PORT', '9123')
    monkeypatch.setenv('SKYTPU_NUM_CHIPS_PER_NODE', '4')
    assert distributed.local_world_size('cpu') == 4
    assert distributed.initialize(local_rank=3, device='cpu') is True
    (call,) = recorded
    assert call['backend'] == 'gloo'
    assert call['rank'] == 1 * 4 + 3 and call['world_size'] == 8
    assert call['init_method'] == 'tcp://10.0.0.1:9123'
    assert call['timeout'].total_seconds() == \
        distributed.TIMEOUT_SECONDS_DEFAULT
    with pytest.raises(ValueError, match='pass local_rank'):
        distributed.initialize(device='cpu')
    with pytest.raises(ValueError, match='outside'):
        distributed.initialize(local_rank=4, device='cpu')


def test_initialize_prefers_the_coordinator_address(recorded, monkeypatch):
    monkeypatch.setenv('SKYTPU_NODE_IPS', '10.0.0.1')
    monkeypatch.setenv('SKYTPU_COORDINATOR_ADDRESS', '10.9.9.9:1234')
    assert distributed.local_world_size('cpu') == 1
    distributed.initialize(force=True, device='cpu')
    assert recorded[0]['init_method'] == 'tcp://10.9.9.9:1234'
    assert recorded[0]['rank'] == 0 and recorded[0]['world_size'] == 1
    monkeypatch.delenv('SKYTPU_COORDINATOR_ADDRESS')
    monkeypatch.delenv('SKYTPU_NODE_IPS')
    distributed.initialize(force=True, device='cpu')
    assert recorded[1]['init_method'] == 'tcp://127.0.0.1:8476'


def test_initialize_on_cuda_binds_nccl_to_the_local_gpu(recorded,
                                                        monkeypatch):
    """On cuda: one process per visible GPU, NCCL, the process bound to
    GPU ``local_rank``; without NCCL it raises (no gloo fallback)."""
    bound = []
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 8)
    monkeypatch.setattr(torch.cuda, 'set_device', bound.append)
    monkeypatch.setattr(distributed.dist, 'is_nccl_available', lambda: True)
    monkeypatch.setenv('SKYTPU_NUM_NODES', '2')
    monkeypatch.setenv('SKYTPU_NODE_RANK', '1')
    assert distributed.local_world_size('cuda') == 8
    distributed.initialize(local_rank=5, device='cuda')
    assert recorded[0]['backend'] == 'nccl' and bound == [5]
    assert recorded[0]['rank'] == 13 and recorded[0]['world_size'] == 16
    monkeypatch.setattr(distributed.dist, 'is_nccl_available', lambda: False)
    with pytest.raises(RuntimeError, match='NCCL'):
        distributed.initialize(local_rank=5, device='cuda')
