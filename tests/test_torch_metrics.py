"""The port's metrics substrate (skypilot_torch/metrics/) against the JAX
package's (skypilot_tpu/metrics/), on the CPU: the same operations on a
JAX registry and a port registry render byte-equal Prometheus text that
each package's parser reads; the port publisher's textfile is read by
the JAX agent-side reader; every family the port's engine, replica and
trainer export has the JAX family's name, kind, help, labels and
buckets; the goodput accountant partitions wall clock as the JAX one
does and MFU resolves the port's card table; the card-memory sampler
degrades to nothing without CUDA and fills the gauges from an injected
stats source; the two windowed ratio gauges come, stay and go as the
JAX engine's do."""
import collections
import importlib
import math
import os
import threading
import time
import types

import pytest
import torch

from skypilot_tpu.metrics import device as jdevice
from skypilot_tpu.metrics import exposition as jexposition
from skypilot_tpu.metrics import goodput as jgoodput
from skypilot_tpu.metrics import publish as jpublish
from skypilot_tpu.serve import batching as jbatching
from skypilot_torch import metrics as tmetrics
from skypilot_torch.metrics import device, exposition, goodput, publish
from skypilot_torch.models import llama
from skypilot_torch.serve import batching

JREG = importlib.import_module('skypilot_tpu.metrics.registry')
TREG = importlib.import_module('skypilot_torch.metrics.registry')


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Fresh process registries and goodput accountants on both sides:
    both are process-global, and one worker runs many test files."""
    monkeypatch.setattr(JREG, '_default_registry', JREG.Registry())
    monkeypatch.setattr(TREG, '_default_registry', TREG.Registry())
    jgoodput.reset_accountant()
    goodput.reset_accountant()
    yield
    jgoodput.reset_accountant()
    goodput.reset_accountant()


class FakeDevice:
    def __init__(self, used=100, limit=1000, peak=500):
        self._stats = {'bytes_in_use': used, 'bytes_limit': limit,
                       'peak_bytes_in_use': peak}

    def memory_stats(self):
        return self._stats


# The engines' windowed ratio gauges are process-global and unlabeled
# (last writer wins): any engine alive in this process — another test's
# included — may register them into the current registry at any time.
RATIOS = ('skytpu_batch_prefix_hit_ratio', 'skytpu_batch_spec_accept_ratio')


def _own(reg):
    """The registry as the test's own writes left it (RATIOS aside):
    what ``render_text`` needs of it."""
    return types.SimpleNamespace(families=lambda: [
        f for f in reg.families() if f.name not in RATIOS])


def _specs(reg):
    """{name: (kind, help, labelnames, buckets)} of a registry's own
    families."""
    return {f.name: (f.kind, f.help, f.labelnames, f.buckets)
            for f in _own(reg).families()}


def _texts(ours, theirs):
    """Both registries' own families as Prometheus text."""
    return (exposition.render_text(_own(ours)),
            jexposition.render_text(_own(theirs)))


# ---------------------------------------------------------------------
# Exposition
# ---------------------------------------------------------------------


def _ops_basic(reg):
    reg.counter('skytpu_x_total', 'Xs.').inc(3)
    c = reg.counter('skytpu_req_total', 'Requests.', ('code', 'path'))
    c.labels('200', '/a').inc()
    c.labels(code='500', path='/b"q\\n\n').inc(2.5)
    g = reg.gauge('skytpu_ratio', 'A ratio\nwith a newline \\ and slash.')
    g.set(0.125)
    g.dec(1e-3)
    reg.gauge('skytpu_big', '').set(1e16)
    reg.gauge('skytpu_inf', 'Inf.').set(float('inf'))
    reg.gauge('skytpu_nan', 'NaN.').set(float('nan'))


def _ops_histograms(reg):
    h = reg.histogram('skytpu_lat_seconds', 'Latency.')
    for v in (0.0005, 0.003, 0.2, 7.0, 100.0, float('nan')):
        h.observe(v)
    hl = reg.histogram('skytpu_rate', 'Rates.', ('mode',),
                       buckets=(1.0, 0.1, 0.5))
    hl.labels(mode='greedy').observe(0.3)
    hl.labels(mode='sampled').observe(1.0)
    hl.labels(mode='sampled').observe(2.0)


def _ops_overflow(reg):
    fam = reg.gauge('skytpu_per_key', 'Per key.', ('key',))
    fam.max_label_sets = 3
    for i in range(6):
        fam.labels(key=f'k{i}').set(i)
    fam.remove(key='k1')
    reg.unregister('skytpu_never')


@pytest.mark.parametrize('ops', [_ops_basic, _ops_histograms, _ops_overflow])
def test_same_operations_render_byte_equal_text(ops):
    jreg, treg = JREG.Registry(), TREG.Registry()
    ops(jreg)
    ops(treg)
    text = exposition.render_text(treg)
    assert text == jexposition.render_text(jreg)
    assert treg.render() == text
    extra = (('proc', 'replica-1'), ('host', 'h"0'))
    assert exposition.render_text(treg, extra) == \
        jexposition.render_text(jreg, extra)
    # Each package's parser reads the other's text to the same series.
    assert jexposition.parse_text(text) == exposition.parse_text(text)


def test_registry_refuses_what_the_jax_registry_refuses():
    for mod in (JREG, TREG):
        reg = mod.Registry()
        reg.histogram('h', buckets=(1.0, 2.0))
        with pytest.raises(ValueError):
            reg.histogram('h', buckets=(1.0, 3.0))
        reg.counter('c', labelnames=('a',))
        with pytest.raises(ValueError):
            reg.gauge('c', labelnames=('a',))
        with pytest.raises(ValueError):
            reg.counter('c', labelnames=('b',))
        with pytest.raises(ValueError):
            reg.counter('c').labels('x').inc(-1)
        with pytest.raises(ValueError):
            reg.counter('1bad')


def test_windowed_rate_matches():
    jr, tr = JREG.WindowedRate(5.0), TREG.WindowedRate(5.0)
    for t in (100.0, 100.5, 101.2, 103.9, 107.0):
        jr.record(now=t)
        tr.record(now=t, count=1)
    for now in (101.0, 104.0, 106.5, 120.0):
        assert tr.rate(now) == jr.rate(now)


# ---------------------------------------------------------------------
# The textfile bridge
# ---------------------------------------------------------------------


def test_port_textfile_read_by_the_jax_reader(tmp_path):
    d = str(tmp_path / 'metrics.d')
    device.sample_device_memory([FakeDevice(100, 1000, 500)])
    tmetrics.registry().counter('skytpu_batch_requests_total',
                                'Requests.').inc(12)
    pub = publish.MetricsPublisher('replica', directory=d)
    pub.publish_once()
    fams = jexposition.parse_text(jpublish.read_textfiles(d))
    used = fams['skytpu_device_hbm_used_bytes'].samples[0]
    assert dict(used.labels) == {'proc': f'replica-{os.getpid()}',
                                 'device': '0'}
    assert used.value == 100
    assert fams['skytpu_batch_requests_total'].samples[0].value == 12
    pub.close()
    assert jpublish.read_textfiles(d) == ''


def test_headers_dedup_across_a_jax_and_a_port_publisher(tmp_path):
    d = str(tmp_path / 'metrics.d')
    tmetrics.registry().gauge('skytpu_goodput_ratio').set(0.5)
    JREG.registry().gauge('skytpu_goodput_ratio').set(0.25)
    a = publish.MetricsPublisher('train', directory=d)
    b = jpublish.MetricsPublisher('serve', directory=d)
    a.publish_once()
    b.publish_once()
    for text in (jpublish.read_textfiles(d), publish.read_textfiles(d)):
        assert text.count('# TYPE skytpu_goodput_ratio gauge') == 1
        samples = exposition.parse_text(text)['skytpu_goodput_ratio'].samples
        assert sorted(s.value for s in samples) == [0.25, 0.5]
    a.close()
    b.close()


def test_stale_files_skipped_and_swept(tmp_path):
    d = tmp_path / 'metrics.d'
    d.mkdir()
    stale = d / 'dead-1.prom'
    stale.write_text('# TYPE x gauge\nx 1\n')
    old = time.time() - 3600
    os.utime(stale, (old, old))
    assert publish.read_textfiles(str(d)) == ''
    assert not stale.exists()


@pytest.mark.parametrize('env', [
    {'SKYTPU_METRICS_DIR': 'M', 'SKYTPU_RUNTIME_DIR': 'R',
     'SKYTPU_STATE_DIR': 'S'},
    {'SKYTPU_RUNTIME_DIR': 'R', 'SKYTPU_STATE_DIR': 'S'},
    {'SKYTPU_STATE_DIR': 'S'}])
def test_textfile_dir_resolution_order(env, tmp_path, monkeypatch):
    for k in ('SKYTPU_METRICS_DIR', 'SKYTPU_RUNTIME_DIR',
              'SKYTPU_STATE_DIR'):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(tmp_path / v))
    assert publish.textfile_dir() == jpublish.textfile_dir()
    assert publish.textfile_dir('~/x') == jpublish.textfile_dir('~/x')
    assert publish.stale_seconds() == jpublish.stale_seconds()


def test_start_publisher_samples_the_card_each_tick(tmp_path, monkeypatch):
    """``start_publisher`` pre-wires the card-memory sampler: the file
    it writes at once already holds the HBM gauges."""
    monkeypatch.setenv('SKYTPU_METRICS_DIR', str(tmp_path / 'm'))
    monkeypatch.setattr(device, 'cuda_devices',
                        lambda: [FakeDevice(7, 9, 8)])
    pub = publish.start_publisher('train', interval=3600)
    try:
        fams = jexposition.parse_text(jpublish.read_textfiles())
        assert fams['skytpu_device_hbm_limit_bytes'].samples[0].value == 9
    finally:
        pub.close()
    assert jpublish.read_textfiles() == ''


# ---------------------------------------------------------------------
# Family specs
# ---------------------------------------------------------------------


def test_engine_and_adapter_families_equal_the_jax_engines():
    batching._engine_metrics()
    batching._adapter_metrics()
    jbatching._engine_metrics()
    jbatching._adapter_metrics()
    got = _specs(tmetrics.registry())
    assert got == _specs(JREG.registry())
    assert len([n for n in got if n.startswith('skytpu_batch_')]) == 33


def test_engine_without_adapters_registers_no_adapter_families():
    """A port engine built without an adapter registry exports the
    engine families and never the adapter ones (no fake zero series)."""
    config = llama.get_config('tiny', dtype=torch.float32)
    engine = batching.BatchingEngine(
        llama.init_params(config, seed=0, device='cpu'), config, slots=2,
        max_seq=32)
    engine.close()
    jbatching._engine_metrics()
    names = set(_specs(tmetrics.registry()))
    assert names == set(_specs(JREG.registry()))
    assert tmetrics.registry().gauge('skytpu_batch_slots_total').value == 2
    assert tmetrics.registry().gauge(
        'skytpu_batch_kv_blocks_total').value == engine.pool.usable_blocks
    assert tmetrics.registry().gauge(
        'skytpu_batch_kv_cache_bytes').value == engine.pool.nbytes > 0


def test_train_goodput_and_hbm_families_equal_the_jax_packages():
    for gl, dl, reg in ((goodput, device, tmetrics.registry()),
                        (jgoodput, jdevice, JREG.registry())):
        gl.train_metrics(reg)
        acct = gl.GoodputAccountant(reg)
        acct.set_model_info(10, 10, peak_flops_per_chip_value=1e3)
        acct.observe_step(1.0, compile_step=True)
        acct.observe_step(1.0)
        dl._hbm_gauges(reg)
    got = _specs(tmetrics.registry())
    assert got == _specs(JREG.registry())
    assert {'skytpu_train_step_seconds', 'skytpu_train_tokens_total',
            'skytpu_train_steps_total', 'skytpu_train_tokens_per_sec',
            'skytpu_goodput_seconds_total', 'skytpu_goodput_ratio',
            'skytpu_mfu_ratio', 'skytpu_device_hbm_used_bytes',
            'skytpu_device_hbm_limit_bytes',
            'skytpu_device_hbm_peak_bytes'} == set(got)


# ---------------------------------------------------------------------
# The two windowed ratio gauges (the gauge sweep on a stub engine)
# ---------------------------------------------------------------------


class _Pool:
    used_blocks, cached_blocks, block_bytes = 3, 2, 64.0


def _stub(mod):
    """An engine-shaped stub with what ``_set_gauges`` reads, its metric
    families registered in ``mod``'s registry."""
    return types.SimpleNamespace(
        _metrics=mod._engine_metrics(), slot_req=[None, object()],
        _pending_lock=threading.Lock(), pending=collections.deque([1]),
        _queued_tokens=17, pool=_Pool(), _adapters=None,
        prefix_caching=True, _prefix_window=collections.deque(),
        _prefix_hits_local=0, _prefix_misses_local=0,
        _hit_ratio_gauge=None, speculative=True,
        _spec_window=collections.deque(), _spec_proposed_local=0,
        _spec_accepted_local=0, _spec_ratio_gauge=None,
        _windowed_ratio=batching.BatchingEngine._windowed_ratio)


def _ratios(engine):
    """{name: (value, help)} of the windowed ratio gauges an engine holds
    (None while idle). Read from the engine's own references: the
    families are process-global and unlabeled, so any other engine alive
    in this process writes (and unregisters) the registry's copy."""
    return {g.name: (g.value, g.help) for g in (engine._hit_ratio_gauge,
                                                engine._spec_ratio_gauge)
            if g is not None}


def test_ratio_gauges_come_and_go_as_the_jax_engines(monkeypatch):
    """One scripted history (admissions' hit/miss blocks and verify
    rounds, on a fake clock) swept through the port's and the JAX
    engine's ``_set_gauges``: the same gauge values and the same
    absences at every sweep — lazy creation (no fake 0 before traffic),
    the trailing-window ratio, and the drop once the window is idle
    (``test_prefix_cache.py`` / ``test_speculative.py`` in the JAX
    package hold the same on a live engine)."""
    clock = [1000.0]
    monkeypatch.setattr(time, 'time', lambda: clock[0])
    for mod in (batching, jbatching):
        monkeypatch.setattr(mod, 'PREFIX_RATIO_WINDOW_SECONDS', 30.0)
        monkeypatch.setattr(mod, 'SPEC_RATIO_WINDOW_SECONDS', 20.0)
    port, jax_ = _stub(batching), _stub(jbatching)
    # (seconds later, hits, misses, proposed, accepted)
    script = [(0, 0, 0, 0, 0), (1, 2, 2, 0, 0), (1, 0, 1, 8, 6),
              (5, 3, 0, 4, 0), (12, 0, 0, 0, 0), (25, 0, 0, 0, 0),
              (2, 1, 0, 0, 0), (40, 0, 0, 0, 0), (1, 0, 0, 0, 0)]
    seen = []
    for dt, hit, miss, prop, acc in script:
        clock[0] += dt
        for stub in (port, jax_):
            stub._prefix_hits_local += hit
            stub._prefix_misses_local += miss
            stub._spec_proposed_local += prop
            stub._spec_accepted_local += acc
        batching.BatchingEngine._set_gauges(port)
        jbatching.BatchingEngine._set_gauges(jax_)
        got = _ratios(port)
        assert got == _ratios(jax_)
        seen.append({k: v for k, (v, _) in got.items()})
    assert seen[0] == {}
    assert seen[2] == {'skytpu_batch_prefix_hit_ratio': 2 / 5,
                       'skytpu_batch_spec_accept_ratio': 6 / 8}
    assert 'skytpu_batch_spec_accept_ratio' not in seen[5]
    assert seen[-1] == {}
    m = port._metrics
    assert (m['occupancy'].value, m['queued_requests'].value,
            m['queued_tokens'].value, m['kv_used'].value,
            m['kv_cached'].value) == (1, 1, 17, 192.0, 128.0)


def test_live_engine_drops_the_idle_prefix_ratio(monkeypatch):
    """On a live port engine: the hit ratio appears after a repeated
    prompt, then disappears once its (shrunk) window is idle."""
    monkeypatch.setattr(batching, 'PREFIX_RATIO_WINDOW_SECONDS', 1.0)
    config = llama.get_config('tiny', dtype=torch.float32)
    engine = batching.BatchingEngine(
        llama.init_params(config, seed=0, device='cpu'), config, slots=2,
        max_seq=64, steps_per_dispatch=2, block_size=8)

    def present():
        return 'skytpu_batch_prefix_hit_ratio' in _ratios(engine)
    try:
        prompt = [(i * 9) % 250 + 1 for i in range(20)]
        engine.generate(prompt, 3)
        engine.generate(prompt, 3)
        deadline = time.time() + 10
        while not present() and time.time() < deadline:
            time.sleep(0.05)
        assert present()
        hits = tmetrics.registry().counter(
            'skytpu_batch_prefix_hits_total').value
        assert hits == 2      # 16 of the 20 tokens, 8-token blocks
        deadline = time.time() + 15
        while present() and time.time() < deadline:
            time.sleep(0.1)
        assert not present()
    finally:
        engine.close()


# ---------------------------------------------------------------------
# Goodput and MFU
# ---------------------------------------------------------------------


def _both(fn):
    """Run ``fn(goodput module)`` on the port's and the JAX package's
    process accountant; returns both snapshots."""
    return fn(goodput), fn(jgoodput)


@pytest.mark.parametrize('case', ['partition', 'large_claim',
                                  'claim_outside'])
def test_goodput_buckets_partition_as_the_jax_accountant(case):
    t = time.monotonic()

    def run(gl):
        acct = gl.accountant()
        if case == 'partition':
            acct.observe_step(10.0, compile_step=True, now=t)
            acct.observe_step(2.0, now=t + 2)
            acct.note('checkpoint_save', 0.5, noted_at=t + 3)
            acct.observe_step(2.5, now=t + 4.5)   # 0.5 carved out
        elif case == 'large_claim':
            acct.note('restore', 5.0, noted_at=t)
            acct.observe_step(2.0, now=t)          # wholly claimed
            acct.observe_step(3.0, now=t + 3.0)    # no overlap
        else:
            acct.note('restore', 5.0, noted_at=t - 100.0)
            acct.observe_step(2.0, compile_step=True, now=t)
            acct.observe_step(1.5, now=t + 1.5)
        return acct.snapshot()
    got, want = _both(run)
    assert got == pytest.approx(want)
    expect = {'partition': dict(compile=10.0, compute=4.0,
                                checkpoint_save=0.5),
              'large_claim': dict(compute=3.0, restore=5.0),
              'claim_outside': dict(restore=5.0, compile=2.0,
                                    compute=1.5)}[case]
    for bucket, sec in expect.items():
        assert got[bucket] == pytest.approx(sec)
    ratio = tmetrics.registry().gauge('skytpu_goodput_ratio').value
    assert ratio == pytest.approx(got['compute'] / sum(got.values()))
    got_text, want_text = _texts(tmetrics.registry(), JREG.registry())
    assert got_text == want_text


def test_unknown_bucket_rejected():
    with pytest.raises(ValueError):
        goodput.note('napping', 1.0)


def test_mfu_math_with_an_explicit_peak():
    acct = goodput.accountant()
    acct.set_model_info(int(1e9), 1000, n_chips=2,
                        peak_flops_per_chip_value=3e12, full_finetune=True)
    acct.observe_step(0.1, compile_step=True)
    assert 'skytpu_mfu_ratio' not in _specs(tmetrics.registry())
    acct.observe_step(1.0)   # 6e12 flops / (1 s * 2 * 3e12) = 1.0
    assert tmetrics.registry().gauge('skytpu_mfu_ratio').value == \
        pytest.approx(1.0)
    acct.set_model_info(int(1e9), 1000, peak_flops_per_chip_value=4e12)
    acct.observe_step(0.5)   # 6e12 / (0.5 s * 2 * 4e12): n_chips kept
    assert tmetrics.registry().gauge('skytpu_mfu_ratio').value == \
        pytest.approx(1.5)


@pytest.mark.parametrize('name, peak', [
    ('H100-SXM', 989e12), ('h100-sxm5', 989e12),
    ('NVIDIA H100 80GB HBM3', 989e12), ('NVIDIA H100 PCIe', None),
    ('tpu-v5p-8', None), ('', None)])
def test_peak_resolves_the_port_card_table(name, peak, monkeypatch):
    monkeypatch.delenv(goodput.ENV_ACCELERATOR, raising=False)
    assert goodput.peak_flops_per_chip(name) == peak
    if name:
        monkeypatch.setenv(goodput.ENV_ACCELERATOR, name)
        assert goodput.peak_flops_per_chip() == peak


def test_unknown_card_exports_no_mfu(monkeypatch):
    monkeypatch.delenv(goodput.ENV_ACCELERATOR, raising=False)
    acct = goodput.accountant()
    acct.set_model_info(int(1e9), 1000, accelerator='not-a-card')
    acct.observe_step(1.0, compile_step=True)
    acct.observe_step(1.0)
    assert 'skytpu_mfu_ratio' not in _specs(tmetrics.registry())


def test_recovery_stall_from_env(monkeypatch):
    monkeypatch.setenv(goodput.ENV_RECOVERY_DETECTED_AT,
                       str(time.time() - 30.0))
    stall = goodput.note_recovery_stall_from_env()
    assert 29.0 < stall < 60.0
    assert goodput.accountant().snapshot()['recovery_stall'] == \
        pytest.approx(stall)
    assert goodput.note_recovery_stall_from_env() is None  # consumed


# ---------------------------------------------------------------------
# Card memory
# ---------------------------------------------------------------------


def test_no_cuda_samples_nothing():
    assert not torch.cuda.is_available()
    assert device.cuda_devices() == []
    assert device.sample_device_memory() == []
    # The families exist but hold no series (no zeros that look like an
    # empty card), as after the JAX sampler over a statless device.
    assert jdevice.sample_device_memory([]) == []
    text, want_text = _texts(tmetrics.registry(), JREG.registry())
    assert text == want_text
    assert 'skytpu_device_hbm_used_bytes{' not in text


def test_injected_devices_drive_the_gauges_as_the_jax_sampler():
    devs = [FakeDevice(100, 1000, 500), FakeDevice(7, 9, 8)]
    rows = device.sample_device_memory(devs)
    assert rows == jdevice.sample_device_memory(devs)
    assert [r['device'] for r in rows] == [0, 1]
    got_text, want_text = _texts(tmetrics.registry(), JREG.registry())
    assert got_text == want_text


def test_cuda_device_reads_allocated_peak_and_total(monkeypatch):
    """``CudaDevice`` maps PyTorch's allocator stats onto the JAX keys:
    used = allocated (not reserved), peak = the allocated high-water
    mark, limit = the card's total memory; a card never allocated on is
    skipped."""
    stats = {0: {'allocated_bytes.all.current': 5,
                 'allocated_bytes.all.peak': 11,
                 'reserved_bytes.all.current': 64,
                 'reserved_bytes.all.peak': 64},
             1: {'reserved_bytes.all.peak': 0}}
    monkeypatch.setattr(torch.cuda, 'memory_stats', lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, 'mem_get_info', lambda i: (3, 80))
    rows = device.sample_device_memory(
        [device.CudaDevice(0), device.CudaDevice(1)])
    assert rows == [{'device': 0, 'bytes_in_use': 5, 'bytes_limit': 80,
                     'peak_bytes_in_use': 11}]
    fam = tmetrics.registry().gauge('skytpu_device_hbm_peak_bytes',
                                    labelnames=('device',))
    assert fam.labels(device='0').value == 11
    assert not math.isnan(fam.labels(device='0').value)
