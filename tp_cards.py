#!/usr/bin/env python3
"""Tensor and expert parallelism across cards: the finetune recipe and
the engine-off replica at llama3-8b, one process per GPU over NCCL,
against one card; with ``--moe``, mixtral-8x7b's recipe over ``ep`` and
its bf16 replica over ``tp``.

    python3 tp_cards.py [--recipe-tp 1,2,4] [--replicas 1:1,2:2,2:4]
        [--steps 10] [--decode-profile 16]
    python3 tp_cards.py --recipe-tp '' --replicas '' --decode-profile 0 \
        --moe ep4,ep2tp2 --moe-replica-tp 2

``--recipe-tp``: for each T, ``recipes/finetune.py --model llama3-8b
--seq 2048 --batch 8 --lora-rank 16 --synthetic --tp T`` with
``SKYTPU_NUM_CHIPS_PER_NODE`` = T (the mesh ``tp = T``); the step times
come from the recipe's cumulative tokens/s lines (steps 1-5, after step
0's warm-up), and once step 5 prints a profile of two steps is armed
(``utils/profiling.write_trigger``): one rank writes the device ms of
every kernel it ran, NCCL's by name (``TP_RECIPE`` lines; the profiles
under ``chiprun_out/tp_cards/``).

``--replicas``: for each ``tp:chips``, ``recipes/serve_model.py --model
llama3-8b --tp tp`` with ``SKYTPU_NUM_CHIPS_PER_NODE`` = chips (``2:4``
is fsdp 2 x tp 2), three 128-token prompts (random ids from a seed)
asking 1 and 32 new tokens: TTFT (the 1-token request), TPOT (the
32-token request less the 1-token one, over 31), and each request's ids
against the first replica's (tp 1). Then teacher forcing: the first
replica's ids fed through tp 1 in this process and through each other
mesh on spawned ranks (NCCL, ``chip_smoke._tp_path``), so each step's
logits compare on the same inputs: every step's max |err| against tp
1, and where a replica's ids first differ, tp 1's top-2 margin there
beside twice that step's max |err| (``chip_smoke._tp_compare``;
``TP_REPLICA`` lines).

``--decode-profile N``: where a tp 2 decode step's time goes. Two
ranks on two cards build llama3-8b's blocks (seed 0), prefill a
128-token prompt and time N decode steps (``forward_cached(layout=)``
and ``greedy_token``, synchronized after each), then rank 0 profiles 4
more (CPU and CUDA activity): the device's busy ms and NCCL's, and the
host ops that take the most time of their own (``TP_DECODE_PROFILE``
line; tp 1 on one card beside it, the same steps).

``--moe``: for each mesh (``ep4``: ``--ep 4``; ``ep2tp2``: ``--ep 2
--tp 2``), ``recipes/finetune.py --model mixtral-8x7b --seq 2048
--lora-rank 16 --synthetic`` on four cards, one batch row a data rank
(``--batch`` = the data group: 4 and 2), as ``--recipe-tp`` times it:
step seconds and tokens/s/chip, unprofiled (a profile armed on a rank
of the ep 4 recipe ended in SIGSEGV); then the recipe's exchange (the
67 MB dispatch buffer over the mesh's ``ep`` group, 192 a step) timed
alone on the four cards with CUDA events (``MOE_RECIPE`` lines).
``--moe-replica-tp T``: ``recipes/serve_model.py --model mixtral-8x7b
--tp T`` (bf16, 46.7 GB a rank at T 2) on T cards, three 128-token
prompts: TTFT, TPOT and ids (``MOE_REPLICA``; no one-card reference:
bf16 mixtral does not fit one card).

``--sp S,...``: sequence parallelism over NCCL, a card a rank:
llama3-8b (32 layers, bf16 base, LoRA rank 16, random weights from seed
0), one row of ``--sp-seq`` tokens (32768), at sp 1 on one card and at
each S on S cards: the first step's loss, ``--train-steps`` timed steps
(host clock, synchronized), tokens/s per chip, each rank's peak memory,
and the ring's exchanges timed alone on every rank with CUDA events
(one layer's (k, v), and the backward's (k, v, dk, dv)), summed to a
step's (``SP_CARDS`` lines). ``--pp P,...``: pipeline parallelism the
same way, seq 2048, a global batch of 16 rows: GPipe at 8 and 16
microbatches and 1F1B at 16 on P cards (``--pp-schedules`` picks
them), each stage's peak memory, and the bubble: 1 - (the unpipelined
step on one card / P) / the pipelined step, beside (P - 1) / (M + P -
1) (``PP_CARDS`` lines; the one-card step once, ``PP_ONE_CARD``).
``--profile-probe RUNS``: the recipe's on-demand profile
(``write_trigger`` at step 5, two steps) with ``PYTHONFAULTHANDLER=1``
for each run named: ``sp2`` (``--sp 2``, two cards, seq 8192),
``mixtral_ep1`` (mixtral-8x7b at ``--ep 1``, four cards, fsdp 4),
``one_card`` (llama3-8b at seq 8192 on one card), ``tp2`` and
``fsdp2`` (llama3-8b, seq 2048, 8 rows, on two cards: the meshes whose
profiles worked in earlier runs); each run's exit code,
its fault handler's report if it crashed, and the profile's kernel
rows; ``gloo_sp2``: one sp 2 step captured by ``torch.profiler`` on
two gloo ranks sharing a card (``PROFILE_PROBE`` lines).

Needs a CUDA card for each rank; run from the repo's root, beside
``chip_smoke.py``, whose tp helpers it uses. Prints the cards' names and
power limits (``nvidia-smi``) on every line.
"""
import argparse
import contextlib
import gc
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import chip_smoke
from skypilot_torch.parallel import distributed

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, 'chiprun_out', 'tp_cards')
PROMPT, NEW, SEED = 128, 32, 61
# --pp's runs: seq and global batch rows.
PP_SEQ, PP_BATCH = 2048, 16


def log(*a):
    print(*a, flush=True)


def cards() -> list:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def _env(chips: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('SKYTPU_')}
    env.update(SKYTPU_NUM_CHIPS_PER_NODE=str(chips), PYTHONPATH=ROOT,
               SKYTPU_STATE_DIR=os.path.join(OUT, 'state'))
    return env


def _tail(path: str) -> str:
    with open(path, encoding='utf-8', errors='replace') as f:
        return f.read()[-4000:]


def recipe(tp: int, steps: int, model: str = 'llama3-8b', ep: int = 1,
           batch: int = 8, profile: bool = True) -> dict:
    """One recipe run at ``--tp tp --ep ep`` on ``tp * ep`` cards:
    per-step seconds, losses, tokens/s per chip, and (``profile``) the
    profiled rank's kernel ms. Its output lines go to
    ``recipe_<tag>.stdout`` as they come."""
    from skypilot_torch.utils import profiling
    chips = tp * ep
    tag = f'{model}_ep{ep}_tp{tp}' if ep > 1 else f'tp{tp}'
    prof = os.path.join(OUT, f'profile_{tag}')
    os.makedirs(prof, exist_ok=True)
    env = _env(chips)
    env.update(SKYTPU_PROFILE_DIR=prof,
               SKYTPU_COORDINATOR_ADDRESS=f'127.0.0.1:{distributed.free_port()}')
    argv = [sys.executable, '-m', 'skypilot_torch.recipes.finetune',
            '--model', model, '--seq', '2048', '--batch', str(batch),
            '--lora-rank', '16', '--synthetic', '--steps', str(steps),
            '--log-every', '1', '--tp', str(tp), '--ep', str(ep)]
    tokens_per_step = batch * 2048
    t0 = time.perf_counter()
    err_path = os.path.join(OUT, f'recipe_{tag}.stderr')
    with open(err_path, 'w', encoding='utf-8') as err, \
            open(err_path[:-len('stderr')] + 'stdout', 'w',
                 encoding='utf-8') as out:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True)
        lines = []
        for line in proc.stdout:
            lines.append(line.rstrip())
            out.write(line)
            out.flush()
            if profile and line.startswith('step 5 '):
                profiling.write_trigger(prof, steps=2)
    assert proc.wait() == 0, _tail(err_path)
    wall = time.perf_counter() - t0
    done = {}
    for line in lines:
        m = re.match(r'step (\d+) loss=(\S+) grad_norm=(\S+) tokens/s=(\d+)',
                     line)
        if m:
            k = int(m.group(1))
            done[k] = (float(m.group(2)),
                       (k + 1) * tokens_per_step / int(m.group(4)))
    step_s = [done[k][1] - done[k - 1][1] for k in range(1, 6)]
    mean = sum(step_s) / len(step_s)
    summary = profiling.load_summary(prof) if profile else None
    kernels = None
    if summary is not None:
        rows = [r for r in summary['rows'] if r['category'] == 'kernel']
        nccl = [r for r in rows if 'nccl' in r['name'].lower()]
        kernels = dict(
            steps=summary['steps'],
            kernel_ms=sum(r['total_ms'] for r in rows) / summary['steps'],
            nccl_ms=sum(r['total_ms'] for r in nccl) / summary['steps'],
            nccl=[dict(name=r['name'][:80], ms=r['total_ms'] /
                       summary['steps'], count=r['count'] / summary['steps'])
                  for r in nccl],
            top=[dict(name=r['name'][:80], ms=r['total_ms'] /
                      summary['steps'])
                 for r in sorted(rows, key=lambda r: -r['total_ms'])[:8]])
    return dict(model=model, tp=tp, ep=ep, chips=chips, batch=batch,
                head=lines[0], losses=[done[k][0] for k in sorted(done)],
                step_s=step_s, step_s_mean=mean,
                tokens_per_s_per_chip=tokens_per_step / mean / chips,
                profiled_rank=kernels, wall_s=wall)


def _train_rank(torch, rank: int, world: int, dev, mesh_kw: dict,
                seq: int, batch: int, steps: int, step_kw: dict) -> dict:
    """llama3-8b (32 layers, bf16 base, LoRA rank 16, seed 0) on the mesh
    ``mesh_kw`` of ``world`` ranks: one warm-up step (its loss), then
    ``steps`` steps timed on the host clock, each ending in a sync; the
    rank's peak memory over them, its coordinate and the last step's
    collectives."""
    import numpy as np

    from skypilot_torch.models import llama
    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import sharding
    from skypilot_torch.parallel import train as train_lib
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(**mesh_kw))
    config = llama.get_config('llama3-8b', max_seq_len=seq)
    state = train_lib.init_train_state(
        config, seed=0, param_dtype=torch.bfloat16, lora_rank=16,
        device=dev, mesh=mesh)
    step = train_lib.build_train_step(config, mesh=mesh, **step_kw)
    tokens = np.random.default_rng(SEED).integers(
        0, config.vocab_size, (batch, seq + 1))
    data = {'tokens': torch.from_numpy(tokens).to(dev)}
    state, m = step(state, data)
    first = float(m['loss'])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(steps):
        sharding.COLLECTIVES.reset()
        t0 = time.perf_counter()
        state, m = step(state, data)
        float(m['loss'])
        step_s.append(time.perf_counter() - t0)
    return dict(coordinate=mesh.coordinate, layers=config.n_layers,
                loss=first,
                last_loss=float(m['loss']), step_s=step_s,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                collectives=sharding.COLLECTIVES.counts())


def _ring_exchange_rank(torch, rank: int, world: int, dev,
                        seq: int) -> dict:
    """The ring's exchanges at sp = ``world`` for one row of ``seq``
    tokens at llama3-8b's 8 kv heads, alone, 20 times after 3 warm-ups,
    timed with CUDA events: a ring forward's (k, v) bf16, and a ring
    backward's (k, v, dk, dv) with f32 sums and last (dk, dv)."""
    from skypilot_torch import comm
    from skypilot_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(sp=world))
    group = mesh.group(('sp',))
    shape = (1, seq // world, 8, 128)
    kv = [torch.randn(shape, device=dev).to(torch.bfloat16)
          for _ in range(2)]
    sums = [torch.randn(shape, device=dev) for _ in range(2)]
    res = {}
    for name, parts in (('kv', kv), ('kv_dkdv', kv + sums),
                        ('dkdv', sums)):
        for _ in range(3):
            comm.ring_exchange(parts, group)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            comm.ring_exchange(parts, group)
        end.record()
        torch.cuda.synchronize()
        res[f'{name}_ms'] = start.elapsed_time(end) / 20
        res[f'{name}_bytes'] = sum(x.numel() * x.element_size()
                                   for x in parts)
    return res


def sp_cards(sizes: list, seq: int, steps: int, smi: list) -> None:
    """``SP_CARDS``: sp 1 on one card, then each of ``sizes``."""
    base = None
    for sp in [1] + sizes:
        ranks, spawn_s = chip_smoke._tp_spawn(
            'nccl', sp, target=_train_rank,
            args=(dict(sp=sp), seq, 1, steps, {}))
        mean = max(sum(r['step_s']) / len(r['step_s']) for r in ranks)
        row = dict(cards=smi[:sp], sp=sp, model='llama3-8b',
                   layers=ranks[0]['layers'],
                   seq=seq, batch=1, lora_rank=16,
                   loss=[r['loss'] for r in ranks],
                   step_s=[r['step_s'] for r in ranks], step_s_mean=mean,
                   tokens_per_s_per_chip=seq / mean / sp,
                   peak_gb=[r['peak_gb'] for r in ranks],
                   collectives=ranks[0]['collectives'], ranks_s=spawn_s)
        if sp > 1:
            ex, _ = chip_smoke._tp_spawn('nccl', sp,
                                         target=_ring_exchange_rank,
                                         args=(seq,))
            # A step per layer: the ring forward twice (remat), its
            # backward once.
            per_layer = [2 * (sp - 1) * e['kv_ms'] +
                         (sp - 1) * e['kv_dkdv_ms'] + e['dkdv_ms']
                         for e in ex]
            row.update(exchange=ex, ring_exchange_ms_per_step=[
                ranks[0]['layers'] * x for x in per_layer])
        if base is None:
            base = row
        row['loss_rel_vs_sp1'] = abs(row['loss'][0] - base['loss'][0]) / \
            abs(base['loss'][0])
        row['per_chip_vs_one_card'] = (row['tokens_per_s_per_chip'] /
                                       base['tokens_per_s_per_chip'])
        log('SP_CARDS ' + json.dumps(row))


def pp_cards(sizes: list, schedules: list, steps: int, smi: list) -> None:
    """``PP_ONE_CARD`` then ``PP_CARDS`` for each pp and schedule."""
    batch, seq = PP_BATCH, PP_SEQ
    ranks, _ = chip_smoke._tp_spawn('nccl', 1, target=_train_rank,
                                    args=(dict(), seq, batch, steps, {}))
    one = sum(ranks[0]['step_s']) / len(ranks[0]['step_s'])
    one_loss = ranks[0]['loss']
    log('PP_ONE_CARD ' + json.dumps(dict(
        cards=smi[:1], model='llama3-8b', layers=ranks[0]['layers'],
        seq=seq, batch=batch,
        step_s=ranks[0]['step_s'], step_s_mean=one,
        peak_gb=ranks[0]['peak_gb'], loss=ranks[0]['loss'],
        tokens_per_s=batch * seq / one)))
    for pp in sizes:
        for spec in schedules:
            schedule, micro = spec.split(':')
            micro = int(micro)
            ranks, spawn_s = chip_smoke._tp_spawn(
                'nccl', pp, target=_train_rank,
                args=(dict(pp=pp), seq, batch, steps,
                      dict(pipeline_microbatches=micro,
                           pipeline_schedule=schedule)))
            ranks = sorted(ranks, key=lambda r: r['coordinate']['pp'])
            mean = max(sum(r['step_s']) / len(r['step_s']) for r in ranks)
            log('PP_CARDS ' + json.dumps(dict(
                cards=smi[:pp], pp=pp, schedule=schedule, microbatches=micro,
                model='llama3-8b', layers=ranks[0]['layers'], seq=seq,
                batch=batch, loss=[r['loss'] for r in ranks],
                loss_rel_vs_one_card=abs(ranks[0]['loss'] - one_loss) /
                abs(one_loss),
                step_s=[r['step_s'] for r in ranks], step_s_mean=mean,
                tokens_per_s_per_chip=batch * seq / mean / pp,
                stage_peak_gb=[r['peak_gb'] for r in ranks],
                pp_sends=[r['collectives']['pp_sends'] for r in ranks],
                bubble_measured=1 - (one / pp) / mean,
                bubble_schedule=(pp - 1) / (micro + pp - 1),
                ranks_s=spawn_s)))


PROBE_RUNS = {
    'sp2': (2, ['--model', 'llama3-8b', '--seq', '8192', '--batch', '2',
                '--sp', '2']),
    'mixtral_ep1': (4, ['--model', 'mixtral-8x7b', '--seq', '2048',
                        '--batch', '4', '--ep', '1']),
    'one_card': (1, ['--model', 'llama3-8b', '--seq', '8192', '--batch',
                     '2']),
    'tp2': (2, ['--model', 'llama3-8b', '--seq', '2048', '--batch', '8',
                '--tp', '2']),
    'fsdp2': (2, ['--model', 'llama3-8b', '--seq', '2048', '--batch',
                  '8']),
}


def _profiled_rank(torch, rank: int, world: int, dev, sp: int) -> dict:
    """One step of llama3-8b at 4 layers, seq 8192, batch 1 over ``sp``
    (ranks sharing the card over gloo) captured by ``torch.profiler``
    (``profiling.capture_trace``) after a warm-up step: the trace's
    device rows."""
    from skypilot_torch.models import llama
    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import train as train_lib
    from skypilot_torch.utils import profiling
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(sp=sp))
    config = llama.get_config('llama3-8b', n_layers=4, max_seq_len=8192)
    state = train_lib.init_train_state(
        config, seed=0, param_dtype=torch.bfloat16, lora_rank=16,
        device=dev, mesh=mesh)
    step = train_lib.build_train_step(config, mesh=mesh)
    data = {'tokens': torch.randint(0, config.vocab_size, (1, 8193),
                                    generator=torch.Generator().manual_seed(
                                        SEED)).to(dev)}
    state, _ = step(state, data)
    trace = os.path.join(OUT, f'probe_gloo_rank{rank}')
    with profiling.capture_trace(trace) as out:
        state, m = step(state, data)
        float(m['loss'])
    rows = profiling.summarize_trace(out)
    return dict(rows=len(rows), device_ms=sum(r.total_ms for r in rows))


def profile_probe(smi: list, runs: list) -> None:
    """``PROFILE_PROBE``: the recipe's on-demand profile under the fault
    handler for each of ``runs`` (``PROBE_RUNS``: ``--sp 2`` on two cards,
    mixtral-8x7b ``--ep 1`` on four, the one-card step at seq 8192), and
    ``gloo_sp2``: a profiled sp 2 step on two gloo ranks sharing a
    card."""
    from skypilot_torch.utils import profiling
    if 'gloo_sp2' in runs:
        try:
            ranks, _ = chip_smoke._tp_spawn('gloo', 2, target=_profiled_rank,
                                            args=(2,))
            got = dict(exit_code=0, ranks=ranks)
        except AssertionError as e:   # a rank that crashed: the answer
            got = dict(exit_code=None, error=str(e)[-600:])
        log('PROFILE_PROBE ' + json.dumps(dict(cards=smi[:1],
                                               run='gloo_sp2', **got)))
    for tag in [r for r in runs if r in PROBE_RUNS]:
        chips, extra = PROBE_RUNS[tag]
        prof = os.path.join(OUT, f'probe_{tag}')
        os.makedirs(prof, exist_ok=True)
        env = _env(chips)
        env.update(SKYTPU_PROFILE_DIR=prof, PYTHONFAULTHANDLER='1',
                   TORCH_SHOW_CPP_STACKTRACES='1',
                   SKYTPU_COORDINATOR_ADDRESS=(
                       f'127.0.0.1:{distributed.free_port()}'))
        argv = [sys.executable, '-m', 'skypilot_torch.recipes.finetune',
                '--lora-rank', '16', '--synthetic', '--steps', '9',
                '--log-every', '1'] + extra
        err_path = os.path.join(OUT, f'probe_{tag}.stderr')
        with open(err_path, 'w', encoding='utf-8') as err:
            proc = subprocess.Popen(argv, cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=err,
                                    text=True)
            lines = []
            for line in proc.stdout:
                lines.append(line.rstrip())
                if line.startswith('step 5 '):
                    profiling.write_trigger(prof, steps=2)
            rc = proc.wait()
        text = _tail(err_path)
        fault = text[text.find('Fatal Python error'):][:3000] \
            if 'Fatal Python error' in text else None
        summary = profiling.load_summary(prof)
        rows = [] if summary is None else [
            r for r in summary['rows'] if r['category'] == 'kernel']
        log('PROFILE_PROBE ' + json.dumps(dict(
            cards=smi[:chips], run=tag, argv=extra, exit_code=rc,
            steps_printed=sum(line.startswith('step ') for line in lines),
            fault=fault, profiled=summary is not None,
            profile_steps=None if summary is None else summary['steps'],
            kernel_ms=None if summary is None else sum(
                r['total_ms'] for r in rows) / summary['steps'],
            top=[dict(name=r['name'][:80], ms=r['total_ms'] /
                      summary['steps'])
                 for r in sorted(rows, key=lambda r: -r['total_ms'])[:10]]
            if summary else None)))


def _exchange_rank(torch, rank: int, world: int, dev, ep: int,
                   tp: int) -> dict:
    """The MoE dispatch exchange of the recipe at ``ep`` x ``tp`` (one
    batch row a data rank): mixtral-8x7b's ``[E, C, D]`` bf16 buffer
    (8 x 1024 x 4096, 67 MB) through ``Layout.to_experts`` over the
    mesh's ``ep`` group, 20 times after 3 warm-ups, timed with CUDA
    events; and ``all_to_all_single`` of the same buffer alone."""
    import torch.distributed as dist

    from skypilot_torch.parallel import mesh as mesh_lib
    from skypilot_torch.parallel import sharding
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(
        fsdp=world // (ep * tp), ep=ep, tp=tp))
    layout = sharding.Layout(mesh, {})
    x = torch.randn((8, 1024, 4096), device=dev).to(torch.bfloat16)
    out = torch.empty_like(x)
    group = mesh.group(('ep',))
    res = {}
    for name, fn in (('to_experts', lambda: layout.to_experts(x)),
                     ('all_to_all_single', lambda: dist.all_to_all_single(
                         out, x, group=group))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        res[f'{name}_ms'] = start.elapsed_time(end) / 20
    res['bytes'] = x.numel() * x.element_size()
    res['bus_gb_s'] = (res['bytes'] * (ep - 1) / ep /
                       (res['all_to_all_single_ms'] / 1e3) / 1e9)
    return res


def exchanges(ep: int, tp: int) -> dict:
    """``_exchange_rank`` on four cards over NCCL: each rank's ms."""
    ranks, _ = chip_smoke._tp_spawn('nccl', 4, target=_exchange_rank,
                                    args=(ep, tp))
    return dict(ep=ep, tp=tp, ranks=ranks)


def _post(port: int, prompt: list, n: int) -> tuple:
    body = json.dumps({'prompt_ids': prompt, 'max_new_tokens': n}).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}/generate',
                                 data=body,
                                 headers={'Content-Type': 'application/json'})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        ids = json.loads(resp.read())['output_ids']
    return ids, 1e3 * (time.perf_counter() - t0)


def replica(tp: int, chips: int, prompts: list,
            model: str = 'llama3-8b') -> dict:
    """The replica of ``model`` at ``--tp tp`` over ``chips`` cards: each
    prompt's ids at 32 new tokens, TTFT and TPOT per prompt."""
    port = distributed.free_port()
    argv = [sys.executable, '-m', 'skypilot_torch.recipes.serve_model',
            '--model', model, '--tp', str(tp), '--port', str(port)]
    t0 = time.perf_counter()
    err_path = os.path.join(OUT, f'replica_{model}_tp{tp}_chips{chips}'
                            '.stderr')
    err = open(err_path, 'w', encoding='utf-8')
    proc = subprocess.Popen(argv, cwd=ROOT, env=_env(chips),
                            stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        ready = proc.stdout.readline()
        assert 'ready' in ready, _tail(err_path)
        setup_s = time.perf_counter() - t0
        _post(port, prompts[0], NEW)  # the first request's allocations
        rows = []
        for prompt in prompts:
            _, ttft = _post(port, prompt, 1)
            ids, full = _post(port, prompt, NEW)
            rows.append(dict(ids=ids, ttft_ms=ttft,
                             tpot_ms=(full - ttft) / (NEW - 1)))
        proc.send_signal(signal.SIGINT)
        proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        err.close()
    return dict(model=model, tp=tp, chips=chips, setup_s=setup_s,
                requests=rows)


def _decode_steps(config, layout, params, dev, n: int,
                  profile: bool) -> dict:
    """llama3-8b's blocks (``chip_smoke._tp_model``): a 128-token
    prefill, ``n`` timed decode steps, then 4 more, recorded by
    ``torch.profiler`` with ``profile``."""
    import torch

    from skypilot_torch.models import decode
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, config.vocab_size, (1, PROMPT),
                           generator=gen).to(dev)
    out = {}
    with torch.inference_mode():
        cache = decode.init_cache(config, 1, PROMPT + n + 8, device=dev,
                                  layout=layout)
        logits, cache = decode.forward_cached(params, prompt, cache, config,
                                              prefill=True, layout=layout)
        tok = decode.greedy_token(logits[:, -1], layout)

        def step():
            nonlocal tok, cache
            logits, cache = decode.forward_cached(params, tok[:, None],
                                                  cache, config,
                                                  layout=layout)
            tok = decode.greedy_token(logits[:, -1], layout)
        step()
        torch.cuda.synchronize()
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        out['step_ms'] = ms
        # Every rank runs the 4 steps (their collectives pair up); one
        # records them.
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profile else \
            contextlib.nullcontext()
        with prof:
            for _ in range(4):
                step()
            torch.cuda.synchronize()
        if profile:
            ev = prof.key_averages()
            cuda = [e for e in ev
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            host = [e for e in ev
                    if e.device_type == torch.autograd.DeviceType.CPU]
            out.update(
                busy_ms_per_step=sum(e.self_device_time_total
                                     for e in cuda) / 1e3 / 4,
                nccl_ms_per_step=sum(e.self_device_time_total for e in cuda
                                     if 'nccl' in e.key.lower()) / 1e3 / 4,
                host_self_ms_per_step=[
                    dict(name=e.key[:70], calls=e.count / 4,
                         ms=e.self_cpu_time_total / 1e3 / 4)
                    for e in sorted(host,
                                    key=lambda e: -e.self_cpu_time_total)
                    [:12]])
    return out


def _decode_rank(torch, rank: int, world: int, dev, n: int) -> dict:
    from skypilot_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=world))
    config, layout, params = chip_smoke._tp_model(torch, dev, mesh)
    return _decode_steps(config, layout, params, dev, n, profile=rank == 0)


def decode_profile(n: int) -> dict:
    """``_decode_steps`` at tp 1 on card 0, then at tp 2 on two cards."""
    import torch
    config, _, params = chip_smoke._tp_model(torch, 'cuda')
    one = _decode_steps(config, None, params, 'cuda', n, profile=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ranks, _ = chip_smoke._tp_spawn('nccl', 2, target=_decode_rank,
                                    args=(n,))
    return dict(tp1=one, tp2=ranks)


def _forced_rank(torch, rank: int, world: int, dev, tp: int, prompts: list,
                 ids: list) -> dict:
    """This rank's vocabulary window and its teacher-forced logits
    (``chip_smoke._tp_path``) for each prompt on tp 1's ``ids``, over the
    mesh the replica builds (``auto_mesh_config(tp=tp)`` over the
    world)."""
    from skypilot_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(mesh_lib.auto_mesh_config(world, tp=tp))
    config, layout, params = chip_smoke._tp_model(torch, dev, mesh)
    return dict(window=layout.vocab_window(config.vocab_size), rows=[
        chip_smoke._tp_path(torch, params, torch.tensor([p], device=dev),
                            config, i, config.max_seq_len, layout)
        for p, i in zip(prompts, ids)])


def forced(rows: list, prompts: list) -> None:
    """Teacher forcing for the replicas ``rows`` (the first at tp 1 on
    one card): tp 1's logits on its own ids, then each other replica's
    mesh on the same ids; each request gains ``vs_tp1``."""
    import torch
    ids = [r['ids'] for r in rows[0]['requests']]
    config, _, params = chip_smoke._tp_model(torch, 'cuda')
    want = [chip_smoke._tp_path(torch, params,
                                torch.tensor([p], device='cuda'), config, i,
                                config.max_seq_len)
            for p, i in zip(prompts, ids)]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for req, w in zip(rows[0]['requests'], want):
        req['tp1_path_is_greedy'] = w.argmax(-1).tolist() == req['ids']
    for row in rows[1:]:
        ranks, _ = chip_smoke._tp_spawn(
            'nccl', row['chips'], target=_forced_rank,
            args=(row['tp'], prompts, ids))
        for i, req in enumerate(row['requests']):
            got = chip_smoke._tp_logits(
                torch, [(r['window'], r['rows'][i]) for r in ranks])
            req['vs_tp1'] = chip_smoke._tp_compare(torch, want[i], got,
                                                   ids[i], req['ids'])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--recipe-tp', default='1,2,4')
    parser.add_argument('--replicas', default='1:1,2:2,2:4')
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--decode-profile', type=int, default=16)
    parser.add_argument('--moe', default='',
                        help='mixtral-8x7b recipe meshes: ep4, ep2tp2')
    parser.add_argument('--moe-replica-tp', type=int, default=0)
    parser.add_argument('--sp', default='',
                        help='sequence-parallel sizes, e.g. 2,4')
    parser.add_argument('--sp-seq', type=int, default=32768)
    parser.add_argument('--pp', default='',
                        help='pipeline-parallel sizes, e.g. 2,4')
    parser.add_argument('--pp-schedules', default='gpipe:8,gpipe:16,1f1b:16',
                        help='schedule:microbatches for each --pp')
    parser.add_argument('--train-steps', type=int, default=3)
    parser.add_argument('--profile-probe', default='',
                        help='comma list of PROBE_RUNS keys and gloo_sp2')
    args = parser.parse_args()
    os.makedirs(OUT, exist_ok=True)
    smi = cards()
    log('TP_CARDS ' + json.dumps(dict(cards=smi)))
    if args.sp:
        sp_cards([int(x) for x in args.sp.split(',')], args.sp_seq,
                 args.train_steps, smi)
    if args.pp:
        pp_cards([int(x) for x in args.pp.split(',')],
                 args.pp_schedules.split(','), args.train_steps, smi)
    if args.profile_probe:
        profile_probe(smi, args.profile_probe.split(','))
    base = None
    for tp in [int(t) for t in args.recipe_tp.split(',') if t]:
        row = recipe(tp, args.steps)
        if base is None:
            base = row
        row.update(cards=smi[:tp],
                   per_chip_vs_one_card=row['tokens_per_s_per_chip'] /
                   base['tokens_per_s_per_chip'])
        log('TP_RECIPE ' + json.dumps(row))
    moe_meshes = {'ep4': (4, 1), 'ep2tp2': (2, 2)}
    for name in [m for m in args.moe.split(',') if m]:
        ep, tp = moe_meshes[name]
        row = recipe(tp, args.steps, model='mixtral-8x7b', ep=ep, batch=ep,
                     profile=False)
        row.update(cards=smi[:ep * tp], mesh=name,
                   exchange=exchanges(ep, tp),
                   exchanges_a_step=6 * 32)
        log('MOE_RECIPE ' + json.dumps(row))
    if args.moe_replica_tp:
        import random
        rand = random.Random(SEED)
        prompts = [[rand.randrange(32000) for _ in range(PROMPT)]
                   for _ in range(3)]
        row = replica(args.moe_replica_tp, args.moe_replica_tp, prompts,
                      model='mixtral-8x7b')
        row['cards'] = smi[:args.moe_replica_tp]
        log('MOE_REPLICA ' + json.dumps(row))
    if args.decode_profile:
        row = decode_profile(args.decode_profile)
        log('TP_DECODE_PROFILE ' + json.dumps(dict(cards=smi[:2], **row)))
    import random
    rand = random.Random(SEED)
    prompts = [[rand.randrange(128256) for _ in range(PROMPT)]
               for _ in range(3)]
    rows = []
    for spec in [s for s in args.replicas.split(',') if s]:
        tp, chips = map(int, spec.split(':'))
        rows.append(replica(tp, chips, prompts))
    assert not rows or (rows[0]['tp'], rows[0]['chips']) == (1, 1), \
        'the first replica is the reference: 1:1'
    if rows:
        forced(rows, prompts)
    for row in rows:
        for got, want in zip(row['requests'], rows[0]['requests']):
            got['ids_equal_first'] = got['ids'] == want['ids']
        row['cards'] = smi[:row['chips']]
        log('TP_REPLICA ' + json.dumps(row))
    return 0


if __name__ == '__main__':
    sys.exit(main())
