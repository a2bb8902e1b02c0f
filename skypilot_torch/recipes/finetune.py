"""Llama finetuning recipe — the port of
``skypilot_tpu/recipes/finetune.py``.

LoRA (rank ``--lora-rank`` on q/v over a frozen base) or a full
finetune (``--full-ft``), AdamW with clip-by-global-norm, on a
tokenized ``.npy`` of token ids (``--data``) or synthetic tokens.
Weights are random, made from seed 0. On the card the attention runs
through the hand-written flash kernels (K1 with fused RoPE forward, K2
and K3 backward).

    python -m skypilot_torch.recipes.finetune \\
        --model llama3-8b --seq 2048 --batch 8 --steps 100 --lora-rank 16
    python -m skypilot_torch.recipes.finetune --model tiny --device cpu \\
        --steps 3

The step is wrapped by ``parallel.train.instrument_train_step`` (step
time, tokens, goodput buckets, MFU, the ``train.step`` span, on-demand
profiles), and ``main`` publishes the process registry to the host
agent's textfile dir (``metrics/publish.py``), prices a recovery
relaunch's stall into goodput and drives the benchmark step callbacks,
as the JAX recipe does. MFU needs the card's peak: set
``SKYTPU_ACCELERATOR`` to a name ``metrics/goodput.PEAK_BF16_FLOPS``
knows.

Checkpoint and resume, as the JAX recipe does them:
``--checkpoint-dir`` (default ``$SKYTPU_CHECKPOINT_DIR``, the managed
job's checkpoint base) saves the whole ``TrainState`` every
``--checkpoint-interval`` steps through the native engine
(``data/checkpoint.CheckpointManager``, namespaced by
``SKYTPU_TASK_ID``), and a rerun restores the latest committed step
before its loop and goes on from the next one ("resumed from checkpoint
at step N"). The data iterator restarts from its seed on a resume, as
the JAX recipe's does. ``--elastic`` (the default) keeps the job's
designed shape in ``design.json`` in the lineage and rescales the
global batch (and, with ``--elastic-scale-lr``, the learning rate) when
a relaunch runs on another device count.

    python -m skypilot_torch.recipes.finetune --model tiny --device cpu \
        --steps 4 --checkpoint-dir /tmp/ckpt --checkpoint-interval 2

Several devices: one process per GPU, from the runtime's env contract
(``parallel/distributed.py``). ``main`` spawns one worker per GPU of
the host (``SKYTPU_NUM_CHIPS_PER_NODE``, else every visible GPU); the
workers of every host join one process group at the contract's
coordinator and train over a mesh of all of them
(``auto_mesh_config(dp=--dp, ep=--ep, tp=--tp, sp=--sp, pp=--pp)``:
what they do not claim goes to fsdp): FSDP/DP over the data axes,
Megatron tensor parallel over ``tp``, expert parallel over ``ep``, ring
attention over ``sp`` and a pipeline of ``--microbatches`` microbatches
(default 2 pp; GPipe, as JAX's recipe runs it) over ``pp``
(``parallel/train.py``, ``parallel/pipeline.py``). Every rank draws the
global batch as a one-process run draws it and the step takes its rows
and, over ``sp``, its positions of them; rank 0 prints. On the CPU the
workers are gloo processes (``SKYTPU_NUM_CHIPS_PER_NODE=2 ... --device
cpu [--tp 2 | --sp 2 | --pp 2 --microbatches 4]``).
"""
import argparse
import json
import math
import os
import time

import numpy as np
import torch

from skypilot_torch import callbacks
from skypilot_torch import checkpoint as checkpoint_lib
from skypilot_torch import device as device_lib
from skypilot_torch.data import checkpoint as ckpt_facade
from skypilot_torch.metrics import goodput as goodput_lib
from skypilot_torch.metrics import publish as publish_lib
from skypilot_torch.models import llama
from skypilot_torch.parallel import distributed
from skypilot_torch.parallel import mesh as mesh_lib
from skypilot_torch.parallel import pipeline as pipeline_lib
from skypilot_torch.parallel import train as train_lib


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument('--model', default='llama3.2-1b')
    p.add_argument('--seq', type=int, default=2048)
    p.add_argument('--batch', type=int, default=8,
                   help='GLOBAL batch size')
    p.add_argument('--steps', type=int, default=100)
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--lora-rank', type=int, default=16)
    p.add_argument('--full-ft', action='store_true',
                   help='full finetune instead of LoRA')
    p.add_argument('--dp', type=int, default=1,
                   help='pure data-parallel degree (the rest of the '
                        'devices go to fsdp)')
    p.add_argument('--tp', type=int, default=1,
                   help='tensor-parallel degree (Megatron layers over the '
                        'heads and ffn columns, the vocabulary sharded)')
    p.add_argument('--ep', type=int, default=1,
                   help='expert-parallel degree (an MoE model\'s experts '
                        'split over it; a data axis elsewhere)')
    p.add_argument('--sp', type=int, default=1,
                   help='sequence-parallel degree (ring attention)')
    p.add_argument('--pp', type=int, default=1,
                   help='pipeline-parallel degree')
    p.add_argument('--microbatches', type=int, default=None,
                   help='pipeline microbatches (default 2*pp)')
    p.add_argument('--data', default=None,
                   help='tokenized dataset (.npy of token ids)')
    p.add_argument('--synthetic', action='store_true', default=None)
    # Default from the env contract: a managed job declares its
    # checkpoint base once (task env SKYTPU_CHECKPOINT_DIR).
    p.add_argument('--checkpoint-dir',
                   default=os.environ.get('SKYTPU_CHECKPOINT_DIR'))
    p.add_argument('--checkpoint-interval', type=int, default=50)
    p.add_argument('--elastic', action='store_true', default=True)
    p.add_argument('--no-elastic', dest='elastic',
                   action='store_false')
    p.add_argument('--elastic-scale-lr', action='store_true',
                   help='scale the learning rate linearly with the '
                        'device ratio on an elastic resize')
    p.add_argument('--param-dtype', default='bf16',
                   choices=['bf16', 'f32'])
    p.add_argument('--log-every', type=int, default=10)
    p.add_argument('--device', default=device_lib.DEFAULT_DEVICE,
                   help="where the step runs: 'cuda' (the kernels; raises "
                        "without CUDA) or 'cpu' (the plain PyTorch path)")
    return p.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """Raise, before any worker starts, for the pipeline configurations
    JAX refuses: layers that ``--pp`` does not split, and MoE with
    ``--sp`` inside a pipeline."""
    if args.pp > 1:
        pipeline_lib.validate_pipeline_config(
            llama.get_config(args.model), {'pp': args.pp, 'sp': args.sp})


def _elastic_design(lineage_dir, n_now, global_batch):
    """The job's DESIGNED shape reference: device count + global
    batch of the FIRST launch, persisted as ``design.json`` in the
    checkpoint lineage (atomic write; ignored by the step scanners).

    Rescaling must reference the design, not the last checkpoint's
    device count: ``--batch`` re-parses as the designed value on every
    relaunch. The first launch always runs at the designed shape, so
    recording (devices, batch) when the file is absent on a non-resized
    run captures the design exactly (the JAX recipe's rule)."""
    path = os.path.join(lineage_dir, 'design.json')
    try:
        with open(path, encoding='utf-8') as f:
            return json.load(f)
    except (OSError, ValueError):
        pass
    doc = {'device_count': n_now, 'global_batch': global_batch}
    if os.environ.get('SKYTPU_ELASTIC_RESIZED'):
        # Resized relaunch of a PRE-elastic lineage (no design file):
        # best effort is the last checkpoint's device count, and the
        # guess is not persisted.
        saved = checkpoint_lib.saved_device_count(lineage_dir)
        if saved:
            doc['device_count'] = saved
        return doc
    try:
        os.makedirs(lineage_dir, exist_ok=True)
        tmp = f'{path}.{os.getpid()}'
        with open(tmp, 'w', encoding='utf-8') as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only mount: run with the in-memory design
    return doc


def _elastic_resize(args: argparse.Namespace,
                    mesh_cfg: mesh_lib.MeshConfig) -> None:
    """Rescale ``args.batch`` (and with ``--elastic-scale-lr`` the
    learning rate) from the lineage's designed device count to the
    devices of ``mesh_cfg``, keeping the per-device batch and a multiple
    of the data-parallel degree, as the JAX recipe does before it
    builds the optimizer and the iterator."""
    n_now = mesh_cfg.num_devices
    design = _elastic_design(
        ckpt_facade.task_checkpoint_dir(args.checkpoint_dir), n_now,
        args.batch)
    n_design = design['device_count']
    if not n_design or n_design == n_now:
        return
    data_n = math.prod(getattr(mesh_cfg, a) for a in mesh_lib.data_axes())
    scaled = max(data_n, design['global_batch'] * n_now // n_design
                 // data_n * data_n)
    resized = os.environ.get('SKYTPU_ELASTIC_RESIZED')
    if distributed.process_index() == 0:
        print(f'elastic resume: designed for {n_design} chips, running on '
              f'{n_now}{f" ({resized})" if resized else ""}; '
              f'global batch {args.batch} -> {scaled}', flush=True)
    args.batch = scaled
    if args.elastic_scale_lr:
        args.lr = args.lr * n_now / n_design


def data_iterator(args, vocab_size, rng):
    """[batch, seq + 1] int32 token windows: random windows of the
    ``--data`` file, or uniform synthetic ids."""
    if args.data:
        tokens = np.load(args.data, mmap_mode='r')
        n = len(tokens) - (args.seq + 1)
        while True:
            starts = rng.integers(0, n, size=args.batch)
            yield np.stack([
                np.asarray(tokens[s:s + args.seq + 1], np.int32)
                for s in starts
            ])
    else:
        while True:
            yield rng.integers(0, vocab_size,
                               size=(args.batch, args.seq + 1),
                               dtype=np.int32)


def build(args: argparse.Namespace):
    """(config, state, step_fn, batches, device) for ``args``; the step
    is instrumented (``instrument_train_step``: its calls feed the
    process metrics registry). In a process group the state and the
    step are over the mesh of every rank (``auto_mesh_config``);
    alone, on one device."""
    check_args(args)
    dev = device_lib.resolve_device(args.device)
    num_slices = mesh_lib.num_slices_from_env()
    mesh_cfg = mesh_lib.auto_mesh_config(dp=args.dp, ep=args.ep,
                                         tp=args.tp, sp=args.sp, pp=args.pp,
                                         num_slices=num_slices)
    mesh = (mesh_lib.make_mesh(mesh_cfg, num_slices=num_slices)
            if distributed.is_initialized() else None)
    if args.elastic and args.checkpoint_dir:
        _elastic_resize(args, mesh_cfg)
    config = llama.get_config(args.model, max_seq_len=args.seq)
    param_dtype = (torch.bfloat16 if args.param_dtype == 'bf16'
                   else torch.float32)
    optimizer = train_lib.default_optimizer(learning_rate=args.lr)
    state = train_lib.init_train_state(
        config, seed=0, optimizer=optimizer, param_dtype=param_dtype,
        lora_rank=None if args.full_ft else args.lora_rank, device=dev,
        mesh=mesh)
    step_fn = train_lib.instrument_train_step(
        train_lib.build_train_step(
            config, optimizer=optimizer, mesh=mesh,
            pipeline_microbatches=args.microbatches),
        tokens_per_step=args.batch * args.seq, model_config=config,
        full_finetune=args.full_ft)
    batches = data_iterator(args, config.vocab_size,
                            np.random.default_rng(0))
    return config, state, step_fn, batches, dev


def main(argv=None) -> None:
    """Train as ``argv`` says: in this process, or, where the host has
    more than one GPU (process), in one spawned worker per GPU."""
    args = parse_args(argv)
    check_args(args)
    device_lib.resolve_device(args.device)  # no CUDA: raise here
    local_world = distributed.local_world_size(args.device)
    if local_world > 1 and not distributed.is_initialized():
        import torch.multiprocessing as mp
        mp.spawn(_worker, args=(argv, local_world), nprocs=local_world,
                 join=True)
        return
    distributed.initialize(device=args.device)  # no-op for one process
    train(args)


def _worker(local_rank: int, argv, local_world: int) -> None:
    """One spawned process of a multi-GPU host: join the group, train,
    leave."""
    args = parse_args(argv)
    os.environ.setdefault(distributed.ENV_NUM_CHIPS_PER_NODE,
                          str(local_world))
    distributed.initialize(force=True, local_rank=local_rank,
                           device=args.device)
    try:
        train(args)
    finally:
        distributed.shutdown()


def train(args: argparse.Namespace) -> None:
    """The training loop of ``args`` in this process (one rank of the
    group, or the only process). Rank 0 prints."""
    config, state, step_fn, batches, dev = build(args)
    rank0 = distributed.process_index() == 0
    n_dev = distributed.process_count()
    mesh = state.layout.mesh if state.layout is not None else None
    if rank0:
        print(f'devices={n_dev} device={dev} model={args.model} '
              f'params={config.num_params() / 1e9:.2f}B '
              f'{"full-ft" if args.full_ft else f"lora-rank={args.lora_rank}"}'
              + (f' mesh={mesh_lib.describe_config(mesh.config)}'
                 if mesh is not None else ''), flush=True)
    publisher = publish_lib.start_publisher('train')
    ckpt = None
    start_step = 0
    if args.checkpoint_dir:
        ckpt = ckpt_facade.CheckpointManager(
            args.checkpoint_dir,
            save_interval_steps=args.checkpoint_interval)
        state, start_step = ckpt.restore_or(state)
        if start_step and rank0:
            info = ckpt.last_restore or {}
            reshard = (' (resharded onto the current mesh)'
                       if info.get('resharded') else '')
            print(f'resumed from checkpoint at step {start_step}{reshard}',
                  flush=True)
    # A recovery relaunch: price the dead time since the controller saw
    # the failure into the goodput `recovery_stall` bucket.
    goodput_lib.note_recovery_stall_from_env()
    # One writer of the host's step-callback file (the JAX recipe runs one
    # process per host): the host's first process.
    if distributed.process_index() % distributed.local_world_size(
            args.device) == 0:
        callbacks.init(total_steps=args.steps)
    tokens_per_step = args.batch * args.seq
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {'tokens': torch.from_numpy(next(batches)).to(dev)}
        callbacks.step_begin()
        state, metrics = step_fn(state, batch)
        loss = float(metrics['loss'])  # waits for the step
        callbacks.step_end()
        if ckpt is not None:
            ckpt.maybe_save(step, state)
        if rank0 and (step % args.log_every == 0 or
                      step == args.steps - 1):
            dt = time.time() - t_start
            tps = (step - start_step + 1) * tokens_per_step / dt
            print(f'step {step} loss={loss:.4f} '
                  f'grad_norm={float(metrics["grad_norm"]):.3f} '
                  f'tokens/s={tps:.0f} tokens/s/chip={tps / n_dev:.0f}',
                  flush=True)
    if ckpt is not None:
        ckpt.wait()
        ckpt.close()
    publisher.close()
    if rank0:
        print('finetune done.', flush=True)


if __name__ == '__main__':
    main()
