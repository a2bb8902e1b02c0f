"""Llama finetuning recipe — the port of
``skypilot_tpu/recipes/finetune.py`` on one device.

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

Not ported yet, and refused with the ROADMAP.md item that brings them:
``--tp/--dp/--ep/--sp/--pp`` above 1 and ``--microbatches`` (Queue 1
items 15-18), ``--checkpoint-dir`` / ``SKYTPU_CHECKPOINT_DIR`` with the
elastic-resume flags (items 13-14), and the step metrics publisher
(item 5, ``instrument_train_step``).
"""
import argparse
import os
import time

import numpy as np
import torch

from skypilot_torch import device as device_lib
from skypilot_torch.models import llama
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
    for axis in ('tp', 'dp', 'ep', 'sp', 'pp'):
        p.add_argument(f'--{axis}', type=int, default=1,
                       help='mesh axis degree (only 1 is ported)')
    p.add_argument('--microbatches', type=int, default=None,
                   help='pipeline microbatches (not ported)')
    p.add_argument('--data', default=None,
                   help='tokenized dataset (.npy of token ids)')
    p.add_argument('--synthetic', action='store_true', default=None)
    p.add_argument('--checkpoint-dir',
                   default=os.environ.get('SKYTPU_CHECKPOINT_DIR'),
                   help='not ported (default $SKYTPU_CHECKPOINT_DIR)')
    p.add_argument('--param-dtype', default='bf16',
                   choices=['bf16', 'f32'])
    p.add_argument('--log-every', type=int, default=10)
    p.add_argument('--device', default=device_lib.DEFAULT_DEVICE,
                   help="where the step runs: 'cuda' (the kernels; raises "
                        "without CUDA) or 'cpu' (the plain PyTorch path)")
    return p.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """Raise for what this slice of the port does not run."""
    axes = {a: getattr(args, a) for a in ('tp', 'dp', 'ep', 'sp', 'pp')}
    wide = {a: n for a, n in axes.items() if n != 1}
    if wide:
        raise NotImplementedError(
            f'mesh axes {wide}: the port trains on one device; FSDP/TP, '
            'the sp ring and the pp pipeline come with ROADMAP.md Queue 1 '
            'items 15-18 (sharded training)')
    if args.microbatches is not None:
        raise NotImplementedError(
            '--microbatches: pipeline parallelism is not ported '
            '(ROADMAP.md Queue 1 item 18)')
    if args.checkpoint_dir:
        raise NotImplementedError(
            f'--checkpoint-dir / SKYTPU_CHECKPOINT_DIR '
            f'({args.checkpoint_dir!r}): checkpointing and resume are not '
            'ported (ROADMAP.md Queue 1 items 13-14)')


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
    """(config, state, step_fn, batches, device) for ``args``."""
    check_args(args)
    dev = device_lib.resolve_device(args.device)
    config = llama.get_config(args.model, max_seq_len=args.seq)
    param_dtype = (torch.bfloat16 if args.param_dtype == 'bf16'
                   else torch.float32)
    optimizer = train_lib.default_optimizer(learning_rate=args.lr)
    state = train_lib.init_train_state(
        config, seed=0, optimizer=optimizer, param_dtype=param_dtype,
        lora_rank=None if args.full_ft else args.lora_rank, device=dev)
    step_fn = train_lib.build_train_step(config, optimizer=optimizer)
    batches = data_iterator(args, config.vocab_size,
                            np.random.default_rng(0))
    return config, state, step_fn, batches, dev


def main(argv=None) -> None:
    args = parse_args(argv)
    config, state, step_fn, batches, dev = build(args)
    print(f'devices=1 device={dev} model={args.model} '
          f'params={config.num_params() / 1e9:.2f}B '
          f'{"full-ft" if args.full_ft else f"lora-rank={args.lora_rank}"}',
          flush=True)
    tokens_per_step = args.batch * args.seq
    t_start = time.time()
    for step in range(args.steps):
        batch = {'tokens': torch.from_numpy(next(batches)).to(dev)}
        state, metrics = step_fn(state, batch)
        loss = float(metrics['loss'])  # waits for the step
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t_start
            tps = (step + 1) * tokens_per_step / dt
            print(f'step {step} loss={loss:.4f} '
                  f'grad_norm={float(metrics["grad_norm"]):.3f} '
                  f'tokens/s={tps:.0f} tokens/s/chip={tps:.0f}',
                  flush=True)
    print('finetune done.', flush=True)


if __name__ == '__main__':
    main()
