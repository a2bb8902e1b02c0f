"""Where the engine's dispatches spend the card's time.

One decode dispatch (8 rows at contexts 17-2048, ``steps_per_dispatch``
steps), one verify dispatch (the same 8 rows, ``draft_k + 1`` query
positions each) and one 512-row prefill chunk (positions 512-1023 of a
1024-token prompt) of the ``--slots 8`` llama3-8b engine, random weights
from the replica's seed, bf16 and int8 (weights and pool). Each runs once
to warm up, then once under chip_smoke.py's ``profile_cuda`` (CUDA
activity only): device busy ms, the invariant GEMM's ms and calls, the
attention kernels' ms and calls (``attn_*``: K4, and in a prefill chunk
K4-prefill or, in a tree before it, K4's W = T form), the norms' ms,
calls and share of busy (``norm_*``: the fused residual add + RMSNorm,
or in a tree before it the norm alone), PyTorch's adds (``torch_add_*``:
there, the residual adds), the K/V write's ms, calls and share of busy
(``write_*``: K5F and K5, and in a tree where a forward still ran it
eagerly, the RoPE and int8 kernels around K5; chip_smoke.py's
``WRITE_KERNELS``), launches, wall ms and the top kernels. The
dispatches are chip_smoke.py's ``engine_dispatches``. Every kernel of
each profile, by name, goes to ``chiprun_out/dispatch/``.

The engine-off path (``--kinds`` with ``engine_off``): chip_smoke.py's
``serve_8b_point`` (llama3.1-8b, 32 layers, batch 8, 1024-token prompts,
32 new tokens; int8 weights and KV, or bf16), its TTFT and TPOT on a
``SERVE_8B`` line with the K/V write's launch counts, and a profile of
the prompt alone and of one decode step alone (``DISPATCH`` lines of
kind ``engine_off_prompt`` and ``engine_off_step``).

``--root DIR`` imports ``skypilot_torch`` from another checkout (this
script's ``chip_smoke.py`` still measures), so that two trees are
measured by the same code in one call on one card::

    python3 dispatch_profile.py [--root DIR] [--forms bf16,int8]
        [--kinds decode,verify,prefill,engine_off]

Needs a CUDA card. Prints one ``DISPATCH`` JSON line per (form, kind),
with the card's name and power limit.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever ``--root`` puts first on
    the path."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--root', default=HERE, help='checkout to import from')
    parser.add_argument('--forms', default='bf16,int8')
    parser.add_argument('--kinds', default='decode,verify,prefill,engine_off')
    args = parser.parse_args()
    kinds = args.kinds.split(',')
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('dispatch_profile: CUDA is not available', file=sys.stderr)
        return 2
    from skypilot_torch.models import decode, llama
    from skypilot_torch.ops import decode_attention as da
    from skypilot_torch.recipes import serve_model
    from skypilot_torch.serve import batching
    smoke = _chip_smoke()
    card = smoke.smi_line()
    config = llama.get_config('llama3-8b')
    tag = os.path.basename(root.rstrip('/')) or 'root'
    out_dir = os.path.join(HERE, 'chiprun_out', 'dispatch')

    def profile(form, kind, fn, extra):
        smoke.profile_cuda(
            torch, fn, 'DISPATCH',
            dict(root=root, form=form, kind=kind, card=card, **extra),
            dump=os.path.join(out_dir, f'{tag}-{form}-{kind}.json'))
    engine_kinds = tuple(k for k in kinds if k != 'engine_off')
    for form in args.forms.split(','):
        if 'engine_off' in kinds:
            counts = {name: getattr(da, name.upper()) for name in (
                'cache_write', 'cache_write_q8', 'rope_cache_write',
                'rope_cache_write_q8') if hasattr(da, name.upper())}
            row = smoke.serve_8b_point(
                torch, form, counts,
                lambda kind, fn, extra, form=form: profile(form, kind, fn,
                                                           extra))
            row.pop('toks')
            smoke.log('SERVE_8B ' + json.dumps(dict(row, root=root,
                                                     card=card)))
            torch.cuda.empty_cache()
        if not engine_kinds:
            continue
        srv_args = serve_model.parse_args(
            ['--model', 'llama3-8b', '--port', '0', '--device', 'cuda',
             '--slots', '8'] + (['--quant', 'int8', '--kv-int8']
                                if form == 'int8' else []))
        server, _ = serve_model.build_server(srv_args)
        engine = server.engine
        try:
            cases, held = smoke.engine_dispatches(torch, engine, config,
                                                  batching, decode,
                                                  engine_kinds)
            for kind, fn, extra in cases:
                fn()
                profile(form, kind, fn, extra)
            for bl in held:
                engine.pool.free(bl)
        finally:
            server.server_close()
            engine.close()
        del server, engine
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
