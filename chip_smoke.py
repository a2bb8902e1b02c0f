#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``skypilot_torch``) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``skypilot_torch/csrc`` and runs,
in order (any failure exits non-zero; nothing is caught):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions; TF32 off for float32 matmuls and convolutions.
2. K1 (flash_fwd): Llama-3-8B prefill shapes in bf16 against
   ``_flash_fwd_plain`` in f32 on the card (out and lse), with kernel,
   plain, library (``F.scaled_dot_product_attention``, timed only) and
   bound times.
3. K4 (decode_attention): the serve path's decode shape and a batch of
   mixed lengths, against the plain version (``K4_TOL`` absolute and
   ``K4_REL_TOL`` per row and query position), same columns with the
   bound share and the device launches per call (kernel nodes of one
   call captured in a CUDA graph, which must be one: the splits' merge
   runs in the same launch); head_dim 64 at groups 1 and 8; a
   ``LAUNCH_FLOOR`` line (an empty kernel timed in a CUDA graph as the
   kernels are). Before the phases, ``BUILD`` lines give every kernel's
   registers, static shared memory and spills; ``K4_BUILD`` sums K4's 64
   instantiations (none may spill) and checks the wrapper's shared-memory
   plan against the kernel's own layout for every instantiation;
   ``MATMUL_BUILD`` shows HGMMA (``cuobjdump -sass``) in each of the
   invariant GEMM's six instantiations, their registers and spills, and
   the clusters the card holds at once, each at least the plan's table.
4. End-to-end numerics: llama3-8b at full width and 2 layers, bf16 on
   the card against the same weights in f32 on the CPU (plain paths);
   K5F = layers x forwards of the greedy run, K5 = 0.
5. Serve: the port's replica at llama3-8b (32 layers, random weights),
   four requests over HTTP; the kernels' launch counts are zeroed just
   before and read just after, and must equal layers x prefills (K1),
   layers x decode steps (K4) and layers x forwards (K5F; K5 0).
6. K1R (flash_fwd with fused RoPE): the training shapes (B 1 and 8,
   T = S = 2048, and a ragged 1000) against ``_flash_fwd_plain`` in f32
   with the same llama3-8b tables; library: SDPA after ``apply_rope``.
7. BWD (flash_bwd_prep, flash_bwd_dq, flash_bwd_dkv): the pre-pass,
   K2 and K3 through ``flash_attention_bwd`` at the training shapes
   with RoPE, tile edges, T > S (rows that see no key must get dq
   exactly 0), full attention, head_dim 64 and a peaked case (q, k x 4),
   against ``_flash_bwd_plain`` in f32 on the pre-pass's rotated q/k;
   the dV-sum invariant (sum over keys of dV = sum of dO over the rows
   that see a key); two calls bit-equal; the pre-pass against
   ``_bwd_prep_plain`` (its rotated q/k bit-equal); library: SDPA's
   backward. ``flash_bwd``'s BUILD lines must show no spills.
8. Train: llama3-8b at 2 layers, bf16 on the card vs f32 on the CPU
   (LoRA loss and adapter gradients, one full-finetune step's loss and
   grad_norm); then ``recipes/finetune`` at llama3-8b, 32 layers, bf16
   base + LoRA rank 16, seq 2048, batch 8: one warm-up step, three
   counted steps (K1-RoPE = 2 x 32 x 3 with the checkpoint's recompute,
   pre-pass = K2 = K3 = 32 x 3), step time, tokens/s, peak memory, and
   a CUDA-only profile of one more step. The recipe's step is
   instrumented (``OBS_TRAIN``): its registry counts the 4 calls, their
   tokens and 3 intervals, ``skytpu_mfu_ratio`` is within
   ``OBS_MFU_REL_TOL`` of this script's 4 N figure over the same
   interval, the HBM gauges equal ``torch.cuda``'s readings, and a
   profile trigger armed for 2 steps yields a summary whose CUDA kernel
   rows hold K1-RoPE (pre-pass and mainloop) 128 times and the backward
   pre-pass, K2 and K3 64 times each.

9. K5 (cache_write): bit-exact against ``index_copy_`` at llama3-8b
   shapes, the rows form over [8, 8192, 8, 128] and the 4097-block pool
   with scattered rows (8, 72, 512), with kernel, plain, library and
   bound times. No serving path runs it (K5F writes them all).
9b. K5F (rope_cache_write): every serving forward's fused RoPE + int8 +
   cache write, bf16 and int8, at R = 8, 72, 512 and 8192 rows (the
   serve_8b prompt, one 1024-row table for 8 rows of prompt) over the
   4097-block pool with scattered and out-of-range rows, bit-exact
   against its plain version and against the eager chain it replaced,
   and its ``k_out`` rows against the plain rotation; kernel (graph,
   eager, with ``k_out``), plain, replaced-chain and bound times, and the
   kernels one call launches (1) beside the replaced chain's. Then
   ``K5F_PATHS``: at 2 layers, bf16 and int8, three 512-row prefill
   chunks (the second from a prefix hit's offset) and an 8 x 1024
   engine-off prompt with four decode steps, pools, caches, logits and
   the chunks' attention outputs bit-equal to the same paths on K5F's
   plain version.
10. K4P (decode_attention_paged): W = 1 and W = 9 over shuffled block
   tables (B 8, 16-token blocks, lengths to 8192) against the f32 plain
   version, timed beside the JAX package's route (gather + dense K4)
   and gather + SDPA; W = 1 bit-equal to dense K4 on contiguous tables;
   B1 at W 2 and 9, head_dim 64 at groups 1 and 8 (W 9), and a 37-page
   table (MB * bs not a whole number of 64-key tiles); ``K4_GRAPH``: a
   4-layer sequence of decode and verify calls and a dense call, captured
   in one CUDA graph and replayed, bit-equal to the same calls made
   eagerly.
10b. INVARIANCE (Queue 3 R9): the invariant GEMM at every llama3-8b
   engine shape, bf16 and int8 weights (and the tied head's transposed
   form at 4096^2), every row bit-equal at M = 1, 8, 9, 72, 512 and
   alone, within ``MATMUL_TOL`` of f32 and of cuBLAS, with a
   ``MATMUL_INV`` line per shape (kernel and cuBLAS ms on cold weights,
   in a CUDA graph and eagerly, the bound and each M's plan at M = 8,
   72, 512); the LoRA delta against its plain version, one launch of
   each of its two kernels a call (``LORA_DELTA``); every other row op of the engine's path bit-equal for a
   row (RMSNorm alone and fused with the residual add before it, at M
   1/8/9/72/512; the LoRA delta, the nucleus threshold, K5F, K4-paged at
   B 1/8 x W 1/9 in bf16 and int8, dense K4's prefill form at T 1..512,
   the int8 quantization), each row of a call against the same row in
   calls of other shapes, the torch forms they replaced printed beside;
   at 32 layers, bf16 and int8, one decode step's and one verify step's
   tokens and new K/V rows for each of 8 rows equal to the row's step
   alone; prefill against decode at one position, printed only.
11. Engine: the engine's prefill logits and greedy tokens at 2 layers,
   bf16 on the card vs f32 on the CPU; then the ``--slots 8`` replica at
   llama3-8b (32 layers) answering 12 concurrent requests (a shared
   1024-token prefix that must hit, two prompts the drafter must draft
   on), launch counts equal to the engine's dispatch record (per layer
   of each decode step and verify one K5F and one K4-paged, of each
   prefill chunk one K5F and one K4-prefill, K5 none; 7 L + 1 GEMMs per
   forward),
   TTFT and TPOT per request, output tokens/s, and a profile of one
   decode dispatch (its device launches per step). ``OBS_ENGINE``: the
   replica's textfile (``SKYTPU_METRICS_DIR``) agrees with the dispatch
   record and the responses (requests, tokens, prefix hits, drafted and
   accepted tokens, TTFT count, slots, pool blocks, the HBM gauges);
   each request, sent with its own ``traceparent``, has
   ``replica.generate`` and the engine's spans under its trace id; a
   profile trigger armed as the burst starts yields K4-paged and K5F
   kernel rows. ``OBS_COST``: the gauge sweep and
   one dispatch's metric updates in us, a publisher tick in ms, beside
   the card's name and power limit.
11b. Sampling: keys and 32-bit random bits at [128256] for 64 (seed,
   position) pairs bit-equal between the card and the CPU; ``sample_rows``
   and ``verify_targets`` on the same f32 logits give the CPU's tokens
   (a flip only where the CPU's top-two gap is under
   ``SAMPLER_FLIP_GAP``); a chi-square test of 4096 keyed draws on a
   peaked row; then the ``--slots 8`` replica with a synthetic
   128256-id grammar vocab answering 12 concurrent requests (4 greedy,
   6 sampled of which two draft, a regex and a json_schema request):
   launch counts equal to the dispatch record, constrained outputs that
   keep their DFA alive and full-match where they ended in EOS; printed
   beside it: the greedy burst's numbers, the sampler's share of a
   sampled dispatch, the grammar mask build per new DFA state, the
   verify mask table's bytes; each seeded request re-run alone and with
   speculation off must give the burst's tokens (batch invariance).
11c. Adapters (multi-LoRA and overload control): llama3-8b at 2 layers
   with two adapters, bf16 on the card vs f32 on the CPU (first-token
   logits of ``forward_paged`` under each); then the ``--slots 8``
   replica with ``--adapter-capacity 2`` over lineages written by the
   port's checkpoint copies ('a' rank 8 bf16 and 'b' 16 preloaded, 'c'
   16 cold, 'big' 32 over the rank bucket) and ``--max-queued-requests
   4``: 12 concurrent greedy requests (3 base, 3 per adapter, a 512-token
   prefix shared by a base and two 'a' requests), launch counts equal to
   the dispatch record, adapter logits that differ from the base's,
   no base block reused under an adapter, the cold load evicting an
   adapter, slot 0 still zeros, 413 for 'big' and 404 for an unknown id,
   every request equal to its run alone (base rows also on an
   adapterless engine), with no divergence allowed;
   printed beside it: the same prompts on an adapterless engine, the
   cold load's host read and upload, the LoRA delta's share of a decode
   dispatch. Then overload on the same replica: 16 requests (4 batch)
   against the queue bound: evictions and sheds answered 429 with
   Retry-After, a 504 for an expired ``X-Skytpu-Deadline``, a dropped
   stream cancelled, the pool back to idle, every completed request equal
   to its run alone.
12. Rows: ``decode_steps_rows`` (K5F + dense K4) and ``decode_steps_paged``
   (K5F + K4-paged) at llama3-8b, B 8, 16 steps on the same content:
   32 x 16 launches each and equal tokens.
13. K6 (packed_flash_fwd): the head-paired forward against its f32 plain
   version (shared and paired kv, T < S, non-causal), kernel / plain /
   K1 / SDPA / bound times at B 8, T 2048, 32/8 heads, head_dim 64; then
   its entry point ``bench_main()`` with its launches counted.
14. INT8K: the int8 forms of K4 (dense; paged W = 1 and W = 9, W = 1
   bit-equal to dense int8 on contiguous tables; dense head_dim 64 at
   groups 1 and 8; paged B1 at W 2 and 9; the ``K4_GRAPH`` replay) and
   K5 (bit-exact on codes and scales) against their plain versions,
   with times.
15. INT8: llama3-8b at 2 layers with int8 weights and int8 KV, bf16 on
   the card vs f32 on the CPU; the serve_8b point (llama3.1-8b, 32
   layers, int8 weights and KV, batch 8, 1024-token prompts, 32 new,
   K1 = 32, int8 K4 = 32 x 31 and int8 K5F = 32 x 32, K5 0; profiles of
   its prompt and of one decode step) beside the same run in bf16; the
   ``--slots 8 --quant int8 --kv-int8`` replica on the engine's
   12-request burst (launch counts equal its dispatch record); one
   engine-off ``--quant int8`` TPOT (K5F = 32 x 32).
16. QLoRA: llama3.1-8b (32 layers) over an int8 frozen base, LoRA rank
   16, seq 2048, batch 4: one warm-up and three counted steps on one
   fixed batch (K1-RoPE 192, pre-pass = K2 = K3 = 96), falling losses,
   step time, tokens/s, MFU (4N), peak memory and a profile of one more
   step.

Then one ``{"kernels": [...]}`` JSON line and, last, the
``{"ok": true, "device": {...}}`` line. ``--phases`` runs a subset (no
final lines then). Exits non-zero without printing a result when CUDA
is absent or the ``skypilot_torch`` package is not beside this file.
"""
import argparse
import collections
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
L2_BYTES = 50 * 2 ** 20
PHASES = ('k1', 'k4', 'e2e', 'serve', 'k1r', 'bwd', 'train', 'k5', 'k5f',
          'k4p', 'k4pre', 'invariance', 'engine', 'sampling', 'adapters',
          'rows', 'k6', 'int8k', 'int8', 'qlora')
K1_TOL = {'out': 2e-2, 'lse': 2e-2}
# K2/K3 in bf16 (P and dS rounded to bf16 before their products) against
# f32 on the same rotated bf16 q and k: max |err| over max |ref| per
# gradient.
BWD_REL_TOL = 3e-2
# The peaked case (|S| to a few tens) and the dV-sum invariant: with S
# scaled in f32 only the bf16 rounding of P, dS and the stored gradients
# remains, random in sign.
BWD_PEAKED_TOL = 1e-2
BWD_DV_SUM_TOL = 1e-2
# The pre-pass's delta against the f32 plain version: summation order.
PREP_TOL = 1e-5
K4_TOL = 2e-2
# K4 against its f32 plain version, per (row, query position): max |err|
# over max |ref| across its heads and dims. K4_TOL's one absolute bound is
# as large as a long row's typical output (about sqrt(e / n) at n keys);
# this holds every row to its own size, so a tile or a split dropped from
# a long row fails it.
K4_REL_TOL = 1e-2
# K4's prefill form (T 512 over 589-1100 visible keys, outputs about
# 0.05) against f32: read 0.0011 on the card; K4_TOL would pass a
# dropped piece of a row.
K4_PREFILL_TOL = 4e-3
E2E_REL_TOL = 5e-2
# bf16 on the card vs f32 on the CPU at 2 layers: relative loss error,
# max |err| / max |ref| per LoRA gradient, relative loss and grad_norm
# error of one full-finetune step (its grad_norm is bf16, as optax's).
TRAIN_TOL = {'loss': 1e-2, 'grad': 5e-2, 'full_ft': 2e-2}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, args_list, iters):
    """Mean ms per call over ``iters`` eager calls back to back, timed
    with CUDA events: the host's launch overhead included. Cycles
    through ``args_list`` (copies of the inputs, so a call finds its
    inputs outside L2 the way the model's caller does)."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, args_list, iters):
    """Mean device time per call in ms: ``iters`` calls (cycling
    through ``args_list``) captured in one CUDA graph, whose replay is
    timed with CUDA events, so host launch gaps drop out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in args_list[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def ptxas_report(log_path):
    """Each kernel's registers and spills from a library's nvcc log
    (``-Xptxas -v``): one dict per entry function, its name demangled by
    ``c++filt`` where the host has it."""
    entries, cur = [], None
    with open(log_path, errors='replace') as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = dict(kernel=m.group(1))
                entries.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
            if m:
                cur.update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
            m = re.search(r'Used (\d+) registers', line)
            if m:
                cur['registers'] = int(m.group(1))
            m = re.search(r'(\d+) bytes smem', line)
            if m:
                cur['static_smem'] = int(m.group(1))
    try:
        names = subprocess.run(
            ['c++filt'], input='\n'.join(e['kernel'] for e in entries),
            capture_output=True, text=True, check=True).stdout.splitlines()
        if len(names) == len(entries):
            for e, n in zip(entries, names):
                e['kernel'] = n
    except (OSError, subprocess.CalledProcessError):
        pass
    return entries


def sass_counts(lib_path, opcode):
    """Lines of each kernel's SASS in a built library that issue
    ``opcode`` (``cuobjdump -sass``), by mangled function name; None
    where the toolkit has no cuobjdump."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                         text=True, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and opcode in line:
            counts[cur] += 1
    return counts


def copies_outside_l2(make, nbytes, first):
    """``first`` and enough fresh copies of an input set that cycling
    through them overflows L2 twice."""
    n = min(16, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [first] + [make() for _ in range(n - 1)]


def _visible_pairs(t, s):
    """(q, k) pairs the causal bottom-right mask leaves visible."""
    return sum(min(max(i + (s - t) + 1, 0), s) for i in range(t))


# The K/V write of a serving forward, by kernel name: K5F and K5, and in a
# tree where a forward still ran it eagerly, the chain around the write
# (RoPE of q and k with cos and sin recomputed, the int8 quantization of
# k and v) as PyTorch 2.11's CUDA build names its kernels: cos/sin, the f32
# products, quotients and differences, the cat of the halves, abs / amax /
# clamp / round, and the cast to int8. Its casts between bf16 and f32
# share their kernels with the MLP's and are counted apart (CAST_KERNELS),
# as are the slice assignments of the old engine-off cache (bf16 copies).
WRITE_KERNELS = (r'cache_write_kernel|cos_kernel|sin_kernel|'
                 r'CatArrayBatchedCopy|AbsFunctor|round_kernel|clamp_|'
                 r'MaxNanFunctor|lambda\(signed char\)|'
                 r'(Binary|BUnary)Functor<float, float, float, '
                 r'\S*(Mul|Div)Functor|CUDAFunctor_add<float>')
CAST_KERNELS = r'direct_copy_kernel_cuda|bfloat16_copy_kernel_cuda'


def profile_cuda(torch, fn, label, extra, dump=None):
    """Where ``fn``'s time goes: the card's busy time (CUDA-only
    profiler, so the host runs almost as unprofiled) against the wall
    clock, and the kernels that take the most device time. ``dump``: a
    path to write every kernel's name, calls and ms to. Returns the busy
    ms."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    # The port's own kernels (csrc/), wherever they rank: PyTorch's own
    # kernels sit in anonymous namespaces too, but under at::.
    port = [e for e in events if re.search(
        r'flash_sm90::|anonymous namespace', e.key) and 'at::' not in e.key]
    k4_ms = sum(e.self_device_time_total for e in events
                if 'decode_kernel' in e.key) / 1e3
    # Attention, in a prefill chunk: K4-prefill, or (before it) K4's
    # W = T form.
    attn = [e for e in events
            if 'prefill_kernel' in e.key or 'decode_kernel' in e.key]
    # The serving path's invariant GEMM (csrc/matmul_invariant.cu).
    gemm = [e for e in events if 'matmul_kernel' in e.key]
    # The norms (csrc/rms_norm.cu; before the fused form, rms_norm_kernel)
    # and PyTorch's elementwise adds (the residual adds before the fused
    # form, and every other torch add).
    norm = [e for e in events if 'rms_norm_kernel' in e.key]
    adds = [e for e in events if re.search(r'Functor\w*_add', e.key)]
    write = [e for e in events if re.search(WRITE_KERNELS, e.key)]
    write_ms = sum(e.self_device_time_total for e in write) / 1e3
    casts = [e for e in events if re.search(CAST_KERNELS, e.key)
             and e not in write]
    launches = sum(e.count for e in events)
    if dump:
        os.makedirs(os.path.dirname(dump), exist_ok=True)
        with open(dump, 'w') as f:
            json.dump(dict(extra, label=label, kernels=[
                dict(name=e.key, calls=e.count,
                     ms=e.self_device_time_total / 1e3,
                     write=bool(re.search(WRITE_KERNELS, e.key)))
                for e in sorted(events,
                                key=lambda e: -e.self_device_time_total)]),
                f, indent=1)
    log(label + ' ' + json.dumps(dict(
        extra, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / wall_ms,
        k4_ms=k4_ms, k4_share=k4_ms / busy_ms if busy_ms else 0.0,
        gemm_ms=sum(e.self_device_time_total for e in gemm) / 1e3,
        gemm_calls=sum(e.count for e in gemm),
        attn_ms=sum(e.self_device_time_total for e in attn) / 1e3,
        attn_calls=sum(e.count for e in attn),
        norm_ms=sum(e.self_device_time_total for e in norm) / 1e3,
        norm_calls=sum(e.count for e in norm),
        norm_share=(sum(e.self_device_time_total for e in norm) / 1e3 /
                    busy_ms if busy_ms else 0.0),
        torch_add_ms=sum(e.self_device_time_total for e in adds) / 1e3,
        torch_add_calls=sum(e.count for e in adds),
        write_ms=write_ms, write_calls=sum(e.count for e in write),
        write_share=write_ms / busy_ms if busy_ms else 0.0,
        cast_ms=sum(e.self_device_time_total for e in casts) / 1e3,
        cast_calls=sum(e.count for e in casts),
        device_launches=launches,
        **({'device_launches_per_step': launches / extra['steps']}
           if 'steps' in extra else {}),
        top=[dict(name=e.key[:80], calls=e.count,
                  ms=e.self_device_time_total / 1e3) for e in top],
        port_kernels=[dict(name=e.key[:80], calls=e.count,
                           ms=e.self_device_time_total / 1e3)
                      for e in port])))
    return busy_ms


# ---------------------------------------------------------------------
# Observability: the registry, the textfile, the spans, the profiles
# ---------------------------------------------------------------------

# The name of this card in the port's peak table
# (``metrics/goodput.PEAK_BF16_FLOPS``: the same 989e12 as
# PEAK_BF16_FLOPS here), stamped for the train phase's MFU check only.
OBS_ACCELERATOR = 'H100-SXM'
# ``skytpu_mfu_ratio`` against this script's own 4 N figure over the same
# step interval.
OBS_MFU_REL_TOL = 0.02
# The greedy ENGINE burst's output tokens/s in an earlier full run of
# this script, before the observability checks (H100 80GB HBM3, 700 W),
# printed beside this run's.
OBS_REFERENCE_ENGINE_TOKENS_PER_S = 73.14


def _obs_dir(name):
    """A fresh directory ``name`` under this run's state dir."""
    d = os.path.join(os.environ['SKYTPU_STATE_DIR'], name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def _family(reg, name):
    """The one series of an unlabeled family in the port's registry
    (None when the family was never registered)."""
    fam = {f.name: f for f in reg.families()}.get(name)
    return None if fam is None else fam.collect()[0][1]


def _prom(path):
    """A published textfile, parsed by the port's ``exposition``:
    {sample name{labels other than proc}: value}."""
    from skypilot_torch.metrics import exposition
    with open(path, encoding='utf-8') as f:
        fams = exposition.parse_text(f.read())
    out = {}
    for fam in fams.values():
        for smp in fam.samples:
            labels = ','.join(f'{k}={v}' for k, v in smp.labels
                              if k != 'proc')
            out[smp.name + (f'{{{labels}}}' if labels else '')] = smp.value
    return out


def _hbm_check(torch):
    """``sample_device_memory`` against ``torch.cuda``'s readings taken
    at the same moment (nothing allocates in between), in its return
    and in the registry's gauges."""
    from skypilot_torch import metrics
    from skypilot_torch.metrics import device as device_metrics
    torch.cuda.synchronize()
    rows = device_metrics.sample_device_memory()
    want = dict(bytes_in_use=torch.cuda.memory_allocated(),
                peak_bytes_in_use=torch.cuda.max_memory_allocated(),
                bytes_limit=torch.cuda.mem_get_info()[1])
    assert [r['device'] for r in rows] == [0], rows
    got = {k: rows[0][k] for k in want}
    gauges = {f.name: f for f in metrics.registry().families()}
    published = {
        'bytes_in_use': gauges['skytpu_device_hbm_used_bytes'],
        'peak_bytes_in_use': gauges['skytpu_device_hbm_peak_bytes'],
        'bytes_limit': gauges['skytpu_device_hbm_limit_bytes']}
    published = {k: f.labels(device='0').value for k, f in published.items()}
    assert got == want and published == {k: float(v)
                                          for k, v in want.items()}, (
        got, published, want)
    return got


def _kernel_rows(kind, patterns, timeout_s=300):
    """The on-demand profile's summary (``latest.json``, waited for) and
    the launches of the port's kernels in it: for each name, the summed
    count of the CUDA kernel rows (category ``kernel``; host rows never
    count) whose name holds all of its patterns. Fails when there is no
    summary or it has no kernel rows."""
    from skypilot_torch.utils import profiling
    deadline = time.time() + timeout_s
    payload = profiling.load_summary()
    while payload is None and time.time() < deadline:
        time.sleep(0.1)
        payload = profiling.load_summary()
    assert payload is not None, f'no {kind} profile summary was written'
    assert payload['kind'] == kind, payload['kind']
    rows = [r for r in payload['rows'] if r['category'] == 'kernel']
    assert rows, f'the {kind} summary has no CUDA kernel rows: ' + \
        json.dumps(payload['rows'][:5])
    counts = {name: sum(r['count'] for r in rows
                        if all(p in r['name'] for p in pats))
              for name, pats in patterns.items()}
    return payload, rows, counts


def _time_capture(profiler):
    """Time a ``StepProfiler``'s capture from outside the package: its
    ``on_step`` and ``_finish`` are wrapped on the instance. The returned
    dict gets ``start`` (the capture began), ``finish`` (its steps are
    done) and ``end`` (stopped, exported, summarized and written), all
    ``perf_counter`` readings."""
    times = {}
    on_step, finish = profiler.on_step, profiler._finish

    def timed_on_step():
        was = profiler._prof
        on_step()
        if was is None and profiler._prof is not None:
            times['start'] = time.perf_counter()

    def timed_finish():
        times['finish'] = time.perf_counter()
        finish()
        times['end'] = time.perf_counter()
    profiler.on_step, profiler._finish = timed_on_step, timed_finish
    return times


def _spans_by_trace():
    """Every span in the port's sink dir, by trace id."""
    from skypilot_torch import trace
    out = collections.defaultdict(list)
    for path in glob.glob(os.path.join(trace.sink_dir(), '*.jsonl')):
        with open(path, encoding='utf-8') as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                out[rec['trace_id']].append(rec)
    return out


def _trace_check(traced, timeout_s=30):
    """Each traced request's spans: one ``replica.generate`` under the
    header's span, ``batch.queue_wait``, ``batch.first_token``, >= 1
    ``batch.prefill`` and >= 1 ``batch.decode`` under it, and nothing
    else in its trace. Returns span counts by name over the burst."""
    deadline = time.time() + timeout_s
    while True:
        by_trace = _spans_by_trace()
        done = [any(s['name'] == 'replica.generate'
                    for s in by_trace.get(tid, ())) for tid, _ in traced]
        if all(done) or time.time() > deadline:
            break
        time.sleep(0.1)
    names = collections.Counter()
    for tid, sid in traced:
        spans = by_trace.get(tid, [])
        gen = [s for s in spans if s['name'] == 'replica.generate']
        assert len(gen) == 1 and gen[0]['parent_id'] == sid, (tid, spans)
        kids = collections.Counter(s['name'] for s in spans
                                   if s['parent_id'] == gen[0]['span_id'])
        assert len(spans) == 1 + sum(kids.values()), spans
        assert (kids['batch.queue_wait'], kids['batch.first_token']) == \
            (1, 1) and kids['batch.prefill'] >= 1 and \
            kids['batch.decode'] >= 1 and len(kids) == 4, kids
        names.update(s['name'] for s in spans)
    return dict(names)


# ---------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------


def _fused_qkv(torch, gen, b, t, h, hkv, d):
    """q, k, v as strided views into one [B, T, H + 2 Hkv, D] buffer,
    the layout a fused qkv projection leaves (checks the tensor maps'
    strides)."""
    buf = torch.randn((b, t, h + 2 * hkv, d), generator=gen, device='cuda',
                      dtype=torch.bfloat16)
    return buf[:, :, :h], buf[:, :, h:h + hkv], buf[:, :, h + hkv:]


def k1_phase(torch, F, attention):
    H, HKV = 32, 8
    # (B, T, S, D, causal, fused): the serve path's prompt lengths (17,
    # 256, 1000, 2048), batch 4, T < S, and T > S (rows that see no key);
    # head_dim 64 causal and full; T = S at the 128-row/128-key tile
    # edges (127, 128, 129) and a long row (4096); q/k/v as views into a
    # fused qkv buffer.
    cases = [(1, 17, 17, 128, True, False), (1, 256, 256, 128, True, False),
             (1, 1000, 1000, 128, True, False),
             (1, 2048, 2048, 128, True, False),
             (4, 2048, 2048, 128, True, False),
             (1, 128, 2048, 128, True, False),
             (1, 1000, 512, 128, True, False),
             (1, 2048, 2048, 64, True, False),
             (1, 2048, 2048, 64, False, False),
             (1, 127, 127, 128, True, False), (1, 128, 128, 128, True, False),
             (1, 129, 129, 128, True, False),
             (1, 4096, 4096, 128, True, False),
             (2, 1000, 1000, 128, True, True)]
    gen = torch.Generator(device='cuda').manual_seed(11)
    rows = []
    for b, t, s, D, causal, fused in cases:
        scale = D ** -0.5

        def make(b=b, t=t, s=s, D=D, fused=fused):
            if fused:
                return _fused_qkv(torch, gen, b, t, H, HKV, D)
            return (torch.randn((b, t, H, D), generator=gen, device='cuda',
                                dtype=torch.bfloat16),
                    torch.randn((b, s, HKV, D), generator=gen,
                                device='cuda', dtype=torch.bfloat16),
                    torch.randn((b, s, HKV, D), generator=gen,
                                device='cuda', dtype=torch.bfloat16))
        q, k, v = make()
        out, lse = attention.flash_attention_fwd(q, k, v, causal=causal,
                                                 scale=scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = attention._flash_fwd_plain(
            q.float(), k.float(), v.float(), causal=causal, scale=scale)
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        # Rows that see no key: lse = +1e30 and out = 0 on both sides.
        empty = ref_lse >= attention.EMPTY_ROW_LSE
        assert torch.equal(empty, lse >= attention.EMPTY_ROW_LSE)
        assert not bool(out[empty.transpose(1, 2)].any())
        ok = (err_out <= K1_TOL['out'] and err_lse <= K1_TOL['lse']
              and bool(torch.isfinite(out.float()).all()))
        pairs = _visible_pairs(t, s) if causal else t * s
        flops = 4 * b * H * D * pairs
        nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
                  + 4 * lse.numel())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = 'operations' if t_ops >= t_bytes else 'bytes'
        inputs = copies_outside_l2(make, nbytes, (q, k, v))
        iters = 20 if t * s * b >= 2 ** 22 else 100
        mask = None
        if causal and t != s:
            mask = (torch.arange(s, device='cuda')[None, :] <=
                    torch.arange(t, device='cuda')[:, None] + (s - t))

        def kernel(q, k, v, causal=causal, scale=scale):
            return attention.flash_attention_fwd(q, k, v, causal=causal,
                                                 scale=scale)

        def plain(q, k, v, causal=causal, scale=scale):
            return attention._flash_fwd_plain(q, k, v, causal=causal,
                                              scale=scale)

        def library(q, k, v, causal=causal, scale=scale, mask=mask):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, is_causal=causal and mask is None,
                scale=scale, enable_gqa=True)

        kernel_ms = graph_ms(torch, kernel, inputs, iters)
        row = dict(B=b, T=t, S=s, D=D, causal=causal, fused_qkv=fused,
                   max_abs_err_out=err_out, max_abs_err_lse=err_lse,
                   tol=K1_TOL, ok=ok, kernel_ms=kernel_ms,
                   plain_ms=graph_ms(torch, plain, inputs[:2],
                                      max(3, iters // 10)),
                   library_ms=graph_ms(torch, library, inputs, iters),
                   bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / kernel_ms / 1e9,
                   kernel_wall_ms=cuda_ms(torch, kernel, inputs, iters))
        log('K1 ' + json.dumps(row))
        rows.append(row)
        del q, k, v, out, lse, ref_out, ref_lse, inputs
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r['ok']]
    assert not bad, f'K1 disagrees with its plain version: {bad}'
    main_case = next(r for r in rows if (r['B'], r['T'], r['S'], r['D'])
                     == (1, 2048, 2048, 128) and r['causal'])
    return dict(max_abs_err=max(max(r['max_abs_err_out'],
                                    r['max_abs_err_lse']) for r in rows),
                ms=main_case['kernel_ms'], plain_ms=main_case['plain_ms'],
                bound_ms=main_case['bound_ms'],
                bound_by=main_case['bound_by'],
                library_ms=main_case['library_ms'])


# ---------------------------------------------------------------------
# K1 with fused RoPE, K2 and K3 (the training slice's attention)
# ---------------------------------------------------------------------

# (B, T, S): the training step's shape (B 8, seq 2048), batch 1, and a
# ragged length; RoPE needs T == S.
TRAIN_ATTN_CASES = [(1, 2048, 2048), (8, 2048, 2048), (1, 1000, 1000)]


def _attn_inputs(torch, gen, b, t, s, with_do=False, d=128):
    H, HKV, D = 32, 8, d
    shapes = [(b, t, H, D), (b, s, HKV, D), (b, s, HKV, D)]
    if with_do:
        shapes.append((b, t, H, D))
    return tuple(torch.randn(sh, generator=gen, device='cuda',
                             dtype=torch.bfloat16) for sh in shapes)


def _llama_tables(torch, attention, t, name='llama3-8b'):
    from skypilot_torch.models import llama
    config = llama.get_config(name)
    angles = llama._rope_frequencies(
        config, torch.arange(t, device='cuda'))
    cos, sin = attention.rope_tables(angles)
    return angles, cos, sin


def k1r_phase(torch, F, attention):
    """K1's fused-RoPE entry (the rotation pre-pass, then the mainloop)
    against the f32 plain version with the same llama3 tables: the
    training shapes, a tile-edge length, q/k/v as views into a fused qkv
    buffer (the pre-pass reads them through strides) and head_dim 64
    with llama3.2-1b's tables."""
    H, HKV = 32, 8
    gen = torch.Generator(device='cuda').manual_seed(15)
    rows = []
    # (B, T, S, D, fused)
    cases = ([(b, t, s, 128, False) for b, t, s in TRAIN_ATTN_CASES] +
             [(1, 129, 129, 128, False), (2, 1000, 1000, 128, True),
              (1, 2048, 2048, 64, False)])
    for b, t, s, D, fused in cases:
        scale = D ** -0.5
        angles, cos, sin = _llama_tables(
            torch, attention, t, 'llama3-8b' if D == 128 else 'llama3.2-1b')

        def make(b=b, t=t, s=s, D=D, fused=fused):
            if fused:
                return _fused_qkv(torch, gen, b, t, H, HKV, D)
            return tuple(torch.randn(sh, generator=gen, device='cuda',
                                     dtype=torch.bfloat16)
                         for sh in ((b, t, H, D), (b, s, HKV, D),
                                    (b, s, HKV, D)))
        q, k, v = make()
        before = attention.FLASH_FWD.launches
        out, lse = attention.flash_attention_fwd(q, k, v, True, scale, cos,
                                                 sin)
        torch.cuda.synchronize()
        assert attention.FLASH_FWD.launches == before  # the RoPE entry ran
        ref_out, ref_lse = attention._flash_fwd_plain(
            q.float(), k.float(), v.float(), True, scale, cos, sin)
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ok = (err_out <= K1_TOL['out'] and err_lse <= K1_TOL['lse']
              and bool(torch.isfinite(out.float()).all()))
        flops = 4 * b * H * D * _visible_pairs(t, s)
        nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
                  + 4 * (lse.numel() + cos.numel() + sin.numel()))
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        inputs = copies_outside_l2(make, nbytes, (q, k, v))
        iters = 10 if b * t >= 2 ** 14 else 30

        def kernel(q, k, v, scale=scale, cos=cos, sin=sin):
            return attention.flash_attention_fwd(q, k, v, True, scale, cos,
                                                 sin)

        def plain(q, k, v, scale=scale, cos=cos, sin=sin):
            return attention._flash_fwd_plain(q, k, v, True, scale, cos,
                                              sin)

        def library(q, k, v, scale=scale, angles=angles):
            qr = attention.apply_rope(q, angles).transpose(1, 2)
            kr = attention.apply_rope(k, angles).transpose(1, 2)
            return F.scaled_dot_product_attention(
                qr, kr, v.transpose(1, 2), is_causal=True, scale=scale,
                enable_gqa=True)

        kernel_ms = graph_ms(torch, kernel, inputs, iters)
        row = dict(B=b, T=t, S=s, D=D, fused_qkv=fused, rope=True,
                   max_abs_err_out=err_out,
                   max_abs_err_lse=err_lse, tol=K1_TOL, ok=ok,
                   kernel_ms=kernel_ms,
                   plain_ms=graph_ms(torch, plain, inputs[:1], 2),
                   library_ms=graph_ms(torch, library, inputs, iters),
                   library='apply_rope x2 + SDPA (GQA, causal)',
                   bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by='operations' if t_ops >= t_bytes else 'bytes',
                   tflops=flops / kernel_ms / 1e9)
        log('K1R ' + json.dumps(row))
        rows.append(row)
        del q, k, v, out, lse, ref_out, ref_lse, inputs
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r['ok']]
    assert not bad, f'K1 with RoPE disagrees with its plain version: {bad}'
    main_case = next(r for r in rows if r['B'] == 8)
    return dict(max_abs_err=max(max(r['max_abs_err_out'],
                                    r['max_abs_err_lse']) for r in rows),
                B=8, T=2048, S=2048, ms=main_case['kernel_ms'],
                plain_ms=main_case['plain_ms'],
                bound_ms=main_case['bound_ms'],
                bound_by=main_case['bound_by'],
                library_ms=main_case['library_ms'])


# (B, T, S, D, rope, causal, peaked): the training shapes, tile edges
# (129 against 64-row and 64-key tiles), T > S (rows that see no key),
# full attention, head_dim 64 with llama3.2-1b's tables, and a "peaked"
# case whose q and k are scaled x4, so |S| reaches a few tens.
BWD_CASES = [(1, 2048, 2048, 128, True, True, False),
             (8, 2048, 2048, 128, True, True, False),
             (1, 1000, 1000, 128, True, True, False),
             (2, 129, 129, 128, True, True, False),
             (1, 1000, 512, 128, False, True, False),
             (1, 1000, 1000, 128, False, False, False),
             (8, 2048, 2048, 64, True, True, False),
             (1, 2048, 2048, 128, True, True, True)]


def _dv_sum_error(torch, dv, do, t, s, causal, hkv):
    """The invariant that needs no reference: per (b, kv head), sum over
    keys of dV = sum over the group's rows that see a key of dO, exactly
    when P's rows sum to 1. Returns max |lhs - rhs| / max |rhs|."""
    b, _, h, d = do.shape
    seen = torch.ones(t, dtype=torch.bool, device=do.device)
    if causal:
        seen = torch.arange(t, device=do.device) + (s - t) >= 0
    rhs = (do.float() * seen[None, :, None, None]).sum(1).reshape(
        b, hkv, h // hkv, d).sum(2)
    lhs = dv.float().sum(1)
    return ((lhs - rhs).abs().max() / rhs.abs().max()).item()


def bwd_phase(torch, F, attention):
    """The backward: the pre-pass, K2 (dq) and K3 (dk, dv) through
    ``flash_attention_bwd`` on K1's out and lse, against the f32 plain
    version on the pre-pass's own (rotated, bf16) q and k, pulled back
    through RoPE as the kernels do; the dV-sum invariant; two calls
    bit-equal; the pre-pass against ``_bwd_prep_plain`` (delta to f32
    rounding, the rotated q/k bit-equal). Times of the
    pre-pass, each kernel, the whole backward, the plain version and
    SDPA's backward beside their bounds."""
    H, HKV = 32, 8
    gen = torch.Generator(device='cuda').manual_seed(16)
    rows = []
    for b, t, s, D, rope, causal, peaked in BWD_CASES:
        scale = D ** -0.5
        cos = sin = angles = None
        if rope:
            angles, cos, sin = _llama_tables(
                torch, attention, t, 'llama3-8b' if D == 128 else
                'llama3.2-1b')

        def make(b=b, t=t, s=s, D=D, causal=causal, peaked=peaked,
                 scale=scale, cos=cos, sin=sin):
            q, k, v, do = _attn_inputs(torch, gen, b, t, s, with_do=True,
                                       d=D)
            if peaked:
                q, k = 4 * q, 4 * k
            out, lse = attention.flash_attention_fwd(q, k, v, causal, scale,
                                                     cos, sin)
            delta, qr, kr = attention._bwd_prep_cuda(q, k, out, do, cos,
                                                     sin)
            return q, k, v, out, lse, do, delta, qr, kr
        q, k, v, out, lse, do, delta, qr, kr = make()
        grads = attention.flash_attention_bwd(q, k, v, out, lse, do, cos,
                                              sin, causal, scale)
        again = attention.flash_attention_bwd(q, k, v, out, lse, do, cos,
                                              sin, causal, scale)
        torch.cuda.synchronize()
        dq, dk, dv = grads
        bit_equal = all(torch.equal(x, y) for x, y in zip(grads, again))
        ref = list(attention._flash_bwd_plain(
            qr.float(), kr.float(), v.float(), out.float(), lse, do.float(),
            None, None, causal, scale))
        if rope:
            ref[0] = attention._rot_inv(ref[0], cos, sin)
            ref[1] = attention._rot_inv(ref[1], cos, sin)
        rel = {}
        for name, got, want in zip(('dq', 'dk', 'dv'), grads, ref):
            rel[name] = ((got.float() - want).abs().max() /
                         want.abs().max()).item()
        p_delta, p_qr, p_kr = attention._bwd_prep_plain(q, k, out, do, cos,
                                                        sin)
        prep_err = ((delta - p_delta).abs().max() /
                    p_delta.abs().max()).item()
        rot_equal = torch.equal(qr, p_qr) and torch.equal(kr, p_kr)
        dv_sum_err = _dv_sum_error(torch, dv, do, t, s, causal, HKV)
        finite = all(bool(torch.isfinite(x.float()).all()) for x in grads)
        tol = BWD_PEAKED_TOL if peaked else BWD_REL_TOL
        ok = (finite and max(rel.values()) <= tol and bit_equal
              and dv_sum_err <= BWD_DV_SUM_TOL and prep_err <= PREP_TOL
              and rot_equal)
        empty_rows = causal and t > s
        if empty_rows:
            # Rows q_pos < T - S see no key: their dq is exactly 0.
            ok = ok and not bool(dq[:, :t - s].any())
        row = dict(B=b, T=t, S=s, D=D, rope=rope, causal=causal,
                   peaked=peaked, rel_err=rel, rel_tol=tol,
                   dv_sum_err=dv_sum_err, dv_sum_tol=BWD_DV_SUM_TOL,
                   bit_equal=bit_equal, prep_delta_err=prep_err,
                   prep_rot_bit_equal=rot_equal, empty_rows_zero=empty_rows,
                   ok=ok)
        if not peaked:
            vis = _visible_pairs(t, s) if causal else t * s
            n_q, n_k = q.numel(), k.numel()
            tables = 4 * (cos.numel() + sin.numel()) if rope else 0
            io = 2 * (n_q + 2 * n_k + do.numel()) + 4 * 2 * lse.numel()
            io += tables
            prep_bytes = (2 * 2 * n_q + 4 * lse.numel() + tables +
                          (2 * 2 * (n_q + n_k) if rope else 0))
            bounds = {'prep': (1e3 * prep_bytes / PEAK_HBM_BYTES, 'bytes')}
            for name, products, nbytes in (
                    ('dq', 3, io + 2 * n_q), ('dkv', 4, io + 4 * n_k)):
                t_ops = 2 * products * b * H * D * vis / PEAK_BF16_FLOPS
                t_bytes = nbytes / PEAK_HBM_BYTES
                bounds[name] = (1e3 * max(t_ops, t_bytes),
                                'operations' if t_ops >= t_bytes
                                else 'bytes')
            inputs = copies_outside_l2(
                make, io, (q, k, v, out, lse, do, delta, qr, kr))
            iters = 10 if b * t >= 2 ** 14 else 30

            def one(kernel, outs_like, causal=causal, scale=scale, cos=cos,
                    sin=sin):
                def run(q, k, v, out, lse, do, delta, qr, kr):
                    outs = tuple(torch.empty_like(x) for x in outs_like)
                    attention._bwd_launch(kernel, qr, kr, v, do, lse, delta,
                                          cos, sin, outs, causal, scale)
                return run

            def prep(q, k, v, out, lse, do, delta, qr, kr, cos=cos,
                     sin=sin):
                return attention._bwd_prep_cuda(q, k, out, do, cos, sin)

            def prep_plain(q, k, v, out, lse, do, delta, qr, kr, cos=cos,
                           sin=sin):
                return attention._bwd_prep_plain(q, k, out, do, cos, sin)

            def whole(q, k, v, out, lse, do, delta, qr, kr, causal=causal,
                      scale=scale, cos=cos, sin=sin):
                return attention.flash_attention_bwd(q, k, v, out, lse, do,
                                                     cos, sin, causal, scale)

            def plain(q, k, v, out, lse, do, delta, qr, kr, causal=causal,
                      scale=scale, cos=cos, sin=sin):
                return attention._flash_bwd_plain(q, k, v, out, lse, do,
                                                  cos, sin, causal, scale)

            row.update(
                prep_ms=graph_ms(torch, prep, inputs, iters),
                dq_ms=graph_ms(torch, one(attention.FLASH_BWD_DQ, (q,)),
                               inputs, iters),
                dkv_ms=graph_ms(torch, one(attention.FLASH_BWD_DKV, (k, v)),
                                inputs, iters),
                backward_ms=graph_ms(torch, whole, inputs, iters),
                prep_plain_ms=graph_ms(torch, prep_plain, inputs, iters),
                plain_ms=graph_ms(torch, plain, inputs[:1], 2),
                library_ms=_sdpa_backward_ms(
                    torch, F, attention, q, k, v, do, angles, scale, causal,
                    iters),
                **{f'{n}_bound_ms': v[0] for n, v in bounds.items()},
                **{f'{n}_bound_by': v[1] for n, v in bounds.items()})
            row['dq_tflops'] = 2 * 3 * b * H * D * vis / row['dq_ms'] / 1e9
            row['dkv_tflops'] = (2 * 4 * b * H * D * vis / row['dkv_ms']
                                 / 1e9)
            del inputs
        log('BWD ' + json.dumps(row))
        rows.append(row)
        del q, k, v, out, lse, do, delta, qr, kr, grads, again, ref
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r['ok']]
    assert not bad, f'the backward disagrees with its plain version: {bad}'
    main_case = next(r for r in rows if r['B'] == 8 and r['D'] == 128)
    common = dict(B=8, T=2048, S=2048, D=128,
                  plain_ms=main_case['plain_ms'],
                  plain_of='dq, dk and dv together',
                  library_ms=main_case['library_ms'],
                  library_of='dq, dk and dv together (SDPA backward)',
                  backward_ms=main_case['backward_ms'])
    dq = dict(common, max_abs_err=max(r['rel_err']['dq'] for r in rows),
              err_is='max |err| / max |ref|', ms=main_case['dq_ms'],
              bound_ms=main_case['dq_bound_ms'],
              bound_by=main_case['dq_bound_by'])
    dkv = dict(common, max_abs_err=max(max(r['rel_err']['dk'],
                                           r['rel_err']['dv'])
                                       for r in rows),
               err_is='max |err| / max |ref|', ms=main_case['dkv_ms'],
               bound_ms=main_case['dkv_bound_ms'],
               bound_by=main_case['dkv_bound_by'])
    prep = dict(B=8, T=2048, S=2048, D=128, rope=True,
                max_abs_err=max(r['prep_delta_err'] for r in rows),
                err_is='delta: max |err| / max |ref|; q_rot/k_rot '
                       'bit-equal to _rot',
                ms=main_case['prep_ms'],
                plain_ms=main_case['prep_plain_ms'],
                bound_ms=main_case['prep_bound_ms'],
                bound_by=main_case['prep_bound_by'], library_ms=None)
    return prep, dq, dkv


def _sdpa_backward_ms(torch, F, attention, q, k, v, do, angles, scale,
                      causal, iters):
    """Device ms of one backward of PyTorch's SDPA (GQA, causal, after
    an external RoPE when ``angles``) through autograd, forward excluded;
    timed only, the port never calls it."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    qr, kr = q, k
    if angles is not None:
        qr, kr = attention.apply_rope(q, angles), attention.apply_rope(
            k, angles)
    t, s = q.shape[1], k.shape[1]
    mask = None
    if causal and t != s:
        mask = (torch.arange(s, device='cuda')[None, :] <=
                torch.arange(t, device='cuda')[:, None] + (s - t))
    out = F.scaled_dot_product_attention(
        qr.transpose(1, 2), kr.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal and mask is None, scale=scale,
        enable_gqa=True)
    grad = do.transpose(1, 2)

    def backward():
        torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)
    return cuda_ms(torch, backward, [()], iters)


# ---------------------------------------------------------------------
# Train: numerics at 2 layers, then the 8B LoRA finetune itself
# ---------------------------------------------------------------------


def _train_numerics(torch):
    """llama3-8b widths at 2 layers: bf16 on the card against the same
    weights in f32 on the CPU (plain paths), LoRA rank 16 with a
    non-zero B (loss and every adapter gradient), then one full-finetune
    step (loss and grad_norm)."""
    from skypilot_torch.models import convert, llama
    from skypilot_torch.parallel import lora as lora_lib
    from skypilot_torch.parallel import train as train_lib
    config = llama.get_config('llama3-8b', n_layers=2)
    cfg_cpu = dataclasses.replace(config, dtype=torch.float32)
    gen = torch.Generator().manual_seed(17)
    tokens = torch.randint(0, config.vocab_size, (1, 257), generator=gen)
    params = llama.init_params(config, seed=2, device='cuda')
    cpu_params = convert.params_from_numpy(
        convert.params_to_numpy(params), cfg_cpu, device='cpu')
    lora = lora_lib.init_lora(config, seed=3, rank=16, dtype=torch.bfloat16,
                              device='cuda')
    for name in ('wq_b', 'wv_b'):
        lora[name] = (0.02 * torch.randn(lora[name].shape, generator=gen)
                      ).to('cuda', torch.bfloat16)

    def lora_grads(p, lo, cfg, dev):
        lo = {k: v.detach().to(dev, cfg.dtype).requires_grad_(True)
              for k, v in lo.items()}
        loss = llama.loss_fn(p, {'tokens': tokens.to(dev)}, cfg, lora=lo,
                             lora_scale=2.0)
        grads = torch.autograd.grad(loss, list(lo.values()))
        return loss.item(), {k: g.float().cpu() for k, g in zip(lo, grads)}

    t0 = time.perf_counter()
    gpu_loss, gpu_grads = lora_grads(params, lora, config, 'cuda')
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = lora_grads(cpu_params, lora, cfg_cpu, 'cpu')
    cpu_s = time.perf_counter() - t0
    rel = {k: ((gpu_grads[k] - cpu_grads[k]).abs().max() /
               cpu_grads[k].abs().max()).item() for k in cpu_grads}
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)

    # One full-finetune step from the same weights on both sides.
    step = train_lib.build_train_step(config)
    batch = {'tokens': tokens}
    _, gpu_m = step(train_lib.TrainState(
        0, params, train_lib.default_optimizer().init(params)),
        {'tokens': tokens.cuda()})
    _, cpu_m = step(train_lib.TrainState(
        0, cpu_params, train_lib.default_optimizer().init(cpu_params)),
        batch)
    ft = {k: (gpu_m[k].float().item(), cpu_m[k].float().item())
          for k in ('loss', 'grad_norm')}
    ft_rel = {k: abs(a - b) / abs(b) for k, (a, b) in ft.items()}
    row = dict(config='llama3-8b', layers=2, B=1, T=256, lora_rank=16,
               loss_gpu=gpu_loss, loss_cpu=cpu_loss, loss_rel_err=loss_rel,
               lora_grad_rel_err=rel, full_ft=ft, full_ft_rel_err=ft_rel,
               tol=TRAIN_TOL, gpu_s=gpu_s, cpu_s=cpu_s)
    log('TRAIN_NUMERICS ' + json.dumps(row))
    assert math.isfinite(gpu_loss) and all(
        math.isfinite(a) for a, _ in ft.values())
    assert loss_rel <= TRAIN_TOL['loss'], row
    assert max(rel.values()) <= TRAIN_TOL['grad'], row
    assert max(ft_rel.values()) <= TRAIN_TOL['full_ft'], row
    del params, cpu_params, lora, gpu_grads, cpu_grads


def train_phase(torch, attention):
    """The training slice: ``recipes/finetune`` at llama3-8b (32 layers,
    bf16 base + bf16 LoRA rank 16, seq 2048, batch 8, synthetic tokens),
    one warm-up step, then three steps with the kernels' launch counts
    zeroed just before and read just after. The recipe's step is
    instrumented: after them its registry must count the steps, tokens
    and intervals run, its MFU must match this script's own 4 N figure
    over the same interval, and the HBM gauges ``torch.cuda``'s readings;
    then a profile trigger armed for 2 steps must yield a summary whose
    kernel rows hold the flash kernels at twice their per-step launches."""
    import gc

    from skypilot_torch import metrics as metrics_lib
    from skypilot_torch.recipes import finetune
    from skypilot_torch.utils import profiling
    gc.collect()
    torch.cuda.empty_cache()
    _train_numerics(torch)
    gc.collect()
    torch.cuda.empty_cache()
    args = finetune.parse_args([
        '--model', 'llama3-8b', '--seq', '2048', '--batch', '8',
        '--lora-rank', '16', '--param-dtype', 'bf16', '--synthetic',
        '--device', 'cuda'])
    t0 = time.perf_counter()
    # MFU resolves the card's peak when the step is instrumented.
    os.environ['SKYTPU_ACCELERATOR'] = OBS_ACCELERATOR
    try:
        config, state, step_fn, batches, dev = finetune.build(args)
    finally:
        del os.environ['SKYTPU_ACCELERATOR']
    setup_s = time.perf_counter() - t0
    os.environ['SKYTPU_PROFILE_DIR'] = _obs_dir('train_profiles')
    reg = metrics_lib.registry()
    series = ('skytpu_train_steps_total', 'skytpu_train_tokens_total',
              'skytpu_train_step_seconds')

    def train_counts():
        children = [_family(reg, n) for n in series]
        return [0 if c is None else (c.count if n.endswith('seconds')
                                     else c.value)
                for n, c in zip(series, children)]
    counts0 = train_counts()
    calls = []       # perf_counter just before each step_fn call
    batch = {'tokens': torch.from_numpy(next(batches)).to(dev)}
    t0 = time.perf_counter()
    calls.append(t0)
    state, metrics = step_fn(state, batch)
    warm = dict(loss=float(metrics['loss']),
                grad_norm=float(metrics['grad_norm']),
                ms=1e3 * (time.perf_counter() - t0))
    kernels = {'flash_fwd': attention.FLASH_FWD,
               'flash_fwd_rope': attention.FLASH_FWD_ROPE,
               'flash_bwd_prep': attention.FLASH_BWD_PREP,
               'flash_bwd_dq': attention.FLASH_BWD_DQ,
               'flash_bwd_dkv': attention.FLASH_BWD_DKV}
    n_steps = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    steps = []
    for _ in range(n_steps):
        batch = {'tokens': torch.from_numpy(next(batches)).to(dev)}
        t0 = time.perf_counter()
        calls.append(t0)
        state, metrics = step_fn(state, batch)
        loss = float(metrics['loss'])  # waits for the step
        steps.append(dict(ms=1e3 * (time.perf_counter() - t0), loss=loss,
                          grad_norm=float(metrics['grad_norm'])))
    launches = {name: k.launches for name, k in kernels.items()}
    counts = [a - b for a, b in zip(train_counts(), counts0)]
    mfu_gauge = _family(reg, 'skytpu_mfu_ratio').value
    hbm = _hbm_check(torch)
    peak = torch.cuda.max_memory_allocated()
    tokens_per_step = args.batch * args.seq
    total_s = sum(s['ms'] for s in steps) / 1e3
    L = config.n_layers
    # Under per-layer checkpointing backward runs each layer's forward
    # (K1) again before K2 and K3.
    fwd_per_layer = 2 if config.remat else 1
    want = {'flash_fwd': 0, 'flash_fwd_rope': fwd_per_layer * L * n_steps,
            'flash_bwd_prep': L * n_steps, 'flash_bwd_dq': L * n_steps,
            'flash_bwd_dkv': L * n_steps}
    tokens_per_s = n_steps * tokens_per_step / total_s
    # The reference's MFU convention (metrics/goodput.py): 4 N FLOPs per
    # token for a LoRA step over a frozen base (6 N for a full finetune),
    # N = every parameter, against the bf16 peak.
    mfu = tokens_per_s * 4 * config.num_params() / PEAK_BF16_FLOPS
    log('TRAIN ' + json.dumps(dict(
        model=args.model, layers=L, seq=args.seq, batch=args.batch,
        lora_rank=args.lora_rank, param_dtype=args.param_dtype,
        setup_s=setup_s, warmup=warm, steps=steps,
        step_ms_mean=1e3 * total_s / n_steps, tokens_per_s=tokens_per_s,
        mfu_4n=mfu, max_memory_allocated_gb=peak / 1e9,
        launches=launches, launches_expected=want)))
    assert all(math.isfinite(s['loss']) and math.isfinite(s['grad_norm'])
               for s in steps + [warm]), steps
    assert launches == want, (launches, want)

    def one_step():
        nonlocal state
        b = {'tokens': torch.from_numpy(next(batches)).to(dev)}
        state, m = step_fn(state, b)
        float(m['loss'])
    # The instrumented step's registry: every call counted, N - 1
    # intervals observed, and the last compute interval's MFU against
    # this script's own 4 N figure over the same interval.
    n_calls = len(calls)
    mfu_own = (tokens_per_step * 4 * config.num_params() /
               ((calls[-1] - calls[-2]) * PEAK_BF16_FLOPS))
    # A capture of 2 steps (it starts at the next call and is written at
    # the third), beside none of this script's own profiles.
    t_prof = time.perf_counter()
    profiling.write_trigger(steps=2)
    for _ in range(3):
        one_step()
    summary, rows, kernel_counts = _kernel_rows('train', {
        'k1_rope_prepass': ['rope_prepass'],
        'k1_rope_mainloop': ['flash_sm90', 'fwd_kernel'],
        'bwd_prep': ['prep_kernel'], 'k2': ['dq_kernel'],
        'k3': ['dkv_kernel']})
    prof_s = time.perf_counter() - t_prof
    k1_per_step = fwd_per_layer * L
    want_prof = {'k1_rope_prepass': 2 * k1_per_step,
                 'k1_rope_mainloop': 2 * k1_per_step,
                 'bwd_prep': 2 * L, 'k2': 2 * L, 'k3': 2 * L}
    log('OBS_TRAIN ' + json.dumps(dict(
        steps_total=counts[0], tokens_total=counts[1],
        step_seconds_count=counts[2],
        expected=[n_calls, n_calls * tokens_per_step, n_calls - 1],
        mfu_ratio=mfu_gauge, mfu_own=mfu_own,
        mfu_rel_err=abs(mfu_gauge - mfu_own) / mfu_own,
        accelerator=OBS_ACCELERATOR, hbm=hbm,
        profile_steps=summary['steps'], profile_kernel_rows=len(rows),
        profile_launches=kernel_counts, profile_launches_expected=want_prof,
        profile_s=prof_s, profile_top=[dict(name=r['name'][:80],
                                            count=r['count'],
                                            ms=r['total_ms'])
                                       for r in rows[:5]])))
    assert counts == [n_calls, n_calls * tokens_per_step, n_calls - 1], \
        counts
    assert abs(mfu_gauge - mfu_own) <= OBS_MFU_REL_TOL * mfu_own, \
        (mfu_gauge, mfu_own)
    assert summary['steps'] == 2 and kernel_counts == want_prof, \
        (summary['steps'], kernel_counts, want_prof)
    del os.environ['SKYTPU_PROFILE_DIR']
    profile_cuda(torch, one_step, 'TRAIN_PROFILE',
                 dict(model=args.model, seq=args.seq, batch=args.batch))
    del state, metrics
    return dict(launches=launches)


# ---------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------


def launch_floor_ms(torch):
    """An empty kernel (``torch.cuda._sleep(0)``) timed in a CUDA graph
    as the kernels are: the least a graph node costs on this card."""
    return graph_ms(torch, lambda: torch.cuda._sleep(0), [()], 200)


def k4_errors(out, ref):
    """K4's output against its plain version: the max absolute error, and
    the max over (row, query position) of max |err| / max |ref| across
    that position's heads and dims (the last two dims)."""
    diff = (out.float() - ref).abs()
    rel = diff.amax(dim=(-2, -1)) / ref.abs().amax(dim=(-2, -1)).clamp_min(
        1e-30)
    return diff.max().item(), rel.max().item()


def graph_launches(torch, fn):
    """Kernels one call of ``fn`` launches on the card: the kernel nodes
    of the call captured alone in a CUDA graph (after a warm-up call),
    read through the driver's cuGraphGetNodes / cuGraphNodeGetType.
    Returns (kernel nodes, all nodes)."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL('libcuda.so.1')

    def check(res):
        assert res == 0, f'CUDA driver error {res}'
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    kinds = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)))
        kinds.append(kind.value)
    del graph
    return sum(k == 0 for k in kinds), len(kinds)   # 0: a kernel node


def k4_one_launch(torch, tag, fn):
    """One K4 call is one kernel and nothing else on the card."""
    kernels, nodes = graph_launches(torch, fn)
    assert kernels == nodes == 1, (
        f'{tag}: one call captured {kernels} kernel nodes of {nodes}')
    return kernels


def k4_graph_check(torch, tag, calls):
    """K4 inside a captured step: ``calls`` (zero-argument functions, one
    per layer and form) made eagerly, then captured in one CUDA graph
    and replayed twice, with an eager call of the first between the
    replays (it shares the merge counters). Every replayed output must
    be bit-equal to the eager one."""
    eager = [f() for f in calls]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    checks = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        checks.append(all(torch.equal(a, b) for a, b in zip(outs, eager)))
        between = calls[0]()
        torch.cuda.synchronize()
        checks.append(torch.equal(between, eager[0]))
    del graph
    row = dict(calls=len(calls), replays=2, bit_equal=all(checks))
    log(f'K4_GRAPH {tag} ' + json.dumps(row))
    assert row['bit_equal'], f'{tag}: K4 replayed in a graph differs'
    return row


def _k4_case(torch, F, da, gen, tag, b, w, hq, hkv, hd, lens, s, q8=False,
             paged=False):
    """One K4 case at given shapes (random inputs from ``gen``): the
    kernel against its plain version in f32 (``K4_TOL``), and kernel,
    plain, library and bound times with the bound share. Dense takes W 1;
    paged reads a shuffled pool of 16-row pages through the block table
    (lengths leave room for the W positions)."""
    from skypilot_torch.serve import kv_pool
    scale = hd ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16)
    if paged:
        mb = -(-s // BLOCK)
        s = mb * BLOCK
        n_pages = b * mb + 1
        k, v = randn(n_pages * BLOCK, hkv, hd), randn(n_pages * BLOCK, hkv,
                                                      hd)
        ids = torch.randperm(n_pages - 1, generator=gen,
                             device='cuda')[:b * mb] + 1
        tables = ids.reshape(b, mb).to(torch.int32).contiguous()
        lens = [min(n, s - w + 1) for n in lens]
        q = randn(b, w, hq, hd)
    else:
        k, v = randn(b, s, hkv, hd), randn(b, s, hkv, hd)
        q = randn(b, hq, hd)
    ks = vs = None
    if q8:
        k, ks = _q8(k[None] if paged else k)
        v, vs = _q8(v[None] if paged else v)
        if paged:
            k, ks, v, vs = k[0], ks[0], v[0], vs[0]
    lengths = torch.tensor(lens, dtype=torch.int32, device='cuda')
    if paged:
        def kernel():
            return da.paged_verify_attention(q, k, v, tables, lengths, scale,
                                             BLOCK, ks, vs)

        def plain(q=q):
            return da._reference_paged_verify_attention(
                q, k, v, tables, lengths, scale, BLOCK, ks, vs)
        spans = [min(max(n + w - 1, 1), s) for n in lens]
        span_mask = (torch.arange(s, device='cuda')[None, None, :] <
                     (lengths[:, None] + torch.arange(
                         w, device='cuda')[None, :])[:, :, None])

        def library():
            gidx = kv_pool.read_indices(tables, BLOCK)
            kd, vd = da.paged_gather(k, gidx), da.paged_gather(v, gidx)
            if q8:
                kd = da.dequant_kv(kd, da.paged_gather(ks, gidx),
                                   torch.bfloat16)
                vd = da.dequant_kv(vd, da.paged_gather(vs, gidx),
                                   torch.bfloat16)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
                attn_mask=span_mask[:, None], scale=scale, enable_gqa=True)
        extra_bytes = 4 * (b + b * mb)
    else:
        def kernel():
            return da.decode_attention(q, k, v, lengths, scale, ks, vs)

        def plain(q=q):
            return da._reference_decode_attention(q, k, v, lengths, scale,
                                                  ks, vs)
        spans = [max(n, 1) for n in lens]
        mask = (torch.arange(s, device='cuda')[None, :] <
                lengths.clamp(min=1)[:, None])[:, None, None, :]

        def library():
            kd = da.dequant_kv(k, ks, torch.bfloat16)
            vd = da.dequant_kv(v, vs, torch.bfloat16)
            return F.scaled_dot_product_attention(
                q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
                attn_mask=mask, scale=scale, enable_gqa=True)
        extra_bytes = 4 * b
    out = kernel()
    torch.cuda.synchronize()
    if q8:          # codes times scales in f32
        ref = plain(q.float())
    elif paged:
        ref = da._reference_paged_verify_attention(
            q.float(), k.float(), v.float(), tables, lengths, scale, BLOCK)
    else:
        ref = da._reference_decode_attention(q.float(), k.float(),
                                             v.float(), lengths, scale)
    err, rel = k4_errors(out, ref)
    key_bytes = (2 * hd + 4) if q8 else 4 * hd
    nbytes = sum(spans) * hkv * key_bytes + 4 * q.numel() + extra_bytes
    row = dict(case=tag, B=b, W=w, Hq=hq, Hkv=hkv, hd=hd, S=s,
               lengths=lens, int8=q8, paged=paged, max_abs_err=err,
               tol=K4_TOL, max_rel_err=rel, rel_tol=K4_REL_TOL,
               ok=err <= K4_TOL and rel <= K4_REL_TOL and bool(
                   torch.isfinite(out.float()).all()),
               kernel_ms=graph_ms(torch, kernel, [()], 100),
               plain_ms=graph_ms(torch, plain, [()], 10),
               library_ms=graph_ms(torch, library, [()], 20),
               bound_ms=1e3 * nbytes / PEAK_HBM_BYTES, bound_by='bytes')
    row['bound_share'] = row['bound_ms'] / row['kernel_ms']
    log(('K4P' if paged else 'K4') + ('Q8 ' if q8 else ' ') +
        json.dumps(row))
    return row


def k4_phase(torch, F, da):
    HQ, HKV, HD, S = 32, 8, 128, 8192
    scale = HD ** -0.5
    # The serve path's decode (batch 1, max_seq 8192, a 2k context) and
    # a batch of 8 mixed lengths.
    cases = [[2048], [1, 511, 512, 4097, 8192, 2049, 100, 7000]]
    gen = torch.Generator(device='cuda').manual_seed(12)
    rows = []
    for lens in cases:
        b = len(lens)

        def make(b=b):
            return (torch.randn((b, HQ, HD), generator=gen, device='cuda',
                                dtype=torch.bfloat16),
                    torch.randn((b, S, HKV, HD), generator=gen,
                                device='cuda', dtype=torch.bfloat16),
                    torch.randn((b, S, HKV, HD), generator=gen,
                                device='cuda', dtype=torch.bfloat16))
        lengths = torch.tensor(lens, dtype=torch.int32, device='cuda')
        q, k, v = make()
        out = da.decode_attention(q, k, v, lengths, scale)
        torch.cuda.synchronize()
        ref = da._reference_decode_attention(q.float(), k.float(),
                                             v.float(), lengths, scale)
        err, rel = k4_errors(out, ref)
        ok = (err <= K4_TOL and rel <= K4_REL_TOL
              and bool(torch.isfinite(out.float()).all()))
        nbytes = (sum(2 * max(n, 1) * HKV * HD * 2 for n in lens)
                  + 2 * 2 * q.numel() + 4 * b)
        bound_ms = 1e3 * nbytes / PEAK_HBM_BYTES
        inputs = copies_outside_l2(make, nbytes, (q, k, v))
        mask = (torch.arange(S, device='cuda')[None, :] <
                lengths.clamp(min=1)[:, None])[:, None, None, :]

        def kernel(q, k, v):
            return da.decode_attention(q, k, v, lengths, scale)

        def plain(q, k, v):
            return da._reference_decode_attention(q, k, v, lengths, scale)

        def library(q, k, v):
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, scale=scale, enable_gqa=True)

        kernel_ms = graph_ms(torch, kernel, inputs, 200)
        row = dict(B=b, S=S, lengths=lens, max_abs_err=err, tol=K4_TOL,
                   max_rel_err=rel, rel_tol=K4_REL_TOL, ok=ok,
                   kernel_ms=kernel_ms,
                   plain_ms=graph_ms(torch, plain, inputs, 20),
                   library_ms=graph_ms(torch, library, inputs, 50),
                   bound_ms=bound_ms, bound_share=bound_ms / kernel_ms,
                   gbps=nbytes / kernel_ms / 1e6,
                   kernel_wall_ms=cuda_ms(torch, kernel, inputs, 200),
                   device_launches_per_call=k4_one_launch(
                       torch, f'K4 B{b}', lambda: kernel(q, k, v)))
        log('K4 ' + json.dumps(row))
        rows.append(row)
        del q, k, v, out, ref, inputs
        torch.cuda.empty_cache()
    floor = launch_floor_ms(torch)
    log('LAUNCH_FLOOR ' + json.dumps(dict(
        kernel='torch.cuda._sleep(0) in a CUDA graph', ms=floor,
        k4_dense_b1_ms=rows[0]['kernel_ms'],
        k4_over_floor=rows[0]['kernel_ms'] / floor)))
    # head_dim 64 at groups 1 and 8 (the other instantiations' shapes).
    rows += [_k4_case(torch, F, da, gen, f'hd64 G{g} B1', 1, 1, 32,
                      32 // g, 64, [2048], S) for g in (1, 8)]
    bad = [r for r in rows if not r['ok']]
    assert not bad, f'K4 disagrees with its plain version: {bad}'
    main_case = rows[0]
    return dict(max_abs_err=max(r['max_abs_err'] for r in rows),
                max_rel_err=max(r['max_rel_err'] for r in rows),
                ms=main_case['kernel_ms'], plain_ms=main_case['plain_ms'],
                bound_ms=main_case['bound_ms'], bound_by='bytes',
                library_ms=main_case['library_ms'],
                bound_share=main_case['bound_share'],
                device_launches_per_call=main_case[
                    'device_launches_per_call'],
                launch_floor_ms=floor)


# ---------------------------------------------------------------------
# End-to-end numerics
# ---------------------------------------------------------------------


def e2e_phase(torch):
    from skypilot_torch.models import convert, decode, llama
    config = llama.get_config('llama3-8b', n_layers=2)
    cfg_cpu = dataclasses.replace(config, dtype=torch.float32)
    params = llama.init_params(config, seed=1, device='cuda')
    cpu_params = convert.params_from_numpy(
        convert.params_to_numpy(params), cfg_cpu, device='cpu')
    gen = torch.Generator().manual_seed(13)
    prompt = torch.randint(0, config.vocab_size, (1, 256), generator=gen)
    n_new, max_seq = 9, 512  # the prefill's token + 8 greedy steps

    def first_logits(p, cfg, dev):
        with torch.inference_mode():
            cache = decode.init_cache(cfg, 1, max_seq, device=dev)
            logits, _ = decode.forward_cached(p, prompt.to(dev), cache,
                                              cfg, last_only=True,
                                              prefill=True)
        return logits[0, -1].float().cpu()

    from skypilot_torch.ops import decode_attention as da
    t0 = time.perf_counter()
    lg = first_logits(params, config, 'cuda')
    da.ROPE_CACHE_WRITE.launches = da.CACHE_WRITE.launches = 0
    toks_gpu = decode.greedy_generate(params, prompt.cuda(), config, n_new,
                                      max_seq=max_seq)[0].tolist()
    k5f_launches = da.ROPE_CACHE_WRITE.launches
    k5_launches = da.CACHE_WRITE.launches
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lc = first_logits(cpu_params, cfg_cpu, 'cpu')
    toks_cpu = decode.greedy_generate(cpu_params, prompt, cfg_cpu, n_new,
                                      max_seq=max_seq)[0].tolist()
    cpu_s = time.perf_counter() - t0
    err = (lg - lc).abs().max().item()
    rel = err / lc.abs().max().item()
    agree = sum(a == b for a, b in zip(toks_gpu, toks_cpu))
    row = dict(config='llama3-8b', layers=2, prompt=256, max_abs_err=err,
               rel_err=rel, rel_tol=E2E_REL_TOL,
               mean_abs_err=(lg - lc).abs().mean().item(),
               greedy_agree=f'{agree}/{n_new}', gpu_tokens=toks_gpu,
               cpu_tokens=toks_cpu, gpu_s=gpu_s, cpu_s=cpu_s,
               k5f_launches=k5f_launches,
               k5f_expected=config.n_layers * n_new, k5_launches=k5_launches)
    log('E2E ' + json.dumps(row))
    assert bool(torch.isfinite(lg).all()) and lg.shape == lc.shape
    assert rel <= E2E_REL_TOL, f'end-to-end logits disagree: {row}'
    # The prompt and each greedy step write their rows through K5F.
    assert k5f_launches == config.n_layers * n_new and not k5_launches, row
    del params, cpu_params
    torch.cuda.empty_cache()
    return k5f_launches


# ---------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------


def _post(port, body, timeout=600):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/generate', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'}, method='POST')
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        status, raw = resp.status, resp.read().decode()
        ctype = resp.headers.get('Content-Type', '')
    ms = 1e3 * (time.perf_counter() - t0)
    if ctype.startswith('text/event-stream'):
        events = [ln[len('data: '):] for ln in raw.split('\n\n') if ln]
        assert events[-1] == '[DONE]', raw[-200:]
        ids = [int(e) for e in events[:-1]]
    else:
        ids = json.loads(raw)['output_ids']
    return status, ids, ms


def serve_phase(torch, attention, da):
    from skypilot_torch.models import llama
    from skypilot_torch.recipes import serve_model
    args = serve_model.parse_args(['--model', 'llama3-8b', '--port', '0',
                                   '--device', 'cuda'])
    config = llama.get_config(args.model)
    t0 = time.perf_counter()
    server, generate = serve_model.build_server(args)
    setup_s = time.perf_counter() - t0
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for _ in range(100):
            try:
                with urllib.request.urlopen(f'http://127.0.0.1:{port}/',
                                            timeout=5) as r:
                    ready = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.1)
        else:
            raise RuntimeError('replica never became ready')
        assert ready == {'status': 'ok', 'model': 'llama3-8b'}, ready
        gen = torch.Generator().manual_seed(14)
        max_new = 32
        reqs = []
        for i, n in enumerate((17, 256, 1000, 2048)):
            ids = torch.randint(0, config.vocab_size, (n,),
                                generator=gen).tolist()
            reqs.append({'prompt_ids': ids, 'max_new_tokens': max_new,
                         'stream': i == 2})
        torch.cuda.synchronize()
        for kern in (attention.FLASH_FWD, da.DECODE_ATTENTION,
                     da.ROPE_CACHE_WRITE, da.CACHE_WRITE):
            kern.launches = 0
        results = [_post(port, r) for r in reqs]
        k1_launches = attention.FLASH_FWD.launches
        k4_launches = da.DECODE_ATTENTION.launches
        k5f_launches = da.ROPE_CACHE_WRITE.launches
        k5_launches = da.CACHE_WRITE.launches
        for (status, ids, _), r in zip(results, reqs):
            assert status == 200, status
            assert len(ids) == max_new, (len(ids), max_new)
            assert all(0 <= t < config.vocab_size for t in ids), ids
        # Every prefill layer through K1, every decode layer through K4
        # (the bucket of 32 is one prefill token + 31 decode steps), and
        # every layer of both writes its rows through K5F.
        want_k1 = config.n_layers * len(reqs)
        want_k4 = config.n_layers * len(reqs) * (max_new - 1)
        want_k5f = config.n_layers * len(reqs) * max_new
        log('SERVE ' + json.dumps(dict(
            k1_launches=k1_launches, k1_expected=want_k1,
            k4_launches=k4_launches, k4_expected=want_k4,
            k5f_launches=k5f_launches, k5f_expected=want_k5f,
            k5_launches=k5_launches, setup_s=setup_s)))
        assert k1_launches == want_k1, (k1_launches, want_k1)
        assert k4_launches == want_k4, (k4_launches, want_k4)
        assert k5f_launches == want_k5f and k5_launches == 0, (
            k5f_launches, want_k5f, k5_launches)
        # TTFT: the same replica's generate() at max_new_tokens=1 (one
        # prefill and its argmax) on the same prompts, after the counted
        # run; per-token time is the rest of the request's latency.
        weight_bytes = 2 * (config.num_params() -
                            config.vocab_size * config.dim)
        for (status, ids, ms), r in zip(results, reqs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(r['prompt_ids'], 1)
            ttft_ms = 1e3 * (time.perf_counter() - t0)
            per_tok = (ms - ttft_ms) / (max_new - 1)
            log('REQ ' + json.dumps(dict(
                prompt=len(r['prompt_ids']), stream=r['stream'],
                n_out=len(ids), latency_ms=ms, ttft_ms=ttft_ms,
                per_token_ms=per_tok,
                decode_weight_gbps=weight_bytes / per_tok / 1e6)))
        prompt_ids = reqs[0]['prompt_ids']
        profile_cuda(torch, lambda: generate(prompt_ids, max_new),
                     'PROFILE', dict(prompt=len(prompt_ids),
                                     max_new=max_new))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return k1_launches, k4_launches, k5f_launches


# ---------------------------------------------------------------------
# K5: the per-row cache write
# ---------------------------------------------------------------------

# llama3-8b's KV row: 8 KV heads x head_dim 128.
HKV8, HD8 = 8, 128
# The engine's pool at 8 slots, max_seq 8192 and 16-token blocks.
POOL_BLOCKS, BLOCK = 8 * 8192 // 16 + 1, 16


def _k5_case(torch, da, label, k, v, k_new, v_new, dst, iters):
    """One K5 case: kernel vs ``_reference_cache_write`` on clones
    (bit-exact), then kernel, plain and library (``index_copy_``)
    times and the byte bound (each new row read once and written once,
    for K and V, plus the indices)."""
    n = int((dst >= 0).sum())
    kk, vk = k.clone(), v.clone()
    kr, vr = k.clone(), v.clone()
    before = da.CACHE_WRITE.launches
    da.cache_write(kk, vk, k_new, v_new, dst)
    torch.cuda.synchronize()
    assert da.CACHE_WRITE.launches == before + 1
    da._reference_cache_write(kr, vr, k_new, v_new, dst)
    exact = torch.equal(kk, kr) and torch.equal(vk, vr)
    nbytes = 2 * 2 * n * k[0].numel() * k.element_size() + 4 * dst.numel()
    keep = dst >= 0              # index_copy_ takes only rows it writes
    idx, k_lib, v_lib = dst[keep].long(), k_new[keep], v_new[keep]

    def kernel():
        da.cache_write(kk, vk, k_new, v_new, dst)

    def plain():
        da._reference_cache_write(kr, vr, k_new, v_new, dst)

    def library():
        kr.index_copy_(0, idx, k_lib)
        vr.index_copy_(0, idx, v_lib)

    row = dict(case=label, rows=dst.numel(), rows_written=n,
               view=list(k.shape), bit_exact=exact,
               kernel_ms=graph_ms(torch, lambda: kernel(), [()], iters),
               plain_ms=cuda_ms(torch, plain, [()], iters),
               library_ms=graph_ms(torch, lambda: library(), [()], iters),
               bound_ms=1e3 * nbytes / PEAK_HBM_BYTES, bound_by='bytes')
    log('K5 ' + json.dumps(row))
    assert exact, f'K5 is not bit-exact against index_copy_: {row}'
    return row


def k5_phase(torch, da):
    """K5 against its plain version, bit-exact, at llama3-8b shapes:
    the rows form over a [8, 8192, 8, 128] cache (one position per
    row, one parked past S), and the flat 4097-block pool with a
    scattered dst of decode (8 rows), verify (72) and prefill-chunk
    (512) sizes."""
    gen = torch.Generator(device='cuda').manual_seed(21)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16)
    b, s = 8, 8192
    k, v = randn(b * s, HKV8, HD8), randn(b * s, HKV8, HD8)
    pos = torch.tensor([0, 17, 511, 2047, 4096, 6000, 8191, 8192],
                       dtype=torch.int32, device='cuda')
    rows = [_k5_case(torch, da, 'rows', k, v, randn(b, HKV8, HD8),
                     randn(b, HKV8, HD8), da.rows_dst(pos, s), 200)]
    del k, v
    n_rows = POOL_BLOCKS * BLOCK
    k, v = randn(n_rows, HKV8, HD8), randn(n_rows, HKV8, HD8)
    for r in (8, 72, 512):
        dst = torch.randperm(n_rows - BLOCK, generator=gen,
                             device='cuda')[:r].to(torch.int32) + BLOCK
        rows.append(_k5_case(torch, da, f'pool R={r}', k, v,
                             randn(r, HKV8, HD8), randn(r, HKV8, HD8),
                             dst, 200))
    del k, v
    torch.cuda.empty_cache()
    main_case = rows[1]          # the engine's decode step: 8 rows
    return dict(max_abs_err=0.0, err_is='bit-exact (torch.equal)',
                case=main_case['case'], ms=main_case['kernel_ms'],
                plain_ms=main_case['plain_ms'],
                bound_ms=main_case['bound_ms'], bound_by='bytes',
                library_ms=main_case['library_ms'],
                library='index_copy_ on K and V',
                cases={r['case']: {key: r[key] for key in (
                    'kernel_ms', 'plain_ms', 'library_ms', 'bound_ms')}
                    for r in rows})


# ---------------------------------------------------------------------
# K5F: the fused RoPE + int8 + cache write of the decode and verify steps
# ---------------------------------------------------------------------


def _replaced_chain(torch, da, q, k, v, angles, kp, vp, dst, ks=None,
                    vs=None):
    """The eager chain K5F replaced in the device steps, as they ran it:
    RoPE of q and of k with cos and sin made from the angles each time,
    the int8 quantization of k and v, then K5. Returns rotated q."""
    def rope(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        cos = torch.cos(angles)[:, None, :]
        sin = torch.sin(angles)[:, None, :]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                         dim=-1).to(x.dtype)
    qr, kr = rope(q), rope(k)
    if ks is None:
        da.cache_write(kp, vp, kr, v, dst)
    else:
        kq, kss = da.quantize_kv(kr)
        vq, vss = da.quantize_kv(v)
        da.cache_write(kp, vp, kq, vq, dst, ks, vs, kss, vss)
    return qr


def _k5f_case(torch, da, gen, q8, r, iters):
    """One K5F case: R rows at llama3-8b widths into the 4097-block pool
    (scattered rows, one dst of -1 and one past the pool), cos and sin a
    table of P = min(R, 1024) positions that row r reads at r mod P (at R
    8192 the serve_8b prompt's 8 x 1024), the kernel against its plain
    version and against the chain it replaced, all bit-exact, and with
    ``k_out`` the rotated k of every row (the dropped ones too) bit-equal
    to the plain rotation; then kernel (graph and eager, and with
    ``k_out``), plain, replaced-chain and bound times, and the kernels
    one call launches."""
    from skypilot_torch.models import llama
    config = llama.get_config('llama3-8b')
    n_rows = POOL_BLOCKS * BLOCK
    hq = config.n_heads
    period = min(r, 1024)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16)
    q, k, v = randn(r, hq, HD8), randn(r, HKV8, HD8), randn(r, HKV8, HD8)
    positions = torch.randint(0, 8192, (period,), generator=gen,
                              device='cuda', dtype=torch.int32)
    angles = llama._rope_frequencies(config, positions)
    cos, sin = torch.cos(angles), torch.sin(angles)
    row_angles = angles.repeat(r // period, 1)
    dst = torch.randperm(n_rows - BLOCK, generator=gen,
                         device='cuda')[:r].to(torch.int32) + BLOCK
    if r > 2:
        dst[1], dst[2] = -1, n_rows
    if q8:
        pools = [torch.randint(-127, 128, (n_rows, HKV8, HD8), generator=gen,
                               device='cuda', dtype=torch.int8)
                 for _ in range(2)]
        pools += [randn(n_rows, HKV8).abs() for _ in range(2)]
    else:
        pools = [randn(n_rows, HKV8, HD8) for _ in range(2)] + [None, None]
    copies = [[None if x is None else x.clone() for x in pools]
              for _ in range(3)]
    k_out = torch.empty_like(k)
    kernel_q = da.rope_cache_write(q, k, v, cos, sin, pools[0], pools[1],
                                   dst, pools[2], pools[3])
    plain_q = da._reference_rope_cache_write(
        q, k, v, cos, sin, copies[0][0], copies[0][1], dst, copies[0][2],
        copies[0][3])
    chain_q = _replaced_chain(torch, da, q, k, v, row_angles, copies[1][0],
                              copies[1][1], dst, copies[1][2], copies[1][3])
    k_out_q = da.rope_cache_write(q, k, v, cos, sin, copies[2][0],
                                  copies[2][1], dst, copies[2][2],
                                  copies[2][3], k_out=k_out)
    torch.cuda.synchronize()
    k_rot = da.rope_plain(k, torch.cos(row_angles), torch.sin(row_angles))

    def same(a, b):
        return all(x is None or torch.equal(x, y) for x, y in zip(a, b))
    exact = torch.equal(kernel_q, plain_q) and same(pools, copies[0])
    exact_chain = torch.equal(kernel_q, chain_q) and same(pools, copies[1])
    exact_k_out = (torch.equal(k_out, k_rot) and torch.equal(k_out_q, plain_q)
                   and same(copies[2], copies[0]))
    n = int(((dst >= 0) & (dst < n_rows)).sum())
    row_bytes = 2 * HKV8 * (HD8 + 2) if q8 else 2 * HKV8 * HD8 * 2
    nbytes = (r * (hq + 2 * HKV8) * HD8 * 2 + period * HD8 * 4 + 4 * r +
              r * hq * HD8 * 2 + n * row_bytes)
    k_out_bytes = r * HKV8 * HD8 * 2

    def kernel():
        return da.rope_cache_write(q, k, v, cos, sin, pools[0], pools[1],
                                   dst, pools[2], pools[3])

    def kernel_k_out():
        return da.rope_cache_write(q, k, v, cos, sin, pools[0], pools[1],
                                   dst, pools[2], pools[3], k_out=k_out)

    def plain():
        return da._reference_rope_cache_write(
            q, k, v, cos, sin, copies[0][0], copies[0][1], dst,
            copies[0][2], copies[0][3])

    def chain():
        return _replaced_chain(torch, da, q, k, v, row_angles, copies[1][0],
                               copies[1][1], dst, copies[1][2], copies[1][3])
    chain_launches, _ = graph_launches(torch, chain)
    kernel_launches, _ = graph_launches(torch, kernel)
    row = dict(case=f'{"int8" if q8 else "bf16"} R={r}', rows=r,
               table_rows=period, rows_written=n, bit_exact=exact,
               bit_exact_to_replaced_chain=exact_chain,
               k_out_bit_exact=exact_k_out,
               kernel_ms=graph_ms(torch, kernel, [()], iters),
               kernel_eager_ms=cuda_ms(torch, kernel, [()], iters),
               kernel_k_out_ms=graph_ms(torch, kernel_k_out, [()], iters),
               plain_ms=cuda_ms(torch, plain, [()], iters),
               replaced_chain_ms=cuda_ms(torch, chain, [()], iters),
               replaced_chain_graph_ms=graph_ms(torch, chain, [()], iters),
               launches_per_call=kernel_launches,
               replaced_chain_launches_per_call=chain_launches,
               bound_ms=1e3 * nbytes / PEAK_HBM_BYTES,
               bound_k_out_ms=1e3 * (nbytes + k_out_bytes) / PEAK_HBM_BYTES,
               bound_by='bytes')
    row['bound_share'] = row['bound_ms'] / row['kernel_ms']
    row['bound_share_k_out'] = row['bound_k_out_ms'] / row['kernel_k_out_ms']
    log('K5F ' + json.dumps(row))
    assert exact and exact_chain and exact_k_out, f'K5F not bit-exact: {row}'
    assert kernel_launches == 1, row
    return row


def _k5f_paths(torch, da):
    """Every serving path that writes through K5F against the same path
    with ``rope_cache_write`` swapped for its plain version (the eager
    chain those paths ran before K5F), on the card, bit for bit:
    llama3-8b at full width and 2 layers, random weights, bf16 and int8
    (weights and KV).

    Engine: three 512-row prefill chunks over a 161-block pool (16-row
    blocks): request A's positions 0-511, then request B, whose table
    shares A's first 32 blocks (a prefix hit), from offset 512 and from
    1024 (real 500: 12 padded rows to the scratch block, which they race
    for and which is left out). Pools (codes and scales), each chunk's
    logits and each layer's attention output.
    Engine-off: the serve_8b prompt's shape (8 x 1024, ``prefill``) and
    four greedy decode steps through ``forward_cached``: the cache (codes
    and scales) and every logit. Each K5F run counts L rope_cache_write
    launches a forward and no cache_write."""
    from skypilot_torch.models import decode, llama, quant
    config = llama.get_config('llama3-8b', n_layers=2)
    dev = 'cuda'
    L, hkv, hd = config.n_layers, config.n_kv_heads, config.head_dim
    gen = torch.Generator().manual_seed(36)
    nb = 161
    tables = [torch.cat([torch.arange(1, 33), torch.arange(97, 161)]),
              torch.arange(1, 97)]
    tables = [t.to(torch.int32).to(dev) for t in tables]
    prompt = torch.randint(0, config.vocab_size, (1536,), generator=gen)
    chunks = [(0, 0, 512), (1, 512, 512), (1, 1024, 500)]
    off_prompt = torch.randint(0, config.vocab_size, (8, 1024),
                               generator=gen).to(dev)
    real_write, real_attn = da.rope_cache_write, da.prefill_attention
    kernels = {'rope_cache_write': da.ROPE_CACHE_WRITE,
               'rope_cache_write_q8': da.ROPE_CACHE_WRITE_Q8,
               'cache_write': da.CACHE_WRITE,
               'cache_write_q8': da.CACHE_WRITE_Q8}
    out = {}
    for form in ('bf16', 'int8'):
        int8 = form == 'int8'
        params = (quant.init_quantized(config, seed=3, device=dev)
                  if int8 else llama.init_params(config, seed=3,
                                                 device=dev))
        runs = {}
        for route in ('kernel', 'plain'):
            attn = []

            def recording(*a, **kw):
                o = real_attn(*a, **kw)
                attn.append(o.clone())
                return o
            da.prefill_attention = recording
            if route == 'plain':
                da.rope_cache_write = da._reference_rope_cache_write
            for kern in kernels.values():
                kern.launches = 0
            try:
                shape = (L, nb, BLOCK, hkv, hd)
                pools = tuple(torch.zeros(shape, dtype=torch.int8 if int8
                                          else config.dtype, device=dev)
                              for _ in range(2))
                pools += ((torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=dev),
                           torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=dev)) if int8
                          else (None, None))
                logits = []
                with torch.inference_mode():
                    for req, start, real in chunks:
                        toks = torch.zeros(512, dtype=torch.long)
                        toks[:real] = prompt[start:start + real]
                        lg, _ = decode.forward_paged(
                            params, toks[None].to(dev), pools, tables[req],
                            start, real, config, BLOCK)
                        logits.append(lg)
                    chunk_launches = {n: k.launches
                                      for n, k in kernels.items()}
                    cache = decode.init_cache(config, 8, 1040,
                                              device=dev, kv_int8=int8)
                    lg, _ = decode.forward_cached(
                        params, off_prompt, cache, config, last_only=True,
                        prefill=True)
                    off_logits = [lg]
                    for _ in range(4):
                        tok = lg[:, -1].argmax(-1)[:, None]
                        lg, _ = decode.forward_cached(params, tok, cache,
                                                      config)
                        off_logits.append(lg)
                torch.cuda.synchronize()
                # Block 0 is the scratch the padded rows race for.
                runs[route] = dict(
                    pools=[x[:, 1:] for x in pools if x is not None],
                    logits=logits, attn=attn,
                    cache=[x for x in (cache.k, cache.v, cache.k_scale,
                                       cache.v_scale) if x is not None],
                    off_logits=off_logits,
                    chunk_launches=chunk_launches,
                    off_launches={n: k.launches - chunk_launches[n]
                                  for n, k in kernels.items()})
            finally:
                da.rope_cache_write, da.prefill_attention = (real_write,
                                                             real_attn)

        def differing(name):
            return sum(int((a != b).sum()) for a, b in zip(
                runs['kernel'][name], runs['plain'][name]))
        q = '_q8' if int8 else ''
        want_chunks = {n: 0 for n in kernels}
        want_chunks['rope_cache_write' + q] = L * len(chunks)
        want_off = {n: 0 for n in kernels}
        want_off['rope_cache_write' + q] = L * 5
        row = dict(form=form, layers=L, chunks=[list(c[1:]) for c in chunks],
                   engine_off=dict(batch=8, prompt=1024, decode_steps=4),
                   **{f'{name}_differing': differing(name) for name in (
                       'pools', 'logits', 'attn', 'cache', 'off_logits')},
                   attn_outputs=len(runs['kernel']['attn']),
                   chunk_launches=runs['kernel']['chunk_launches'],
                   chunk_launches_expected=want_chunks,
                   engine_off_launches=runs['kernel']['off_launches'],
                   engine_off_launches_expected=want_off)
        log('K5F_PATHS ' + json.dumps(row))
        assert row['attn_outputs'] == L * len(chunks), row
        assert not any(row[f'{name}_differing'] for name in (
            'pools', 'logits', 'attn', 'cache', 'off_logits')), row
        assert row['chunk_launches'] == want_chunks, row
        assert row['engine_off_launches'] == want_off, row
        out[form] = row
        del params, runs
        torch.cuda.empty_cache()
    return out


K5F_ROWS = (8, 72, 512, 8192)


def k5f_phase(torch, da):
    """K5F against its plain version and against the eager chain it
    replaced, bit-exact, bf16 and int8, at R = 8 (a decode step), 72 (a
    verify window), 512 (a prefill chunk) and 8192 rows (the serve_8b
    prompt's 8 x 1024) over the engine's 4097-block pool with scattered
    and out-of-range rows, with and without ``k_out``; times and the
    launches a layer. Then the serving paths through K5F bit-equal to
    the same paths on its plain version (``_k5f_paths``)."""
    gen = torch.Generator(device='cuda').manual_seed(31)
    rows = [_k5f_case(torch, da, gen, q8, r, 200 if r < 8192 else 50)
            for q8 in (False, True) for r in K5F_ROWS]
    torch.cuda.empty_cache()
    paths = _k5f_paths(torch, da)

    def pick(q8):
        form = 'int8' if q8 else 'bf16'
        # The engine's decode step: 8 rows.
        main = next(r for r in rows if r['case'] == f'{form} R=8')
        return dict(max_abs_err=0.0, err_is='bit-exact (torch.equal) to '
                    'the plain chain and to the replaced eager chain',
                    case=main['case'], ms=main['kernel_ms'],
                    plain_ms=main['plain_ms'], bound_ms=main['bound_ms'],
                    bound_by='bytes', library_ms=main['replaced_chain_ms'],
                    library='the eager chain K5F replaced (RoPE of q and k, '
                    'the int8 quantization, K5), eager as the steps ran it',
                    kernels_per_layer=main['launches_per_call'],
                    replaced_kernels_per_layer=main[
                        'replaced_chain_launches_per_call'],
                    cases={r['case']: {key: r[key] for key in (
                        'kernel_ms', 'kernel_eager_ms', 'kernel_k_out_ms',
                        'plain_ms', 'replaced_chain_ms',
                        'replaced_chain_graph_ms', 'bound_ms',
                        'bound_k_out_ms')} for r in rows
                        if r['case'].startswith(form)},
                    paths_bit_equal=paths[form])
    return dict(bf16=pick(False), int8=pick(True))


# ---------------------------------------------------------------------
# The serving kernels' launch identities
# ---------------------------------------------------------------------


def _serving_kernels(attention, da):
    """Every launch count of the engine's device path, by name; the int8
    forms under ``*_q8``."""
    from skypilot_torch.ops import matmul_invariant as mi
    from skypilot_torch.ops import rms_norm as rn
    from skypilot_torch.ops import top_p as tp
    return {'flash_fwd': attention.FLASH_FWD,
            'decode_attention': da.DECODE_ATTENTION,
            'decode_attention_q8': da.DECODE_ATTENTION_Q8,
            'prefill_attention': da.PREFILL_ATTENTION,
            'prefill_attention_q8': da.PREFILL_ATTENTION_Q8,
            'paged_w1': da.PAGED_DECODE_ATTENTION,
            'paged_verify': da.PAGED_VERIFY_ATTENTION,
            'paged_w1_q8': da.PAGED_DECODE_ATTENTION_Q8,
            'paged_verify_q8': da.PAGED_VERIFY_ATTENTION_Q8,
            'cache_write': da.CACHE_WRITE,
            'cache_write_q8': da.CACHE_WRITE_Q8,
            'rope_cache_write': da.ROPE_CACHE_WRITE,
            'rope_cache_write_q8': da.ROPE_CACHE_WRITE_Q8,
            'matmul': mi.MATMUL, 'matmul_q8': mi.MATMUL_Q8,
            'rms_norm': rn.RMS_NORM, 'add_rms_norm': rn.ADD_RMS_NORM,
            'lora_mid': mi.LORA_MID,
            'lora_delta': mi.LORA_DELTA,
            'top_p_kth': tp.TOP_P_KTH}


def _dispatch_record(events):
    """(decode steps, verify dispatches, prefill chunks) of a run's
    ``engine.events``."""
    steps = sum(e[2] for e in events if e[0] == 'decode' and len(e) == 3)
    n_verify = sum(e[0] == 'verify' for e in events)
    n_chunks = sum(e[0] == 'prefill_chunk' for e in events)
    return steps, n_verify, n_chunks


def _serving_identity(kernels, n_layers, events, q8=False, lora=False):
    """The launch counts a run's dispatch record fixes, with ``L``
    layers: a layer of each decode step and verify dispatch launches one
    K5F and one K4-paged (W = 1 or W > 1); a layer of each prefill chunk
    one K5F and one K4-prefill (K5 none: no serving path runs it); every
    forward (step,
    verify, chunk) 7 products a layer and the LM head, the first layer's
    attention norm alone (``rms_norm``) and every other norm with the
    residual add before it (``add_rms_norm``: 2 L, the final norm one of
    them); an engine with an
    adapter set 2 LoRA deltas a layer per forward, each two launches
    (``lora_mid``, then ``lora_delta``). ``q8``: int8 weights
    and pool (the ``*_q8`` forms). Every other count 0 (the sampler's
    ``top_p_kth`` included: a caller whose run samples sets it)."""
    steps, n_verify, n_chunks = _dispatch_record(events)
    L, q = n_layers, '_q8' if q8 else ''
    fwd = steps + n_verify + n_chunks
    want = {name: 0 for name in kernels}
    want.update({'paged_w1' + q: L * steps,
                 'paged_verify' + q: L * n_verify,
                 'rope_cache_write' + q: L * (steps + n_verify + n_chunks),
                 'prefill_attention' + q: L * n_chunks,
                 'matmul' + q: (7 * L + 1) * fwd,
                 'rms_norm': fwd,
                 'add_rms_norm': 2 * L * fwd,
                 'lora_mid': 2 * L * fwd if lora else 0,
                 'lora_delta': 2 * L * fwd if lora else 0})
    return want, dict(decode_steps=steps, verify_dispatches=n_verify,
                      prefill_chunks=n_chunks)


# ---------------------------------------------------------------------
# INVARIANCE: a row's bits whatever shares its call (Queue 3 R9)
# ---------------------------------------------------------------------

INV_MS = (1, 8, 9, 72, 512)
MATMUL_SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
                 (128256, 4096))
MATMUL_TOL = 1e-2


def _row_bits(torch, fn, x, ms=INV_MS):
    """``fn`` over the first m rows of x (m in ``ms``) against the same
    rows of one call over all of x, and 16 rows of x each alone: the
    number of output elements that differ, by m and for 'alone'. A
    reduction whose order moved with the call's rows shows on some row
    even where one random row rounds alike."""
    full = fn(x)
    diffs = {m: int((fn(x[:m]).float() != full[:m].float()).sum())
             for m in ms}
    picks = torch.linspace(0, x.shape[0] - 1, 16).long().tolist()
    diffs['alone'] = sum(int((fn(x[i:i + 1]).float() !=
                              full[i:i + 1].float()).sum()) for i in picks)
    return diffs


def _matmul_lines(torch, mi, gen):
    """The invariant GEMM at every engine shape: bf16 and int8 weights,
    a fixed row's bits at M = 1, 8, 9, 72, 512 and alone (with cuBLAS's
    beside them, printed), the error against f32, and ``MATMUL_INV``
    times at M = 8, 72, 512 on cold weights (each call a copy of the
    weight outside L2, as the engine meets a layer's weights, for the
    kernel and cuBLAS alike: ``torch.matmul``, timed only) in a CUDA
    graph and eagerly (the host's cost a launch included), beside the
    bound and each M's plan: bucket tile, segments and form."""
    rows, mains = [], {}
    for n, k in MATMUL_SHAPES:
        def make_w(n=n, k=k):
            return (torch.randn((k, n), generator=gen, device='cuda') *
                    k ** -0.5).to(torch.bfloat16)

        def make_wq(n=n, k=k):
            return {'q': torch.randint(-127, 128, (k, n), generator=gen,
                                       device='cuda', dtype=torch.int8),
                    's': (torch.rand((1, n), generator=gen, device='cuda') *
                          0.02).to(torch.bfloat16)}
        def make_wt(n=n, k=k):  # a tied head's transposed [N, K]
            return (torch.randn((n, k), generator=gen, device='cuda') *
                    k ** -0.5).to(torch.bfloat16).T
        x = torch.randn((512, k), generator=gen, device='cuda',
                        dtype=torch.bfloat16)
        forms = [('bf16', make_w), ('int8', make_wq)]
        if n == k:
            forms.append(('bf16_t', make_wt))
        for form, make in forms:
            weight = make()
            y = mi.matmul(x, weight)
            plain = mi._matmul_plain(x, weight)
            ref = (x.float() @ weight.float() if form != 'int8' else
                   (x.float() @ weight['q'].float()) *
                   weight['s'].float())
            err = ((y.float() - ref).abs().max() /
                   ref.abs().max()).item()
            abs_err = (y.float() - plain.float()).abs().max().item()
            err_plain = abs_err / plain.float().abs().max().item()
            del ref, plain
            bits = _row_bits(torch, lambda a, wt=weight: mi.matmul(a, wt),
                             x)
            cublas = _row_bits(
                torch, lambda a, wt=weight: mi._matmul_plain(a, wt), x)
            wbytes = k * n * (1 if form == 'int8' else 2) + \
                (2 * n if form == 'int8' else 0)
            copies = copies_outside_l2(make, wbytes, weight)
            times = {}
            for m in (8, 72, 512):
                xm = x[:m]
                args = [(xm, c) for c in copies]
                for a in args:  # every copy's tensor map before capture
                    mi.matmul(*a)
                nbytes = 2 * m * k + wbytes + 2 * m * n
                flops = 2 * m * n * k

                def kernel(a, wt):
                    return mi.matmul(a, wt)

                def cublas_call(a, wt):
                    return mi._matmul_plain(a, wt)
                times[m] = dict(
                    plan=mi.matmul_launch(m, n, k),
                    kernel_ms=graph_ms(torch, kernel, args, 20),
                    cublas_ms=graph_ms(torch, cublas_call, args, 20),
                    kernel_eager_ms=cuda_ms(torch, kernel, args, 20),
                    cublas_eager_ms=cuda_ms(torch, cublas_call, args, 20),
                    weight_copies=len(copies),
                    bound_ms=1e3 * max(nbytes / PEAK_HBM_BYTES,
                                       flops / PEAK_BF16_FLOPS),
                    bound_by='bytes' if nbytes / PEAK_HBM_BYTES >
                    flops / PEAK_BF16_FLOPS else 'operations')
            line = dict(N=n, K=k, form=form,
                        plan=dict(zip(('seg_tiles', 'n_segs', 'group'),
                                      mi.matmul_plan(n, k))),
                        err_vs_f32=err, err_vs_plain=err_plain,
                        max_abs_err=abs_err,
                        row_bits_differing=bits,
                        cublas_row_bits_differing=cublas, times=times,
                        card=smi_line())
            log('MATMUL_INV ' + json.dumps(line))
            assert err_plain <= MATMUL_TOL and err <= MATMUL_TOL, line
            assert all(d == 0 for d in bits.values()), line
            rows.append(line)
            if (n, k, form) in ((4096, 4096, 'bf16'), (4096, 4096, 'int8')):
                mains[form] = line
            del weight, copies
            torch.cuda.empty_cache()
    return rows, mains


def _op_invariance(torch, da, mi, rn, tp, gen):
    """Every other row op of the engine's path, each row of a call
    against the same row in calls of other shapes; returns ({op: {shape:
    differing elements}}, the same for the torch forms they replaced,
    printed as evidence and not held)."""
    from skypilot_torch.models import llama

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device='cuda') *
                scale).to(dtype)
    held, shown = {}, {}
    d = 4096
    wn = randn(d)
    xn = randn(512, d)
    held['rms_norm'] = _row_bits(torch, lambda x: rn.rms_norm(x, wn, 1e-5),
                                 xn)
    # The fused form: x and delta side by side, s and y side by side.
    held['add_rms_norm'] = _row_bits(
        torch, lambda xd: torch.cat(rn.add_rms_norm(
            xd[:, 0], xd[:, 1], wn, 1e-5), -1), randn(512, 2, d))
    shown['rms_norm_torch'] = _row_bits(
        torch, lambda x: llama._rms_norm(x, wn, 1e-5), xn)
    # The int8 quantization of the prefill chunk's rows stays torch: its
    # reduction is a max, exact in any order.
    held['quantize_kv'] = _row_bits(
        torch, lambda x: torch.cat([c.float().flatten(1) for c in
                                    da.quantize_kv(x)], 1),
        randn(512, HKV8, HD8))
    # The LoRA delta: B 1/8 rows of T 1/9/512 positions, against the
    # same rows of one B 8 x T 512 call.
    a_sl = randn(3, d, 16, dtype=torch.float32, scale=0.05)
    b_sl = randn(3, 16, d, dtype=torch.float32, scale=0.05)
    h = randn(8, 512, d)
    idx = torch.tensor([1, 2, 0, 1, 2, 0, 1, 2], dtype=torch.int32,
                       device='cuda')
    for name, fn in (('lora_delta', mi.lora_gather_delta),
                     ('lora_bmm_torch', mi._lora_plain)):
        full = fn(h, a_sl, b_sl, idx)
        (held if name == 'lora_delta' else shown)[name] = {
            f'B{b}T{t}': int((fn(h[:b, :t], a_sl, b_sl, idx[:b]) !=
                              full[:b, :t]).sum())
            for b in (1, 8) for t in (1, 9, 512)}
    # The sampler's nucleus threshold over sorted 128256-id rows.
    vocab = 128256
    srt = torch.sort(randn(72, vocab, dtype=torch.float32, scale=3.0), -1,
                     descending=True).values
    top = torch.full((72,), 0.9, device='cuda')
    held['top_p_kth'] = _row_bits(torch, lambda x: tp.top_p_kth(
        x, top[:x.shape[0]]), srt, ms=(1, 8, 9, 72))
    shown['top_p_kth_torch'] = _row_bits(torch, lambda x: tp._top_p_kth_plain(
        x, top[:x.shape[0]]), srt, ms=(1, 8, 9, 72))
    shown['top_p_cumsum_torch'] = _row_bits(
        torch, lambda x: torch.cumsum(torch.softmax(x, -1), -1), srt,
        ms=(1, 8, 9, 72))
    # K5F: R rows (each its own pool row) against the same rows of one
    # 512-row call: rotated q, written codes/rows and scales.
    n_rows = 600
    q, k, v = randn(512, 32, HD8), randn(512, HKV8, HD8), randn(512, HKV8,
                                                                 HD8)
    ang = torch.rand((512, HD8 // 2), generator=gen, device='cuda') * 50
    cos, sin = torch.cos(ang), torch.sin(ang)
    dst = torch.arange(512, dtype=torch.int32, device='cuda') + 16
    for q8 in (False, True):
        def call(r):
            dt = torch.int8 if q8 else torch.bfloat16
            kp = torch.zeros((n_rows, HKV8, HD8), dtype=dt, device='cuda')
            vp = torch.zeros_like(kp)
            sc = ([torch.zeros((n_rows, HKV8), dtype=torch.bfloat16,
                               device='cuda') for _ in range(2)] if q8
                  else [None, None])
            qo = da.rope_cache_write(q[:r], k[:r], v[:r], cos[:r], sin[:r],
                                     kp, vp, dst[:r], *sc)
            return [qo] + [x[16:16 + r] for x in [kp, vp] + sc
                           if x is not None]
        full = call(512)
        held[f'rope_cache_write_{"int8" if q8 else "bf16"}'] = {
            r: sum(int((a.float() != b[:r].float()).sum())
                   for a, b in zip(call(r), full)) for r in INV_MS}
    # K4-paged: 8 rows at engine lengths, W 1 and 9, each row against the
    # same row alone, and verify's query 0 against decode.
    nb = 8 * 130 + 1
    tables = (torch.randperm(nb - 1, generator=gen, device='cuda')
              .reshape(8, 130) + 1).to(torch.int32)
    lens = torch.tensor([17, 64, 256, 1024, 1064, 1114, 1536, 2048],
                        dtype=torch.int32, device='cuda')
    for q8 in (False, True):
        if q8:
            kp = torch.randint(-127, 128, (nb * BLOCK, HKV8, HD8),
                               generator=gen, device='cuda',
                               dtype=torch.int8)
            vp = torch.randint(-127, 128, (nb * BLOCK, HKV8, HD8),
                               generator=gen, device='cuda',
                               dtype=torch.int8)
            sc = [randn(nb * BLOCK, HKV8).abs() * 0.02 for _ in range(2)]
        else:
            kp, vp = randn(nb * BLOCK, HKV8, HD8), randn(nb * BLOCK, HKV8,
                                                          HD8)
            sc = [None, None]
        qv = randn(8, 9, 32, HD8)

        def dec(rows):
            return da.paged_decode_attention(
                qv[rows, 0].contiguous(), kp, vp, tables[rows], lens[rows],
                HD8 ** -0.5, BLOCK, *sc)

        def ver(rows):
            return da.paged_verify_attention(
                qv[rows].contiguous(), kp, vp, tables[rows], lens[rows],
                HD8 ** -0.5, BLOCK, *sc)
        every = list(range(8))
        d8, v8 = dec(every), ver(every)
        held[f'k4_paged_{"int8" if q8 else "bf16"}'] = dict(
            B1W1_vs_B8W1=sum(int((dec([r])[0] != d8[r]).sum())
                             for r in every),
            B1W9_vs_B8W9=sum(int((ver([r])[0] != v8[r]).sum())
                             for r in every),
            W9q0_vs_W1=int((v8[:, 0] != d8).sum()))
        del kp, vp
    # K4-prefill (the prefill chunk): chunks of T rows ending at position
    # 1099, against the same positions of the 512-row chunk, and over a
    # view padded from 1104 to 2048 keys (dense) or a table widened from
    # 69 to 128 pages (paged, bf16 and int8).
    kd, vd = randn(1, 2048, HKV8, HD8), randn(1, 2048, HKV8, HD8)
    qa = randn(1, 1100, 32, HD8)

    def chunk(t, s):
        st = 1100 - t
        return da.verify_attention(
            qa[:, st:].contiguous(), kd[:, :s], vd[:, :s],
            torch.tensor([st + 1], dtype=torch.int32, device='cuda'),
            HD8 ** -0.5)[0]
    kpg, tab = _paged_copy(torch, gen, kd, 128)
    vpg = torch.zeros_like(kpg)
    rows = (tab[0].long()[:, None] * BLOCK + torch.arange(
        BLOCK, device='cuda')).reshape(-1)
    vpg[rows] = vd[0]
    (kc, ks), (vc, vs) = da.quantize_kv(kpg), da.quantize_kv(vpg)

    def paged_chunk(t, mb):
        st = 1100 - t
        return da.prefill_attention(
            qa[:, st:].contiguous(), kpg, vpg,
            torch.tensor([st + 1], dtype=torch.int32, device='cuda'),
            HD8 ** -0.5, block_table=tab[:, :mb].contiguous(),
            block_size=BLOCK)[0]
    full_p = paged_chunk(512, 69)
    held['k4_prefill_paged'] = {
        f'T{t}MB{mb}': int((paged_chunk(t, mb) != full_p[512 - t:]).sum())
        for t, mb in ((1, 69), (8, 69), (9, 69), (72, 69), (512, 128))}
    # int8: a chunk attends its own exact rows and earlier keys' codes, so
    # the chunks share a start (1028) and differ in length (a bucket's
    # padding) and in the table's width.
    qb = randn(1, 512, 32, HD8)

    def int8_chunk(t, mb):
        return da.prefill_attention(
            qb[:, :t].contiguous(), kc, vc,
            torch.tensor([1029], dtype=torch.int32, device='cuda'),
            HD8 ** -0.5, block_table=tab[:, :mb].contiguous(),
            block_size=BLOCK, k_new=kd[:, 1028:1028 + t].contiguous(),
            v_new=vd[:, 1028:1028 + t].contiguous(), k_scale=ks,
            v_scale=vs)[0]
    full_q = int8_chunk(512, 128)
    held['k4_prefill_paged_int8'] = {
        f'T{t}MB{mb}': int((int8_chunk(t, mb) != full_q[:t]).sum())
        for t, mb in ((1, 97), (8, 97), (9, 97), (72, 97), (512, 97))}

    def einsum_form(t):
        st = 1100 - t
        return da._reference_verify_attention(
            qa[:, st:], kd[:, :1104], vd[:, :1104],
            torch.tensor([st + 1], dtype=torch.int32, device='cuda'),
            HD8 ** -0.5)[0]
    full, full_m = chunk(512, 1104), einsum_form(512)
    held['k4_prefill'] = {f'T{t}S{s}': int((chunk(t, s) != full[512 - t:])
                                           .sum())
                          for t, s in ((1, 1104), (8, 1104), (9, 1104),
                                       (72, 1104), (512, 2048))}
    shown['einsum_attention_torch'] = {
        f'T{t}': int((einsum_form(t) != full_m[512 - t:]).sum())
        for t in (1, 8, 9, 72)}
    shown['matmul_torch'] = 'see MATMUL_INV cublas_row_bits_differing'
    return held, shown


def _step_invariance(torch, batching, config, params, q8, gen):
    """One decode step and one verify step (W 9) at 32 layers: each row's
    tokens and new K/V rows among 8 rows against the row's step alone
    (greedy and sampled rows), and each row's verify query 0 against the
    decode step's token. Returns (rows, held)."""
    from skypilot_torch.models import llama
    L, hkv, hd = config.n_layers, config.n_kv_heads, config.head_dim
    lens = [17, 64, 256, 1024, 1064, 1114, 1536, 2048]
    b, w, mb = len(lens), 9, 2048 // BLOCK + 2
    nb = 1 + b * mb
    shape = (L, nb, BLOCK, hkv, hd)
    if q8:
        kp = torch.randint(-127, 128, shape, generator=gen, device='cuda',
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device='cuda',
                           dtype=torch.int8)
        ks = (torch.rand(shape[:-1], generator=gen, device='cuda') *
              0.02).to(torch.bfloat16)
        vs = (torch.rand(shape[:-1], generator=gen, device='cuda') *
              0.02).to(torch.bfloat16)
        caches = (kp, vp, ks, vs)
    else:
        kp = torch.randn(shape, generator=gen, device='cuda',
                         dtype=torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device='cuda',
                         dtype=torch.bfloat16)
        caches = (kp, vp, None, None)
    tables = (torch.randperm(nb - 1, generator=gen, device='cuda')[:b * mb]
              .reshape(b, mb) + 1).to(torch.int32)
    pos = torch.tensor(lens, dtype=torch.int32, device='cuda')
    tokens = torch.randint(0, config.vocab_size, (b, w), generator=gen,
                           device='cuda', dtype=torch.int32)
    active = torch.ones(b, dtype=torch.bool, device='cuda')
    n_real = torch.full((b,), w, dtype=torch.int32, device='cuda')
    vocab = config.vocab_size
    knobs = dict(temps=torch.tensor([0.0] * 4 + [0.8] * 4, device='cuda'),
                 top_ps=torch.tensor([1.0, 1.0, 0.9, 0.9] * 2,
                                     device='cuda'),
                 seeds=torch.arange(b, dtype=torch.int32, device='cuda') + 7)

    def sampling(rows, width=None):
        table = torch.ones((1, vocab) if width is None else
                           (1, width, vocab), dtype=torch.bool,
                           device='cuda')
        return dict({k: v[rows] for k, v in knobs.items()},
                    mask_table=table,
                    mask_idx=torch.zeros(len(rows), dtype=torch.int32,
                                         device='cuda'))

    def new_rows(r, width):
        """Every layer's K/V (codes and scales) at row r's ``width``
        write positions."""
        out = []
        for p in range(lens[r], lens[r] + width):
            blk = tables[r, p // BLOCK].item()
            out.append([x[:, blk, p % BLOCK].clone()
                        for x in caches if x is not None])
        return out

    def decode(rows):
        return batching.decode_steps_paged(
            params, tokens[rows, 0], caches, tables[rows], pos[rows],
            active[rows], config, 1, BLOCK, sampling=sampling(rows))[0]

    def verify(rows):
        return batching.verify_step_paged(
            params, tokens[rows], caches, tables[rows], pos[rows],
            n_real[rows], config, w, BLOCK,
            sampling=sampling(rows, w))[0]
    every = list(range(b))
    held, rows_out = {}, []
    with torch.inference_mode():
        for name, step, width in (('decode', decode, 1),
                                  ('verify', verify, w)):
            batch = step(every).cpu()
            kv_batch = [new_rows(r, width) for r in every]
            diffs = []
            for r in every:
                alone = step([r]).cpu()
                kv_alone = new_rows(r, width)
                kv_equal = all(torch.equal(x, y) for a, c in
                               zip(kv_batch[r], kv_alone)
                               for x, y in zip(a, c))
                tok_equal = torch.equal(alone[0], batch[r])
                diffs.append(dict(row=r, tokens_equal=tok_equal,
                                  kv_equal=kv_equal))
            held[name] = diffs
            rows_out.append((name, batch))
    dec, ver = rows_out[0][1], rows_out[1][1]
    held['verify_q0_equals_decode'] = [bool(dec[r, 0] == ver[r, 0])
                                      for r in every]
    del caches, kp, vp
    return held


def _prefill_vs_decode(torch, batching, config, params, gen):
    """Position 1023 of a 1024-token prompt prefilled in chunks of 512
    against the same position reached by prefilling 1023 tokens and
    decoding one: the K/V rows written there (layer 0 and the last) and
    the token (held by ``invariance_phase``: a preempted request
    re-prefills its tokens and must go on as it would have)."""
    from skypilot_torch.models import decode as decode_lib
    L, hkv, hd = config.n_layers, config.n_kv_heads, config.head_dim
    mb = 1024 // BLOCK + 1
    shape = (L, 2 * mb + 1, BLOCK, hkv, hd)
    kp = torch.zeros(shape, dtype=torch.bfloat16, device='cuda')
    vp = torch.zeros_like(kp)
    caches = (kp, vp, None, None)
    prompt = torch.randint(0, config.vocab_size, (1024,), generator=gen,
                           device='cuda')
    tabs = [torch.arange(1 + i * mb, 1 + (i + 1) * mb, dtype=torch.int32,
                         device='cuda') for i in range(2)]
    with torch.inference_mode():
        for start in (0, 512):
            logits, _ = decode_lib.forward_paged(
                params, prompt[None, start:start + 512], caches, tabs[0],
                start, 512, config, BLOCK)
        prefill_tok = int(logits[0].argmax())
        decode_lib.forward_paged(params, prompt[None, :512], caches,
                                 tabs[1], 0, 512, config, BLOCK)
        decode_lib.forward_paged(params, prompt[None, 512:1023], caches,
                                 tabs[1], 512, 511, config, BLOCK)
        toks, _, _ = batching.decode_steps_paged(
            params, prompt[1023:1024].to(torch.int32), caches, tabs[1][None],
            torch.tensor([1023], dtype=torch.int32, device='cuda'),
            torch.ones(1, dtype=torch.bool, device='cuda'), config, 1,
            BLOCK)
    p = 1023
    rows = [(tab[p // BLOCK].item(), p % BLOCK) for tab in tabs]
    kv_equal = {layer: all(torch.equal(x[layer, rows[0][0], rows[0][1]],
                                       x[layer, rows[1][0], rows[1][1]])
                           for x in (kp, vp)) for layer in (0, L - 1)}
    line = dict(position=p, prefill_token=prefill_tok,
                decode_token=int(toks[0, 0]),
                tokens_equal=prefill_tok == int(toks[0, 0]),
                kv_rows_equal_by_layer=kv_equal)
    log('INVARIANCE_PREFILL_VS_DECODE ' + json.dumps(line))
    del kp, vp
    return line


def _lora_line(torch, mi, gen):
    """The LoRA delta at a decode step's shape (B 8, T 1, d 4096, rank
    16, q's 4096 outputs): the kernel against the plain batched products
    (f32), times and the bound."""
    b, d, r, n = 8, 4096, 16, 4096
    h = torch.randn((b, 1, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    a_sl = torch.randn((3, d, r), generator=gen, device='cuda') * 0.03
    b_sl = torch.randn((3, r, n), generator=gen, device='cuda') * 0.03
    idx = torch.tensor([1, 2, 0, 1, 2, 0, 1, 2], dtype=torch.int32,
                       device='cuda')
    before = (mi.LORA_MID.launches, mi.LORA_DELTA.launches)
    y = mi.lora_gather_delta(h, a_sl, b_sl, idx)
    launches = (mi.LORA_MID.launches - before[0],
                mi.LORA_DELTA.launches - before[1])
    ref = mi._lora_plain(h, a_sl, b_sl, idx)
    err = (y - ref).abs().max().item()
    # The kernel's two phases against their plain versions.
    mid_ref = mi._lora_mid_plain(h, a_sl, idx)
    phase_err = (mi._lora_out_plain(mid_ref, b_sl, idx) - ref).abs().max(
        ).item() / ref.abs().max().item()
    # The rows share slots: the function reads each distinct slot's
    # factors once.
    u = len(set(idx.tolist()))
    nbytes = 2 * b * d + 4 * (u * d * r + u * r * n) + 4 * b * n
    flops = 2 * b * r * (d + n)
    line = dict(B=b, T=1, d=d, rank=r, out=n, max_abs_err=err,
                rel_err=err / ref.abs().max().item(),
                plain_phases_rel_err=phase_err,
                launches_per_call=dict(lora_mid=launches[0],
                                       lora_delta=launches[1]),
                ms=graph_ms(torch, lambda: mi.lora_gather_delta(
                    h, a_sl, b_sl, idx), [()], 50),
                plain_ms=graph_ms(torch, lambda: mi._lora_plain(
                    h, a_sl, b_sl, idx), [()], 50),
                bound_ms=1e3 * max(nbytes / PEAK_HBM_BYTES,
                                   flops / PEAK_BF16_FLOPS),
                bound_by='bytes', library='torch.bmm x 2 (the plain version)',
                card=smi_line())
    line['library_ms'] = line['plain_ms']
    log('LORA_DELTA ' + json.dumps(line))
    assert line['rel_err'] <= 1e-5 and phase_err <= 1e-5, line
    # One launch of each phase a call: _serving_identity's 2 L + 2 L.
    assert launches == (1, 1), line
    return line


# The nucleus threshold against its plain version on the card: a row's
# cut may differ only where the token between the two cuts has a
# preceding mass within this of top_p (the two sum in other orders).
TOP_P_TIE = 1e-5
# Vocabularies the nucleus threshold is also held at: one warp a block
# (4096), an odd V, so that every row after the first starts off a 16-byte
# boundary (128255), and Gemma's (256000, 896 threads a block).
TOP_P_OTHER_VOCABS = (4096, 128255, 256000)


def _top_p_ties(torch, tp, srt, top):
    """The kernel's and the plain version's cuts over sorted rows: (rows
    whose cut differs, the largest distance from top_p of the preceding
    mass of a logit between the two cuts, the kernel's cuts)."""
    kth = tp.top_p_kth(srt, top)
    ref = tp._top_p_kth_plain(srt, top)
    e = torch.exp(srt - srt[:, :1])
    probs = e / e.sum(-1, keepdim=True)
    before = torch.cumsum(probs, -1) - probs
    lo, hi = torch.minimum(kth, ref), torch.maximum(kth, ref)
    between = (srt >= lo) & (srt < hi)
    ties = (before - top[:, None]).abs()[between]
    return (int((kth != ref).sum()),
            ties.max().item() if ties.numel() else 0.0, kth, ref)


def _top_p_line(torch, tp, gen):
    """The nucleus threshold at 72 rows of 128256 sorted logits: the
    kernel against the plain version (the kth logit equal on every row
    but at a ``TOP_P_TIE`` near-tie of the mass), also over logits of
    standard deviation 40 (a few percent of the e_i under 2^-100, which
    the kernel divides with ``__fdiv_rn`` in its other loop) and at
    ``TOP_P_OTHER_VOCABS`` (other plans, and rows that start off a
    16-byte boundary), then times at a decode step's 8 rows and a verify
    step's 72, the bound and the plan (cluster, logits a block,
    threads)."""
    rows, vocab = 72, 128256

    def sorted_rows(scale, v=vocab):
        return torch.sort(torch.randn((rows, v), generator=gen,
                                      device='cuda') * scale, -1,
                          descending=True).values
    top = torch.linspace(0.5, 0.95, rows, device='cuda')
    wide = sorted_rows(40)
    e = torch.exp(wide - wide[:, :1])
    tiny_share = ((e > 0) & (e < 2 ** -100)).float().mean().item()
    del e
    wide_cuts, wide_worst, _, _ = _top_p_ties(torch, tp, wide, top)
    del wide
    others = {}
    for v in TOP_P_OTHER_VOCABS:
        cuts, worst_v, _, _ = _top_p_ties(torch, tp, sorted_rows(3, v), top)
        others[v] = dict(plan=tp.top_p_plan(v), differing_cuts=cuts,
                         worst_tie=worst_v)
    srt = sorted_rows(3)
    differing, worst, kth, ref = _top_p_ties(torch, tp, srt, top)

    def times(m, fn):
        return graph_ms(torch, lambda: fn(srt[:m], top[:m]), [()], 50)

    def bound(m):
        return 1e3 * 4 * m * (vocab + 2) / PEAK_HBM_BYTES
    line = dict(rows=8, vocab=vocab, rows_checked=72,
                plan=dict(zip(('cluster', 'per_cta', 'threads'),
                              tp.top_p_plan(vocab))),
                max_abs_err=(kth[:8] - ref[:8]).abs().max().item(),
                max_abs_err_72=(kth - ref).abs().max().item(),
                differing_cuts=differing, worst_tie=worst,
                tie_tol=TOP_P_TIE,
                wide=dict(scale=40, tiny_share=tiny_share,
                          differing_cuts=wide_cuts, worst_tie=wide_worst),
                other_vocabs=others,
                ms=times(8, tp.top_p_kth),
                plain_ms=times(8, tp._top_p_kth_plain),
                bound_ms=bound(8), bound_by='bytes', library_ms=None,
                ms_72=times(72, tp.top_p_kth),
                plain_ms_72=times(72, tp._top_p_kth_plain),
                bound_ms_72=bound(72),
                card=smi_line())
    log('TOP_P_KTH ' + json.dumps(line))
    assert worst < TOP_P_TIE and wide_worst < TOP_P_TIE, line
    assert all(o['worst_tie'] < TOP_P_TIE for o in others.values()), line
    assert tiny_share > 0, line
    return line


# Input pairs the 512-row fused norm is timed over: 12 x 8 MB of x and
# delta, twice the H100's 50 MB of L2.
NORM_COLD_SETS = 12


def _rms_norm_line(torch, rn, gen):
    """RMSNorm at a decode step's 8 rows of 4096: the plain-norm form (no
    delta) against the plain version (1e-2 of the output's size: bf16
    rounding of sums in another order), times, the bound and the library
    call (``torch.nn.functional.rms_norm``, timed only). Then the fused
    form (the residual add with it) at 8 and 512 rows: every s and y
    bit-equal to torch's add followed by the plain-norm form, within 1e-2
    of the plain version, its time against torch's add followed by the
    plain-norm form (``add_plus_new_norm_ms``; the add alone: ``add_ms``;
    the add and ``F.rms_norm``: ``add_plus_library_norm_ms``), and its
    bound (x and delta read, s and y written). At 8 rows the inputs stay
    in L2 between calls, as a decode step's do; at 512 each graph cycles
    through ``NORM_COLD_SETS`` input pairs, more bytes than L2 holds, so
    that the time compares with the HBM bound."""
    from skypilot_torch.ops import rms_norm as rn_mod
    F = torch.nn.functional
    d = 4096

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16)
    x, w = randn(8, d), randn(d)
    y = rn.rms_norm(x, w, 1e-5)
    ref = rn_mod._rms_norm_plain(x, w, 1e-5)
    err = (y.float() - ref.float()).abs().max().item()
    line = dict(rows=8, dim=d, plan=rn.norm_plan(d, 2), max_abs_err=err,
                rel_err=err / ref.float().abs().max().item(),
                ms=graph_ms(torch, lambda: rn.rms_norm(x, w, 1e-5), [()],
                            50),
                plain_ms=graph_ms(torch, lambda: rn_mod._rms_norm_plain(
                    x, w, 1e-5), [()], 50),
                bound_ms=1e3 * (2 * 8 * d * 2 + 2 * d) / PEAK_HBM_BYTES,
                bound_by='bytes',
                library_ms=graph_ms(torch, lambda: F.rms_norm(
                    x, (d,), w, 1e-5), [()], 50),
                library='torch.nn.functional.rms_norm')
    fused = {}
    for rows in (8, 512):
        sets = [(randn(rows, d), randn(rows, d))
                for _ in range(1 if rows == 8 else NORM_COLD_SETS)]
        xr, dr = sets[0]
        s, yf = rn.add_rms_norm(xr, dr, w, 1e-5)
        s_ref = xr + dr
        y_ref = rn.rms_norm(s_ref, w, 1e-5)
        y_plain = rn_mod._rms_norm_plain(s_ref, w, 1e-5)
        f_err = (yf.float() - y_plain.float()).abs().max().item()

        def timed(fn):
            return graph_ms(torch, fn, sets, 48)
        fused[rows] = dict(
            s_elements_differing=int((s != s_ref).sum()),
            y_elements_differing=int((yf != y_ref).sum()),
            max_abs_err=f_err,
            rel_err=f_err / y_plain.float().abs().max().item(),
            input_sets=len(sets),
            ms=timed(lambda a, b: rn.add_rms_norm(a, b, w, 1e-5)),
            add_plus_new_norm_ms=timed(
                lambda a, b: rn.rms_norm(a + b, w, 1e-5)),
            add_ms=timed(lambda a, b: a + b),
            plain_ms=timed(lambda a, b: rn_mod._add_rms_norm_plain(
                a, b, w, 1e-5, False)),
            add_plus_library_norm_ms=timed(lambda a, b: F.rms_norm(
                a + b, (d,), w, 1e-5)),
            bound_ms=1e3 * (4 * rows * d * 2 + 2 * d) / PEAK_HBM_BYTES,
            bound_by='bytes', library_ms=None)
        del sets
    line.update(fused=fused, card=smi_line())
    log('RMS_NORM ' + json.dumps(line))
    assert line['rel_err'] <= 1e-2, line
    for f in fused.values():
        assert f['s_elements_differing'] == 0, line
        assert f['y_elements_differing'] == 0, line
        assert f['rel_err'] <= 1e-2, line
    return line


# K4-prefill's lines: T 512 at these (start, view keys); the bit checks
# at these chunk lengths and starts (100: not a multiple of 16).
K4_PREFILL_CASES = ((588, 1104), (7680, 8192))
PREFILL_BIT_TS = (1, 9, 72, 512)
PREFILL_BIT_STARTS = (0, 100, 588, 7680)


def _paged_copy(torch, gen, x, mb):
    """The rows of a view x [1, S, ...] laid into a pool of ``mb`` + 1
    pages of BLOCK rows (page 0 left as scratch) in shuffled page order:
    (pool [N, ...], table [1, mb] int32)."""
    s = x.shape[1]
    table = (torch.randperm(mb, generator=gen, device='cuda') + 1).to(
        torch.int32)[None]
    pool = torch.zeros(((mb + 1) * BLOCK,) + tuple(x.shape[2:]),
                       dtype=x.dtype, device='cuda')
    rows = (table[0].long()[:, None] * BLOCK +
            torch.arange(BLOCK, device='cuda')).reshape(-1)[:s]
    pool[rows] = x[0]
    return pool, table


def _prefill_attention_line(torch, da, gen, st, s):
    """K4-prefill at an engine prefill chunk (T 512 from position ``st``
    over an ``s``-key view, llama3-8b heads): its paged form (the
    engine's: the pool, the chunk's rows included, through a shuffled
    table) against the plain version in f32 (``K4_PREFILL_TOL`` absolute and
    ``K4_REL_TOL`` per row and query position); its dense form bit-equal
    to the paged one; timed beside K4's W = T form on the same view (the
    route before K4-prefill, through ``DECODE_ATTENTION``), the einsum
    form of the JAX step, SDPA (the library call, timed only) and the
    bound (q, the visible keys and out; the causal products)."""
    import torch.nn.functional as F
    t, scale = 512, HD8 ** -0.5
    q = torch.randn((1, t, 32, HD8), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    k = torch.randn((1, s, HKV8, HD8), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    v = torch.randn((1, s, HKV8, HD8), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    kp, table = _paged_copy(torch, gen, k, -(-s // BLOCK) + 2)
    vp = torch.zeros_like(kp)
    vp[(table[0].long()[:, None] * BLOCK + torch.arange(
        BLOCK, device='cuda')).reshape(-1)[:s]] = v[0]
    lengths = torch.tensor([st + 1], dtype=torch.int32, device='cuda')

    def paged():
        return da.prefill_attention(q, kp, vp, lengths, scale,
                                    block_table=table, block_size=BLOCK)

    def dense():
        return da.prefill_attention(q, k, v, lengths, scale)

    def before():
        return da._decode_attention_cuda(q, k, v, lengths, scale)
    out = paged()
    ref = da._reference_verify_attention(q.float(), k.float(), v.float(),
                                         lengths, scale)
    err, rel = k4_errors(out, ref)
    b_err, b_rel = k4_errors(before(), ref)
    kr = k.repeat_interleave(32 // HKV8, dim=2).transpose(1, 2)
    vr = v.repeat_interleave(32 // HKV8, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    mask = (torch.arange(s, device='cuda')[None, :] <=
            torch.arange(t, device='cuda')[:, None] + st)

    def library():
        return F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask,
                                              scale=scale)
    lib_err = (library().transpose(1, 2).float() - ref.float()).abs().max(
        ).item()
    pairs = sum(st + 1 + i for i in range(t))
    nbytes = 2 * (2 * t * 32 * HD8 + 2 * (st + t) * HKV8 * HD8)
    flops = 4 * pairs * 32 * HD8
    line = dict(T=t, S=s, start=st, max_abs_err=err, tol=K4_PREFILL_TOL,
                max_rel_err=rel, rel_tol=K4_REL_TOL,
                dense_equals_paged=bool(torch.equal(dense(), out)),
                ms=graph_ms(torch, paged, [()], 10),
                dense_ms=graph_ms(torch, dense, [()], 10),
                before_ms=graph_ms(torch, before, [()], 10),
                before='K4 W = T (DECODE_ATTENTION), dense view',
                before_max_abs_err=b_err, before_max_rel_err=b_rel,
                einsum_form_ms=graph_ms(
                    torch, lambda: da._reference_verify_attention(
                        q, k, v, lengths, scale), [()], 10),
                library_ms=graph_ms(torch, library, [()], 10),
                library='F.scaled_dot_product_attention, bool mask, K/V '
                        'repeated', library_max_abs_err=lib_err,
                bound_ms=1e3 * max(nbytes / PEAK_HBM_BYTES,
                                   flops / PEAK_BF16_FLOPS),
                bound_by='operations' if flops / PEAK_BF16_FLOPS >
                nbytes / PEAK_HBM_BYTES else 'bytes')
    log('K4_PREFILL ' + json.dumps(line))
    assert err <= K4_PREFILL_TOL and rel <= K4_REL_TOL, line
    assert line['dense_equals_paged'], line
    return line


def _prefill_q8_line(torch, da, gen, st=588, s=1104):
    """K4-prefill's int8 form at the engine's chunk (T 512 from ``st``,
    an ``s``-key view quantized per (row, kv head) into a shuffled
    pool, the chunk's exact bf16 rows from st): against the plain version
    (gather, dequant, splice, attention) in f32, bit-equal to the bf16
    form over a bf16 pool holding the dequantized codes, timed beside
    the plain version and the bound (codes, scales, the chunk's rows,
    q and out; the causal products)."""
    t, scale = 512, HD8 ** -0.5
    q = torch.randn((1, t, 32, HD8), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    k = torch.randn((1, s, HKV8, HD8), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    v = torch.randn((1, s, HKV8, HD8), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    (kc, ks), (vc, vs) = da.quantize_kv(k), da.quantize_kv(v)
    mb = -(-s // BLOCK) + 2
    kcp, table = _paged_copy(torch, gen, kc, mb)
    rows = (table[0].long()[:, None] * BLOCK + torch.arange(
        BLOCK, device='cuda')).reshape(-1)[:s]

    def like(x):
        pool = torch.zeros((kcp.shape[0],) + tuple(x.shape[2:]),
                           dtype=x.dtype, device='cuda')
        pool[rows] = x[0]
        return pool
    vcp, ksp, vsp = like(vc), like(ks), like(vs)
    k_new = k[:, st:st + t].contiguous()
    v_new = v[:, st:st + t].contiguous()
    lengths = torch.tensor([st + 1], dtype=torch.int32, device='cuda')
    common = dict(block_table=table, block_size=BLOCK, k_new=k_new,
                  v_new=v_new)

    def kernel():
        return da.prefill_attention(q, kcp, vcp, lengths, scale,
                                    k_scale=ksp, v_scale=vsp, **common)

    def plain():
        return da._reference_prefill_attention(
            q, kcp, vcp, lengths, scale, k_scale=ksp, v_scale=vsp, **common)
    out = kernel()
    # The bf16 form over a bf16 pool holding the dequantized codes, the
    # chunk's exact rows in place.
    kb = da.dequant_kv(kcp, ksp, torch.bfloat16)
    vb = da.dequant_kv(vcp, vsp, torch.bfloat16)
    kb[rows[st:st + t]] = k_new[0]
    vb[rows[st:st + t]] = v_new[0]
    bf = da.prefill_attention(q, kb, vb, lengths, scale, block_table=table,
                              block_size=BLOCK)
    ref = da._reference_prefill_attention(
        q.float(), kcp, vcp, lengths, scale, k_scale=ksp, v_scale=vsp,
        block_table=table, block_size=BLOCK, k_new=k_new.float(),
        v_new=v_new.float())
    err, rel = k4_errors(out, ref)
    pairs = sum(st + 1 + i for i in range(t))
    nbytes = (2 * 2 * t * 32 * HD8 + 2 * st * HKV8 * (HD8 + 2) +
              2 * 2 * t * HKV8 * HD8)
    flops = 4 * pairs * 32 * HD8
    line = dict(T=t, S=s, start=st, max_abs_err=err, tol=K4_PREFILL_TOL,
                max_rel_err=rel, rel_tol=K4_REL_TOL,
                differing_from_bf16_form=int((out != bf).sum()),
                ms=graph_ms(torch, kernel, [()], 10),
                plain_ms=cuda_ms(torch, plain, [()], 10),
                plain_timed='eager (its gather reads the lengths on the host)',
                bound_ms=1e3 * max(nbytes / PEAK_HBM_BYTES,
                                   flops / PEAK_BF16_FLOPS),
                bound_by='operations' if flops / PEAK_BF16_FLOPS >
                nbytes / PEAK_HBM_BYTES else 'bytes', library_ms=None)
    log('K4_PREFILL_Q8 ' + json.dumps(line))
    assert err <= K4_PREFILL_TOL and rel <= K4_REL_TOL, line
    assert line['differing_from_bf16_form'] == 0, line
    return line


def _prefill_bits(torch, da, gen):
    """The bit contract of K4-prefill's bf16 form: every real row of a
    chunk of T (``PREFILL_BIT_TS``, and a 72-row bucket holding 60 real
    rows) from each of ``PREFILL_BIT_STARTS`` equal to K4-paged's decode
    step (W = 1) at the same position over the same pool (8192 keys,
    shuffled pages), at llama3-8b's heads and at head_dim 64 / 128 x
    groups 1 / 8: differing elements by case."""
    s, scale = 8192, HD8 ** -0.5
    k = torch.randn((1, s, HKV8, HD8), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    v = torch.randn((1, s, HKV8, HD8), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    mb = s // BLOCK
    kp, table = _paged_copy(torch, gen, k, mb)
    vp = torch.zeros_like(kp)
    vp[(table[0].long()[:, None] * BLOCK + torch.arange(
        BLOCK, device='cuda')).reshape(-1)] = v[0]
    qa = torch.randn((1, 512, 32, HD8), generator=gen, device='cuda',
                     dtype=torch.bfloat16)
    cases = [(t, t) for t in PREFILL_BIT_TS] + [(72, 60)]
    held = {}
    for st in PREFILL_BIT_STARTS:
        for t, real in cases:
            if st + t > s:
                continue
            q = qa[:, :t].contiguous()
            got = da.prefill_attention(
                q, kp, vp, torch.tensor([st + 1], dtype=torch.int32,
                                        device='cuda'), scale,
                block_table=table, block_size=BLOCK)
            dec = da.paged_decode_attention(
                q[0, :real].contiguous(), kp, vp,
                table.expand(real, mb).contiguous(),
                torch.arange(st + 1, st + 1 + real, dtype=torch.int32,
                             device='cuda'), scale, BLOCK)
            held[f'start{st}_T{t}' + ('' if real == t else f'_real{real}')] \
                = int((got[0, :real] != dec).sum())
    # The other instantiations the template builds: head_dim 64 and 128 at
    # groups 1 and 8 (Hq 32), a 72-row chunk from 100 over 1024 keys.
    for hd, g in ((64, 1), (64, 8), (128, 1), (128, 8)):
        hkv = 32 // g
        kx = torch.randn((1, 1024, hkv, hd), generator=gen, device='cuda',
                         dtype=torch.bfloat16)
        vx = torch.randn((1, 1024, hkv, hd), generator=gen, device='cuda',
                         dtype=torch.bfloat16)
        kpx, tabx = _paged_copy(torch, gen, kx, 1024 // BLOCK)
        vpx = torch.zeros_like(kpx)
        vpx[(tabx[0].long()[:, None] * BLOCK + torch.arange(
            BLOCK, device='cuda')).reshape(-1)] = vx[0]
        qx = torch.randn((1, 72, 32, hd), generator=gen, device='cuda',
                         dtype=torch.bfloat16)
        got = da.prefill_attention(
            qx, kpx, vpx, torch.tensor([101], dtype=torch.int32,
                                       device='cuda'), hd ** -0.5,
            block_table=tabx, block_size=BLOCK)
        dec = da.paged_decode_attention(
            qx[0], kpx, vpx, tabx.expand(72, tabx.shape[1]).contiguous(),
            torch.arange(101, 173, dtype=torch.int32, device='cuda'),
            hd ** -0.5, BLOCK)
        held[f'hd{hd}_G{g}_start100_T72'] = int((got[0] != dec).sum())
    return held


def k4pre_phase(torch, da):
    """K4-prefill on the card: the ``K4_PREFILL`` lines at
    ``K4_PREFILL_CASES`` (bf16, paged and dense), ``K4_PREFILL_Q8``, and
    ``K4_PREFILL_BITS`` (every real row against K4-paged's decode step).
    Returns the kernels-line numbers, bf16 and int8."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device='cuda').manual_seed(43)
    lines = [_prefill_attention_line(torch, da, gen, st, s)
             for st, s in K4_PREFILL_CASES]
    q8 = _prefill_q8_line(torch, da, gen)
    bits = _prefill_bits(torch, da, gen)
    log('K4_PREFILL_BITS ' + json.dumps(dict(
        vs='K4-paged decode step (W = 1), same position and pool',
        differing_elements=bits)))
    assert not any(bits.values()), bits
    torch.cuda.empty_cache()
    log(f'K4_PREFILL_PHASE_S {time.perf_counter() - t_phase:.1f}')
    keys = ('max_abs_err', 'ms', 'bound_ms', 'bound_by', 'library_ms')
    bf16 = dict({key: lines[0][key] for key in keys},
                plain_ms=lines[0]['einsum_form_ms'],
                before_ms=lines[0]['before_ms'],
                cases={f'start{ln["start"]}_S{ln["S"]}': ln for ln in lines},
                bits=bits)
    return bf16, dict({key: q8[key] for key in keys}, plain_ms=q8['plain_ms'],
                      differing_from_bf16_form=q8[
                          'differing_from_bf16_form'])


def invariance_phase(torch, da):
    """Queue 3 R9 on the card: (1) the invariant GEMM at every engine
    shape, bf16 and int8: a fixed row bit-equal at M = 1, 8, 72, 512,
    within ``MATMUL_TOL`` of f32 and of cuBLAS, ``MATMUL_INV`` times; (2)
    every other row op of the engine's path bit-equal for a fixed row at
    its call shapes (the LoRA delta at B 1/8 x T 1/9/512, the nucleus
    threshold at 1/8/72 rows, K5F at R 1..512, K4-paged at B 1/8 x W 1/9,
    K4-prefill at T 1..512 and a padded view or table, dense, paged and
    int8, rms_norm alone and with its residual add, and the int8
    quantization), with the torch forms they replaced printed; the
    ``RMS_NORM`` line (the fused form bit-equal to torch's add then the
    norm, at 8 and 512 rows) and the ``TOP_P_KTH`` line (8 and 72 rows,
    the cluster plan);
    (3) at llama3-8b, 32 layers, bf16 and int8 (weights and pool): one
    decode step's and one verify step's tokens and new K/V rows for each
    of 8 rows equal to the row's step alone, and verify's query 0 equal
    to the decode step's token; (4) prefill against decode at one
    position: the K/V rows at layers 0 and 31 and the token equal."""
    import gc

    from skypilot_torch.models import llama, quant
    from skypilot_torch.ops import matmul_invariant as mi
    from skypilot_torch.ops import rms_norm as rn
    from skypilot_torch.ops import top_p as tp
    from skypilot_torch.serve import batching
    t_phase = time.perf_counter()
    gen = torch.Generator(device='cuda').manual_seed(41)
    matmul_rows, mains = _matmul_lines(torch, mi, gen)
    lora = _lora_line(torch, mi, gen)
    top_p = _top_p_line(torch, tp, gen)
    norm = _rms_norm_line(torch, rn, gen)
    held, shown = _op_invariance(torch, da, mi, rn, tp, gen)
    log('INVARIANCE_OPS ' + json.dumps(dict(held=held,
                                            torch_forms_replaced=shown)))
    bad = {op: d for op, d in held.items() if any(d.values())}
    assert not bad, f'row ops that are not batch-invariant: {bad}'
    config = llama.get_config('llama3-8b')
    steps = {}
    for form in ('bf16', 'int8'):
        gc.collect()
        torch.cuda.empty_cache()
        params = (quant.init_quantized(config, seed=6, device='cuda')
                  if form == 'int8' else
                  llama.init_params(config, seed=6, device='cuda'))
        steps[form] = _step_invariance(torch, batching, config, params,
                                       form == 'int8', gen)
        log(f'INVARIANCE_STEPS_{form.upper()} ' + json.dumps(steps[form]))
        if form == 'bf16':
            pvd = _prefill_vs_decode(torch, batching, config, params, gen)
        del params
    for form, s in steps.items():
        for name in ('decode', 'verify'):
            assert all(r['tokens_equal'] and r['kv_equal'] for r in s[name]), \
                (form, name, s[name])
        assert all(s['verify_q0_equals_decode']), (form, s)
    assert pvd['tokens_equal'] and all(
        pvd['kv_rows_equal_by_layer'].values()), pvd
    gc.collect()
    torch.cuda.empty_cache()
    log(f'INVARIANCE_PHASE_S {time.perf_counter() - t_phase:.1f}')
    return dict(matmul=mains, matmul_rows=matmul_rows, ops=held, lora=lora,
                top_p=top_p, rms_norm=norm)


# ---------------------------------------------------------------------
# K4-paged: decode (W = 1) and verify (W = 9) through the block table
# ---------------------------------------------------------------------


def k4p_phase(torch, F, da):
    """K4-paged against the plain version (gather + reference, f32) at
    B 8, 16-token blocks, a 4097-block pool handed out in shuffled
    order, lengths mixed up to 8192, W = 1 and W = 9; the JAX package's
    route (gather + dense K4) and a library route (gather + SDPA with a
    boolean mask) timed beside it; and the bit-equality of W = 1 with
    dense K4 on tables that lay rows out contiguously."""
    from skypilot_torch.serve import kv_pool
    HQ = 32
    b, mb = 8, 8192 // BLOCK
    s = mb * BLOCK
    scale = HD8 ** -0.5
    gen = torch.Generator(device='cuda').manual_seed(22)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16)
    k_pool = randn(POOL_BLOCKS * BLOCK, HKV8, HD8)
    v_pool = randn(POOL_BLOCKS * BLOCK, HKV8, HD8)
    ids = torch.randperm(POOL_BLOCKS - 1, generator=gen,
                         device='cuda')[:b * mb] + 1
    tables = ids.reshape(b, mb).to(torch.int32).contiguous()
    k_f32, v_f32 = k_pool.float(), v_pool.float()
    lens = [1, 17, 300, 2048, 4097, 6000, 8183, 8192]
    rows = []
    for w in (1, 9):
        q = randn(b, w, HQ, HD8)
        # Verify's base length leaves room for its W positions.
        lengths = torch.tensor([min(n, s - w + 1) for n in lens],
                               dtype=torch.int32, device='cuda')
        before = (da.PAGED_DECODE_ATTENTION.launches,
                  da.PAGED_VERIFY_ATTENTION.launches)
        if w == 1:
            def kernel(q=q, lengths=lengths):
                return da.paged_decode_attention(
                    q[:, 0], k_pool, v_pool, tables, lengths, scale,
                    BLOCK)[:, None]

            def plain(q=q, lengths=lengths):
                return da._reference_paged_decode_attention(
                    q[:, 0], k_pool, v_pool, tables, lengths, scale,
                    BLOCK)[:, None]

            def jax_route(q=q, lengths=lengths):
                gidx = kv_pool.read_indices(tables, BLOCK)
                return da.decode_attention(
                    q[:, 0], da.paged_gather(k_pool, gidx),
                    da.paged_gather(v_pool, gidx), lengths, scale)
        else:
            def kernel(q=q, lengths=lengths):
                return da.paged_verify_attention(
                    q, k_pool, v_pool, tables, lengths, scale, BLOCK)

            def plain(q=q, lengths=lengths):
                return da._reference_paged_verify_attention(
                    q, k_pool, v_pool, tables, lengths, scale, BLOCK)
            jax_route = plain      # the JAX verify is the plain einsum
        out = kernel()
        torch.cuda.synchronize()
        launched = (da.PAGED_DECODE_ATTENTION.launches - before[0],
                    da.PAGED_VERIFY_ATTENTION.launches - before[1])
        assert launched == ((1, 0) if w == 1 else (0, 1)), launched
        if w == 1:
            ref = da._reference_paged_decode_attention(
                q[:, 0].float(), k_f32, v_f32, tables, lengths, scale,
                BLOCK)[:, None]
        else:
            ref = da._reference_paged_verify_attention(
                q.float(), k_f32, v_f32, tables, lengths, scale, BLOCK)
        err, rel = k4_errors(out, ref)
        ok = (err <= K4_TOL and rel <= K4_REL_TOL
              and bool(torch.isfinite(out.float()).all()))
        spans = [min(max(n + w - 1, 1), s) for n in lengths.tolist()]
        nbytes = (sum(spans) * 2 * HKV8 * HD8 * 2 + 2 * 2 * q.numel()
                  + 4 * (b + b * mb))
        span_mask = (torch.arange(s, device='cuda')[None, None, :] <
                     (lengths[:, None] + torch.arange(
                         w, device='cuda')[None, :])[:, :, None])

        def library(q=q, span_mask=span_mask):
            gidx = kv_pool.read_indices(tables, BLOCK)
            kd = da.paged_gather(k_pool, gidx).transpose(1, 2)
            vd = da.paged_gather(v_pool, gidx).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kd, vd, attn_mask=span_mask[:, None],
                scale=scale, enable_gqa=True)

        row = dict(B=b, W=w, block_size=BLOCK, pool_blocks=POOL_BLOCKS,
                   lengths=lengths.tolist(), max_abs_err=err, tol=K4_TOL,
                   max_rel_err=rel, rel_tol=K4_REL_TOL, ok=ok,
                   kernel_ms=graph_ms(torch, kernel, [()], 200),
                   plain_ms=graph_ms(torch, plain, [()], 10),
                   jax_route_ms=graph_ms(torch, jax_route, [()], 50),
                   library_ms=graph_ms(torch, library, [()], 20),
                   library='gather + SDPA (boolean mask, GQA)',
                   bound_ms=1e3 * nbytes / PEAK_HBM_BYTES, bound_by='bytes',
                   device_launches_per_call=k4_one_launch(
                       torch, f'K4P W{w}', kernel))
        row['gbps'] = nbytes / row['kernel_ms'] / 1e6
        row['bound_share'] = row['bound_ms'] / row['kernel_ms']
        log('K4P ' + json.dumps(row))
        rows.append(row)
        del q, out, ref
    # Contiguous tables: row b's blocks are 1 + b*mb .. (b+1)*mb, so the
    # pool holds exactly a dense [B, S] cache.
    k_dense, v_dense = randn(b, s, HKV8, HD8), randn(b, s, HKV8, HD8)
    q = randn(b, HQ, HD8)
    lengths = torch.tensor(lens, dtype=torch.int32, device='cuda')
    kp = torch.cat([torch.zeros_like(k_dense[0, :BLOCK]),
                    k_dense.reshape(b * s, HKV8, HD8)])
    vp = torch.cat([torch.zeros_like(v_dense[0, :BLOCK]),
                    v_dense.reshape(b * s, HKV8, HD8)])
    contiguous = (torch.arange(b * mb, device='cuda', dtype=torch.int32)
                  .reshape(b, mb) + 1)
    dense = da.decode_attention(q, k_dense, v_dense, lengths, scale)
    paged = da.paged_decode_attention(q, kp, vp, contiguous, lengths, scale,
                                      BLOCK)
    torch.cuda.synchronize()
    bit_equal = torch.equal(dense, paged)
    log('K4P_CONTIGUOUS ' + json.dumps(dict(
        bit_equal_to_dense_k4=bit_equal,
        max_abs_diff=(dense.float() - paged.float()).abs().max().item())))
    # K4 inside a captured step: 4 layers (their own q, the pools swapped
    # on odd layers) of decode and verify calls, then a dense call.
    calls = []
    for i in range(4):
        kl, vl = (k_pool, v_pool) if i % 2 == 0 else (v_pool, k_pool)
        for w in (1, 9):
            ql = randn(b, w, HQ, HD8)
            ll = torch.tensor([min(n, s - w + 1) for n in lens],
                              dtype=torch.int32, device='cuda')
            calls.append(lambda ql=ql, kl=kl, vl=vl, ll=ll:
                         da.paged_verify_attention(ql, kl, vl, tables, ll,
                                                   scale, BLOCK))
    calls.append(lambda: da.decode_attention(q, k_dense, v_dense, lengths,
                                             scale))
    graph = k4_graph_check(torch, 'bf16', calls)
    del k_pool, v_pool, k_f32, v_f32, k_dense, v_dense, kp, vp, calls
    torch.cuda.empty_cache()
    # B1 at W 2 and 9; head_dim 64 at groups 1 and 8 (G 8 at W 9 is 72
    # query rows: two passes over the span); a table whose MB * bs is
    # not a whole number of 64-key tiles.
    extra = [_k4_case(torch, F, da, gen, f'B1 W{w}', 1, w, 32, 8, 128,
                      [2000], 8192, paged=True) for w in (2, 9)]
    extra += [_k4_case(torch, F, da, gen, f'hd64 G{g} B1 W9', 1, 9, 32,
                       32 // g, 64, [2000], 8192, paged=True)
              for g in (1, 8)]
    extra.append(_k4_case(torch, F, da, gen, 'hd64 G1 B2 W3 MB37', 2, 3,
                          8, 8, 64, [5, 590], 37 * BLOCK, paged=True))
    bad = [r for r in rows + extra if not r['ok']]
    assert not bad, f'K4-paged disagrees with its plain version: {bad}'
    assert bit_equal, 'K4-paged W=1 is not bit-equal to dense K4'
    main_case, verify = rows
    keys = ('B', 'W', 'max_abs_err', 'max_rel_err', 'kernel_ms', 'plain_ms',
            'jax_route_ms', 'library_ms', 'bound_ms', 'bound_share',
            'device_launches_per_call')
    return dict(max_abs_err=max(r['max_abs_err'] for r in rows),
                max_rel_err=max(r['max_rel_err'] for r in rows + extra),
                ms=main_case['kernel_ms'], plain_ms=main_case['plain_ms'],
                bound_ms=main_case['bound_ms'], bound_by='bytes',
                library_ms=main_case['library_ms'],
                library='gather + SDPA (boolean mask, GQA)',
                jax_route_ms=main_case['jax_route_ms'],
                bound_share=main_case['bound_share'],
                device_launches_per_call=main_case[
                    'device_launches_per_call'],
                bit_equal_to_dense_k4=bit_equal,
                verify={k: verify[k] for k in keys},
                graph=graph,
                cases={r['case']: {k: r[k] for k in (
                    'max_abs_err', 'max_rel_err', 'kernel_ms', 'plain_ms',
                    'library_ms', 'bound_ms', 'bound_share')}
                    for r in extra})


# ---------------------------------------------------------------------
# Engine: numerics at 2 layers, then the --slots 8 replica at 32
# ---------------------------------------------------------------------


def _engine_numerics(torch):
    """llama3-8b widths at 2 layers: the engine's prefill
    (``forward_paged``) first-token logits and the engine's greedy
    tokens, bf16 on the card against f32 on the CPU with the same
    weights and prompts."""
    from skypilot_torch.models import convert, decode, llama
    from skypilot_torch.serve import batching, kv_pool
    config = llama.get_config('llama3-8b', n_layers=2)
    cfg_cpu = dataclasses.replace(config, dtype=torch.float32)
    params = llama.init_params(config, seed=4, device='cuda')
    cpu_params = convert.params_from_numpy(
        convert.params_to_numpy(params), cfg_cpu, device='cpu')
    gen = torch.Generator().manual_seed(23)
    prompts = [torch.randint(0, config.vocab_size, (n,),
                             generator=gen).tolist() for n in (256, 700)]
    n_new, max_seq = 9, 1024

    def first_logits(p, cfg, dev, prompt):
        with torch.inference_mode():
            pool = kv_pool.KVBlockPool(cfg, max_seq // BLOCK + 1, BLOCK,
                                       device=dev)
            row = torch.arange(1, max_seq // BLOCK + 1, dtype=torch.int32,
                               device=dev)
            out = None
            for start in range(0, len(prompt), 512):
                chunk = prompt[start:start + 512]
                out, _ = decode.forward_paged(
                    p, torch.tensor([chunk], device=dev), pool.caches, row,
                    start, len(chunk), cfg, BLOCK)
        return out[0].float().cpu()

    def engine_tokens(p, cfg):
        eng = batching.BatchingEngine(p, cfg, slots=2, max_seq=max_seq)
        try:
            qs = [eng.submit(pr, n_new) for pr in prompts]
            toks = []
            for q in qs:
                out = []
                while (t := q.get(timeout=600)) is not None:
                    assert not isinstance(t, BaseException), t
                    out.append(t)
                toks.append(out)
            return toks
        finally:
            eng.close()

    t0 = time.perf_counter()
    lg = [first_logits(params, config, 'cuda', p) for p in prompts]
    toks_gpu = engine_tokens(params, config)
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lc = [first_logits(cpu_params, cfg_cpu, 'cpu', p) for p in prompts]
    toks_cpu = engine_tokens(cpu_params, cfg_cpu)
    cpu_s = time.perf_counter() - t0
    rel = max(((a - c).abs().max() / c.abs().max()).item()
              for a, c in zip(lg, lc))
    agree = sum(a == c for g, c_ in zip(toks_gpu, toks_cpu)
                for a, c in zip(g, c_))
    row = dict(config='llama3-8b', layers=2, prompts=[len(p) for p in
                                                      prompts],
               first_token_logits_rel_err=rel, rel_tol=E2E_REL_TOL,
               greedy_agree=f'{agree}/{n_new * len(prompts)}',
               gpu_tokens=toks_gpu, cpu_tokens=toks_cpu, gpu_s=gpu_s,
               cpu_s=cpu_s)
    log('ENGINE_NUMERICS ' + json.dumps(row))
    assert all(bool(torch.isfinite(x).all()) for x in lg)
    assert all(len(t) == n_new for t in toks_gpu), toks_gpu
    assert rel <= E2E_REL_TOL, f'engine logits disagree: {row}'
    del params, cpu_params


def _sse_post(port, body, timeout=900, headers=None):
    """POST /generate with ``stream``: (status, prefix headers, ids,
    ms to the first token event, ms to the end)."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request('POST', '/generate', body=json.dumps(body),
                     headers={'Content-Type': 'application/json',
                              **(headers or {})})
        resp = conn.getresponse()
        heads = {h: resp.getheader(h) for h in (
            'X-Skytpu-Prefix-Hits', 'X-Skytpu-Prefix-Misses',
            'X-Skytpu-Adapter-Hits', 'X-Skytpu-Adapter-Loads')}
        ids, first_ms = [], None
        if not body.get('stream'):
            ids = json.loads(resp.read())['output_ids']
        else:
            while True:
                line = resp.readline()
                assert line, 'stream ended without [DONE]'
                line = line.decode().strip()
                if not line.startswith('data: '):
                    assert not line.startswith('event:'), line
                    continue
                if line == 'data: [DONE]':
                    break
                if first_ms is None:
                    first_ms = 1e3 * (time.perf_counter() - t0)
                ids.append(int(line[len('data: '):]))
            resp.read()
        return (resp.status, heads, ids, first_ms,
                1e3 * (time.perf_counter() - t0))
    finally:
        conn.close()


def _prefill_logits(torch, engine, config, tokens, adapters=None, slot=0):
    """The logits [1, V] after ``tokens`` that hit no cached block, as the
    engine's prefill gives them: its chunks (same buckets, same padding,
    same kernels) replayed on a private pool of its kind on its device,
    under the adapter at ``slot`` of ``adapters`` (None: the base
    model)."""
    from skypilot_torch.models import decode
    from skypilot_torch.serve import kv_pool
    dev = engine.device
    n_blk = engine.pool.blocks_for(len(tokens) + 1)
    pool = kv_pool.KVBlockPool(config, n_blk + 1, engine.block_size,
                               kv_int8=engine.kv_int8, device=dev)
    row = torch.zeros(engine.max_blocks_per_req, dtype=torch.int32)
    row[:n_blk] = torch.arange(1, n_blk + 1, dtype=torch.int32)
    row = row.to(dev)
    kw = {} if adapters is None else dict(
        adapters=adapters,
        adapter_idx=torch.tensor([slot], dtype=torch.int32, device=dev))
    off = 0
    with torch.inference_mode():
        while off < len(tokens):
            bucket = engine._chunk_bucket(len(tokens) - off)
            real = min(len(tokens) - off, bucket)
            chunk = tokens[off:off + real] + [0] * (bucket - real)
            logits, _ = decode.forward_paged(
                engine.params, torch.tensor([chunk], device=dev),
                pool.caches, row, off, real, config, engine.block_size,
                **kw)
            off += real
    return logits


def _first_token(torch, engine, config, prompt, knobs=None):
    """The engine's first token for a prompt that hits no cached block:
    the argmax of its prefill logits, as ``_finish_prefill`` takes it
    (``knobs``: the request's temperature, top_p and seed, drawn as
    ``_finish_prefill`` draws a sampled first token)."""
    from skypilot_torch.serve.sampling import sample
    logits = _prefill_logits(torch, engine, config, prompt)
    if knobs is not None:
        return int(sample.sample_first(
            logits, knobs['temperature'], knobs['top_p'],
            _int32(knobs['seed']), len(prompt) - 1))
    return int(logits[0].argmax())


def _int32(seed):
    """A seed as the engine keeps it: the int32 two's complement of
    ``seed mod 2**32``."""
    seed &= 0xFFFFFFFF
    return seed - (1 << 32) if seed >= 1 << 31 else seed


def _draft_prompts(torch, engine, config, rand, need=2, tries=8,
                   knobs=None, label='ENGINE'):
    """Prompts the engine's drafter must draft on at its first decode
    dispatch: ``x + [a, b, c] + y + [a, b]`` where c is the model's own
    first token for that very prompt (found by fixed-point iteration),
    so the stream's trailing trigram (a, b, c) occurred earlier and the
    drafter proposes y. Greedy prefill is deterministic, so the
    replica reproduces c; ``knobs`` (one dict per prompt) draw c as
    the replica draws a seeded sampled first token."""
    found, log_rows = [], []
    for attempt in range(2 * need):
        x, (a, b), y = rand(150 + 20 * attempt), rand(2), rand(140)
        c = rand(1)[0]
        for it in range(tries):
            prompt = x + [a, b, c] + y + [a, b]
            got = _first_token(torch, engine, config, prompt,
                               None if knobs is None
                               else knobs[len(found)])
            if got == c:
                found.append(prompt)
                break
            c = got
        log_rows.append(dict(attempt=attempt, iterations=it + 1,
                             fixed_point=got == c))
        if len(found) == need:
            break
    log(label + '_DRAFT_PROMPTS ' + json.dumps(log_rows))
    assert len(found) == need, 'no fixed-point first token was found'
    return found


# The replica's context lengths of a profiled dispatch's 8 rows, and
# the profiled prefill chunk (positions 512-1023 of a 1024-token prompt).
DISPATCH_CONTEXTS = [17, 64, 256, 1024, 1064, 1114, 1536, 2048]
DISPATCH_PREFILL_START = DISPATCH_PREFILL_ROWS = 512


def engine_dispatches(torch, engine, config, batching, decode,
                      kinds=('decode', 'verify', 'prefill')):
    """The engine's device dispatches of ``kinds`` on its own pool, as
    (kind, fn, extra), and the blocks they hold (give them back with
    ``engine.pool.free``): a decode dispatch (``decode_steps_paged``,
    ``steps_per_dispatch`` tokens), a verify dispatch
    (``verify_step_paged``, ``draft_k + 1`` positions a row), both on 8
    rows at ``DISPATCH_CONTEXTS``, and one prefill chunk
    (``forward_paged``)."""
    dev = engine.device
    lens = DISPATCH_CONTEXTS
    b, w = len(lens), engine.draft_k + 1
    ahead = max(engine.steps, w) if 'verify' in kinds else engine.steps
    held = [engine.pool.alloc(engine.pool.blocks_for(n + ahead))
            for n in lens]
    tables = torch.zeros((b, engine.max_blocks_per_req), dtype=torch.int32)
    for i, bl in enumerate(held):
        tables[i, :len(bl)] = torch.tensor(bl, dtype=torch.int32)
    tables = tables.to(dev)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    tokens = torch.ones(b, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    drafts = torch.ones((b, w), dtype=torch.int32, device=dev)
    n_real = torch.full((b,), w, dtype=torch.int32, device=dev)
    start, rows = DISPATCH_PREFILL_START, DISPATCH_PREFILL_ROWS
    chunk = torch.ones((1, rows), dtype=torch.int32, device=dev)

    def decode_dispatch():
        with torch.inference_mode():
            toks, _, _ = batching.decode_steps_paged(
                engine.params, tokens, engine.caches, tables, pos, active,
                config, engine.steps, engine.block_size)
            toks.cpu()

    def verify_dispatch():
        with torch.inference_mode():
            preds = batching.verify_step_paged(
                engine.params, drafts, engine.caches, tables, pos, n_real,
                config, w, engine.block_size)[0]
            preds.cpu()

    def prefill_chunk():
        with torch.inference_mode():
            out = decode.forward_paged(
                engine.params, chunk, engine.caches, table, start, rows,
                config, engine.block_size)
            (out[0] if isinstance(out, tuple) else out).cpu()

    if 'prefill' in kinds:
        prompt = engine.pool.alloc(engine.pool.blocks_for(start + rows))
        held.append(prompt)
        table = torch.zeros(engine.max_blocks_per_req, dtype=torch.int32)
        table[:len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        table = table.to(dev)
    cases = {'decode': (decode_dispatch,
                        dict(rows=b, steps=engine.steps, lengths=lens)),
             'verify': (verify_dispatch, dict(rows=b, width=w, lengths=lens)),
             'prefill': (prefill_chunk, dict(rows=rows, start=start))}
    return [(k,) + cases[k] for k in kinds], held


def _profile_engine_dispatch(torch, engine, config, batching, label):
    """Where a decode dispatch's time goes: the engine's own step
    (``decode_steps_paged``, ``steps_per_dispatch`` tokens) on its pool,
    8 rows at the replica's context lengths, profiled on the card."""
    from skypilot_torch.models import decode
    [(_, dispatch, extra)], held = engine_dispatches(
        torch, engine, config, batching, decode, kinds=('decode',))
    dispatch()
    profile_cuda(torch, dispatch, label + '_DISPATCH_PROFILE', extra)
    for bl in held:
        engine.pool.free(bl)


# Each engine burst's end-to-end numbers, by label, for the sampled
# burst to print beside the greedy one.
_BURSTS = {}


def _engine_obs(torch, server, engine, published0, traced, results, events,
                n_out, run_s, capture):
    """The replica's observability after the 12-request burst: (b) its
    textfile against the engine's own record, every request's spans under
    its own trace id, the profile armed at the burst's start holding
    K4-paged and K5F rows; (c) the host cost of the instrumentation,
    measured on the live engine from outside the package."""
    from skypilot_torch import metrics as metrics_lib
    from skypilot_torch import trace
    pub = server.publisher
    pub.publish_once()
    published = _prom(pub.path)

    def delta(name):
        return published.get(name, 0.0) - published0.get(name, 0.0)
    verifies = [e for e in events if e[0] == 'verify']
    header_hits = [int(r[1]['X-Skytpu-Prefix-Hits']) for r in results]
    n = len(results)
    got = dict(
        requests=delta('skytpu_batch_requests_total'),
        decode_tokens=delta('skytpu_batch_decode_tokens_total'),
        prefix_hits=delta('skytpu_batch_prefix_hits_total'),
        spec_proposed=delta('skytpu_batch_spec_proposed_total'),
        spec_accepted=delta('skytpu_batch_spec_accepted_total'),
        ttft_count=delta('skytpu_batch_ttft_seconds_count'),
        slots=published['skytpu_batch_slots_total'],
        kv_blocks=published['skytpu_batch_kv_blocks_total'])
    want = dict(requests=n, decode_tokens=sum(len(r[2]) for r in results),
                prefix_hits=sum(header_hits),
                spec_proposed=sum(e[2] for e in verifies),
                spec_accepted=sum(e[3] for e in verifies), ttft_count=n,
                slots=engine.slots, kv_blocks=engine.pool.usable_blocks)
    hbm = {k: published.get(f'skytpu_device_hbm_{k}_bytes{{device=0}}')
           for k in ('used', 'limit', 'peak')}
    # The shared 1024-token prefix: 64 blocks for each request that hit.
    prefix_blocks = 1024 // engine.block_size
    spans = _trace_check(traced)
    L = engine.config.n_layers
    summary, rows, kernel_counts = _kernel_rows('decode', {
        'k4_paged': ['decode_kernel'], 'k5f': ['rope_cache_write_kernel']})
    # (c) The host cost, per call, on the live engine (the counter and
    # gauge updates on scratch families of the same kinds, so the
    # replica's series keep their values).
    scratch = metrics_lib.Registry()
    tok_s = scratch.gauge('skytpu_batch_decode_tokens_per_sec')
    tokens = scratch.counter('skytpu_batch_decode_tokens_total')
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        engine._set_gauges()
    sweep_us = 1e6 * (time.perf_counter() - t0) / reps
    ctx = trace.SpanContext(os.urandom(16).hex(), os.urandom(8).hex())

    def dispatch_updates(parent):
        """What one 8-row decode dispatch adds for observability: the
        profiler's tick, the throughput gauge, a batch.decode span per
        row, the token counter."""
        engine._profiler.on_step()
        t = time.time()
        tok_s.set(64.0)
        for row in range(8):
            trace.record_span('batch.decode', t, t, parent,
                              attrs={'tokens': 8, 'slot': row})
        tokens.inc(64)
    upd = {}
    for tag, parent in (('untraced', None), ('traced', ctx)):
        t0 = time.perf_counter()
        for _ in range(reps):
            dispatch_updates(parent)
        upd[tag] = 1e6 * (time.perf_counter() - t0) / reps
    ticks = 20
    t0 = time.perf_counter()
    for _ in range(ticks):
        pub.publish_once()
    tick_ms = 1e3 * (time.perf_counter() - t0) / ticks
    log('OBS_ENGINE ' + json.dumps(dict(
        published=got, expected=want, hbm_bytes=hbm,
        prefix_hit_requests=sum(h > 0 for h in header_hits),
        spans=spans, profile_steps=summary['steps'],
        profile_kernel_rows=len(rows), profile_launches=kernel_counts,
        textfile_bytes=os.path.getsize(pub.path))))
    # The capture inside the burst: its profiled dispatches, then the
    # stop, export, summary and write on the engine thread.
    window_s = capture['finish'] - capture['start']
    write_s = capture['end'] - capture['finish']
    log('OBS_COST ' + json.dumps(dict(
        card=smi_line(), gauge_sweep_us=sweep_us,
        dispatch_updates_us=upd, publisher_tick_ms=tick_ms,
        burst_tokens_per_s=n_out / run_s,
        burst_tokens_per_s_without_capture_write=n_out / (run_s - write_s),
        capture_window_s=window_s, capture_write_s=write_s,
        reference_burst_tokens_per_s=OBS_REFERENCE_ENGINE_TOKENS_PER_S)))
    assert got == want, (got, want)
    assert got['prefix_hits'] >= prefix_blocks * sum(
        h > 0 for h in header_hits)
    assert all(v is not None and v > 0 for v in hbm.values()), hbm
    assert summary['steps'] == 2 and all(
        c > 0 and c % L == 0 for c in kernel_counts.values()), kernel_counts


def _median(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


def _burst_summary(results, n_out, run_s):
    """A burst's output tokens/s and its median TTFT and TPOT (ms) over
    the streamed requests."""
    return dict(output_tokens_per_s=n_out / run_s,
                ttft_ms_median=_median(r[3] for r in results),
                tpot_ms_median=_median(
                    None if r[3] is None or len(r[2]) < 2
                    else (r[4] - r[3]) / (len(r[2]) - 1)
                    for r in results))


def engine_phase(torch, attention, da, quant=False):
    """The engine slice: numerics at 2 layers, then the port's replica
    at llama3-8b (32 layers, random weights) with ``--slots 8`` and the
    JAX defaults answering 12 concurrent HTTP requests (prompts of
    17-2048 tokens; two sharing a 1024-token prefix, the first admitted
    ahead so the second hits the prefix cache; two built so the drafter
    drafts at their first dispatch, so a verify runs). Launch counts are
    zeroed just before and
    read just after the 12 requests, and must equal the engine's own
    dispatch record. ``quant``: the same burst on ``--quant int8
    --kv-int8`` (int8 weights, an int8 pool: the int8 forms of K4-paged
    and K5 must carry every launch), without the 2-layer numerics (the
    int8 phase has its own).

    The bf16 burst also holds the replica's observability
    (``_engine_obs``): each request carries its own ``traceparent``, the
    replica publishes to ``SKYTPU_METRICS_DIR``, and a profile trigger is
    armed as the burst starts."""
    import gc

    from skypilot_torch.models import llama
    from skypilot_torch.recipes import serve_model
    from skypilot_torch.serve import batching
    from skypilot_torch.utils import profiling
    label = 'ENGINE_Q8' if quant else 'ENGINE'
    obs = not quant
    gc.collect()
    torch.cuda.empty_cache()
    if not quant:
        _engine_numerics(torch)
    gc.collect()
    torch.cuda.empty_cache()
    if obs:
        os.environ['SKYTPU_METRICS_DIR'] = _obs_dir('engine_metrics')
        os.environ['SKYTPU_PROFILE_DIR'] = _obs_dir('engine_profiles')
    args = serve_model.parse_args(
        ['--model', 'llama3-8b', '--port', '0', '--device', 'cuda',
         '--slots', '8'] + (['--quant', 'int8', '--kv-int8'] if quant
                            else []))
    config = llama.get_config(args.model)
    t0 = time.perf_counter()
    server, _ = serve_model.build_server(args)
    setup_s = time.perf_counter() - t0
    engine = server.engine
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        gen = torch.Generator().manual_seed(24)

        def rand(n):
            return torch.randint(0, config.vocab_size, (n,),
                                 generator=gen).tolist()
        drafting = _draft_prompts(torch, engine, config, rand)
        shared = rand(1024)
        # Order of submission: the two drafting prompts first (their
        # first dispatch must have prefill budget left for drafts), the
        # first shared-prefix request once a verify ran, the other nine
        # once that request's prefill (and so its prefix blocks) is done.
        reqs = [{'prompt_ids': p, 'max_new_tokens': 64, 'stream': True}
                for p in drafting]
        reqs.append({'prompt_ids': shared + rand(40), 'max_new_tokens': 48,
                     'stream': True})
        reqs.append({'prompt_ids': shared + rand(90), 'max_new_tokens': 40,
                     'stream': True})
        for i, n in enumerate((17, 64, 256, 512, 1000, 1536, 2048, 700)):
            reqs.append({'prompt_ids': rand(n),
                         'max_new_tokens': 32 + 4 * i,
                         'stream': i % 4 != 1})
        assert len(reqs) == 12
        kernels = _serving_kernels(attention, da)
        torch.cuda.synchronize()
        traced = [(os.urandom(16).hex(), os.urandom(8).hex())
                  for _ in reqs]
        if obs:
            server.publisher.publish_once()
            published0 = _prom(server.publisher.path)
        for k in kernels.values():
            k.launches = 0
        engine.events.clear()
        torch.cuda.reset_peak_memory_stats()
        results = [None] * len(reqs)

        def post(i):
            tid, sid = traced[i]
            results[i] = _sse_post(port, reqs[i], headers={
                'traceparent': f'00-{tid}-{sid}-01'} if obs else None)

        def start(idx):
            for i in idx:
                threads.append(threading.Thread(target=post, args=(i,)))
                threads[-1].start()

        def wait_for(what, pred):
            deadline = time.time() + 600
            while not any(pred(e) for e in list(engine.events)):
                assert time.time() < deadline and \
                    threads[-1].is_alive(), f'never saw {what}'
                time.sleep(0.01)

        threads = []
        if obs:
            capture = _time_capture(engine._profiler)
            profiling.write_trigger(steps=2)
        t_run = time.perf_counter()
        start([0, 1])
        wait_for('a verify dispatch', lambda e: e[0] == 'verify')
        start([2])
        wait_for('the shared prefix prefilled', lambda e: (
            e[0] == 'prefill_chunk' and e[2] == e[3]
            and e[3] == len(reqs[2]['prompt_ids'])))
        start(range(3, len(reqs)))
        for t in threads:
            t.join(timeout=900)
        assert not any(t.is_alive() for t in threads)
        run_s = time.perf_counter() - t_run
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        events = list(engine.events)
        n_verify = sum(e[0] == 'verify' for e in events)
        n_decode = sum(e[0] == 'decode' for e in events) - n_verify
        n_chunks = sum(e[0] == 'prefill_chunk' for e in events)
        L = config.n_layers
        want, record = _serving_identity(kernels, L, events, q8=quant)
        assert record['decode_steps'] == engine.steps * n_decode, record
        n_out = 0
        for (status, heads, ids, ttft, ms), r in zip(results, reqs):
            assert status == 200, status
            assert len(ids) == r['max_new_tokens'], (len(ids), r)
            assert all(0 <= t < config.vocab_size for t in ids)
            n_out += len(ids)
            log(label + '_REQ ' + json.dumps(dict(
                prompt=len(r['prompt_ids']), stream=r['stream'],
                n_out=len(ids), latency_ms=ms, ttft_ms=ttft,
                tpot_ms=None if ttft is None else
                (ms - ttft) / (len(ids) - 1),
                prefix_hits=int(heads['X-Skytpu-Prefix-Hits']),
                prefix_misses=int(heads['X-Skytpu-Prefix-Misses']))))
        hits = int(results[3][1]['X-Skytpu-Prefix-Hits'])
        verifies = [e for e in events if e[0] == 'verify']
        _BURSTS[label] = _burst_summary(results, n_out, run_s)
        log(label + ' ' + json.dumps(dict(
            model=args.model, layers=L, slots=args.slots,
            quant=args.quant, kv_int8=args.kv_int8,
            block_size=engine.block_size, pool_blocks=engine.pool.num_blocks,
            max_seq=engine.max_seq, draft_k=engine.draft_k,
            steps_per_dispatch=engine.steps, setup_s=setup_s, run_s=run_s,
            requests=len(reqs), output_tokens=n_out,
            output_tokens_per_s=n_out / run_s,
            decode_dispatches=n_decode, verify_dispatches=n_verify,
            drafted=sum(e[2] for e in verifies),
            accepted=sum(e[3] for e in verifies), prefill_chunks=n_chunks,
            preemptions=sum(e[0] == 'preempt' for e in events),
            shared_prefix_hits=hits, launches=launches,
            launches_expected=want,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)))
        assert hits > 0, 'the shared 1024-token prefix was not reused'
        assert n_verify > 0, 'no verify dispatch ran'
        assert launches == want, (launches, want)
        if obs:
            _engine_obs(torch, server, engine, published0, traced, results,
                        events, n_out, run_s, capture)
        _profile_engine_dispatch(torch, engine, config, batching, label)
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
        thread.join(timeout=30)
        if obs:
            del os.environ['SKYTPU_METRICS_DIR']
            del os.environ['SKYTPU_PROFILE_DIR']
    assert not thread.is_alive() and not engine.thread.is_alive()
    return launches


# ---------------------------------------------------------------------
# Sampling: keyed sampled decode, sampled verify, grammar masks
# ---------------------------------------------------------------------

# (b): a token may differ between the card and the CPU only where the
# CPU's top-two gap in (gumbel + logit / T) is under this.
SAMPLER_FLIP_GAP = 1e-5
# (c): the chi-square test must not reject at this p.
CHI2_P_MIN = 1e-3
# Upper 0.001 quantiles of chi-square by degrees of freedom (used where
# scipy is absent).
CHI2_999 = {6: 22.458, 10: 29.588}
SAMPLING_SEEDS = [0, 1, -1, 7, -12345, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5,
                  2 ** 32 - 1, 2746413216]


def _sampling_bits(torch):
    """(a) Keys and 32-bit random bits at [128256] for 64 (seed,
    position) pairs, bit-equal between the card and the CPU (the CPU
    path is the one the tests hold to JAX)."""
    from skypilot_torch.serve.sampling import prng
    gen = torch.Generator().manual_seed(31)
    seeds = [_int32(s) for s in SAMPLING_SEEDS] + torch.randint(
        -2 ** 31, 2 ** 31, (54,), generator=gen).tolist()
    pos = [0, 1, 2 ** 31 - 1] + torch.randint(
        0, 8192, (61,), generator=gen).tolist()
    s_cpu = torch.tensor(seeds, dtype=torch.int32)
    p_cpu = torch.tensor(pos, dtype=torch.int32)
    keys_cpu = prng.row_keys(s_cpu, p_cpu)
    keys_gpu = prng.row_keys(s_cpu.cuda(), p_cpu.cuda())
    keys_equal = torch.equal(keys_gpu.cpu(), keys_cpu)
    v = 128256
    bits_equal, t_ms = True, 0.0
    for lo in range(0, 64, 16):
        cpu = prng.random_bits(keys_cpu[lo:lo + 16], (v,))
        t0 = time.perf_counter()
        gpu = prng.random_bits(keys_gpu[lo:lo + 16], (v,))
        torch.cuda.synchronize()
        t_ms += 1e3 * (time.perf_counter() - t0)
        bits_equal &= torch.equal(gpu.cpu(), cpu)
    row = dict(pairs=64, vocab=v, keys_equal=keys_equal,
               bits_equal=bits_equal, gpu_bits_ms_64_rows=t_ms)
    log('SAMPLING_BITS ' + json.dumps(row))
    assert keys_equal and bits_equal, row


def _sampler_gaps(torch, logits, temps, tops, seeds, pos, allowed):
    """The CPU's top-two gap of the quantity each row's token is the
    argmax of: the logits for greedy rows, gumbel + filtered logit / T
    for sampled rows."""
    from skypilot_torch.serve.sampling import prng
    from skypilot_torch.serve.sampling import sample
    x = logits.float()
    if allowed is not None:
        x = torch.where(allowed, x, sample.NEG_INF)
    filt = sample._filter_top_p_row(x, tops)
    noise = prng.gumbel(prng.row_keys(seeds, pos), (x.shape[-1],))
    score = noise + filt / torch.clamp_min(temps, 1e-6)[:, None]
    score = torch.where((temps <= 0)[:, None], x, score)
    top2 = score.topk(2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


def _sampling_sampler(torch):
    """(b) ``sample_rows`` on [8, V] and ``verify_targets`` on [8, 9, V]
    seeded f32 logits, temperatures {0, 0.7, 1.0}, top_p {1.0, 0.9} and
    two masked rows: the card's tokens against the CPU's, flips allowed
    only under ``SAMPLER_FLIP_GAP``."""
    from skypilot_torch.serve.sampling import sample
    v = 128256
    gen = torch.Generator().manual_seed(32)
    temps = torch.tensor([0.0, 0.7, 1.0, 0.7, 1.0, 0.0, 1.0, 0.7])
    tops = torch.tensor([1.0, 0.9, 1.0, 1.0, 0.9, 0.9, 0.9, 1.0])
    seeds = torch.tensor([_int32(s) for s in SAMPLING_SEEDS[:8]],
                         dtype=torch.int32)
    pos = torch.randint(0, 8192, (8,), generator=gen, dtype=torch.int32)
    rows = []
    for w in (None, 9):
        shape = (8, v) if w is None else (8, w, v)
        logits = 3.0 * torch.randn(shape, generator=gen)
        allowed = torch.ones(shape, dtype=torch.bool)
        allowed[1] = torch.rand(shape[1:], generator=gen) < 0.3
        allowed[6] = torch.rand(shape[1:], generator=gen) < 0.3
        args = (logits, temps, tops, seeds, pos, allowed)
        fn = sample.sample_rows if w is None else sample.verify_targets
        cpu = fn(*args)
        t0 = time.perf_counter()
        gpu = fn(*[a.cuda() for a in args])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        gpu = gpu.cpu()
        if w is None:
            gaps = _sampler_gaps(torch, logits, temps, tops, seeds, pos,
                                 allowed)
        else:
            per = lambda x: x[:, None].expand(8, w).reshape(-1)  # noqa
            gaps = _sampler_gaps(
                torch, logits.reshape(-1, v), per(temps), per(tops),
                per(seeds), (pos[:, None] + torch.arange(w)).reshape(-1),
                allowed.reshape(-1, v)).reshape(8, w)
        flips = gpu != cpu
        row = dict(shape=list(shape), tokens=int(cpu.numel()),
                   flips=int(flips.sum()),
                   flip_gaps=gaps[flips].tolist(),
                   min_gap=float(gaps.min()), first_call_ms=ms,
                   masked_in_support=bool(
                       allowed.reshape(-1, v)[
                           torch.arange(cpu.numel()),
                           gpu.reshape(-1).long()].all()))
        log('SAMPLING_SAMPLER ' + json.dumps(row))
        rows.append(row)
        assert bool((gaps[flips] < SAMPLER_FLIP_GAP).all()), row
        assert row['masked_in_support'], row
    return rows


def _chi2_p(stat, df):
    try:
        from scipy import stats
    except ImportError:
        return None
    return float(stats.chi2.sf(stat, df))


def _sampling_chi2(torch):
    """(c) 4096 draws (one request's positions 0..4095, one seed) from a
    peaked [128256] row on the card against softmax of the filtered
    logits: ten head tokens and the tail as one bin; at T 0.7 and top_p
    0.9 the nucleus (taken at T 1, as the sampler takes it) keeps seven
    heads."""
    import numpy as np

    from skypilot_torch.serve.sampling import sample
    v, n = 128256, 4096
    heads = np.asarray([0.3, 0.2, 0.15, 0.1, 0.07, 0.05, 0.04, 0.03, 0.02,
                        0.01])
    probs = np.full(v, (1 - heads.sum()) / (v - len(heads)))
    probs[:len(heads)] = heads
    logits = torch.tensor(np.log(probs), dtype=torch.float32).cuda()
    out = []
    one = lambda x, dt=torch.float32: torch.tensor(  # noqa: E731
        [x], dtype=dt, device='cuda')
    for temp, top_p in ((1.0, 1.0), (0.7, 0.9)):
        toks = []
        for lo in range(0, n, 512):
            m = min(512, n - lo)
            toks.append(sample.sample_rows(
                logits[None].expand(m, v),
                torch.full((m,), temp, device='cuda'),
                torch.full((m,), top_p, device='cuda'),
                torch.full((m,), 17, dtype=torch.int32, device='cuda'),
                torch.arange(lo, lo + m, dtype=torch.int32,
                             device='cuda')).cpu())
        toks = torch.cat(toks).numpy()
        # Softmax of the logits as the sampler filters them, in f64.
        filt = sample._filter_top_p_row(logits[None], one(top_p))[0]
        keep = (filt > sample.NEG_INF).cpu().numpy()
        z = filt.cpu().double().numpy() / temp
        p = np.where(keep, np.exp(z - z.max()), 0.0)
        p /= p.sum()
        bins = np.append(p[:len(heads)], p[len(heads):].sum())
        counts = np.append(np.bincount(np.minimum(toks, len(heads)),
                                       minlength=len(heads) + 1)[:-1],
                           (toks >= len(heads)).sum()).astype(float)
        live = bins > 0
        assert counts[~live].sum() == 0, (temp, top_p, counts)
        exp = bins[live] * n
        stat = float(((counts[live] - exp) ** 2 / exp).sum())
        df = int(live.sum()) - 1
        pval = _chi2_p(stat, df)
        row = dict(temperature=temp, top_p=top_p, draws=n, bins=int(
            live.sum()), df=df, chi2=stat, p_value=pval,
            counts=counts[live].tolist(), expected=exp.tolist())
        log('SAMPLING_CHI2 ' + json.dumps(row))
        if pval is not None:
            assert pval >= CHI2_P_MIN, row
        else:
            assert stat < CHI2_999[df], row
        out.append(row)
    return out


def _grammar_vocab(torch, vocab_size, eos_id):
    """A synthetic token-text table for llama3's 128256 ids, made from a
    seed: a JSON lexicon at the first ids, no text at ``eos_id``, and
    random 1-6 character strings elsewhere (some of which a grammar
    takes)."""
    lexicon = (list('0123456789{}[],:"abtrufelsn') +
               ['true', 'false', 'null', '{"', '":', '",', '"}'])
    alphabet = list('0123456789abcdefghijklmnopqrstuvwxyz{}[],:" -_.')
    gen = torch.Generator().manual_seed(33)
    lens = torch.randint(1, 7, (vocab_size,), generator=gen).tolist()
    picks = torch.randint(0, len(alphabet), (vocab_size * 6,),
                          generator=gen).tolist()
    vocab = [''.join(alphabet[c] for c in picks[6 * i:6 * i + lens[i]])
             for i in range(vocab_size)]
    vocab[1:1 + len(lexicon)] = lexicon
    vocab[0] = None
    vocab[eos_id] = None
    return vocab


SAMPLING_REGEX = r'\{"id":[0-9]{1,3},"ok":(true|false)\}'
SAMPLING_SCHEMA = {'type': 'object', 'properties': {
    'name': {'enum': ['ab', 'ba']}, 'flag': {'type': 'boolean'},
    'xs': {'type': 'array', 'items': {'type': 'boolean'},
           'maxItems': 2}}}


def _profile_sampled_dispatch(torch, engine, config, batching):
    """A sampled decode dispatch (the engine's step, 8 rows at the
    replica's context lengths, every row sampled, no mask) beside the
    greedy one, and the sampler alone at [8, V] profiled on the card:
    the sampler's share of the sampled dispatch's busy time."""
    from skypilot_torch.serve.sampling import sample
    lens = [17, 64, 256, 1024, 1064, 1114, 1536, 2048]
    b = len(lens)
    blocks = [engine.pool.alloc(engine.pool.blocks_for(n + engine.steps))
              for n in lens]
    tables = torch.zeros((b, engine.max_blocks_per_req), dtype=torch.int32)
    for i, bl in enumerate(blocks):
        tables[i, :len(bl)] = torch.tensor(bl, dtype=torch.int32)
    tables = tables.cuda()
    pos = torch.tensor(lens, dtype=torch.int32, device='cuda')
    tokens = torch.ones(b, dtype=torch.int32, device='cuda')
    active = torch.ones(b, dtype=torch.bool, device='cuda')
    knobs = dict(
        temps=torch.tensor([0.7, 1.0] * 4, device='cuda'),
        top_ps=torch.tensor([0.9, 1.0] * 4, device='cuda'),
        seeds=torch.arange(b, dtype=torch.int32, device='cuda'),
        mask_table=engine._mask_table,
        mask_idx=torch.zeros(b, dtype=torch.int32, device='cuda'))

    def dispatch(sampling):
        with torch.inference_mode():
            toks, _, _ = batching.decode_steps_paged(
                engine.params, tokens, engine.caches, tables, pos, active,
                config, engine.steps, engine.block_size, sampling=sampling)
            toks.cpu()
    extra = dict(rows=b, steps=engine.steps, lengths=lens)
    busy = {}
    for name, sampling in (('greedy', None), ('sampled', knobs)):
        dispatch(sampling)
        busy[name] = profile_cuda(
            torch, lambda s=sampling: dispatch(s),
            f'SAMPLING_DISPATCH_PROFILE_{name.upper()}', extra)
    logits = 3.0 * torch.randn(b, config.vocab_size, device='cuda')
    reps = 16

    def sampler():
        for _ in range(reps):
            sample.sample_rows(logits, knobs['temps'], knobs['top_ps'],
                               knobs['seeds'], pos,
                               sample.gather_masks(knobs['mask_table'],
                                                   knobs['mask_idx']))
        torch.cuda.synchronize()
    sampler()
    sampler_busy = profile_cuda(torch, sampler, 'SAMPLING_SAMPLER_PROFILE',
                                dict(rows=b, vocab=config.vocab_size,
                                     calls=reps))
    per_call = sampler_busy / reps
    row = dict(sampler_ms_per_step=per_call, steps=engine.steps,
               sampled_dispatch_busy_ms=busy['sampled'],
               greedy_dispatch_busy_ms=busy['greedy'],
               sampler_share=engine.steps * per_call / busy['sampled'],
               busy_difference_share=(busy['sampled'] - busy['greedy']) /
               busy['sampled'])
    log('SAMPLING_SHARE ' + json.dumps(row))
    for bl in blocks:
        engine.pool.free(bl)
    return row


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def sampling_phase(torch, attention, da):
    """The sampling slice: (a) keys and bits, (b) the sampler on the same
    logits, (c) the chi-square test, then (d) the ``--slots 8`` replica
    at llama3-8b (32 layers, random weights) with a synthetic 128256-id
    grammar vocab answering 12 concurrent requests: 4 greedy, 6 sampled
    (two built to draft, so sampled verify runs) and 2 constrained (a
    regex and a json_schema). Launch counts are zeroed just before and
    read just after, and must equal the engine's dispatch record; every
    request is answered, every constrained output keeps its DFA alive
    and, where it ended in EOS, full-matches. Printed: the burst's
    tokens/s, TTFT and TPOT beside the greedy ENGINE burst's, the
    sampler's share of a sampled dispatch, the grammar mask build per
    new DFA state (timed where the engine builds it in the burst), the
    verify mask table's bytes, each seeded sampled request re-run alone
    on the same engine (batch invariance) and alone on a
    ``--speculative off`` engine with a fresh pool (for the two drafting
    ones, spec-on against spec-off)."""
    import gc
    import os
    import re
    import tempfile

    from skypilot_torch.models import llama
    from skypilot_torch.recipes import serve_model
    from skypilot_torch.serve import batching
    from skypilot_torch.serve.sampling import grammar
    t_phase = time.perf_counter()
    _sampling_bits(torch)
    _sampling_sampler(torch)
    _sampling_chi2(torch)
    gc.collect()
    torch.cuda.empty_cache()
    config = llama.get_config('llama3-8b')
    eos = 128009
    vocab = _grammar_vocab(torch, config.vocab_size, eos)
    tmp = tempfile.mkdtemp(prefix='skypilot_sampling_')
    vocab_path = os.path.join(tmp, 'vocab.json')
    with open(vocab_path, 'w', encoding='utf-8') as f:
        json.dump(vocab, f)
    args = serve_model.parse_args(
        ['--model', 'llama3-8b', '--port', '0', '--device', 'cuda',
         '--slots', '8', '--grammar-vocab', vocab_path])
    t0 = time.perf_counter()
    server, _ = serve_model.build_server(args)
    setup_s = time.perf_counter() - t0
    engine = server.engine
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    spec_off = None
    try:
        gen = torch.Generator().manual_seed(34)

        def rand(n):
            return torch.randint(0, config.vocab_size, (n,),
                                 generator=gen).tolist()
        knobs = [dict(temperature=0.7, top_p=0.9, seed=1001),
                 dict(temperature=1.0, top_p=1.0, seed=2 ** 31 + 1002),
                 dict(temperature=0.7, top_p=1.0, seed=-1003),
                 dict(temperature=1.0, top_p=0.9, seed=1004),
                 dict(temperature=0.7, top_p=0.9, seed=1005),
                 dict(temperature=1.0, top_p=0.9, seed=1006)]
        drafting = _draft_prompts(torch, engine, config, rand,
                                  knobs=knobs[:2], label='SAMPLING')
        reqs = [dict({'prompt_ids': p, 'max_new_tokens': 48,
                      'stream': True}, **k)
                for p, k in zip(drafting, knobs[:2])]
        for i, (n, k) in enumerate(zip((64, 300, 1000, 17), knobs[2:])):
            reqs.append(dict({'prompt_ids': rand(n),
                              'max_new_tokens': 32 + 4 * i,
                              'stream': i % 2 == 0}, **k))
        for i, n in enumerate((40, 256, 700, 1536)):
            reqs.append({'prompt_ids': rand(n), 'max_new_tokens': 32 + 4 * i,
                         'stream': i % 2 == 1})
        constrained = [
            ({'type': 'regex', 'pattern': SAMPLING_REGEX},
             dict(temperature=0.8, seed=77)),
            ({'type': 'json_schema', 'schema': SAMPLING_SCHEMA},
             dict(temperature=1.0, top_p=0.9, seed=78))]
        for (rf, k), n in zip(constrained, (90, 500)):
            reqs.append(dict({'prompt_ids': rand(n), 'max_new_tokens': 48,
                              'stream': True, 'eos_id': eos,
                              'response_format': rf}, **k))
        assert len(reqs) == 12
        kernels = _serving_kernels(attention, da)
        # The grammar mask build per new DFA state, timed where the
        # engine builds it during the burst (a mask not cached yet).
        builds = []
        allowed = grammar.CompiledGrammar.allowed

        def timed_allowed(g, state):
            if state is None or state in g._masks:
                return allowed(g, state)
            t0 = time.perf_counter()
            mask = allowed(g, state)
            builds.append(1e3 * (time.perf_counter() - t0))
            return mask
        grammar.CompiledGrammar.allowed = timed_allowed
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        engine.events.clear()
        results = [None] * len(reqs)

        def post(i):
            results[i] = _sse_post(port, reqs[i])

        threads = []

        def start(idx):
            for i in idx:
                threads.append(threading.Thread(target=post, args=(i,)))
                threads[-1].start()

        t_run = time.perf_counter()
        start([0, 1])
        deadline = time.time() + 600
        while not any(e[0] == 'verify' for e in list(engine.events)):
            assert time.time() < deadline and threads[-1].is_alive(), \
                'no sampled verify dispatch ran'
            time.sleep(0.01)
        start(range(2, len(reqs)))
        for t in threads:
            t.join(timeout=900)
        assert not any(t.is_alive() for t in threads)
        run_s = time.perf_counter() - t_run
        torch.cuda.synchronize()
        grammar.CompiledGrammar.allowed = allowed
        launches = {name: k.launches for name, k in kernels.items()}
        events = list(engine.events)
        n_verify = sum(e[0] == 'verify' for e in events)
        steps = sum(e[2] for e in events if e[0] == 'decode' and len(e) == 3)
        n_decode = sum(e[0] == 'decode' and len(e) == 3 for e in events)
        n_chunks = sum(e[0] == 'prefill_chunk' for e in events)
        L = config.n_layers
        want, _ = _serving_identity(kernels, L, events)
        # The nucleus threshold runs once per sampled forward: its count
        # is data-dependent (a dispatch samples while a sampled row is
        # admitted), so it is held to be positive, not to a formula.
        assert launches['top_p_kth'] > 0, launches
        want['top_p_kth'] = launches['top_p_kth']
        n_out, outs = 0, []
        for (status, heads, ids, ttft, ms), r in zip(results, reqs):
            assert status == 200, (status, r.get('response_format'))
            assert all(0 <= t < config.vocab_size for t in ids)
            if 'response_format' not in r:
                assert len(ids) == r['max_new_tokens'], (len(ids), r)
            n_out += len(ids)
            outs.append(ids)
            kind = ('constrained' if 'response_format' in r else
                    'sampled' if r.get('temperature') else 'greedy')
            log('SAMPLING_REQ ' + json.dumps(dict(
                kind=kind, prompt=len(r['prompt_ids']), stream=r['stream'],
                n_out=len(ids), latency_ms=ms, ttft_ms=ttft,
                tpot_ms=None if ttft is None or len(ids) < 2 else
                (ms - ttft) / (len(ids) - 1))))
        # Constrained outputs: every prefix keeps the DFA alive; an
        # output that ended in EOS full-matches its pattern.
        checks = []
        for (rf, _), ids in zip(constrained, outs[-2:]):
            g = grammar.compile_grammar(rf, engine._grammar_vocab, eos)
            st, alive = g.start, True
            for t in ids:
                st = g.advance(st, t)
                alive &= st is not None
            text = ''.join(vocab[t] or '' for t in ids if t != eos)
            pattern = (rf['pattern'] if rf['type'] == 'regex'
                       else grammar.schema_to_regex(rf['schema']))
            ended = bool(ids) and ids[-1] == eos
            full = re.fullmatch(pattern, text) is not None
            checks.append(dict(type=rf['type'], n_out=len(ids), text=text,
                               ended_in_eos=ended, dfa_alive=alive,
                               full_match=full))
            assert alive, checks[-1]
            assert full or not ended, checks[-1]
        verifies = [e for e in events if e[0] == 'verify']
        summary = _burst_summary(results, n_out, run_s)
        log('SAMPLING ' + json.dumps(dict(
            model=args.model, layers=L, slots=args.slots,
            block_size=engine.block_size, draft_k=engine.draft_k,
            steps_per_dispatch=engine.steps, setup_s=setup_s, run_s=run_s,
            requests=len(reqs), output_tokens=n_out, **summary,
            decode_dispatches=n_decode, decode_steps=steps,
            verify_dispatches=n_verify,
            drafted=sum(e[2] for e in verifies),
            accepted=sum(e[3] for e in verifies), prefill_chunks=n_chunks,
            preemptions=sum(e[0] == 'preempt' for e in events),
            constrained=checks, launches=launches,
            launches_expected=want)))
        assert n_verify > 0, 'no sampled verify dispatch ran'
        assert launches == want, (launches, want)
        log('SAMPLING_VS_ENGINE ' + json.dumps(dict(
            sampled_burst=summary,
            greedy_engine_burst=_BURSTS.get('ENGINE', 'not measured'))))
        w = engine.draft_k + 1
        log('SAMPLING_VERIFY_MASK ' + json.dumps(dict(
            table_shape=[engine.slots + 1, w, config.vocab_size],
            bytes_per_dispatch_with_a_constrained_row=(
                (engine.slots + 1) * w * config.vocab_size),
            note='bool table uploaded by each verify dispatch while a '
                 'constrained row is admitted')))
        log('SAMPLING_GRAMMAR ' + json.dumps(dict(
            vocab=config.vocab_size, new_states=len(builds),
            build_ms_total=sum(builds),
            ms_per_new_state=sum(builds) / max(len(builds), 1),
            ms_max=max(builds, default=None), burst_run_s=run_s)))
        # Batch invariance on the card: each seeded sampled request alone
        # on the same engine.
        inv, alone = [], []
        for i, r in enumerate(reqs[:6]):
            alone.append(engine.generate(
                r['prompt_ids'], r['max_new_tokens'],
                temperature=r['temperature'], top_p=r['top_p'],
                seed=r['seed']))
            inv.append(dict(request=i, drafting=i < 2,
                            equal=alone[i] == outs[i],
                            first_divergence=_first_divergence(alone[i],
                                                               outs[i])))
        log('SAMPLING_INVARIANCE ' + json.dumps(inv))
        assert all(r['equal'] for r in inv), ('a seeded request differs '
                                              'from its run alone', inv)
        # Spec-on vs spec-off: the seeded sampled requests, each alone on
        # an engine with speculation off (same weights, a fresh pool, so
        # no prefix-cache hit either); the two drafting ones are the
        # spec-on/spec-off pair.
        spec_off = batching.BatchingEngine(
            engine.params, config, slots=args.slots, speculative=False,
            grammar_vocab=vocab)
        spec = []
        for i, r in enumerate(reqs[:6]):
            off = spec_off.generate(r['prompt_ids'], r['max_new_tokens'],
                                    temperature=r['temperature'],
                                    top_p=r['top_p'], seed=r['seed'])
            spec.append(dict(request=i, drafting=i < 2,
                             equal=off == outs[i],
                             first_divergence=_first_divergence(off,
                                                                outs[i]),
                             equal_to_alone=off == alone[i]))
        log('SAMPLING_SPEC_OFF ' + json.dumps(spec))
        assert all(r['equal'] for r in spec), ('a request differs from '
                                               'its spec-off run', spec)
        _profile_sampled_dispatch(torch, engine, config, batching)
    finally:
        if spec_off is not None:
            spec_off.close()
        server.shutdown()
        server.server_close()
        engine.close()
        thread.join(timeout=30)
    assert not thread.is_alive() and not engine.thread.is_alive()
    log(f'SAMPLING_PHASE_S {time.perf_counter() - t_phase:.1f}')
    return launches


# ---------------------------------------------------------------------
# Adapters: multi-LoRA and overload control through the engine
# ---------------------------------------------------------------------

# The lineages' ranks: 'a' and 'b' preloaded, 'c' cold, 'big' over the
# engine's rank bucket (16).
ADAPTER_RANKS = {'a': 8, 'b': 16, 'c': 16, 'big': 32}
# Factor std: at llama3-8b a rank-16 delta on q and v comes to ~0.5 of
# the base projections' unit scale (B carries the registry's x2 too).
ADAPTER_FACTOR_STD = 0.03


def _write_lineages(torch, base, config, ranks, seed):
    """One committed lineage per adapter under ``base``, written through
    the port's ``checkpoint`` copies (the JAX writer's format): q/v LoRA
    factors from a seed, 'a' in bf16 and the rest in f32."""
    import os

    from skypilot_torch import checkpoint
    gen = torch.Generator().manual_seed(seed)
    L, d = config.n_layers, config.dim
    outs = {'wq': config.n_heads * config.head_dim,
            'wv': config.n_kv_heads * config.head_dim}
    for name, r in ranks.items():
        factors = {}
        for proj, out in outs.items():
            factors[f'{proj}_a'] = torch.randn(
                (L, d, r), generator=gen) * ADAPTER_FACTOR_STD
            factors[f'{proj}_b'] = torch.randn(
                (L, r, out), generator=gen) * ADAPTER_FACTOR_STD
        if name == 'a':
            factors = {k: v.bfloat16() for k, v in factors.items()}
        checkpoint.save_tree(os.path.join(base, name), 1,
                             {'lora': factors})


def _adapter_shapes(config):
    return (config.n_layers, config.dim, config.n_heads * config.head_dim,
            config.n_kv_heads * config.head_dim)


def _logits_after(torch, engine, config, tokens, adapters=None, slot=0):
    """``_prefill_logits`` as [V] f32 on the host."""
    return _prefill_logits(torch, engine, config, tokens, adapters,
                           slot)[0].float().cpu()


def _solo_check(torch, label, engine, config, reqs, outs, registry,
                solo_engine=None):
    """Rule (b): each request re-run alone (on ``solo_engine``, default
    the same engine) must give the burst's tokens exactly: the engine's
    rows are batch-invariant on the card. A divergence is printed with
    its position and the solo run's top-two logit gap there (recomputed
    by the engine's prefill path under its adapter), then fails the
    run; returns the rows."""
    from skypilot_torch.serve.adapters import ResidentAdapterSet
    solo_engine = solo_engine or engine
    sets, rows = {}, []
    for i, (r, out) in enumerate(zip(reqs, outs)):
        adapter = r.get('adapter')
        solo = solo_engine.generate(r['prompt_ids'], r['max_new_tokens'],
                                    adapter=adapter)
        p = _first_divergence(solo, out)
        row = dict(request=i, adapter=adapter, equal=p is None,
                   first_divergence=p)
        if p is not None:
            assert p < len(solo) and p < len(out), (label, i, solo, out)
            kw = {}
            if adapter is not None:
                if adapter not in sets:
                    sets[adapter] = ResidentAdapterSet(
                        registry, 1, _adapter_shapes(config),
                        device=engine.device)
                    sets[adapter].preload([adapter])
                kw = dict(adapters=sets[adapter].buffers(), slot=1)
            top = _logits_after(torch, engine, config,
                                r['prompt_ids'] + solo[:p], **kw).topk(2)
            row.update(solo_token=solo[p], burst_token=out[p],
                       top2_gap=float(top.values[0] - top.values[1]),
                       recomputed_argmax=int(top.indices[0]))
            log(f'{label}_DIVERGENCE ' + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r['equal']]
    assert not bad, (label, bad)
    return rows


def _adapter_numerics(torch, dev, model):
    """(g): llama3-8b widths at 2 layers with 2-layer adapters 'a' and
    'b' (and the base model), bf16 on the card against f32 on the CPU
    (the plain paths): first-token logits of ``forward_paged`` under each
    adapter within ``E2E_REL_TOL``, and each adapter's logits differing
    from the base's."""
    import shutil
    import tempfile

    from skypilot_torch.models import convert, decode, llama
    from skypilot_torch.serve import kv_pool
    from skypilot_torch.serve.adapters import (AdapterRegistry,
                                               ResidentAdapterSet)
    config = llama.get_config(model, n_layers=2)
    cfg_cpu = dataclasses.replace(config, dtype=torch.float32)
    params = llama.init_params(config, seed=5, device=dev)
    cpu_params = convert.params_from_numpy(
        convert.params_to_numpy(params), cfg_cpu, device='cpu')
    tmp = tempfile.mkdtemp(prefix='skypilot_adapters2_')
    try:
        _write_lineages(torch, tmp, config, {'a': 8, 'b': 16}, seed=46)
        reg = AdapterRegistry(base_dir=tmp)
        sets = {}
        for d in (dev, 'cpu'):
            sets[d] = ResidentAdapterSet(reg, 2, _adapter_shapes(config),
                                         device=d)
            sets[d].preload(['a', 'b'])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen = torch.Generator().manual_seed(47)
    prompt = torch.randint(0, config.vocab_size, (300,),
                           generator=gen).tolist()
    n_blk = -(-len(prompt) // BLOCK) + 1

    def logits(p, cfg, d, name):
        slot = 0 if name == 'base' else sets[d].slot(name)
        with torch.inference_mode():
            pool = kv_pool.KVBlockPool(cfg, n_blk + 1, BLOCK, device=d)
            row = torch.arange(1, n_blk + 1, dtype=torch.int32, device=d)
            out = None
            for start in range(0, len(prompt), 256):
                chunk = prompt[start:start + 256]
                out, _ = decode.forward_paged(
                    p, torch.tensor([chunk], device=d), pool.caches, row,
                    start, len(chunk), cfg, BLOCK,
                    adapters=sets[d].buffers(),
                    adapter_idx=torch.tensor([slot], dtype=torch.int32,
                                             device=d))
        return out[0].float().cpu()
    rows = {}
    for name in ('base', 'a', 'b'):
        g = logits(params, config, dev, name)
        c = logits(cpu_params, cfg_cpu, 'cpu', name)
        assert bool(torch.isfinite(g).all())
        rows[name] = dict(rel_err=((g - c).abs().max() /
                                   c.abs().max()).item(), gpu=g, cpu=c)
    row = dict(config=model, layers=2, prompt=len(prompt),
               rel_tol=E2E_REL_TOL,
               rel_err={k: v['rel_err'] for k, v in rows.items()},
               delta_vs_base={k: (rows[k]['cpu'] - rows['base']['cpu']
                                  ).abs().max().item() for k in ('a', 'b')})
    log('ADAPTERS_NUMERICS ' + json.dumps(row))
    assert all(v <= E2E_REL_TOL for v in row['rel_err'].values()), row
    assert all(v > 1e-2 for v in row['delta_vs_base'].values()), row
    del params, cpu_params


def _http(port, body, headers=None, timeout=900):
    """POST /generate (not streamed): (status, response headers, body)."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        conn.request('POST', '/generate', body=json.dumps(body),
                     headers=dict({'Content-Type': 'application/json'},
                                  **(headers or {})))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def _engine_post(engine, body):
    """The engine's answer to a request body without HTTP, timed as
    ``_sse_post`` times a stream: (200, {}, ids, ms to the first token,
    ms to the end)."""
    t0 = time.perf_counter()
    req = engine.submit_request(body['prompt_ids'], body['max_new_tokens'],
                                adapter=body.get('adapter'))
    ids, first_ms = [], None
    while (t := req.out.get(timeout=900)) is not None:
        assert not isinstance(t, BaseException), t
        if first_ms is None:
            first_ms = 1e3 * (time.perf_counter() - t0)
        ids.append(t)
    return 200, {}, ids, first_ms, 1e3 * (time.perf_counter() - t0)


def _staged_burst(engine, reqs, post):
    """The adapter burst's submission order: request 0 (base, the shared
    prefix) first; request 1 (the same prefix under 'a') once 0's
    prefill is done; request 2 (again under 'a') once 1's is; then the
    rest at once. Returns (results, wall seconds)."""
    results = [None] * len(reqs)
    threads = []

    def run(i):
        results[i] = post(reqs[i])

    def start(idx):
        for i in idx:
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()

    def prefilled(i):
        n = len(reqs[i]['prompt_ids'])
        deadline = time.time() + 600
        while not any(e[0] == 'prefill_chunk' and e[2] == e[3] == n
                      for e in list(engine.events)):
            assert time.time() < deadline and threads[-1].is_alive(), \
                f'request {i} never finished its prefill'
            time.sleep(0.005)

    t0 = time.perf_counter()
    start([0])
    prefilled(0)
    start([1])
    prefilled(1)
    start(range(2, len(reqs)))
    for t in threads:
        t.join(timeout=900)
    assert not any(t.is_alive() for t in threads)
    return results, time.perf_counter() - t0


def _profile_lora(torch, engine, config, batching, card):
    """The LoRA delta's cost in a decode dispatch: the engine's step (8
    rows at the replica's context lengths, ``steps_per_dispatch`` steps)
    without an adapter set and with every row on an adapter slot,
    profiled on the card, and ``lora_gather_delta`` alone (q and v, every
    layer, one step's worth at [8, 1, 4096] bf16): its device time and,
    unprofiled, its wall time (launch-bound on the host)."""
    from skypilot_torch.models import decode
    lens = [17, 64, 256, 1024, 1064, 1114, 1536, 2048]
    b = len(lens)
    blocks = [engine.pool.alloc(engine.pool.blocks_for(n + engine.steps))
              for n in lens]
    tables = torch.zeros((b, engine.max_blocks_per_req), dtype=torch.int32)
    for i, bl in enumerate(blocks):
        tables[i, :len(bl)] = torch.tensor(bl, dtype=torch.int32)
    dev = engine.device
    tables = tables.to(dev)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    tokens = torch.ones(b, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    bufs = engine._adapters.buffers()
    idx = torch.tensor([1, 2] * 4, dtype=torch.int32, device=dev)

    def dispatch(kw):
        with torch.inference_mode():
            toks, _, _ = batching.decode_steps_paged(
                engine.params, tokens, engine.caches, tables, pos, active,
                config, engine.steps, engine.block_size, **kw)
            toks.cpu()
    extra = dict(rows=b, steps=engine.steps, lengths=lens)
    busy = {}
    for name, kw in (('base', {}),
                     ('adapters', dict(adapters=bufs, adapter_idx=idx))):
        dispatch(kw)
        busy[name] = profile_cuda(
            torch, lambda k=kw: dispatch(k),
            f'ADAPTERS_DISPATCH_PROFILE_{name.upper()}', extra)
    h = torch.randn((b, 1, config.dim), device=dev).to(config.dtype)
    layers = decode.adapter_layers(bufs, config.n_layers)
    reps = 4

    def deltas():
        with torch.inference_mode():
            for _ in range(reps):
                for ad in layers:
                    decode.lora_gather_delta(h, ad['wq_a'], ad['wq_b'],
                                             idx).to(h.dtype)
                    decode.lora_gather_delta(h, ad['wv_a'], ad['wv_b'],
                                             idx).to(h.dtype)
        torch.cuda.synchronize()
    deltas()
    t0 = time.perf_counter()
    deltas()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    delta_busy = profile_cuda(torch, deltas, 'ADAPTERS_DELTA_PROFILE',
                              dict(rows=b, layers=config.n_layers,
                                   steps=reps))
    per_step = delta_busy / reps
    row = dict(card=card, delta_ms_per_step=per_step,
               delta_host_wall_ms_per_step=wall,
               steps=engine.steps,
               adapter_dispatch_busy_ms=busy['adapters'],
               base_dispatch_busy_ms=busy['base'],
               delta_share=engine.steps * per_step / busy['adapters'],
               busy_difference_share=(busy['adapters'] - busy['base']) /
               busy['adapters'])
    log('ADAPTERS_SHARE ' + json.dumps(row))
    for bl in blocks:
        engine.pool.free(bl)
    return row


def _overload_burst(torch, engine, port, config, rand):
    """Overload control on the same replica with its queue bound at 4: 8
    long interactive requests fill the rows (four at a time, so none is
    shed); then, in order, 2 batch and
    2 interactive requests fill the queue, 2 more interactive arrivals
    each evict the youngest queued batch request (429), and 2 more batch
    arrivals are shed (429); every 429 carries Retry-After >= 1. Returns
    (bodies, results by index, counts) for the solo check."""
    bodies = [{'prompt_ids': rand(64), 'max_new_tokens': 64}
              for _ in range(8)]
    results = {}
    threads = []

    def post(i):
        results[i] = _http(port, bodies[i])

    def submit(i):
        threads.append(threading.Thread(target=post, args=(i,)))
        threads[-1].start()

    def wait(what, pred):
        deadline = time.time() + 300
        while not pred():
            assert time.time() < deadline, f'never saw {what}'
            time.sleep(0.002)

    # Four at a time: the queue holds four.
    for i in range(8):
        submit(i)
        if i % 4 == 3:
            wait(f'{i + 1} rows busy', lambda n=i + 1: not engine.pending
                 and sum(r is not None for r in engine.slot_req) == n)
    order = ['batch', 'batch', 'interactive', 'interactive',
             'interactive', 'interactive', 'batch', 'batch']
    # Past the fourth queued request each arrival answers one request at
    # once: the evicted batch request (the youngest queued first) or
    # itself, shed.
    answers = {4: 9, 5: 8, 6: 14, 7: 15}
    for k, prio in enumerate(order):
        bodies.append({'prompt_ids': rand(32), 'max_new_tokens': 16,
                       'priority': prio})
        submit(len(bodies) - 1)
        if k < 4:
            wait(f'{k + 1} queued',
                 lambda n=k + 1: len(engine.pending) == n)
        else:
            wait(f'request {answers[k]} answered',
                 lambda i=answers[k]: i in results)
    for t in threads:
        t.join(timeout=900)
    assert not any(t.is_alive() for t in threads)
    statuses = {i: results[i][0] for i in results}
    refused = [i for i, s in statuses.items() if s == 429]
    for i in refused:
        assert int(results[i][1]['Retry-After']) >= 1, results[i]
    evicted = [i for i in refused
               if 'shed from the pending queue' in results[i][2]['error']]
    shed = [i for i in refused if 'pending queue full' in
            results[i][2]['error']]
    counts = dict(requests=len(bodies),
                  batch=sum(b.get('priority') == 'batch' for b in bodies),
                  refused_429=len(refused), evicted=len(evicted),
                  shed=len(shed), statuses=statuses)
    # The two interactive arrivals past the bound each evicted a queued
    # batch request (the younger first), and both later batch arrivals
    # were shed.
    assert sorted(evicted) == [8, 9], counts
    assert sorted(shed) == [14, 15], counts
    assert all(statuses[i] == 200 for i in range(14)
               if i not in evicted), counts
    return bodies, results, counts


def adapters_phase(torch, attention, da, dev='cuda', model='llama3-8b'):
    """The overload and multi-LoRA slice: (g) numerics at 2 layers, then
    the ``--slots 8`` replica at llama3-8b (32 layers, random weights,
    the JAX defaults) with ``--adapter-capacity 2``, lineages 'a' (rank
    8, bf16) and 'b' (16) preloaded, 'c' (16) cold, 'big' (32, over the
    bucket), and ``--max-queued-requests 4``. The adapter burst (the
    queue bound lifted for it): 12 concurrent greedy requests, 3 base and
    3 each for 'a', 'b' and 'c', prompts of 64-1024 tokens, 32 new each,
    a base and two 'a' requests sharing a 512-token prefix. Checks: (a)
    each adapter's first-token logits differ from the base's on the same
    prompt; (b) every request equals its run alone on the same engine
    and the base rows their runs on an adapterless engine, bit for bit
    (the rows are batch-invariant); (c) the first 'a' request hits no
    base block, the second hits the first's; 'c' is loaded cold and its
    load evicts an adapter; (d) slot 0 all zeros after the cycle; (e)
    'big' answers 413 and an unknown id 404; (f) launch counts equal to
    the dispatch record. Beside it: the same prompts as an adapterless
    burst, the cold load's host read and upload, the delta's share of a
    decode dispatch. Then overload on the same replica (the bound at 4):
    evictions, sheds with Retry-After, a 504 for an expired
    X-Skytpu-Deadline, a dropped stream's cancel, the pool back to idle,
    and every completed request equal to its solo run. ``dev`` and
    ``model`` exist to rehearse the phase small on the CPU."""
    import gc
    import os
    import shutil
    import socket
    import tempfile

    from skypilot_torch.models import llama
    from skypilot_torch.recipes import serve_model
    from skypilot_torch.serve import batching
    t_phase = time.perf_counter()
    card = smi_line()
    gc.collect()
    torch.cuda.empty_cache()
    _adapter_numerics(torch, dev, model)
    gc.collect()
    torch.cuda.empty_cache()
    config = llama.get_config(model)
    tmp = tempfile.mkdtemp(prefix='skypilot_adapters_')
    t0 = time.perf_counter()
    _write_lineages(torch, tmp, config, ADAPTER_RANKS, seed=45)
    write_s = time.perf_counter() - t0
    args = serve_model.parse_args(
        ['--model', model, '--port', '0', '--device', dev,
         '--slots', '8', '--adapter-dir', tmp, '--adapter-capacity', '2',
         '--preload-adapters', 'a,b', '--max-queued-requests', '4'])
    t0 = time.perf_counter()
    server, _ = serve_model.build_server(args)
    setup_s = time.perf_counter() - t0
    engine = server.engine
    registry = engine._adapters.registry
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    plain = None
    try:
        assert engine.max_queued_requests == 4
        idle_free = engine.pool.free_blocks
        gen = torch.Generator().manual_seed(44)

        def rand(n):
            return torch.randint(0, config.vocab_size, (n,),
                                 generator=gen).tolist()
        shared = rand(512)
        spec = [(None, shared + rand(40)), ('a', shared + rand(60)),
                ('a', shared + rand(100)), (None, rand(64)),
                (None, rand(1024)), ('a', rand(300)), ('b', rand(128)),
                ('b', rand(700)), ('b', rand(1000)), ('c', rand(90)),
                ('c', rand(512)), ('c', rand(256))]
        reqs = []
        for adapter, prompt in spec:
            r = {'prompt_ids': prompt, 'max_new_tokens': 32,
                 'stream': True}
            if adapter is not None:
                r['adapter'] = adapter
            reqs.append(r)
        # (a): each preloaded adapter moves the first-token logits of a
        # prompt against the base model's ('c' is checked after its load).
        resident = engine._adapters
        probe = rand(200)
        first = {'base': _logits_after(torch, engine, config, probe)}
        for name in ('a', 'b'):
            first[name] = _logits_after(torch, engine, config, probe,
                                        resident.buffers(),
                                        resident.slot(name))
        kernels = _serving_kernels(attention, da)

        def identity(events):
            return _serving_identity(kernels, config.n_layers, events,
                                     lora=True)

        # The adapter burst, with the queue bound lifted.
        engine.max_queued_requests = None
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        engine.events.clear()
        results, run_s = _staged_burst(
            engine, reqs, lambda body: _sse_post(port, body))
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        events = list(engine.events)
        want, record = identity(events)
        engine.max_queued_requests = 4
        outs, n_out = [], 0
        for (status, heads, ids, ttft, ms), r in zip(results, reqs):
            assert status == 200, (status, r.get('adapter'))
            assert len(ids) == r['max_new_tokens'], (len(ids), r)
            assert all(0 <= t < config.vocab_size for t in ids)
            outs.append(ids)
            n_out += len(ids)
            log('ADAPTERS_REQ ' + json.dumps(dict(
                adapter=r.get('adapter'), prompt=len(r['prompt_ids']),
                n_out=len(ids), latency_ms=ms, ttft_ms=ttft,
                tpot_ms=None if ttft is None else
                (ms - ttft) / (len(ids) - 1),
                prefix_hits=int(heads['X-Skytpu-Prefix-Hits']),
                adapter_hits=heads['X-Skytpu-Adapter-Hits'],
                adapter_loads=heads['X-Skytpu-Adapter-Loads'])))
        hits = [int(res[1]['X-Skytpu-Prefix-Hits']) for res in results]
        loads = {}
        for r, res in zip(reqs, results):
            if r.get('adapter'):
                loads.setdefault(r['adapter'], []).append(
                    res[1]['X-Skytpu-Adapter-Loads'])
        evicts = [e for e in events if e[0] == 'adapter_evict']
        summary = _burst_summary(results, n_out, run_s)
        log('ADAPTERS ' + json.dumps(dict(
            card=card, model=args.model, layers=config.n_layers, slots=args.slots,
            adapter_capacity=args.adapter_capacity,
            rank_bucket=engine._adapters.rank_bucket,
            ranks=ADAPTER_RANKS, lineage_write_s=write_s, setup_s=setup_s,
            run_s=run_s, requests=len(reqs), output_tokens=n_out, **summary,
            **record, preemptions=sum(e[0] == 'preempt' for e in events),
            shared_prefix_hits=hits[:3],
            adapter_events=[e for e in events
                            if e[0] in ('adapter_load', 'adapter_evict')],
            launches=launches, launches_expected=want)))
        assert launches == want, (launches, want)          # (f)
        # (c): no base block reused under 'a'; the second 'a' request
        # reuses the first's 32 prefix blocks; 'c' came in cold and its
        # load evicted a preloaded adapter.
        assert hits[:3] == [0, 0, 32], hits
        assert loads['a'] == loads['b'] == ['0'] * 3, loads
        assert '1' in loads['c'], loads
        assert evicts and evicts[0][1][0] in ('a', 'b'), evicts
        assert ('adapter_load', ('c',)) in events, events
        # (d): slot 0 is all zeros after the install/evict cycle.
        assert all(not bool(buf[:, 0].any()) for buf in
                   engine._adapters.buffers().values())
        # (a), 'c' now resident.
        first['c'] = _logits_after(torch, engine, config, probe,
                                   resident.buffers(), resident.slot('c'))
        moved = {k: (first[k] - first['base']).abs().max().item()
                 for k in ('a', 'b', 'c')}
        log('ADAPTERS_FIRST_LOGITS ' + json.dumps(dict(
            prompt=len(probe), max_abs_diff_vs_base=moved)))
        assert all(v > 1e-2 for v in moved.values()), moved
        # (e)
        status_big = _http(port, {'prompt_ids': rand(64),
                                  'max_new_tokens': 4, 'adapter': 'big'})
        status_unknown = _http(port, {'prompt_ids': rand(64),
                                      'max_new_tokens': 4,
                                      'adapter': 'nobody'})
        log('ADAPTERS_REFUSALS ' + json.dumps(dict(
            big=status_big[0], big_error=status_big[2]['error'],
            unknown=status_unknown[0],
            unknown_error=status_unknown[2]['error'])))
        assert status_big[0] == 413 and status_unknown[0] == 404
        times = engine._adapters.load_times['c']
        log('ADAPTERS_COLD_LOAD ' + json.dumps(dict(
            card=card, adapter='c', rank=ADAPTER_RANKS['c'],
            host_read_s=times['read_s'], upload_s=times['upload_s'],
            ttft_ms_of_c_requests=[res[3] for r, res in zip(reqs, results)
                                   if r.get('adapter') == 'c'])))
        # (b)
        inv = _solo_check(torch, 'ADAPTERS_SOLO', engine, config, reqs,
                          outs, registry)
        log('ADAPTERS_SOLO ' + json.dumps(inv))
        # The adapterless engine on the same weights: the burst's prompts
        # as base requests, then the base rows alone.
        plain = batching.BatchingEngine(engine.params, config,
                                        slots=args.slots)
        base_reqs = [{k: v for k, v in r.items() if k != 'adapter'}
                     for r in reqs]
        plain_results, plain_s = _staged_burst(
            plain, base_reqs, lambda body: _engine_post(plain, body))
        plain_summary = _burst_summary(
            plain_results, sum(len(r[2]) for r in plain_results), plain_s)
        log('ADAPTERS_VS_ADAPTERLESS ' + json.dumps(dict(
            card=card, adapter_burst=summary, adapterless_burst=plain_summary,
            note='the same 12 prompts and submission order, all as base '
                 'requests, on an engine without an adapter set (same '
                 'weights, a fresh pool)')))
        base_idx = [i for i, r in enumerate(reqs) if 'adapter' not in r]
        plain_rows = _solo_check(
            torch, 'ADAPTERS_ADAPTERLESS', engine, config,
            [reqs[i] for i in base_idx], [outs[i] for i in base_idx],
            registry, solo_engine=plain)
        log('ADAPTERS_ADAPTERLESS ' + json.dumps(plain_rows))
        plain.close()
        plain = None
        share = _profile_lora(torch, engine, config, batching, card)
        # Overload on the same replica, its bound back at 4.
        for k in kernels.values():
            k.launches = 0
        engine.events.clear()
        bodies, res, counts = _overload_burst(torch, engine, port, config,
                                              rand)
        torch.cuda.synchronize()
        o_launches = {name: k.launches for name, k in kernels.items()}
        o_want, o_record = identity(list(engine.events))
        assert o_launches == o_want, (o_launches, o_want)
        status_504 = _http(port, {'prompt_ids': rand(128),
                                  'max_new_tokens': 16},
                           headers={'X-Skytpu-Deadline': '0.001'})
        assert status_504[0] == 504, status_504
        # A streaming client that drops its connection after 4 tokens.
        body = json.dumps({'prompt_ids': rand(128), 'max_new_tokens': 256,
                           'stream': True}).encode()
        sock = socket.create_connection(('127.0.0.1', port), timeout=300)
        sock.sendall(b'POST /generate HTTP/1.1\r\nHost: x\r\n'
                     b'Content-Type: application/json\r\n'
                     + f'Content-Length: {len(body)}\r\n\r\n'.encode()
                     + body)
        buf = b''
        while buf.count(b'data: ') < 4:
            chunk = sock.recv(65536)
            assert chunk, 'the stream ended before 4 tokens'
            buf += chunk
        sock.close()
        deadline = time.time() + 120
        while not any(e[0] == 'cancel' for e in list(engine.events)):
            assert time.time() < deadline, 'the dropped stream was not ' \
                                           'cancelled'
            time.sleep(0.01)
        cancels = [e for e in engine.events if e[0] == 'cancel']
        deadline = time.time() + 120
        while engine.pool.free_blocks != idle_free or engine.pending:
            assert time.time() < deadline, (engine.pool.free_blocks,
                                            idle_free)
            time.sleep(0.01)
        done = [i for i in sorted(res) if res[i][0] == 200]
        o_rows = _solo_check(torch, 'OVERLOAD_SOLO', engine, config,
                             [bodies[i] for i in done],
                             [res[i][2]['output_ids'] for i in done],
                             registry)
        log('OVERLOAD ' + json.dumps(dict(
            card=card, max_queued_requests=engine.max_queued_requests, **counts,
            deadline_504=status_504[0], cancelled=len(cancels),
            cancel_events=cancels, **o_record, launches=o_launches,
            launches_expected=o_want, pool_free_blocks=
            engine.pool.free_blocks, pool_idle_free_blocks=idle_free,
            completed=len(done),
            completed_equal_to_solo=sum(r['equal'] for r in o_rows))))
    finally:
        if plain is not None:
            plain.close()
        server.shutdown()
        server.server_close()
        engine.close()
        thread.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    assert not thread.is_alive() and not engine.thread.is_alive()
    log(f'ADAPTERS_PHASE_S {time.perf_counter() - t_phase:.1f}')
    return dict(adapter_burst=launches, overload_burst=o_launches,
                share=share)


# ---------------------------------------------------------------------
# Rows: decode_steps_rows (K5F + dense K4) against its paged twin
# ---------------------------------------------------------------------


def rows_phase(torch, da):
    """``decode_steps_rows`` at llama3-8b (32 layers, B 8 at mixed
    positions, 16 steps) over a dense cache of random content, then
    ``decode_steps_paged`` over a pool holding the same content through
    contiguous tables: exactly 32 x 16 launches of K5F and dense K4 in
    the first, of K5F and K4-paged in the second, and equal tokens."""
    import gc

    from skypilot_torch.models import llama
    from skypilot_torch.serve import batching
    gc.collect()
    torch.cuda.empty_cache()
    config = llama.get_config('llama3-8b')
    params = llama.init_params(config, seed=5, device='cuda')
    b, s, steps, L = 8, 8192, 16, config.n_layers
    gen = torch.Generator(device='cuda').manual_seed(25)
    shape = (L, b, s, HKV8, HD8)
    k = torch.randn(shape, generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    v = torch.randn(shape, generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    pos = torch.tensor([17, 100, 1000, 2047, 4096, 5000, 7000, 8000],
                       dtype=torch.int32, device='cuda')
    tokens = torch.randint(0, config.vocab_size, (b,), generator=gen,
                           device='cuda', dtype=torch.int32)
    active = torch.ones(b, dtype=torch.bool, device='cuda')
    mb = s // BLOCK
    kp = torch.zeros((L, 1 + b * mb, BLOCK, HKV8, HD8), device='cuda',
                     dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    kp[:, 1:] = k.reshape(L, b * mb, BLOCK, HKV8, HD8)
    vp[:, 1:] = v.reshape(L, b * mb, BLOCK, HKV8, HD8)
    tables = (torch.arange(b * mb, dtype=torch.int32, device='cuda')
              .reshape(b, mb) + 1)
    kernels = (da.ROPE_CACHE_WRITE, da.DECODE_ATTENTION,
               da.PAGED_DECODE_ATTENTION)
    out = {}
    with torch.inference_mode():
        for name in ('rows', 'paged'):
            torch.cuda.synchronize()
            for kern in kernels:
                kern.launches = 0
            t0 = time.perf_counter()
            if name == 'rows':
                toks, _, new_pos = batching.decode_steps_rows(
                    params, tokens, (k, v, None, None), pos, active, config,
                    steps)
            else:
                toks, _, new_pos = batching.decode_steps_paged(
                    params, tokens, (kp, vp, None, None), tables, pos,
                    active, config, steps, BLOCK)
            toks = toks.cpu()
            ms = 1e3 * (time.perf_counter() - t0)
            out[name] = dict(tokens=toks.tolist(), pos=new_pos.tolist(),
                             ms_per_step=ms / steps,
                             launches=[kern.launches for kern in kernels])
    same = out['rows']['tokens'] == out['paged']['tokens']
    log('ROWS ' + json.dumps(dict(
        config='llama3-8b', layers=L, B=b, steps=steps,
        positions=pos.tolist(), tokens_equal=same,
        launches_order=['rope_cache_write', 'decode_attention',
                        'decode_attention_paged'], **out)))
    n = L * steps
    assert out['rows']['launches'] == [n, n, 0], out['rows']['launches']
    assert out['paged']['launches'] == [n, 0, n], out['paged']['launches']
    assert out['rows']['pos'] == out['paged']['pos'] == \
        [p + steps for p in pos.tolist()]
    assert same, 'decode_steps_rows and decode_steps_paged disagree'
    del params, k, v, kp, vp
    return n


# ---------------------------------------------------------------------
# K6: the head-paired flash forward and its bench entry
# ---------------------------------------------------------------------


def k6_phase(torch, F, attention):
    """K6 against ``_packed_fwd_plain`` in f32 on the card (shared kv at
    32/8 heads and at groups 2, paired kv at groups 1, causal T < S,
    non-causal, T = S = 192 against 128-key tiles); at the
    JAX bench's shape (B 8, T 2048, 32/8 heads, head_dim 64, causal) the
    kernel, plain, K1 (the JAX bench's comparison), SDPA (timed only)
    and bound times; then ``bench_main()`` itself, the entry point, with
    K6's launch count zeroed just before and read just after."""
    from skypilot_torch.ops import attention_packed as packed
    gen = torch.Generator(device='cuda').manual_seed(31)
    # (B, H, Hkv, T, S, D, causal)
    # The last three: GQA groups 2 at head_dim 128, and T = S = 192, a
    # length the reference's block min(512, T) allows and the kernel's
    # 128-key tile does not divide (shared and paired kv).
    cases = [(8, 32, 8, 2048, 2048, 64, True), (1, 32, 32, 1024, 1024, 64,
                                                True),
             (1, 32, 8, 512, 2048, 128, True),
             (2, 16, 8, 1024, 1024, 128, False),
             (2, 16, 8, 1024, 1024, 128, True),
             (1, 32, 8, 192, 192, 64, True), (1, 16, 16, 192, 192, 128, True)]
    rows = []
    for b, h, hkv, t, s, d, causal in cases:
        def make(b=b, h=h, hkv=hkv, t=t, s=s, d=d):
            return tuple(torch.randn(sh, generator=gen, device='cuda',
                                     dtype=torch.bfloat16)
                         for sh in ((b, h, t, d), (b, hkv, s, d),
                                    (b, hkv, s, d)))
        q, k, v = make()
        before = packed.PACKED_FWD.launches
        out, lse = packed.packed_flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert packed.PACKED_FWD.launches == before + 1
        ref_out, ref_lse = packed._packed_fwd_plain(
            q.float(), k.float(), v.float(), causal=causal)
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ok = (err_out <= K1_TOL['out'] and err_lse <= K1_TOL['lse']
              and bool(torch.isfinite(out.float()).all()))
        pairs = _visible_pairs(t, s) if causal else t * s
        flops = 4 * b * h * d * pairs
        nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
                  + 4 * lse.numel())
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
        row = dict(B=b, H=h, Hkv=hkv, T=t, S=s, D=d, causal=causal,
                   max_abs_err_out=err_out, max_abs_err_lse=err_lse,
                   tol=K1_TOL, ok=ok, bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by='operations' if t_ops >= t_bytes else 'bytes',
                   gflop=flops / 1e9)
        if len(rows) == 0:
            inputs = copies_outside_l2(make, nbytes, (q, k, v))

            def kernel(q, k, v):
                return packed.packed_flash_attention_fwd(q, k, v,
                                                         causal=True)

            def plain(q, k, v):
                return packed._packed_fwd_plain(q, k, v, causal=True)

            def k1(q, k, v):
                return attention.flash_attention_fwd(
                    q.transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2), causal=True)

            def library(q, k, v):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            row.update(kernel_ms=graph_ms(torch, kernel, inputs, 20),
                       plain_ms=graph_ms(torch, plain, inputs[:1], 2),
                       k1_ms=graph_ms(torch, k1, inputs, 20),
                       library_ms=graph_ms(torch, library, inputs, 20),
                       library='SDPA (GQA, causal)')
            row['tflops'] = flops / row['kernel_ms'] / 1e9
            row['k1_tflops'] = flops / row['k1_ms'] / 1e9
            del inputs
        log('K6 ' + json.dumps(row))
        rows.append(row)
        del q, k, v, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r['ok']]
    assert not bad, f'K6 disagrees with its plain version: {bad}'
    torch.cuda.synchronize()
    packed.PACKED_FWD.launches = 0
    iters = 20
    bench = packed.bench_main(iters=iters)
    launches = packed.PACKED_FWD.launches
    log('K6_BENCH ' + json.dumps(dict(bench, launches=launches,
                                      launches_expected=iters + 1)))
    assert launches == iters + 1, launches       # warm-up + timed calls
    main_case = rows[0]
    return dict(max_abs_err=max(max(r['max_abs_err_out'],
                                    r['max_abs_err_lse']) for r in rows),
                B=8, T=2048, S=2048, H=32, Hkv=8, D=64,
                ms=main_case['kernel_ms'], plain_ms=main_case['plain_ms'],
                bound_ms=main_case['bound_ms'],
                bound_by=main_case['bound_by'],
                library_ms=main_case['library_ms'],
                library='SDPA (GQA, causal)', k1_ms=main_case['k1_ms'],
                bench_main=bench, launches=launches)


# ---------------------------------------------------------------------
# int8 K4 (dense, paged W = 1 and W = 9) and int8 K5
# ---------------------------------------------------------------------

# Bytes of one key and kv head, K and V with their scales: int8 codes
# plus two bf16 scales (260 at head_dim 128), against 4 * hd in bf16.
Q8_KEY_BYTES = 2 * HD8 + 2 * 2


def _q8(x):
    """bf16 rows [..., hd] -> (int8 codes, bf16 scales) as the model
    writes them."""
    from skypilot_torch.models import decode
    return decode._quantize_kv(x)


def int8k_phase(torch, F, da):
    """The int8 forms of K4 and K5 against their plain versions: dense K4
    on codes + scales (the serve path's batch-1 decode and serve_8b's
    batch 8 at 1024-token prompts), K4-paged W = 1 and W = 9 over the
    shuffled 4097-block int8 pool (and W = 1 bit-equal to dense int8 on
    contiguous tables), K5 bit-exact against ``index_copy_`` on codes and
    scales. Library column: dequantize + SDPA (K4), ``index_copy_`` x 4
    (K5); timed only."""
    from skypilot_torch.serve import kv_pool
    HQ, S = 32, 8192
    scale = HD8 ** -0.5
    gen = torch.Generator(device='cuda').manual_seed(32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16)

    def dequant(x, sc):
        return da.dequant_kv(x, sc, torch.bfloat16)
    out = {}
    dense_rows = []
    for label, lens, s in (('serve B1', [2048], S),
                           ('serve_8b B8', [1024 + 9 * i for i in range(8)],
                            2048)):
        b = len(lens)

        def make(b=b, s=s):
            kq, ks = _q8(randn(b, s, HKV8, HD8))
            vq, vs = _q8(randn(b, s, HKV8, HD8))
            return randn(b, HQ, HD8), kq, vq, ks, vs
        lengths = torch.tensor(lens, dtype=torch.int32, device='cuda')
        q, kq, vq, ks, vs = make()
        before = da.DECODE_ATTENTION_Q8.launches
        got = da.decode_attention(q, kq, vq, lengths, scale, ks, vs)
        torch.cuda.synchronize()
        assert da.DECODE_ATTENTION_Q8.launches == before + 1
        ref = da._reference_decode_attention(
            q.float(), kq, vq, lengths, scale, ks, vs)
        err, rel = k4_errors(got, ref)
        nbytes = (sum(lens) * HKV8 * Q8_KEY_BYTES + 2 * 2 * q.numel()
                  + 4 * b)
        inputs = copies_outside_l2(make, nbytes, (q, kq, vq, ks, vs))
        mask = (torch.arange(s, device='cuda')[None, :] <
                lengths[:, None])[:, None, None, :]

        def kernel(q, kq, vq, ks, vs):
            return da.decode_attention(q, kq, vq, lengths, scale, ks, vs)

        def plain(q, kq, vq, ks, vs):
            return da._reference_decode_attention(q, kq, vq, lengths, scale,
                                                  ks, vs)

        def library(q, kq, vq, ks, vs):
            return F.scaled_dot_product_attention(
                q[:, :, None], dequant(kq, ks).transpose(1, 2),
                dequant(vq, vs).transpose(1, 2), attn_mask=mask,
                scale=scale, enable_gqa=True)
        row = dict(case=label, B=b, S=s, lengths=lens, max_abs_err=err,
                   tol=K4_TOL, max_rel_err=rel, rel_tol=K4_REL_TOL,
                   ok=err <= K4_TOL and rel <= K4_REL_TOL and bool(
                       torch.isfinite(got.float()).all()),
                   kernel_ms=graph_ms(torch, kernel, inputs, 200),
                   plain_ms=graph_ms(torch, plain, inputs, 20),
                   library_ms=graph_ms(torch, library, inputs, 50),
                   library='dequantize + SDPA (boolean mask, GQA)',
                   bound_ms=1e3 * nbytes / PEAK_HBM_BYTES, bound_by='bytes',
                   device_launches_per_call=k4_one_launch(
                       torch, f'K4Q8 {label}',
                       lambda: kernel(q, kq, vq, ks, vs)))
        row['gbps'] = nbytes / row['kernel_ms'] / 1e6
        row['bound_share'] = row['bound_ms'] / row['kernel_ms']
        log('K4Q8 ' + json.dumps(row))
        dense_rows.append(row)
        del q, kq, vq, ks, vs, inputs, got, ref
        torch.cuda.empty_cache()

    # Paged over the engine's pool: 4097 blocks of 16, shuffled tables.
    b, mb = 8, 8192 // BLOCK
    s = mb * BLOCK
    n_rows = POOL_BLOCKS * BLOCK
    kq, ks = _q8(randn(n_rows, HKV8, HD8)[None])
    vq, vs = _q8(randn(n_rows, HKV8, HD8)[None])
    kq, vq, ks, vs = kq[0], vq[0], ks[0], vs[0]
    ids = torch.randperm(POOL_BLOCKS - 1, generator=gen,
                         device='cuda')[:b * mb] + 1
    tables = ids.reshape(b, mb).to(torch.int32).contiguous()
    lens = [1, 17, 300, 2048, 4097, 6000, 8183, 8192]
    paged_rows = []
    for w in (1, 9):
        q = randn(b, w, HQ, HD8)
        lengths = torch.tensor([min(n, s - w + 1) for n in lens],
                               dtype=torch.int32, device='cuda')
        counts = (da.PAGED_DECODE_ATTENTION_Q8, da.PAGED_VERIFY_ATTENTION_Q8)
        before = tuple(c.launches for c in counts)
        if w == 1:
            def kernel(q=q, lengths=lengths):
                return da.paged_decode_attention(
                    q[:, 0], kq, vq, tables, lengths, scale, BLOCK, ks,
                    vs)[:, None]

            def plain(q=q, lengths=lengths):
                return da._reference_paged_decode_attention(
                    q[:, 0], kq, vq, tables, lengths, scale, BLOCK, ks,
                    vs)[:, None]
        else:
            def kernel(q=q, lengths=lengths):
                return da.paged_verify_attention(
                    q, kq, vq, tables, lengths, scale, BLOCK, ks, vs)

            def plain(q=q, lengths=lengths):
                return da._reference_paged_verify_attention(
                    q, kq, vq, tables, lengths, scale, BLOCK, ks, vs)
        got = kernel()
        torch.cuda.synchronize()
        launched = tuple(c.launches - n for c, n in zip(counts, before))
        assert launched == ((1, 0) if w == 1 else (0, 1)), launched
        if w == 1:
            ref = da._reference_paged_decode_attention(
                q[:, 0].float(), kq, vq, tables, lengths, scale, BLOCK, ks,
                vs)[:, None]
        else:
            ref = da._reference_paged_verify_attention(
                q.float(), kq, vq, tables, lengths, scale, BLOCK, ks, vs)
        err, rel = k4_errors(got, ref)
        spans = [min(max(n + w - 1, 1), s) for n in lengths.tolist()]
        nbytes = (sum(spans) * HKV8 * Q8_KEY_BYTES + 2 * 2 * q.numel()
                  + 4 * (b + b * mb))
        span_mask = (torch.arange(s, device='cuda')[None, None, :] <
                     (lengths[:, None] + torch.arange(
                         w, device='cuda')[None, :])[:, :, None])

        def library(q=q, span_mask=span_mask):
            gidx = kv_pool.read_indices(tables, BLOCK)
            kd = dequant(da.paged_gather(kq, gidx),
                         da.paged_gather(ks, gidx)).transpose(1, 2)
            vd = dequant(da.paged_gather(vq, gidx),
                         da.paged_gather(vs, gidx)).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kd, vd, attn_mask=span_mask[:, None],
                scale=scale, enable_gqa=True)
        row = dict(case=f'paged W={w}', B=b, W=w, lengths=lengths.tolist(),
                   max_abs_err=err, tol=K4_TOL, max_rel_err=rel,
                   rel_tol=K4_REL_TOL,
                   ok=err <= K4_TOL and rel <= K4_REL_TOL and bool(
                       torch.isfinite(got.float()).all()),
                   kernel_ms=graph_ms(torch, kernel, [()], 200),
                   plain_ms=graph_ms(torch, plain, [()], 10),
                   library_ms=graph_ms(torch, library, [()], 20),
                   library='gather + dequantize + SDPA',
                   bound_ms=1e3 * nbytes / PEAK_HBM_BYTES, bound_by='bytes',
                   device_launches_per_call=k4_one_launch(
                       torch, f'K4PQ8 W{w}', kernel))
        row['gbps'] = nbytes / row['kernel_ms'] / 1e6
        row['bound_share'] = row['bound_ms'] / row['kernel_ms']
        log('K4PQ8 ' + json.dumps(row))
        paged_rows.append(row)
        del q, got, ref
    # W = 1 over contiguous tables equals dense int8 K4 bit for bit.
    mb2 = 2048 // BLOCK
    dk, dks = _q8(randn(b, 2048, HKV8, HD8))
    dv, dvs = _q8(randn(b, 2048, HKV8, HD8))

    def pool_of(x):      # block 0 scratch, then row b's blocks in order
        return torch.cat([torch.zeros_like(x[0, :BLOCK]),
                          x.reshape(b * 2048, *x.shape[2:])])
    contiguous = (torch.arange(b * mb2, device='cuda', dtype=torch.int32)
                  .reshape(b, mb2) + 1)
    q = randn(b, HQ, HD8)
    lengths = torch.tensor([1, 17, 300, 1024, 1500, 2000, 2047, 2048],
                           dtype=torch.int32, device='cuda')
    dense = da.decode_attention(q, dk, dv, lengths, scale, dks, dvs)
    paged = da.paged_decode_attention(
        q, pool_of(dk), pool_of(dv), contiguous, lengths, scale, BLOCK,
        pool_of(dks), pool_of(dvs))
    torch.cuda.synchronize()
    bit_equal = torch.equal(dense, paged)
    log('K4PQ8_CONTIGUOUS ' + json.dumps(dict(
        bit_equal_to_dense_int8_k4=bit_equal,
        max_abs_diff=(dense.float() - paged.float()).abs().max().item())))
    calls = []
    for i in range(4):
        pools = (kq, vq, ks, vs) if i % 2 == 0 else (vq, kq, vs, ks)
        for w in (1, 9):
            ql = randn(b, w, HQ, HD8)
            ll = torch.tensor([min(n, s - w + 1) for n in lens],
                              dtype=torch.int32, device='cuda')
            calls.append(lambda ql=ql, pools=pools, ll=ll:
                         da.paged_verify_attention(
                             ql, pools[0], pools[1], tables, ll, scale,
                             BLOCK, pools[2], pools[3]))
    calls.append(lambda: da.decode_attention(q, dk, dv, lengths, scale, dks,
                                             dvs))
    graph = k4_graph_check(torch, 'int8', calls)
    del calls
    del dk, dks, dv, dvs, dense, paged

    # K5 int8: codes and scales, bit-exact against index_copy_.
    k5_rows = []
    for r in (8, 72, 512):
        dst = torch.randperm(n_rows - BLOCK, generator=gen,
                             device='cuda')[:r].to(torch.int32) + BLOCK
        kn, ksn = _q8(randn(1, r, HKV8, HD8))
        vn, vsn = _q8(randn(1, r, HKV8, HD8))
        new = (kn[0], vn[0], ksn[0], vsn[0])
        got = [x.clone() for x in (kq, vq, ks, vs)]
        want = [x.clone() for x in (kq, vq, ks, vs)]
        before = da.CACHE_WRITE_Q8.launches
        da.cache_write(got[0], got[1], new[0], new[1], dst, got[2], got[3],
                       new[2], new[3])
        torch.cuda.synchronize()
        assert da.CACHE_WRITE_Q8.launches == before + 1
        da._reference_cache_write(want[0], want[1], new[0], new[1], dst,
                                  want[2], want[3], new[2], new[3])
        exact = all(torch.equal(a, c) for a, c in zip(got, want))
        idx = dst.long()
        nbytes = 2 * 2 * r * HKV8 * (HD8 + 2) + 4 * r

        def kernel():
            da.cache_write(got[0], got[1], new[0], new[1], dst, got[2],
                           got[3], new[2], new[3])

        def plain():
            da._reference_cache_write(want[0], want[1], new[0], new[1], dst,
                                      want[2], want[3], new[2], new[3])

        def library():
            for x, n in zip(want, new):
                x.index_copy_(0, idx, n)
        row = dict(case=f'pool R={r}', rows=r, bit_exact=exact,
                   kernel_ms=graph_ms(torch, lambda: kernel(), [()], 200),
                   plain_ms=cuda_ms(torch, plain, [()], 200),
                   library_ms=graph_ms(torch, lambda: library(), [()], 200),
                   library='index_copy_ on K, V and their scales',
                   bound_ms=1e3 * nbytes / PEAK_HBM_BYTES, bound_by='bytes')
        log('K5Q8 ' + json.dumps(row))
        k5_rows.append(row)
        del got, want
    del kq, vq, ks, vs
    torch.cuda.empty_cache()
    # head_dim 64 at groups 1 and 8, dense; B1 at W 2 and 9, paged.
    extra = [_k4_case(torch, F, da, gen, f'hd64 G{g} B1', 1, 1, 32, 32 // g,
                      64, [2048], S, q8=True) for g in (1, 8)]
    extra += [_k4_case(torch, F, da, gen, f'B1 W{w}', 1, w, 32, 8, 128,
                       [2000], 8192, q8=True, paged=True) for w in (2, 9)]
    bad = [r for r in dense_rows + paged_rows + extra if not r['ok']]
    assert not bad, f'int8 K4 disagrees with its plain version: {bad}'
    assert bit_equal, 'int8 K4-paged W=1 is not bit-equal to dense int8 K4'
    assert all(r['bit_exact'] for r in k5_rows), k5_rows

    def pick(row):
        return {k: row[k] for k in ('case', 'max_abs_err', 'max_rel_err',
                                    'kernel_ms', 'plain_ms', 'library_ms',
                                    'library', 'bound_ms', 'bound_by',
                                    'bound_share', 'device_launches_per_call')
                if k in row}
    out['decode_attention'] = dict(
        main=pick(dense_rows[1]), serve_b1=pick(dense_rows[0]),
        cases={r['case']: pick(r) for r in extra[:2]})
    out['decode_attention_paged'] = dict(
        main=pick(paged_rows[0]), verify=pick(paged_rows[1]),
        bit_equal_to_dense_int8=bit_equal, graph=graph,
        cases={r['case']: pick(r) for r in extra[2:]})
    out['cache_write'] = dict(main=dict(pick(k5_rows[0]), max_abs_err=0.0),
                              cases={r['case']: pick(r) for r in k5_rows})
    return out


# ---------------------------------------------------------------------
# int8: numerics, serve_8b, the int8 replica, engine-off TPOT
# ---------------------------------------------------------------------


def _int8_numerics(torch):
    """llama3-8b widths at 2 layers, int8 weights (``init_quantized`` on
    the card) and an int8 KV cache: bf16 on the card against the same
    codes in f32 on the CPU; first-token logits and greedy tokens."""
    from skypilot_torch.models import convert, decode, llama, quant
    config = llama.get_config('llama3-8b', n_layers=2)
    cfg_cpu = dataclasses.replace(config, dtype=torch.float32)
    params = quant.init_quantized(config, seed=6, device='cuda')
    cpu_params = convert.params_from_numpy(
        convert.params_to_numpy(params), cfg_cpu, device='cpu')
    gen = torch.Generator().manual_seed(33)
    prompt = torch.randint(0, config.vocab_size, (1, 256), generator=gen)
    n_new, max_seq = 9, 512

    def first_logits(p, cfg, dev):
        with torch.inference_mode():
            cache = decode.init_cache(cfg, 1, max_seq, device=dev,
                                      kv_int8=True)
            logits, _ = decode.forward_cached(p, prompt.to(dev), cache,
                                              cfg, last_only=True,
                                              prefill=True)
        return logits[0, -1].float().cpu()

    lg = first_logits(params, config, 'cuda')
    toks_gpu = decode.greedy_generate(params, prompt.cuda(), config, n_new,
                                      max_seq=max_seq,
                                      kv_int8=True)[0].tolist()
    lc = first_logits(cpu_params, cfg_cpu, 'cpu')
    toks_cpu = decode.greedy_generate(cpu_params, prompt, cfg_cpu, n_new,
                                      max_seq=max_seq,
                                      kv_int8=True)[0].tolist()
    rel = ((lg - lc).abs().max() / lc.abs().max()).item()
    agree = sum(a == b for a, b in zip(toks_gpu, toks_cpu))
    row = dict(config='llama3-8b', layers=2, weights='int8', kv='int8',
               prompt=256, rel_err=rel, rel_tol=E2E_REL_TOL,
               greedy_agree=f'{agree}/{n_new}', gpu_tokens=toks_gpu,
               cpu_tokens=toks_cpu)
    log('INT8_NUMERICS ' + json.dumps(row))
    assert bool(torch.isfinite(lg).all()) and lg.shape == lc.shape
    assert rel <= E2E_REL_TOL, f'int8 logits disagree: {row}'
    del params, cpu_params


SERVE_8B = dict(model='llama3.1-8b', batch=8, prompt_len=1024, new=32,
                max_seq=2048, seed=34)


def serve_8b_point(torch, weights, counts, profile=None):
    """One form of the JAX bench's serve_8b point through the engine-off
    entry point: llama3.1-8b (32 layers), ``weights`` 'int8'
    (``init_quantized`` and an int8 dense cache) or 'bf16', batch 8,
    1024-token prompts, 32 new tokens: one warm-up, then one
    ``greedy_generate`` with the ``counts`` (name -> kernel) zeroed just
    before and read just after, and TTFT as the same call at one new
    token. ``profile``: a function (label, fn, extra) that profiles the
    prompt alone and one decode step alone after it. Returns the row
    (``launches`` as read, ``toks``)."""
    from skypilot_torch.models import decode, llama, quant
    cfg = SERVE_8B
    config = llama.get_config(cfg['model'])
    b, prompt_len, new, max_seq = (cfg['batch'], cfg['prompt_len'],
                                   cfg['new'], cfg['max_seq'])
    gen = torch.Generator().manual_seed(cfg['seed'])
    prompt = torch.randint(0, config.vocab_size, (b, prompt_len),
                           generator=gen).cuda()
    int8 = weights == 'int8'
    t0 = time.perf_counter()
    params = (quant.init_quantized(config, seed=0, device='cuda')
              if int8 else llama.init_params(config, seed=0, device='cuda'))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # What a decode step reads: every weight but the embedding (one row
    # per token).
    weight_bytes = sum(x.numel() * x.element_size() for x in _tensors(
        {k: v for k, v in params.items() if k != 'embed'}))

    def run(n):
        out = decode.greedy_generate(params, prompt, config, n,
                                     max_seq=max_seq, kv_int8=int8)
        return out.cpu()
    run(2)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counts.values():
        k.launches = 0
    t0 = time.perf_counter()
    toks = run(new)
    total_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counts.items()}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    run(1)
    ttft_s = time.perf_counter() - t0
    tpot_ms = 1e3 * (total_s - ttft_s) / (new - 1)
    row = dict(model=cfg['model'], layers=config.n_layers, weights=weights,
               kv_cache=weights, batch=b, prompt_len=prompt_len,
               new_tokens=new, max_seq=max_seq, setup_s=setup_s,
               weight_gb=weight_bytes / 1e9, total_s=total_s,
               ttft_ms=1e3 * ttft_s, tpot_ms=tpot_ms,
               tokens_per_s=b * new / total_s,
               decode_tokens_per_s=b * (new - 1) / (total_s - ttft_s),
               weight_read_floor_ms=1e3 * weight_bytes / PEAK_HBM_BYTES,
               max_memory_allocated_gb=peak / 1e9, launches=launches,
               toks=toks)
    if profile is not None:
        cache = decode.init_cache(config, b, max_seq, device='cuda',
                                  kv_int8=int8)
        tok = toks[:, :1].cuda()

        def prefill():
            with torch.inference_mode():
                cache.pos = 0
                logits, _ = decode.forward_cached(
                    params, prompt, cache, config, last_only=True,
                    prefill=True)
                logits.argmax(-1).cpu()

        def step():
            with torch.inference_mode():
                cache.pos = prompt_len
                logits, _ = decode.forward_cached(params, tok, cache,
                                                  config, last_only=True)
                logits.argmax(-1).cpu()
        for kind, fn in (('engine_off_prompt', prefill),
                         ('engine_off_step', step)):
            fn()
            profile(kind, fn, dict(rows=b * (prompt_len if kind ==
                                             'engine_off_prompt' else 1)))
        del cache
    del params
    return row


def _serve_8b(torch, attention, da):
    """The JAX bench's serve_8b point (``serve_8b_point``), int8 weights
    and KV, then bf16 beside it, each with its launch counts held: K1 =
    32 for the one prefill, K4 = 32 x 31 decode steps (the int8 form
    over int8 KV), and K5F (the int8 form over int8 KV) = 32 x 32, one a
    layer for the prompt and for each decode step."""
    import gc

    from skypilot_torch.models import llama
    config = llama.get_config(SERVE_8B['model'])
    L, new = config.n_layers, SERVE_8B['new']
    counts = {'flash_fwd': attention.FLASH_FWD,
              'decode_attention': da.DECODE_ATTENTION,
              'decode_attention_q8': da.DECODE_ATTENTION_Q8,
              'rope_cache_write': da.ROPE_CACHE_WRITE,
              'rope_cache_write_q8': da.ROPE_CACHE_WRITE_Q8,
              'cache_write': da.CACHE_WRITE,
              'cache_write_q8': da.CACHE_WRITE_Q8}
    rows = {}
    for weights in ('int8', 'bf16'):
        gc.collect()
        torch.cuda.empty_cache()
        int8 = weights == 'int8'
        q = '_q8' if int8 else ''

        def profile(kind, fn, extra, weights=weights):
            profile_cuda(torch, fn, 'SERVE_8B_PROFILE',
                         dict(extra, weights=weights, kind=kind))
        row = serve_8b_point(torch, weights, counts,
                             profile if int8 else None)
        toks = row.pop('toks')
        want = {name: 0 for name in counts}
        want.update({'flash_fwd': L, 'decode_attention' + q: L * (new - 1),
                     'rope_cache_write' + q: L * new})
        row['launches_expected'] = want
        log('SERVE_8B ' + json.dumps(row))
        assert toks.shape == (SERVE_8B['batch'], new) and bool(
            ((toks >= 0) & (toks < config.vocab_size)).all())
        assert row['launches'] == want, (row['launches'], want)
        rows[weights] = row
    return rows


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def _int8_engine_off(torch, attention, da):
    """One engine-off TPOT on ``--quant int8`` (int8 weights, a bf16
    cache as in the JAX replica without the engine): a 1024-token
    prompt, 32 new tokens, K1, K4 and K5F (and K5, none) counted."""
    from skypilot_torch.models import llama
    from skypilot_torch.recipes import serve_model
    args = serve_model.parse_args(['--model', 'llama3-8b', '--port', '0',
                                   '--device', 'cuda', '--quant', 'int8'])
    config = llama.get_config(args.model)
    server, generate = serve_model.build_server(args)
    try:
        gen = torch.Generator().manual_seed(35)
        prompt = torch.randint(0, config.vocab_size, (1024,),
                               generator=gen).tolist()
        max_new = 32
        torch.cuda.synchronize()
        counts = dict(flash_fwd=attention.FLASH_FWD,
                      decode_attention=da.DECODE_ATTENTION,
                      rope_cache_write=da.ROPE_CACHE_WRITE,
                      cache_write=da.CACHE_WRITE)
        for kern in counts.values():
            kern.launches = 0
        t0 = time.perf_counter()
        ids = generate(prompt, max_new)
        total_ms = 1e3 * (time.perf_counter() - t0)
        launches = {name: kern.launches for name, kern in counts.items()}
        t0 = time.perf_counter()
        generate(prompt, 1)
        ttft_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        server.server_close()
    L = config.n_layers
    want = dict(flash_fwd=L, decode_attention=L * (max_new - 1),
                rope_cache_write=L * max_new, cache_write=0)
    row = dict(model=args.model, quant='int8', kv='bf16', prompt=1024,
               n_out=len(ids), latency_ms=total_ms, ttft_ms=ttft_ms,
               tpot_ms=(total_ms - ttft_ms) / (max_new - 1),
               launches=launches, launches_expected=want)
    log('INT8_ENGINE_OFF ' + json.dumps(row))
    assert len(ids) == max_new and launches == want, row
    return row


def int8_phase(torch, attention, da):
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    _int8_numerics(torch)
    serve8b = _serve_8b(torch, attention, da)
    replica = engine_phase(torch, attention, da, quant=True)
    gc.collect()
    torch.cuda.empty_cache()
    engine_off = _int8_engine_off(torch, attention, da)
    return dict(serve_8b=serve8b, replica=replica, engine_off=engine_off)


# ---------------------------------------------------------------------
# QLoRA: the JAX bench's headline row through the port's train step
# ---------------------------------------------------------------------


def qlora_phase(torch, attention):
    """``_qlora_probe``'s shape: llama3.1-8b (32 layers), an int8 frozen
    base (``init_qlora_state``), bf16 LoRA rank 16, seq 2048, batch 4,
    ``remat_saves='attn'``, the probe's optimizer (clip 1.0, AdamW lr
    1e-3, b2 0.95); one warm-up step and three counted steps on one
    fixed batch, the launch counts zeroed just before and read just
    after (K1-RoPE 2 x 32 x 3 with the checkpoint's recompute, pre-pass
    = K2 = K3 = 32 x 3). The losses must fall."""
    import gc

    from skypilot_torch.models import llama
    from skypilot_torch.parallel import train as train_lib
    gc.collect()
    torch.cuda.empty_cache()
    seq, batch_size, rank, n_steps = 2048, 4, 16, 3
    config = llama.get_config('llama3.1-8b', max_seq_len=seq,
                              remat_saves='attn')
    optimizer = train_lib.AdamW(learning_rate=1e-3, weight_decay=1e-4,
                                b1=0.9, b2=0.95, eps=1e-8, grad_clip=1.0)
    t0 = time.perf_counter()
    state = train_lib.init_qlora_state(config, seed=0, lora_rank=rank,
                                       optimizer=optimizer, device='cuda')
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step_fn = train_lib.build_train_step(config, optimizer=optimizer)
    gen = torch.Generator().manual_seed(36)
    batch = {'tokens': torch.randint(0, config.vocab_size,
                                     (batch_size, seq + 1),
                                     generator=gen).cuda()}
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    warm = dict(loss=float(metrics['loss']),
                grad_norm=float(metrics['grad_norm']),
                ms=1e3 * (time.perf_counter() - t0))
    kernels = {'flash_fwd': attention.FLASH_FWD,
               'flash_fwd_rope': attention.FLASH_FWD_ROPE,
               'flash_bwd_prep': attention.FLASH_BWD_PREP,
               'flash_bwd_dq': attention.FLASH_BWD_DQ,
               'flash_bwd_dkv': attention.FLASH_BWD_DKV}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    steps = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics['loss'])  # waits for the step
        steps.append(dict(ms=1e3 * (time.perf_counter() - t0), loss=loss,
                          grad_norm=float(metrics['grad_norm'])))
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    L = config.n_layers
    want = {'flash_fwd': 0, 'flash_fwd_rope': 2 * L * n_steps,
            'flash_bwd_prep': L * n_steps, 'flash_bwd_dq': L * n_steps,
            'flash_bwd_dkv': L * n_steps}
    total_s = sum(st['ms'] for st in steps) / 1e3
    tokens_per_s = n_steps * batch_size * seq / total_s
    losses = [warm['loss']] + [st['loss'] for st in steps]
    row = dict(model='llama3.1-8b', layers=L, base='int8', lora_rank=rank,
               seq=seq, batch=batch_size, remat_saves='attn',
               setup_s=setup_s, warmup=warm, steps=steps,
               step_ms_mean=1e3 * total_s / n_steps,
               tokens_per_s=tokens_per_s,
               mfu_4n=tokens_per_s * 4 * config.num_params() /
               PEAK_BF16_FLOPS,
               max_memory_allocated_gb=peak / 1e9, losses=losses,
               loss_decreasing=all(b < a for a, b in zip(losses,
                                                          losses[1:])),
               launches=launches, launches_expected=want)
    log('QLORA ' + json.dumps(row))
    assert all(math.isfinite(x) for x in losses), losses
    assert launches == want, (launches, want)
    assert row['loss_decreasing'], f'QLoRA losses did not fall: {losses}'

    def one_step():
        nonlocal state
        state, m = step_fn(state, batch)
        float(m['loss'])
    profile_cuda(torch, one_step, 'QLORA_PROFILE',
                 dict(model='llama3.1-8b', seq=seq, batch=batch_size))
    del state, metrics
    return dict(launches=launches)


def _matmul_entry(line):
    """The kernels line's numbers of the invariant GEMM at a decode step
    (M = 8) of one shape: kernel, cuBLAS (the plain version is the
    library call) and bound."""
    t = line['times'][8]
    return dict(shape=[8, line['K'], line['N']],
                max_abs_err=line['max_abs_err'], ms=t['kernel_ms'],
                plain_ms=t['cublas_ms'], bound_ms=t['bound_ms'],
                bound_by=t['bound_by'], library_ms=t['cublas_ms'])


def k4_smem_plan_check(_build, da):
    """The wrapper's copy of K4's shared-memory layout
    (``decode_smem_bytes``, which its checks use before a launch) against
    the kernel's own (``skypilot_decode_smem_bytes``), for every head_dim
    x group x int8 instantiation, one m-tile (W x G <= 16) or several,
    dense and paged, and a 512-row prefill chunk."""
    import ctypes
    fn = _build.load('decode_attention').skypilot_decode_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    checked, bad = 0, []
    for hd in da.DECODE_HEAD_DIMS:
        for g in da.DECODE_GROUPS:
            for q8 in (False, True):
                for w in (1, 2, 9, 512):
                    for pages in (0, 4, da.DECODE_CHUNK // 8):
                        args = (hd, q8, 32 // g, pages, w * g)
                        want = fn(hd, int(q8), *args[2:])
                        got = da.decode_smem_bytes(*args)
                        checked += 1
                        if got != want:
                            bad.append(dict(args=args, python=got,
                                            kernel=want))
    return dict(smem_plan_checked=checked, smem_plan_mismatches=bad)


def prefill_smem_plan_check(_build, da):
    """The wrapper's copies of K4-prefill's shared-memory layout
    (``prefill_smem_bytes``) and of its partials' size
    (``prefill_plan``'s scratch) against the kernel's own
    (``skypilot_prefill_smem_bytes``, ``skypilot_prefill_part_floats``),
    for each head_dim and group, bf16 and int8, dense and tables of 69,
    514 and 1026 pages of 16 rows; the largest block must fit."""
    import ctypes
    lib = _build.load('prefill_attention')
    smem = lib.skypilot_prefill_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_int
    part = lib.skypilot_prefill_part_floats
    part.argtypes = [ctypes.c_int] * 7
    part.restype = ctypes.c_longlong
    checked, bad, most = 0, [], 0
    for hd in da.DECODE_HEAD_DIMS:
        for g in da.DECODE_GROUPS:
            for q8 in (False, True):
                for mb in (0, 69, 514, 1026):
                    s = 16 * max(mb, 69)
                    plan = da.prefill_plan(1, 512, 32 // g, g, hd, q8, s, mb)
                    want = (smem(hd, int(q8), mb, plan['n_split']),
                            part(1, 512, 32, 32 // g, hd, s, plan['chunk']))
                    got = (plan['smem'], plan['scratch'])
                    checked += 1
                    most = max(most, got[0])
                    if got != want:
                        bad.append(dict(args=(hd, g, q8, mb), python=got,
                                        kernel=want))
    if most > da.DECODE_MAX_SMEM:
        bad.append(dict(largest=most, limit=da.DECODE_MAX_SMEM))
    return dict(smem_plan_checked=checked, smem_plan_mismatches=bad,
                largest_smem=most)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--phases', default=','.join(PHASES),
                        help=f'comma-separated subset of {PHASES}')
    phases = parser.parse_args().phases.split(',')
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    try:
        import torch.nn.functional as F

        from skypilot_torch.ops import _build
        from skypilot_torch.ops import attention
        from skypilot_torch.ops import decode_attention as da
    except ImportError as e:
        print(f'chip_smoke: the skypilot_torch package is not beside this '
              f'script ({e})', file=sys.stderr)
        return 2
    # Spans, profiles and published metrics of this run stay inside the
    # checkout (build/ is ignored by git).
    state = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'build', 'smoke_state')
    shutil.rmtree(state, ignore_errors=True)
    os.environ['SKYTPU_STATE_DIR'] = state
    smi = smi_line()
    log(f'card: {smi}')
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]} '
        f'device {torch.cuda.get_device_name(0)}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} '
        f'cudnn={torch.backends.cudnn.allow_tf32}')
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f'kernels built in {time.perf_counter() - t0:.1f} s')
    # K2/K3, every K4 instantiation and the row kernels (rms_norm, top_p)
    # must not spill (checked after the phases).
    bwd_spills, k4_entries, pre_entries, row_spills = [], [], [], []
    for name, path in libs.items():
        for entry in ptxas_report(path[:-len('.so')] + '.log'):
            log('BUILD ' + json.dumps(dict(library=name, **entry)))
            spills = entry.get('spill_stores') or entry.get('spill_loads')
            if name == 'flash_bwd' and spills:
                bwd_spills.append(entry)
            if name in ('rms_norm', 'top_p') and spills:
                row_spills.append(entry)
            if 'decode_kernel' in entry['kernel']:
                k4_entries.append(entry)
            if 'prefill_kernel' in entry['kernel']:
                pre_entries.append(entry)
    k4_spills = [e for e in k4_entries
                 if e.get('spill_stores') or e.get('spill_loads')]
    # The invariant GEMM is a wgmma kernel: HGMMA in each of its six
    # instantiations' SASS (bucket x form), with ptxas's registers and
    # spills.
    mm_path = libs['matmul_invariant']
    hgmma = sass_counts(mm_path, 'HGMMA')
    mm_entries = [e for e in ptxas_report(mm_path[:-len('.so')] + '.log')
                  if 'matmul_kernel' in e['kernel']]
    # The clusters of each size the card holds at once, held against the
    # plan's table (ops/matmul_invariant.MATMUL_CLUSTERS): a call whose
    # clusters exceed them would run a second wave.
    import ctypes

    from skypilot_torch.ops import matmul_invariant as mi
    max_clusters = _build.load('matmul_invariant').skypilot_matmul_max_clusters
    max_clusters.argtypes = [ctypes.c_int] * 3
    max_clusters.restype = ctypes.c_int
    clusters = {f'nwg{w}_{f}': {z: max_clusters(w, fi, z)
                                for z in mi.MATMUL_CLUSTERS}
                for w in (1, 2) for fi, f in enumerate(('bf16', 'bf16_t',
                                                        'int8'))}
    log('MATMUL_BUILD ' + json.dumps(dict(
        card=smi, instantiations=len(mm_entries),
        sass_hgmma_lines=hgmma, entries=mm_entries,
        max_active_clusters=clusters,
        plan_clusters=mi.MATMUL_CLUSTERS)))
    assert len(mm_entries) == 6, mm_entries
    short = {(inst, z): n for inst, per in clusters.items()
             for z, n in per.items() if n < mi.MATMUL_CLUSTERS[z]}
    assert not short, ('the card holds fewer clusters than the GEMM\'s plan '
                       f'counts on (a second wave): {short}')
    if hgmma is not None:
        mm_sass = {f: c for f, c in hgmma.items() if 'matmul_kernel' in f}
        assert len(mm_sass) == 6 and all(mm_sass.values()), hgmma
    # Dynamic shared memory of a K4 block at llama3-8b's shapes (Hkv 8,
    # 16-row pages, the split plan's chunk): W 1 and W 9, bf16 and int8.
    smem_plan = k4_smem_plan_check(_build, da)
    log('K4_BUILD ' + json.dumps(dict(
        instantiations=len(k4_entries),
        max_registers=max((e.get('registers', 0) for e in k4_entries),
                          default=None),
        spilling=len(k4_spills),
        dynamic_smem={f'{"int8" if q8 else "bf16"} W{w}':
                      da.decode_smem_bytes(128, q8, 8, da.DECODE_CHUNK
                                           // 16, 4 * w)
                      for q8 in (False, True) for w in (1, 9)},
        **smem_plan)))
    assert not smem_plan['smem_plan_mismatches'], (
        'K4: the wrapper\'s shared-memory plan differs from the kernel\'s '
        f'layout: {smem_plan["smem_plan_mismatches"]}')
    pre_plan = prefill_smem_plan_check(_build, da)
    pre_spills = [e for e in pre_entries
                  if e.get('spill_stores') or e.get('spill_loads')]
    log('K4_PREFILL_BUILD ' + json.dumps(dict(
        instantiations=len(pre_entries),
        max_registers=max((e.get('registers', 0) for e in pre_entries),
                          default=None),
        spilling=len(pre_spills), **pre_plan)))
    # head_dim x group x (dense bf16, paged bf16, paged int8).
    assert len(pre_entries) == 24 and not pre_spills, (
        f'K4-prefill: {len(pre_entries)} instantiations built (24 '
        f'expected), spilling: {pre_spills}')
    assert not pre_plan['smem_plan_mismatches'], pre_plan
    if 'k1' in phases:
        k1 = k1_phase(torch, F, attention)
    if 'k4' in phases:
        k4 = k4_phase(torch, F, da)
    if 'e2e' in phases:
        e2e_k5f = e2e_phase(torch)
    if 'serve' in phases:
        k1_n, k4_n, k5f_n = serve_phase(torch, attention, da)
    if 'k1r' in phases:
        k1r = k1r_phase(torch, F, attention)
    if 'bwd' in phases:
        prep, k2, k3 = bwd_phase(torch, F, attention)
    if 'train' in phases:
        train = train_phase(torch, attention)
    if 'k5' in phases:
        k5 = k5_phase(torch, da)
    if 'k5f' in phases:
        k5f = k5f_phase(torch, da)
    if 'k4p' in phases:
        k4p = k4p_phase(torch, F, da)
    if 'k4pre' in phases:
        pre, pre_q8 = k4pre_phase(torch, da)
    if 'invariance' in phases:
        inv = invariance_phase(torch, da)
    if 'engine' in phases:
        eng = engine_phase(torch, attention, da)
    if 'sampling' in phases:
        smp = sampling_phase(torch, attention, da)
    if 'adapters' in phases:
        adp = adapters_phase(torch, attention, da)
    if 'rows' in phases:
        rows_n = rows_phase(torch, da)
    if 'k6' in phases:
        k6 = k6_phase(torch, F, attention)
    if 'int8k' in phases:
        int8k = int8k_phase(torch, F, da)
    if 'int8' in phases:
        int8 = int8_phase(torch, attention, da)
    if 'qlora' in phases:
        qlora = qlora_phase(torch, attention)
    assert not bwd_spills, f'the backward kernels spill: {bwd_spills}'
    assert not row_spills, f'the norm or nucleus kernels spill: {row_spills}'
    assert len(k4_entries) == 32 and not k4_spills, (
        f'K4: {len(k4_entries)} instantiations built (32 expected), '
        f'spilling: {k4_spills}')
    if set(phases) != set(PHASES):
        return 0
    s8 = {w: int8['serve_8b'][w]['launches'] for w in ('int8', 'bf16')}
    ad_b, ov_b = adp['adapter_burst'], adp['overload_burst']
    rep = int8['replica']
    off = int8['engine_off']['launches']
    k1_launches = dict(
        serve=k1_n, sampled=smp['flash_fwd'],
        train_rope=train['launches']['flash_fwd_rope'],
        qlora_rope=qlora['launches']['flash_fwd_rope'],
        serve_8b_int8=s8['int8']['flash_fwd'],
        serve_8b_bf16=s8['bf16']['flash_fwd'],
        engine_off_int8_weights=off['flash_fwd'])
    k5f_launches = dict(
        engine=eng['rope_cache_write'], rows=2 * rows_n,
        sampled=smp['rope_cache_write'], adapters=ad_b['rope_cache_write'],
        overload=ov_b['rope_cache_write'], int8=rep['rope_cache_write_q8'],
        serve=k5f_n, e2e=e2e_k5f,
        serve_8b_bf16=s8['bf16']['rope_cache_write'],
        serve_8b_int8_kv=s8['int8']['rope_cache_write_q8'],
        engine_off_int8_weights=off['rope_cache_write'])
    k4_launches = dict(serve=k4_n, rows=rows_n,
                       serve_8b_bf16=s8['bf16']['decode_attention'],
                       engine_off_int8_weights=off['decode_attention'],
                       serve_8b_int8_kv=s8['int8']['decode_attention_q8'])
    bursts = (eng, smp, ad_b, ov_b, rep)
    prefill = dict(engine=eng['prefill_attention'],
                   sampled=smp['prefill_attention'],
                   adapters=ad_b['prefill_attention'],
                   overload=ov_b['prefill_attention'])
    # 'launches' sums every main path's run; the launches_* keys split
    # it by path, and the int8 forms of K4/K5 (the same templates over
    # int8 codes) carry their own counts and numbers under 'int8'.
    kernels = [
        # Top-level numbers: the serving path's prefill (no RoPE, B=1,
        # T=S=2048); 'rope': the training step's shape with fused RoPE.
        dict(name='flash_fwd', route='cuda',
             source='skypilot_torch/csrc/flash_fwd.cu',
             replaces='skypilot_tpu/ops/attention.py:170',
             launches=sum(k1_launches.values()),
             **{f'launches_{k}': v for k, v in k1_launches.items()},
             **k1, rope=k1r),
        dict(name='flash_bwd_prep', route='cuda',
             source='skypilot_torch/csrc/flash_bwd.cu',
             replaces='skypilot_tpu/ops/attention.py:505',
             launches=(train['launches']['flash_bwd_prep'] +
                       qlora['launches']['flash_bwd_prep']),
             launches_train=train['launches']['flash_bwd_prep'],
             launches_qlora=qlora['launches']['flash_bwd_prep'], **prep),
        dict(name='flash_bwd_dq', route='cuda',
             source='skypilot_torch/csrc/flash_bwd.cu',
             replaces='skypilot_tpu/ops/attention.py:263',
             launches=(train['launches']['flash_bwd_dq'] +
                       qlora['launches']['flash_bwd_dq']),
             launches_train=train['launches']['flash_bwd_dq'],
             launches_qlora=qlora['launches']['flash_bwd_dq'], **k2),
        dict(name='flash_bwd_dkv', route='cuda',
             source='skypilot_torch/csrc/flash_bwd.cu',
             replaces='skypilot_tpu/ops/attention.py:331',
             launches=(train['launches']['flash_bwd_dkv'] +
                       qlora['launches']['flash_bwd_dkv']),
             launches_train=train['launches']['flash_bwd_dkv'],
             launches_qlora=qlora['launches']['flash_bwd_dkv'], **k3),
        dict(name='decode_attention', route='cuda',
             source='skypilot_torch/csrc/decode_attention.cu',
             replaces='skypilot_tpu/ops/decode_attention.py:123',
             launches=sum(k4_launches.values()),
             **{f'launches_{k}': v for k, v in k4_launches.items()},
             launches_int8=k4_launches['serve_8b_int8_kv'],
             **k4, int8=int8k['decode_attention']),
        # K4-prefill: the engine's prefill chunks, one launch a layer.
        dict(name='prefill_attention', route='cuda',
             source='skypilot_torch/csrc/prefill_attention.cu',
             replaces='skypilot_tpu/ops/decode_attention.py:123',
             launches=sum(prefill.values()),
             **{f'launches_{k}': v for k, v in prefill.items()}, **pre),
        dict(name='prefill_attention_q8', route='cuda',
             source='skypilot_torch/csrc/prefill_attention.cu',
             replaces='skypilot_tpu/ops/decode_attention.py:123',
             launches=rep['prefill_attention_q8'],
             launches_int8=rep['prefill_attention_q8'], **pre_q8),
        # The engine slice: launches from its 12-request replica runs,
        # bf16 and int8.
        dict(name='decode_attention_paged', route='cuda',
             source='skypilot_torch/csrc/decode_attention.cu',
             replaces='skypilot_tpu/ops/decode_attention.py:123',
             launches=(eng['paged_w1'] + eng['paged_verify'] +
                       smp['paged_w1'] + smp['paged_verify'] +
                       ad_b['paged_w1'] + ad_b['paged_verify'] +
                       ov_b['paged_w1'] + ov_b['paged_verify'] +
                       rep['paged_w1_q8'] + rep['paged_verify_q8'] +
                       rows_n),
             launches_decode_w1=eng['paged_w1'],
             launches_verify=eng['paged_verify'], launches_rows=rows_n,
             launches_sampled=smp['paged_w1'] + smp['paged_verify'],
             launches_sampled_decode_w1=smp['paged_w1'],
             launches_sampled_verify=smp['paged_verify'],
             launches_adapters_decode_w1=ad_b['paged_w1'],
             launches_adapters_verify=ad_b['paged_verify'],
             launches_overload_decode_w1=ov_b['paged_w1'],
             launches_overload_verify=ov_b['paged_verify'],
             launches_int8=rep['paged_w1_q8'] + rep['paged_verify_q8'],
             launches_int8_decode_w1=rep['paged_w1_q8'],
             launches_int8_verify=rep['paged_verify_q8'],
             **k4p, int8=int8k['decode_attention_paged']),
        # K5: no serving path runs it since K5F writes the prefill chunk
        # too; held by its own phase (k5), its launches on the main paths
        # counted all the same (0).
        dict(name='cache_write', route='cuda',
             source='skypilot_torch/csrc/decode_attention.cu',
             replaces='skypilot_tpu/ops/decode_attention.py:389',
             launches=(eng['cache_write'] + smp['cache_write'] +
                       ad_b['cache_write'] + ov_b['cache_write'] +
                       rep['cache_write_q8']),
             launches_engine=eng['cache_write'],
             launches_sampled=smp['cache_write'],
             launches_adapters=ad_b['cache_write'],
             launches_overload=ov_b['cache_write'],
             launches_int8=rep['cache_write_q8'], **k5,
             int8=int8k['cache_write']),
        # K5F: every serving forward's new rows, one launch a layer.
        dict(name='rope_cache_write', route='cuda',
             source='skypilot_torch/csrc/decode_attention.cu',
             replaces='skypilot_tpu/ops/decode_attention.py:389',
             launches=sum(k5f_launches.values()),
             **{f'launches_{k}': v for k, v in k5f_launches.items()},
             **k5f['bf16'], int8=k5f['int8']),
        # Not ports of TPU kernels: the batch-invariance repair of the
        # serving path's products (the JAX package leaves them to XLA)
        # and of the sampler's nucleus threshold; 'replaces' names the
        # JAX function each computes.
        dict(name='matmul_invariant', route='cuda',
             source='skypilot_torch/csrc/matmul_invariant.cu',
             replaces='skypilot_tpu/models/llama.py:326',
             launches=sum(b['matmul'] + b['matmul_q8'] for b in bursts),
             launches_engine=eng['matmul'], launches_sampled=smp['matmul'],
             launches_adapters=ad_b['matmul'],
             launches_overload=ov_b['matmul'],
             launches_int8=rep['matmul_q8'],
             **_matmul_entry(inv['matmul']['bf16']),
             int8=_matmul_entry(inv['matmul']['int8']),
             shapes=inv['matmul_rows']),
        dict(name='lora_delta', route='cuda',
             source='skypilot_torch/csrc/matmul_invariant.cu',
             replaces='skypilot_tpu/models/decode.py:304',
             launches=(ad_b['lora_mid'] + ov_b['lora_mid'] +
                       ad_b['lora_delta'] + ov_b['lora_delta']),
             launches_mid=ad_b['lora_mid'] + ov_b['lora_mid'],
             launches_out=ad_b['lora_delta'] + ov_b['lora_delta'],
             launches_adapters=ad_b['lora_mid'] + ad_b['lora_delta'],
             launches_overload=ov_b['lora_mid'] + ov_b['lora_delta'],
             **{k: inv['lora'][k] for k in (
                 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                 'library_ms')}),
        dict(name='rms_norm', route='cuda',
             source='skypilot_torch/csrc/rms_norm.cu',
             replaces='skypilot_tpu/models/llama.py:339',
             launches=sum(b['rms_norm'] for b in bursts),
             launches_engine=eng['rms_norm'], launches_sampled=smp['rms_norm'],
             launches_adapters=ad_b['rms_norm'],
             launches_overload=ov_b['rms_norm'],
             launches_int8=rep['rms_norm'],
             **{k: inv['rms_norm'][k] for k in (
                 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                 'library_ms')}),
        dict(name='add_rms_norm', route='cuda',
             source='skypilot_torch/csrc/rms_norm.cu',
             replaces='skypilot_tpu/models/llama.py:339',
             launches=sum(b['add_rms_norm'] for b in bursts),
             launches_engine=eng['add_rms_norm'],
             launches_sampled=smp['add_rms_norm'],
             launches_adapters=ad_b['add_rms_norm'],
             launches_overload=ov_b['add_rms_norm'],
             launches_int8=rep['add_rms_norm'],
             **{k: inv['rms_norm']['fused'][8][k] for k in (
                 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                 'library_ms', 'add_plus_new_norm_ms')},
             rows_512={k: inv['rms_norm']['fused'][512][k] for k in (
                 'ms', 'add_plus_new_norm_ms', 'bound_ms', 'input_sets')}),
        dict(name='top_p_kth', route='cuda',
             source='skypilot_torch/csrc/top_p.cu',
             replaces='skypilot_tpu/serve/sampling/sample.py:35',
             launches=smp['top_p_kth'], launches_sampled=smp['top_p_kth'],
             **{k: inv['top_p'][k] for k in (
                 'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                 'library_ms', 'ms_72', 'bound_ms_72', 'plan')}),
        # Its main path is its entry point, bench_main().
        dict(name='packed_flash_fwd', route='cuda',
             source='skypilot_torch/csrc/attention_packed.cu',
             replaces='skypilot_tpu/ops/attention_packed.py:38', **k6),
    ]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
