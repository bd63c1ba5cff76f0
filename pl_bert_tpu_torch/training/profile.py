"""Where a training step's device time goes, from ``torch.profiler``::

    python -m pl_bert_tpu_torch.training.profile [--steps 3]
        [--attention_impl auto|pallas|xla] [--packed] [--multitask]

Runs the port's train step at bench.py's workload (configs/config.yml's
model: hidden 768, 12 heads, FFN 2048, 12 layers, L 512; bf16, dropout
0.1, AdamW at 7e-5; random weights from a seed) on the CUDA card: the batch and dropout
are ``Config()``'s, as in bench.py; two warm-up steps, then ``--steps``
steps under the profiler. ``--attention_impl`` picks the model's
attention path (``pallas``: the per-head flash kernels K7/K8);
``--packed`` feeds packed rows of a synthetic corpus (several samples a
row, segment and position ids) and masks them on the device inside the
step, as a run with ``ondevice_masking`` and ``sequence_packing`` does;
without it the batches are full-length and masked on the host.
``--multitask`` profiles bench.py's production run
(``bench.py::run_production``): the multi-task model with the 60,000-word
grapheme head, packed short samples (8-30 words) with their grapheme
ids, masked on the device, ``attention_impl: pallas``, the fused head at
capacity 144 and gradient accumulation 2 (two micro-batches of 96 a
step). Prints the card and its power limit (``nvidia-smi``), the step
time, device time per step by kernel and by group (the port's kernels,
cuBLAS GEMMs, the rest), the device's busy share of the window, and its
SM clock and power draw at the window's end (``nvidia-smi``); for
the multi-task model also the grapheme head's device time by part (the
gather, the logits, ``dh`` and ``dW`` GEMMs, the CE's elementwise
passes, from ``ops/masked_ce.py``'s ``lm_head.*`` spans), the encoder
and the rest apart, and what each capacity read costs (the host's wait,
the device's idle gap after it). Needs a CUDA card; there is no CPU
fallback.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

# kernel-name substrings → group, first match wins (the port's CUDA
# kernels carry their template arguments in the demangled name)
GROUPS = (
    # the block path's K3/K4 and the flash path's K7/K8 run the same
    # attention kernels (csrc/attention_tiles.cuh); one path a run
    ("attention_fwd", "K3 / K7 attention forward"),
    ("gemm_bias_sm90<false>", "K3 projections (wgmma)"),
    ("gemm_bias_sm90<true>", "K4 dx projection (wgmma)"),
    ("gemm_bias<__nv_bfloat16, true>", "K4 do projection (CUDA cores)"),
    ("attention_bwd_delta", "K4 attention backward: delta pass"),
    ("attention_bwd_dq", "K4 / K8 attention backward: dq"),
    ("attention_bwd_dkdv", "K4 / K8 attention backward: dk/dv"),
    ("ln_fwd", "K5 LN forward (CUDA)"),
    ("ln_bwd", "K6 LN backward (CUDA; with its dgamma/dbeta reduction)"),
    *((key, "cuBLAS GEMMs (FFN, heads, weight gradients)")
      for key in ("gemm", "nvjet", "cutlass", "xmma")),
)


def group_of(name: str) -> str:
    for key, group in GROUPS:
        if key in name:
            return group
    return "other (elementwise, reductions, optimizer, copies)"


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (µs in)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


# the grapheme head's parts: ops/masked_ce.py's lm_head.* spans
HEAD_PARTS = ("gather", "logits", "ce", "dh", "dW")
CAPACITY_READ = "lm_head.capacity_read"


def head_parts(events) -> dict:
    """Device ms of each grapheme-head part: the kernels launched inside
    the host's ``lm_head.<part>`` ranges."""
    parts = dict.fromkeys(HEAD_PARTS, 0.0)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("lm_head."):
            part = e.name[len("lm_head."):]
            if part in parts:
                parts[part] += e.device_time_total / 1e3
    return parts


def capacity_reads(events, kernels) -> list[tuple[float, float]]:
    """(host ms waiting, device ms idle after) of every capacity read:
    the read's own span, and the gap between the last kernel to end
    before the read returned and the first to start after it."""
    starts = sorted(e.time_range.start for e in kernels)
    ends = sorted(e.time_range.end for e in kernels)
    out = []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name == CAPACITY_READ:
            done = e.time_range.end
            before = [t for t in ends if t <= done]
            after = [t for t in starts if t >= done]
            idle = (after[0] - before[-1]) / 1e3 if before and after else 0.0
            out.append((e.time_range.elapsed_us() / 1e3, idle))
    return out


def production_pool(tp, L: int, accum: int, n_steps: int, token_vocab: int):
    """bench.py's production batches: 6000 short samples (8-30 words)
    with random grapheme ids, packed into rows of ``L``, as ``n_steps``
    stacked [accum, B, L] super-batches; and the rows' occupancy."""
    import numpy as np

    from pl_bert_tpu_torch.data.packed import PackedSequenceDataset
    from pl_bert_tpu_torch.training.train import make_synthetic_corpus

    corpus = make_synthetic_corpus(6000, token_vocab=token_vocab, words_per_sample=(8, 30))
    packed = PackedSequenceDataset(corpus, L)
    micro = list(packed.batches(tp.batch_size, epoch=1, seed=tp.seed))[: accum * n_steps]
    pool = [{k: np.stack([m[k] for m in micro[i: i + accum]]) for k in micro[0]}
            for i in range(0, len(micro), accum)]
    return pool, packed.packing_efficiency


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="profile the port's train step on the card")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=25, help="kernels listed by device time")
    parser.add_argument("--json", default=None, help="also write the numbers here")
    parser.add_argument("--attention_impl", default=None,
                        help="the model's attention path (default: the config's, auto)")
    parser.add_argument("--packed", action="store_true",
                        help="packed rows masked on the device inside the step")
    parser.add_argument("--multitask", action="store_true",
                        help="bench.py's production run: the 60k grapheme head, packed, "
                        "pallas, fused head at capacity 144, accumulation 2")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA card")
    import dataclasses

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.data.synthetic import full_length_batches
    from pl_bert_tpu_torch.models.albert import build_model, init_params
    from pl_bert_tpu_torch.training import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    config = Config()
    mp, tp = config.model_params, config.training_params
    accum = 1
    if args.multitask:  # bench.py's production run
        accum, args.packed = 2, True
        mp = dataclasses.replace(mp, num_token_vocab=60_000, attention_impl="pallas")
    if args.attention_impl:
        mp = dataclasses.replace(mp, attention_impl=args.attention_impl)
    L, batch, warmup = config.dataset_params.max_seq_length, tp.batch_size, 2
    model = init_params(build_model(mp, tp.mixed_precision), seed=0).to("cuda")
    tx = ts.make_optimizer(tp)
    state = ts.TrainState(model, tx.init(model))
    masking_params, occupancy = None, 1.0
    if args.multitask:
        from pl_bert_tpu_torch.data.masking import MaskingParams

        pool, occupancy = production_pool(tp, L, accum, 4, mp.num_token_vocab)
        masking_params = MaskingParams(max_seq_length=L)
    elif args.packed:
        from pl_bert_tpu_torch.data.masking import MaskingParams
        from pl_bert_tpu_torch.data.packed import PackedSequenceDataset
        from pl_bert_tpu_torch.training.train import make_synthetic_corpus

        packed = PackedSequenceDataset(make_synthetic_corpus(1024), L)
        occupancy = packed.packing_efficiency
        pool = list(packed.batches(batch, epoch=1, seed=tp.seed))[:4]
        masking_params = MaskingParams(max_seq_length=L)
    else:
        pool = full_length_batches(4, batch, L)
    step = ts.make_train_step(model, tx, seed=tp.seed, masking_params=masking_params,
                              grad_accum=accum, fused_lm_head=tp.fused_lm_head,
                              lm_head_capacity=tp.lm_head_capacity)
    for i in range(warmup):
        float(step(state, pool[i % len(pool)])[1]["loss"])

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            float(step(state, pool[(warmup + i) % len(pool)])[1]["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
        # the clock the window ran at: a card held to its power limit
        # runs its kernels slower
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    events = prof.events()
    # a record_function range (a user annotation) leaves a copy of itself
    # among the device's events: no kernel
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        raise SystemExit("profile: the trace holds no device activity")
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    busy = busy_ms(intervals)
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e3
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us() / 1e3
        rec[1] += 1
    by_group: dict[str, float] = {}
    for name, (ms, _) in by_name.items():
        by_group[group_of(name)] = by_group.get(group_of(name), 0.0) + ms
    n = args.steps
    print(f"attention_impl {mp.attention_impl}, "
          f"{f'packed rows at {occupancy:.0%} occupancy, masked on the device' if args.packed else 'full-length rows masked on the host'}")
    real = sum(int(pool[(warmup + i) % len(pool)]["lengths"].sum()) for i in range(n))
    if args.multitask:
        print(f"multi-task: grapheme head of {mp.num_token_vocab}, fused "
              f"{tp.fused_lm_head}, capacity {tp.lm_head_capacity}, {accum} micro-batches "
              f"a step; {real / n:,.0f} real tokens a step, "
              f"{real * 1e3 / wall_ms:,.0f} real tokens/s with the profiler on")
    print(f"B={batch}{f'x{accum}' if accum > 1 else ''} L={L} {tp.mixed_precision} "
          f"dropout {mp.dropout}: "
          f"{wall_ms / n:.1f} ms a step with the profiler on, "
          f"{device_ms / n:.1f} ms of kernels a step; device busy {busy / window:.1%} of "
          f"the window from first to last kernel, {busy / wall_ms:.1%} of the host wall time")
    print(f"SM clock, max SM clock, power draw at the window's end: {clocks}")
    print("by group, ms a step (share of kernel time):")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / n:9.3f}  {ms / device_ms:6.1%}  {group}")
    head, reads = {}, []
    if args.multitask:
        head = head_parts(events)
        reads = capacity_reads(events, kernels)
        head_ms = sum(head.values())
        print("the grapheme head by part, ms a step (its kernels inside the host's "
              "lm_head.* spans; the gradient's scatter through the gather counts as other):")
        for part in HEAD_PARTS:
            print(f"  {head[part] / n:9.3f}  {head[part] / device_ms:6.1%}  {part}")
        print(f"  {head_ms / n:9.3f}  {head_ms / device_ms:6.1%}  the head; the encoder and "
              f"the rest {(device_ms - head_ms) / n:.3f} ms")
        if reads:
            print(f"capacity reads: {len(reads) / n:.1f} a step; host wait "
                  f"{sum(r[0] for r in reads) / len(reads):.3f} ms, device idle after "
                  f"{sum(r[1] for r in reads) / len(reads):.4f} ms a read (mean); "
                  f"{sum(r[1] for r in reads) / n:.4f} ms idle a step")
    print(f"top {args.top} kernels, ms a step, calls a step:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    for name, (ms, calls) in top:
        print(f"  {ms / n:9.3f}  {calls / n:6.0f}  {name[:110]}")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"card": card, "clocks": clocks, "batch": batch, "steps": n,
                       "attention_impl": mp.attention_impl, "packed": args.packed,
                       "wall_ms_per_step": wall_ms / n, "kernel_ms_per_step": device_ms / n,
                       "busy_share_window": busy / window, "busy_share_wall": busy / wall_ms,
                       "groups_ms_per_step": {g: ms / n for g, ms in by_group.items()},
                       "head_ms_per_step": {p: ms / n for p, ms in head.items()},
                       "capacity_reads": reads,
                       "kernels_ms_per_step": {k: v[0] / n for k, v in by_name.items()}},
                      f, indent=1)


if __name__ == "__main__":
    main()
