#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, its training step and its
Trainer entry point once on one CUDA card.

    python3 chip_smoke.py

At the full width of the flagship model (configs/config.yml: hidden 768,
12 heads of 64, FFN 2048, 12 layers, embedding 128, vocab 188, L 512)
with random weights made from a fixed seed, in order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from the sources in this checkout, and shows that
   the bf16 attention kernels, forward and backward, run on the tensor
   cores: ``cuobjdump -sass`` counts the HGMMA (wgmma) and HMMA
   (mma.sync) instructions of the projection GEMM (``gemm_bias_sm90``),
   the attention pass (``attention_fwd_sm90``) and the backward's dq and
   dk/dv kernels (``attention_bwd_dq_sm90``, ``attention_bwd_dkdv_sm90``)
   in both libraries, and raises if any has no HGMMA; it prints what
   ``ptxas -v`` said of their registers, shared memory and spills, and of
   the fused LN library's (K5 and K6 at three slices a lane, bf16 and
   fp32, with and without dropout; K9: ``csrc/fused_ln.cu``), and counts
   the IMAD and LOP3 instructions one Philox draw of K5 and of K6 issues
   (the SASS with dropout less without, over the 24 draws a lane makes a
   row);
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes, in bf16 and fp32 (TF32 off); the block also
   at head_dim 128 (6 heads, L 200); K5 also at dropout 0.1, the plain
   version fed the mask of Triton's own ``tl.rand``;
4. runs the 12-layer encoder on the kernel path against the plain path;
5. writes the weights as a reference .pth and starts the port's HTTP
   server through its normal entry, in a thread;
6. answers 32 requests of 5-500 phonemes from 4 client threads and holds
   each answer against a direct PhonemeEncoder call; the same again from a
   server at ``--pipeline_depth 1``; then prints the pipeline line: how
   long a second ``dispatch`` holds its thread, how long before the end of
   batch N+1's forward ``fetch(N)`` returns, and the request latency at
   depth 1 and 2;
7. checks from the launch counters that every forward of that run went
   through the kernels (12 attention blocks, 24 fused LNs a forward);
8. times each kernel against its plain version, and the encoder forward
   at B=8, L=512 on both paths; K5 at [4096, 768] and [49152, 768] (past
   the L2), dropout 0 and 0.1, beside the library call (``F.dropout``,
   the add, ``F.layer_norm``) and its bound with the integer term of its
   draws (the kernels line takes [49152, 768] at dropout 0.1, where the
   bytes bound holds; the serving shape stays in L2); K1's projection
   GEMMs and attention pass
   each against its own bound (``torch.profiler``), and K2 (the fp32
   light forward) against its plain version and stock fp32 PyTorch;
9. holds the attention block's training forward (K3) against its plain
   version at [8, 512, 768] in bf16 and fp32 (output, qkv, context,
   softmax statistics), and checks the light forward (K1) returns K3's
   output bitwise, with attention dropout 0 and 0.1; the flash
   backward's (K8's) recomputed row max and denominator on views of
   K3's qkv must equal K3's saved ones bit for bit (bf16: the tensor-core
   kernels; fp32: the CUDA-core delta pass against the fp32 forward);
10. holds its backward (K4) against the plain backward on the same saved
   tensors (dx, dW, db), dropout 0 and 0.1 — at 0.1 the plain version
   gets the mask the kernels' Philox code writes, which must equal the
   plain Philox bit for bit; K4's ``do`` must equal the plain ``do`` bit
   for bit in bf16, and its delta and ds scratch are held against their
   plain versions fed K4's own ``do``;
11. holds the fused LN backward (K6) against its plain version, dropout
   0 and 0.1 (the mask from Triton's ``tl.rand``), and K5's and K6's masks
   against Triton's bit for bit at [49152, 768] for seeds 0, 1, 2^31 - 2
   and one the training step draws (K5's output against its plain version
   fed that mask, under the bf16 gate; K6's dx is zero exactly where the
   mask drops), with the plain ``tl_rand`` against Triton's uniform floats;
12. checks the keep rate of every dropout site at the training shape
   (0.9 ± 1e-3; the fused LN's read from K5's own output too, which must
   equal Triton's mask) and that a seed gives the same mask twice;
13. runs the train step (hidden 768, 12 heads, FFN 2048, 12 layers,
   L 512): 3 steps at B=8, dropout 0, on the kernel path against the
   plain path from the same weights and batches (loss and grad_norm per
   step), then bench.py's workload — B=96, bf16, dropout 0.1, AdamW at
   7e-5 — on the kernel path, 3 warm-up and 5 timed steps, with the
   launch counters read over the timed steps (per step: K3 12, K4 12,
   K5 24, K6 24, K1 0); then times K3, K4 and K6 at that shape against
   their plain versions and the library calls (K3 and K6 also at dropout
   0, K3's two parts against their bounds, K6's bound with its bytes,
   fp32 and integer terms), checks that two K6 calls give the same bits
   and holds each against
   its plain version there (K4 on K3's saved tensors, dropout 0.1 with
   the kernels' mask), as phases 9-11 do at B=8, K8's statistics bitwise
   K3's there too, and splits K4 into its projections and its delta,
   dk/dv and dq kernels (``torch.profiler``), each CUDA-core part beside
   the products it forms at the fp32 rate. The B=8 comparison also
   runs the per-head flash path (``attention_impl: pallas``) against the
   plain path;
14. holds the per-head flash attention kernels (K7 forward, K8 backward)
   against their plain versions at [8, 512, 12, 64] in bf16 and fp32 —
   padded rows, packed segments, dropout 0 and 0.1 (the kernels' mask,
   bit for bit the plain Philox), views of one fused projection — at
   L = 200, at head_dim 128 ([8, 200, 6, 128]), and at the training shape
   [96, 512, 12, 64]; holds the copy anchor (K9) bitwise against its
   plain version, also on a ragged count and an unaligned view; times
   K7, K8 and K9 against their plain versions and one library call each
   (K7 also at dropout 0), and splits K8 into its
   dq and dk/dv kernels;
15. runs the 12-layer encoder on the flash path against the plain path
   and the block path (in phase 4), and serves 8 HTTP requests from a
   server started with an ``attention_impl: pallas`` config: 12 K7 and
   24 K5 launches a forward, no block launch;
16. the packed run: ``pl_bert_tpu_torch.training.train.train()`` through
   its normal entry on ``synthetic:4096`` — flagship model,
   ``attention_impl: pallas``, on-device masking and sequence packing,
   B=96, bf16, dropout 0.1 — 8 steps with a checkpoint every 4, then
   the same call again with ``num_steps`` 12, which resumes from
   ``step_8.pth``; checks the losses, the packing line, the launch
   counters (12 K7, 12 K8, 24 K5, 24 K6 a training step, 12 K7 and 24 K5
   a validation forward, no block launch), the three checkpoints, and
   that ``step_12.pth`` loads strictly into a fresh model;
17. runs the fused-LN microbench (``tools/bench_fused_ln.py``: the copy
   anchor, K5, K5+K6 and the plain version over a 24-call chain at
   [49152, 768]) and prints its table.

Any failure raises and exits non-zero. The line before the last is a
JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import base64
import dataclasses
import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"  # cuda:0 — the one card this script needs

# tolerances, kernel against plain version on the same inputs:
# fp32 — the same arithmetic in another summation order (768/2048-deep
#   dot products, 512-key softmax sums): ~1e-6 relative;
# bf16 — both round q/k/v, the normalised probabilities, context and
#   outputs to bf16 at the same points, but after differently ordered fp32
#   sums, so a value near a rounding boundary lands one bf16 ulp (2^-8
#   relative; 1.6e-2 at the LN's outputs of magnitude ~4) apart. Few do:
#   rel-L2 ~3e-4 for the block (its tensor-core projections round ~1.6e-4
#   of qkv one ulp from the fp32 plain GEMM's, and the flips carry into
#   the probabilities), ~2e-5 for the LN on the card.
TOL = {
    "float32": {"max_abs": 1e-3, "rel_l2": 1e-5},
    "bfloat16": {"max_abs": 5e-2, "rel_l2": 1e-3},
}
# fp32 weight and bias gradients contracted over B·L = 4096 (or 49152)
# rows from the kernels' and the plain versions' compute-dtype dqkv (or
# ctx): sums of thousands of terms, each of which may carry a one-ulp bf16
# flip (the card read max-abs 1.4e-2 for dWo in bf16 at 4096 rows, 5.0e-3
# at 49152 on phase 13's inputs)
TOL_GRAD = {
    "float32": TOL["float32"],
    "bfloat16": {"max_abs": 1e-1, "rel_l2": 1e-3},
}
# the 12-layer encoder, kernel path against plain path (valid positions):
# each one-ulp flip feeds the next layer's bf16 roundings, so over 12
# layers the hidden states drift to about one bf16 ulp apart (rel-L2
# ~4e-3 on the card)
ENCODER_TOL = {
    "float32": {"max_abs": 1e-2, "rel_l2": 1e-4},
    "bfloat16": {"max_abs": 2e-1, "rel_l2": 1.5e-2},
}
# the train step, kernel path against plain path (3 steps, B=8, bf16,
# dropout 0, same weights and batches): loss and grad_norm relative
# differences per step. Both paths round to bf16 at the same points but
# sum in other orders, and the flips grow through 12 layers and 3
# updates; the card read at most 4.2e-5 (loss) and 3.1e-4 (grad_norm)
# (NVIDIA H100 80GB HBM3, 700 W), and the gates sit about 10x above.
TRAIN_TOL = {"loss": 5e-4, "grad_norm": 5e-3}
# dropout sites' keep rate at the training shape (0.9 ± 1e-3)
KEEP_TOL = 1e-3
# the H100's peak rates (NVIDIA's data sheet, SXM, dense) for the bounds
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# 32-bit integer results a clock an SM at compute capability 9.0, for
# multiply-adds (IMAD, IMAD.HI, IMAD.WIDE) and for logic ops (LOP3) alike,
# on two pipes (CUDA C++ Programming Guide, "Arithmetic Instructions",
# throughput table); times the SMs and the card's max SM clock
# (nvidia-smi clocks.max.sm) for the integer term of K5's and K6's bounds
INT_OPS_PER_SM_CLOCK = 64
# K5's and K6's element draws a row per lane at H = 768: three slices of 8
DRAWS_PER_LANE_ROW = 24
SEED = 0
BUCKETS = (64, 128, 256)
# name → (route, source, TPU kernel replaced, the path whose run counts it)
KERNELS = {
    "attention_block": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                        "pl_bert_tpu/ops/attention_block.py:253", "serving"),
    "dropout_add_layernorm": ("cuda", "pl_bert_tpu_torch/csrc/fused_ln.cu",
                              "pl_bert_tpu/ops/fused_ln.py:72", "serving"),
    "attention_block_train": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                              "pl_bert_tpu/ops/attention_block.py:116", "training"),
    "attention_block_bwd": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                            "pl_bert_tpu/ops/attention_block.py:315", "training"),
    "dropout_add_layernorm_bwd": ("cuda", "pl_bert_tpu_torch/csrc/fused_ln.cu",
                                  "pl_bert_tpu/ops/fused_ln.py:88", "training"),
    "flash_attention": ("cuda", "pl_bert_tpu_torch/csrc/flash_attention.cu",
                        "pl_bert_tpu/ops/flash_attention.py:47", "packed_run"),
    "flash_attention_bwd": ("cuda", "pl_bert_tpu_torch/csrc/flash_attention.cu",
                            "pl_bert_tpu/ops/flash_attention.py:73", "packed_run"),
    "add_copy": ("cuda", "pl_bert_tpu_torch/csrc/fused_ln.cu",
                 "tools/bench_fused_ln.py:110", "microbench"),
}
# the config of the packed run (phase 16), at the flagship width of
# configs/config.yml; {out} and {steps} are filled in
RUN_CONFIG = """\
training_params:
  output_dir: {out}
  mixed_precision: bf16
  batch_size: 96
  save_interval: 4
  log_interval: 1
  num_steps: {steps}
  learning_rate: 7.0e-5
  training_dataset: "synthetic:4096"
dataset_params:
  max_seq_length: 512
  ondevice_masking: true
  sequence_packing: true
model_params:
  hidden_size: 768
  num_attention_heads: 12
  intermediate_size: 2048
  max_position_embeddings: 512
  num_hidden_layers: 12
  dropout: 0.1
  attention_impl: pallas
"""
MAX_BATCH = 8
N_CLIENTS, PER_CLIENT = 4, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def max_sm_clock_mhz() -> float:
    """The card's max SM clock, MHz (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.splitlines()[0])


def all_counters() -> tuple:
    """Every kernel wrapper's launch counter, in ``KERNELS``' order."""
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import flash_attention as fa
    from pl_bert_tpu_torch.ops import fused_ln

    return (ab.LAUNCHES, fused_ln.LAUNCHES, ab.LAUNCHES_TRAIN, ab.LAUNCHES_BWD,
            fused_ln.LAUNCHES_BWD, fa.LAUNCHES, fa.LAUNCHES_BWD, fused_ln.LAUNCHES_COPY)


def reset_counters() -> tuple:
    counters = all_counters()
    for c in counters:
        c.reset()
    return counters


def read_counters(counters) -> dict:
    return {c.name: c.count for c in counters}


def errors(out, ref) -> dict:
    o, r = out.float(), ref.float()
    return {
        "max_abs": float((o - r).abs().max()),
        "rel_l2": float((o - r).norm() / r.norm().clamp_min(1e-30)),
    }


def gate(name: str, err: dict, tol: dict) -> None:
    ok = err["max_abs"] <= tol["max_abs"] and err["rel_l2"] <= tol["rel_l2"]
    log(f"  {name}: max_abs {err['max_abs']:.3e} rel_l2 {err['rel_l2']:.3e} "
        f"(tol {tol['max_abs']:.1e}/{tol['rel_l2']:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside tolerance: {err} vs {tol}")


def hold(results: dict, kernel: str, label: str, out, ref, tol: dict) -> None:
    """Gate a kernel's output against its plain version's and keep the
    error for the kernels line."""
    if not out.isfinite().all():
        raise AssertionError(f"{label}: non-finite")
    err = errors(out, ref)
    results[kernel].append(err["max_abs"])
    gate(label, err, tol)


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Time per call over ``iters`` back-to-back calls (CUDA events).
    Where the host launches slower than the device runs, this is the
    host's launch time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed and timed with CUDA events, so host launch cost is out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    ms = time_ms(torch, graph.replay, 5, warmup=1) / iters
    del graph
    return ms


def a_b(torch, plain, kernel, iters: int, timer=time_ms) -> tuple[float, float]:
    """Plain, kernel, kernel, plain on the same card; mean of each pair."""
    p1 = timer(torch, plain, iters)
    k1 = timer(torch, kernel, iters)
    k2 = timer(torch, kernel, iters)
    p2 = timer(torch, plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def random_state_dict(torch, cfg, seed: int) -> dict:
    """Encoder weights at the config's width from a numpy seed: matrices
    and embeddings N(0, initializer_range), biases N(0, 0.02), LayerNorm
    gamma 1 + N(0, 0.1) and beta N(0, 0.1)."""
    import numpy as np

    from pl_bert_tpu_torch.models.albert import AlbertModel

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in AlbertModel(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        noise = rng.standard_normal(shape, dtype=np.float32)
        if "LayerNorm" in k or "layer_norm" in k:
            arr = 1.0 + 0.1 * noise if k.endswith("weight") else 0.1 * noise
        elif k.endswith("bias"):
            arr = 0.02 * noise
        else:
            arr = cfg.initializer_range * noise
        sd[k] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return sd


def phoneme_text(rng, n: int) -> str:
    letters = "abdfhiklmnqrstuwzθðʃʕħɣχːˈ"
    words = []
    while sum(len(w) + 1 for w in words) < n:
        words.append("".join(rng.choice(list(letters), size=int(rng.integers(2, 9)))))
    return " ".join(words)[:n]


def http_json(conn, method: str, path: str, payload: dict | None = None) -> dict:
    """One request on an open ``http.client`` connection; the JSON answer,
    or an AssertionError for any status but 200."""
    body = None if payload is None else json.dumps(payload).encode()
    headers = {} if body is None else {"Content-Type": "application/json"}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise AssertionError(f"{method} {path}: HTTP {resp.status} {data[:300]!r}")
    return json.loads(data)


def encode_b64(conn, text: str):
    """POST /encode with the binary payload → (hidden [n, H] fp32, n)."""
    import numpy as np

    r = http_json(conn, "POST", "/encode",
                  {"phonemes": text, "encoding": "b64", "dtype": "float32"})
    hidden = np.frombuffer(base64.b64decode(r["hidden_b64"]), dtype=r["dtype"])
    return hidden.reshape(r["shape"]), int(r["length"])


def phase_tensor_cores(build) -> None:
    """2. the bf16 kernels that run on the tensor cores (the block's and
    the flash path's forward, the block backward's dx projection, the flash
    backward) have HGMMA (wgmma) instructions in their SASS; and what
    ptxas said of their registers, shared memory and spills."""
    import re

    def label(mangled: str) -> str:  # gemm_bias_sm90<1>, attention_bwd_dq_sm90<64, 1>, ...
        found = re.search(r"(gemm_bias_sm90|attention_\w+?_sm90)((?:I?L[ib]\d+E)*)", mangled)
        args = re.findall(r"L[ib](\d+)E", found.group(2))
        return found.group(1) + (f"<{', '.join(args)}>" if args else "")

    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    for lib in ("attention_block", "flash_attention"):
        sass = subprocess.run([cuobjdump, "-sass", str(build.build(lib))], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts, func = {}, None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                func = found.group(1)
                counts[func] = {"HGMMA": 0, "HMMA": 0}
            elif func and "HGMMA" in line:
                counts[func]["HGMMA"] += 1
            elif func and "HMMA" in line:
                counts[func]["HMMA"] += 1
        # the bf16 forward of both paths, K4's dx projection and K8 run wgmma
        kernels = (["attention_fwd_sm90", "gemm_bias_sm90"] if lib == "attention_block" else
                   ["attention_fwd_sm90", "attention_bwd_dq_sm90", "attention_bwd_dkdv_sm90"])
        for key in kernels:
            names = [f for f in counts if key in f]
            for f in names:
                log(f"  {lib}: {label(f)}: {counts[f]['HGMMA']} HGMMA, {counts[f]['HMMA']} HMMA")
            if not names or any(not counts[f]["HGMMA"] for f in names):
                raise AssertionError(f"{lib}: {key} has no wgmma (HGMMA) instructions")
        func = None
        for line in build.ptxas_report(lib).splitlines():
            found = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
            if found:
                func = found.group(1)
            elif func and "sm90" in func and ("Used" in line or "spill" in line):
                log(f"  ptxas {lib}: {label(func)}: {line.split(':', 1)[-1].strip()}")


def ln_label(mangled: str) -> str:
    """ln_fwd<bf16, 3, 1> or ln_bwd<f32, 3, 0> (dtype, slices, dropout),
    add_copy<f32> or ln_bwd_reduce from a mangled name of csrc/fused_ln.cu."""
    import re

    found = re.search(r"\d(ln_bwd_reduce|ln_fwd|ln_bwd|add_copy)[EI]", mangled)
    if not found:
        return mangled
    name = found.group(1)
    if name == "ln_bwd_reduce":
        return name
    args = ["bf16" if "__nv_bfloat16" in mangled else "f32"]
    if name in ("ln_fwd", "ln_bwd"):
        args += re.findall(r"Li(\d+)E", mangled)[:1] + re.findall(r"Lb([01])E", mangled)[:1]
    return f"{name}<{', '.join(args)}>"


def phase_fused_ln_build(build) -> dict:
    """2. the fused LN library (K5, K6, K9): what ptxas said of each
    kernel's registers, shared memory and spills (K5 and K6 at the
    flagship's three slices a lane, H = 768, and at their widest, eight
    slices, H = 2048, where K6's partials live in shared memory); and the
    integer instructions one Philox draw of K5 and of K6 issues, from the
    SASS: IMAD (with IMAD.HI, IMAD.WIDE) and LOP3 in the bf16 H = 768
    kernel with dropout, less the one without, over the 24 draws a lane
    makes a row.
    → {"ln_fwd": {"imad": .., "lop3": ..}, "ln_bwd": {...}} a draw."""
    import re

    func = None
    for line in build.ptxas_report("fused_ln").splitlines():
        found = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if found:
            func = found.group(1)
        elif func and ("Used" in line or "spill" in line):
            name = ln_label(func)
            if (not name.startswith("ln_") or name == "ln_bwd_reduce" or ", 3, " in name
                    or ", 8, " in name):
                log(f"  ptxas fused_ln: {name}: {line.split(':', 1)[-1].strip()}")
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.build("fused_ln"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            func = found.group(1)
            counts[func] = {"imad": 0, "lop3": 0}
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if func and op:
            if op.group(1) == "IMAD":
                counts[func]["imad"] += 1
            elif op.group(1) == "LOP3":
                counts[func]["lop3"] += 1
    labelled = {ln_label(f): c for f, c in counts.items()}
    per_draw = {}
    for kernel in ("ln_fwd", "ln_bwd"):
        with_, without = (labelled.get(f"{kernel}<bf16, 3, {d}>") for d in (1, 0))
        if with_ is None or without is None:
            raise AssertionError(f"fused_ln: no bf16 H=768 {kernel} pair in the SASS: "
                                 f"{sorted(labelled)}")
        per_draw[kernel] = {k: (with_[k] - without[k]) / DRAWS_PER_LANE_ROW
                            for k in ("imad", "lop3")}
        log(f"  SASS {kernel}<bf16, 3>: with dropout {with_}, without {without}: "
            f"{per_draw[kernel]['imad']:.2f} IMAD and {per_draw[kernel]['lop3']:.2f} LOP3 "
            f"a Philox draw")
        if per_draw[kernel]["imad"] <= 0:
            raise AssertionError(f"fused_ln: {kernel} with dropout issues no more IMAD than "
                                 f"without")
    return per_draw


def phase_kernels(torch, cfg, results: dict) -> None:
    """3. each kernel against its plain version on the card."""
    import numpy as np

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import fused_ln

    log("phase 3: kernels against their plain versions")
    rng = np.random.default_rng(SEED + 1)
    E, H, dev = cfg.hidden_size, cfg.num_attention_heads, DEV
    w = {n: torch.from_numpy(rng.standard_normal((E, E), dtype=np.float32) * 0.05)
         for n in "qkvo"}
    b = {n: torch.from_numpy(rng.standard_normal(E, dtype=np.float32) * 0.02)
         for n in "qkvo"}
    cases = [  # (name, B, L, valid lengths per row, segments, heads)
        ("L512", 8, 512, [512, 480, 384, 256, 128, 64, 5, 0], False, H),
        ("L64", 8, 64, [64, 63, 50, 33, 17, 8, 1, 0], False, H),
        ("L200_seg", 8, 200, [200, 199, 150, 101, 100, 64, 3, 0], True, H),
        # head_dim 128, which the block takes too
        ("L200_seg_d128", 8, 200, [200, 199, 150, 101, 100, 64, 3, 0], True, E // 128),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        packed = ab.pack_weights(
            *(t.to(dev) for n in "qkvo" for t in (w[n], b[n])), dtype
        )
        for name, B, L, lengths, segments, heads in cases:
            x = torch.from_numpy(rng.standard_normal((B, L, E), dtype=np.float32) * 0.5)
            mask = torch.from_numpy(
                (np.arange(L)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
            )
            seg = None
            if segments:
                seg = torch.from_numpy(
                    (np.arange(L)[None, :] >= np.asarray(lengths)[:, None] // 2)
                    .astype(np.int32)
                ).to(dev)
            x = x.to(dev, dtype)
            bias = attention_bias_from_mask(mask.to(dev))
            out = ab.attention_block_packed(x, *packed, heads, bias=bias, segment_ids=seg)
            ref = ab.attention_block_plain(x, *packed, heads, bias=bias, segment_ids=seg)
            torch.cuda.synchronize()
            if out.shape != (B, L, E) or out.dtype != dtype:
                raise AssertionError(f"attention_block {name}: {out.shape} {out.dtype}")
            if not torch.isfinite(out).all():
                raise AssertionError(f"attention_block {name} {dname}: non-finite output")
            err = errors(out, ref)
            results["attention_block"].append(err["max_abs"])
            gate(f"attention_block {name} {dname}", err, TOL[dname])

        N = 8 * 512
        xs = [torch.from_numpy(rng.standard_normal((N, E), dtype=np.float32)).to(dev, dtype)
              for _ in range(2)]
        gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(E, dtype=np.float32)).to(dev)
        beta = torch.from_numpy(0.1 * rng.standard_normal(E, dtype=np.float32)).to(dev)
        # with dropout the plain version gets Triton's own tl.rand mask
        for rate, seed in ((0.0, None), (0.1, 4321)):
            keep = fused_ln.dropout_mask((N, E), seed, rate, dev) if rate else None
            out = fused_ln.dropout_add_layernorm(xs[0], xs[1], gamma, beta, seed, rate)
            ref = fused_ln.dropout_add_layernorm_plain(xs[0], xs[1], gamma, beta, seed, rate,
                                                       keep=keep)
            torch.cuda.synchronize()
            if out.dtype != dtype:
                raise AssertionError(f"dropout_add_layernorm {dname}: {out.dtype} output")
            hold(results, "dropout_add_layernorm",
                 f"dropout_add_layernorm [{N}, {E}] {dname} dropout {rate}", out, ref, TOL[dname])

    # dropout inside the LN kernel (the training slice's path): with
    # x = 1 and residual = 0 a row holds two values, kept 1/(1-rate) and
    # dropped 0; after normalisation the dropped ones are the negative ones
    rate = 0.25
    ones = torch.ones(N, E, device=dev)
    y = fused_ln.dropout_add_layernorm(
        ones, torch.zeros_like(ones), torch.ones(E, device=dev),
        torch.zeros(E, device=dev), seed=1234, rate=rate,
    )
    dropped = float((y < 0).float().mean())
    same = fused_ln.dropout_add_layernorm(
        ones, torch.zeros_like(ones), torch.ones(E, device=dev),
        torch.zeros(E, device=dev), seed=1234, rate=rate,
    )
    log(f"  dropout_add_layernorm dropout: rate {rate} dropped {dropped:.4f}, "
        f"same seed same mask {bool(torch.equal(y, same))}")
    if abs(dropped - rate) > 0.01 or not torch.equal(y, same):
        raise AssertionError("dropout_add_layernorm: dropout mask is off")


def phase_encoder(torch, cfg, sd) -> dict:
    """4. the full encoder forward on the kernel path against the plain path."""
    import numpy as np

    from pl_bert_tpu_torch.models.inference import PhonemeEncoder

    log(f"phase 4: {cfg.num_hidden_layers}-layer encoder, kernel path against "
        f"plain path, B={MAX_BATCH} L={cfg.max_position_embeddings}")
    rng = np.random.default_rng(SEED + 2)
    texts = [phoneme_text(rng, n) for n in (512, 500, 384, 256, 128, 64, 5)]
    encoders = {}
    for mp in ("bf16", "fp32"):
        for impl in ("auto", "eager", "pallas"):
            params = dataclasses.replace(cfg, attention_impl=impl)
            encoders[mp, impl] = PhonemeEncoder(
                sd, params, cfg.max_position_embeddings, mixed_precision=mp,
                batch_size=MAX_BATCH, device=DEV,
            )
        enc, plain = encoders[mp, "auto"], encoders[mp, "eager"]
        ids, mask, lengths = enc.encode_batch(texts)
        out = enc.forward(ids, mask)
        ref = plain.forward(ids, mask)
        torch.cuda.synchronize()
        dname = str(enc.cfg.dtype).removeprefix("torch.")
        if out.shape != (MAX_BATCH, 512, cfg.hidden_size) or out.dtype != enc.cfg.dtype:
            raise AssertionError(f"encoder output {out.shape} {out.dtype}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"encoder {dname}: non-finite hidden states")
        valid = torch.from_numpy(mask.astype(bool)).to(out.device)
        gate(f"encoder {dname}", errors(out[valid], ref[valid]), ENCODER_TOL[dname])
        # phase 15: the per-head flash path, against the plain and the block path
        flash = encoders[mp, "pallas"].forward(ids, mask)
        torch.cuda.synchronize()
        if flash.shape != out.shape or not torch.isfinite(flash).all():
            raise AssertionError(f"flash-path encoder {dname}: bad hidden states")
        gate(f"encoder {dname}, flash path against plain path",
             errors(flash[valid], ref[valid]), ENCODER_TOL[dname])
        gate(f"encoder {dname}, flash path against block path",
             errors(flash[valid], out[valid]), ENCODER_TOL[dname])
    return encoders


def phase_serve(torch, cfg, sd, workdir: str, impl: str = "auto",
                per_client: int = PER_CLIENT, depth: int = 2) -> tuple[dict, dict]:
    """5-7. serve through the port's entry, check answers and counters.
    ``impl`` "pallas" (phase 15) starts the server with a config that
    asks for the per-head flash path; ``depth`` is its
    ``--pipeline_depth`` (2, the server's default, or 1)."""
    import numpy as np

    from pl_bert_tpu_torch.models.inference import PhonemeEncoder
    from pl_bert_tpu_torch.serving.server import build_server, serve_in_thread

    log(f"phase 5: reference .pth + the port's HTTP server in a thread "
        f"(attention_impl {impl}, pipeline_depth {depth})")
    ckpt = os.path.join(workdir, "step_0.pth")
    torch.save({"net": {f"encoder.{k}": v for k, v in sd.items()}, "step": 0,
                "epoch": 0}, ckpt)
    argv = ["--checkpoint", ckpt, "--port", "0", "--max_batch", str(MAX_BATCH),
            "--buckets", ",".join(map(str, BUCKETS)), "--device", DEV,
            "--pipeline_depth", str(depth)]
    config_path = None
    if impl != "auto":  # the default config is the flagship model on the block path
        config_path = os.path.join(workdir, f"serve_{impl}.yml")
        with open(config_path, "w", encoding="utf-8") as f:
            f.write(f"model_params:\n  attention_impl: {impl}\n")
        argv += ["--config_path", config_path]
    counters = reset_counters()  # the serving path's run starts here
    server = build_server(argv)
    warm = len(BUCKETS) + 1  # build_server warms every bucket and 512
    serve_in_thread(server)
    port = server.server_address[1]
    log(f"  {server.banner}")
    try:
        rng = np.random.default_rng(SEED + 3)
        sizes = [5, 500, *rng.integers(5, 501, N_CLIENTS * per_client - 2)]
        texts = [phoneme_text(rng, int(n)) for n in sizes]
        answers: dict[int, tuple] = {}
        failures: list[BaseException] = []

        def client_loop(c: int) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                for i in range(c, len(texts), N_CLIENTS):
                    answers[i] = encode_b64(conn, texts[i])
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                failures.append(exc)
            finally:
                conn.close()

        log(f"phase 6: {len(texts)} requests of {min(map(len, texts))}-"
            f"{max(map(len, texts))} phonemes from {N_CLIENTS} client threads")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client_loop, args=(c,)) for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if failures:
            raise failures[0]
        if any(t.is_alive() for t in threads) or len(answers) != len(texts):
            raise AssertionError(f"{len(answers)} of {len(texts)} requests answered")
        probe = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        stats = http_json(probe, "GET", "/stats")
        launches = read_counters(counters)  # the serving path's run ends here
        health = http_json(probe, "GET", "/healthz")
        probe.close()
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
    forwards = warm + stats["batches"]
    stats["wall_s"] = wall
    log(f"  answered {len(answers)} in {wall:.2f} s: {stats['batches']} batches, "
        f"mean batch {stats['mean_batch_size']:.2f}, p50 "
        f"{stats['latency_ms']['p50']:.1f} ms, p95 {stats['latency_ms']['p95']:.1f} ms; "
        f"healthz hidden_size {health['hidden_size']}")

    direct = PhonemeEncoder.from_checkpoint(
        ckpt, config_path, batch_size=MAX_BATCH, seq_buckets=BUCKETS, device=DEV
    )
    worst = 0.0
    for i, text in enumerate(texts):
        hidden, n = answers[i]
        ref, lengths = direct([text])
        if n != int(lengths[0]) or hidden.shape != (n, cfg.hidden_size):
            raise AssertionError(f"request {i}: length {n} vs {lengths[0]}")
        if not np.isfinite(hidden).all():
            raise AssertionError(f"request {i}: non-finite hidden states")
        worst = max(worst, float(np.abs(hidden - ref[0, :n]).max()))
    log(f"  every answer against a direct PhonemeEncoder call: max_abs {worst:.3e}")
    if worst > 2e-2:
        raise AssertionError(f"served answers differ from direct calls by {worst}")

    log(f"phase 7: launch counters over {forwards} forwards "
        f"({warm} warm-up + {stats['batches']} batches): {launches}")
    expect = dict.fromkeys(launches, 0)
    expect["flash_attention" if impl == "pallas" else "attention_block"] = (
        cfg.num_hidden_layers * forwards)
    expect["dropout_add_layernorm"] = 2 * cfg.num_hidden_layers * forwards
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    return launches, stats


def pipeline_probe(torch, enc, texts, rounds: int = 10) -> dict:
    """6. the serving pipeline's stream order on ``enc``: batch N
    dispatched, then N+1, then N fetched. Medians over ``rounds``
    of: how long the second ``dispatch`` held the calling thread; how long
    before the end of N+1's forward (an event recorded right after its
    dispatch) ``fetch(N)`` returned (0: not before; it waited for N+1); and
    the share of rounds in which N+1's forward was still running when it
    did."""
    import statistics

    for _ in range(3):
        enc(texts)
    torch.cuda.synchronize()
    blocked, early, running = [], [], []
    for _ in range(rounds):
        first = enc.dispatch(texts)
        t0 = time.perf_counter()
        second = enc.dispatch(texts)
        t1 = time.perf_counter()
        end = torch.cuda.Event()
        end.record()  # the end of N+1's forward on the compute stream
        enc.fetch(first)
        t2 = time.perf_counter()
        running.append(not end.query())
        end.synchronize()
        t3 = time.perf_counter()
        enc.fetch(second)
        blocked.append((t1 - t0) * 1e3)
        early.append((t3 - t2) * 1e3)
    return {"dispatch_blocked_ms": statistics.median(blocked),
            "fetch_before_next_end_ms": statistics.median(early),
            "fetch_returned_while_next_ran": sum(running) / rounds}


def phase_pipeline(torch, cfg, sd, enc, by_depth: dict) -> dict:
    """6. the pipeline probe on the block-path bf16 encoder at B=8, where
    the host's enqueue of a forward outlasts its kernels, and at B=64,
    where the kernels outlast the enqueue and the stream order shows;
    beside the request latency of phase 6's 32 requests at depth 1 and 2."""
    import numpy as np

    from pl_bert_tpu_torch.models.inference import PhonemeEncoder

    rng = np.random.default_rng(SEED + 8)
    big = PhonemeEncoder(sd, cfg, 512, mixed_precision="bf16", batch_size=64, device=DEV)
    probes = {}
    for B, encoder in ((MAX_BATCH, enc), (64, big)):
        probes[B] = pipeline_probe(torch, encoder, [phoneme_text(rng, 512) for _ in range(B)])
    del big
    lat = {d: (st["latency_ms"]["p50"], st["latency_ms"]["p95"], st["wall_s"])
           for d, st in by_depth.items()}
    for B, probe in probes.items():
        log(f"phase 6: pipeline, B={B} L=512 bf16: the second dispatch held its thread "
            f"{probe['dispatch_blocked_ms']:.3f} ms; fetch(N) returned "
            f"{probe['fetch_before_next_end_ms']:.3f} ms before N+1's forward ended (N+1 still "
            f"running at {probe['fetch_returned_while_next_ran']:.0%} of returns)")
    log("phase 6: request latency over the 32 requests, "
        + "; ".join(f"depth {d}: p50 {p50:.1f} ms, p95 {p95:.1f} ms, all in {w:.2f} s"
                    for d, (p50, p95, w) in sorted(lat.items())))
    return {"probes": probes, "latency": lat}


def phase_timing(torch, cfg, encoders, per_draw: dict, clock_mhz: float) -> dict:
    """8. kernel against plain version, and the encoder forward, timed;
    the library yardsticks and the bounds beside the kernels; K5 at the
    serving and the training shape, dropout 0 and 0.1, beside its library
    call and its bound with the integer term of its draws."""
    import numpy as np

    import torch.nn.functional as F

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import fused_ln
    from pl_bert_tpu_torch.ops.attention import NEG

    log("phase 8: time per call, bf16, B=8 L=512 — kernels: device time from a "
        "replayed CUDA graph; encoder forward: CUDA events around the serving "
        "call, host-to-device copy of the ids included")
    enc, plain = encoders["bf16", "auto"], encoders["bf16", "eager"]
    w = enc.weights["encoder"]["layer"]
    att = w["attention"]
    rng = np.random.default_rng(SEED + 4)
    B, L, E = MAX_BATCH, 512, cfg.hidden_size
    x = torch.from_numpy(rng.standard_normal((B, L, E), dtype=np.float32)).to(DEV, torch.bfloat16)
    lengths = np.array([512, 480, 384, 256, 128, 64, 5, 0])
    bias = attention_bias_from_mask(
        torch.from_numpy((np.arange(L)[None] < lengths[:, None]).astype(np.int32)).to(DEV)
    )
    args = (x, att["wqkv"], att["bqkv"], att["wo"], att["bo"], cfg.num_attention_heads)
    times = {}
    times["attention_block"] = a_b(
        torch, lambda: ab.attention_block_plain(*args, bias=bias),
        lambda: ab.attention_block_packed(*args, bias=bias), iters=20,
        timer=graph_ms,
    )
    # speed reference only: the same block on library kernels in bf16
    # (cuBLAS tensor-core GEMMs, SDPA), as stock PyTorch would run it; it
    # rounds at other points, so it is not what the kernel is checked against
    H = cfg.num_attention_heads
    stock_bias = bias.clamp(min=NEG).to(torch.bfloat16)
    bqkv16, bo16 = att["bqkv"].to(torch.bfloat16), att["bo"].to(torch.bfloat16)

    def stock_block():
        qkv = torch.addmm(bqkv16, x.reshape(B * L, E), att["wqkv"])
        q, k, v = qkv.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=stock_bias)
        return torch.addmm(bo16, ctx.transpose(1, 2).reshape(B * L, E), att["wo"])

    library = {"attention_block": graph_ms(torch, stock_block, 20)}
    bounds = {"attention_block": block_bound(block_cost(B, L, E, E, 2))}
    log_parts("attention_block (K1)", part_times(
        torch, lambda: ab.attention_block_packed(*args, bias=bias)), block_cost(B, L, E, E, 2))

    # K2, the fp32 light forward (CUDA cores), against its plain version and
    # the same block in stock fp32 PyTorch (TF32 off); bound at 67 TFLOP/s
    att32 = encoders["fp32", "auto"].weights["encoder"]["layer"]["attention"]
    x32 = x.float()
    args32 = (x32, att32["wqkv"], att32["bqkv"], att32["wo"], att32["bo"], H)
    k2, p2 = a_b(torch, lambda: ab.attention_block_plain(*args32, bias=bias),
                 lambda: ab.attention_block_packed(*args32, bias=bias), iters=10, timer=graph_ms)

    def stock_block32():
        qkv = torch.addmm(att32["bqkv"], x32.reshape(B * L, E), att32["wqkv"])
        q, k, v = qkv.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.clamp(min=NEG))
        return torch.addmm(att32["bo"], ctx.transpose(1, 2).reshape(B * L, E), att32["wo"])

    lib2 = graph_ms(torch, stock_block32, 10)
    bound2 = block_bound(block_cost(B, L, E, E, 4), PEAK_FP32_FLOPS)
    log(f"  attention_block fp32 (K2) [{B}, {L}, {E}]: kernel {k2:.4f} ms, plain {p2:.4f} ms, "
        f"library {lib2:.4f} ms, bound {bound2[0]:.4f} ms ({bound2[1]}, fp32 at 67 TFLOP/s)")
    res = torch.from_numpy(rng.standard_normal((B * L, E), dtype=np.float32)).to(DEV, torch.bfloat16)
    x2 = x.reshape(B * L, E)
    ln = att["ln"]
    # K5's library yardstick: the add and F.layer_norm; with dropout,
    # F.dropout before them
    g16, b16 = ln["g"].to(torch.bfloat16), ln["b"].to(torch.bfloat16)

    def library_ln(xa, ra, rate):
        return lambda: F.layer_norm((F.dropout(xa, rate) if rate else xa) + ra, (E,), g16, b16,
                                    cfg.layer_norm_eps)

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bound5(N, rate):  # x and the residual read, the output written, ~10 fp32 flops an element
        return ln_bound(N, E, 2, 3, 10.0, N * E if rate else 0, per_draw["ln_fwd"], sms,
                        clock_mhz)

    texts = [phoneme_text(rng, 512) for _ in range(B)]
    ids, mask, _ = enc.encode_batch(texts)
    times["encoder_forward"] = a_b(
        torch, lambda: plain.forward(ids, mask), lambda: enc.forward(ids, mask), iters=5,
    )
    for name, (k, p) in times.items():
        extra = (f", library {library[name]:.4f} ms, bound {bounds[name][0]:.4f} ms "
                 f"({bounds[name][1]})" if name in library else "")
        log(f"  {name}: kernel {k:.4f} ms, plain {p:.4f} ms{extra}")
    # K5 at both shapes and rates: the training shape's 226 MB do not fit in
    # the 50 MB L2, so its share of the bytes bound is one of device memory
    # (the serving shape's 18.9 MB stay in L2 under graph replay, where the
    # bytes bound at the memory rate is no bound). The kernels line takes
    # the training shape at the training step's rate, 0.1.
    Nt = 96 * 512
    xt, rt = (torch.from_numpy(rng.standard_normal((Nt, E), dtype=np.float32)).to(
        DEV, torch.bfloat16) for _ in range(2))
    for N, xa, ra, iters in ((B * L, x2, res, 200), (Nt, xt, rt, 20)):
        for rate in (0.0, 0.1):
            seed = 7 if rate else None
            k5 = graph_ms(torch, lambda: fused_ln.dropout_add_layernorm(
                xa, ra, ln["g"], ln["b"], seed, rate), iters)
            lib5 = graph_ms(torch, library_ln(xa, ra, rate), iters)
            b5, by, terms = bound5(N, rate)
            at = (f"[{N}, {E}] dropout {rate}: kernel {k5:.4f} ms, library {lib5:.4f} ms, "
                  f"bound {b5:.4f} ms ({by}; " + ", ".join(f"{k} {v:.4f}" for k, v in terms.items())
                  + ")")
            if N == Nt:
                log(f"  dropout_add_layernorm {at}, {b5 / k5:.1%} of it")
            else:
                log(f"  dropout_add_layernorm {at}; L2-resident, so no share of it is read")
            if N == Nt and rate:
                # the plain version draws its own mask with the same rate (event-timed:
                # its generator is not captured in a graph; ~1 ms a call, so the host's
                # launches are out of the way)
                plain5 = time_ms(torch, lambda: fused_ln.dropout_add_layernorm_plain(
                    xa, ra, ln["g"], ln["b"], seed, rate), iters)
                times["dropout_add_layernorm"] = (k5, plain5)
                library["dropout_add_layernorm"] = lib5
                bounds["dropout_add_layernorm"] = (b5, by)
    # the draws alone, which bound K5 with dropout: Triton's mask kernel,
    # the same tl.rand an element and one byte out
    draws = graph_ms(torch, lambda: fused_ln.dropout_mask((Nt, E), 7, 0.1, DEV), 20)
    log(f"  the dropout draws alone at [{Nt}, {E}] (Triton's tl.rand mask kernel, one byte "
        f"out an element): {draws:.4f} ms")
    return {"times": times, "library": library, "bounds": bounds}


def bound_ms(flops: float, nbytes: float, flops_peak: float = PEAK_BF16_FLOPS):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_cost(B, L, E, P, itemsize, kind="light") -> dict:
    """FLOPs and bytes of the attention block's kernels, ``kind`` "light"
    (K1/K2), "train" (K3), "backward" (K4) or "backward_simt" (K4, with
    ``formed``: the products each of its CUDA-core kernels forms at
    head_dim 64 -- do = dout·Woᵀ 2·M·E·P; the delta pass's q·k and do·vᵀ
    4·M·L·P; the dk/dv kernel's q·k, do·vᵀ, pdᵀ·do and dsᵀ·q 8·M·L·P; dq =
    ds·k 2·M·L·P: seven L²·D products a head where the gradient needs
    five), split into the projection
    GEMMs and the attention pass. With M = B·L: forward GEMMs x·Wqkv and
    ctx·Wo, 8·M·E·P; attention q·k and p·v, 4·M·L·P. Backward GEMMs
    do = dout·Woᵀ and dx = dqkv·Wqkvᵀ, 8·M·E·P; attention q·k, do·v, pᵀ·do,
    ds·k, dsᵀ·q, 10·M·L·P. ``bytes``: the block's inputs read and outputs
    written once (x and the weights read, the output written, and for K3
    also qkv, ctx and the statistics; for K4 dout, qkv, the weights and the
    statistics read, dqkv and dx written). ``gemm_bytes`` and
    ``attention_bytes``: what each part moves on its own (the projections
    read x, ctx and the weights and write qkv and the output; the
    attention reads qkv and writes ctx, and the statistics for K3; K4's
    projections read dout, dqkv and the weights and write do and dx, its
    attention reads qkv, do and the statistics and writes dqkv)."""
    M, H = B * L, P // 64
    weights = 4 * E * P * itemsize
    stats = 2 * B * H * L * 4
    if kind == "backward_simt":
        cost = block_cost(B, L, E, P, itemsize, "backward")
        cost["formed"] = {"do": 2 * M * E * P, "delta": 4 * M * L * P, "dkdv": 8 * M * L * P,
                          "dq": 2 * M * L * P}
        return cost
    if kind == "backward":
        return {"gemm": 8 * M * E * P, "attention": 10 * M * L * P,
                "bytes": 2 * M * (E + 3 * P) * itemsize + weights + stats,
                "gemm_bytes": (2 * M * E + 4 * M * P) * itemsize + weights,
                "attention_bytes": 7 * M * P * itemsize + stats}
    nbytes = 2 * M * E * itemsize + weights
    saved = stats if kind == "train" else 0
    if kind == "train":
        nbytes += M * 4 * P * itemsize + stats
    return {"gemm": 8 * M * E * P, "attention": 4 * M * L * P, "bytes": nbytes,
            "gemm_bytes": (2 * M * E + 4 * M * P) * itemsize + weights,
            "attention_bytes": 4 * M * P * itemsize + saved}


def block_bound(cost: dict, flops_peak: float = PEAK_BF16_FLOPS):
    """The bound of the whole block: all its products against its bytes."""
    return bound_ms(cost["gemm"] + cost["attention"], cost["bytes"], flops_peak)


# the parts of a bf16 block or flash call: {part: (kernel name, launches a call)}
FORWARD_PARTS = {"gemm": ("gemm_bias_sm90", 2), "attention": ("attention_fwd_sm90", 1)}
# K4: do = dout·Woᵀ and the attention (delta pass, dk/dv with the ds
# scratch, dq = ds·k) on the CUDA cores, dx on wgmma
BACKWARD_PARTS = {"do": ("gemm_bias<", 1), "dx": ("gemm_bias_sm90", 1),
                  "delta": ("attention_bwd_delta<", 1), "dkdv": ("attention_bwd_dkdv<", 1),
                  "dq": ("attention_bwd_dq<", 1)}
FLASH_BACKWARD_PARTS = {"dq": ("attention_bwd_dq_sm90", 1),
                        "dkdv": ("attention_bwd_dkdv_sm90", 1)}


def part_times(torch, fn, iters: int = 5, keys: dict = FORWARD_PARTS) -> dict:
    """Device ms a call of ``fn`` by part, from ``torch.profiler`` over
    ``iters`` calls: ``keys`` names each part's kernel and its launches a
    call (the forward's projection GEMMs and attention pass by default;
    the backward's GEMMs, dq and dk/dv kernels). The trace can drop a
    kernel record (seen on the card: 9 of 10 GEMMs), so each part is its
    mean over the records it has times its launches a call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    records = {part: [] for part in keys}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part, (key, _) in keys.items():
            if key in evt.name:
                records[part].append(evt.time_range.elapsed_us() / 1e3)
    return {part: sum(ms) / len(ms) * keys[part][1] if ms else 0.0
            for part, ms in records.items()}


def log_parts(label: str, parts: dict, cost: dict) -> None:
    """Print each part's device time; then the projections (gemm, or do
    and dx) and the attention (attention, or delta, dk/dv and dq) each
    against its own bound. With a "backward_simt" cost, each CUDA-core
    part of K4 also beside the products it forms at the fp32 rate, and the
    attention beside the CUDA-core bound of the products it needs."""
    if set(parts) - {"gemm", "attention"}:
        log(f"  {label}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts.items()))
    groups = {"gemm": ("gemm", "do", "dx"), "attention": ("attention", "delta", "dkdv", "dq")}
    for part, keys in groups.items():
        ms = sum(parts.get(k, 0.0) for k in keys)
        bound, by = bound_ms(cost[part], cost[f"{part}_bytes"])
        log(f"  {label} {part}: {ms:.4f} ms a call, bound {bound:.4f} ms ({by}; "
            f"{cost[part] / 1e9:.1f} GFLOP), {bound / ms if ms else 0:.1%} of it")
    if "formed" not in cost:
        return
    for part, flops in cost["formed"].items():
        ms = parts.get(part, 0.0)
        bound = flops / PEAK_FP32_FLOPS * 1e3
        log(f"  {label} {part} on the CUDA cores: {ms:.4f} ms, forms {flops / 1e9:.1f} GFLOP, "
            f"{bound:.4f} ms at 67 TFLOP/s, {bound / ms if ms else 0:.1%} of it")
    ms = sum(parts.get(k, 0.0) for k in groups["attention"])
    bound, by = bound_ms(cost["attention"], cost["attention_bytes"], PEAK_FP32_FLOPS)
    log(f"  {label} attention: {ms:.4f} ms a call, CUDA-core bound {bound:.4f} ms ({by}; the "
        f"{cost['attention'] / 1e9:.1f} GFLOP it needs at 67 TFLOP/s), "
        f"{bound / ms if ms else 0:.1%} of it")


def hold_flash_stats(torch, saved, heads: int, bias_row, label: str) -> None:
    """K8's first pass on views of K3's qkv recomputes the row max and
    denominator with the forward's own functions: they must equal K3's
    saved ones bit for bit (dO is not read by that pass)."""
    from pl_bert_tpu_torch.ops import flash_attention as fa

    qkv, _, m, l = saved
    B, _, L = m.shape
    P = qkv.shape[1] // 3
    q, k, v = (t.reshape(B, L, heads, P // heads)
               for t in qkv.reshape(B, L, 3 * P).split(P, dim=-1))
    *_, m8, l8 = fa._launch_bwd(torch.zeros_like(q), q, k, v, bias_row, None, 0.0, None)
    torch.cuda.synchronize()
    same = torch.equal(m8, m) and torch.equal(l8, l)
    log(f"  K8's recomputed row max and denominator equal K3's saved ones bit for bit "
        f"({label}): {same}")
    if not same:
        raise AssertionError(
            f"K8's statistics differ from K3's ({label}): row max by "
            f"{float((m8 - m).abs().max()):.3e}, denominator by "
            f"{float((l8 - l).abs().max()):.3e}")


def hold_k4_stages(torch, results, dout, wo, saved, heads, bias_row, rate, seed, keep, scratch,
                   tag) -> None:
    """K4's CUDA-core stages against their plain versions: ``do`` must be
    the plain ``do`` bit for bit in bf16 (one fmaf chain an output over the
    768 inputs in order, as cuBLAS fp32 sums them), delta (the delta pass)
    and the ds scratch (the dk/dv kernel) are held fed K4's own ``do``
    and delta."""
    from pl_bert_tpu_torch.ops import attention_block as ab

    do, delta, ds = scratch
    B, _, L = delta.shape
    plain_do = (dout.reshape(B * L, -1).float() @ wo.float().T).to(dout.dtype)
    same = bool(torch.equal(do, plain_do))
    share = float((do != plain_do).float().mean())
    log(f"  K4 do == plain do bitwise ({tag}): {same} ({share:.2e} of the elements differ)")
    if dout.dtype == torch.bfloat16 and not same:
        raise AssertionError(f"K4's do is not the plain do bit for bit ({tag})")
    args = (heads, bias_row, None, rate, seed, keep)
    hold(results, "attention_block_bwd", f"K4 delta {tag}", delta,
         ab.attention_delta_plain(do, saved, *args), TOL["float32"])
    dname = str(dout.dtype).removeprefix("torch.")
    hold(results, "attention_block_bwd", f"K4 ds {tag}", ds[:, :, :L, :L],
         ab.attention_dkdv_plain(do, saved, delta, *args)[2], TOL[dname])


def phase_train_kernels(torch, cfg, results: dict) -> None:
    """9-12. the training kernels against their plain versions, and the
    dropout statistics."""
    import numpy as np

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask, _dropout
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import fused_ln

    rng = np.random.default_rng(SEED + 5)
    B, L, E, H, dev = 8, 512, cfg.hidden_size, cfg.num_attention_heads, DEV
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    wqkv32, bqkv = f32(rng.standard_normal((E, 3 * E)) * 0.05), f32(rng.standard_normal(3 * E) * 0.02)
    wo32, bo = f32(rng.standard_normal((E, E)) * 0.05), f32(rng.standard_normal(E) * 0.02)
    lengths = np.array([512, 480, 384, 256, 128, 64, 5, 0])
    mask = f32(np.arange(L)[None, :] < lengths[:, None])
    bias_row, _ = ab.rows(attention_bias_from_mask(mask), None, B, L)
    x32 = f32(rng.standard_normal((B, L, E)) * 0.5)
    dout32 = f32(rng.standard_normal((B, L, E)))

    log("phase 9: attention block training forward (K3) against its plain version, "
        f"[{B}, {L}, {E}]")
    log("phase 10: its backward (K4) against the plain backward on the same saved tensors")
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        x, dout = x32.to(dtype), dout32.to(dtype)
        wqkv, wo = wqkv32.to(dtype).contiguous(), wo32.to(dtype).contiguous()
        for rate in (0.0, 0.1):
            seed = 4321 if rate else None
            keep = None
            if rate:
                keep = ab.dropout_mask(seed, rate, B, H, L, dev)
                if not torch.equal(keep.bool(), ab.dropout_keep(seed, rate, B, H, L, dev)):
                    raise AssertionError("the kernels' dropout mask is not the plain Philox")
            out, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed)
            light, _ = ab._launch_fwd(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed,
                                      save=False)
            ref, ref_saved = ab.train_forward_plain(x, wqkv, bqkv, wo, bo, H, bias_row, None,
                                                    rate, seed, keep=keep)
            torch.cuda.synchronize()
            if not torch.equal(out, light):
                raise AssertionError(f"K1 and K3 outputs differ ({dname}, dropout {rate})")
            if not all(torch.isfinite(t).all() for t in (out, *saved)):
                raise AssertionError(f"K3 {dname}: non-finite output")
            tag = f"{dname} dropout {rate}"
            for name, a, r in [("out", out, ref), ("qkv", saved[0], ref_saved[0]),
                               ("ctx", saved[1], ref_saved[1])]:
                err = errors(a, r)
                results["attention_block_train"].append(err["max_abs"])
                gate(f"K3 {name} {tag}", err, TOL[dname])
            # the statistics on the q and k K3 read: the bf16 projection
            # rounds qkv on the tensor cores (qkv is held above)
            stats = ab.softmax_stats_plain(saved[0], H, B, L, bias_row)
            for name, a, r in [("row max", saved[2], stats[0]),
                               ("denominator", saved[3], stats[1])]:
                gate(f"K3 {name} {tag}", errors(a, r), TOL["float32"])
            log(f"  K1 output == K3 output bitwise ({tag})")
            hold_flash_stats(torch, saved, H, bias_row, f"[{B}, {L}, {E}] {tag}")

            dx, dqkv, (do, delta, ds) = ab._launch_bwd(dout, x, wqkv, wo, saved, H, bias_row,
                                                       None, rate, seed, scratch=True)
            rdx, rdqkv = ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None,
                                                 rate, seed, keep=keep)
            hold_k4_stages(torch, results, dout, wo, saved, H, bias_row, rate, seed, keep,
                           (do, delta, ds), tag)
            del do, delta, ds
            x2, d2 = x.reshape(B * L, E).float(), dout.reshape(B * L, E).float()
            grads = {"dx": (dx, rdx), "dqkv": (dqkv, rdqkv),
                     "dWqkv": (x2.T @ dqkv.float(), x2.T @ rdqkv.float()),
                     "dbqkv": (dqkv.float().sum(0), rdqkv.float().sum(0)),
                     "dWo": (saved[1].float().T @ d2, ref_saved[1].float().T @ d2),
                     "dbo": (d2.sum(0), d2.sum(0))}
            torch.cuda.synchronize()
            for name, (a, r) in grads.items():
                if not torch.isfinite(a).all():
                    raise AssertionError(f"K4 {name} {tag}: non-finite")
                err = errors(a, r)
                results["attention_block_bwd"].append(err["max_abs"])
                gate(f"K4 {name} {tag}", err, TOL[dname] if a.dtype == dtype else TOL_GRAD[dname])
            del saved, ref_saved, grads

    log("phase 11: fused LN backward (K6) against its plain backward, [4096, 768]")
    N = 4096
    xs = [f32(rng.standard_normal((N, E))) for _ in range(3)]
    gamma = f32(1 + 0.1 * rng.standard_normal(E))
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        x, res, dy = (t.to(dtype) for t in xs)
        for rate in (0.0, 0.1):
            seed = 99 if rate else None
            keep = fused_ln.dropout_mask((N, E), 99, rate, dev) if rate else None
            got = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, rate)
            ref = fused_ln.dropout_add_layernorm_bwd_plain(dy, x, res, gamma, seed, rate,
                                                           keep=keep)
            torch.cuda.synchronize()
            for name, a, r in zip(("dx", "dres", "dgamma", "dbeta"), got, ref):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"K6 {name}: non-finite")
                err = errors(a, r)
                results["dropout_add_layernorm_bwd"].append(err["max_abs"])
                gate(f"K6 {name} {dname} dropout {rate}", err,
                     TOL[dname] if a.dtype == dtype else TOL_GRAD[dname])

    hold_ln_masks(torch, results, dev)

    Bt = 96
    log(f"phase 12: dropout keep rates at the training shape (B={Bt}, rate 0.1)")
    rate = 0.1
    ones = torch.ones(Bt * L, E, device=dev, dtype=torch.bfloat16)
    g1, b0 = torch.ones(E, device=dev), torch.zeros(E, device=dev)

    def k5_kept(s):
        # x = 1, residual = 0: a row holds kept 1/(1-rate) and dropped 0, and
        # after normalisation the dropped ones are the negative ones
        return fused_ln.dropout_add_layernorm(ones, torch.zeros_like(ones), g1, b0, s, rate) >= 0

    sites = {
        "attention (Philox, CUDA)": lambda s: ab.dropout_mask(s, rate, Bt, H, L, dev),
        "fused LN (K5's output, CUDA)": k5_kept,
        "fused LN (tl.rand, Triton)": lambda s: fused_ln.dropout_mask((Bt * L, E), s, rate, dev),
        "embedding (torch.Generator)": lambda s: _dropout(
            torch.ones(Bt, L, cfg.embedding_size, device=dev), s, rate) != 0,
    }
    for name, make in sites.items():
        first, again, other = make(17), make(17), make(18)
        kept = float(first.float().mean())
        same = bool(torch.equal(first, again))
        log(f"  {name}: kept {kept:.5f} over {first.numel()} elements, "
            f"same seed same mask {same}, other seed other mask {not torch.equal(first, other)}")
        if abs(kept - (1 - rate)) > KEEP_TOL or not same or torch.equal(first, other):
            raise AssertionError(f"dropout at {name} is off")
        del first, again, other
    same = torch.equal(k5_kept(17), fused_ln.dropout_mask((Bt * L, E), 17, rate, dev).bool())
    log(f"  fused LN: K5's kept elements are Triton's tl.rand mask, bit for bit: {same}")
    if not same:
        raise AssertionError("K5's dropout mask is not Triton's")


def hold_ln_masks(torch, results: dict, dev) -> None:
    """11. K5 and K6 draw Triton's ``tl.rand`` mask bit for bit: at
    [49152, 768], rate 0.1, for seeds 0, 1, 2^31 - 2 and one the training
    step draws, K5's output is held against its plain version fed the mask
    of a Triton kernel that calls ``tl.rand`` (one element dropped
    otherwise moves its output past the bf16 gate), K6's dx is zero
    exactly where that mask drops or dres is zero; and the plain
    ``tl_rand`` equals Triton's uniform floats at the first 4096 offsets,
    bitwise."""
    from pl_bert_tpu_torch.models.albert import draw_dropout_seeds
    from pl_bert_tpu_torch.ops import fused_ln

    shape, rate = (96 * 512, 768), 0.1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, res, dy = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
    gamma = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    beta = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    drawn = draw_dropout_seeds(torch.Generator().manual_seed(SEED), 1)[1]
    for seed in (0, 1, fused_ln.SEED_MAX, drawn):
        mask = fused_ln.dropout_mask(shape, seed, rate, dev).bool()
        out = fused_ln.dropout_add_layernorm(x, res, gamma, beta, seed, rate)
        ref = fused_ln.dropout_add_layernorm_plain(x, res, gamma, beta, seed, rate, keep=mask)
        hold(results, "dropout_add_layernorm",
             f"K5 against plain fed Triton's mask, seed {seed}, {list(shape)}", out, ref,
             TOL["bfloat16"])
        del out, ref
        dx, dres, _, _ = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, rate)
        same = torch.equal(dx != 0, mask & (dres != 0))
        u = fused_ln.triton_rand(4096, seed, dev).cpu()
        plain = fused_ln.tl_rand(seed, torch.arange(4096))
        log(f"  K6's dx is zero where Triton's tl.rand mask drops, seed {seed}, {list(shape)}: "
            f"{same} (kept {float(mask.float().mean()):.5f}); plain tl_rand == Triton's at "
            f"offsets 0-4095: {torch.equal(u, plain)}; tl.rand at offsets 0-3: "
            f"{[float(v) for v in u[:4]]}")
        if not same or not torch.equal(u, plain):
            raise AssertionError(f"K6's dropout mask is not Triton's at seed {seed}")
        del dx, dres, mask


def ln_bound(N: int, H: int, itemsize: int, passes: int, flops: float, draws: int,
             per_draw: dict, sms: int, clock_mhz: float):
    """K5's or K6's bound → (ms, "bytes" or "operations", {term: ms}): the
    largest of the bytes it must move (``passes`` of [N, H]: K5 reads x and
    the residual and writes the output, 3; K6 reads x, the residual and dy
    and writes dx and dres, 5) over 3.35 TB/s; its ``flops`` fp32
    operations an element (~10, ~20) over 67 TFLOP/s; and its ``draws``
    Philox draws' integer instructions, the busier of the IMAD and LOP3
    pipes (``per_draw``, counted in its SASS), over
    ``INT_OPS_PER_SM_CLOCK`` × ``sms`` × the max SM clock."""
    terms = {
        "bytes": passes * N * H * itemsize / PEAK_BYTES * 1e3,
        "fp32": flops * N * H / PEAK_FP32_FLOPS * 1e3,
        "integer": draws * max(per_draw.values())
        / (INT_OPS_PER_SM_CLOCK * sms * clock_mhz * 1e6) * 1e3,
    }
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations", terms


def phase_train(torch, results: dict, per_draw: dict,
                clock_mhz: float) -> tuple[dict, dict, dict]:
    """13. the train step: kernel path against plain path, then bench.py's
    workload on the kernel path, with the launch counters; then K3, K4
    and K6 timed at that workload's shapes and held against their plain
    versions there."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.data.synthetic import full_length_batches
    from pl_bert_tpu_torch.models.albert import build_model, init_params
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import fused_ln
    from pl_bert_tpu_torch.ops.attention import NEG
    from pl_bert_tpu_torch.training import train_step as ts

    config = Config()  # configs/config.yml's values: bf16, B 96, L 512, AdamW 7e-5
    mp, tp = config.model_params, config.training_params
    L = config.dataset_params.max_seq_length
    log("phase 13: train step, block path (auto) and flash path (pallas) against the plain "
        "path: 3 steps, B=8, bf16, dropout 0")
    pool8 = full_length_batches(3, 8, L)
    losses = {}
    for impl in ("auto", "pallas", "eager"):
        model = init_params(build_model(dataclasses.replace(mp, dropout=0.0, attention_impl=impl),
                                        tp.mixed_precision), seed=SEED).to(DEV)
        tx = ts.make_optimizer(tp)
        state = ts.TrainState(model, tx.init(model))
        step = ts.make_train_step(model, tx, seed=tp.seed)
        losses[impl] = [{k: float(v) for k, v in step(state, b)[1].items()} for b in pool8]
        del model, state, tx
        torch.cuda.empty_cache()
    for impl in ("auto", "pallas"):
        for s, (k, p) in enumerate(zip(losses[impl], losses["eager"])):
            rel = {m: abs(k[m] - p[m]) / abs(p[m]) for m in ("loss", "grad_norm")}
            ok = all(rel[m] <= TRAIN_TOL[m] for m in rel) and all(
                np.isfinite(k[m]) for m in ("loss", "grad_norm"))
            log(f"  {impl} step {s}: loss {k['loss']:.6f} vs {p['loss']:.6f} "
                f"(rel {rel['loss']:.2e}), grad_norm {k['grad_norm']:.6f} vs "
                f"{p['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"train step {s}: {impl} path off the plain path: {rel}")

    B = tp.batch_size
    log(f"phase 13: bench.py's workload on the kernel path: B={B}, L={L}, "
        f"{tp.mixed_precision}, dropout {mp.dropout}, AdamW lr {tp.learning_rate}")
    model = init_params(build_model(mp, tp.mixed_precision), seed=SEED).to(DEV)
    tx = ts.make_optimizer(tp)
    state = ts.TrainState(model, tx.init(model))
    step = ts.make_train_step(model, tx, seed=tp.seed)
    pool = full_length_batches(4, B, L)
    warm, timed = 3, 5
    for i in range(warm):
        _, m = step(state, pool[i % len(pool)])
    float(m["loss"])
    counters = reset_counters()  # the training path's run starts here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_losses = []
    for i in range(timed):
        _, m = step(state, pool[(warm + i) % len(pool)])
        step_losses.append(float(m["loss"]))  # a host read: the step has finished
    wall = time.perf_counter() - t0
    launches = read_counters(counters)  # the training path's run ends here
    step_ms = wall / timed * 1e3
    tokens = sum(int(pool[(warm + i) % len(pool)]["lengths"].sum()) for i in range(timed))
    log(f"  losses {[round(v, 5) for v in step_losses]}; {step_ms:.1f} ms a step, "
        f"{tokens / wall:.0f} phoneme tokens/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(np.isfinite(step_losses)):
        raise AssertionError(f"non-finite training loss: {step_losses}")
    n = mp.num_hidden_layers
    expect = dict.fromkeys(launches, 0)
    expect.update({"attention_block_train": n * timed, "attention_block_bwd": n * timed,
                   "dropout_add_layernorm": 2 * n * timed,
                   "dropout_add_layernorm_bwd": 2 * n * timed})
    log(f"  launch counters over {timed} steps: {launches}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    train = {"step_ms": step_ms, "tokens_per_s": tokens / wall, "losses": step_losses}
    del state, model, tx
    torch.cuda.empty_cache()

    log(f"phase 13: K3, K4, K6 timed at the workload's shapes (B={B}, L={L}, bf16, "
        "dropout 0.1; CUDA events over back-to-back calls), and held against their "
        "plain versions there")
    rng = np.random.default_rng(SEED + 6)
    E, H, dt, rate, seed = mp.hidden_size, mp.num_attention_heads, torch.bfloat16, mp.dropout, 7
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(DEV)  # noqa: E731
    x = f32(rng.standard_normal((B, L, E)) * 0.5).to(dt)
    dout = f32(rng.standard_normal((B, L, E))).to(dt)
    wqkv, bqkv = f32(rng.standard_normal((E, 3 * E)) * 0.05).to(dt), f32(np.zeros(3 * E))
    wo, bo = f32(rng.standard_normal((E, E)) * 0.05).to(dt), f32(np.zeros(E))
    bias_row = torch.zeros(B, L, device=DEV)
    times, bounds = {}, {}
    # the plain versions get the kernels' mask made once (its Philox in
    # int64 PyTorch ops would need tens of GB at this shape)
    keep = ab.dropout_mask(seed, rate, B, H, L, DEV)
    times["attention_block_train"] = a_b(
        torch,
        lambda: ab.train_forward_plain(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed,
                                       keep=keep),
        lambda: ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed), iters=3,
    )
    # K3 again at dropout 0 (no Philox draws), and each part of it timed
    k3 = {r: (lambda r=r: ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, r,
                                           seed if r else None)) for r in (0.0, rate)}
    log(f"  attention_block_train [{B}, {L}, {E}]: kernel {time_ms(torch, k3[0.0], 3):.4f} ms "
        f"at dropout 0, {times['attention_block_train'][0]:.4f} ms at dropout {rate}")
    for r, fn in k3.items():
        log_parts(f"attention_block_train (K3) dropout {r}", part_times(torch, fn, 3),
                  block_cost(B, L, E, E, 2, "train"))
    _, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed)

    def k4():
        return ab.train_backward(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed)

    times["attention_block_bwd"] = a_b(
        torch,
        lambda: ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed,
                                        keep=keep),
        k4, iters=3,
    )
    log_parts(f"attention_block_bwd (K4) dropout {rate}", part_times(torch, k4, 3, BACKWARD_PARTS),
              block_cost(B, L, E, E, 2, "backward_simt"))
    # the same calls held against each other at this shape, as phases 9-10
    # do at B=8: K3 (out, qkv, ctx, statistics), then K4 on K3's saved
    # tensors (dx, dqkv, and the fp32 weight and bias gradients)
    tag = f"[{B}, {L}, {E}] bf16 dropout {rate}"
    out, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed)
    ref, ref_saved = ab.train_forward_plain(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate,
                                            seed, keep=keep)
    for name, a, r in [("out", out, ref), ("qkv", saved[0], ref_saved[0]),
                       ("ctx", saved[1], ref_saved[1])]:
        hold(results, "attention_block_train", f"K3 {name} {tag}", a, r, TOL["bfloat16"])
    stats = ab.softmax_stats_plain(saved[0], H, B, L, bias_row)  # K3's own q and k
    for name, a, r in [("row max", saved[2], stats[0]), ("denominator", saved[3], stats[1])]:
        hold(results, "attention_block_train", f"K3 {name} {tag}", a, r, TOL["float32"])
    del stats
    hold_flash_stats(torch, saved, H, bias_row, tag)
    del out, ref
    dx, dqkv = ab.train_backward(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed)
    rdx, rdqkv = ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None, rate,
                                         seed, keep=keep)
    x2, d2 = x.reshape(B * L, E).float(), dout.reshape(B * L, E).float()
    for name, a, r, tol in [
        ("dx", dx, rdx, TOL["bfloat16"]), ("dqkv", dqkv, rdqkv, TOL["bfloat16"]),
        ("dWqkv", x2.T @ dqkv.float(), x2.T @ rdqkv.float(), TOL_GRAD["bfloat16"]),
        ("dbqkv", dqkv.float().sum(0), rdqkv.float().sum(0), TOL_GRAD["bfloat16"]),
        ("dWo", saved[1].float().T @ d2, ref_saved[1].float().T @ d2, TOL_GRAD["bfloat16"]),
    ]:
        hold(results, "attention_block_bwd", f"K4 {name} {tag}", a, r, tol)
    del saved, ref_saved, keep, dx, dqkv, rdx, rdqkv, x2, d2
    bounds["attention_block_train"] = block_bound(block_cost(B, L, E, E, 2, "train"))
    bounds["attention_block_bwd"] = block_bound(block_cost(B, L, E, E, 2, "backward"))

    # library yardsticks, timed only: the same block on cuBLAS and SDPA in
    # bf16 under autograd (forward; then its backward), and F.layer_norm's
    # backward; they round at other points than the kernels
    xg = x.detach().requires_grad_()
    ws = [t.detach().requires_grad_() for t in (wqkv, bqkv.to(dt), wo, bo.to(dt))]
    attn_bias = bias_row.clamp(min=NEG).to(dt)[:, None, None, :]

    def stock_block():
        qkv = F.linear(xg, ws[0].T, ws[1])
        q, k, v = qkv.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_bias, dropout_p=rate)
        return F.linear(ctx.transpose(1, 2).reshape(B, L, E), ws[2].T, ws[3])

    library = {"attention_block_train": time_ms(torch, stock_block, 3)}
    stock_out = stock_block()
    library["attention_block_bwd"] = time_ms(
        torch, lambda: torch.autograd.grad(stock_out, [xg, *ws], dout, retain_graph=True), 3)
    del stock_out

    N = B * L
    xl, res, dy = (f32(rng.standard_normal((N, E))).to(dt) for _ in range(3))
    gamma, beta = f32(1 + 0.1 * rng.standard_normal(E)), f32(0.1 * rng.standard_normal(E))
    times["dropout_add_layernorm_bwd"] = a_b(
        torch, lambda: fused_ln.dropout_add_layernorm_bwd_plain(dy, xl, res, gamma, seed, rate),
        lambda: fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma, seed, rate), iters=10,
    )
    # K6 again at dropout 0 (no Philox draws), beside its library call,
    # which does no dropout either
    k6_0 = time_ms(torch, lambda: fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma), 10)
    keep = fused_ln.dropout_mask((N, E), seed, rate, DEV)
    got = fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma, seed, rate)
    ref = fused_ln.dropout_add_layernorm_bwd_plain(dy, xl, res, gamma, seed, rate, keep=keep)
    for name, a, r in zip(("dx", "dres", "dgamma", "dbeta"), got, ref):
        hold(results, "dropout_add_layernorm_bwd", f"K6 {name} [{N}, {E}] bf16 dropout {rate}",
             a, r, TOL["bfloat16"] if a.dtype == dt else TOL_GRAD["bfloat16"])
    # no float atomics in the dgamma/dbeta sums: a second call, same bits
    again = fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma, seed, rate)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  K6 [{N}, {E}] dropout {rate}: a second call gives the same dx, dres, dgamma "
        f"and dbeta bits: {same}")
    if not same:
        raise AssertionError("K6: two calls on the same inputs differ")
    del keep, got, ref, again
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k6_per_draw = per_draw["ln_bwd"]
    bound6 = ln_bound(N, E, 2, 5, 20.0, N * E, k6_per_draw, sms, clock_mhz)
    bound6_0 = ln_bound(N, E, 2, 5, 20.0, 0, k6_per_draw, sms, clock_mhz)
    bounds["dropout_add_layernorm_bwd"] = bound6[:2]
    log(f"  dropout_add_layernorm_bwd [{N}, {E}] bound terms: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in bound6[2].items())
        + f" ({N * E} draws, {max(k6_per_draw.values()):.2f} integer instructions a draw on "
        f"the busier pipe, {INT_OPS_PER_SM_CLOCK} a clock an SM x {sms} SMs x {clock_mhz:.0f} MHz)")
    yg = (xl + res).requires_grad_()
    gg, bg = gamma.to(dt).requires_grad_(), beta.to(dt).requires_grad_()
    ln_out = F.layer_norm(yg, (E,), gg, bg, mp.layer_norm_eps)
    library["dropout_add_layernorm_bwd"] = time_ms(
        torch, lambda: torch.autograd.grad(ln_out, [yg, gg, bg], dy, retain_graph=True), 10)
    k6_1 = times["dropout_add_layernorm_bwd"][0]
    log(f"  dropout_add_layernorm_bwd [{N}, {E}]: kernel {k6_0:.4f} ms at dropout 0 (bound "
        f"{bound6_0[0]:.4f} ms, {bound6_0[0] / k6_0:.1%} of it; library "
        f"{library['dropout_add_layernorm_bwd']:.4f} ms), {k6_1:.4f} ms at dropout {rate} "
        f"(bound {bound6[0]:.4f} ms, {bound6[0] / k6_1:.1%} of it)")
    for name, (k, p) in times.items():
        log(f"  {name}: kernel {k:.4f} ms, plain {p:.4f} ms, library {library[name]:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    return train, launches, {"times": times, "library": library, "bounds": bounds}


def flash_cost(B, L, H, D, itemsize, backward=False):
    """(FLOPs, bytes) of K7 or K8 on dense rows: the forward's q.k and
    p.v, 4·L²·D a (batch, head), with q, k, v read and o written; the
    backward's five products, 10·L²·D, with q, k, v, do read and dq, dk,
    dv written."""
    tensors, products = (7, 10) if backward else (4, 4)
    return products * L * L * D * B * H, tensors * B * L * H * D * itemsize


def phase_flash_kernels(torch, cfg, results: dict) -> dict:
    """14. K7, K8 and K9 against their plain versions, then timed."""
    import numpy as np
    import torch.nn.functional as F

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import flash_attention as fa
    from pl_bert_tpu_torch.ops import fused_ln
    from pl_bert_tpu_torch.ops.attention import NEG

    log("phase 14: flash attention forward (K7) and backward (K8) against their plain versions")
    rng = np.random.default_rng(SEED + 7)
    H, D, E, dev = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size, DEV
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731

    def case(B, L, lengths, segments, dtype, heads=H, hd=D):
        """q, k, v as views of one fused [B, L, 3·heads·hd] projection (the
        model's layout), dout, and the bias and segment rows: rows padded
        to ``lengths``, and with ``segments`` two or three packed samples a
        row."""
        width = heads * hd
        qkv = f32(rng.standard_normal((B, L, 3 * width)) * 0.7).to(dtype)
        q, k, v = (t.reshape(B, L, heads, hd) for t in qkv.split(width, dim=-1))
        dout = f32(rng.standard_normal((B, L, heads, hd))).to(dtype)
        valid = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
        seg = None
        if segments:
            cuts = np.asarray(lengths)[:, None] * np.array([[0.3, 0.55]])
            seg_np = (np.arange(L)[None, :, None] >= cuts[:, None, :]).sum(-1)
            seg = torch.from_numpy(np.where(valid, seg_np, -1).astype(np.int32)).to(dev)
        bias_row, seg_row = ab.rows(attention_bias_from_mask(f32(valid)), seg, B, L)
        return q, k, v, dout, bias_row, seg_row

    def check(tag, B, L, lengths, segments, dtype, rate, heads=H, hd=D):
        dname = str(dtype).removeprefix("torch.")
        q, k, v, dout, bias_row, seg_row = case(B, L, lengths, segments, dtype, heads, hd)
        seed = 977 if rate else None
        keep = ab.dropout_mask(seed, rate, B, heads, L, dev) if rate else None
        out = fa.flash_attention_fwd(q, k, v, bias_row, seg_row, rate, seed)
        grads = fa.flash_attention_bwd(dout, q, k, v, bias_row, seg_row, rate, seed)
        ref = fa.flash_attention_plain(q, k, v, bias_row, seg_row, rate, seed, keep=keep)
        refs = fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, seg_row, rate, seed,
                                            keep=keep)
        torch.cuda.synchronize()
        if out.shape != (B, L, heads, hd) or out.dtype != dtype:
            raise AssertionError(f"K7 {tag}: {out.shape} {out.dtype}")
        label = f"{tag} {dname} dropout {rate}"
        hold(results, "flash_attention", f"K7 out {label}", out, ref, TOL[dname])
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            hold(results, "flash_attention_bwd", f"K8 {name} {label}", a, r, TOL[dname])

    padded = [512, 480, 384, 256, 128, 64, 5, 0]
    mask = ab.dropout_mask(977, 0.1, 8, H, 512, dev)
    if not torch.equal(mask.bool(), ab.dropout_keep(977, 0.1, 8, H, 512, dev)):
        raise AssertionError("the kernels' dropout mask is not the plain Philox")
    log("  the kernels' dropout mask equals the plain Philox bit for bit")
    del mask
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.0, 0.1):
            check("[8, 512, 12, 64] padded", 8, 512, padded, False, dtype, rate)
            check("[8, 512, 12, 64] packed", 8, 512, padded, True, dtype, rate)
        check("[8, 200, 12, 64] packed", 8, 200, [200, 199, 150, 101, 100, 64, 3, 0], True,
              dtype, 0.1)
        # head_dim 128, which the flash kernels take too
        check("[8, 200, 6, 128] packed", 8, 200, [200, 199, 150, 101, 100, 64, 5, 0], True,
              dtype, 0.1, heads=E // 128, hd=128)
    Bt = 96
    check(f"[{Bt}, 512, 12, 64] packed", Bt, 512, rng.integers(300, 513, Bt), True,
          torch.bfloat16, 0.1)
    torch.cuda.empty_cache()

    N = Bt * 512
    for dtype in (torch.bfloat16, torch.float32):
        x, res = (f32(rng.standard_normal((N, E))).to(dtype) for _ in range(2))
        got, want = fused_ln.add_copy(x, res), fused_ln.add_copy_plain(x, res)
        torch.cuda.synchronize()
        results["add_copy"].append(float((got.float() - want.float()).abs().max()))
        log(f"  K9 add_copy [{N}, {E}] {dtype}: bitwise {bool(torch.equal(got, want))}")
        if got.dtype != dtype or not torch.equal(got, want):
            raise AssertionError(f"K9 add_copy {dtype} differs from its plain version")
        # a count that is no whole number of 16-byte vectors (1001 x 769),
        # and views one element past an aligned base (the scalar loop)
        n = 1001 * 769
        flat = [f32(rng.standard_normal(n + 1)).to(dtype) for _ in range(2)]
        for label, xv, rv in (("ragged", flat[0][:n], flat[1][:n]),
                              ("unaligned view", flat[0][1:], flat[1][1:])):
            xv, rv = xv.view(1001, 769), rv.view(1001, 769)
            got = fused_ln.add_copy(xv, rv)
            want = fused_ln.add_copy_plain(xv, rv)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            log(f"  K9 add_copy [1001, 769] {label} {dtype}: bitwise {same}")
            if not same:
                raise AssertionError(f"K9 add_copy {label} {dtype} differs from its plain version")

    log("phase 14: K7 and K8 timed, bf16, dropout 0.1, full-length rows, no segments: device "
        "time from a replayed CUDA graph at B=8, CUDA events over back-to-back calls at B=96")
    times, library, bounds = {}, {}, {}
    rate, seed, dt = 0.1, 977, torch.bfloat16
    for B, timer, iters in ((8, graph_ms, 10), (Bt, time_ms, 3)):
        q, k, v, dout, bias_row, _ = case(B, 512, [512] * B, False, dt)
        keep = ab.dropout_mask(seed, rate, B, H, 512, dev)
        fwd = a_b(torch,
                  lambda: fa.flash_attention_plain(q, k, v, bias_row, None, rate, seed, keep=keep),
                  lambda: fa.flash_attention_fwd(q, k, v, bias_row, None, rate, seed),
                  iters=iters, timer=timer)
        bwd = a_b(torch,
                  lambda: fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, None, rate, seed,
                                                       keep=keep),
                  lambda: fa.flash_attention_bwd(dout, q, k, v, bias_row, None, rate, seed),
                  iters=iters, timer=timer)
        fwd0 = timer(torch, lambda: fa.flash_attention_fwd(q, k, v, bias_row, None), iters)
        log(f"  flash_attention [{B}, 512, 12, 64]: kernel {fwd0:.4f} ms at dropout 0, "
            f"{fwd[0]:.4f} ms at dropout {rate}")
        parts = part_times(torch, lambda: fa.flash_attention_bwd(dout, q, k, v, bias_row, None,
                                                                 rate, seed),
                           3, FLASH_BACKWARD_PARTS)
        log(f"  flash_attention_bwd [{B}, 512, 12, 64] dropout {rate}: dq kernel "
            f"{parts['dq']:.4f} ms (three passes over the keys), dk/dv kernel "
            f"{parts['dkdv']:.4f} ms")
        del keep
        # library yardstick, timed only: SDPA with the mask, forward, then
        # its backward; it rounds at other points than the kernels
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        attn_bias = bias_row.clamp(min=NEG).to(dt)[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=attn_bias, dropout_p=rate)
        lib_fwd = time_ms(torch, sdpa, max(iters, 5))
        sdpa_out = sdpa()
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, [qs, ks, vs], dout.transpose(1, 2), retain_graph=True), max(iters, 5))
        del sdpa_out
        shape = f"[{B}, 512, 12, 64]"
        for name, (kms, pms), lib, back in (("flash_attention", fwd, lib_fwd, False),
                                            ("flash_attention_bwd", bwd, lib_bwd, True)):
            bound = bound_ms(*flash_cost(B, 512, H, D, 2, back))
            log(f"  {name} {shape}: kernel {kms:.4f} ms, plain {pms:.4f} ms, library "
                f"{lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
            # the kernels line carries the packed run's shape, B=96
            times[name], library[name], bounds[name] = (kms, pms), lib, bound
        torch.cuda.empty_cache()

    x, res = (f32(rng.standard_normal((N, E))).to(dt) for _ in range(2))
    times["add_copy"] = a_b(torch, lambda: fused_ln.add_copy_plain(x, res),
                            lambda: fused_ln.add_copy(x, res), iters=20)
    library["add_copy"] = time_ms(torch, lambda: torch.add(x, res), 20)
    # one fp32 add an element; x and the residual read, the output written
    bounds["add_copy"] = bound_ms(1.0 * N * E, 3 * N * E * 2, PEAK_FP32_FLOPS)
    kms, pms = times["add_copy"]
    log(f"  add_copy [{N}, {E}]: kernel {kms:.4f} ms, plain {pms:.4f} ms, library "
        f"{library['add_copy']:.4f} ms, bound {bounds['add_copy'][0]:.4f} ms "
        f"({bounds['add_copy'][1]})")
    return {"times": times, "library": library, "bounds": bounds}


def phase_packed_run(torch, workdir: str) -> tuple[dict, dict]:
    """16. the Trainer through its normal entry on a packed,
    on-device-masked run on the flash path: 8 steps, then a resume to 12."""
    import contextlib
    import io

    import numpy as np

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.models.albert import build_model
    from pl_bert_tpu_torch.training.train import train

    out_dir = os.path.join(workdir, "runs")
    config_path = os.path.join(workdir, "packed_run.yml")
    run_dir = os.path.join(out_dir, "smoke")

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            sys.__stdout__.flush()
            return super().write(text)

    def launch(steps: int, paths) -> tuple[str, dict, float]:
        for path in paths:
            with open(path, "w", encoding="utf-8") as f:
                f.write(RUN_CONFIG.format(out=out_dir, steps=steps))
        counters = reset_counters()  # the packed run starts here
        printed = Tee()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            final = train({"config_path": config_path, "run_name": "smoke", "device": DEV})
        wall = time.perf_counter() - t0
        launches = read_counters(counters)  # the packed run ends here
        if final != steps:
            raise AssertionError(f"the run stopped at step {final}, not {steps}")
        return printed.getvalue(), launches, wall

    log("phase 16: the packed run through training.train.train(): flagship model, "
        "attention_impl pallas, on-device masking, sequence packing, B=96, bf16, dropout 0.1, "
        "8 steps")
    printed, first, wall1 = launch(8, [config_path])
    if "sequence packing:" not in printed or "token occupancy" not in printed:
        raise AssertionError("the run did not print its packing line")
    log("phase 16: the same call again with num_steps 12 (the run directory's config copy "
        "is what a resumed run reads, so it is raised there too): resumes from step_8.pth")
    printed2, second, wall2 = launch(12, [config_path, os.path.join(run_dir, "packed_run.yml")])
    if "step_8.pth loaded" not in printed2 or "Resuming" not in printed2:
        raise AssertionError("the second call did not resume from step_8.pth")

    with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    if [r["step"] for r in steps] != list(range(1, 13)):
        raise AssertionError(f"metrics.jsonl steps: {[r['step'] for r in steps]}")
    losses = [r["loss"] for r in steps]
    vals = [r for r in records if "val_phoneme_loss" in r]
    if not all(np.isfinite(losses)) or not all(np.isfinite(r["val_phoneme_loss"]) for r in vals):
        raise AssertionError(f"non-finite loss in the packed run: {losses}")
    for n in (4, 8, 12):
        if not os.path.isfile(os.path.join(run_dir, f"step_{n}.pth")):
            raise AssertionError(f"step_{n}.pth is missing")
    config = Config.load(config_path)
    ckpt = torch.load(os.path.join(run_dir, "step_12.pth"), map_location="cpu",
                      weights_only=True)
    fresh = build_model(config.model_params, config.training_params.mixed_precision)
    fresh.load_state_dict(ckpt["net"], strict=True)
    if ckpt["step"] != 12 or len(ckpt["optimizer"]["state"]) != len(ckpt["net"]):
        raise AssertionError("step_12.pth: wrong step or optimizer state")

    n = config.model_params.num_hidden_layers
    total = {k: first[k] + second[k] for k in first}
    # every training step runs K7 and K8 once and K5 and K6 twice a layer;
    # every validation forward K7 once and K5 twice a layer
    evals, rem = divmod(total["flash_attention"] - 12 * n, n)
    expect = dict.fromkeys(total, 0)
    expect.update({"flash_attention": n * (12 + evals), "flash_attention_bwd": n * 12,
                   "dropout_add_layernorm": 2 * n * (12 + evals),
                   "dropout_add_layernorm_bwd": 2 * n * 12})
    log(f"  launch counters over 12 training steps and {evals} validation forwards: {total}")
    if rem or evals < 0 or total != expect:
        raise AssertionError(f"launch counts {total} != {expect}")
    # per-step rates from the run's own log (log_interval 1: each record
    # ends in a host read of the loss, so the step has finished); the
    # median leaves out the steps that follow a checkpoint and a validation
    occupancy = float(printed.split("rows (")[1].split("%")[0]) / 100
    sps = float(np.median([r["steps_per_sec"] for r in steps if "steps_per_sec" in r]))
    tokens = sps * config.training_params.batch_size * config.dataset_params.max_seq_length
    log(f"  losses {[round(v, 4) for v in losses]}; validation "
        f"{[round(r['val_phoneme_loss'], 4) for r in vals]}")
    log(f"  packed run: {1e3 / sps:.1f} ms a step (median), {tokens:.0f} token positions/s, "
        f"{tokens * occupancy:.0f} phoneme tokens/s at {occupancy:.0%} occupancy; the two "
        f"calls took {wall1:.1f} s and {wall2:.1f} s with set-up, validation and checkpoints")
    run = {"step_ms": 1e3 / sps, "tokens_per_s": tokens * occupancy, "occupancy": occupancy,
           "losses": losses}
    return run, total


def phase_microbench(torch) -> dict:
    """17. the fused-LN microbench through its own entry."""
    from pl_bert_tpu_torch.tools import bench_fused_ln

    log("phase 17: the fused-LN microbench (copy anchor K9, K5, K5+K6, plain)")
    counters = reset_counters()  # the microbench's run starts here
    bench_fused_ln.main(["--steps", "5"])
    launches = read_counters(counters)  # the microbench's run ends here
    # the anchor's case: the warm-up chains and the one captured in a graph
    # (its five timed replays launch no wrapper)
    expect = bench_fused_ln.CALLS * (bench_fused_ln.WARMUP + 1)
    if launches["add_copy"] != expect:
        raise AssertionError(f"add_copy launched {launches['add_copy']} times, not {expect}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pl_bert_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)  # 1. the card, beside every number below
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from pl_bert_tpu_torch.models.albert import AlbertConfig
    from pl_bert_tpu_torch.runtime import build

    log("phase 2: build")
    t0 = time.perf_counter()
    for name, path in build.build_all().items():  # one nvcc a source, all at once
        log(f"  nvcc {name}: {path}")
    build.import_triton()
    log(f"  built in {time.perf_counter() - t0:.1f} s (Triton compiles at first launch)")
    phase_tensor_cores(build)
    per_draw = phase_fused_ln_build(build)
    clock_mhz = max_sm_clock_mhz()

    cfg = AlbertConfig()  # the flagship model of configs/config.yml
    results = {name: [] for name in KERNELS}
    phase_kernels(torch, cfg, results)
    sd = random_state_dict(torch, cfg, SEED)
    encoders = phase_encoder(torch, cfg, sd)
    with tempfile.TemporaryDirectory() as workdir:
        serve_launches, stats2 = phase_serve(torch, cfg, sd, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        _, stats1 = phase_serve(torch, cfg, sd, workdir, depth=1)
    phase_pipeline(torch, cfg, sd, encoders["bf16", "auto"], {1: stats1, 2: stats2})
    with tempfile.TemporaryDirectory() as workdir:
        log("phase 15: 8 requests from a server started with attention_impl pallas")
        phase_serve(torch, cfg, sd, workdir, impl="pallas", per_client=2)
    serving = phase_timing(torch, cfg, encoders, per_draw, clock_mhz)
    del encoders
    torch.cuda.empty_cache()
    phase_train_kernels(torch, cfg, results)
    flash = phase_flash_kernels(torch, cfg, results)
    train, train_launches, training = phase_train(torch, results, per_draw, clock_mhz)
    with tempfile.TemporaryDirectory() as workdir:
        run, run_launches = phase_packed_run(torch, workdir)
    bench_launches = phase_microbench(torch)

    paths = {"serving": (serve_launches, serving), "training": (train_launches, training),
             "packed_run": (run_launches, flash), "microbench": (bench_launches, flash)}
    kernels = []
    for name, (route, source, replaces, path) in KERNELS.items():
        launches, measured = paths[path]
        ms, plain_ms = measured["times"][name]
        bound, bound_by = measured["bounds"][name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            # the count from the run of the path the kernel serves; every
            # path's count beside (K5 runs in all but the plain ones)
            "launches": launches[name],
            "max_abs_err": max(results[name]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": measured["library"].get(name),
            "launches_by_path": {p: counts[name] for p, (counts, _) in paths.items()},
        })
    log(f"train step, block path: {train['step_ms']:.1f} ms, {train['tokens_per_s']:.0f} "
        f"phoneme tokens/s (B=96, L=512, bf16, dropout 0.1)")
    log(f"packed run, flash path: {run['step_ms']:.1f} ms a step, {run['tokens_per_s']:.0f} "
        f"phoneme tokens/s at {run['occupancy']:.0%} occupancy (B=96, L=512, bf16, dropout 0.1)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
