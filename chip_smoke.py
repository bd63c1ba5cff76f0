#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and its training step once on
one CUDA card.

    python3 chip_smoke.py

At the full width of the flagship model (configs/config.yml: hidden 768,
12 heads of 64, FFN 2048, 12 layers, embedding 128, vocab 188, L 512)
with random weights made from a fixed seed, in order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from the sources in this checkout;
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes, in bf16 and fp32 (TF32 off);
4. runs the 12-layer encoder on the kernel path against the plain path;
5. writes the weights as a reference .pth and starts the port's HTTP
   server through its normal entry, in a thread;
6. answers 32 requests of 5-500 phonemes from 4 client threads and holds
   each answer against a direct PhonemeEncoder call;
7. checks from the launch counters that every forward of that run went
   through the kernels (12 attention blocks, 24 fused LNs a forward);
8. times each kernel against its plain version, and the encoder forward
   at B=8, L=512 on both paths;
9. holds the attention block's training forward (K3) against its plain
   version at [8, 512, 768] in bf16 and fp32 (output, qkv, context,
   softmax statistics), and checks the light forward (K1) returns K3's
   output bitwise, with attention dropout 0 and 0.1;
10. holds its backward (K4) against the plain backward on the same saved
   tensors (dx, dW, db), dropout 0 and 0.1 — at 0.1 the plain version
   gets the mask the kernels' Philox code writes, which must equal the
   plain Philox bit for bit;
11. holds the fused LN backward (K6) against its plain version, dropout
   0 and 0.1 (the mask from the kernels' ``tl.rand``);
12. checks the keep rate of every dropout site at the training shape
   (0.9 ± 1e-3) and that a seed gives the same mask twice;
13. runs the train step (hidden 768, 12 heads, FFN 2048, 12 layers,
   L 512): 3 steps at B=8, dropout 0, on the kernel path against the
   plain path from the same weights and batches (loss and grad_norm per
   step), then bench.py's workload — B=96, bf16, dropout 0.1, AdamW at
   7e-5 — on the kernel path, 3 warm-up and 5 timed steps, with the
   launch counters read over the timed steps (per step: K3 12, K4 12,
   K5 24, K6 24, K1 0); then times K3, K4 and K6 at that shape against
   their plain versions and the library calls, and holds each against
   its plain version there (K4 on K3's saved tensors, dropout 0.1 with
   the kernels' mask), as phases 9-11 do at B=8.

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
#   rel-L2 ~6e-5 for the block, ~2e-5 for the LN on the card.
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
SEED = 0
BUCKETS = (64, 128, 256)
# name → (route, source, TPU kernel replaced, the path whose run counts it)
KERNELS = {
    "attention_block": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                        "pl_bert_tpu/ops/attention_block.py:253", "serving"),
    "dropout_add_layernorm": ("triton", "pl_bert_tpu_torch/ops/_ln_triton.py",
                              "pl_bert_tpu/ops/fused_ln.py:72", "serving"),
    "attention_block_train": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                              "pl_bert_tpu/ops/attention_block.py:116", "training"),
    "attention_block_bwd": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                            "pl_bert_tpu/ops/attention_block.py:315", "training"),
    "dropout_add_layernorm_bwd": ("triton", "pl_bert_tpu_torch/ops/_ln_triton.py",
                                  "pl_bert_tpu/ops/fused_ln.py:88", "training"),
}
MAX_BATCH = 8
N_CLIENTS, PER_CLIENT = 4, 8


def log(msg: str) -> None:
    print(msg, flush=True)


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
    cases = [  # (name, B, L, valid lengths per row, segments)
        ("L512", 8, 512, [512, 480, 384, 256, 128, 64, 5, 0], False),
        ("L64", 8, 64, [64, 63, 50, 33, 17, 8, 1, 0], False),
        ("L200_seg", 8, 200, [200, 199, 150, 101, 100, 64, 3, 0], True),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        packed = ab.pack_weights(
            *(t.to(dev) for n in "qkvo" for t in (w[n], b[n])), dtype
        )
        for name, B, L, lengths, segments in cases:
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
            out = ab.attention_block_packed(x, *packed, H, bias=bias, segment_ids=seg)
            ref = ab.attention_block_plain(x, *packed, H, bias=bias, segment_ids=seg)
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
        out = fused_ln.dropout_add_layernorm(xs[0], xs[1], gamma, beta)
        ref = fused_ln.dropout_add_layernorm_plain(xs[0], xs[1], gamma, beta)
        torch.cuda.synchronize()
        if out.dtype != dtype or not torch.isfinite(out).all():
            raise AssertionError(f"dropout_add_layernorm {dname}: bad output")
        err = errors(out, ref)
        results["dropout_add_layernorm"].append(err["max_abs"])
        gate(f"dropout_add_layernorm [{N}, {E}] {dname}", err, TOL[dname])

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
        for impl in ("auto", "eager"):
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
    return encoders


def phase_serve(torch, cfg, sd, workdir: str) -> tuple[dict, dict]:
    """5-7. serve through the port's entry, check answers and counters."""
    import numpy as np

    from pl_bert_tpu_torch.models.inference import PhonemeEncoder
    from pl_bert_tpu_torch.ops import attention_block, fused_ln
    from pl_bert_tpu_torch.serving.server import build_server, serve_in_thread

    log("phase 5: reference .pth + the port's HTTP server in a thread")
    ckpt = os.path.join(workdir, "step_0.pth")
    torch.save({"net": {f"encoder.{k}": v for k, v in sd.items()}, "step": 0,
                "epoch": 0}, ckpt)
    counters = (attention_block.LAUNCHES, fused_ln.LAUNCHES, attention_block.LAUNCHES_TRAIN,
                attention_block.LAUNCHES_BWD, fused_ln.LAUNCHES_BWD)
    for c in counters:  # the serving path's run starts here
        c.reset()
    server = build_server([
        "--checkpoint", ckpt, "--port", "0", "--max_batch", str(MAX_BATCH),
        "--buckets", ",".join(map(str, BUCKETS)), "--device", DEV,
    ])
    warm = len(BUCKETS) + 1  # build_server warms every bucket and 512
    serve_in_thread(server)
    port = server.server_address[1]
    log(f"  {server.banner}")
    try:
        rng = np.random.default_rng(SEED + 3)
        sizes = [5, 500, *rng.integers(5, 501, N_CLIENTS * PER_CLIENT - 2)]
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
        launches = {c.name: c.count for c in counters}  # the serving path's run ends here
        health = http_json(probe, "GET", "/healthz")
        probe.close()
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
    forwards = warm + stats["batches"]
    log(f"  answered {len(answers)} in {wall:.2f} s: {stats['batches']} batches, "
        f"mean batch {stats['mean_batch_size']:.2f}, p50 "
        f"{stats['latency_ms']['p50']:.1f} ms, p95 {stats['latency_ms']['p95']:.1f} ms; "
        f"healthz hidden_size {health['hidden_size']}")

    direct = PhonemeEncoder.from_checkpoint(
        ckpt, batch_size=MAX_BATCH, seq_buckets=BUCKETS, device=DEV
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
    expect = {"attention_block": cfg.num_hidden_layers * forwards,
              "dropout_add_layernorm": 2 * cfg.num_hidden_layers * forwards,
              "attention_block_train": 0, "attention_block_bwd": 0,
              "dropout_add_layernorm_bwd": 0}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    return launches, stats


def phase_timing(torch, cfg, encoders) -> dict:
    """8. kernel against plain version, and the encoder forward, timed;
    the library yardsticks and the bounds beside the kernels."""
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
    bounds = {"attention_block": bound_ms(*block_cost(B, L, E, E, 2))}
    res = torch.from_numpy(rng.standard_normal((B * L, E), dtype=np.float32)).to(DEV, torch.bfloat16)
    x2 = x.reshape(B * L, E)
    ln = att["ln"]
    times["dropout_add_layernorm"] = a_b(
        torch, lambda: fused_ln.dropout_add_layernorm_plain(x2, res, ln["g"], ln["b"]),
        lambda: fused_ln.dropout_add_layernorm(x2, res, ln["g"], ln["b"]), iters=200,
        timer=graph_ms,
    )
    # its library yardstick: the add and F.layer_norm (serving runs dropout 0)
    g16, b16 = ln["g"].to(torch.bfloat16), ln["b"].to(torch.bfloat16)
    library["dropout_add_layernorm"] = graph_ms(
        torch, lambda: F.layer_norm(x2 + res, (E,), g16, b16, cfg.layer_norm_eps), 200)
    # x and the residual read and the output written, ~10 fp32 flops an element
    bounds["dropout_add_layernorm"] = bound_ms(10.0 * B * L * E, 3 * B * L * E * 2,
                                               PEAK_FP32_FLOPS)
    texts = [phoneme_text(rng, 512) for _ in range(B)]
    ids, mask, _ = enc.encode_batch(texts)
    times["encoder_forward"] = a_b(
        torch, lambda: plain.forward(ids, mask), lambda: enc.forward(ids, mask), iters=5,
    )
    for name, (k, p) in times.items():
        extra = (f", library {library[name]:.4f} ms, bound {bounds[name][0]:.4f} ms "
                 f"({bounds[name][1]})" if name in library else "")
        log(f"  {name}: kernel {k:.4f} ms, plain {p:.4f} ms{extra}")
    return {"times": times, "library": library, "bounds": bounds}


def bound_ms(flops: float, nbytes: float, flops_peak: float = PEAK_BF16_FLOPS):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_cost(B, L, E, P, itemsize, kind="light"):
    """(FLOPs, bytes) of the attention block's kernels, ``kind`` "light"
    (K1), "train" (K3) or "backward" (K4). Forward: the four projections
    and q.k, p.v, 2·B·L·P·(4E + 2L); x and the weights read, the output
    written, and for K3 also qkv, ctx and the statistics. Backward:
    do = dout·Woᵀ, dx = dqkv·Wqkvᵀ, and q.k, do.v, pᵀ·do, ds·k, dsᵀ·q,
    2·B·L·P·(4E + 5L); dout, qkv, the weights and the statistics read,
    dqkv and dx written."""
    H = P // 64
    weights = 4 * E * P * itemsize
    stats = 2 * B * H * L * 4
    if kind == "backward":
        flops = 2 * B * L * P * (4 * E + 5 * L)
        nbytes = 2 * B * L * (E + 3 * P) * itemsize + weights + stats
        return flops, nbytes
    flops = 2 * B * L * P * (4 * E + 2 * L)
    nbytes = 2 * B * L * E * itemsize + weights
    if kind == "train":
        nbytes += B * L * 4 * P * itemsize + stats
    return flops, nbytes


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
            for name, a, r in [("row max", saved[2], ref_saved[2]),
                               ("denominator", saved[3], ref_saved[3])]:
                gate(f"K3 {name} {tag}", errors(a, r), TOL["float32"])
            log(f"  K1 output == K3 output bitwise ({tag})")

            dx, dqkv = ab.train_backward(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed)
            rdx, rdqkv = ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None,
                                                 rate, seed, keep=keep)
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

    Bt = 96
    log(f"phase 12: dropout keep rates at the training shape (B={Bt}, rate 0.1)")
    rate = 0.1
    sites = {
        "attention (Philox, CUDA)": lambda s: ab.dropout_mask(s, rate, Bt, H, L, dev),
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


def phase_train(torch, results: dict) -> tuple[dict, dict, dict]:
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
    log("phase 13: train step, kernel path against plain path: 3 steps, B=8, bf16, dropout 0")
    pool8 = full_length_batches(3, 8, L)
    losses = {}
    for impl in ("auto", "eager"):
        model = init_params(build_model(dataclasses.replace(mp, dropout=0.0, attention_impl=impl),
                                        tp.mixed_precision), seed=SEED).to(DEV)
        tx = ts.make_optimizer(tp)
        state = ts.TrainState(model, tx.init(model))
        step = ts.make_train_step(model, tx, seed=tp.seed)
        losses[impl] = [{k: float(v) for k, v in step(state, b)[1].items()} for b in pool8]
        del model, state, tx
        torch.cuda.empty_cache()
    for s, (k, p) in enumerate(zip(losses["auto"], losses["eager"])):
        rel = {m: abs(k[m] - p[m]) / abs(p[m]) for m in ("loss", "grad_norm")}
        ok = all(rel[m] <= TRAIN_TOL[m] for m in rel) and all(
            np.isfinite(k[m]) for m in ("loss", "grad_norm"))
        log(f"  step {s}: loss {k['loss']:.6f} vs {p['loss']:.6f} (rel {rel['loss']:.2e}), "
            f"grad_norm {k['grad_norm']:.6f} vs {p['grad_norm']:.6f} "
            f"(rel {rel['grad_norm']:.2e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"train step {s}: kernel path off the plain path: {rel}")

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
    counters = (ab.LAUNCHES, ab.LAUNCHES_TRAIN, ab.LAUNCHES_BWD, fused_ln.LAUNCHES,
                fused_ln.LAUNCHES_BWD)
    for c in counters:  # the training path's run starts here
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_losses = []
    for i in range(timed):
        _, m = step(state, pool[(warm + i) % len(pool)])
        step_losses.append(float(m["loss"]))  # a host read: the step has finished
    wall = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}  # the training path's run ends here
    step_ms = wall / timed * 1e3
    tokens = sum(int(pool[(warm + i) % len(pool)]["lengths"].sum()) for i in range(timed))
    log(f"  losses {[round(v, 5) for v in step_losses]}; {step_ms:.1f} ms a step, "
        f"{tokens / wall:.0f} phoneme tokens/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(np.isfinite(step_losses)):
        raise AssertionError(f"non-finite training loss: {step_losses}")
    n = mp.num_hidden_layers
    expect = {"attention_block": 0, "attention_block_train": n * timed,
              "attention_block_bwd": n * timed, "dropout_add_layernorm": 2 * n * timed,
              "dropout_add_layernorm_bwd": 2 * n * timed}
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
    _, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed)
    times["attention_block_bwd"] = a_b(
        torch,
        lambda: ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed,
                                        keep=keep),
        lambda: ab.train_backward(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed),
        iters=3,
    )
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
    for name, a, r in [("row max", saved[2], ref_saved[2]),
                       ("denominator", saved[3], ref_saved[3])]:
        hold(results, "attention_block_train", f"K3 {name} {tag}", a, r, TOL["float32"])
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
    bounds["attention_block_train"] = bound_ms(*block_cost(B, L, E, E, 2, "train"))
    bounds["attention_block_bwd"] = bound_ms(*block_cost(B, L, E, E, 2, "backward"))

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
    keep = fused_ln.dropout_mask((N, E), seed, rate, DEV)
    got = fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma, seed, rate)
    ref = fused_ln.dropout_add_layernorm_bwd_plain(dy, xl, res, gamma, seed, rate, keep=keep)
    for name, a, r in zip(("dx", "dres", "dgamma", "dbeta"), got, ref):
        hold(results, "dropout_add_layernorm_bwd", f"K6 {name} [{N}, {E}] bf16 dropout {rate}",
             a, r, TOL["bfloat16"] if a.dtype == dt else TOL_GRAD["bfloat16"])
    del keep, got, ref
    bounds["dropout_add_layernorm_bwd"] = bound_ms(20.0 * N * E, 5 * N * E * 2, PEAK_FP32_FLOPS)
    yg = (xl + res).requires_grad_()
    gg, bg = gamma.to(dt).requires_grad_(), beta.to(dt).requires_grad_()
    ln_out = F.layer_norm(yg, (E,), gg, bg, mp.layer_norm_eps)
    library["dropout_add_layernorm_bwd"] = time_ms(
        torch, lambda: torch.autograd.grad(ln_out, [yg, gg, bg], dy, retain_graph=True), 10)
    for name, (k, p) in times.items():
        log(f"  {name}: kernel {k:.4f} ms, plain {p:.4f} ms, library {library[name]:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    return train, launches, {"times": times, "library": library, "bounds": bounds}


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
    for name in build.all_sources():
        log(f"  nvcc {name}: {build.build(name)}")
    build.import_triton()
    log(f"  built in {time.perf_counter() - t0:.1f} s (Triton compiles at first launch)")

    cfg = AlbertConfig()  # the flagship model of configs/config.yml
    results = {name: [] for name in KERNELS}
    phase_kernels(torch, cfg, results)
    sd = random_state_dict(torch, cfg, SEED)
    encoders = phase_encoder(torch, cfg, sd)
    with tempfile.TemporaryDirectory() as workdir:
        serve_launches, _ = phase_serve(torch, cfg, sd, workdir)
    serving = phase_timing(torch, cfg, encoders)
    del encoders
    torch.cuda.empty_cache()
    phase_train_kernels(torch, cfg, results)
    train, train_launches, training = phase_train(torch, results)

    kernels = []
    for name, (route, source, replaces, path) in KERNELS.items():
        measured = serving if path == "serving" else training
        ms, plain_ms = measured["times"][name]
        bound, bound_by = measured["bounds"][name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            # the count from the run of the path the kernel serves; both
            # paths' counts beside (K5 runs in both)
            "launches": (serve_launches if path == "serving" else train_launches)[name],
            "max_abs_err": max(results[name]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": measured["library"].get(name),
            "launches_by_path": {"serving": serve_launches[name],
                                 "training": train_launches[name]},
        })
    log(f"train step: {train['step_ms']:.1f} ms, {train['tokens_per_s']:.0f} phoneme tokens/s "
        f"(B=96, L=512, bf16, dropout 0.1)")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
