#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

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
   at B=8, L=512 on both paths.

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
# the 12-layer encoder, kernel path against plain path (valid positions):
# each one-ulp flip feeds the next layer's bf16 roundings, so over 12
# layers the hidden states drift to about one bf16 ulp apart (rel-L2
# ~4e-3 on the card)
ENCODER_TOL = {
    "float32": {"max_abs": 1e-2, "rel_l2": 1e-4},
    "bfloat16": {"max_abs": 2e-1, "rel_l2": 1.5e-2},
}
SEED = 0
BUCKETS = (64, 128, 256)
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
    counters = (attention_block.LAUNCHES, fused_ln.LAUNCHES)
    for c in counters:  # the main path's run starts here
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
        launches = {c.name: c.count for c in counters}  # the main path ends here
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
              "dropout_add_layernorm": 2 * cfg.num_hidden_layers * forwards}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    return launches, stats


def phase_timing(torch, cfg, encoders) -> dict:
    """8. kernel against plain version, and the encoder forward, timed."""
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

    times["attention_block_stock_bf16"] = (graph_ms(torch, stock_block, 20),) * 2
    res = torch.from_numpy(rng.standard_normal((B * L, E), dtype=np.float32)).to(DEV, torch.bfloat16)
    x2 = x.reshape(B * L, E)
    ln = att["ln"]
    times["dropout_add_layernorm"] = a_b(
        torch, lambda: fused_ln.dropout_add_layernorm_plain(x2, res, ln["g"], ln["b"]),
        lambda: fused_ln.dropout_add_layernorm(x2, res, ln["g"], ln["b"]), iters=200,
        timer=graph_ms,
    )
    texts = [phoneme_text(rng, 512) for _ in range(B)]
    ids, mask, _ = enc.encode_batch(texts)
    times["encoder_forward"] = a_b(
        torch, lambda: plain.forward(ids, mask), lambda: enc.forward(ids, mask), iters=5,
    )
    for name, (k, p) in times.items():
        if name.endswith("_stock_bf16"):
            log(f"  {name}: {k:.4f} ms (cuBLAS + SDPA, speed reference)")
        else:
            log(f"  {name}: kernel {k:.4f} ms, plain {p:.4f} ms")
    return times


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
    results = {"attention_block": [], "dropout_add_layernorm": []}
    phase_kernels(torch, cfg, results)
    sd = random_state_dict(torch, cfg, SEED)
    encoders = phase_encoder(torch, cfg, sd)
    with tempfile.TemporaryDirectory() as workdir:
        launches, _ = phase_serve(torch, cfg, sd, workdir)
    times = phase_timing(torch, cfg, encoders)

    kernels = [
        {"name": "attention_block", "route": "cuda",
         "source": "pl_bert_tpu_torch/csrc/attention_block.cu",
         "replaces": "pl_bert_tpu/ops/attention_block.py:253"},
        {"name": "dropout_add_layernorm", "route": "triton",
         "source": "pl_bert_tpu_torch/ops/_ln_triton.py",
         "replaces": "pl_bert_tpu/ops/fused_ln.py:72"},
    ]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["max_abs_err"] = max(results[k["name"]])
        k["ms"], k["plain_ms"] = times[k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
