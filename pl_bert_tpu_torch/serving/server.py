"""HTTP serving front-end over the PyTorch encoder.

The handler, ``make_server``, ``attach_reload``, ``make_pool_server``
and ``serve_in_thread`` are a copy of ``pl_bert_tpu/serving/server.py``
(:61-392), over the port's own batcher and replica pool, so the port
imports nothing of the JAX package. The routes are the same
(``/encode``, ``/healthz``, ``/stats``, ``/metrics``, ``/reload``) with
the same ``/stats`` and ``/metrics`` fields; ``/reload`` takes what
the server was started from: a reference ``.pth``, or an HF export
directory (JAX server.py:458-469). The CLI below is the port's own.

Run::

    python -m pl_bert_tpu_torch.serving.server \\
        --checkpoint step_1000.pth --port 8787 --max_batch 64 \\
        --buckets 64,128,256
    python -m pl_bert_tpu_torch.serving.server --hf_dir export_dir --int8
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from pl_bert_tpu_torch.models.inference import PhonemeEncoder, load_encoder
from pl_bert_tpu_torch.serving.batcher import DynamicBatcher, QueueFull
from pl_bert_tpu_torch.serving.pool import ReplicaPool

__all__ = [
    "attach_reload", "build_server", "main", "make_pool_server", "make_server",
    "serve_in_thread",
]


def _prometheus_text(stats: dict) -> str:
    """Batcher counters → Prometheus text exposition (the ``/metrics``
    scrape route — production monitoring without any dependency)."""
    lines = []

    def emit(name: str, kind: str, help_text: str, value, labels: str = ""):
        lines.append(f"# HELP plbert_{name} {help_text}")
        lines.append(f"# TYPE plbert_{name} {kind}")
        lines.append(f"plbert_{name}{labels} {value}")

    emit("requests_total", "counter", "Requests admitted to the queue",
         stats["requests"])
    emit("batches_total", "counter", "Encoder forwards executed",
         stats["batches"])
    emit("rejected_total", "counter",
         "Requests rejected by max_pending backpressure", stats["rejected"])
    emit("errors_total", "counter", "Requests failed in the encoder",
         stats["errors"])
    emit("pending", "gauge", "Requests queued, not yet batched",
         stats["pending"])
    emit("mean_batch_size", "gauge", "Mean requests per encoder forward",
         stats["mean_batch_size"])
    lat = stats.get("latency_ms")
    if lat:
        lines.append("# HELP plbert_request_latency_ms submit-to-result "
                     "latency of recent requests")
        lines.append("# TYPE plbert_request_latency_ms summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("1", "max")):
            lines.append(
                f'plbert_request_latency_ms{{quantile="{q}"}} {lat[key]}'
            )
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive: every reply carries Content-Length, so
    # persistent connections are safe — a closed-loop client reuses one
    # TCP connection (and one server thread) instead of paying
    # connect + thread-spawn per request on the serving host
    protocol_version = "HTTP/1.1"

    # set per-server via make_server (class attribute on a subclass)
    batcher: DynamicBatcher
    model_info: dict
    # checkpoint path -> encoder params host tree (set by the CLI /
    # attach_reload; None disables the /reload route)
    load_params = None
    # /reload hardening (attach_reload): realpath prefix every reload
    # path must live under, and/or a shared-secret X-Reload-Token
    reload_root: str | None = None
    reload_token: str | None = None
    reload_lock: threading.Lock
    request_timeout_s: float = 60.0

    # silence per-request stderr lines; stats carries the counters
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._reply(200, {"ok": True, **self.model_info})
        elif self.path == "/stats":
            self._reply(200, self.batcher.stats())
        elif self.path == "/metrics":
            body = _prometheus_text(self.batcher.stats()).encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _read_body(self) -> bytes:
        """Drain the request body unconditionally — under HTTP/1.1
        keep-alive a reply that leaves body bytes in the socket desyncs
        the persistent connection (the next request line parses from the
        middle of the stale body and 400s confusingly)."""
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n else b""

    def do_POST(self) -> None:  # noqa: N802
        # drain FIRST, before any routing decision, so every error path
        # (404, 501, 400) leaves the keep-alive stream clean
        raw = self._read_body()
        if self.path == "/reload":
            self._do_reload(raw)
            return
        if self.path != "/encode":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            req = json.loads(raw or b"{}")
            phonemes = req["phonemes"]
        except (ValueError, KeyError) as exc:
            self._reply(400, {"error": f"bad request: {exc!r}"})
            return
        single = isinstance(phonemes, str)
        texts = [phonemes] if single else list(phonemes)
        if not texts or not all(isinstance(t, str) and t for t in texts):
            self._reply(400, {"error": "phonemes must be a non-empty "
                                       "string or list of non-empty strings"})
            return
        nd = req.get("round")
        encoding = req.get("encoding")
        out_dtype = req.get("dtype", "float32")
        if encoding not in (None, "b64"):
            self._reply(400, {"error": f"unknown encoding {encoding!r} "
                                       "(supported: \"b64\")"})
            return
        if out_dtype not in ("float32", "float16"):
            self._reply(400, {"error": f"unknown dtype {out_dtype!r} "
                                       "(supported: float32, float16)"})
            return
        try:
            # submit all before collecting any — a list request batches
            # with itself (and with every other in-flight request)
            futures = [self.batcher.submit(t) for t in texts]
        except QueueFull as exc:
            # overload backpressure: tell the client to retry rather
            # than letting the queue (and tail latency) grow unbounded
            self.send_response(503)
            self.send_header("Retry-After", "1")
            body = json.dumps({"error": str(exc)}).encode("utf-8")
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        try:
            results = []
            for f in futures:
                hidden, length = f.result(timeout=self.request_timeout_s)
                if nd is not None:
                    hidden = np.round(hidden, int(nd))
                if encoding == "b64":
                    raw = np.ascontiguousarray(
                        hidden.astype(out_dtype, copy=False)
                    )
                    results.append({
                        "hidden_b64": base64.b64encode(raw.tobytes())
                        .decode("ascii"),
                        "dtype": out_dtype,
                        "shape": list(raw.shape),
                        "length": length,
                    })
                else:
                    results.append(
                        {"hidden": hidden.tolist(), "length": length}
                    )
        except Exception as exc:  # noqa: BLE001 — surfaced to the client
            self._reply(500, {"error": repr(exc)})
            return
        self._reply(200, results[0] if single else {"results": results})

    def _do_reload(self, raw: bytes) -> None:
        """POST /reload {"checkpoint": path} — zero-downtime weight
        rollout: loads the checkpoint on host, validates the tree shape,
        and atomically swaps it under every replica; in-flight batches
        finish on the old weights, no recompile, service never pauses.

        Hardening (the route loads and serves an arbitrary readable
        file): ``reload_token`` requires a matching X-Reload-Token
        header, ``reload_root`` rejects any checkpoint whose realpath
        escapes that directory — the CLI defaults the root to the
        serving checkpoint's parent (the run dir of step_N siblings)."""
        if type(self).load_params is None:
            self._reply(
                501, {"error": "reload not enabled for this server "
                               "(no checkpoint loader attached)"}
            )
            return
        cls = type(self)
        if cls.reload_token is not None and (
            self.headers.get("X-Reload-Token") != cls.reload_token
        ):
            self._reply(403, {"error": "missing or wrong X-Reload-Token"})
            return
        try:
            ckpt = json.loads(raw or b"{}")["checkpoint"]
        except (ValueError, KeyError) as exc:
            self._reply(400, {"error": f"bad request: {exc!r}"})
            return
        if cls.reload_root is not None:
            root = os.path.realpath(cls.reload_root)
            real = os.path.realpath(str(ckpt))
            if not (real == root or real.startswith(root + os.sep)):
                self._reply(
                    403, {"error": f"checkpoint outside the allowed "
                                   f"reload root {cls.reload_root!r}"}
                )
                return
        # serialize concurrent reloads: the load itself is the slow part
        # and interleaved swaps would make "which weights are live"
        # depend on thread timing
        with self.reload_lock:
            try:
                new_params = type(self).load_params(ckpt)
                self.batcher.swap_params(new_params)
            except (ValueError, FileNotFoundError) as exc:
                self._reply(400, {"error": str(exc)})
                return
            except Exception as exc:  # noqa: BLE001 — surfaced to client
                self._reply(500, {"error": repr(exc)})
                return
            self.model_info["checkpoint"] = ckpt  # /healthz shows it
        self._reply(200, {"ok": True, "checkpoint": ckpt})


def make_server(
    encoder,
    host: str = "127.0.0.1",
    port: int = 0,
    max_batch: int | None = None,
    max_wait_ms: float = 5.0,
    max_pending: int | None = None,
    pipeline_depth: int = 1,
) -> ThreadingHTTPServer:
    """Build (but do not start) the serving HTTP server.

    ``encoder`` is a ``PhonemeEncoder``; ``max_batch`` defaults to its
    fixed ``batch_size`` (required — a shape-per-request encoder would
    recompile under load, the exact footgun the fixed batch removes).
    The batcher inherits the encoder's ``seq_buckets`` so batch
    formation is bucket-aware whenever serving is length-bucketed, and
    ``max_pending`` (optional) bounds the queue — overload answers 503
    + Retry-After instead of queueing without bound.
    Returns a ``ThreadingHTTPServer`` with ``.batcher`` attached; call
    ``serve_forever()`` (or drive it from a thread in tests) and
    ``shutdown()`` + ``server.batcher.close()`` to stop.
    """
    if max_batch is None:
        if encoder.batch_size is None:
            raise ValueError(
                "encoder must be built with a fixed batch_size (or pass "
                "max_batch explicitly) so serving compiles exactly once"
            )
        max_batch = encoder.batch_size
    if encoder.batch_size is not None and max_batch > encoder.batch_size:
        raise ValueError(
            f"max_batch {max_batch} exceeds the encoder's fixed "
            f"batch_size {encoder.batch_size}"
        )
    batcher = DynamicBatcher(
        encoder, max_batch, max_wait_ms=max_wait_ms,
        seq_buckets=encoder.seq_buckets, max_pending=max_pending,
        pipeline_depth=pipeline_depth,
    )
    return _assemble_server(batcher, _model_info(encoder), host, port)


def _model_info(encoder) -> dict:
    return {
        "hidden_size": int(encoder.cfg.hidden_size),
        "max_seq_length": int(encoder.max_seq_length),
        "batch_size": encoder.batch_size,
        "seq_buckets": (
            list(encoder.seq_buckets) if encoder.seq_buckets else None
        ),
    }


def _assemble_server(batcher, model_info: dict, host, port):
    """``batcher`` is anything with the DynamicBatcher surface
    (submit/stats/close) — a single batcher or a serving/pool.py
    ReplicaPool."""

    class Handler(_Handler):
        pass

    Handler.batcher = batcher
    Handler.model_info = model_info
    Handler.reload_lock = threading.Lock()
    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher  # type: ignore[attr-defined]
    return server


def attach_reload(
    server: ThreadingHTTPServer,
    load_params,
    root: str | None = None,
    token: str | None = None,
) -> None:
    """Enable ``POST /reload`` on a built server. ``load_params`` maps a
    checkpoint path → encoder params host tree (e.g.
    ``PhonemeEncoder.checkpoint_encoder_params`` with the config bound);
    the route swaps the result onto the live batcher/pool.

    ``root`` restricts reloads to checkpoints under that directory
    (realpath-prefix check → 403 outside it); ``token`` additionally
    requires the ``X-Reload-Token`` header to match. Embedded/test use
    may leave both None (unrestricted); the serving CLI always sets a
    root."""
    handler = server.RequestHandlerClass
    handler.load_params = staticmethod(load_params)
    handler.reload_root = root
    handler.reload_token = token


def make_pool_server(
    pool,
    host: str = "127.0.0.1",
    port: int = 0,
) -> ThreadingHTTPServer:
    """HTTP server over a serving/pool.py ``ReplicaPool`` (model info
    for /healthz comes from the first replica's encoder)."""
    info = _model_info(pool.encoders[0])
    info["replicas"] = pool.replicas
    return _assemble_server(pool, info, host, port)


def serve_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    """Start ``serve_forever`` on a daemon thread (tests / embedding)."""
    t = threading.Thread(
        target=server.serve_forever, name="plbert-http", daemon=True
    )
    t.start()
    return t



def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve PL-BERT hidden states over HTTP with dynamic "
                    "batching (PyTorch/CUDA)"
    )
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint", help="reference .pth (training save or state dict)")
    src.add_argument("--hf_dir", help="directory written by pl_bert_tpu_torch.export")
    parser.add_argument("--config_path",
                        help="training config with --checkpoint (default: the "
                             "flagship shape); an --hf_dir carries its own")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--max_batch", type=int, default=64,
                        help="fixed batch = max requests coalesced per forward")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="max time a request waits for co-riders")
    parser.add_argument("--max_pending", type=int, default=None,
                        help="queue-depth bound; at capacity new requests "
                             "get 503 + Retry-After (default: unbounded)")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help=">1 overlaps batch N+1's forward with batch "
                             "N's device->host copy")
    parser.add_argument("--replicas", type=int, default=1,
                        help="serve N independent replicas, one per CUDA "
                             "device (0 = one per device)")
    parser.add_argument("--int8", action="store_true",
                        help="dynamic int8 dense projections (ops/quant.py)")
    parser.add_argument("--buckets", default="",
                        help="comma-separated sequence-length buckets, e.g. "
                             "64,128,256 — short requests run at short "
                             "padded lengths")
    parser.add_argument("--device", default="cuda",
                        help="torch device of a single replica (default "
                             "cuda; 'cpu' runs the plain path)")
    parser.add_argument("--reload_root", default=None,
                        help="directory POST /reload checkpoints must live "
                             "under (default: the parent directory of the "
                             "--checkpoint or --hf_dir served)")
    parser.add_argument("--reload_token", default=None,
                        help="shared secret: /reload then requires a "
                             "matching X-Reload-Token header")
    return parser


def _warm(encoder: PhonemeEncoder) -> None:
    """One forward per bucket shape before traffic: the first call also
    builds the kernels, so no request pays for that."""
    for bk in encoder.seq_buckets or (encoder.max_seq_length,):
        encoder(["a" * min(bk, encoder.max_seq_length)])


def build_server(argv=None):
    """Parse the CLI, load the encoder, warm every bucket and return the
    built (not yet serving) HTTP server with ``/reload`` attached."""
    parser = _parser()
    args = parser.parse_args(argv)
    enc = load_encoder(parser, args, args.max_batch)
    if args.replicas == 1:
        _warm(enc)
        server = make_server(
            enc, args.host, args.port, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, max_pending=args.max_pending,
            pipeline_depth=args.pipeline_depth,
        )
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n = len(devices) if args.replicas == 0 else args.replicas
        if n > len(devices):
            parser.error(f"--replicas {n} exceeds the {len(devices)} CUDA devices")
        pool = ReplicaPool.from_encoder(
            enc, devices[:n], max_wait_ms=args.max_wait_ms,
            max_pending=args.max_pending, pipeline_depth=args.pipeline_depth,
        )
        for replica in pool.encoders:
            _warm(replica)
        server = make_pool_server(pool, args.host, args.port)
    source = args.checkpoint or args.hf_dir
    attach_reload(
        server,
        PhonemeEncoder.hf_encoder_params if args.hf_dir
        else PhonemeEncoder.checkpoint_encoder_params,
        root=args.reload_root or os.path.dirname(os.path.realpath(source)),
        token=args.reload_token,
    )
    server.RequestHandlerClass.model_info["checkpoint"] = source
    server.banner = (  # type: ignore[attr-defined]
        f"serving on http://{args.host}:{server.server_address[1]} "
        f"(max_batch {args.max_batch}, max_wait {args.max_wait_ms} ms, "
        f"buckets {enc.seq_buckets}, replicas {args.replicas}, "
        f"device {enc.device}, quantize {enc.cfg.quantize})"
    )
    return server


def main(argv=None) -> None:
    import signal
    import sys

    server = build_server(argv)
    # graceful drain on SIGTERM: leave serve_forever the way Ctrl-C does,
    # so the finally block stops the listener and drains the batcher
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    print(server.banner, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.batcher.close()
        print("server drained and stopped", flush=True)


if __name__ == "__main__":
    main()
