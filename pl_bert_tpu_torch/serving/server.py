"""HTTP serving front-end over the PyTorch encoder.

The JAX package's server (``pl_bert_tpu/serving/server.py``) is reused
as it is — its handler, ``make_server``, ``attach_reload``,
``make_pool_server`` and ``serve_in_thread`` import no jax — with the
port's ``PhonemeEncoder`` behind it. The routes are the same
(``/encode``, ``/healthz``, ``/stats``, ``/metrics``, ``/reload``);
``/reload`` takes a reference ``.pth``.

Run::

    python -m pl_bert_tpu_torch.serving.server \\
        --checkpoint step_1000.pth --port 8787 --max_batch 64 \\
        --buckets 64,128,256
"""

from __future__ import annotations

import argparse
import os

import torch

from pl_bert_tpu.serving.server import (
    attach_reload,
    make_pool_server,
    make_server,
    serve_in_thread,
)
from pl_bert_tpu_torch.models.inference import PhonemeEncoder

__all__ = ["build_server", "main", "serve_in_thread"]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve PL-BERT hidden states over HTTP with dynamic "
                    "batching (PyTorch/CUDA)"
    )
    parser.add_argument("--checkpoint", required=True,
                        help="reference .pth (training save or state dict)")
    parser.add_argument("--config_path",
                        help="training config (default: the flagship shape)")
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
                        help="int8 dense projections (not yet ported: raises)")
    parser.add_argument("--buckets", default="",
                        help="comma-separated sequence-length buckets, e.g. "
                             "64,128,256 — short requests run at short "
                             "padded lengths")
    parser.add_argument("--device", default="cuda",
                        help="torch device of a single replica (default "
                             "cuda; 'cpu' runs the plain path)")
    parser.add_argument("--reload_root", default=None,
                        help="directory POST /reload checkpoints must live "
                             "under (default: the checkpoint's directory)")
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
    enc = PhonemeEncoder.from_checkpoint(
        args.checkpoint, args.config_path,
        batch_size=args.max_batch,
        quantize="int8" if args.int8 else None,
        seq_buckets=tuple(int(x) for x in args.buckets.split(",") if x) or None,
        device=args.device,
    )
    if args.replicas == 1:
        _warm(enc)
        server = make_server(
            enc, args.host, args.port, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, max_pending=args.max_pending,
            pipeline_depth=args.pipeline_depth,
        )
    else:
        from pl_bert_tpu.serving.pool import ReplicaPool

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
    attach_reload(
        server, PhonemeEncoder.checkpoint_encoder_params,
        root=args.reload_root or os.path.dirname(os.path.realpath(args.checkpoint)),
        token=args.reload_token,
    )
    server.RequestHandlerClass.model_info["checkpoint"] = args.checkpoint
    server.banner = (  # type: ignore[attr-defined]
        f"serving on http://{args.host}:{server.server_address[1]} "
        f"(max_batch {args.max_batch}, max_wait {args.max_wait_ms} ms, "
        f"buckets {enc.seq_buckets}, replicas {args.replicas}, "
        f"device {enc.device})"
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
