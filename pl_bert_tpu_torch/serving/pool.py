"""Replica-per-device serving pool.

A copy of ``pl_bert_tpu/serving/pool.py`` over the port's batcher, so the
port imports nothing of the JAX package. Devices are ``torch.device``s.

At ALBERT-base scale the model fits one chip with room to spare, so a
multi-chip host (a v5e board has 8) serves fastest as INDEPENDENT
replicas — one pinned encoder + one :class:`DynamicBatcher` per device
— not as one tensor-sharded model paying ICI hops on every token. The
reference has no serving at all (its export is consumed offline,
reference: README.md:36-119); this is the scale-out half of the online
path that serving/server.py is the front door for.

``ReplicaPool`` exposes the same ``submit/encode/stats/close`` surface
as a single ``DynamicBatcher``, so ``make_server`` (and the HTTP
handler) work unchanged — pass ``--replicas N`` to the server CLI.
Requests route to the replica with the fewest pending requests (ties →
round-robin), which keeps per-replica batches full under load while
spreading a trickle evenly.
"""

from __future__ import annotations

import itertools

from pl_bert_tpu_torch.serving.batcher import DynamicBatcher, QueueFull


class ReplicaPool:
    """N per-device batchers behind one submit() — see module docstring.

    Build via :meth:`from_encoder` (one pinned clone of a template
    ``PhonemeEncoder`` per device) or pass pre-built batchers.
    """

    def __init__(self, batchers: list[DynamicBatcher]) -> None:
        if not batchers:
            raise ValueError("ReplicaPool needs at least one batcher")
        self._batchers = list(batchers)
        # each replica's encoder (the batchers' encode_fn) — the HTTP
        # front-end reads model info off encoders[0]
        self.encoders = [b._encode_fn for b in self._batchers]
        self._rr = itertools.cycle(range(len(self._batchers)))

    @classmethod
    def from_encoder(
        cls,
        encoder,
        devices: list,
        max_wait_ms: float = 5.0,
        max_pending: int | None = None,
        pipeline_depth: int = 1,
    ) -> "ReplicaPool":
        """One pinned clone of ``encoder`` (a PhonemeEncoder built with
        a fixed ``batch_size``) per device, each behind its own
        batcher."""
        if encoder.batch_size is None:
            raise ValueError(
                "the template encoder needs a fixed batch_size"
            )
        batchers = []
        for dev in devices:
            enc = encoder.clone_to(dev)
            batchers.append(
                DynamicBatcher(
                    enc, enc.batch_size, max_wait_ms=max_wait_ms,
                    seq_buckets=enc.seq_buckets,
                    # split one global bound across replicas so total
                    # queued work stays bounded
                    max_pending=(
                        None if max_pending is None
                        else max(1, max_pending // len(devices))
                    ),
                    pipeline_depth=pipeline_depth,
                )
            )
        return cls(batchers)

    # --- DynamicBatcher-compatible surface ----------------------------------
    @property
    def replicas(self) -> int:
        return len(self._batchers)

    def _pick(self) -> DynamicBatcher:
        """Least-pending replica; round-robin breaks the (common,
        all-idle) tie so a trickle of singles still rotates devices."""
        start = next(self._rr)
        n = len(self._batchers)
        ordered = [self._batchers[(start + i) % n] for i in range(n)]
        return min(ordered, key=lambda b: b.pending)

    def submit(self, phoneme_string: str):
        last_exc: QueueFull | None = None
        # under backpressure, the picked replica may be full while a
        # sibling still has room — try each once before giving up
        for _ in range(len(self._batchers)):
            try:
                return self._pick().submit(phoneme_string)
            except QueueFull as exc:
                last_exc = exc
        raise last_exc  # every replica at capacity: genuine overload

    def encode(self, phoneme_string: str, timeout: float | None = None):
        return self.submit(phoneme_string).result(timeout=timeout)

    def swap_params(self, new_params: dict) -> None:
        """Roll ``new_params`` onto every replica (host tree loaded
        once; each replica device_puts to its own pinned device inside
        its encoder's swap). Validation happens per replica; the trees
        are identical clones, so the first either all-pass or all-fail."""
        for enc in self.encoders:
            enc.swap_params(new_params)

    def stats(self) -> dict:
        per = [b.stats() for b in self._batchers]
        agg = {
            k: sum(s[k] for s in per)
            for k in ("requests", "batches", "pending", "errors", "rejected")
        }
        total_items = sum(
            s["mean_batch_size"] * s["batches"] for s in per
        )
        agg["mean_batch_size"] = (
            total_items / agg["batches"] if agg["batches"] else 0.0
        )
        agg["max_batch_seen"] = max(s["max_batch_seen"] for s in per)
        lats = [s["latency_ms"] for s in per if "latency_ms" in s]
        if lats:
            # cross-replica percentile approximation: worst replica's
            # percentile (conservative; exact pooling would need the
            # raw samples)
            agg["latency_ms"] = {
                q: max(l[q] for l in lats) for q in ("p50", "p95", "max")
            }
        agg["replicas"] = len(per)
        agg["per_replica"] = per
        return agg

    def close(self, timeout: float = 10.0) -> None:
        for b in self._batchers:
            b.close(timeout=timeout)
