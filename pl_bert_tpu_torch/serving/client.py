"""Python client for the serving HTTP API.

A copy of ``pl_bert_tpu/serving/client.py`` (``ServingClient`` :57), so
the port imports nothing of the JAX package; it speaks to the port's
server (``serving/server.py``) and to JAX's alike. Stdlib only, so
downstream consumers (e.g. a StyleTTS
fine-tune loop reading contextual embeddings from a shared PL-BERT
server — the reference's consumption contract, reference:
README.md:40-47, but online instead of offline .npz files) don't
hand-roll JSON/HTTP:

    client = ServingClient("http://127.0.0.1:8787")
    hidden, length = client.encode("mrhba balʕalm")   # [length, H] fp32
    results = client.encode(["ab", "qlm"])            # list in, list out

Transport: one persistent HTTP/1.1 connection *per calling thread*
(``http.client`` is not thread-safe, so each thread keeps its own) —
a closed-loop consumer pays TCP connect once, not per request. The
connection transparently reopens if the server closed it.

Payload: ``encoding="b64"`` asks the server for base64-packed raw
values instead of JSON float lists (~5x fewer bytes, ~10x with
``dtype="float16"``) — decoded back to an ``np.ndarray`` here, so the
call signature is identical either way.

Overload (the server's 503 backpressure signal, see batcher.py) raises
:class:`ServerOverloaded` carrying ``retry_after_s`` so callers can
back off; other HTTP errors raise :class:`ServingError` with the
server's JSON error message.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
import urllib.parse

import numpy as np


class ServingError(RuntimeError):
    """Non-2xx response from the serving API (message = server error)."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ServerOverloaded(ServingError):
    """503 backpressure: the server's request queue is at capacity.
    Retry after ``retry_after_s`` (the Retry-After header, default 1)."""

    def __init__(self, message: str, retry_after_s: float) -> None:
        super().__init__(503, message)
        self.retry_after_s = retry_after_s


class ServingClient:
    def __init__(self, base_url: str, timeout_s: float = 60.0) -> None:
        u = urllib.parse.urlsplit(base_url if "//" in base_url
                                  else "http://" + base_url)
        if u.scheme != "http":
            raise ValueError(f"only http:// is supported, got {base_url!r}")
        self._netloc = u.netloc
        self.base_url = f"http://{u.netloc}"
        self.timeout_s = timeout_s
        self._local = threading.local()  # one persistent conn per thread

    # --- plumbing -----------------------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self._netloc, timeout=self.timeout_s
            )
            self._local.conn = conn
        return conn

    def close(self) -> None:
        """Close this thread's persistent connection (other threads'
        connections close when their thread-local is collected)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _request(self, path: str, payload: dict | None = None) -> dict:
        body = None if payload is None else json.dumps(payload).encode()
        method = "GET" if payload is None else "POST"
        headers = {} if body is None else {"Content-Type": "application/json"}
        conn = self._conn()
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
        except TimeoutError:
            # a slow server is NOT a dead connection: re-sending would
            # double-submit the POST (and double server load exactly when
            # it is overloaded) — surface the timeout to the caller
            conn.close()
            self._local.conn = None
            raise
        except (
            ConnectionError,
            http.client.BadStatusLine,
            http.client.NotConnected,
            http.client.CannotSendRequest,
            BrokenPipeError,
        ):
            # stale keep-alive (server restarted / idle-closed the
            # socket before any response bytes arrived): one reconnect,
            # then let a second failure surface
            conn.close()
            conn = self._conn()
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
        data = resp.read()  # always drain — keeps the connection reusable
        if 200 <= resp.status < 300:
            return json.loads(data)
        try:
            message = json.loads(data).get("error", "")
        except ValueError:
            message = data.decode("utf-8", "replace")
        if resp.status == 503:
            retry_after = float(resp.headers.get("Retry-After", 1) or 1)
            raise ServerOverloaded(message, retry_after)
        raise ServingError(resp.status, message)

    # --- API ----------------------------------------------------------------
    def encode(
        self,
        phonemes: str | list[str],
        round_decimals: int | None = None,
        encoding: str | None = None,
        dtype: str = "float32",
    ):
        """One phoneme string → ``(hidden [length, H], length)``; a list
        → a list of such tuples (the members batch together server-side).
        ``round_decimals`` shrinks the JSON payload; ``encoding="b64"``
        switches to the binary payload (``dtype="float16"`` halves it
        again — returned array keeps the wire dtype)."""
        payload: dict = {"phonemes": phonemes}
        if round_decimals is not None:
            payload["round"] = round_decimals
        if encoding is not None:
            payload["encoding"] = encoding
            payload["dtype"] = dtype
        body = self._request("/encode", payload)

        def unpack(r: dict):
            if "hidden_b64" in r:
                # .copy(): frombuffer views are read-only — both payload
                # paths must return equivalent writable arrays
                hidden = np.frombuffer(
                    base64.b64decode(r["hidden_b64"]), dtype=r["dtype"]
                ).reshape(r["shape"]).copy()
            else:
                hidden = np.asarray(r["hidden"], np.float32)
            return hidden, int(r["length"])

        if isinstance(phonemes, str):
            return unpack(body)
        return [unpack(r) for r in body["results"]]

    def healthz(self) -> dict:
        """Liveness + model shape (hidden_size, buckets, ...)."""
        return self._request("/healthz")

    def stats(self) -> dict:
        """Batching counters + latency percentiles (see batcher.stats)."""
        return self._request("/stats")

    def reload(self, checkpoint: str) -> dict:
        """Zero-downtime weight rollout (``POST /reload``); raises
        :class:`ServingError` if the server rejects the checkpoint."""
        return self._request("/reload", {"checkpoint": checkpoint})
