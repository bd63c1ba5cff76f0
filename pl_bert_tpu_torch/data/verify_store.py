"""Packed-store integrity verification (production data-plane ops).

A copy of ``pl_bert_tpu/data/verify_store.py`` (``verify_store`` :71,
``main`` :224): the same verdicts, messages and exit codes.

A packed store (data/packed_store.py) is written once and then feeds
every training run; a silently corrupted shard (truncated copy, bit
rot, a meta edited by hand) would surface as NaNs or quietly clamped
labels thousands of steps in. This tool makes the failure loud and
immediate — run it after copying a store between machines or before a
long production run::

    python -m pl_bert_tpu_torch.data.verify_store /path/to/store [--quick]

``--quick`` checks structure only (meta schema, shard presence, npy
headers, row counts); the full mode additionally streams every row and
validates value ranges: lengths within [0, L], phoneme label ids within
the 188-symbol table (reference contract: char_indexer semantics,
SURVEY §2.1), word ids ≥ -1, token ids matching the meta's recorded
``max_token_id`` (the bound ``Trainer`` trusts for its
fail-loudly-vs-take_along_axis vocab check), and long-stream offset
tables that are monotone and consistent.

Exit code 0 = verified; 1 = corruption, with the first failure's
location in the message.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from pl_bert_tpu_torch.data.packed_store import (
    FORMAT_VERSION,
    META_NAME,
    _NpyFile,
    _ROW_FIELDS,
    _SEQ_FIELDS,
)
from pl_bert_tpu_torch.text.symbols import NUM_SYMBOLS


class StoreCorruption(Exception):
    """A packed store failed verification; str(e) names the location."""


def _fail(msg: str) -> None:
    raise StoreCorruption(msg)


def _open_field(shard_dir: str, name: str, rows: int | None) -> _NpyFile:
    path = os.path.join(shard_dir, name + ".npy")
    if not os.path.exists(path):
        _fail(f"{shard_dir}: missing {name}.npy")
    expect = os.path.getsize(path)
    try:
        f = _NpyFile(path)
    except Exception as e:
        _fail(f"{path}: unreadable npy header ({e})")
    if rows is not None and f.shape[0] != rows:
        _fail(f"{path}: {f.shape[0]} rows != shard table's {rows}")
    need = f._start + int(np.prod(f.shape, dtype=np.int64)) * f.dtype.itemsize
    if expect < need:
        _fail(
            f"{path}: file is {expect} bytes but the header promises "
            f"{need} (truncated copy?)"
        )
    return f


def verify_store(path: str, quick: bool = False) -> dict:
    """Verify the store at ``path``; returns summary stats or raises
    :class:`StoreCorruption` at the first inconsistency."""
    meta_path = os.path.join(path, META_NAME)
    if not os.path.isfile(meta_path):
        _fail(f"{path}: no {META_NAME} — not a packed store")
    with open(meta_path, encoding="utf-8") as fh:
        meta = json.load(fh)
    if meta.get("format_version") != FORMAT_VERSION:
        _fail(
            f"{path}: format_version {meta.get('format_version')} != "
            f"supported {FORMAT_VERSION}"
        )
    kind = meta.get("kind")
    if kind not in ("rows", "packed_rows"):
        _fail(f"{path}: unknown kind {kind!r}")
    L = int(meta["max_seq_length"])
    has_tokens = bool(meta["has_tokens"])
    fields = list(_ROW_FIELDS if kind == "rows" else _SEQ_FIELDS)
    if has_tokens:
        fields.append("token_ids")

    rows_total = 0
    tokens_total = 0
    long_total = 0
    max_tid = -1
    for s in meta["shards"]:
        d = os.path.join(path, s["dir"])
        if not os.path.isdir(d):
            _fail(f"{path}: shard dir {s['dir']} missing")
        rows = int(s["rows"])
        handles = {n: _open_field(d, n, rows) for n in fields}
        for n, h in handles.items():
            want = (rows,) if n == "lengths" else (rows, L)
            if tuple(h.shape) != want:
                _fail(f"{d}/{n}.npy: shape {h.shape} != {want}")
        long_handles = {}
        if kind == "rows":
            long_names = ["long_rows", "long_offsets", "long_labels",
                          "long_words"] + (["long_tokens"] if has_tokens else [])
            long_handles = {n: _open_field(d, n, None) for n in long_names}
            k = long_handles["long_rows"].shape[0]
            if int(s["long_rows"]) != k:
                _fail(f"{d}: shard table says {s['long_rows']} long rows, "
                      f"long_rows.npy has {k}")
            if long_handles["long_offsets"].shape[0] != k + 1:
                _fail(f"{d}: long_offsets has "
                      f"{long_handles['long_offsets'].shape[0]} entries, "
                      f"expected {k + 1}")
        rows_total += rows
        long_total += int(s.get("long_rows", 0))

        if quick:
            tokens_total += int(s["tokens"])
            for h in list(handles.values()) + list(long_handles.values()):
                h.close()
            continue

        lengths = handles["lengths"].range(0, rows)
        if rows and (lengths.min() < 0 or lengths.max() > L):
            bad = int(np.flatnonzero((lengths < 0) | (lengths > L))[0])
            _fail(f"{d}: row {bad} length {int(lengths[bad])} outside [0, {L}]")
        tokens_total += int(lengths.sum())
        for i in range(rows):
            lab = handles["label_ids"].row(i)
            n = int(lengths[i])
            body = lab[:n]
            if n and (body.min() < 0 or body.max() >= NUM_SYMBOLS):
                _fail(f"{d}: row {i} phoneme label outside [0, {NUM_SYMBOLS})")
            w = handles["word_ids"].row(i)
            if w.min() < -1:
                _fail(f"{d}: row {i} word_id < -1")
            if has_tokens:
                t = handles["token_ids"].row(i)
                if n:
                    if t[:n].min() < 0:
                        _fail(f"{d}: row {i} negative token id")
                    # separator positions (word_id -1) carry the
                    # token_separator id, which the writer's recorded
                    # max (over RAW per-word ids) does not include —
                    # count word positions only
                    words = t[:n][w[:n] >= 0]
                    if words.size:
                        max_tid = max(max_tid, int(words.max()))
        if kind == "rows" and long_handles["long_rows"].shape[0]:
            k = long_handles["long_rows"].shape[0]
            lr = long_handles["long_rows"].range(0, k)
            off = long_handles["long_offsets"].range(0, k + 1)
            if lr.min() < 0 or lr.max() >= rows:
                _fail(f"{d}: long_rows index outside [0, {rows})")
            if np.any(np.diff(off) <= L):
                _fail(f"{d}: a long stream is not longer than L={L} — "
                      "long rows must exceed the crop window")
            if int(off[0]) != 0 or int(off[-1]) != long_handles["long_labels"].shape[0]:
                _fail(f"{d}: long_offsets ends at {int(off[-1])} but "
                      f"long_labels has {long_handles['long_labels'].shape[0]}")
            # the full char streams are what per-epoch re-crops actually
            # read — scan them too (and their tails hold token ids the
            # cropped rows never show, so the meta max check NEEDS them)
            total = long_handles["long_labels"].shape[0]
            for name in ("long_words", "long_tokens") if has_tokens else (
                "long_words",
            ):
                got_n = long_handles[name].shape[0]
                if got_n != total:  # e.g. a shard file swapped in a copy
                    _fail(f"{d}: {name}.npy has {got_n} entries, "
                          f"long_labels has {total}")
            ll = long_handles["long_labels"].range(0, total)
            if ll.min() < 0 or ll.max() >= NUM_SYMBOLS:
                _fail(f"{d}: long-stream phoneme label outside "
                      f"[0, {NUM_SYMBOLS})")
            lw = long_handles["long_words"].range(0, total)
            if lw.min() < -1:
                _fail(f"{d}: long-stream word_id < -1")
            if has_tokens:
                lt = long_handles["long_tokens"].range(0, total)
                if lt.min() < 0:
                    _fail(f"{d}: negative long-stream token id")
                words = lt[lw >= 0]  # same separator exclusion as rows
                if words.size:
                    max_tid = max(max_tid, int(words.max()))
        for h in list(handles.values()) + list(long_handles.values()):
            h.close()

    if rows_total != int(meta["num_rows"]):
        _fail(f"{path}: shards hold {rows_total} rows, meta says "
              f"{meta['num_rows']}")
    if long_total != int(meta.get("num_long_rows", 0)):
        _fail(f"{path}: shards hold {long_total} long rows, meta says "
              f"{meta.get('num_long_rows')}")
    if tokens_total != int(meta["total_tokens"]):
        _fail(f"{path}: counted {tokens_total} tokens, meta says "
              f"{meta['total_tokens']}")
    if not quick and has_tokens and max_tid > int(meta["max_token_id"]):
        # only the DANGEROUS direction fails: ids beyond what Trainer's
        # vocab check trusts would be silently clamped by the CE. The
        # reverse (recorded > scanned) is legitimate — an id may never
        # land at a scannable word position (zero-length words; rows a
        # packed layout crops).
        _fail(f"{path}: max token id in data is {max_tid}, meta records "
              f"{meta['max_token_id']} — Trainer's vocab check would be "
              "wrong")
    return {
        "kind": kind,
        "shards": len(meta["shards"]),
        "rows": rows_total,
        "long_rows": long_total,
        "tokens": tokens_total,
        "max_token_id": max_tid if has_tokens and not quick else None,
        "quick": quick,
    }


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("store", help="packed store directory")
    p.add_argument("--quick", action="store_true",
                   help="structure/header checks only (no full data scan)")
    a = p.parse_args(argv)
    try:
        stats = verify_store(a.store, quick=a.quick)
    except StoreCorruption as e:
        print(f"CORRUPT: {e}", file=sys.stderr)
        sys.exit(1)
    mode = "structure" if stats["quick"] else "full scan"
    print(f"OK ({mode}): {stats['rows']} rows / {stats['tokens']} tokens in "
          f"{stats['shards']} shards ({stats['long_rows']} long rows)")


if __name__ == "__main__":
    main()
