"""The port's ``verify_store`` against the JAX package's on JAX's
corruption catalog (tests/test_verify_store.py): each healthy or
damaged store gets the same verdict, the same message and, through the
CLI, the same exit code and output from both packages."""

import json
import os

import numpy as np
import pytest

from pl_bert_tpu.data import verify_store as jax_verify
from pl_bert_tpu_torch.data import verify_store as port_verify
from pl_bert_tpu_torch.data.packed_store import write_packed_store
from pl_bert_tpu_torch.training.train import make_synthetic_corpus


def _meta(store):
    with open(os.path.join(store, "packed_meta.json")) as f:
        return json.load(f)


def _edit_meta(store, edit):
    meta = _meta(store)
    edit(meta)
    with open(os.path.join(store, "packed_meta.json"), "w") as f:
        json.dump(meta, f)


def _edit_array(path, edit):
    arr = np.load(path)
    np.save(path, edit(arr))


def _set(arr, index, value):
    arr[index] = value
    return arr


def _truncate(path, nbytes):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - nbytes)


def _store(tmp_path, kind="rows"):
    if kind == "long_tail":
        # the global max token id only in the tail of a long sample
        records = [{"phonemes": ["ab"] * 100, "token_ids": [1] * 99 + [299]}] + [
            {"phonemes": ["cd"] * 5, "token_ids": [2] * 5} for _ in range(10)]
        return write_packed_store(iter(records), str(tmp_path / "lt"),
                                  max_seq_length=128, shard_rows=50)
    if kind == "packed_rows":
        corpus = make_synthetic_corpus(80, seed=4, token_vocab=300)
        return write_packed_store(iter(corpus), str(tmp_path / "sp"), max_seq_length=256,
                                  sequence_packing=True, shard_rows=60)
    if kind == "small_vocab":
        corpus = make_synthetic_corpus(40, seed=7, token_vocab=50)
        return write_packed_store(iter(corpus), str(tmp_path / "sv"), max_seq_length=128,
                                  shard_rows=20)
    corpus = make_synthetic_corpus(120, seed=3, token_vocab=300)
    return write_packed_store(iter(corpus), str(tmp_path / "st"), max_seq_length=128,
                              shard_rows=50)


def _shard(store, i, name):
    return os.path.join(store, f"shard_{i:05d}", name + ".npy")


# name → (store kind, damage, quick, expected failure or None)
CATALOG = {
    "healthy": ("rows", None, False, None),
    "healthy quick": ("rows", None, True, None),
    "healthy sequence store": ("packed_rows", None, False, None),
    "small vocabulary below the separator": ("small_vocab", None, False, None),
    "healthy long tail": ("long_tail", None, False, None),
    "truncated shard file": (
        "rows", lambda s: _truncate(_shard(s, 1, "label_ids"), 1024), True, "truncated"),
    "missing field": ("rows", lambda s: os.remove(_shard(s, 2, "word_ids")), True,
                      "missing word_ids"),
    "row count drift": (
        "rows", lambda s: _edit_meta(s, lambda m: m["shards"][0].update(
            rows=m["shards"][0]["rows"] + 1)), True, "rows"),
    "out-of-range label": (
        "rows", lambda s: _edit_array(_shard(s, 0, "label_ids"),
                                      lambda a: _set(a, (7, 0), 4096)), False, "phoneme label"),
    "out-of-range label, quick": (
        "rows", lambda s: _edit_array(_shard(s, 0, "label_ids"),
                                      lambda a: _set(a, (7, 0), 4096)), True, None),
    "token max drift": (
        "rows", lambda s: _edit_meta(s, lambda m: m.update(max_token_id=m["max_token_id"] - 5)),
        False, "max token id"),
    "total token drift": (
        "rows", lambda s: _edit_meta(s, lambda m: m.update(total_tokens=m["total_tokens"] - 3)),
        False, "tokens"),
    "swapped long stream file": (
        "long_tail", lambda s: _edit_array(_shard(s, 0, "long_words"), lambda a: a[:-10]),
        False, "long_words"),
    "corrupt long stream": (
        "long_tail", lambda s: _edit_array(_shard(s, 0, "long_labels"),
                                           lambda a: _set(a, -1, 9999)),
        False, "long-stream phoneme"),
    "not a store": ("rows", lambda s: os.remove(os.path.join(s, "packed_meta.json")), True,
                    "not a packed store"),
}


def _verdict(mod, store, quick):
    try:
        return "ok", mod.verify_store(store, quick=quick)
    except mod.StoreCorruption as e:
        return "corrupt", str(e)


def _cli(mod, store, quick, capsys):
    try:
        mod.main([store] + (["--quick"] if quick else []))
        rc = 0
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", list(CATALOG))
def test_same_verdict_as_jax(tmp_path, case, capsys):
    kind, damage, quick, failure = CATALOG[case]
    store = _store(tmp_path, kind)
    if damage is not None:
        damage(store)
    got = _verdict(port_verify, store, quick)
    assert got == _verdict(jax_verify, store, quick)
    if failure is None:
        assert got[0] == "ok" and got[1]["rows"] > 0 and got[1]["quick"] == quick
    else:
        assert got[0] == "corrupt" and failure in got[1], got
    rc, out, err = _cli(port_verify, store, quick, capsys)
    assert (rc, out, err) == _cli(jax_verify, store, quick, capsys)
    assert rc == (0 if failure is None else 1)
    assert out.startswith("OK (") if failure is None else err.startswith("CORRUPT: ")
