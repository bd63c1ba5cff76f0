"""The ``records.jsonl`` dataset format of the preprocessing stages.

A copy of the parts of ``pl_bert_tpu/preprocess/shard_engine.py`` that
the pack stage and the Trainer need: ``_save_records`` (:76),
``_load_records`` (:85), ``combine_and_save`` (:208),
``load_processed_dataset`` (:247) and ``iter_processed_dataset`` (:252).
A dataset is a directory holding ``records.jsonl``, one JSON object (a
``phonemes`` list of words, and optionally per-word ``token_ids``) a
line. The sharded map-with-retry engine that the other stages run on is
not ported yet.
"""

from __future__ import annotations

import json
import os


def _save_records(records: list[dict], directory: str) -> None:
    with open(os.path.join(directory, "records.jsonl"), "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


def _load_records(directory: str) -> list[dict]:
    path = os.path.join(directory, "records.jsonl")
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def combine_and_save(shards: list[list[dict]], output_path: str) -> int:
    """Save in-memory record lists as one ``records.jsonl`` dataset at
    ``output_path``; returns the record count."""
    records = [r for shard in shards for r in shard]
    os.makedirs(output_path, exist_ok=True)
    _save_records(records, output_path)
    return len(records)


def load_processed_dataset(path: str) -> list[dict]:
    """The records of a ``records.jsonl`` dataset directory."""
    return _load_records(path)


def iter_processed_dataset(path: str):
    """Stream a ``records.jsonl`` dataset one record at a time — constant
    memory regardless of corpus size (the pack stage uses this to keep
    the writer's RSS flat)."""
    with open(os.path.join(path, "records.jsonl"), encoding="utf-8") as f:
        for line in f:
            if line.strip():
                yield json.loads(line)
