"""Sharded map-with-retry engine for corpus preprocessing.

Same fault-tolerance contract as the reference's pebble-based engine
(reference: preprocess.py:168-373): the dataset splits into
``num_shards``; each shard is processed in its own worker process and
saved to ``shard_i/``; shard-directory existence is the completion
marker (idempotent resume); workers exceeding ``timeout`` seconds are
killed; up to ``max_try_count`` retry rounds with linearly growing
backoff; finally all shards concatenate into the output dataset and the
shard dirs are cleaned up.

Implementation differences (stdlib-only, kill-capable): a sliding
window of ``multiprocessing.Process`` workers instead of pebble's
ProcessPool — join(timeout) + terminate() gives the same
per-shard-timeout semantics without the dependency. Shards write to a
temp dir and rename, so a killed worker never leaves a half-written
completion marker (the reference can, if killed mid-save).

A copy of ``pl_bert_tpu/preprocess/shard_engine.py`` (1-340): the
engine, the inline mode, resume, ``cleanup_shards``,
``combine_shards_streaming`` and the ``records.jsonl`` format that the
pack stage and the Trainer read.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import re
import shutil
import time
from typing import Any, Callable, Iterable


_SHARD_RE = re.compile(r"^shard_(\d+)$")


def _shard_dir(root: str, i: int) -> str:
    return os.path.join(root, f"shard_{i}")


def get_existing_shards(root_directory: str) -> set[int]:
    existing = set()
    if os.path.isdir(root_directory):
        for name in os.listdir(root_directory):
            m = _SHARD_RE.match(name)
            if m:
                existing.add(int(m.group(1)))
    return existing


def _worker(
    i: int,
    root: str,
    dataset,
    num_shards: int,
    process_fn: Callable,
    process_args: Any,
) -> None:
    """Process one shard in a child process; atomic rename on success."""
    final = _shard_dir(root, i)
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)

    n = len(dataset)
    lo = (n * i) // num_shards
    hi = (n * (i + 1)) // num_shards
    out = []
    for j in range(lo, hi):
        record = dict(dataset[j])
        if process_args is not None:
            record.update(process_fn(record, process_args))
        else:
            record["text"] = process_fn(record["text"])
        out.append(record)

    os.makedirs(tmp, exist_ok=True)
    _save_records(out, tmp)
    os.rename(tmp, final)


def _save_records(records: list[dict], directory: str) -> None:
    import json

    with open(os.path.join(directory, "records.jsonl"), "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


def _load_records(directory: str) -> list[dict]:
    import json

    path = os.path.join(directory, "records.jsonl")
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def auto_inline(max_workers: int) -> bool:
    """Should a hang-safe stage skip worker processes? True when there
    is no parallelism to be had (one worker requested, or a one-core
    host, where fork+teardown per shard only SLOWS the stage — measured
    ~2× on a one-core host, BASELINE.md preprocess section). Overridable with
    PLBERT_INLINE_SHARDS=0/1."""
    env = os.environ.get("PLBERT_INLINE_SHARDS", "")
    if env in ("0", "1"):
        return env == "1"
    return max_workers <= 1 or (os.cpu_count() or 2) <= 1


def process_shards_inline(
    missing: list[int],
    root: str,
    dataset,
    num_shards: int,
    process_fn: Callable,
    process_args: Any = None,
) -> list[int]:
    """Sequential in-process variant of :func:`process_missing_shards`
    for HANG-SAFE stages (pure-Python clean/tokenize; never espeak):
    identical shard dirs, atomic renames, and resume semantics — minus
    the per-shard fork/teardown and the timeout kill (an exception
    fails just that shard; the retry loop above still applies)."""
    failed = []
    for i in missing:
        try:
            _worker(i, root, dataset, num_shards, process_fn, process_args)
        except Exception as e:  # noqa: BLE001 — shard-granular failure
            print(f"Error processing shard {i}: {e!r}")
            failed.append(i)
    done = get_existing_shards(root)
    return [i for i in missing if i not in done]


def process_missing_shards(
    missing: list[int],
    root: str,
    dataset,
    num_shards: int,
    max_workers: int,
    timeout: float,
    process_fn: Callable,
    process_args: Any = None,
) -> list[int]:
    """Run missing shards in a sliding window of worker processes; kill
    any worker exceeding ``timeout``. Returns shards still missing."""
    ctx = mp.get_context("fork")  # dataset/process_fn shared by fork, no pickling
    pending = list(missing)
    running: dict[int, tuple[mp.Process, float]] = {}
    failed: list[int] = []

    while pending or running:
        while pending and len(running) < max_workers:
            i = pending.pop()
            p = ctx.Process(
                target=_worker,
                args=(i, root, dataset, num_shards, process_fn, process_args),
                daemon=True,
            )
            p.start()
            running[i] = (p, time.monotonic())
        finished = []
        for i, (p, started) in running.items():
            p.join(timeout=0.02)
            if not p.is_alive():
                finished.append(i)
                if p.exitcode != 0:
                    print(f"Error processing shard {i}: exit {p.exitcode}")
                    failed.append(i)
            elif time.monotonic() - started > timeout:
                print(f"Shard {i} timed out after {timeout}s; killing worker")
                p.terminate()
                p.join(10)
                if p.is_alive():
                    # a worker wedged in native code can ignore SIGTERM;
                    # escalate so one stuck shard can't hang the engine
                    p.kill()
                    p.join()
                finished.append(i)
                failed.append(i)
        for i in finished:
            del running[i]

    done = get_existing_shards(root)
    return [i for i in missing if i not in done]


def load_all_shards(root: str) -> list[list[dict]]:
    """Load completed shards only — leftover shard_N.tmp dirs from killed
    workers are NOT shards (get_existing_shards agrees)."""
    shards = []
    for name in sorted(os.listdir(root)):
        if _SHARD_RE.match(name) and os.path.isdir(os.path.join(root, name)):
            try:
                shards.append(_load_records(os.path.join(root, name)))
            except (OSError, ValueError) as e:
                print(f"Error loading {name}: {e}")
    return shards


def cleanup_shards(root: str) -> int:
    count = 0
    for name in os.listdir(root):
        path = os.path.join(root, name)
        is_shard = _SHARD_RE.match(name) or (
            name.startswith("shard_") and name.endswith(".tmp")
        )
        if is_shard and os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            count += 1
    return count


def combine_and_save(shards: list[list[dict]], output_path: str) -> int:
    """Save in-memory record lists (small outputs, e.g. the diacritize
    sample). Shard-dir outputs go through :func:`combine_shards_streaming`
    instead — never materialize a full corpus as Python objects."""
    records = [r for shard in shards for r in shard]
    os.makedirs(output_path, exist_ok=True)
    _save_records(records, output_path)
    return len(records)


def combine_shards_streaming(root: str, output_path: str) -> int:
    """Concatenate completed shards' ``records.jsonl`` files line by line
    into ``output_path/records.jsonl`` (atomic rename) — constant memory
    at any corpus size. The reference gets the same out-of-core property
    from arrow ``concatenate_datasets`` (reference: preprocess.py:265-276).
    Shard order matches the previous in-memory combine (lexical dir-name
    sort), so combined corpus order is unchanged."""
    os.makedirs(output_path, exist_ok=True)
    final = os.path.join(output_path, "records.jsonl")
    tmp = final + ".tmp"
    total = 0
    with open(tmp, "w", encoding="utf-8") as out:
        for name in sorted(os.listdir(root)):
            if not (_SHARD_RE.match(name)
                    and os.path.isdir(os.path.join(root, name))):
                continue
            shard_file = os.path.join(root, name, "records.jsonl")
            try:
                with open(shard_file, encoding="utf-8") as f:
                    for line in f:
                        if line.strip():
                            out.write(line if line.endswith("\n") else line + "\n")
                            total += 1
            except OSError as e:
                print(f"Error loading {name}: {e}")
    os.replace(tmp, final)
    return total


def load_processed_dataset(path: str) -> list[dict]:
    """Load a dataset previously written by :func:`process_dataset`."""
    return _load_records(path)


def iter_processed_dataset(path: str):
    """Stream a dataset written by :func:`process_dataset` one record at
    a time — constant memory regardless of corpus size (the pack stage
    uses this to keep the writer's RSS flat)."""
    import json

    with open(os.path.join(path, "records.jsonl"), encoding="utf-8") as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


def process_dataset(
    dataset: Iterable[dict],
    root_directory: str,
    process_fn: Callable,
    process_args: Any = None,
    output_dir: str | None = None,
    max_workers: int = 4,
    timeout: float = 3600,
    max_try_count: int = 3,
    num_shards: int = 100,
    hang_safe: bool = False,
) -> str:
    """Shard → process (parallel, resumable, retried) → combine → save.

    ``hang_safe``: the stage cannot wedge in native code (pure-Python
    clean/tokenize, not espeak) — lets :func:`auto_inline` drop the
    worker processes where they only cost (single worker or one-core
    host)."""
    os.makedirs(root_directory, exist_ok=True)
    all_shards = list(range(num_shards))
    missing: list[int] = []
    inline = hang_safe and auto_inline(max_workers)
    if inline:
        print("shard engine: inline mode (hang-safe stage, no parallelism "
              "to gain from worker processes)")

    for attempt in range(1, max_try_count + 1):
        existing = get_existing_shards(root_directory)
        missing = [i for i in all_shards if i not in existing]
        if not missing:
            break
        print(f"Attempt {attempt}/{max_try_count}: {len(missing)} shards to process")
        if inline:
            missing = process_shards_inline(
                missing, root_directory, dataset, num_shards,
                process_fn, process_args,
            )
        else:
            missing = process_missing_shards(
                missing, root_directory, dataset, num_shards,
                max_workers, timeout, process_fn, process_args,
            )
        if not missing:
            break
        if attempt < max_try_count:
            wait = 10 * attempt
            print(f"{len(missing)} shards failed; retrying in {wait}s")
            time.sleep(wait)

    if missing:
        print(f"Warning: {len(missing)} shards failed after {max_try_count} attempts: {missing}")
    if len(missing) == num_shards:
        # reference refuses to save with zero successful shards
        # (reference: preprocess.py:281); an empty 'success' would let a
        # --stage all run silently process an empty corpus to completion
        raise RuntimeError(
            f"no shards were successfully processed in {root_directory} — "
            "nothing to save"
        )

    output_path = (
        os.path.join(root_directory, output_dir) if output_dir else root_directory
    )
    total = combine_shards_streaming(root_directory, output_path)
    print(f"Dataset saved to {output_path} ({total} samples)")
    if missing:
        # PARTIAL output: keep the completed shard dirs so a rerun
        # resumes exactly where this one gave up — cleaning up here
        # would destroy the resume state precisely when it's needed
        print(
            f"PARTIAL dataset ({len(missing)} shards missing); keeping "
            f"{num_shards - len(missing)} completed shard dirs for resume "
            "— rerun this stage to complete"
        )
    else:
        cleanup_shards(root_directory)
    return output_path
