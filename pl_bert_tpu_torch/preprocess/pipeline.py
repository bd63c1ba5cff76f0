"""Corpus preprocessing CLI: the pack stage.

A copy of ``pl_bert_tpu/preprocess/pipeline.py``'s ``main_pack``
(:256-316) and of its CLI (:366-396), with the same arguments:

    python -m pl_bert_tpu_torch.preprocess.pipeline --stage pack \\
        --dataset_path prep/cleaned.phonemized [--config_path configs/config.yml]

packs a phonemised (optionally tokenized) dataset — a ``records.jsonl``
directory, or an arrow ``save_to_disk`` dataset through a lazy
``datasets`` import — into the memory-mapped training store
(``data/packed_store.py``) at ``<dataset_path>.packed``, and prints which
packer route packed it. The other stages (``clean``, ``phonemize``,
``tokenize``, ``diacritize``, ``all``) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import json
import os

from pl_bert_tpu_torch import runtime
from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.data.packed_store import META_NAME, write_packed_store
from pl_bert_tpu_torch.preprocess.shard_engine import iter_processed_dataset

STAGES = ("clean", "phonemize", "tokenize", "pack", "diacritize", "all")


def _iter_records(path: str):
    """Stream records from a ``records.jsonl`` stage output or an arrow
    ``save_to_disk`` dataset (the reference's format, reference:
    preprocess.py:364-371); both iterate lazily (arrow is memory-mapped),
    keeping the writer's RSS flat."""
    if os.path.exists(os.path.join(path, "records.jsonl")):
        return iter_processed_dataset(path)
    from datasets import load_from_disk

    ds = load_from_disk(path)
    if hasattr(ds, "keys") and not hasattr(ds, "features"):  # DatasetDict
        split = "train" if "train" in ds else next(iter(ds.keys()))
        ds = ds[split]
    return iter(ds)


def main_pack(
    config: Config,
    dataset_path: str,
    output_dir: str | None = None,
    shard_rows: int = 65536,
) -> str:
    """Pack a phonemized (optionally tokenized) dataset into the
    memory-mapped training store: the native packer runs once here
    instead of at every Trainer start, and training then reads the
    shards with bounded RSS."""
    dp = config.dataset_params
    if output_dir is None:
        output_dir = f"{os.path.basename(dataset_path)}.packed"
    if not os.path.isabs(output_dir):
        output_dir = os.path.join(
            os.path.dirname(dataset_path) or ".", output_dir
        )
    print(f"Packing {dataset_path} -> {output_dir} "
          f"(L={dp.max_seq_length}, sequence_packing={dp.sequence_packing})")
    native, numpy_route = runtime.NATIVE_PACKS.count, runtime.NUMPY_PACKS.count
    out = write_packed_store(
        _iter_records(dataset_path),
        output_dir,
        max_seq_length=dp.max_seq_length,
        token_separator=dp.word_separator,
        sequence_packing=dp.sequence_packing,
        shard_rows=shard_rows,
    )
    with open(os.path.join(out, META_NAME), encoding="utf-8") as f:
        meta = json.load(f)
    print(
        f"Packed store: {meta['num_rows']} rows / {meta['num_samples']} "
        f"samples, {len(meta['shards'])} shards, "
        f"{meta['num_long_rows']} long rows"
    )
    print(f"pack_batch calls: native {runtime.NATIVE_PACKS.count - native}, "
          f"numpy {runtime.NUMPY_PACKS.count - numpy_route}", flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="PL-BERT corpus preprocessing")
    parser.add_argument("--config_path", type=str, default="configs/config.yml")
    parser.add_argument("--local_dataset_path", type=str, default=None)
    parser.add_argument("--stage", choices=STAGES, default="all")
    parser.add_argument("--dataset_path", type=str, default=None,
                        help="input for phonemize/tokenize/pack/diacritize stages")
    parser.add_argument("--tokenizer_dir", type=str, default=None,
                        help="load (or save) the word tokenizer here "
                             "(tokenize stage)")
    args = parser.parse_args(argv)
    if args.stage != "pack":
        raise NotImplementedError(
            f"--stage {args.stage} is not yet ported to pl_bert_tpu_torch "
            "(only the pack stage is)")
    if not args.dataset_path:
        parser.error("--stage pack requires --dataset_path "
                     "(a phonemized dataset)")
    main_pack(Config.load(args.config_path), args.dataset_path)


if __name__ == "__main__":
    main()
