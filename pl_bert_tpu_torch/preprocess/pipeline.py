"""Corpus preprocessing CLI: clean → phonemize → diacritize, tokenize, pack.

A copy of ``pl_bert_tpu/preprocess/pipeline.py`` (:39-253 the clean,
phonemize and tokenize stages; :256-316 the pack stage; :318-408 the
diacritize stage and the CLI), with the same arguments:

    python -m pl_bert_tpu_torch.preprocess.pipeline --config_path \\
        configs/config.yml [--stage clean|phonemize|tokenize|pack|diacritize|all] \\
        [--local_dataset_path corpus.txt] [--dataset_path DIR] [--tokenizer_dir DIR]

Source corpora load from a local ``.txt`` file (one article per line), a
``records.jsonl`` directory of an earlier stage, a local
``save_to_disk`` dataset or the HF hub (both through a lazy ``datasets``
import). Each stage writes a ``records.jsonl`` directory beside its
input, byte for byte JAX's; ``--stage pack`` packs a phonemized
(optionally tokenized) dataset into the memory-mapped training store
(``data/packed_store.py``) at ``<dataset_path>.packed`` and prints which
packer route packed it (the one line JAX does not print). The stages run
on the host: the shard engine forks its workers, so nothing here touches
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from pl_bert_tpu_torch import runtime
from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.data.packed_store import META_NAME, write_packed_store
from pl_bert_tpu_torch.preprocess.diacritize import (
    CattTashkeel,
    IdentityDiacritizer,
    diacritize_text,
)
from pl_bert_tpu_torch.preprocess.phonemize import get_g2p_backend, phonemize_text
from pl_bert_tpu_torch.preprocess.shard_engine import (
    iter_processed_dataset,
    load_processed_dataset,
    process_dataset,
)
from pl_bert_tpu_torch.text.normalize import (
    clean_text,
    convert_numbers_to_arabic_words,
    filter_non_arabic_words,
    remove_diacritics,
)

STAGES = ("clean", "phonemize", "tokenize", "pack", "diacritize", "all")


def standardize_text(text: str) -> str:
    """Arabic clean stage: numbers → words, Arabic-only filter, unicode
    cleanup (reference: preprocess.py:18-30)."""
    text = convert_numbers_to_arabic_words(text)
    text = filter_non_arabic_words(text)
    return clean_text(text)


def standardize_text_english(text: str) -> str:
    """English clean stage (clean_language: en): the converter-registry
    router verbalizes number-shaped tokens (cardinals, decimals, times,
    dates, ordinals, fractions, URLs — the reference router's exact
    shape set), then the same unicode cleanup. Upstream PL-BERT's
    language; the reference carries this router as DEAD code
    (text_normalize.py:282 NameError) — here it works
    (normalize.py::normalize_text). No script filter: English corpora
    keep their punctuation and casing for the phonemizer."""
    from pl_bert_tpu_torch.text.normalize import normalize_text

    return clean_text(normalize_text(text))


def load_source_dataset(cfg, local_path: str | None = None):
    if local_path:
        if os.path.isdir(local_path):
            jsonl = os.path.join(local_path, "records.jsonl")
            if os.path.exists(jsonl):
                return load_processed_dataset(local_path)
            from datasets import load_from_disk

            return load_from_disk(local_path)
        if local_path.endswith(".txt"):
            with open(local_path, encoding="utf-8") as f:
                return [
                    {"id": str(i), "text": line.rstrip("\n")}
                    for i, line in enumerate(f)
                ]
        raise ValueError(f"unsupported local dataset: {local_path}")
    from datasets import load_dataset

    return load_dataset(
        cfg.hf_dataset_name, cfg.hf_dataset_split, trust_remote_code=True
    )["train"]


def _stage_shard_root(base: str, output_name: str) -> str:
    """Stage-private shard directory. Every stage sharding into the same
    directory would let an interrupted run's shard_N dirs from ONE stage
    be adopted as completed shards by a DIFFERENT stage on resume
    (wrong records silently concatenated into the output)."""
    return os.path.join(base, f".shards_{os.path.basename(output_name)}")


def _finish_stage(shard_root: str) -> None:
    try:
        os.rmdir(shard_root)  # only succeeds when cleanup emptied it
    except OSError:
        pass


def main_clean(config: Config, local_dataset_path: str | None = None) -> str:
    pp = config.preprocess_params
    dataset = load_source_dataset(pp, local_dataset_path)
    print(f"Cleaning {len(dataset)} samples ({pp.clean_language})")
    clean_fn = (
        standardize_text_english
        if pp.clean_language == "en"
        else standardize_text
    )
    shard_root = _stage_shard_root(pp.preprocess_dir, pp.cleaned_output_dir)
    out = process_dataset(
        dataset=dataset,
        root_directory=shard_root,
        process_fn=clean_fn,
        output_dir=os.path.abspath(
            os.path.join(pp.preprocess_dir, pp.cleaned_output_dir)
        ),
        max_workers=pp.max_workers,
        timeout=pp.timeout,
        max_try_count=pp.max_try_count,
        num_shards=pp.num_shards,
        hang_safe=True,  # pure-Python normalization cannot wedge
    )
    _finish_stage(shard_root)
    return out


def _phonemize_record(record: dict, backend) -> dict:
    return {"phonemes": phonemize_text(record["text"], backend)}


def main_phonemize(
    config: Config, dataset_path: str, output_dir: str | None = None
) -> str:
    pp = config.preprocess_params
    dataset = load_processed_dataset(dataset_path)
    backend = get_g2p_backend(
        pp.g2p_backend, language=pp.phonemizer_language, with_stress=pp.with_stress
    )
    if output_dir is None:
        output_dir = f"{os.path.basename(dataset_path)}.phonemized"
    print(f"Phonemizing {len(dataset)} samples via {pp.g2p_backend}")
    base = os.path.dirname(dataset_path) or "."
    if not os.path.isabs(output_dir):
        output_dir = os.path.join(base, output_dir)
    shard_root = _stage_shard_root(base, output_dir)
    out = process_dataset(
        dataset=dataset,
        root_directory=shard_root,
        process_fn=_phonemize_record,
        process_args=backend,
        output_dir=os.path.abspath(output_dir),
        max_workers=min(pp.max_workers, 4),
        # espeak is the slowest stage: honor a LARGER configured timeout
        # but never shrink below the hour that real espeak shards need
        timeout=max(pp.timeout, 3600),
        max_try_count=pp.max_try_count,
        num_shards=min(pp.num_shards, 100),
    )
    _finish_stage(shard_root)
    return out


def _tokenize_record(record: dict, tokenizer) -> dict:
    ids = tokenizer.encode(record["text"])
    n = len(record["phonemes"]) if "phonemes" in record else len(ids)
    if len(ids) == n:
        # 1:1 positional pairing with the phonemes column (phonemize_text
        # emits one entry per words-and-punctuation token when the G2P
        # backend is word-preserving)
        return {"token_ids": ids, "token_alignment": "exact"}
    # the backend merged/split words somewhere (espeak on digit runs):
    # every pairing after the divergence point would be wrong, and the
    # divergence point is unrecoverable here — label the whole record
    # [UNK] rather than train the grapheme head on misaligned words
    return {
        "token_ids": [tokenizer.unk_token_id] * n,
        "token_alignment": "mismatch",
    }


def main_tokenize(
    config: Config,
    dataset_path: str,
    output_dir: str | None = None,
    tokenizer_dir: str | None = None,
) -> str:
    """Attach per-word grapheme ``token_ids`` to a phonemized dataset —
    the multi-task variant's data column. The reference's dataset reader
    expects ``data[idx]['token_ids']`` (reference: dataloader.py:39-44)
    but nothing in the reference repo produces it (the upstream notebook
    did); this stage closes that gap: it builds (or loads) the 60k word
    tokenizer (reference: tokenizer.py:13-68) over the dataset's cleaned
    text and aligns ids with the ``phonemes`` column through the same
    words-and-punctuation split the phonemize stage used.
    """
    from pl_bert_tpu_torch.text.word_tokenizer import (
        WordTokenizer, create_word_tokenizer,
    )

    pp = config.preprocess_params
    dataset = load_processed_dataset(dataset_path)
    if output_dir is None:
        output_dir = f"{os.path.basename(dataset_path)}.tokenized"

    if tokenizer_dir and os.path.exists(
        os.path.join(tokenizer_dir, "tokenizer.json")
    ):
        tokenizer = WordTokenizer.load(tokenizer_dir)
        print(f"Loaded tokenizer ({tokenizer.vocab_size} words)")
    else:
        save_to = tokenizer_dir or os.path.join(
            os.path.dirname(dataset_path) or ".", "word_tokenizer"
        )
        tokenizer = create_word_tokenizer(
            (r["text"] for r in dataset), output_dir=save_to,
            # vocab over the SAME tokens encode() later looks up — the
            # mode is persisted with the tokenizer
            split_mode="words_and_punctuation",
        )
        print(
            f"Built tokenizer ({tokenizer.vocab_size} words) -> {save_to}"
        )

    print(f"Tokenizing {len(dataset)} samples")
    base = os.path.dirname(dataset_path) or "."
    if not os.path.isabs(output_dir):
        output_dir = os.path.join(base, output_dir)
    shard_root = _stage_shard_root(base, output_dir)
    out = process_dataset(
        dataset=dataset,
        root_directory=shard_root,
        process_fn=_tokenize_record,
        process_args=tokenizer,
        output_dir=output_dir,
        max_workers=pp.max_workers,
        timeout=pp.timeout,
        max_try_count=pp.max_try_count,
        num_shards=min(pp.num_shards, 100),
        hang_safe=True,  # pure-Python word tokenizer cannot wedge
    )
    _finish_stage(shard_root)
    # stream: counting mismatches must not re-materialize the corpus
    mismatched = sum(
        1 for r in iter_processed_dataset(out)
        if r.get("token_alignment") == "mismatch"
    )
    if mismatched:
        print(
            f"WARNING: {mismatched} records had G2P word-count drift and "
            "were labeled [UNK] (token_alignment='mismatch')"
        )
    return out


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


def main_diacritize(
    config: Config,
    dataset_path: str,
    output_dir: str | None = None,
    sample_size: int = 200_000,
    diacritizer=None,
    seed: int = 0,
) -> str:
    """Sample, sentence-aware-crop, strip and restore tashkeel
    (reference: preprocess.py:459-534)."""
    from pl_bert_tpu_torch.data.dataset import TruncatedTextDataset
    from pl_bert_tpu_torch.preprocess.shard_engine import combine_and_save

    dataset = load_processed_dataset(dataset_path)
    truncated = TruncatedTextDataset(dataset, max_seq_length=512, seed=seed)
    n = len(truncated)
    if n > sample_size:
        indices = np.random.Generator(np.random.Philox(seed)).choice(
            n, size=sample_size, replace=False
        )
    else:
        indices = np.arange(n)

    if diacritizer is None:
        try:
            diacritizer = CattTashkeel()
        except RuntimeError as e:
            print(f"[diacritize] {e}; falling back to identity diacritizer")
            diacritizer = IdentityDiacritizer()

    records = []
    for idx in indices:
        record = truncated[int(idx)]
        original = record["text"]
        record["original_text"] = original
        record["text"] = diacritize_text(remove_diacritics(original), diacritizer)
        records.append(record)

    if output_dir is None:
        output_dir = f"{os.path.basename(dataset_path)}.diacritized"
    output_path = os.path.join(os.path.dirname(dataset_path) or ".", output_dir)
    combine_and_save([records], output_path)
    print(f"Diacritized dataset saved to {output_path} ({len(records)} samples)")
    return output_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="PL-BERT corpus preprocessing")
    parser.add_argument("--config_path", type=str, default="configs/config.yml")
    parser.add_argument("--local_dataset_path", type=str, default=None)
    parser.add_argument(
        "--stage",
        choices=STAGES,
        default="all",
    )
    parser.add_argument("--dataset_path", type=str, default=None,
                        help="input for phonemize/tokenize/pack/diacritize stages")
    parser.add_argument("--tokenizer_dir", type=str, default=None,
                        help="load (or save) the word tokenizer here "
                             "(tokenize stage)")
    args = parser.parse_args(argv)
    config = Config.load(args.config_path)

    if args.stage in ("clean", "all"):
        cleaned = main_clean(config, args.local_dataset_path)
    else:
        cleaned = args.dataset_path
    if args.stage in ("phonemize", "all"):
        if not cleaned:
            parser.error("--stage phonemize requires --dataset_path "
                         "(a cleaned dataset)")
        main_phonemize(config, cleaned)
    if args.stage == "tokenize":
        # multi-task data column; input = a PHONEMIZED dataset
        if not cleaned:
            parser.error("--stage tokenize requires --dataset_path "
                         "(a phonemized dataset)")
        main_tokenize(config, cleaned, tokenizer_dir=args.tokenizer_dir)
    if args.stage == "pack":
        # memory-mapped training store; input = a phonemized (optionally
        # tokenized) dataset
        if not cleaned:
            parser.error("--stage pack requires --dataset_path "
                         "(a phonemized dataset)")
        main_pack(config, cleaned)
    if args.stage in ("diacritize", "all"):
        if not cleaned:
            parser.error("--stage diacritize requires --dataset_path "
                         "(a cleaned dataset)")
        diacritized = main_diacritize(config, cleaned)
        main_phonemize(config, diacritized)


if __name__ == "__main__":
    main()
