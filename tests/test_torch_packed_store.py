"""The port's memory-mapped packed store against the JAX package's: the
same records give byte-identical stores, each package reads the other's
to the same batches (the per-epoch re-crop stream included), the pack
CLI writes JAX's ``main_pack`` store from ``records.jsonl`` and arrow
datasets, and the port's Trainer adopts a store — refusing one that does
not fit its config — and trains from it exactly as from the same corpus
in RAM. Small shapes: L 64, corpora of tens of records."""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pl_bert_tpu.config import Config as JaxConfig
from pl_bert_tpu.data import packed_store as jax_store
from pl_bert_tpu.preprocess.pipeline import main_pack as jax_main_pack
from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.data import packed_store as store_mod
from pl_bert_tpu_torch.data.packed import PackedPhonemeDataset, PackedSequenceDataset
from pl_bert_tpu_torch.preprocess import pipeline
from pl_bert_tpu_torch.preprocess.shard_engine import combine_and_save
from pl_bert_tpu_torch.training import train as port_train

L = 64
MODEL = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=L, num_hidden_layers=2, embedding_size=32)


def _corpus(n=60, seed=3, token_vocab=300):
    # 3-30 words of 2-9 phonemes: rows from a few phonemes to several
    # times L, so the rows kind keeps long streams to re-crop
    return port_train.make_synthetic_corpus(n, seed=seed, token_vocab=token_vocab,
                                            words_per_sample=(3, 30))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def _write(writer, records, out, **kw):
    mod = jax_store if writer == "jax" else store_mod
    return mod.write_packed_store(iter(records), str(out), max_seq_length=L, **kw)


def _open(reader, path, seed=1):
    mod = jax_store if reader == "jax" else store_mod
    return mod.open_packed_store(str(path), seed=seed)


def _same_batches(a, b, msg=""):
    assert set(a) == set(b), msg
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg}/{k}")


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("tokens", [True, False])
@pytest.mark.parametrize("sequence_packing", [False, True])
def test_store_bytes_equal_jax(tmp_path, sequence_packing, tokens, shards):
    corpus = _corpus(token_vocab=300 if tokens else 0)
    assert max(sum(len(w) + 1 for w in r["phonemes"]) for r in corpus) > 2 * L
    kw = dict(sequence_packing=sequence_packing, shard_rows=10_000 if shards == 1 else 20)
    ours = _write("port", corpus, tmp_path / "port", **kw)
    ref = _write("jax", corpus, tmp_path / "jax", **kw)
    assert _files(ours) == _files(ref)
    names = _files(ref)
    assert sum(n.startswith("shard_") and n.endswith("lengths.npy") for n in names) == shards
    for name in names:
        got = (Path(ours) / name).read_bytes()
        want = (Path(ref) / name).read_bytes()
        if name == store_mod.META_NAME:
            assert json.loads(got) == json.loads(want)
        assert got == want, name


@pytest.mark.parametrize("sequence_packing", [False, True])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_store(tmp_path, writer, sequence_packing):
    corpus = _corpus()
    path = _write(writer, corpus, tmp_path / "st", sequence_packing=sequence_packing,
                  shard_rows=25)
    ours, ref = _open("port", path, seed=5), _open("jax", path, seed=5)
    assert len(ours) == len(ref) and ours.has_tokens
    if not sequence_packing:
        assert ours.meta["num_long_rows"] > 0
    # epochs ascend: a reader keeps the latest epoch's crop windows
    for epoch in (0, 1, 2):
        got = list(ours.batches(8, epoch, seed=9))
        want = list(ref.batches(8, epoch, seed=9))
        assert len(got) == len(want) > 0
        for b1, b2 in zip(got, want):
            _same_batches(b1, b2, f"epoch {epoch}")


@pytest.mark.parametrize("sequence_packing", [False, True])
def test_one_shard_store_equals_the_in_ram_dataset(tmp_path, sequence_packing):
    corpus = _corpus()
    path = _write("port", corpus, tmp_path / "st", sequence_packing=sequence_packing)
    store = _open("port", path, seed=5)
    ref = (PackedSequenceDataset(corpus, L) if sequence_packing
           else PackedPhonemeDataset(corpus, L, seed=5))
    assert len(store) == len(ref)
    if sequence_packing:
        assert store.packing_efficiency == pytest.approx(ref.packing_efficiency, abs=1e-12)
    for epoch in (0, 1, 2):
        for b1, b2 in zip(store.batches(8, epoch, seed=2), ref.batches(8, epoch, seed=2)):
            _same_batches(b1, b2, f"epoch {epoch}")


def test_repack_over_an_existing_store_swaps_atomically(tmp_path):
    corpus = _corpus()
    out = str(tmp_path / "st")
    _write("port", corpus[:20], out)
    assert _open("port", out).meta["num_samples"] == 20
    _write("port", corpus, out)
    assert _open("port", out).meta["num_samples"] == len(corpus)
    assert not os.path.exists(out + ".replaced") and not os.path.exists(out + ".tmp")


@pytest.mark.parametrize("records,match", [
    ([{"phonemes": ["ab", "cd"], "token_ids": [1, 2]}] * 3
     + [{"phonemes": ["ab", "cd"], "token_ids": [1]}], "record 3"),
    ([], "empty"),
    ([{"phonemes": ["ab"], "token_ids": [5]}, {"phonemes": ["cd"]}], "inconsistent"),
])
def test_refused_records_raise_as_in_jax(tmp_path, records, match):
    for writer in ("port", "jax"):
        with pytest.raises(ValueError, match=match):
            _write(writer, records, tmp_path / writer)


def _jax_config():
    cfg = JaxConfig()
    return dataclasses.replace(cfg, dataset_params=dataclasses.replace(
        cfg.dataset_params, max_seq_length=L))


@pytest.mark.parametrize("fmt", ["records.jsonl", "arrow"])
def test_pack_cli_writes_jax_main_packs_store(tmp_path, fmt, capsys):
    corpus = _corpus(n=40, seed=5, token_vocab=120)
    for name in ("ours", "ref"):
        src = str(tmp_path / name / "phonemized")
        if fmt == "arrow":
            import datasets

            datasets.Dataset.from_list(corpus).save_to_disk(src)
        else:
            combine_and_save([corpus], src)
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump({"dataset_params": {"max_seq_length": L}}))
    pipeline.main(["--stage", "pack", "--dataset_path", str(tmp_path / "ours" / "phonemized"),
                   "--config_path", str(cfg_path)])
    printed = capsys.readouterr().out
    assert "pack_batch calls: native " in printed
    ours = tmp_path / "ours" / "phonemized.packed"
    ref = jax_main_pack(_jax_config(), str(tmp_path / "ref" / "phonemized"))
    assert _files(ours) == _files(ref)
    for name in _files(ref):
        assert (ours / name).read_bytes() == (Path(ref) / name).read_bytes(), name
    # the other stages run too; without their input they stop as JAX's
    # parser.error stops them
    with pytest.raises(SystemExit) as stop:
        pipeline.main(["--stage", "phonemize", "--config_path", str(cfg_path)])
    assert stop.value.code == 2
    assert "--stage phonemize requires --dataset_path" in capsys.readouterr().err


def _write_config(tmp_path, name="cfg.yml", model=None, dataset=None, **training):
    raw = {
        "training_params": {
            **dict(output_dir=str(tmp_path / "runs"), mixed_precision="fp32", batch_size=4,
                   save_interval=3, log_interval=1, num_steps=6, learning_rate=1e-3), **training},
        "dataset_params": {"max_seq_length": L, "ondevice_masking": True, **(dataset or {})},
        "model_params": dict(MODEL, **(model or {})),
    }
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("field,value,match", [
    ("ondevice_masking", False, "on-device masking"),
    ("sequence_packing", True, "kind"),
    ("max_seq_length", 32, "max_seq_length"),
    ("word_separator", 90, "token_separator"),
])
def test_trainer_refuses_a_store_that_does_not_fit(tmp_path, field, value, match):
    path = _write("port", _corpus(n=20), tmp_path / "st")
    cfg = Config.load(_write_config(tmp_path, dataset={field: value},
                                    training_dataset=path))
    with pytest.raises(ValueError, match=match):
        port_train.Trainer(cfg, str(tmp_path / "r"), resuming=False, device="cpu")


@pytest.mark.parametrize("vocab,tokens,match", [
    (87, 50, "word_separator"),  # above every raw id, at the separator's
    (100, 300, "token_ids go up to 29"),  # the store's recorded max
    (100, 0, "needs 'token_ids'"),
])
def test_trainer_holds_the_grapheme_head_to_the_store(tmp_path, vocab, tokens, match):
    path = _write("port", _corpus(n=20, token_vocab=tokens), tmp_path / "st")
    cfg = Config.load(_write_config(tmp_path, model={"num_token_vocab": vocab},
                                    training_dataset=path))
    with pytest.raises(ValueError, match=match):
        port_train.Trainer(cfg, str(tmp_path / "r"), resuming=False, device="cpu")


@pytest.mark.parametrize("sequence_packing", [False, True])
def test_trainer_from_a_store_equals_the_corpus_in_ram(tmp_path, sequence_packing, capsys):
    """20 records: 19 train rows make 4 batches an epoch, so 6 steps cross
    into epoch 2, whose long rows a rows store re-crops."""
    corpus = _corpus(n=20, token_vocab=100)
    path = _write("port", corpus, tmp_path / "st", sequence_packing=sequence_packing)
    dataset = {"sequence_packing": sequence_packing}
    model = {"num_token_vocab": 100}
    from_store = _write_config(tmp_path, "store.yml", model=model, dataset=dataset,
                               training_dataset=path)
    in_ram = _write_config(tmp_path, "ram.yml", model=model, dataset=dataset,
                           training_dataset="unused")
    assert port_train.load_training_dataset(path, "train").path == path
    assert port_train.train({"config_path": from_store, "run_name": "store",
                             "device": "cpu"}) == 6
    assert "memory-mapped packed store" in capsys.readouterr().out
    assert port_train.train({"config_path": in_ram, "run_name": "ram", "device": "cpu"},
                            dataset=corpus) == 6
    runs = tmp_path / "runs"
    records = [[json.loads(line) for line in open(runs / r / "metrics.jsonl")]
               for r in ("store", "ram")]
    drop = ("steps_per_sec", "tokens_per_sec", "time")
    assert [{k: v for k, v in r.items() if k not in drop} for r in records[0]] == [
        {k: v for k, v in r.items() if k not in drop} for r in records[1]]
    assert sum("loss" in r for r in records[0]) == 6
    a = torch.load(runs / "store" / "step_6.pth", weights_only=False)["net"]
    b = torch.load(runs / "ram" / "step_6.pth", weights_only=False)["net"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("layout", ["dataset", "dataset dict"])
def test_hf_save_to_disk_resolves_as_in_jax_and_scans_by_column(tmp_path, layout):
    """A ``save_to_disk`` directory resolves to the configured split of a
    DatasetDict, or to the dataset itself; its grapheme ids are scanned
    by column, and a row without any fails naming the row."""
    import datasets

    from pl_bert_tpu.training.train import load_training_dataset as jax_load

    corpus = _corpus(n=12, token_vocab=100)
    path = str(tmp_path / "hf")
    ds = datasets.Dataset.from_list(corpus)
    if layout == "dataset":
        ds.save_to_disk(path)
        want = corpus
    else:
        datasets.DatasetDict({"train": ds.select(range(8)),
                              "validation": ds.select(range(8, 12))}).save_to_disk(path)
        want = corpus[8:]
    got = port_train.load_training_dataset(path, "validation")
    assert [dict(r) for r in got] == [dict(r) for r in jax_load(path, "validation")] == want
    assert port_train._max_token_id(got) == max(max(r["token_ids"]) for r in want)
    holed = [dict(r) for r in want]
    holed[2]["token_ids"] = []
    datasets.Dataset.from_list(holed).save_to_disk(str(tmp_path / "holed"))
    with pytest.raises(ValueError, match="row 2 has none"):
        port_train._max_token_id(port_train.load_training_dataset(str(tmp_path / "holed"),
                                                                  "train"))
