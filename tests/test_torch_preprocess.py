"""The port's preprocessing stages held byte for byte to JAX's
(``pl_bert_tpu_torch/preprocess/`` against ``pl_bert_tpu/preprocess/``).

- The CLI of each package (``pipeline.main``) on examples/end_to_end.sh's
  four-line Arabic corpus: ``clean``, ``phonemize`` and ``tokenize``
  (with ``--tokenizer_dir``), ``diacritize`` (no CATT checkout: the
  identity fall-back, then phonemize) and ``pack`` with the identity G2P;
  ``all`` and ``tokenize`` with ``g2p_backend: espeak`` through the ABI
  stub ``tests/espeak_stub/espeak_stub.c`` (built with gcc as
  tests/test_espeak_stub_ffi.py:33-37 builds it; ``PLBERT_ESPEAK_LIB``).
  Every file the stages write is compared.
- The shard engine: inline and forked give JAX's records, a missing
  shard is resumed beside a completed one, and a worker past its timeout
  is killed and its shard left missing, as JAX's engine does.
- ``phonemize_text``, ``separate_text_into_segments``, ``strip_stress``
  and ``diacritize_text`` on seeded strings; ``TruncatedTextDataset``'s
  crops; ``CattTashkeel`` and ``MantoqG2P`` raise JAX's errors without a
  checkout; ``EspeakBackend`` raises where no library is found.
"""

import os
import re
import subprocess
import time

import numpy as np
import pytest
import yaml

from pl_bert_tpu.data import dataset as jdataset
from pl_bert_tpu.preprocess import diacritize as jdia
from pl_bert_tpu.preprocess import phonemize as jphon
from pl_bert_tpu.preprocess import pipeline as jpipe
from pl_bert_tpu.preprocess import shard_engine as jeng
from pl_bert_tpu_torch.data import dataset
from pl_bert_tpu_torch.preprocess import diacritize as dia
from pl_bert_tpu_torch.preprocess import phonemize as phon
from pl_bert_tpu_torch.preprocess import pipeline as pipe
from pl_bert_tpu_torch.preprocess import shard_engine as eng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(REPO, "tests", "espeak_stub", "espeak_stub.c")


def _corpus() -> str:
    """The four lines examples/end_to_end.sh writes."""
    text = open(os.path.join(REPO, "examples", "end_to_end.sh"), encoding="utf-8").read()
    return re.search(r"corpus\.txt\" <<'TXT'\n(.*?)\nTXT\n", text, re.S).group(1) + "\n"


def _config(root, g2p: str) -> str:
    path = os.path.join(root, "config.yml")
    with open(path, "w") as f:
        yaml.safe_dump({"preprocess_params": {
            "num_shards": 2, "max_workers": 2, "max_try_count": 1, "timeout": 120,
            "preprocess_dir": os.path.join(root, "prep"), "cleaned_output_dir": "cleaned",
            "g2p_backend": g2p,
        }, "dataset_params": {"max_seq_length": 64}}, f)
    return path


def _files(root) -> dict:
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def _stages(main, root, g2p: str) -> None:
    """Each package's CLI over the corpus, as examples/end_to_end.sh runs it."""
    os.makedirs(root)
    corpus = os.path.join(root, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write(_corpus())
    cfg = ["--config_path", _config(root, g2p)]
    prep = os.path.join(root, "prep")
    tok = ["--tokenizer_dir", os.path.join(prep, "word_tokenizer")]
    if g2p == "identity":
        main(cfg + ["--stage", "clean", "--local_dataset_path", corpus])
        main(cfg + ["--stage", "phonemize", "--dataset_path", f"{prep}/cleaned"])
        main(cfg + ["--stage", "tokenize", "--dataset_path", f"{prep}/cleaned.phonemized"] + tok)
        main(cfg + ["--stage", "diacritize", "--dataset_path", f"{prep}/cleaned"])
        main(cfg + ["--stage", "pack", "--dataset_path", f"{prep}/cleaned.phonemized.tokenized"])
    else:
        main(cfg + ["--stage", "all", "--local_dataset_path", corpus])
        main(cfg + ["--stage", "tokenize", "--dataset_path",
                    f"{prep}/cleaned.diacritized.phonemized"] + tok)


@pytest.fixture(scope="module")
def stub_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("espeak_stub") / "libespeak-stub.so"
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", str(out), STUB], check=True)
    return str(out)


@pytest.mark.parametrize("g2p", ["identity", "espeak"])
def test_stage_outputs_equal_jax(tmp_path, monkeypatch, capsys, stub_lib, g2p):
    monkeypatch.setenv("PLBERT_ESPEAK_LIB", stub_lib)
    _stages(jpipe.main, str(tmp_path / "jax"), g2p)
    _stages(pipe.main, str(tmp_path / "port"), g2p)
    printed = capsys.readouterr().out
    assert "falling back to identity diacritizer" in printed
    ours, ref = _files(tmp_path / "port" / "prep"), _files(tmp_path / "jax" / "prep")
    assert sorted(ours) == sorted(ref)
    assert "word_tokenizer/tokenizer.json" in ours
    assert any(name.endswith("records.jsonl") and "diacritized.phonemized" in name
               for name in ours)
    for name in ref:
        assert ours[name] == ref[name], name
    if g2p == "espeak":  # the stub's phonemes: a stress mark before each word
        first = ours["cleaned.phonemized/records.jsonl"].decode().splitlines()[0]
        assert '"phonemes": ["ˈ' in first


def _records(n=23):
    rng = np.random.default_rng(3)
    words = ["كتب", "عام", "1986", "مدينة", "،", "hello", "وكان", "3", "."]
    return [{"id": str(i), "text": " ".join(rng.choice(words, rng.integers(1, 9)))}
            for i in range(n)]


@pytest.mark.parametrize("inline", [True, False], ids=["inline", "forked"])
def test_shard_engine_records_equal_jax(tmp_path, monkeypatch, inline):
    monkeypatch.setenv("PLBERT_INLINE_SHARDS", "1" if inline else "0")
    kw = dict(process_fn=pipe.standardize_text, max_workers=2, num_shards=5, max_try_count=1,
              hang_safe=True)
    out = eng.process_dataset(_records(), str(tmp_path / "port"), output_dir="out", **kw)
    kw["process_fn"] = jpipe.standardize_text
    ref = jeng.process_dataset(_records(), str(tmp_path / "jax"), output_dir="out", **kw)
    assert _files(out) == _files(ref) and len(_files(out)) == 1
    assert eng.get_existing_shards(str(tmp_path / "port")) == set()  # cleaned up


def _tag(record, tag):
    return {"text": f"{tag}:{record['text']}"}


def test_shard_engine_resumes_a_missing_shard(tmp_path):
    """Shard 1 completed by an earlier run (tagged 'old') is kept; the
    others are processed now (tagged 'new')."""
    for engine, root in ((eng, tmp_path / "port"), (jeng, tmp_path / "jax")):
        engine._worker(1, str(root), _records(), 4, _tag, "old")
        assert engine.get_existing_shards(str(root)) == {1}
        engine.process_dataset(_records(), str(root), _tag, "new", output_dir="out",
                               max_workers=2, num_shards=4, max_try_count=1)
    ours = _files(tmp_path / "port" / "out")["records.jsonl"]
    assert ours == _files(tmp_path / "jax" / "out")["records.jsonl"]
    assert ours.count(b"old:") == 6 and ours.count(b"new:") == 17


def _slow(record, _):
    if record["id"] == "0":
        time.sleep(60)
    return {"text": record["text"]}


def test_shard_engine_kills_a_worker_past_its_timeout(tmp_path, capsys):
    """The worker of shard 0 sleeps past a 1 s timeout: it is killed, its
    shard stays missing, the rest is saved and the completed shards are
    kept for a resume, the same partial output as JAX's."""
    for engine, root in ((eng, tmp_path / "port"), (jeng, tmp_path / "jax")):
        start = time.monotonic()
        engine.process_dataset(_records(), str(root), _slow, "x", output_dir="out",
                               max_workers=3, timeout=1, num_shards=3, max_try_count=1)
        assert time.monotonic() - start < 20
        assert engine.get_existing_shards(str(root)) == {1, 2}
    printed = capsys.readouterr().out
    assert printed.count("Shard 0 timed out after 1s; killing worker") == 2
    assert _files(tmp_path / "port" / "out") == _files(tmp_path / "jax" / "out")


def _strings(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    pool = list("كتبعامدينةوالحبقرء") + list("abcXYZ") + list("0123") + list(".,،؟!?") + [" "] * 6
    return ["".join(rng.choice(pool, rng.integers(0, 50))) for _ in range(n)]


def test_phonemize_and_diacritize_functions_equal_jax():
    for text in _strings(4, 300) + ["ا ، ، ب", "hi?!", "?!", ""]:
        tokens = text.split()
        assert phon.separate_text_into_segments(tokens) == jphon.separate_text_into_segments(
            tokens)
        assert phon.phonemize_text(text, phon.IdentityG2P()) == jphon.phonemize_text(
            text, jphon.IdentityG2P())
        assert phon.strip_stress("ˈa" + text) == jphon.strip_stress("ˈa" + text)
        assert dia.diacritize_text(text, dia.IdentityDiacritizer()) == jdia.diacritize_text(
            text, jdia.IdentityDiacritizer())
    assert phon.espeak_phoneme_mode(True) == jphon.espeak_phoneme_mode(True)


def test_truncated_text_dataset_equals_jax():
    records = [{"text": t * 30} for t in _strings(5, 40)]
    mine = dataset.TruncatedTextDataset(records, max_seq_length=64, seed=7)
    ref = jdataset.TruncatedTextDataset(records, max_seq_length=64, seed=7)
    assert [mine[i] for i in range(len(records))] == [ref[i] for i in range(len(records))]


def test_external_checkouts_never_resolve_outside_the_repository(tmp_path, monkeypatch):
    """The CATT and mantoq roots default to ``catt/`` and ``mantoq/`` in
    the repository (JAX's default, ``../../../catt``, is the directory
    that holds the checkout); ``PLBERT_CATT_DIR`` / ``PLBERT_MANTOQ_DIR``
    move them, and the shims raise naming the root they looked in."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for env, name, shim in (("PLBERT_CATT_DIR", "catt", dia.CattTashkeel),
                            ("PLBERT_MANTOQ_DIR", "mantoq", dia.MantoqG2P)):
        monkeypatch.delenv(env, raising=False)
        default = os.path.realpath(dia.checkout_path(None, env, name))
        assert default == os.path.join(os.path.realpath(repo), name)
        assert os.path.commonpath([default, os.path.realpath(repo)]) == os.path.realpath(repo)
        moved = str(tmp_path / f"no_{name}")
        monkeypatch.setenv(env, moved)
        assert dia.checkout_path(None, env, name) == moved
        assert dia.checkout_path("given", env, name) == "given"
        with pytest.raises(RuntimeError, match=f"not found at {moved}"):
            shim()


def test_external_shims_raise_jax_errors(tmp_path, monkeypatch):
    missing = str(tmp_path / "catt")
    for mine, ref in ((dia.CattTashkeel, jdia.CattTashkeel), (dia.MantoqG2P, jdia.MantoqG2P)):
        with pytest.raises(RuntimeError) as got:
            mine(missing)
        with pytest.raises(RuntimeError) as want:
            ref(missing)
        assert str(got.value) == str(want.value)
    monkeypatch.delenv("PLBERT_CATT_DIR", raising=False)
    with pytest.raises(RuntimeError, match="CATT checkout not found"):
        dia.CattTashkeel()  # no catt/ checkout in the repository
    monkeypatch.delenv("PLBERT_ESPEAK_LIB", raising=False)
    monkeypatch.setattr(phon.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="libespeak-ng not found"):
        phon.get_g2p_backend("espeak")
