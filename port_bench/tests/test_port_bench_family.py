"""A model family is one file under ``port_bench/families/`` that a
configuration names: ``run.py``, ``sweep.py`` and ``spans.py`` reach
PL-BERT through that name alone, a new family is a new file, and the
``plbert`` family counts what ``cost.py`` counts."""

import ast
import json

import pytest

from port_bench import card, cost, run, spec
from port_bench.symbols import SEPARATOR_ID
from port_bench.tests.tiny import REPO, kernel_ln_stream, tiny_root

HERE = REPO / "port_bench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text(encoding="utf-8"))
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 977
INTERFACE = ("model", "corpus", "weights", "batches", "kept", "stats", "reference", "step_flops",
             "kernel_bound_s")
KERNELS = ("K3", "K4", "K5", "K6", "K7", "K8")
# the harness's modules that belong to PL-BERT, and the names of its data
PLBERT_MODULES = {"corpus", "feed", "weights", "reference", "symbols", "cost"}
PLBERT_NAMES = ("type_vocab_size", "word_pred_prob", "phoneme_mask_prob", "replace_prob",
                "SEPARATOR_ID", "token_ids")

# a family that hands every call to ``plbert`` and writes down which
RECORDED = '''"""PL-BERT's family, each call written down by name (a line of
``recorded.calls`` beside this file) and handed on."""

import functools
from pathlib import Path

from port_bench import spec

HERE = Path(__file__).resolve().parent
PLBERT = spec.family(HERE, "plbert")


def _recorded(name):
    inner = getattr(PLBERT, name)

    @functools.wraps(inner)
    def call(*args, **kwargs):
        with open(HERE / "recorded.calls", "a", encoding="utf-8") as log:
            log.write(name + "\\n")
        return inner(*args, **kwargs)

    return call


model = _recorded("model")
corpus = _recorded("corpus")
weights = _recorded("weights")
batches = _recorded("batches")
kept = _recorded("kept")
stats = _recorded("stats")
reference = _recorded("reference")
step_flops = _recorded("step_flops")
kernel_bound_s = _recorded("kernel_bound_s")
'''


def _set_family(root, name):
    path = root / "port_bench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text(encoding="utf-8"))
    if name is None:
        del cfg["family"]
    else:
        cfg["family"] = name
    path.write_text(json.dumps(cfg), encoding="utf-8")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_names_its_family(cell):
    c = spec.cell(REPO, cell)
    assert c["config"]["family"] == "plbert"
    assert all(callable(getattr(c["family"], name)) for name in INTERFACE)


def test_a_configuration_without_a_family_names_its_file(tmp_path):
    root = tiny_root(tmp_path, "train_packed")
    _set_family(root, None)
    with pytest.raises(ValueError, match="port_bench/configs/tiny.json"):
        spec.cell(root, "tiny")


@pytest.mark.parametrize("name", ["run.py", "sweep.py", "spans.py"])
def test_callers_reach_plbert_through_the_family_alone(name):
    source = (HERE / name).read_text(encoding="utf-8")
    imported = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module == "port_bench":
            imported |= {f"port_bench.{a.name}" for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    assert not [m for m in imported
                if m.startswith("port_bench.") and m.split(".")[1] in PLBERT_MODULES]
    assert not [n for n in PLBERT_NAMES if n in source]


def test_a_family_added_as_a_file(tmp_path, monkeypatch):
    """A configuration that names a new family file runs as the cell it
    was, every call going through that file; the harness's own files
    are the repo's, byte for byte."""
    kernel_ln_stream(monkeypatch)
    root = tiny_root(tmp_path, "mt_train_packed")
    families = root / "port_bench" / "families"
    (families / "recorded.py").write_text(RECORDED, encoding="utf-8")
    _set_family(root, "recorded")
    for name in ("port_bench/run.py", "port_bench/spec.py", "port_bench/families/plbert.py"):
        assert (root / name).read_bytes() == (REPO / name).read_bytes()

    log = families / "recorded.calls"
    result = run.run(root, "tiny", SEED, 0.2, trace=False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["checks"]["feed_arrays_differ"]["value"] == 0
    assert set(log.read_text(encoding="utf-8").split()) == set(INTERFACE) - {
        "step_flops", "kernel_bound_s"}
    # each reader counts work through the window's family: a window with
    # device time under every kernel name the readers look for
    cell = spec.cell(root, "tiny")
    s = {"tokens": 900, "slots": 1024, "seg_sq": 41_000.0, "masked": 120.0, "rows": 16}
    kernels = {"attention_fwd": 1e-3, "attention_bwd": 2e-3, "gemm_bias<": 1e-3,
               "gemm_bias_sm90<true>": 1e-3, "gemm_bias_sm90<false>": 1e-3, "ln_fwd": 1e-4,
               "ln_bwd": 2e-4}
    w = {"family": cell["family"], "model": cell["family"].model(cell), "step_ms": [10.0],
         "stats": [[s, s]], "trace": {"kernels": kernels, "stats": [[s, s]]}}
    plain = {**w, "family": spec.family(HERE / "families", "plbert")}
    for metric, counts in (("step_mfu", "step_flops"),
                           *((f"{k}_roofline", "kernel_bound_s") for k in KERNELS)):
        read = spec.reader(cell["metrics_dir"], metric)
        log.unlink()
        assert read(w) == read(plain) > 0, metric
        assert set(log.read_text(encoding="utf-8").split()) == {counts}, metric


@pytest.mark.parametrize("base", ["mt_train_packed", "train_full", "train_packed"])
def test_plbert_counts_what_cost_counts(tmp_path, base):
    """On a tiny cell's batches, the family's model dict, counts and work
    are the ones the harness worked out from ``cost.py`` before there
    were families, bit for bit."""
    cell = spec.cell(tiny_root(tmp_path, base), "tiny")
    family, cfg = cell["family"], cell["config"]
    data = cell["traffic"]["dataset_params"]
    model = {**cfg["model_params"], "type_vocab_size": cfg["type_vocab_size"]}
    share = data["word_pred_prob"] * (data["phoneme_mask_prob"] + data["replace_prob"])
    assert family.model(cell) == model
    batches = run.derived_batches(cell, family.corpus(cell, SEED), run.training_seed(SEED), 4)
    stats = [family.stats(cell, b) for b in batches]
    assert stats == [cost.batch_stats(b, SEPARATOR_ID, share) for b in batches]
    assert family.step_flops(model, stats) == cost.step_flops(model, stats)
    for kernel in KERNELS:
        assert ([family.kernel_bound_s(kernel, model, s) for s in stats]
                == [cost.kernel_bound_s(kernel, model, s) for s in stats])


@pytest.mark.parametrize("peak", ["PEAK_BF16", "PEAK_FP32", "PEAK_BYTES"])
def test_the_card_peaks_are_the_ones_plbert_counts_against(peak):
    assert getattr(card, peak) == getattr(cost, peak)


def test_plbert_keeps_the_grapheme_ids_where_its_configuration_has_words(tmp_path):
    """``kept`` reads the configuration alone: the multi-task model's
    batches keep their grapheme ids, the phoneme-only model's leave them."""
    arrays = {"phoneme_ids": 0, "token_ids": 0, "lengths": 0}
    for base, keys in (("mt_train_packed", ["phoneme_ids", "token_ids", "lengths"]),
                       ("train_packed", ["phoneme_ids", "lengths"])):
        cell = spec.cell(tiny_root(tmp_path / base, base), "tiny")
        assert cell["family"].kept(cell, arrays) == keys, base
