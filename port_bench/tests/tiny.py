"""A copy of the benchmark with one more cell, ``tiny``: a configuration
at CPU-test widths beside a cell of the benchmark, added as files and
entries only, as a later change adds one."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, base: str, precision: str = "fp32", dropout: float = 0.1) -> Path:
    """A checkout under ``tmp`` whose ``BENCHMARK.json`` adds cell
    ``tiny`` (configuration ``tiny``, traffic ``tiny``) shaped like cell
    ``base`` at hidden 128, 2 heads, FFN 256, 2 layers, L 64, B 8."""
    root = Path(tmp)
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text(encoding="utf-8"))
    cell = next(w for w in bench["workloads"] if w["name"] == base)
    cfg = json.loads((REPO / "port_bench" / "configs" / f"{cell['config']}.json").read_text(
        encoding="utf-8"))
    cfg["name"] = "tiny"
    cfg["model_params"].update(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                               num_hidden_layers=2, max_position_embeddings=64, dropout=dropout)
    if cfg["model_params"]["num_token_vocab"]:
        cfg["model_params"]["num_token_vocab"] = 500
        cfg["training_params"]["lm_head_capacity"] = 12
    cfg["training_params"]["mixed_precision"] = precision
    traffic = json.loads((REPO / "port_bench" / "traffic" / f"{cell['traffic']}.json").read_text(
        encoding="utf-8"))
    traffic["name"] = "tiny"
    traffic["training_params"]["batch_size"] = 8
    traffic["dataset_params"]["max_seq_length"] = 64
    corpus = traffic["corpus"]
    if "min_sample_phonemes" in corpus:
        corpus.update(min_sample_phonemes=80, samples=200)
    else:
        corpus.update(words_per_sample=[2, 5], samples=400)
        if corpus.get("token_vocab"):
            corpus["token_vocab"] = [5, 500]
    files = {"configs/tiny.json": cfg, "traffic/tiny.json": traffic,
             "limits/tiny.json": json.loads((REPO / "port_bench" / "limits" / f"{base}.json")
                                            .read_text(encoding="utf-8"))}
    for name, data in files.items():
        (root / "port_bench" / name).write_text(json.dumps(data, ensure_ascii=False),
                                                encoding="utf-8")
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2301.08810",
                             "file": "port_bench/configs/tiny.json", "reduced": [],
                             "why": "test widths"})
    bench["workloads"].append({"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1,
                               "why": f"{base} at test widths"})
    for metric in bench["per_layer"]:
        if base in metric.get("workloads", []):
            metric["workloads"].append("tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, ensure_ascii=False), encoding="utf-8")
    return root


def kernel_ln_stream(monkeypatch) -> None:
    """Make the program's plain LayerNorm dropout (its CPU path) draw the
    kernels' stream (``tl.rand``), so that a CPU run drops what a card
    run drops."""
    from pl_bert_tpu_torch.ops import fused_ln

    def keep(x, seed, rate, given):
        if seed is None or rate <= 0.0:
            return None
        return fused_ln.tl_rand_keep(int(seed), torch.arange(x.numel()), rate).reshape(x.shape)

    monkeypatch.setattr(fused_ln, "_plain_keep", keep)
