"""The port's spans and operator counters on the CPU, at a tiny size (2
layers, hidden 128, L 64, batch 4, a grapheme vocabulary of 100): the
span helper, a packed multi-task Trainer run with accumulation 2 traced
through ``PLBERT_PROFILE_DIR`` (every span on its thread, inside its
parent, as often as the step and its micro-batches make it), names that
no reader of kernel names can take for a kernel, the training head's
fallbacks counted apart from validation's, and what ``metrics.jsonl``
carries: real tokens, the feed's wait and the head's fallbacks."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pl_bert_tpu_torch.data.collate import Batch
from pl_bert_tpu_torch.data.pipeline import Waits, prefetch
from pl_bert_tpu_torch.ops import masked_ce
from pl_bert_tpu_torch.training import profile as port_profile
from pl_bert_tpu_torch.training import train as port_train
from pl_bert_tpu_torch.training.metrics import MetricsLogger
from pl_bert_tpu_torch.utils.profiler import PREFIX, span

REPO = Path(__file__).resolve().parent.parent
MODEL = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
             num_token_vocab=100, attention_impl="pallas", dropout=0.1)
STEPS, START, TRACED, ACCUM, B, L = 5, 2, 2, 2, 4, 64
# the kernel-name keys a reader matches by substring: the roofline
# readers' own, the profiling CLI's groups', and the cuBLAS families'
KERNEL_KEYS = ("attention_fwd", "attention_bwd", "attention_bwd_delta", "gemm", "ln_fwd",
               "ln_bwd", "nvjet", "cutlass", "xmma", "sgemm", "add_copy")
STEP_CHILDREN = {"plbert.step.mask": ACCUM, "plbert.step.forward": ACCUM,
                 "plbert.step.backward": ACCUM, "plbert.step.optimizer": 1}


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """5 steps of a packed multi-task run (accumulation 2, capacity 8,
    where some micro-batches gather and some fall back), steps 3-4
    traced, a validation between steps 4 and 5; the host batches' real tokens as the feed put them, the
    Trainer's ``log_step`` calls, and each capacity decision of the head
    with whether validation made it."""
    tmp = tmp_path_factory.mktemp("spans")
    raw = {
        "training_params": dict(output_dir=str(tmp / "runs"), mixed_precision="fp32",
                                batch_size=B, save_interval=100, val_interval=4, log_interval=2,
                                num_steps=STEPS, learning_rate=1e-3, grad_accum_steps=ACCUM,
                                lm_head_capacity=8, training_dataset="synthetic:160:0:3-12"),
        "dataset_params": dict(max_seq_length=L, ondevice_masking=True, sequence_packing=True),
        "model_params": MODEL,
    }
    cfg = tmp / "cfg.yml"
    cfg.write_text(yaml.safe_dump(raw))
    fed, logged, decided = [], [], []
    put, log_step = port_train.Trainer._put, MetricsLogger.log_step
    validate, fits = port_train.Trainer.validate, masked_ce.fits_capacity
    validating = [False]

    def spy_put(self, batch, axis=0):
        if axis == 1:  # a training super-batch (validation puts along axis 0)
            fed.append(int(np.asarray(batch["lengths"]).sum()))
        return put(self, batch, axis)

    def spy_log(self, step, epoch, metrics, tokens_per_batch=0, **counters):
        logged.append((tokens_per_batch, counters))
        return log_step(self, step, epoch, metrics, tokens_per_batch, **counters)

    def spy_validate(self):
        validating[0] = True
        try:
            return validate(self)
        finally:
            validating[0] = False

    def spy_fits(valid, capacity, max_over=None):
        out = fits(valid, capacity, max_over)
        decided.append((out, validating[0]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLBERT_PROFILE_DIR", str(tmp / "trace"))
        mp.setenv("PLBERT_PROFILE_START", str(START))
        mp.setenv("PLBERT_PROFILE_STEPS", str(TRACED))
        mp.setattr(port_train.Trainer, "_put", spy_put)
        mp.setattr(MetricsLogger, "log_step", spy_log)
        mp.setattr(port_train.Trainer, "validate", spy_validate)
        mp.setattr(masked_ce, "fits_capacity", spy_fits)
        assert port_train.train({"config_path": str(cfg), "run_name": "run",
                                 "device": "cpu"}) == STEPS
    with open(tmp / "trace" / f"trace_step_{START}.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    with open(tmp / "runs" / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    return {"events": events, "fed": fed, "logged": logged, "records": records,
            "decided": decided}


def _named(events, name):
    return [e for e in events if e["name"] == name]


def test_span_is_a_shared_no_op_without_a_profiler():
    assert span("plbert.a") is span("plbert.b")
    with span("plbert.a") as inside:
        assert inside is None


def test_span_records_a_range_while_a_profiler_runs():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("plbert.test.outer"):
            torch.ones(4).sum()
    (outer,) = [e for e in prof.events() if e.name == "plbert.test.outer"]
    # a function-scope record: no user annotation, which would leave a
    # copy of itself among a card's events
    assert not outer.is_user_annotation
    assert any(e.name == "aten::sum" and e.time_range.start >= outer.time_range.start
               for e in prof.events())


def test_step_spans_nest_on_the_stepping_thread(traced_run):
    events = traced_run["events"]
    steps = _named(events, "plbert.step")
    assert len(steps) == TRACED
    tid = steps[0]["tid"]
    assert {e["tid"] for e in steps} == {tid}
    for name, per_step in STEP_CHILDREN.items():
        found = _named(events, name)
        assert len(found) == per_step * TRACED, name
        for step in steps:
            assert sum(_inside(e, step) for e in found) == per_step, name
    # the grapheme head's parts inside the forward, the capacity read
    # once a micro-batch
    forwards = _named(events, "plbert.step.forward")
    reads = _named(events, "lm_head.capacity_read")
    assert len(reads) == ACCUM * TRACED
    assert all(any(_inside(r, f) for f in forwards) for r in reads)
    # one wait for each traced step's batch, on the stepping thread
    waits = _named(events, "plbert.feed.wait")
    assert len(waits) == TRACED and {e["tid"] for e in waits} == {tid}


def test_feed_spans_are_the_prefetch_threads(traced_run):
    events = traced_run["events"]
    tid = _named(events, "plbert.step")[0]["tid"]
    batches = _named(events, "plbert.feed.batch")
    copies = _named(events, "plbert.feed.h2d")
    assert batches and copies
    assert tid not in {e["tid"] for e in batches}
    for copy in copies:
        assert sum(_inside(copy, b) for b in batches) == 1
    # a put a super-batch: every batch but one cut by the window's end
    assert len(copies) >= len(batches) - 1


def test_span_names_hold_no_kernel_key(traced_run):
    names = {e["name"] for e in traced_run["events"] if e["name"].startswith(PREFIX)}
    assert {"plbert.step", "plbert.feed.batch", "plbert.feed.h2d", "plbert.feed.wait",
            *STEP_CHILDREN} <= names
    readers = []
    for path in sorted((REPO / "port_bench" / "metrics").glob("*.py")):
        for node in ast.parse(path.read_text(encoding="utf-8")).body:
            if isinstance(node, ast.Assign) and node.targets[0].id == "KERNELS":
                readers += ast.literal_eval(node.value)
    assert readers
    keys = {*KERNEL_KEYS, *(key for key, _ in port_profile.GROUPS), *readers}
    assert not [(n, k) for n in names for k in keys if k in n]


def test_training_fallbacks_are_counted_apart_from_validation(traced_run):
    decided = traced_run["decided"]
    fell_in_training = sum(not fits for fits, validating in decided if not validating)
    # the validation between two training steps fell back too, and none
    # of it is logged
    first = next(i for i, (_, validating) in enumerate(decided) if not validating)
    assert any(not fits for fits, validating in decided[first:] if validating)
    logged = [c["lm_head_fallbacks"] for _, c in traced_run["logged"]]
    assert sum(logged) == fell_in_training
    steps = [r for r in traced_run["records"] if "loss" in r]
    assert sum(r["lm_head_fallbacks"] for r in steps) == fell_in_training


def test_trainer_counts_training_decisions_alone(traced_run):
    trained = [fits for fits, validating in traced_run["decided"] if not validating]
    # one decision a micro-batch, both ways taken in the run
    assert len(trained) == ACCUM * STEPS and set(trained) == {True, False}
    logged = [c["lm_head_fallbacks"] for _, c in traced_run["logged"]]
    assert logged == [sum(not f for f in trained[k:k + ACCUM])
                      for k in range(0, len(trained), ACCUM)]
    # a record every 2 steps, and the final partial window's
    steps = [r for r in traced_run["records"] if "loss" in r]
    assert [r["step"] for r in steps] == [2, 4, 5]
    assert [r["lm_head_fallbacks"] for r in steps] == [sum(logged[:2]), sum(logged[2:4]),
                                                       logged[4]]


def test_metrics_carry_real_tokens_and_the_feed_wait(traced_run):
    logged, fed = traced_run["logged"], traced_run["fed"]
    assert len(logged) == STEPS
    # each step's tokens are its host batch's lengths, not its row slots
    assert [t for t, _ in logged] == fed[:STEPS]
    assert all(0 < t < ACCUM * B * L for t, _ in logged)
    assert all(c["feed_wait_s"] >= 0 and c["lm_head_fallbacks"] >= 0 for _, c in logged)
    steps = [r for r in traced_run["records"] if "loss" in r]
    assert all(r["feed_wait_ms"] >= 0 for r in steps)
    # the full windows' records (a step later than the first) carry the rate
    assert "tokens_per_sec" in steps[1]


def test_logger_rate_is_the_tokens_it_is_given(tmp_path, monkeypatch):
    from types import SimpleNamespace

    from pl_bert_tpu_torch.training import metrics

    clock = iter([0.0, 1.0, 3.0])  # the logger's start, its records at steps 2 and 4
    monkeypatch.setattr(metrics, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    m = MetricsLogger(str(tmp_path), log_interval=2)
    for step, tokens, wait, fell in ((1, 100, 0.001, 0), (2, 200, 0.001, 0),
                                     (3, 300, 0.002, 1), (4, 500, 0.004, 0)):
        m.log_step(step, 1, {"loss": 1.0}, tokens, feed_wait_s=wait, lm_head_fallbacks=fell)
    m.close()
    record = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")][-1]
    assert record["step"] == 4
    assert record["tokens_per_sec"] == pytest.approx((300 + 500) / 2.0)
    assert record["feed_wait_ms"] == pytest.approx(3.0)
    assert record["lm_head_fallbacks"] == 1


def test_real_tokens_count_lengths():
    stacked = {"lengths": np.array([[64, 30, 0, 5], [0, 0, 0, 0]])}  # a ragged group's pad
    assert port_train.real_tokens(stacked) == 99
    batch = Batch(*(np.zeros((2, 4), np.int32) for _ in range(4)), lengths=np.array([3, 4]))
    assert port_train.real_tokens(batch) == 7


def test_prefetch_sums_its_consumers_waits():
    waits = Waits()
    assert list(prefetch(iter(range(5)), size=2, waits=waits)) == list(range(5))
    assert waits.seconds > 0


def test_packed_records_carry_the_flash_tile_share(traced_run):
    """Each record of the packed run carries the window's mean share of
    tile pairs the flash kernels walk on its rows, as the feed's host
    batches give it."""
    steps = [r for r in traced_run["records"] if "loss" in r]
    assert steps and all(0 < r["flash_tile_share"] <= 1 for r in steps)
