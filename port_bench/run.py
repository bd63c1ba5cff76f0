"""One run of one cell of the port's benchmark::

    python3 -m port_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the program's ``Trainer`` (``pl_bert_tpu_torch``'s
``training/train.py``) on the cell's configuration and a corpus made
from the seed, loads weights made on the card from the seed, and drives
its training step through the Trainer's own feed: the first steps are
the ones the reference follows, the next ones warm up. The window then
steps for ``--seconds`` as the Trainer's loop does (the prefetched,
pinned feed, the step, the loss logging), timing the whole window on
the host clock and each step with CUDA events; ``--trace 1`` records the
window's first steps with ``torch.profiler`` and reports the per-layer
metrics instead of the end-to-end ones. Then the program's state is
freed and the reference follows the first steps from the same weights
on the batches it derives itself; the numbers of ``compare.py`` against
``limits/<workload>.json`` decide ``correct``. The last line of
standard output is the result.

What belongs to the model's architecture (the corpus, the weights, the
batches' derivation and counts, the reference, the work counts) comes
from the model family that the configuration names
(``families/<family>.py``; its interface is ``spec.py``'s).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# modules that must not be loaded in the process that prints a result,
# compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pl_bert_tpu")
# steps run after the compared ones and before the window
WARMUP_STEPS = 2
# steps of the window that a traced run records
TRACE_STEPS = 10


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Loop:
    """The Trainer's loop body on the Trainer's own feed: its batches
    (grouped into ``grad_accum_steps`` micro-batches), put on the card
    by its prefetch thread, then its step and its loss logging. Keeps
    each batch's counts, the first ``keep`` batches whole, and each
    step's feed wait (host clock), CUDA events and loss. The cell's
    family picks the arrays kept and counts each batch."""

    def __init__(self, trainer, keep: int, cell: dict) -> None:
        from pl_bert_tpu_torch.data.pipeline import prefetch
        from pl_bert_tpu_torch.training.train_step import batch_to_arrays

        self.trainer, self.keep = trainer, keep
        self._prefetch, self._to_arrays = prefetch, batch_to_arrays
        self.cell, self.family = cell, cell["family"]
        self.epoch, self._feed = 1, None
        self.kept: list = []
        self.stats: list = []
        self._taken = 0
        self.steps: list = []

    def _record(self, it):
        keys = None
        for b in it:
            arrays = b if isinstance(b, dict) else self._to_arrays(b)
            if keys is None:
                keys = self.family.kept(self.cell, arrays)
            arrays = {k: arrays[k] for k in keys}
            if len(self.kept) < self.keep:
                self.kept.append({k: v.copy() for k, v in arrays.items()})
            self.stats.append(self.family.stats(self.cell, arrays))
            yield b

    def _open(self) -> None:
        t = self.trainer
        it = self._record(t._train_batches(epoch=self.epoch, start_batch=0))
        accum = t.config.training_params.grad_accum_steps
        if accum > 1:
            feed = ((t._put(b, axis=1), c) for b, c in t._group_micro(it, accum))
        else:
            feed = ((t._put(b), 1) for b in it)
        self._feed = self._prefetch(feed, size=2)

    def _next(self):
        while True:
            if self._feed is None:
                self._open()
            try:
                return next(self._feed)
            except StopIteration:
                self._feed = None
                self.epoch += 1

    def step(self) -> dict:
        import torch
        from torch.profiler import record_function

        t = self.trainer
        t0 = time.perf_counter()
        with record_function("port_bench.feed_wait"):
            batch, consumed = self._next()
        wait = time.perf_counter() - t0
        start, end = (torch.cuda.Event(enable_timing=True) if t.device.type == "cuda"
                      else None for _ in range(2))
        if start is not None:
            start.record()
        with record_function("port_bench.step"):
            t.state, metrics = t.train_step(t.state, batch)
        if end is not None:
            end.record()
        t.current_step += 1
        stats = self.stats[self._taken:self._taken + consumed]
        self._taken += consumed
        with record_function("port_bench.log_step"):
            tp = t.config.training_params
            t.metrics.log_step(t.current_step, self.epoch, metrics,
                               tp.batch_size * t.config.dataset_params.max_seq_length * consumed)
        self.steps.append({"wait_s": wait, "events": (start, end), "stats": stats,
                           "loss": metrics["loss"]})
        return metrics

    def close(self) -> None:
        if self._feed is not None:
            self._feed.close()
            self._feed = None


def _program_config(cell: dict, seed: int):
    from pl_bert_tpu_torch.config import Config

    sections = ("preprocess_params", "training_params", "dataset_params", "model_params")
    merged = {s: {**cell["config"].get(s, {}), **cell["traffic"].get(s, {})} for s in sections}
    merged["training_params"]["seed"] = seed
    return Config.from_dict(merged)


def training_seed(seed: int) -> int:
    """The program's ``training_params.seed`` for a run seed: below 2³¹,
    so that the step's generator seed ``seed·2³² + step`` fits 64 bits."""
    return 1 + int(seed) % (2**31 - 2)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _quantile(values: list, q: float) -> float:
    """The ``q`` quantile by nearest rank."""
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, max(0, math.ceil(q * len(ordered)) - 1))]


def derived_batches(cell: dict, corpus: list, seed: int, n_batches: int) -> list:
    """The first ``n_batches`` training batches, as the cell's family
    works them out."""
    return cell["family"].batches(cell, corpus, seed, n_batches)


def follow(cell: dict, weights: dict, batches: list, seed: int, rounding: str = "fp32"):
    """The reference (or, with ``rounding``, the control) through the
    compared steps: {"losses", "grads" (first step), "params"}."""
    import torch

    accum = cell["config"]["training_params"]["grad_accum_steps"]
    steps = len(batches) // accum
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = cell["family"].reference(cell, weights, rounding)
        losses, grads = [], None
        for k in range(steps):
            losses.append(ref.step(batches[k * accum:(k + 1) * accum], k, seed))
            if grads is None:
                grads = {n: g.clone() for n, g in ref.grads().items()}
        params = {n: p.detach().clone() for n, p in ref.params.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"losses": losses, "grads": grads, "params": params}


def start(root: Path, workload: str, seed: int, device: str = "cuda", hook=None) -> dict:
    """Set-up up to the window: the cell's Trainer on a corpus and weights
    made from ``seed``, driven through the steps the reference follows.
    ``hook(trainer)`` (``faults.py``: the harness's tests and the sweep)
    may break the timed path underneath."""
    from port_bench import spec

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    cell = spec.cell(root, workload)
    family = cell["family"]
    n_compared = int(cell["limits"]["steps"])
    tp_seed = training_seed(seed)
    config = _program_config(cell, tp_seed)
    accum = config.training_params.grad_accum_steps

    from pl_bert_tpu_torch.training.train import Trainer

    corpus = family.corpus(cell, seed)
    logs = tempfile.TemporaryDirectory(prefix="port_bench-")
    trainer = Trainer(config, logs.name, resuming=False, dataset=corpus, device=device)
    weights = family.weights(cell, seed, trainer.device)
    trainer.model.load_state_dict(weights, strict=True)
    if hook is not None:
        hook(trainer)
    loop = Loop(trainer, n_compared * accum, cell)
    b1 = config.training_params.adam_b1
    prog = {"losses": []}
    for k in range(n_compared):
        prog["losses"].append(loop.step()["loss"])
        if k == 0:  # the first gradient, from the optimizer's first moment
            prog["grads"] = {n: mu.detach() / (1 - b1)
                             for n, (mu, _) in trainer.state.opt_state.moments.items()}
    prog["params"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    return {"cell": cell, "seed": seed, "tp_seed": tp_seed, "corpus": corpus, "logs": logs,
            "trainer": trainer, "loop": loop, "weights": weights, "prog": prog,
            "n_compared": n_compared, "accum": accum}


def release(st: dict) -> None:
    """Free the program's state (its feed thread stopped), so that the
    reference runs on a card that holds only what it needs."""
    import torch

    st["loop"].close()
    st["kept"] = st["loop"].kept
    st["prog"]["losses"] = [float(v) for v in st["prog"]["losses"]]
    cuda = st["trainer"].device.type == "cuda"
    st["loop"] = st["trainer"] = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    st["logs"].cleanup()


def judge(st: dict) -> tuple[dict, dict]:
    """The numbers of ``compare.py`` for a released set-up: the feed's
    batches against the family's derivation, the program's steps against
    the reference's; → (numbers, the reference's readings)."""
    from port_bench import compare

    batches = derived_batches(st["cell"], st["corpus"], st["tp_seed"],
                              st["n_compared"] * st["accum"])
    kept = st["kept"]
    differ = abs(len(kept) - len(batches))
    for k, d in zip(kept, batches):
        differ += len(set(k) ^ set(d)) + sum(not np.array_equal(k[n], d[n])
                                             for n in set(k) & set(d))
    ref = follow(st["cell"], st["weights"], batches, st["tp_seed"])
    numbers = compare.gaps(st["prog"], ref, st["weights"])
    numbers["feed_arrays_differ"] = differ
    return numbers, ref


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None, hook=None) -> dict:
    """One run of ``workload``: set-up, the window, the per-layer or the
    end-to-end metrics, then the reference's judgement; → the result."""
    import torch

    from port_bench import compare, spec, trace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    st = start(root, workload, seed, device, hook)
    cell, loop = st["cell"], st["loop"]
    for _ in range(WARMUP_STEPS):
        loop.step()
    cuda = st["trainer"].device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s ({st['n_compared'] + WARMUP_STEPS} steps)")

    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    first = len(loop.steps)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    traced = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or len(loop.steps) == first:
        loop.step()
        if prof is not None and not traced and len(loop.steps) - first == TRACE_STEPS:
            if cuda:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            traced = TRACE_STEPS
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if prof is not None and not traced:
        prof.__exit__(None, None, None)
        traced = len(loop.steps) - first
    window = loop.steps[first:]
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    losses = torch.stack([s["loss"].float().reshape(()) for s in window]).cpu()
    step_ms = [s["events"][0].elapsed_time(s["events"][1]) for s in window] if cuda else []
    w = {"family": cell["family"], "model": cell["family"].model(cell), "steps": len(window),
         "window_s": window_s, "step_ms": step_ms,
         "feed_wait_s": [s["wait_s"] for s in window], "stats": [s["stats"] for s in window],
         "peak_bytes": peak_window, "trace": None}
    result = {"correct": False, "attempted": len(window),
              "failed": int((~torch.isfinite(losses)).sum()), "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": max(peak_setup, peak_window)}}
    if step_ms:
        _log(f"window: {len(window)} steps in {window_s:.3f} s; a step (CUDA events) median "
             f"{_quantile(step_ms, 0.5):.3f} ms, p90 {_quantile(step_ms, 0.9):.3f} ms")
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if trace:
        t_read = time.perf_counter()
        w["trace"] = tr.reduce(prof.events())
        w["trace"]["steps"] = traced
        w["trace"]["stats"] = w["stats"][:traced]
        prof = None
        for m in cell["per_layer"]:
            value = spec.reader(cell["metrics_dir"], m["name"])(w)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": units[m["name"]]}
        result["device"]["busy_s"] = w["trace"]["busy_s"]
        result["device"]["window_s"] = w["trace"]["window_s"]
        result["breakdown"] = {"device_ops": tr.top(w["trace"]["kernels"]),
                               "idle_gaps": tr.top(w["trace"]["gaps"])}
        _log(f"trace of {traced} steps read in {time.perf_counter() - t_read:.1f} s")
    else:
        result["metrics"]["real_tokens_per_s"] = {"value": tokens_per_s(w),
                                                  "unit": units["real_tokens_per_s"]}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}

    release(st)
    t_ref = time.perf_counter()
    numbers, ref = judge(st)
    result["correct"], result["checks"] = compare.verdict(numbers, cell["limits"]["limits"])
    _log(f"reference: {st['n_compared']} steps in {time.perf_counter() - t_ref:.1f} s; losses "
         f"program {st['prog']['losses']} reference {ref['losses']}; worst leaves "
         f"{numbers['leaves']}")
    return result


def tokens_per_s(w: dict) -> float:
    """Real (non-pad) tokens of the window's steps over the window."""
    return sum(m["tokens"] for step in w["stats"] for m in step) / w["window_s"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from port_bench import spec

    chips = spec.cell(ROOT, args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"port_bench: needs {chips} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    _log(f"card: {_card()}")
    result = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                 t_start=T_START)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if loaded:
        _log(f"port_bench: the process holds {loaded}: the benchmark runs the port alone")
        return 3
    for name, check in result["checks"].items():
        _log(f"{name} {check['value']!r} limit {check['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
