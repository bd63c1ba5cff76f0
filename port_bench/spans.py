"""What the program's own spans say about a cell's step, on the device
trace's clock::

    python3 -m port_bench.spans --workload <name> --seed <n> [--steps 10] [--control]

Set-up as a run's (``run.start`` and the warm-up steps), then ``--steps``
steps of the run's loop timed by CUDA events alone, then ``--steps``
more under a ``torch.profiler`` that records every thread, since the
feed's spans (``plbert.feed.*``) are the prefetch thread's. Prints one
JSON line: the card, both step times (what tracing costs), the card's
idle share and its idle gaps by label as ``trace.reduce`` takes them,
and :func:`reduce`'s: each ``plbert.*`` span and the capacity read by
calls, host and device milliseconds a step, the device's idle gaps put
down to the innermost span of the stepping thread, and the readings
``optimizer_ms``, ``device_mask_ms``, ``feed_host_ms``,
``feed_overlap_idle_ms`` and ``capacity_read_idle_ms``
(:func:`readings`). ``--control`` adds two windows of as many steps
each, under keys of their own: ``stepping_thread``, the live feed traced
on the stepping thread alone, as a cell's traced run (``run.py``) traces
it; and ``batches_ready``, the next batches taken off the feed and put on
the card before the window, so that the prefetch thread has stopped
(its queue full) while the card steps on them. No result line of a
cell's run and no judgement; a cell's traced run reads none of these.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time

import torch

from port_bench import trace

SPAN_PREFIX = "plbert."
CAPACITY_READ = "lm_head.capacity_read"
STEP = "plbert.step"
FEED_BATCH = "plbert.feed.batch"
# the host ranges an idle gap may be put down to
LABELS = trace.GAP_LABELS + (SPAN_PREFIX,)
# seconds for the prefetch thread to fill its queue once the batches of
# a ``batches_ready`` window are taken (a few of the host masker's batches)
FEED_SETTLE_S = 3.0


def _pieces(intervals: list) -> list:
    """The union of (start, end) intervals as sorted, disjoint pieces:
    what lies between ``trace._union``'s gaps."""
    if not intervals:
        return []
    _, gaps = trace._union(intervals)
    edges = [min(s for s, _ in intervals), *(t for g in gaps for t in g),
             max(e for _, e in intervals)]
    return list(zip(edges[::2], edges[1::2]))


def _overlap(a0: float, a1: float, pieces: list) -> float:
    """Length of [a0, a1] inside the union of sorted, disjoint pieces."""
    return sum(max(0.0, min(a1, e) - max(a0, s)) for s, e in pieces)


def _innermost(labels: list, points: list) -> list:
    """For each of the sorted ``points``, the name of the shortest range
    covering it among ``labels`` [(start, end, name, thread)] (a
    thread's ranges nest), or None."""
    threads: dict = {}
    # an enclosing range before the ranges it holds, where they start together
    for s, e, name, t in sorted(labels, key=lambda r: (r[0], -r[1])):
        threads.setdefault(t, []).append((s, e, name))
    state = {t: [0, []] for t in threads}  # next label, open ranges
    out = []
    for at in points:
        best = None
        for t, ranges in threads.items():
            i, open_ = state[t]
            while i < len(ranges) and ranges[i][0] <= at:
                while open_ and open_[-1][1] < ranges[i][0]:
                    open_.pop()
                open_.append(ranges[i])
                i += 1
            while open_ and open_[-1][1] < at:
                open_.pop()
            state[t][0] = i
            if open_ and (best is None or open_[-1][1] - open_[-1][0] < best[0]):
                best = (open_[-1][1] - open_[-1][0], open_[-1][2])
        out.append(best[1] if best else None)
    return out


def _label(e) -> tuple:
    return (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name, e.thread)


def reduce(events) -> dict:
    """The program's spans in a trace (``prof.events()``), in seconds:
    {"spans": name → {"calls", "host_s", "device_s", "intervals":
    [(start, end, thread)]} for every ``plbert.*`` range and the
    capacity read; "kernels": the device's work [(start, end)] and
    "gaps": its idle gaps [(start, end)], both as ``trace.reduce`` takes
    them (its kernels, its ``_union``); "idle": label → idle seconds,
    each gap put down to the innermost of the stepping thread's (the
    threads that hold ``plbert.step``, else every thread)
    ``port_bench.*``, ``lm_head.*`` and ``plbert.*`` ranges covering its
    middle, and after a ``>`` the call that waits on the device covering
    it, if one does (``plbert.step > cudaStreamSynchronize``); "window":
    (start, end) of the stepping thread's events and the kernels, which
    is ``trace.reduce``'s window where the profiler records that thread
    alone (with every thread recorded, the feed's events would stretch
    it past the steps)}."""
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    kernels = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6) for e in device
                     if not e.name.startswith(trace.GAP_LABELS))
    spans: dict = {}
    for e in host:
        if e.name.startswith(SPAN_PREFIX) or e.name == CAPACITY_READ:
            s = spans.setdefault(e.name, {"calls": 0, "host_s": 0.0, "device_s": 0.0,
                                          "intervals": []})
            s["calls"] += 1
            s["host_s"] += e.time_range.elapsed_us() / 1e6
            s["device_s"] += e.device_time_total / 1e6
            s["intervals"].append((e.time_range.start / 1e6, e.time_range.end / 1e6,
                                   e.thread))
    gaps = trace._union(kernels)[1]
    stepping = {e.thread for e in host if e.name == STEP} or {e.thread for e in host}
    stamps = [t for e in host if e.thread in stepping
              for t in (e.time_range.start / 1e6, e.time_range.end / 1e6)]
    stamps += [t for k in kernels for t in k]
    window = (min(stamps), max(stamps)) if stamps else (0.0, 0.0)
    mine = [e for e in host if e.thread in stepping]
    middles = [(a + b) / 2 for a, b in gaps]
    in_span = _innermost([_label(e) for e in mine if e.name.startswith(LABELS)], middles)
    in_call = _innermost([_label(e) for e in mine if e.name in trace.GAP_CALLS], middles)
    idle: dict = {}
    for (g0, g1), span_, call in zip(gaps, in_span, in_call):
        label = (span_ or "other") + (f" > {call}" if call else "")
        idle[label] = idle.get(label, 0.0) + g1 - g0
    return {"spans": spans, "kernels": kernels, "gaps": gaps, "idle": idle,
            "window": window}


def capacity_read_idle_s(red: dict) -> list:
    """For each capacity read, the device's gap from the last kernel to
    end before the read returned to the first kernel to start after it
    (``training/profile.py``'s ``capacity_reads``)."""
    ends = sorted(e for _, e in red["kernels"])
    starts = [s for s, _ in red["kernels"]]
    out = []
    for _, done, _ in red["spans"].get(CAPACITY_READ, {"intervals": []})["intervals"]:
        i, j = bisect.bisect_right(ends, done), bisect.bisect_left(starts, done)
        out.append(starts[j] - ends[i - 1] if i and j < len(starts) else 0.0)
    return out


def readings(red: dict, steps: int) -> dict:
    """The five numbers a traced window's spans give, ms a traced step;
    a span the window lacks gives none."""
    spans = red["spans"]
    out = {}
    for key, name in (("optimizer_ms", "plbert.step.optimizer"),
                      ("device_mask_ms", "plbert.step.mask")):
        if name in spans:
            out[key] = 1e3 * spans[name]["device_s"] / steps
    if FEED_BATCH in spans:
        w0, w1 = red["window"]
        feed = [(max(a, w0), min(b, w1)) for a, b, _ in spans[FEED_BATCH]["intervals"]]
        feed = [(a, b) for a, b in feed if b > a]
        out["feed_host_ms"] = 1e3 * sum(b - a for a, b in feed) / steps
        pieces = _pieces(feed)
        out["feed_overlap_idle_ms"] = 1e3 * sum(_overlap(g0, g1, pieces)
                                                for g0, g1 in red["gaps"]) / steps
    if CAPACITY_READ in spans:
        out["capacity_read_idle_ms"] = 1e3 * sum(capacity_read_idle_s(red)) / steps
    return out


def _window(loop, steps: int, cuda: bool, every_thread: bool) -> dict:
    """``steps`` steps of ``loop`` timed by CUDA events alone, then
    ``steps`` more traced (every thread recorded, or the thread that
    starts the profiler alone, as ``run.py`` traces); → their numbers,
    the host clock's ms a step among them (the steps' rate, as the
    end-to-end metric takes it)."""
    def steps_ms(n: int) -> tuple:
        first, t0 = len(loop.steps), time.perf_counter()
        for _ in range(n):
            loop.step()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
        if not cuda:
            return [], wall_ms
        return [s["events"][0].elapsed_time(s["events"][1]) for s in loop.steps[first:]], wall_ms

    print(f"window at {time.strftime('%Y/%m/%d %H:%M:%S')}", file=sys.stderr, flush=True)
    untraced, untraced_wall = steps_ms(steps)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    threads = (torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
               if every_thread else None)
    with torch.profiler.profile(activities=acts, experimental_config=threads) as prof:
        traced, traced_wall = steps_ms(steps)
    t0 = time.perf_counter()
    events = prof.events()
    red = reduce(events)
    std = trace.reduce(events)
    kernels = red["kernels"]
    return {
        "step_ms_untraced_median": statistics.median(untraced) if untraced else None,
        "step_ms_traced_median": statistics.median(traced) if traced else None,
        "wall_ms_a_step_untraced": untraced_wall,
        "wall_ms_a_step_traced": traced_wall,
        "device_idle_pct": (100.0 * (1 - std["busy_s"] / std["window_s"])
                            if std["window_s"] else None),
        "busy_ms_a_step": 1e3 * std["busy_s"] / steps,
        "kernel_span_ms_a_step": (1e3 * (max(e for _, e in kernels) - kernels[0][0]) / steps
                                  if kernels else None),
        "device_ops_ms_a_step": {k: 1e3 * v / steps for k, v in trace.top(std["kernels"], 12)},
        "trace_gaps_ms_a_step": {k: 1e3 * v / steps for k, v in trace.top(std["gaps"])},
        "idle_ms_a_step": {k: 1e3 * v / steps for k, v in
                           sorted(red["idle"].items(), key=lambda kv: -kv[1])},
        "spans": {k: {"calls_a_step": v["calls"] / steps,
                      "host_ms_a_step": 1e3 * v["host_s"] / steps,
                      "device_ms_a_step": 1e3 * v["device_s"] / steps,
                      "threads": len({t for _, _, t in v["intervals"]})}
                  for k, v in sorted(red["spans"].items())},
        "readings": readings(red, steps),
        "read_s": time.perf_counter() - t0,
    }


def _batches_ready(loop, n: int) -> None:
    """Take the feed's next ``n`` batches now (on the card already) and
    have ``loop`` step on them; wait until its prefetch thread has
    filled its queue and stopped on it."""
    ready = [loop._next() for _ in range(n)]
    loop._next = lambda: ready.pop(0)
    time.sleep(FEED_SETTLE_S)


def measure(root, workload: str, seed: int, steps: int, device: str = "cuda",
            control: bool = False) -> dict:
    """Set-up, then a window of ``steps`` untraced and ``steps`` traced
    steps of the cell with every thread recorded, and with ``control``
    the ``stepping_thread`` and ``batches_ready`` windows after it; →
    the numbers :func:`main` prints (step times on a card alone)."""
    from port_bench import run

    st = run.start(root, workload, seed, device)
    loop = st["loop"]
    cuda = st["trainer"].device.type == "cuda"
    for _ in range(run.WARMUP_STEPS):
        loop.step()
    out = {"workload": workload, "seed": seed, "steps": steps,
           **_window(loop, steps, cuda, every_thread=True)}
    if control:
        out["stepping_thread"] = _window(loop, steps, cuda, every_thread=False)
        _batches_ready(loop, 2 * steps)
        out["batches_ready"] = _window(loop, steps, cuda, every_thread=True)
    run.release(st)
    return out


def main(argv=None) -> int:
    from port_bench import run

    parser = argparse.ArgumentParser(description="the program's spans in a traced window")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--steps", type=int, default=run.TRACE_STEPS)
    parser.add_argument("--control", action="store_true",
                        help="also trace the stepping thread alone, and the steps on "
                             "batches made before the window")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    out = measure(run.ROOT, args.workload, args.seed, args.steps, control=args.control)
    print(json.dumps({"card": run._card(), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
