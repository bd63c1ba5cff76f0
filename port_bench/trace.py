"""What a ``torch.profiler`` trace of the window says: device seconds by
kernel name, by host range, the device's busy time, and the idle gaps
by what the host was doing."""

from __future__ import annotations

import bisect

import torch

# host ranges an idle gap is put down to: the benchmark's own spans, the
# program's ``lm_head.*`` ranges, and the calls that wait on the device
GAP_LABELS = ("port_bench.", "lm_head.")
GAP_CALLS = ("aten::_local_scalar_dense", "cudaStreamSynchronize", "cudaDeviceSynchronize",
             "aten::pin_memory", "cudaMemcpyAsync", "cudaMalloc", "cudaFree",
             "cudaHostAlloc")


def _union(intervals: list) -> tuple[float, list]:
    """(length of the union of (start, end) intervals, the gaps between
    its pieces)."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None:
            busy, end = e - s, e
        elif s > end:
            gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def reduce(events) -> dict:
    """The numbers of a trace (``prof.events()``), in seconds."""
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    kernels = [e for e in device if not e.name.startswith(GAP_LABELS)]
    if not kernels:
        return {"kernels": {}, "ranges": {}, "busy_s": 0.0, "window_s": 0.0, "gaps": {}}
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    ranges: dict[str, float] = {}
    for e in host:
        if e.name.startswith("lm_head."):
            ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total / 1e6
    busy, gaps = _union([(e.time_range.start, e.time_range.end) for e in kernels])
    stamps = [e.time_range.start for e in host] + [e.time_range.end for e in host]
    stamps += [e.time_range.start for e in kernels] + [e.time_range.end for e in kernels]
    window = max(stamps) - min(stamps)
    labels = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host
                     if e.name.startswith(GAP_LABELS) or e.name in GAP_CALLS))
    starts = [s for s, _, _ in labels]
    by_label: dict[str, float] = {}
    for g0, g1 in gaps:
        at = (g0 + g1) / 2
        best = None
        for s, e, name in reversed(labels[max(0, bisect.bisect_right(starts, at) - 64):
                                          bisect.bisect_right(starts, at)]):
            if e >= at and (best is None or e - s < best[0]):
                best = (e - s, name)
        label = best[1] if best else "other"
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e6
    return {"kernels": by_name, "ranges": ranges, "busy_s": busy / 1e6,
            "window_s": window / 1e6, "gaps": by_label}


def device_seconds(trace: dict, keys: tuple) -> float:
    """Summed seconds of the kernels whose names hold any of ``keys``."""
    return sum(s for name, s in trace["kernels"].items() if any(k in name for k in keys))


def top(table: dict, n: int = 10) -> list:
    return [[name, s] for name, s in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
