"""K7 and K8 on packed rows and on dense ones, on the CUDA card, and
against an earlier tree's kernels::

    python -m pl_bert_tpu_torch.tools.flash_tiles [--segments FILE.npz] [--against DIR]

At the packed training shape, [96, 512, 12, 64] bf16 with attention
dropout 0.1, the flash forward (K7) and backward (K8) run on each batch
of FILE (``segment_ids`` [N, 96, 512] and ``lengths`` [N, 96], rows as the
packed feed lays them out, with ``seeds`` [N] for the inputs and the
dropout) and on one dense batch (rows of 512, no segments). Each line
prints the share of tile pairs the kernels walk (``flash_tile_share``),
Σ segment² over B·L², the least time the inputs need (the larger of
their operations at 989 TFLOP/s and their bytes at 3.35 TB/s, counting
attention within segments as the benchmark does), and each kernel's
median device ms by CUDA events over ``--iters`` calls.

With ``--against DIR``, DIR a checkout of an earlier tree, that tree's
``csrc/flash_attention.cu`` is built with this tree's nvcc flags and run
on the same inputs, in turns with this tree's, and its times are printed
beside; then o, dq, dk, dv, the recomputed row max and denominator and
delta are compared bit for bit. Prints the card and its power limit.
Needs a CUDA card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.ops import flash_attention as fa
from pl_bert_tpu_torch.runtime import build

B, L, H, D = 96, 512, 12, 64
RATE = 0.1
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12


def bound_ms(seg_sq: float, tokens: int) -> tuple[float, float]:
    """(K7, K8) least ms: attention within segments, each input read and
    output written once (the benchmark's ``cost.kernel_bound_s``)."""
    E = H * D
    k7 = max(4 * seg_sq * E / PEAK_BF16, 4 * tokens * E * 2 / PEAK_BYTES)
    k8 = max(8 * seg_sq * E / PEAK_BF16, 7 * tokens * E * 2 / PEAK_BYTES)
    return 1e3 * k7, 1e3 * k8


def seg_sq(seg: np.ndarray, lengths: np.ndarray) -> float:
    if seg is None:
        return float((lengths.astype(np.int64) ** 2).sum())
    return float(sum((np.bincount(row[row >= 0]).astype(np.int64) ** 2).sum() for row in seg))


def entries(lib: ctypes.CDLL):
    """(forward, backward) C entry points of a flash_attention library."""
    fwd, bwd = lib.plbt_flash_attention_fwd, lib.plbt_flash_attention_bwd
    for fn, n_ptrs in ((fwd, 6), (bwd, 14)):
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 9
                       + list(ab._DROPOUT_ARGTYPES) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fwd, bwd


def earlier_library(tree: Path) -> ctypes.CDLL:
    src = tree / "pl_bert_tpu_torch" / "csrc" / "flash_attention.cu"
    out = build.BUILD_DIR / "earlier" / "libflash_attention_earlier.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise build.BuildError(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out))


class Case:
    """One batch's inputs and the buffers each call writes."""

    def __init__(self, dev, seg, lengths, seed: int):
        gen = torch.Generator(dev).manual_seed(seed)
        self.q, self.k, self.v, self.dout = (
            torch.randn(B, L, H, D, device=dev, generator=gen).to(torch.bfloat16)
            for _ in range(4))
        valid = torch.from_numpy(np.arange(L)[None] < lengths[:, None]).to(dev)
        segs = None if seg is None else torch.from_numpy(seg).to(dev)
        self.bias_row, self.seg_row = ab.rows(attention_bias_from_mask(valid), segs, B, L)
        self.seed = seed

    def outputs(self):
        dev = self.q.device
        o, dq, dk, dv = (torch.empty_like(self.q) for _ in range(4))
        m, den, delta = (torch.zeros((B, H, L), device=dev) for _ in range(3))
        return o, dq, dk, dv, m, den, delta

    def run(self, fns, outs, which: str) -> None:
        fwd, bwd = fns
        o, dq, dk, dv, m, den, delta = outs
        p = ab._ptr
        drop = ab._dropout_args(RATE, self.seed)
        stream = ab._stream(self.q.device)
        if which == "fwd":
            status = fwd(p(self.q), p(self.k), p(self.v), p(self.bias_row), p(self.seg_row),
                         p(o), B, L, H, D, H * D, H * D, H * D, H * D, 1, *drop, stream)
        else:
            status = bwd(p(self.q), p(self.k), p(self.v), p(self.dout), p(self.bias_row),
                         p(self.seg_row), p(m), p(den), p(delta), None, None, p(dq), p(dk),
                         p(dv), B, L, H, D, H * D, H * D, H * D, H * D, 1, *drop, stream)
        build.check(status, f"flash attention {which}")


def timed(case: Case, sides: dict, iters: int) -> dict:
    """Median device ms of each side's forward and backward, the sides in
    turns each iteration."""
    outs = {name: case.outputs() for name in sides}
    times = {(name, w): [] for name in sides for w in ("fwd", "bwd")}
    for it in range(iters + 3):
        for name, fns in sides.items():
            for which in ("fwd", "bwd"):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                case.run(fns, outs[name], which)
                end.record()
                end.synchronize()
                if it >= 3:
                    times[name, which].append(start.elapsed_time(end))
    return {key: statistics.median(v) for key, v in times.items()}, outs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--segments", type=Path, default=None,
                        help="npz of segment_ids [N, 96, 512], lengths [N, 96], seeds [N]")
    parser.add_argument("--against", type=Path, default=None,
                        help="a checkout of an earlier tree whose kernels to compare with")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    sides = {"this": entries(build.load("flash_attention"))}
    if args.against:
        sides["earlier"] = entries(earlier_library(args.against))
    cases = [("dense", None, np.full(B, L), 1)]
    if args.segments:
        data = np.load(args.segments)
        for i, (seg, lengths, seed) in enumerate(zip(data["segment_ids"], data["lengths"],
                                                    data["seeds"])):
            cases.append((f"packed {i} (seed {int(seed)})", seg, lengths, int(seed)))
    for label, seg, lengths, seed in cases:
        case = Case(dev, seg, lengths, seed)
        share = 1.0 if seg is None else fa.flash_tile_share(seg, lengths)
        sq = seg_sq(seg, lengths)
        b7, b8 = bound_ms(sq, int(lengths.sum()))
        ms, outs = timed(case, sides, args.iters)
        line = (f"{label}: flash_tile_share {share:.4f}  Σs²/(B·L²) {sq / (B * L * L):.4f}  "
                f"bound K7 {b7:.4f} K8 {b8:.4f} ms")
        for name in sides:
            line += (f"  | {name}: K7 {ms[name, 'fwd']:.4f} ms ({100 * b7 / ms[name, 'fwd']:.2f}%)"
                     f" K8 {ms[name, 'bwd']:.4f} ms ({100 * b8 / ms[name, 'bwd']:.2f}%)")
        print(line, flush=True)
        if "earlier" in sides:
            names = ("o", "dq", "dk", "dv", "stat_m", "stat_l", "delta")
            equal = {n: torch.equal(a, b) for n, a, b in zip(names, outs["this"],
                                                              outs["earlier"])}
            print(f"  bits against the earlier tree: "
                  + ", ".join(f"{n} {'equal' if e else 'DIFFER'}" for n, e in equal.items()),
                  flush=True)


if __name__ == "__main__":
    main()
