"""Microbench of the fused dropout + add + LayerNorm kernels against
their traffic floor, on the CUDA card::

    python -m pl_bert_tpu_torch.tools.bench_fused_ln [--rows 49152] [--steps 10]

The counterpart of ``tools/bench_fused_ln.py``: at the flagship
[B·L, hidden] = [49152, 768] in bf16, a chain of 24 dependent calls (12
layers × 2 LayerNorm sites; each call's output is the next one's input),
timed with CUDA events over ``--steps`` chains after ``WARMUP`` warm-up
chains (the first compiles the Triton kernels, and a card that sat idle
needs a few launches to reach its clocks):

- the copy anchor (K9, ``fused_ln.add_copy``): both operands read, one
  output written — the floor of the forward's traffic under K5's launch
  shape;
- the fused forward (K5) at dropout rate 0 and 0.1: what the statistics
  and the in-kernel random bits cost over the anchor;
- the plain PyTorch forward at rate 0.1: what the fusion buys;
- forward + backward through K5/K6's ``autograd.Function`` at rate 0 and
  0.1, and through the plain version under autograd.

The TPU tool's row-block sweep is left behind with ``_block_rows``: the
Triton kernels pick their block from the width alone. Prints the card
and its power limit (``nvidia-smi``) beside the table. Needs a CUDA
card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

ROWS, HIDDEN = 96 * 512, 768  # the flagship [B·L, hidden]
CALLS = 24  # 12 layers × 2 LayerNorm sites
STEPS = 10
WARMUP = 3


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _time_chain(step, steps: int) -> float:
    """ms per chain: CUDA events around ``steps`` chains, after ``WARMUP``."""
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def run(rows: int = ROWS, hidden: int = HIDDEN, calls: int = CALLS, steps: int = STEPS,
        device: str = "cuda") -> dict:
    """{row name: ms per chain} for the seven rows of the table."""
    from pl_bert_tpu_torch.ops import fused_ln

    if not torch.cuda.is_available():
        raise SystemExit("bench_fused_ln: needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((rows, hidden), generator=gen).to(device, torch.bfloat16)
    res = torch.randn((rows, hidden), generator=gen).to(device, torch.bfloat16)
    gamma = torch.ones(hidden, device=device)
    beta = torch.zeros(hidden, device=device)

    def fused(rate):
        return lambda y, i: fused_ln.dropout_add_layernorm_train(
            y, res, gamma, beta, seed=17 + i, rate=rate)

    def plain(y, i):
        return fused_ln.dropout_add_layernorm_plain(y, res, gamma, beta, seed=17 + i, rate=0.1)

    def forward(op):
        @torch.no_grad()
        def step():
            y = x
            for i in range(calls):
                y = op(y, i)
            return y
        return step

    def forward_backward(op):
        def step():
            y = x.detach().requires_grad_()
            leaf = y
            for i in range(calls):
                y = op(y, i)
            y.float().mean().backward()
            return leaf.grad
        return step

    cases = {
        "copy-anchor        fwd": forward(lambda y, i: fused_ln.add_copy(y, res)),
        "fused rate=0       fwd": forward(fused(0.0)),
        "fused rate=0.1     fwd": forward(fused(0.1)),
        "plain rate=0.1     fwd": forward(plain),
        "fused rate=0   fwd+bwd": forward_backward(fused(0.0)),
        "fused rate=0.1 fwd+bwd": forward_backward(fused(0.1)),
        "plain rate=0.1 fwd+bwd": forward_backward(plain),
    }
    return {name: _time_chain(step, steps) for name, step in cases.items()}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="fused LN kernels against their copy anchor")
    parser.add_argument("--rows", type=int, default=ROWS)
    parser.add_argument("--hidden", type=int, default=HIDDEN)
    parser.add_argument("--calls", type=int, default=CALLS)
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--json", default=None, help="also write the numbers here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fused_ln: needs a CUDA card")
    card = card_line()
    results = run(args.rows, args.hidden, args.calls, args.steps)
    print(card, flush=True)
    print(f"[N={args.rows}, H={args.hidden}] bf16, {args.calls}-call chain, "
          f"{args.steps}-chain mean (CUDA events)")
    for name, ms in results.items():
        print(f"  {name:26s} {ms:8.3f} ms/chain  ({ms / args.calls:6.4f} ms/call)", flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"card": card, "rows": args.rows, "hidden": args.hidden,
                       "calls": args.calls, "ms_per_chain": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
