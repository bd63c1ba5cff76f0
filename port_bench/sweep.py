"""The readings that the limits of ``limits/<workload>.json`` are set
from, on the card, in one process::

    python3 -m port_bench.sweep --workload <name> --seeds 1,2,3 [--control 3]
        [--faults half_batch,loss_altered] [--fault_seeds 3] [--out FILE]

For each seed: the program through set-up's compared steps, judged as a
run judges it (``run.start``, ``run.judge``); whether the grapheme
head's capacity gather fell back to the full length; on the first
``--control`` seeds also the control — the reference itself in the
program's place, computed in fp8 — held to the fp32 reference; on the
first ``--fault_seeds`` seeds the program with each planted fault
(``faults.py``). One JSON line a reading goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench import compare, faults, run


def _fallbacks() -> int:
    from pl_bert_tpu_torch.ops import masked_ce

    return masked_ce.FALLBACKS.count


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="readings of the correctness numbers")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault_seeds", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a", encoding="utf-8") if args.out else None

    def emit(record: dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        before = _fallbacks()
        st = run.start(run.ROOT, args.workload, seed)
        fell_back = _fallbacks() - before
        run.release(st)
        t1 = time.perf_counter()
        numbers, ref = run.judge(st)
        t2 = time.perf_counter()
        emit({"workload": args.workload, "seed": seed, "side": "program",
              "fallbacks": fell_back, "setup_s": t1 - t0, "reference_s": t2 - t1,
              "losses": st["prog"]["losses"], "ref_losses": ref["losses"], **numbers})
        if i < args.control:
            batches = run.derived_batches(st["cell"], st["corpus"], st["tp_seed"],
                                          st["n_compared"] * st["accum"])
            ctrl = run.follow(st["cell"], st["weights"], batches, st["tp_seed"], "fp8")
            emit({"workload": args.workload, "seed": seed, "side": "control_fp8",
                  "losses": ctrl["losses"], **compare.gaps(ctrl, ref, st["weights"])})
        del st, ref
        if i < args.fault_seeds:
            for name in filter(None, args.faults.split(",")):
                st = run.start(run.ROOT, args.workload, seed, hook=faults.FAULTS[name])
                run.release(st)
                numbers, _ = run.judge(st)
                emit({"workload": args.workload, "seed": seed, "side": f"fault_{name}",
                      **numbers})
                del st
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
