"""Where the attention block's bf16 backward (K4) parts from its plain
version, stage by stage, on the CUDA card::

    python -m pl_bert_tpu_torch.tools.backward_rounding [--against DIR]

At the inputs of ``chip_smoke.py``'s phase 10 (the flagship width,
[8, 512, 768], rows padded to 512 … 5 and 0, random weights from seed 5),
bf16, attention dropout 0 and 0.1, each stage of K4 is held against the
plain backward's, fed the same upstream tensor:

- ``do = dout·Woᵀ``: the CUDA-core GEMM that K4 runs (register-blocked,
  one fmaf chain an output), and the tensor-core GEMM (``gemm_bias_sm90``
  reading Woᵀ K-major), against cuBLAS fp32;
- the attention on the CUDA cores (K4's delta pass, dk/dv kernel and dq
  GEMM, fed K4's own ``do``): delta, the ds scratch (fed K4's delta too)
  and ``dqkv``; and on the tensor cores (the flash backward's wgmma
  kernels, K8, on views of K3's qkv, fed the plain ``do``: their
  recomputed statistics are K3's saved ones bit for bit, so they compute
  what those kernels would inside K4);
- ``dx = dqkv·Wqkvᵀ``: K4 as it runs (its CUDA-core stages, then the
  tensor-core GEMM), the tensor-core GEMM alone on the plain dqkv, and the
  plain GEMM on the dqkv that each tensor-core stage yields, against the
  plain dx.

Each row prints max-abs, rel-L2, the share of elements that differ and
the reference's largest magnitude, beside the smoke's bf16 gate (max-abs
5e-2, rel-L2 1e-3). With ``--against DIR``, DIR a checkout of an earlier
tree whose K4 entry takes no ds scratch (the CUDA-core kernels that formed
nine products a head), that tree's ``csrc/attention_block.cu`` is built
with the same flags and run on the same inputs, and each of K4's outputs
(do, delta, dq, dk, dv, dx) is compared with it: the share of elements
whose bits differ and the largest difference. Prints the card and its
power limit. Needs a CUDA card; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.ops import flash_attention as fa
from pl_bert_tpu_torch.runtime import build

B, L, E, HEADS = 8, 512, 768, 12
LENGTHS = (512, 480, 384, 256, 128, 64, 5, 0)
GATE = {"max_abs": 5e-2, "rel_l2": 1e-3}  # chip_smoke.TOL["bfloat16"]


def held(label: str, got, ref) -> None:
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    err = {"max_abs": float(diff.max()), "rel_l2": float((g - r).norm() / r.norm())}
    ok = all(err[k] <= GATE[k] for k in GATE)
    print(f"  {label:<58} max_abs {err['max_abs']:.3e}  rel_l2 {err['rel_l2']:.3e}  "
          f"differ {float((diff > 0).float().mean()):.2e}  |ref| max "
          f"{float(r.abs().max()):6.2f}  {'within' if ok else 'OUTSIDE'} the gate", flush=True)


def k4_scratch(dout, x, wqkv, wo, saved, bias_row, rate, seed):
    """K4 as it runs, keeping its scratch: (do, delta, ds, dqkv, dx)."""
    dx, dqkv, (do, delta, ds) = ab._launch_bwd(dout, x, wqkv, wo, saved, HEADS, bias_row, None,
                                               rate, seed, scratch=True)
    return do, delta, ds, dqkv, dx


def earlier_k4(tree: Path):
    """``plbt_attention_block_bwd`` of the earlier tree's
    ``csrc/attention_block.cu`` (12 pointers: no ds scratch), built with
    this tree's nvcc flags beside this tree's libraries."""
    src = tree / "pl_bert_tpu_torch" / "csrc" / "attention_block.cu"
    out = build.BUILD_DIR / "earlier" / "libattention_block_earlier.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise build.BuildError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(out)).plbt_attention_block_bwd
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + list(ab._DROPOUT_ARGTYPES)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run_earlier(fn, dout, wqkv, wo, saved, bias_row, rate, seed):
    """The earlier K4 on the same inputs: (do, delta, dqkv, dx)."""
    qkv, _, m, l = saved
    dev, dt = dout.device, dout.dtype
    do = torch.empty((B * L, E), dtype=dt, device=dev)
    delta = torch.empty((B, HEADS, L), device=dev)
    dqkv = torch.empty((B * L, 3 * E), dtype=dt, device=dev)
    dx = torch.empty((B, L, E), dtype=dt, device=dev)
    status = fn(ab._ptr(dout), ab._ptr(wqkv), ab._ptr(wo), ab._ptr(qkv), ab._ptr(m),
                ab._ptr(l), ab._ptr(bias_row), None, ab._ptr(do), ab._ptr(delta),
                ab._ptr(dqkv), ab._ptr(dx), B, L, E, E, HEADS, 1,
                *ab._dropout_args(rate, seed), ab._stream(dev))
    build.check(status, "the earlier attention_block backward kernel")
    return do, delta, dqkv, dx


def differ(label: str, got, ref) -> None:
    """The share of elements whose bits differ, and the largest difference."""
    diff = (got.float() - ref.float()).abs()
    print(f"  {label:<40} bits differ in {float((got != ref).float().mean()):.3e} of "
          f"{got.numel()} elements, max-abs {float(diff.max()):.3e}", flush=True)


def gemm_bt(a, b):
    """a · bᵀ in bf16 on the tensor cores (``plbt_gemm_bt``)."""
    out = torch.empty((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    fn = ab._entry("plbt_gemm_bt", 3, 3)
    status = fn(ab._ptr(a), ab._ptr(b), ab._ptr(out), a.shape[0], b.shape[0], a.shape[1],
                ab._stream(a.device))
    ab.build.check(status, "wgmma GEMM")
    return out


def tensor_core_attention(do, saved, bias_row, rate, seed):
    """dqkv of K8's wgmma kernels on views of K3's qkv and ``do``."""
    qkv = saved[0]
    D = E // HEADS
    q, k, v = (t.reshape(B, L, HEADS, D) for t in qkv.reshape(B, L, 3 * E).split(E, dim=-1))
    dq, dk, dv, *_ = fa._launch_bwd(do.reshape(B, L, HEADS, D), q, k, v, bias_row, None, rate,
                                    seed)
    return torch.cat([t.reshape(B * L, E) for t in (dq, dk, dv)], dim=1)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a checkout of an earlier tree whose K4 to compare bit for bit")
    args_ = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("backward_rounding needs a CUDA card")
    earlier = earlier_k4(args_.against) if args_.against else None
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev, dt = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(5)  # chip_smoke.py's phase 9-10 inputs (SEED + 5)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    wqkv = f32(rng.standard_normal((E, 3 * E)) * 0.05)
    bqkv = f32(rng.standard_normal(3 * E) * 0.02)
    wo, bo = f32(rng.standard_normal((E, E)) * 0.05), f32(rng.standard_normal(E) * 0.02)
    mask = f32(np.arange(L)[None, :] < np.asarray(LENGTHS)[:, None])
    bias_row, _ = ab.rows(attention_bias_from_mask(mask), None, B, L)
    x = f32(rng.standard_normal((B, L, E)) * 0.5).to(dt)
    dout = f32(rng.standard_normal((B, L, E))).to(dt)
    wqkv, wo = wqkv.to(dt).contiguous(), wo.to(dt).contiguous()

    def plain_dx(dqkv):  # the plain dx projection
        return (dqkv.float() @ wqkv.float().T).to(dt).reshape(B, L, E)

    for rate in (0.0, 0.1):
        seed = 4321 if rate else None
        keep = ab.dropout_mask(seed, rate, B, HEADS, L, dev) if rate else None
        _, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, HEADS, bias_row, None, rate, seed)
        args = (saved, HEADS, bias_row, None, rate, seed, keep)
        do_k, delta_k, ds_k, dqkv_k, dx_k = k4_scratch(dout, x, wqkv, wo, saved, bias_row, rate,
                                                       seed)
        do_p = (dout.reshape(B * L, E).float() @ wo.float().T).to(dt)
        dqkv_p, _ = ab.attention_backward_plain(do_p, *args)
        dx_p = plain_dx(dqkv_p)
        print(f"[{B}, {L}, {E}] bf16, dropout {rate}:")
        held("do, CUDA-core GEMM (K4, register-blocked)", do_k, do_p)
        do_tc = gemm_bt(dout.reshape(B * L, E), wo)
        held("do, tensor-core GEMM", do_tc, do_p)
        dqkv_kp, delta_kp = ab.attention_backward_plain(do_k, *args)
        held("delta, CUDA cores (K4's delta pass), fed K4's do", delta_k, delta_kp)
        ds_p = ab.attention_dkdv_plain(do_k, saved, delta_k, HEADS, bias_row, None, rate, seed,
                                       keep)[2]
        held("ds, CUDA cores (K4's dk/dv), fed K4's do, delta", ds_k[:, :, :L, :L], ds_p)
        held("dqkv, CUDA cores (K4), fed K4's do", dqkv_k, dqkv_kp)
        del ds_p
        dqkv_tc = tensor_core_attention(do_p, saved, bias_row, rate, seed)
        for i, name in enumerate(("dq", "dk", "dv")):
            held(f"{name}, tensor cores (K8's kernels), fed the plain do",
                 dqkv_tc[:, i * E:(i + 1) * E], dqkv_p[:, i * E:(i + 1) * E])
        held("dx, K4 as it runs", dx_k, dx_p)
        held("dx, tensor-core GEMM on the plain dqkv", gemm_bt(dqkv_p, wqkv),
             dx_p.reshape(B * L, E))
        held("dx, plain GEMM on the tensor-core attention's dqkv", plain_dx(dqkv_tc), dx_p)
        dqkv_do_tc, _ = ab.attention_backward_plain(do_tc, *args)
        held("dx, plain attention and GEMM on the tensor-core do", plain_dx(dqkv_do_tc), dx_p)
        if earlier is not None:
            print(f"  K4 against the earlier tree's K4 ({args_.against}), the same inputs:")
            e_do, e_delta, e_dqkv, e_dx = run_earlier(earlier, dout, wqkv, wo, saved, bias_row,
                                                      rate, seed)
            torch.cuda.synchronize()
            differ("do", do_k, e_do)
            differ("delta", delta_k, e_delta)
            for i, name in enumerate(("dq", "dk", "dv")):
                differ(name, dqkv_k[:, i * E:(i + 1) * E], e_dqkv[:, i * E:(i + 1) * E])
            differ("dx", dx_k, e_dx)
        del saved, keep


if __name__ == "__main__":
    main()
