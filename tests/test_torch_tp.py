"""The port's tensor-parallel wrappers (``pl_bert_tpu_torch/parallel/tp.py``)
against JAX's (``pl_bert_tpu/parallel/tp.py``) on the CPU, in fp32.

Two ranks over gloo (this file run as a script, one process a rank;
``tests/test_tensor_parallel.py``'s shape: B 2, L 128, E 256, 4 heads,
2 a rank) hold their shards of the same numpy-seeded inputs; JAX runs its
wrappers in interpret mode on a 1×2 CPU mesh in the test process:

- ``tp_attention_block`` forward and gradients (dx, every weight and
  bias) within atol 2e-5 / rtol 1e-5, with and without sequence
  parallelism (the SP rows are the non-SP values' rows, scattered over L),
  on a training weight set, and forward on a serving one;
- ``tp_flash_attention`` on the local heads, and
  ``tp_dropout_add_layernorm`` with and without SP, forward;
- with dropout, each rank's attention seed is its own, and the backward
  regenerates the forward's mask (against autograd of the plain block
  fed that mask).

The model (``models/albert.py``) runs its sharded attention and
LayerNorms through these wrappers, so they are the Trainer's path.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

B, L, E, H = 2, 128, 256, 4
LN_L = 256
ATOL, RTOL = 2e-5, 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    inp = {"x": rng.standard_normal((B, L, E)).astype(f32) * 0.5}
    for n in "qkvo":
        inp["w" + n] = rng.standard_normal((E, E)).astype(f32) * 0.05
        inp["b" + n] = rng.standard_normal(E).astype(f32) * 0.02
    mask = np.ones((B, L), np.int32)
    mask[0, 100:] = 0
    inp["mask"] = mask
    inp["dout"] = rng.standard_normal((B, L, E)).astype(f32) * 0.1
    for n in "qkv":  # flash attention's [B, L, H, D]
        inp["f" + n] = rng.standard_normal((B, L, H, E // H)).astype(f32) * 0.3
    # the LN's rows: JAX's kernel takes row counts in multiples of 256
    inp["res"] = rng.standard_normal((4, LN_L, E)).astype(f32)
    inp["scale"] = rng.standard_normal(E).astype(f32) * 0.1 + 1.0
    inp["lnb"] = rng.standard_normal(E).astype(f32) * 0.1
    return inp


def _worker(rank: int, port: int, out_dir: str) -> None:
    """One rank: its shards of the inputs through the port's wrappers."""
    import torch.distributed as dist

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.parallel import tp
    from pl_bert_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    mesh = make_mesh(1, 2)
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    bias = attention_bias_from_mask(inp["mask"])
    cols, rows = slice(rank * E // 2, (rank + 1) * E // 2), slice(rank * L // 2,
                                                                   (rank + 1) * L // 2)
    out = {}
    for sp in (False, True):
        w = {n: inp["w" + n][:, cols].clone().requires_grad_() for n in "qkv"}
        w["o"] = inp["wo"][cols].clone().requires_grad_()
        b = {n: inp["b" + n][cols].clone().requires_grad_() for n in "qkv"}
        b["o"] = inp["bo"].clone().requires_grad_()
        x = (inp["x"][:, rows] if sp else inp["x"]).clone().requires_grad_()
        # the shard's training weight set, as AlbertSelfAttention makes it
        wqkv32 = torch.cat([w["q"], w["k"], w["v"]], dim=1)
        ws = {"wqkv32": wqkv32, "bqkv": torch.cat([b["q"], b["k"], b["v"]]),
              "wo32": w["o"], "bo": b["o"], "wqkv": wqkv32.detach().contiguous(),
              "wo": w["o"].detach().contiguous()}
        y = tp.tp_attention_block(mesh, x, ws, H, bias=bias, out_dtype=torch.float32, sp=sp)
        (y * (inp["dout"][:, rows] if sp else inp["dout"])).sum().backward()
        out[f"block_sp{int(sp)}"] = {
            "out": y.detach(), "dx": x.grad,
            **{f"dw{n}": w[n].grad for n in w}, **{f"db{n}": b[n].grad for n in b}}
    with torch.no_grad():  # a serving weight set: compute-dtype copies only
        ws = {"wqkv": torch.cat([inp["w" + n][:, cols] for n in "qkv"], 1),
              "bqkv": torch.cat([inp["b" + n][cols] for n in "qkv"]),
              "wo": inp["wo"][cols].contiguous(), "bo": inp["bo"]}
        out["block_serve"] = tp.tp_attention_block(mesh, inp["x"], ws, H, bias=bias,
                                                   out_dtype=torch.float32)
    heads = slice(rank * H // 2, (rank + 1) * H // 2)
    out["flash"] = tp.tp_flash_attention(mesh, *(inp["f" + n][:, :, heads] for n in "qkv"),
                                         bias, out_dtype=torch.float32)
    for sp in (False, True):
        r = slice(rank * LN_L // 2, (rank + 1) * LN_L // 2) if sp else slice(None)
        out[f"ln_sp{int(sp)}"] = tp.tp_dropout_add_layernorm(
            mesh, inp["res"][:, r] * 0.5, inp["res"][:, r], inp["scale"], inp["lnb"], None,
            0.0, 1e-12, sp=sp)
    # dropout: this rank's seed, and the backward's mask is the forward's
    seed = tp.attention_seed(12345, mesh)
    x = inp["x"].clone().requires_grad_()
    wqkv = torch.cat([inp["w" + n][:, cols] for n in "qkv"], 1).requires_grad_()
    bqkv = torch.cat([inp["b" + n][cols] for n in "qkv"])
    wo = inp["wo"][cols]
    zero = torch.zeros(E)
    y = ab.attention_block_train(x, wqkv, bqkv, wo, zero, wqkv.detach(), wo, H // 2, bias=bias,
                                 dropout_rate=0.1, dropout_seed=seed)
    y.backward(inp["dout"])
    x2 = inp["x"].clone().requires_grad_()
    wqkv2 = wqkv.detach().clone().requires_grad_()
    keep = ab.dropout_keep(seed, 0.1, B, H // 2, L)
    y2 = ab.attention_block_plain(x2, wqkv2, bqkv, wo, zero, H // 2, bias=bias,
                                  dropout_rate=0.1, dropout_seed=seed, keep=keep)
    y2.backward(inp["dout"])
    out["dropout"] = {"seed": seed, "out": y.detach(), "out_plain": y2.detach(),
                      "dx": x.grad, "dx_plain": x2.grad, "dw": wqkv.grad,
                      "dw_plain": wqkv2.grad, "kept": keep.float().mean()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("tp"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), out_dir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log[-4000:]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
            for r in range(2)]


@pytest.fixture(scope="module")
def jax_ref():
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from pl_bert_tpu.models.albert import attention_bias_from_mask
    from pl_bert_tpu.parallel.mesh import make_mesh
    from pl_bert_tpu.parallel.tp import (
        tp_attention_block,
        tp_dropout_add_layernorm,
        tp_flash_attention,
    )

    inp = {k: jnp.asarray(v) for k, v in _inputs().items()}
    bias = attention_bias_from_mask(inp["mask"])
    mesh = make_mesh(data=1, model=2, devices=jax.devices("cpu")[:2])
    ws = {n: inp["w" + n] for n in "qkvo"}
    bs = {n: inp["b" + n] for n in "qkvo"}

    def block(x, ws, bs):
        return tp_attention_block(mesh, x, ws["q"], bs["q"], ws["k"], bs["k"], ws["v"],
                                  bs["v"], ws["o"], bs["o"], H, bias=bias,
                                  out_dtype=jnp.float32)

    with pltpu.force_tpu_interpret_mode():
        out, pullback = jax.vjp(block, inp["x"], ws, bs)
        grads = pullback(inp["dout"])
        flash = tp_flash_attention(mesh, inp["fq"], inp["fk"], inp["fv"], bias,
                                   out_dtype=jnp.float32)
        ln = [tp_dropout_add_layernorm(mesh, inp["res"] * 0.5, inp["res"], inp["scale"],
                                       inp["lnb"], None, 0.0, 1e-12, sp=sp)
              for sp in (False, True)]
    np_ = np.asarray
    return {"out": np_(out), "dx": np_(grads[0]),
            **{f"dw{n}": np_(grads[1][n]) for n in "qkvo"},
            **{f"db{n}": np_(grads[2][n]) for n in "qkvo"},
            "flash": np_(flash), "ln": [np_(t) for t in ln]}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_tp_attention_block_matches_jax(ranks, jax_ref, sp):
    """Values and gradients: each rank's column slice of dWq/dWk/dWv and
    dbq/dbk/dbv, its row slice of dWo; dx on every rank (under SP its L
    rows); dbo summed over the ranks (under SP each saw its rows). The SP
    values are JAX's (non-SP) values, scattered over L, as JAX's SP output
    is (tests/test_sequence_parallel.py)."""
    key = f"block_sp{int(sp)}"
    for r, got in enumerate(ranks):
        g = got[key]
        cols = slice(r * E // 2, (r + 1) * E // 2)
        rows = slice(r * L // 2, (r + 1) * L // 2) if sp else slice(None)
        _close(g["out"], jax_ref["out"][:, rows], f"out rank {r}")
        _close(g["dx"], jax_ref["dx"][:, rows], f"dx rank {r}")
        for n in "qkv":
            _close(g[f"dw{n}"], jax_ref[f"dw{n}"][:, cols], f"dW{n} rank {r}")
            _close(g[f"db{n}"], jax_ref[f"db{n}"][cols], f"db{n} rank {r}")
        _close(g["dwo"], jax_ref["dwo"][cols], f"dWo rank {r}")
    dbo = [got[key]["dbo"] for got in ranks]
    _close(dbo[0] + dbo[1] if sp else dbo[0], jax_ref["dbo"], "dbo")
    if not sp:
        assert torch.equal(dbo[0], dbo[1])


def test_tp_attention_block_serving_set_matches_jax(ranks, jax_ref):
    """The serving weight set (K1's route, no gradient) gives the same
    values on every rank."""
    for r, got in enumerate(ranks):
        _close(got["block_serve"], jax_ref["out"], f"rank {r}")


def test_tp_flash_attention_matches_jax(ranks, jax_ref):
    for r, got in enumerate(ranks):
        heads = slice(r * H // 2, (r + 1) * H // 2)
        _close(got["flash"], jax_ref["flash"][:, :, heads], f"rank {r}")


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "sp"])
def test_tp_dropout_add_layernorm_matches_jax(ranks, jax_ref, sp):
    for r, got in enumerate(ranks):
        rows = slice(r * LN_L // 2, (r + 1) * LN_L // 2) if sp else slice(None)
        _close(got[f"ln_sp{int(sp)}"], jax_ref["ln"][int(sp)][:, rows], f"rank {r}")
    if not sp:  # model ranks hold the same rows and stay bitwise equal
        assert torch.equal(ranks[0]["ln_sp0"], ranks[1]["ln_sp0"])


def test_dropout_seed_per_rank_and_backward_regenerates_the_mask(ranks):
    from pl_bert_tpu_torch.parallel.tp import SEED_STRIDE

    seeds = [got["dropout"]["seed"] for got in ranks]
    assert seeds == [12345, 12345 + SEED_STRIDE]
    for got in ranks:
        d = got["dropout"]
        assert abs(float(d["kept"]) - 0.9) < 0.01
        torch.testing.assert_close(d["out"], d["out_plain"], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(d["dx"], d["dx_plain"], atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(d["dw"], d["dw_plain"], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_row_parallel_partial_product(dtype):
    """The row-parallel layer's partial product (models/albert.py): the
    fp32 product of the compute-dtype operands, and in the backward the
    gradients the layer's own compute-dtype backward gives (fp32
    products of the rounded output gradient, rounded once)."""
    from pl_bert_tpu_torch.models.albert import _PartialProduct

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32)).to(dtype).float()
    x.requires_grad_()
    w.requires_grad_()
    y = _PartialProduct.apply(x, w)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.detach().float() @ w.detach().float().T, atol=1e-5,
                               rtol=1e-6)
    dx, dw = torch.autograd.grad(y, [x, w], g)
    assert dx.dtype == dw.dtype == dtype
    torch.testing.assert_close(dx, (g @ w.detach().float()).to(dtype), atol=0, rtol=0)
    torch.testing.assert_close(
        dw, (g.reshape(-1, 16).T @ x.detach().float().reshape(-1, 32)).to(dtype), atol=0,
        rtol=0)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
