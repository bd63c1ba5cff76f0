"""PyTorch port of the per-head flash attention (K7, K8) against the JAX
kernel (Pallas interpret mode on the CPU) and against itself.

On the CPU the port's wrappers run their plain versions. Tolerances:
fp32 rtol 1e-5 / atol 5e-6 (the gate of tests/test_flash_attention.py:
the same arithmetic in another summation order); bf16 one bf16 ulp of
the largest value (2^-8 relative: both sides round p and the output to
bf16 at the same points, after differently ordered fp32 sums).

The rule by which the bf16 kernels skip the tiles a packed row's segments
blank is held here on the CPU (``walked_tiles``); the kernels that follow
it are held against their plain versions on a CUDA card, in the tests
marked ``cuda``, which skip without one. On a machine with a card (no
JAX needed)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_flash_attention.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

try:  # the JAX kernels the CPU tests compare with; a card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from pl_bert_tpu.ops import flash_attention as jax_fa
    from pl_bert_tpu.ops.attention import xla_attention
except ImportError:
    jax = None

from pl_bert_tpu_torch.config import ModelParams
from pl_bert_tpu_torch.models.albert import build_model, init_params
from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.ops import flash_attention as fa
from pl_bert_tpu_torch.ops.attention import (
    IMPL_PATHS,
    fused_attention,
    kernel_refusal,
    resolve_impl,
)

B, L, H, D = 2, 128, 2, 64
FP32 = dict(rtol=1e-5, atol=5e-6)
BF16_ULP = 2.0 ** -8


def _inputs(seed=0, length=L, padding=False, segments=False, head_dim=D):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, length, H, head_dim)).astype(np.float32)
                  for _ in range(4))
    lengths = np.array([length, length * 3 // 5]) if padding else np.array([length] * B)
    valid = np.arange(length)[None, :] < lengths[:, None]
    bias = seg = None
    if padding:
        bias = ((1.0 - valid) * np.finfo(np.float32).min).astype(np.float32)[:, None, None, :]
    if segments:  # two packed samples a row, -1 at padding
        seg = np.where(valid, (np.arange(length)[None, :] >= length // 3), -1).astype(np.int32)
    return q, k, v, g, bias, seg


def _jax(q, k, v, g, bias, seg, dtype):
    """Forward and (dq, dk, dv) of the JAX kernel in interpret mode."""
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    jb = None if bias is None else jnp.asarray(bias)
    js = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, jb, js, out_dtype=dtype)

    with pltpu.force_tpu_interpret_mode():
        out = f(cast(q), cast(k), cast(v))
        grads = jax.grad(
            lambda q, k, v: (f(q, k, v).astype(jnp.float32) * jnp.asarray(g)).sum(),
            argnums=(0, 1, 2),
        )(cast(q), cast(k), cast(v))
    return [np.asarray(a, np.float32) for a in (out, *grads)]


def _port(q, k, v, g, bias, seg, dtype):
    tq, tk, tv = (torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(
        tq, tk, tv, None if bias is None else torch.tensor(bias),
        None if seg is None else torch.tensor(seg),
    )
    assert out.dtype == dtype and out.shape == tq.shape
    (out.float() * torch.tensor(g)).sum().backward()
    return [a.detach().float().numpy() for a in (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("padding,segments", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_flash_matches_jax_kernel_fp32(padding, segments):
    inputs = _inputs(padding=padding, segments=segments)
    for got, want in zip(_port(*inputs, torch.float32), _jax(*inputs, jnp.float32)):
        np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("padding", [False, True])
def test_flash_matches_jax_kernel_fp32_head_dim_128(padding):
    """head_dim 128, which the port's kernels take as JAX's do: the plain
    forward and backward against the Pallas kernel in interpret mode,
    with packed segments."""
    inputs = _inputs(seed=5, padding=padding, segments=True, head_dim=128)
    for got, want in zip(_port(*inputs, torch.float32), _jax(*inputs, jnp.float32)):
        np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("padding,segments", [(False, False), (True, True)])
def test_flash_matches_jax_kernel_bf16(padding, segments):
    inputs = _inputs(seed=1, padding=padding, segments=segments)
    for got, want in zip(_port(*inputs, torch.bfloat16), _jax(*inputs, jnp.bfloat16)):
        assert np.abs(got - want).max() <= BF16_ULP * np.abs(want).max()


def test_fully_masked_rows_stay_finite():
    """A row whose every key is masked (padding bias on all of them, and
    segment −1 everywhere) stays finite through the NEG clamp, forward
    and backward (tests/test_flash_attention.py:59)."""
    q, k, v, g, _, _ = _inputs(seed=2)
    bias = np.zeros((B, 1, 1, L), np.float32)
    bias[1] = np.finfo(np.float32).min
    seg = np.zeros((B, L), np.int32)
    seg[1] = -1
    for got, want in zip(_port(q, k, v, g, bias, seg, torch.float32),
                         _jax(q, k, v, g, bias, seg, jnp.float32)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **FP32)


def test_any_length_against_xla_attention():
    """L = 200 is no multiple of 128: the TPU gate
    (pl_bert_tpu/ops/attention.py:44) sends it to ``xla_attention``, the
    port's kernel path takes it — a deliberate difference."""
    q, k, v, _, bias, seg = _inputs(seed=3, length=200, padding=True, segments=True)
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                         jnp.asarray(seg), dtype=jnp.float32)
    got = fused_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.tensor(bias), torch.tensor(seg))
    # padded query rows carry no meaning (the kernels clamp the bias to
    # NEG, the einsum path does not): compare the real positions
    valid = seg >= 0
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **FP32)


def test_other_head_widths_raise_on_the_kernel_path():
    """head_dim 64 or 128 (the TPU takes any multiple of 64): the kernel's
    checks refuse another width, they do not fall back (the model picks
    the eager path for it when it is built). They run before any launch,
    so a CPU test can reach them."""
    q = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa._check(q.to("meta"), q.to("meta"), q.to("meta"), None, None)
    fake = torch.empty(0, device="meta")

    class Cuda:  # a tensor's facts, as _check reads them
        device = torch.device("cuda", 0)
        dtype = torch.float32
        shape = (1, 16, 2, 32)

        def dim(self):
            return 4

    with pytest.raises(ValueError, match=r"D in \(64, 128\)"):
        fa._check(Cuda(), fake, fake, None, None)
    Cuda.shape = (1, 16, 2, 96)
    with pytest.raises(ValueError, match=r"D in \(64, 128\)"):
        fa._check(Cuda(), fake, fake, None, None)
    Cuda.shape = (1, 16, 2, 128)  # taken: the width check passes, the next one reads k
    with pytest.raises(ValueError, match="flash_attention k"):
        fa._check(Cuda(), fake, fake, None, None)


def test_plain_backward_gradcheck_fp64():
    """The written-out backward (K8's formulas) is the gradient of the
    plain forward: ``autograd.gradcheck`` in fp64 at a tiny shape, with
    padding and segments."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 12, 2, 8, dtype=torch.float64, generator=gen).requires_grad_()
               for _ in range(3))
    # the last two keys are padding; every query keeps some key (a row
    # with none has a constant score, whose true gradient is 0)
    bias = torch.zeros(1, 1, 1, 12)
    bias[..., 10:] = torch.finfo(torch.float32).min
    seg = torch.tensor([[0] * 4 + [1] * 8], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, bias, seg), (q, k, v), fast_mode=True)


def test_dropout_forward_and_backward_share_one_mask():
    """With dropout 0.1 the plain forward and backward regenerate one
    mask from the seed: a finite-difference check with the mask fixed
    (fp64), the keep rate is 0.9 ± 0.01, and another seed drops other
    elements."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 12, 2, 8, dtype=torch.float64, generator=gen).requires_grad_()
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, dropout_rate=0.1, dropout_seed=5),
        (q, k, v), fast_mode=True)
    keep = ab.dropout_keep(5, 0.1, 4, 8, 128)
    assert abs(float(keep.float().mean()) - 0.9) < 0.01
    assert not torch.equal(keep, ab.dropout_keep(6, 0.1, 4, 8, 128))
    a = fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=5)
    assert torch.equal(a, fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=5))
    assert not torch.equal(a, fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=6))
    # no seed means rate 0 (pl_bert_tpu/ops/flash_attention.py:219-221)
    assert torch.equal(fa.flash_attention(q, k, v, dropout_rate=0.1),
                       fa.flash_attention(q, k, v))


@pytest.mark.parametrize("impl,path", [
    ("auto", "block"), ("kernel", "block"), ("pallas_block", "block"), ("pallas", "flash"),
    ("eager", "eager"), ("xla", "eager"),
])
def test_resolve_impl_maps_each_config_value_to_its_path(impl, path):
    assert resolve_impl(impl) == path and IMPL_PATHS[impl] == path


@pytest.mark.parametrize("impl", ["auto", "kernel", "pallas_block", "pallas", "xla"])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resolve_impl_falls_back_where_the_kernels_do_not_take_the_shape(impl, head_dim, dtype):
    """With the model's shapes a kernel path whose kernels do not take
    them goes to ``eager``, as JAX's ``_resolve_impl`` goes to ``xla``:
    head_dim 64 and 128 keep their path (12 heads, width 768 or 1536),
    head_dim 32 falls back and ``kernel_refusal`` says why."""
    width = 12 * head_dim
    path = resolve_impl(impl, head_dim, width, dtype)
    if head_dim == 32 and IMPL_PATHS[impl] != "eager":
        assert path == "eager"
        assert "head_dim 32" in kernel_refusal(head_dim, width, dtype)
    else:
        assert path == IMPL_PATHS[impl]
        assert head_dim == 32 or kernel_refusal(head_dim, width, dtype) is None


def test_kernel_refusal_names_widths_the_kernels_cannot_read():
    """A width that is no whole number of heads, or in bf16 no multiple
    of 8 (TMA's 16-byte rows), is refused; fp32 takes any whole width."""
    assert "whole number" in kernel_refusal(64, 130, torch.float32)
    assert kernel_refusal(64, 128, torch.bfloat16) is None
    assert resolve_impl("auto", 64, 130, torch.float32) == "eager"


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_flagship_and_narrow_heads_resolve_when_the_model_is_built(impl, caplog):
    """The flagship shape (12 heads of 64) keeps its kernel path; 12
    heads of 32 build, run the eager path, and the model logs why."""
    import logging

    base = ModelParams(hidden_size=384, num_attention_heads=12, intermediate_size=256,
                       max_position_embeddings=64, num_hidden_layers=1, embedding_size=32,
                       attention_impl=impl)
    with caplog.at_level(logging.INFO, logger="pl_bert_tpu_torch.models.albert"):
        narrow = build_model(base, "bf16")
    assert narrow.encoder.encoder.layer.attention.impl == "eager"
    assert any("falls back to the eager path" in r.message and "head_dim 32" in r.message
               for r in caplog.records)
    flagship = build_model(dataclasses.replace(base, hidden_size=768), "bf16")
    assert flagship.encoder.encoder.layer.attention.impl == IMPL_PATHS[impl]
    ids = torch.arange(64)[None].repeat(2, 1) % 100
    out = init_params(narrow, seed=1)(ids, torch.ones(2, 64, dtype=torch.int32))
    assert out.shape == (2, 64, 188) and torch.isfinite(out).all()


def test_resolve_impl_refuses_unknown_values():
    with pytest.raises(ValueError, match="unsupported attention_impl"):
        resolve_impl("flashier")


def _layer_model(impl, dropout):
    mp = ModelParams(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
                     dropout=dropout, attention_impl=impl)
    return init_params(build_model(mp, "fp32"), seed=3)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_flash_path_and_block_path_of_a_layer_agree(dropout):
    """Same weights, same seeds: the flash path (K7/K8 between cuBLAS
    projections) and the block path drop the same probabilities and
    return the same hidden states and gradients (fp32, other summation
    order: rtol 1e-4 / atol 1e-5), and each runs its own wrappers only."""
    rng = np.random.default_rng(4)
    hidden = torch.tensor(rng.standard_normal((2, 64, 128)).astype(np.float32))
    mask = torch.ones(2, 64, dtype=torch.int32)
    mask[1, 40:] = 0
    seg = torch.where(mask.bool(), (torch.arange(64)[None] >= 20).int(), -1)
    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask

    outs = {}
    for impl in ("auto", "pallas"):
        model = _layer_model(impl, dropout)
        attn = model.encoder.encoder.layer.attention
        calls = []
        for mod, name in ((fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
                          (ab, "train_forward"), (ab, "train_backward")):
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _name=name, **kw):
                calls.append(_name)
                return _orig(*a, **kw)

            setattr(mod, name, spy)
        try:
            x = hidden.clone().requires_grad_()
            w = model.encoder.train_weights()["encoder"]["layer"]["attention"]
            seeds = (11, 12, 13) if dropout else (None, None, None)
            out = attn(x, attention_bias_from_mask(mask), seg, w, seeds)
            out.square().sum().backward()
        finally:
            for mod, name in ((fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
                              (ab, "train_forward"), (ab, "train_backward")):
                setattr(mod, name, getattr(mod, name).__kwdefaults__["_orig"])
        want = (["flash_attention_fwd", "flash_attention_bwd"] if impl == "pallas"
                else ["train_forward", "train_backward"])
        assert calls == want
        outs[impl] = (out.detach(), x.grad, attn.query.weight.grad, attn.dense.weight.grad)
    for a, b in zip(outs["pallas"], outs["auto"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_one_state_dict_drives_all_three_paths():
    base = _layer_model("auto", 0.0)
    ids = torch.arange(64)[None].repeat(2, 1) % 100
    mask = torch.ones(2, 64, dtype=torch.int32)
    want = base(ids, mask)
    for impl in ("pallas", "xla"):
        other = build_model(dataclasses.replace(
            ModelParams(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                        max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
                        dropout=0.0), attention_impl=impl), "fp32")
        other.load_state_dict(base.state_dict(), strict=True)
        np.testing.assert_allclose(other(ids, mask).detach().numpy(), want.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)


# --- the tiles the bf16 kernels walk on packed rows ---------------------------


def _walk_sets(walked):
    """{query tile: the key tiles walked} of one row of ``walked_tiles``."""
    return {q: set(np.flatnonzero(row).tolist()) for q, row in enumerate(walked)}


ALL4 = {0, 1, 2, 3}


@pytest.mark.parametrize("seg,lengths,walks", [
    # two segments across the tile edges, a padded tail: the tail tile walks all
    ([0] * 100 + [1] * 100 + [-1] * 56, 200, {0: {0, 1}, 1: ALL4, 2: {1, 2, 3}, 3: ALL4}),
    # one-token segments: only the diagonal
    (list(range(256)), 256, {q: {q} for q in range(4)}),
    # ids reused out of order: walks that are not intervals
    ([0] * 64 + [1] * 64 + [0] * 64 + [1] * 64, 256, {0: {0, 2}, 1: {1, 3}, 2: {0, 2}, 3: {1, 3}}),
    # one segment: every pair
    ([7] * 256, 256, {q: ALL4 for q in range(4)}),
    # all padding but one token: every query tile holds padding
    ([0] + [-1] * 255, 1, {q: ALL4 for q in range(4)}),
    # rows past L are no padding: L = 100, two tiles
    ([0] * 50 + [1] * 50, 100, {0: {0, 1}, 1: {0, 1}}),
    # three segments inside one tile, the next tiles apart
    ([0] * 20 + [1] * 20 + [2] * 88 + [3] * 128, 256, {0: {0, 1}, 1: {0, 1}, 2: {2, 3},
                                                       3: {2, 3}}),
])
def test_walked_tiles_of_hand_made_rows(seg, lengths, walks):
    seg = np.array([seg])
    open_rows = np.arange(seg.shape[1])[None] < lengths
    assert _walk_sets(fa.walked_tiles(seg, open_rows)[0]) == walks
    total = sum(len(w) for w in walks.values())
    assert fa.flash_tile_share(seg, np.array([lengths])) == total / len(walks) ** 2


def test_a_closed_bias_makes_its_query_tile_walk_every_key_tile():
    """A real row whose key the padding bias closes may see nothing but
    masked scores, so its tile walks every key tile, as a padding row's;
    no bias (``open_rows`` None) closes nothing."""
    seg = np.array([[0] * 64 + [1] * 64])
    open_rows = np.ones((1, 128), bool)
    open_rows[0, 70] = False
    assert _walk_sets(fa.walked_tiles(seg, open_rows)[0]) == {0: {0}, 1: {0, 1}}
    assert _walk_sets(fa.walked_tiles(seg)[0]) == {0: {0}, 1: {1}}
    # leading axes (stacked micro-batches) fold into the rows
    stacked = np.stack([np.concatenate([seg, seg]), np.concatenate([seg, seg])])
    assert fa.walked_tiles(stacked).shape == (4, 2, 2)


def _packed_layout(rng, L, reuse=False):
    """One random row: segments of 1-90 tokens (ids ascending, or drawn
    from 0-3 with ``reuse``), then padding; → (segment ids, length)."""
    length = int(rng.integers(1, L + 1)) if rng.random() < 0.7 else L
    seg = np.full(L, -1, np.int64)
    at, sid = 0, 0
    while at < length:
        n = int(rng.integers(1, 91))
        seg[at:min(at + n, length)] = int(rng.integers(0, 4)) if reuse else sid
        at, sid = at + n, sid + 1
    return seg, length


@pytest.mark.parametrize("L", [64, 130, 200, 512])
def test_monotone_rows_walk_contiguous_intervals(L):
    """On rows whose segment ids ascend (as packing lays them out), each
    query tile walks an interval of key tiles that holds its own."""
    rng = np.random.default_rng(L)
    rows = [_packed_layout(rng, L) for _ in range(64)]
    seg = np.stack([r[0] for r in rows])
    open_rows = np.arange(L)[None] < np.array([r[1] for r in rows])[:, None]
    for walked in fa.walked_tiles(seg, open_rows):
        for own, row in enumerate(walked):
            idx = np.flatnonzero(row)
            assert own in idx
            assert (np.diff(idx) == 1).all()


@pytest.mark.parametrize("reuse", [False, True])
@pytest.mark.parametrize("L", [150, 200, 320, 448])
def test_no_visible_pair_falls_in_a_skipped_tile(L, reuse):
    """Brute force over [L, L] on random rows (ids reused and out of order
    too, open rows closed at random): every query row that is padding or
    closed walks every key tile, and every pair of one segment lies in a
    walked tile; and every probability the plain version gives in a
    skipped tile is exactly 0, so skipping it adds exact zeros."""
    rng = np.random.default_rng(L + 7 * reuse)
    rows = [_packed_layout(rng, L, reuse) for _ in range(12)]
    seg = np.stack([r[0] for r in rows])
    open_rows = np.arange(L)[None] < np.array([r[1] for r in rows])[:, None]
    open_rows &= rng.random((len(rows), L)) > 0.02
    walked = fa.walked_tiles(seg, open_rows)
    tiles = np.arange(L) // fa.TILE
    pair_walked = walked[:, tiles[:, None], tiles[None, :]]  # [R, L, L]
    blind = (seg < 0) | ~open_rows
    assert pair_walked[blind].all()
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0)
    assert pair_walked[same].all()
    assert not pair_walked.all()  # the rule skips something on these rows
    bias = torch.from_numpy(np.where(open_rows, 0.0, np.finfo(np.float32).min)
                            .astype(np.float32))
    bias_row, seg_row = ab.rows(bias[:, None, None, :], torch.from_numpy(seg), len(rows), L)
    gen = torch.Generator().manual_seed(L)
    q, k = (torch.randn(len(rows), L, 2, 64, generator=gen) for _ in range(2))
    p = fa._probs(q, k, bias_row, seg_row)
    skipped = torch.from_numpy(~pair_walked)[:, None].expand_as(p)
    assert (p[skipped] == 0).all()


def test_metrics_logger_writes_the_mean_tile_share(tmp_path):
    from pl_bert_tpu_torch.training.metrics import MetricsLogger

    m = MetricsLogger(str(tmp_path), log_interval=2)
    for step, share in ((1, 0.4), (2, 0.5), (3, None), (4, None)):
        m.log_step(step, 1, {"loss": 1.0}, 10, flash_tile_share=share)
    m.close()
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert records[0]["flash_tile_share"] == pytest.approx(0.45)
    assert "flash_tile_share" not in records[1]


def test_trainer_tile_share_needs_segments():
    from pl_bert_tpu_torch.data.collate import Batch
    from pl_bert_tpu_torch.training.train import tile_share

    seg = np.array([[0] * 100 + [1] * 100 + [-1] * 56])
    assert tile_share({"segment_ids": seg, "lengths": np.array([200])}) == 13 / 16
    assert tile_share({"lengths": np.array([200])}) is None
    batch = Batch(*(np.zeros((1, 256), np.int32) for _ in range(4)), lengths=np.array([200]))
    assert tile_share(batch) is None


# --- the bf16 kernels on a card (marked cuda: skip without one) ----------------

# test_torch_cuda.py's gates of the kernels against their plain versions:
# max-abs as a share of the largest reference value, and relative L2
CARD_BF16 = (6e-2, 1e-2)
LAYOUTS = ["crossing", "one_token", "one_segment", "padded_tail", "all_pad_but_one",
           "reused_ids"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_layout(name, L, seed):
    """Three rows of one layout: (segment ids [3, L], lengths [3])."""
    rng = np.random.default_rng(seed)
    seg = np.full((3, L), -1, np.int64)
    lengths = [L, L, L]

    def fill(r, length, sizes, ids=None):
        at = 0
        for i, n in enumerate(sizes):
            if at >= length:
                break
            seg[r, at:min(at + n, length)] = i if ids is None else ids[i]
            at += n
        lengths[r] = length

    many = lambda lo, hi: rng.integers(lo, hi, size=L).tolist()  # noqa: E731
    if name == "crossing":  # segments across tile edges, one row full
        fill(0, L, many(20, 150))
        fill(1, L - 37, many(20, 150))
        fill(2, L * 2 // 3, many(60, 100))
    elif name == "one_token":
        fill(0, L, [1] * L)
        fill(1, L, [1] * 40 + many(2, 9))
        fill(2, L - 11, [1] * L)
    elif name == "one_segment":
        fill(0, L, [L])
        fill(1, L * 2 // 3, [L])
        fill(2, 65, [L])
    elif name == "padded_tail":
        fill(0, L - 1, many(30, 90))
        fill(1, L // 2 + 7, many(30, 90))
        fill(2, 65, many(30, 90))
    elif name == "all_pad_but_one":  # and a row with no token at all
        fill(0, 1, [1])
        fill(1, L - 5, many(10, 70))
        fill(2, 0, [])
    else:  # reused_ids: ids drawn from 0-3, out of order and repeated
        ids = rng.integers(0, 4, size=L).tolist()
        fill(0, L, many(5, 80), ids)
        fill(1, L - 21, many(5, 80), ids[::-1])
        fill(2, L // 3, many(1, 20), ids)
    return seg, np.array(lengths)


def _card_case(dev, layout, L, D, H=2, seed=0):
    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask

    seg, lengths = _card_layout(layout, L, seed)
    gen = torch.Generator(dev).manual_seed(seed + L + D)
    q, k, v, dout = (torch.randn(3, L, H, D, device=dev, generator=gen).to(torch.bfloat16)
                     for _ in range(4))
    valid = torch.from_numpy(np.arange(L)[None] < lengths[:, None]).to(dev)
    bias_row, seg_row = ab.rows(attention_bias_from_mask(valid),
                                torch.from_numpy(seg).to(dev), 3, L)
    return q, k, v, dout, bias_row, seg_row


def _card_close(got, ref):
    share, rel = CARD_BF16
    g, r = got.float(), ref.float()
    assert torch.isfinite(g).all()
    assert (g - r).abs().max() <= share * max(1.0, float(r.abs().max()))
    assert (g - r).norm() / r.norm() <= rel


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [200, 512])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tile_skipping_kernels_match_plain(dev, layout, L, D, rate):
    """K7 and K8 in bf16, which walk only the tiles the segments can see,
    against their plain versions, which form every score, on packed rows
    of each layout; the plain ones drop with the kernels' own mask."""
    q, k, v, dout, bias_row, seg_row = _card_case(dev, layout, L, D)
    seed = 23 if rate else None
    keep = ab.dropout_mask(23, rate, 3, 2, L, dev) if rate else None
    out = fa.flash_attention_fwd(q, k, v, bias_row, seg_row, rate, seed)
    grads = fa.flash_attention_bwd(dout, q, k, v, bias_row, seg_row, rate, seed)
    ref = fa.flash_attention_plain(q, k, v, bias_row, seg_row, rate, seed, keep=keep)
    rgrads = fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, seg_row, rate, seed,
                                          keep=keep)
    torch.cuda.synchronize()
    for got, want in [(out, ref), *zip(grads, rgrads)]:
        _card_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("layout", ["crossing", "reused_ids", "all_pad_but_one"])
def test_tile_skipping_kernels_repeat_bit_for_bit(dev, layout, D):
    """Two calls on the same inputs give the same bits: o, dq, dk, dv and
    the recomputed row max and denominator."""
    q, k, v, dout, bias_row, seg_row = _card_case(dev, layout, 512, D, H=4, seed=3)
    runs = [(fa.flash_attention_fwd(q, k, v, bias_row, seg_row, 0.1, 29),
             *fa._launch_bwd(dout, q, k, v, bias_row, seg_row, 0.1, 29)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
