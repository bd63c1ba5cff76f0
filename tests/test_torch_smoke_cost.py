"""The cost model of ``chip_smoke.py``, which sets every kernel's
``bound_ms``: the attention block's FLOPs, split into its projection
GEMMs and its attention pass, and bytes, pinned against counts worked
out by hand at the flagship width (E = P = 768, 12 heads of 64, L 512).
``chip_smoke`` imports torch only inside its functions, so it loads here."""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

E = P = 768
L = 512


@pytest.mark.parametrize("B,gemm,attention", [
    # M = B·L rows. GEMMs: x·[Wq|Wk|Wv] is 2·M·E·3P, ctx·Wo 2·M·P·E.
    # Attention: q·k and p·v, 2·L·L·D each, for B·H (batch, head) pairs.
    (8, 2 * 4096 * 768 * 2304 + 2 * 4096 * 768 * 768, 2 * 2 * 512 * 512 * 64 * 8 * 12),
    (96, 2 * 49152 * 768 * 2304 + 2 * 49152 * 768 * 768, 2 * 2 * 512 * 512 * 64 * 96 * 12),
])
@pytest.mark.parametrize("kind", ["light", "train"])
def test_block_cost_splits_the_forward(B, gemm, attention, kind):
    cost = smoke.block_cost(B, L, E, P, 2, kind)
    assert cost["gemm"] == gemm
    assert cost["attention"] == attention
    total = {8: 25.8e9, 96: 309e9}[B]  # PERF.md's K1 and K3 rows
    assert cost["gemm"] + cost["attention"] == pytest.approx(total, rel=2e-3)


@pytest.mark.parametrize("kind,nbytes", [
    # x read and the output written (B·L·E bf16 each), the four weights
    ("light", 2 * 8 * 512 * 768 * 2 + 4 * 768 * 768 * 2),
    # ... and K3's saved qkv and ctx (4·B·L·P bf16) and m, l (2·B·H·L fp32)
    ("train", 2 * 8 * 512 * 768 * 2 + 4 * 768 * 768 * 2 + 4 * 8 * 512 * 768 * 2
     + 2 * 8 * 12 * 512 * 4),
])
def test_block_cost_bytes(kind, nbytes):
    cost = smoke.block_cost(8, L, E, P, 2, kind)
    assert cost["bytes"] == nbytes
    # the parts: the projections move x, ctx, qkv, the output and the
    # weights; the attention reads qkv and writes ctx (and m, l for K3)
    assert cost["gemm_bytes"] == (2 * 4096 * 768 + 4 * 4096 * 768) * 2 + 4 * 768 * 768 * 2
    assert cost["attention_bytes"] == 4 * 4096 * 768 * 2 + (
        2 * 8 * 12 * 512 * 4 if kind == "train" else 0)


def test_backward_cost_is_pr3s_425_gflop():
    cost = smoke.block_cost(96, L, E, P, 2, "backward")
    assert cost["gemm"] == 8 * 49152 * 768 * 768
    assert cost["attention"] == 10 * 49152 * 512 * 768
    assert cost["gemm"] + cost["attention"] == pytest.approx(425.2e9, rel=1e-3)


def test_backward_cost_splits_its_bytes():
    """K4's parts at B=96: the projections read dout, dqkv and the weights
    and write do and dx; the attention reads qkv, do and m, l and writes
    dqkv. Together they move more than the block (do crosses twice)."""
    M = 96 * 512
    cost = smoke.block_cost(96, L, E, P, 2, "backward")
    assert cost["gemm_bytes"] == (2 * M * 768 + 4 * M * 768) * 2 + 4 * 768 * 768 * 2
    assert cost["attention_bytes"] == 7 * M * 768 * 2 + 2 * 96 * 12 * 512 * 4
    assert cost["gemm_bytes"] + cost["attention_bytes"] > cost["bytes"]


@pytest.mark.parametrize("flops,nbytes,peak,want", [
    # K1 at [8, 512, 768]: 25.8 GFLOP over 989 TFLOP/s beats 17.3 MB over 3.35 TB/s
    (25_769_803_776, 17_301_504, smoke.PEAK_BF16_FLOPS, (0.026056, "operations")),
    # K2, the same work in fp32 at 67 TFLOP/s
    (25_769_803_776, 34_603_008, smoke.PEAK_FP32_FLOPS, (0.384624, "operations")),
    # K1's attention pass alone: 6.4 GFLOP against 25.2 MB of qkv and ctx
    (6_442_450_944, 25_165_824, smoke.PEAK_BF16_FLOPS, (0.0075122, "bytes")),
])
def test_bound_ms_takes_the_larger_of_operations_and_bytes(flops, nbytes, peak, want):
    ms, by = smoke.bound_ms(flops, nbytes, peak)
    assert by == want[1]
    assert ms == pytest.approx(want[0], rel=1e-4)


def test_block_bound_sums_the_parts():
    cost = smoke.block_cost(8, L, E, P, 2)
    assert smoke.block_bound(cost) == smoke.bound_ms(25_769_803_776, cost["bytes"])


def test_cuda_core_backward_forms_seven_products_a_head():
    """K4's CUDA-core plan at B=96: the delta pass forms q·k and do·vᵀ,
    the dk/dv kernel q·k, do·vᵀ, pdᵀ·do and dsᵀ·q, the dq GEMM ds·k --
    seven L²·D products a (batch, head), 2 FLOP each, where the gradient
    needs five (the "attention" count)."""
    M, heads = 96 * L, 12
    cost = smoke.block_cost(96, L, E, P, 2, "backward_simt")
    per_product = 2 * L * L * 64 * 96 * heads
    formed = cost["formed"]
    assert formed["delta"] == 2 * per_product
    assert formed["dkdv"] == 4 * per_product
    assert formed["dq"] == per_product
    products = (formed["delta"] + formed["dkdv"] + formed["dq"]) / per_product
    assert products == 7 <= 7
    assert cost["attention"] == 5 * per_product
    assert formed["do"] == 2 * M * E * P
    # what the "backward" kind says of the block is unchanged
    assert {k: v for k, v in cost.items() if k != "formed"} == smoke.block_cost(
        96, L, E, P, 2, "backward")


@pytest.mark.parametrize("part,flops,want_ms", [
    # the attention's five products, 193 GFLOP, at the fp32 rate
    ("attention", 10 * 49152 * 512 * 768, 2.8846),
    # do = dout·Woᵀ, 58 GFLOP
    ("do", 2 * 49152 * 768 * 768, 0.86539),
])
def test_cuda_core_bound_of_the_backward(part, flops, want_ms):
    cost = smoke.block_cost(96, L, E, P, 2, "backward_simt")
    got = cost["attention"] if part == "attention" else cost["formed"]["do"]
    assert got == flops
    nbytes = cost["attention_bytes"] if part == "attention" else cost["gemm_bytes"]
    ms, by = smoke.bound_ms(got, nbytes, smoke.PEAK_FP32_FLOPS)
    assert by == "operations"
    assert ms == pytest.approx(want_ms, rel=1e-4)


@pytest.mark.parametrize("draws,imad,want_ms,want_by", [
    # K6 at [49152, 768] bf16: 5 x 37.7M x 2 bytes = 377 MB over 3.35 TB/s
    (0, 20.0, 0.112683, "bytes"),
    # dropout 0.1, 20 IMAD a draw: 37.7M x 20 over 64 x 132 x 1980 MHz = 0.0451 ms
    (49152 * 768, 20.0, 0.112683, "bytes"),
    # 60 IMAD a draw would make the integer pipe the bound: 0.1354 ms
    (49152 * 768, 60.0, 0.135405, "operations"),
])
def test_k6_bound_takes_the_largest_term(draws, imad, want_ms, want_by):
    # K6 moves five [N, H] passes (x, res, dy read; dx, dres written), ~20 flops an element
    ms, by, terms = smoke.ln_bound(49152, 768, 2, 5, 20.0, draws, {"imad": imad, "lop3": 12.0},
                                   132, 1980.0)
    assert terms["bytes"] == pytest.approx(377_487_360 / 3.35e12 * 1e3, rel=1e-9)
    assert terms["fp32"] == pytest.approx(20 * 37_748_736 / 67e12 * 1e3, rel=1e-9)
    # the busier of the two integer pipes, IMAD here, sets the integer term
    assert terms["integer"] == pytest.approx(draws * imad / (64 * 132 * 1.98e9) * 1e3, rel=1e-9)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=1e-4) == max(terms.values())


@pytest.mark.parametrize("draws,want_ms,want_by", [
    # K5 at [49152, 768] bf16: x and res read, out written, 3 x 37.7M x 2 bytes
    # = 226 MB over 3.35 TB/s
    (0, 0.067610, "bytes"),
    # dropout 0.1 at 20 IMAD a draw: the integer term 0.0451 ms stays below it
    (49152 * 768, 0.067610, "bytes"),
])
def test_k5_bound_takes_the_largest_term(draws, want_ms, want_by):
    ms, by, terms = smoke.ln_bound(49152, 768, 2, 3, 10.0, draws, {"imad": 20.0, "lop3": 19.0},
                                   132, 1980.0)
    assert terms["bytes"] == pytest.approx(226_492_416 / 3.35e12 * 1e3, rel=1e-9)
    assert terms["fp32"] == pytest.approx(10 * 37_748_736 / 67e12 * 1e3, rel=1e-9)
    assert terms["integer"] == pytest.approx(draws * 20.0 / (64 * 132 * 1.98e9) * 1e3, rel=1e-9)
    assert by == want_by
    assert ms == pytest.approx(want_ms, rel=1e-4) == max(terms.values())


@pytest.mark.parametrize("mangled,label", [
    ("_ZN44_GLOBAL__N__35f85fe7_11_fused_ln_cu_b894cab86ln_fwdI13__nv_bfloat16Li3ELb1EEEvNS_9"
     "LnFwdArgsE", "ln_fwd<bf16, 3, 1>"),
    ("_ZN44_GLOBAL__N__35f85fe7_11_fused_ln_cu_b894cab86ln_fwdIfLi8ELb0EEEvNS_9LnFwdArgsE",
     "ln_fwd<f32, 8, 0>"),
    ("_ZN44_GLOBAL__N__35f85fe7_11_fused_ln_cu_b894cab86ln_bwdI13__nv_bfloat16Li3ELb0EEEvNS_9"
     "LnBwdArgsE", "ln_bwd<bf16, 3, 0>"),
    ("_ZN44_GLOBAL__N__35f85fe7_11_fused_ln_cu_b894cab813ln_bwd_reduceEPKfiiPf", "ln_bwd_reduce"),
])
def test_ln_label_names_the_fused_ln_kernels(mangled, label):
    """Phase 2 reads K5's and K6's registers and SASS by these labels
    (mangled names as ptxas and cuobjdump print them on the card)."""
    assert smoke.ln_label(mangled) == label
