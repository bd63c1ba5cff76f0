"""The yardstick's operation and byte counts against hand-worked values
at small shapes."""

import numpy as np
import pytest

from port_bench import cost

MODEL = {"hidden_size": 8, "embedding_size": 4, "intermediate_size": 16, "num_hidden_layers": 2,
         "num_attention_heads": 2, "vocab_size": 10, "num_token_vocab": 0, "dropout": 0.1}


def test_batch_stats_packed_rows():
    # row 0: segments of 3 and 2 phonemes, then padding; row 1: one of 4
    seg = np.array([[0, 0, 0, 1, 1, -1], [0, 0, 0, 0, -1, -1]])
    labels = np.array([[5, 186, 6, 7, 186, 0], [5, 5, 186, 5, 0, 0]])
    s = cost.batch_stats({"lengths": np.array([5, 4]), "label_ids": labels,
                          "segment_ids": seg}, separator=186, masked_share=0.5)
    assert s == {"tokens": 9, "slots": 12, "seg_sq": 9 + 4 + 16, "masked": 0.5 * 6, "rows": 2}


def test_batch_stats_full_rows_count_their_masks():
    labels = np.ones((2, 4), np.int64)
    mask = np.array([[1, 0, 1, 0], [0, 0, 0, 1]], bool)
    s = cost.batch_stats({"lengths": np.array([4, 3]), "label_ids": labels,
                          "mask_positions": mask}, separator=186, masked_share=0.5)
    # no segments: a row attends over its whole length; the mask past a
    # row's length is not read
    assert (s["seg_sq"], s["masked"], s["tokens"]) == (16 + 9, 2, 7)


def test_dense_attention_and_head_flops():
    # a token: mapping 2·4·8 = 64; a layer 2·(8·24 + 8·8 + 2·8·16) = 1024
    assert cost.dense_flops(MODEL, 1) == 3 * (64 + 2 * 1024)
    assert cost.attention_flops(MODEL, 29) == 4 * 29 * 8
    assert cost.attention_flops(MODEL, 29, backward=True) == 8 * 29 * 8
    assert cost.head_flops(MODEL, 3, 10) == 3 * 2 * 3 * 8 * 10


def test_step_flops_sums_micro_batches():
    s = {"tokens": 9, "seg_sq": 29, "masked": 3.0, "slots": 12, "rows": 2}
    one = (cost.dense_flops(MODEL, 9) + 2 * (4 + 8) * 29 * 8 + cost.head_flops(MODEL, 3, 10))
    assert cost.step_flops(MODEL, [s, s]) == pytest.approx(2 * one)
    mt = dict(MODEL, num_token_vocab=100)
    assert cost.step_flops(mt, [s]) == pytest.approx(one + cost.head_flops(mt, 3, 100))


def test_kernel_bounds():
    s = {"tokens": 1000, "seg_sq": 50_000.0, "masked": 0.0, "slots": 1024, "rows": 2}
    H = 8
    k7 = max(4 * 50_000 * H / cost.PEAK_BF16, 4 * 1000 * H * 2 / cost.PEAK_BYTES)
    assert cost.kernel_bound_s("K7", MODEL, s) == pytest.approx(2 * k7)
    k8 = max(8 * 50_000 * H / cost.PEAK_BF16, 7 * 1000 * H * 2 / cost.PEAK_BYTES)
    assert cost.kernel_bound_s("K8", MODEL, s) == pytest.approx(2 * k8)
    stats = 2 * 2 * 2 * 512 * 4
    k3 = max((8 * 1000 * H * H + 4 * 50_000 * H) / cost.PEAK_BF16,
             (2 * 1000 * H * 2 + 4 * H * H * 2 + 4 * 1000 * H * 2 + stats) / cost.PEAK_BYTES)
    assert cost.kernel_bound_s("K3", MODEL, s) == pytest.approx(2 * k3)
    k4 = max((8 * 1000 * H * H + 8 * 50_000 * H) / cost.PEAK_BF16,
             (2 * 1000 * 4 * H * 2 + 4 * H * H * 2 + stats) / cost.PEAK_BYTES)
    assert cost.kernel_bound_s("K4", MODEL, s) == pytest.approx(2 * k4)
    # the LN kernels: two sites a layer, bytes-bound at this width
    assert cost.kernel_bound_s("K5", MODEL, s) == pytest.approx(
        2 * 2 * 3 * 1000 * H * 2 / cost.PEAK_BYTES)
    assert cost.kernel_bound_s("K6", MODEL, s) == pytest.approx(
        2 * 2 * 5 * 1000 * H * 2 / cost.PEAK_BYTES)
    with pytest.raises(ValueError):
        cost.kernel_bound_s("K9", MODEL, s)


def test_production_shape_magnitudes():
    """At the flagship widths a real token needs ~396 MFLOP of dense work
    (3 × 12 × 11.0 MFLOP and the embedding mapping)."""
    flagship = {"hidden_size": 768, "embedding_size": 128, "intermediate_size": 2048,
                "num_hidden_layers": 12}
    assert cost.dense_flops(flagship, 1) / 1e6 == pytest.approx(396.9, abs=0.1)
