"""The reference's step against a hand-rolled fp64 step at a tiny width,
its dropout streams against Philox's published answer and the program's
documented plain streams, and its data derivation against the
program's feed."""

import math

import numpy as np
import pytest
import torch

from port_bench import feed, philox
from port_bench.reference import Reference
from port_bench.weights import layer_name, make_weights

MODEL = {"hidden_size": 8, "num_attention_heads": 2, "intermediate_size": 12,
         "max_position_embeddings": 6, "num_hidden_layers": 2, "dropout": 0.0,
         "embedding_size": 4, "vocab_size": 188, "num_token_vocab": 7, "layer_norm_eps": 1e-12,
         "initializer_range": 0.02, "type_vocab_size": 2}
TRAIN = {"learning_rate": 1e-3, "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8,
         "weight_decay": 0.01}
DATA = {"ondevice_masking": False}


def _batch(gen):
    B, L = 3, 6
    labels = torch.randint(1, 180, (B, L), generator=gen)
    mask = torch.rand((B, L), generator=gen) < 0.4
    mask[0, 0] = True
    mask[2] = False  # a row without masks counts for nothing
    return {"masked_ids": torch.where(mask, 185, labels).numpy(), "label_ids": labels.numpy(),
            "mask_positions": mask.numpy(), "lengths": np.array([6, 4, 5]),
            "segment_ids": np.array([[0, 0, 0, 1, 1, 1], [0, 0, 1, 1, -1, -1],
                                     [0, 0, 0, 0, 0, -1]]),
            "position_ids": np.array([[0, 1, 2, 0, 1, 2], [0, 1, 0, 1, 0, 0],
                                      [0, 1, 2, 3, 4, 0]]),
            "token_ids": torch.randint(0, 7, (B, L), generator=gen).numpy()}


def _fp64_loss(P, b):
    """PL-BERT's loss of one batch, written out in fp64."""
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    B, L = t["label_ids"].shape
    H, nh = MODEL["hidden_size"], MODEL["num_attention_heads"]
    D = H // nh

    def lin(x, name):
        return x @ P[name + ".weight"].T + P[name + ".bias"]

    def ln(x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-12) * P[name + ".weight"] + P[name + ".bias"]

    x = (P["encoder.embeddings.word_embeddings.weight"][t["masked_ids"]]
         + P["encoder.embeddings.position_embeddings.weight"][t["position_ids"]]
         + P["encoder.embeddings.token_type_embeddings.weight"][0])
    h = lin(ln(x, "encoder.embeddings.LayerNorm"), "encoder.encoder.embedding_hidden_mapping_in")
    valid = torch.arange(L)[None] < t["lengths"][:, None]
    seg = t["segment_ids"]
    allowed = valid[:, :, None] & valid[:, None, :] & (seg[:, :, None] == seg[:, None, :])
    for _ in range(MODEL["num_hidden_layers"]):
        q, k, v = (lin(h, layer_name(f"attention.{n}")).view(B, L, nh, D).transpose(1, 2)
                   for n in ("query", "key", "value"))
        s = q @ k.transpose(-1, -2) / math.sqrt(D)
        s = s.masked_fill(~allowed[:, None], -1e300)
        ctx = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, L, H)
        a = ln(lin(ctx, layer_name("attention.dense")) + h, layer_name("attention.LayerNorm"))
        f = lin(torch.nn.functional.gelu(lin(a, layer_name("ffn")), approximate="tanh"),
                layer_name("ffn_output"))
        h = ln(f + a, layer_name("full_layer_layer_norm"))
    m = t["mask_positions"] & valid
    total = 0.0
    for head, labels in (("phoneme_predictor", t["label_ids"]), ("token_predictor", t["token_ids"])):
        nll = -torch.log_softmax(lin(h, head), -1).gather(-1, labels[..., None])[..., 0]
        per_row = [nll[r][m[r]].mean() for r in range(B) if m[r].any()]
        total = total + sum(per_row) / len(per_row)
    return total


def test_reference_step_is_the_fp64_step():
    gen = torch.Generator().manual_seed(0)
    weights = make_weights(MODEL, 3, "cpu")
    weights = {n: w + 0.05 * torch.randn(w.shape, generator=gen) for n, w in weights.items()}
    ref = Reference(MODEL, TRAIN, DATA, weights, block_rows=2)
    P = {n: w.double().clone().requires_grad_(True) for n, w in weights.items()}
    moments = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in P.items()}
    for step in range(2):
        batch = _batch(gen)
        loss = ref.step([batch], step, seed=1)
        for p in P.values():
            p.grad = None
        loss64 = _fp64_loss(P, batch)
        loss64.backward()
        # fp32 sums of a few hundred terms: ~1e-6 relative
        assert loss == pytest.approx(float(loss64.detach()), rel=1e-5)
        grads = ref.grads()
        for n, p in P.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            assert torch.allclose(grads[n].double(), g, rtol=1e-4, atol=1e-7), n
        with torch.no_grad():  # AdamW, decoupled decay on all but the pooler
            for n, p in P.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                mu, nu = moments[n]
                mu.mul_(0.9).add_(0.1 * g)
                nu.mul_(0.999).add_(0.001 * g * g)
                u = (mu / (1 - 0.9 ** (step + 1))) / (
                    torch.sqrt(nu / (1 - 0.999 ** (step + 1))) + 1e-8)
                if "pooler" not in n:
                    u = u + 0.01 * p
                p.add_(-1e-3 * u)
    for n, p in P.items():
        # a coordinate with a gradient near 0 moves by a rate's worth on
        # either side of it: the moved parameters agree to a few ulps of lr
        assert torch.allclose(ref.params[n].double(), p.detach(), rtol=1e-5, atol=2e-6), n


def test_philox_known_answer():
    """Random123's known answer for Philox4x32-10 at key 0, counter 0."""
    assert int(philox.word0(0, 0, torch.tensor(0), 0)) == 0x6627E8D5


def test_dropout_streams_are_the_programs():
    from pl_bert_tpu_torch.ops import attention_block, fused_ln

    B, H, L = 2, 3, 5
    keep = attention_block.dropout_keep(1234567, 0.1, B, H, L)
    b, h, q, k = torch.meshgrid(*(torch.arange(n) for n in (B, H, L, L)), indexing="ij")
    assert torch.equal(philox.attention_keep(1234567, 0.1, b * H + h, q, k), keep)
    offsets = torch.arange(4096)
    assert torch.equal(philox.layernorm_keep(2**31 - 5, 0.1, offsets),
                       fused_ln.tl_rand_keep(2**31 - 5, offsets, 0.1))


@pytest.mark.parametrize("packing", [True, False])
def test_feed_derivation_is_the_programs(packing):
    """``feed.py``'s batches are the program's data plane's for one
    corpus and seed."""
    from pl_bert_tpu_torch.data.packed import PackedSequenceDataset
    from pl_bert_tpu_torch.data.pipeline import build_dataloader, split_train_val
    from port_bench.corpus import make_corpus

    spec = {"samples": 300, "phonemes_per_word": [2, 10], "alphabet": "abdfhijklmnopq",
            "token_vocab": [5, 500], "shape_seed": 0}
    spec.update({"words_per_sample": [2, 9]} if packing else {"min_sample_phonemes": 70})
    corpus = make_corpus(spec, 2**32 + 7)
    masking = {"word_pred_prob": 0.15, "phoneme_mask_prob": 0.8, "replace_prob": 0.1}
    if packing:
        ds = PackedSequenceDataset(corpus, 64, token_separator=87)
        train, _ = split_train_val(len(ds), seed=11)
        program = list(ds.batches(8, epoch=1, seed=11, indices=train))
        derived = list(feed.packed_batches(corpus, 64, 8, 11, 87))
    else:
        data, _ = build_dataloader(corpus, 8, dict(masking, max_seq_length=64), seed=11)
        program = [{"masked_ids": b.masked_ids, "label_ids": b.label_ids,
                    "mask_positions": b.mask_positions, "lengths": b.lengths}
                   for b in data.batches(epoch=1)]
        derived = list(feed.host_masked_batches(corpus, 64, 8, 11, masking))
    assert len(program) == len(derived) > 3
    for p, d in zip(program, derived):
        assert set(p) == set(d)
        for key in p:
            assert np.array_equal(p[key], d[key]), key
