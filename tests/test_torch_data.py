"""The port's copies of the host-side data path (masking, collation, the
masked-phoneme dataset) and of the masked CE, against the JAX package's:
the same arrays for the same records and seed, bitwise, and the losses to
1e-6."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_bert_tpu.data import collate as jax_collate
from pl_bert_tpu.data import dataset as jax_dataset
from pl_bert_tpu.data import masking as jax_masking
from pl_bert_tpu.ops import masked_ce as jax_ce
from pl_bert_tpu_torch.data import collate, dataset, masking
from pl_bert_tpu_torch.ops import masked_ce

L = 64
LETTERS = list("abdfhiklmnqrstuwzθðʃʕħɣχːˈ")


def _corpus(n=24, seed=0, tokens=False):
    """Records of 2-40 words, so some run past L and get cropped."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = ["".join(rng.choice(LETTERS, size=int(rng.integers(1, 9))))
                 for _ in range(int(rng.integers(2, 40)))]
        rec = {"phonemes": words}
        if tokens:
            rec["token_ids"] = rng.integers(0, 500, len(words)).tolist()
        out.append(rec)
    return out


def _same(a, b):
    for field in ("masked_ids", "label_ids", "token_ids", "mask_positions"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("tokens", [False, True])
def test_dataset_and_collate_bitwise(tokens):
    corpus = _corpus(tokens=tokens)
    kw = dict(max_seq_length=L, use_token_ids=tokens, seed=7, word_pred_prob=0.3)
    ours = dataset.MaskedPhonemeDataset(corpus, **kw)
    ref = jax_dataset.MaskedPhonemeDataset(corpus, **kw)
    assert len(ours) == len(ref)
    for epoch in (0, 3):
        samples = [ours.get(i, epoch) for i in range(len(ours))]
        refs = [ref.get(i, epoch) for i in range(len(ref))]
        for s, r in zip(samples, refs):
            _same(s, r)
        b, rb = collate.collate_fixed(samples, L), jax_collate.collate_fixed(refs, L)
        for field in ("masked_ids", "label_ids", "token_ids", "mask_positions", "lengths"):
            np.testing.assert_array_equal(getattr(b, field), getattr(rb, field))
        np.testing.assert_array_equal(b.attention_mask, rb.attention_mask)


def test_reference_parity_masker_bitwise():
    params = masking.MaskingParams(max_seq_length=L, word_pred_prob=0.4)
    jparams = jax_masking.MaskingParams(max_seq_length=L, word_pred_prob=0.4)
    for rec in _corpus(n=8, seed=2):
        np.random.seed(11)
        random.seed(11)
        ours = masking.mask_sample_reference_parity(rec["phonemes"], params)
        np.random.seed(11)
        random.seed(11)
        _same(ours, jax_masking.mask_sample_reference_parity(rec["phonemes"], jparams))


def _loss_inputs(seed, no_masks=False):
    rng = np.random.default_rng(seed)
    B, V = 5, 40
    logits = rng.standard_normal((B, L, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = rng.random((B, L)) < 0.2
    lengths = np.array([L, 40, 17, 5, 0], np.int32)
    mask[3, :] = False  # a sample with no masks at all
    mask[2, 30:40] = True  # masks past the length: padding, excluded
    if no_masks:
        mask[:] = False
    return logits, labels, mask, lengths


@pytest.mark.parametrize("no_masks", [False, True])
def test_masked_ce_matches_jax(no_masks):
    logits, labels, mask, lengths = _loss_inputs(3, no_masks)
    t = torch.from_numpy
    for lens in (lengths, None):
        got = masked_ce.masked_phoneme_loss(
            t(logits), t(labels), t(mask), None if lens is None else t(lens))
        ref = jax_ce.masked_phoneme_loss(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
            None if lens is None else jnp.asarray(lens))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)
        acc = masked_ce.masked_accuracy(
            t(logits), t(labels), t(mask), None if lens is None else t(lens))
        racc = jax_ce.masked_accuracy(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
            None if lens is None else jnp.asarray(lens))
        np.testing.assert_allclose(float(acc), float(racc), rtol=1e-6, atol=1e-6)
    if no_masks:
        assert float(got) == 0.0


def test_padding_masks_do_not_count():
    """Masks past a sample's length change nothing; a sample whose only
    masks lie there leaves the per-sample mean."""
    logits, labels, mask, lengths = _loss_inputs(4)
    t = torch.from_numpy
    base = masked_ce.masked_phoneme_loss(t(logits), t(labels), t(mask), t(lengths))
    padded = mask.copy()
    padded[4, :] = True  # length 0: every one of these is padding
    padded[1, 45:] = True
    again = masked_ce.masked_phoneme_loss(t(logits), t(labels), t(padded), t(lengths))
    assert float(again) == float(base)
    n = masked_ce.samples_with_masks(t(padded), t(lengths))
    valid = jax_ce.valid_positions(jnp.asarray(padded), jnp.asarray(lengths), L)
    assert float(n) == float((np.asarray(valid).sum(1) > 0).sum())
