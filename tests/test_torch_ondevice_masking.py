"""The port's on-device masking and packed datasets against the JAX
package's: ``mask_batch`` by its invariants and, over many draws, by its
rates (torch and JAX draw other bits, so the comparison is
distributional); ``pack_sample``, ``data/packed.py``,
``make_synthetic_corpus`` and ``split_train_val`` bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_bert_tpu.data import packed as jax_packed
from pl_bert_tpu.data.masking import MaskingParams as JaxMaskingParams
from pl_bert_tpu.data.pipeline import split_train_val as jax_split
from pl_bert_tpu.ops import ondevice_masking as jax_odm
from pl_bert_tpu.training.train import make_synthetic_corpus as jax_corpus
from pl_bert_tpu_torch.data import packed
from pl_bert_tpu_torch.data.masking import MaskingParams
from pl_bert_tpu_torch.data.pipeline import split_train_val
from pl_bert_tpu_torch.ops import ondevice_masking as odm
from pl_bert_tpu_torch.text.symbols import MASK_ID, SEPARATOR_ID
from pl_bert_tpu_torch.training.train import make_synthetic_corpus

L = 64


@pytest.fixture(scope="module")
def corpus():
    # short and long samples: some pack three to a row, some need a crop
    return make_synthetic_corpus(120, seed=5, words_per_sample=(2, 16))


@pytest.fixture(scope="module")
def rows(corpus):
    ds = packed.PackedSequenceDataset(corpus, L)
    idx = np.arange(len(ds))
    return {k: torch.from_numpy(v) for k, v in ds.batch(idx).items()}


def test_mask_batch_invariants(rows):
    """Separators and padding are never masked; a word is masked whole
    or not at all; a replacement is one of the sample's own characters."""
    params = MaskingParams(word_pred_prob=0.5, max_seq_length=L)
    gen = torch.Generator().manual_seed(0)
    labels, words, lengths = rows["label_ids"], rows["word_ids"], rows["lengths"]
    masked, pos = odm.mask_batch(labels, words, lengths, gen, params)
    assert masked.shape == labels.shape and pos.dtype == torch.bool and pos.any()
    in_range = torch.arange(L)[None] < lengths[:, None]
    assert not pos[(words < 0) | ~in_range].any()
    assert torch.equal(masked[~pos], labels[~pos])
    assert not (labels[pos] == SEPARATOR_ID).any()
    for r in range(labels.shape[0]):
        own = set(labels[r][(words[r] >= 0) & in_range[r]].tolist())
        for w in words[r][words[r] >= 0].unique().tolist():
            span = words[r] == w
            assert pos[r][span].all() or not pos[r][span].any()
            kinds = masked[r][span & pos[r]]
            # a masked word is all MASK, a replaced one has none
            assert (kinds == MASK_ID).all() or not (kinds == MASK_ID).any()
            assert set(kinds.tolist()) <= own | {MASK_ID}
    again, pos2 = odm.mask_batch(labels, words, lengths, torch.Generator().manual_seed(0),
                                 params)
    assert torch.equal(masked, again) and torch.equal(pos, pos2)


def test_mask_batch_rates_match_jax(rows):
    """Over 60 draws of 100+ rows: the share of characters selected, the
    share of those shown as MASK, and the share replaced agree with the
    JAX ``mask_batch`` within 0.02 absolute (each is a mean over tens of
    thousands of word decisions; 0.02 is over five standard errors) and
    with the configured probabilities."""
    params = dict(word_pred_prob=0.3, phoneme_mask_prob=0.6, replace_prob=0.2,
                  max_seq_length=L)
    labels, words, lengths = rows["label_ids"], rows["word_ids"], rows["lengths"]
    jl, jw, jn = (jnp.asarray(t.numpy()) for t in (labels, words, lengths))
    valid = ((words >= 0) & (torch.arange(L)[None] < lengths[:, None])).numpy()

    def rates(masked, pos):
        masked, pos = np.asarray(masked), np.asarray(pos)
        shown = (masked == MASK_ID) & pos
        return np.array([pos[valid].mean(), shown.sum() / pos.sum()])

    gen = torch.Generator().manual_seed(1)
    jmask = jax.jit(lambda key: jax_odm.mask_batch(jl, jw, jn, key, JaxMaskingParams(**params)))
    port, ref = [], []
    for i in range(60):
        port.append(rates(*odm.mask_batch(labels, words, lengths, gen, MaskingParams(**params))))
        ref.append(rates(*jmask(jax.random.PRNGKey(i))))
    port, ref = np.mean(port, axis=0), np.mean(ref, axis=0)
    np.testing.assert_allclose(port, ref, atol=0.02)
    np.testing.assert_allclose(port[1], 0.6 / 0.8, atol=0.02)  # masked among masked+replaced


@pytest.mark.parametrize("offset", [0, 7])
def test_pack_sample_bitwise(corpus, offset):
    for record in corpus[:20]:
        got = odm.pack_sample(record["phonemes"], L, offset=offset)
        want = jax_odm.pack_sample(record["phonemes"], L, offset=offset)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cls", ["PackedSequenceDataset", "PackedPhonemeDataset"])
def test_packed_datasets_bitwise(corpus, cls):
    """Labels, word ids, segment ids, position ids and lengths of every
    row, and the batch order of two epochs (the second re-crops the long
    samples), are the JAX classes' bit for bit."""
    kwargs = {} if cls == "PackedSequenceDataset" else {"seed": 3}
    ours = getattr(packed, cls)(corpus, L, **kwargs)
    theirs = getattr(jax_packed, cls)(corpus, L, **kwargs)
    assert len(ours) == len(theirs)
    if cls == "PackedSequenceDataset":
        assert ours.packing_efficiency == theirs.packing_efficiency
        assert len(ours) < len(corpus)  # several samples share a row
    train_idx, _ = split_train_val(len(ours), seed=3)
    for epoch in (1, 2):
        a = list(ours.batches(8, epoch, seed=3, indices=train_idx, start_batch=1))
        b = list(theirs.batches(8, epoch, seed=3, indices=train_idx, start_batch=1))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{cls} epoch {epoch} {k}")


def test_pack_token_batch_bitwise(corpus):
    tokens = [list(range(5, 5 + len(r["phonemes"]))) for r in corpus[:10]]
    samples = [r["phonemes"] for r in corpus[:10]]
    offsets = np.arange(10) % 3
    np.testing.assert_array_equal(
        packed.pack_token_batch(samples, tokens, L, 87, offsets),
        jax_packed.pack_token_batch(samples, tokens, L, 87, offsets))


@pytest.mark.parametrize("kwargs", [
    dict(n_samples=12), dict(n_samples=12, seed=4, token_vocab=50),
    dict(n_samples=12, token_vocab=50, derivable=True, pool_size=24,
         words_per_sample=(6, 14)),
])
def test_make_synthetic_corpus_bitwise(kwargs):
    assert make_synthetic_corpus(**kwargs) == jax_corpus(**kwargs)


@pytest.mark.parametrize("total,seed", [(100, 1), (1000, 7), (300_000, 2)])
def test_split_train_val_bitwise(total, seed):
    for a, b in zip(split_train_val(total, seed=seed), jax_split(total, seed=seed)):
        np.testing.assert_array_equal(a, b)
