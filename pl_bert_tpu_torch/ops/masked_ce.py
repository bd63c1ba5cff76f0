"""Masked cross-entropy over the phoneme head, in plain PyTorch.

The counterpart of ``pl_bert_tpu/ops/masked_ce.py`` (:26-58
``valid_positions`` and ``masked_phoneme_loss``, :439-450
``masked_accuracy``), with the reference's semantics:

    per-sample mean CE over that sample's masked positions,
    then mean over samples that have ≥1 masked position;
    0.0 if no sample in the batch has masks.

No kernel: the JAX side had none here either. The multi-task grapheme
head's losses are not ported yet.
"""

from __future__ import annotations

import torch


def valid_positions(mask_positions, lengths, L: int):
    """Masked positions restricted to each sample's real length — the
    validity rule every loss here and the train step's sample count
    share."""
    if lengths is None:
        return mask_positions.bool()
    in_range = torch.arange(L, device=mask_positions.device)[None, :] < lengths[:, None]
    return mask_positions.bool() & in_range


def masked_phoneme_loss(logits, labels, mask_positions, lengths=None):
    """Reference-equivalent masked CE (fp32 scalar tensor) from fp32
    logits [B, L, V], int labels [B, L], bool mask positions [B, L] and
    int lengths [B] (crops padding)."""
    valid = valid_positions(mask_positions, lengths, labels.shape[1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    w = valid.float()
    per_sample_count = w.sum(dim=1)
    has_mask = per_sample_count > 0
    per_sample_mean = (token_nll * w).sum(dim=1) / per_sample_count.clamp_min(1.0)
    n_with_mask = has_mask.float().sum()
    total = torch.where(has_mask, per_sample_mean, 0.0).sum()
    return torch.where(n_with_mask > 0, total / n_with_mask.clamp_min(1.0), 0.0)


def masked_accuracy(logits, labels, mask_positions, lengths=None):
    """Fraction of valid masked positions predicted correctly."""
    valid = valid_positions(mask_positions, lengths, labels.shape[1])
    hit = (logits.argmax(dim=-1) == labels.long()) & valid
    return hit.sum().float() / valid.sum().clamp_min(1).float()


def samples_with_masks(mask_positions, lengths):
    """fp32 count of samples with ≥1 valid masked position: the weight of
    a micro-batch under gradient accumulation."""
    valid = valid_positions(mask_positions, lengths, mask_positions.shape[1])
    return (valid.sum(dim=1) > 0).float().sum()
