"""On-device whole-word phoneme masking.

The counterpart of ``pl_bert_tpu/ops/ondevice_masking.py``: ``mask_batch``
(:27-74) on torch tensors with an explicit ``torch.Generator`` where JAX
takes a key, and a copy of ``pack_sample`` (:77-110). The host ships only
static packed arrays (label ids, word ids, lengths) once per batch, and
the per-step masking randomness is drawn on the tensors' device: no
per-step host RNG and no ragged index lists.

Distribution parity with the host masker (data/masking.py): each word
selected w.p. ``word_pred_prob``; selected words fully masked w.p.
``phoneme_mask_prob``/(selected), replaced w.p. ``replace_prob`` with
phonemes drawn uniformly from the same sample's own characters, else
kept; separators/padding never masked. The random numbers are torch's,
not JAX's: the two packages agree in distribution, not in bits.
"""

from __future__ import annotations

import numpy as np
import torch

from pl_bert_tpu_torch.data.masking import MaskingParams
from pl_bert_tpu_torch.text.symbols import MASK_ID, SEPARATOR_ID, encode


def mask_batch(
    label_ids: torch.Tensor,  # int [B, L] — with separators, zero-padded
    word_ids: torch.Tensor,  # int [B, L] — word index per char, -1 at sep/pad
    lengths: torch.Tensor,  # int [B]
    generator: torch.Generator,
    params: MaskingParams,
    rows: tuple[int, int] = (0, 1),
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (masked_ids [B, L], mask_positions bool [B, L]). The uniforms
    are drawn on ``generator``'s device (the tensors' own, for no copy).
    ``rows`` (d, n): the batch is slice d of a global batch of n such
    slices (data parallelism); the uniforms are drawn at the global shape
    and sliced, so every rank masks its rows as one process masks the
    global batch (``jax.random``'s draws depend on the shape only)."""
    B, L = label_ids.shape
    dev = label_ids.device
    d, n = rows
    u_sel, u_act, u_draw = torch.rand(
        (3, B * n, L), generator=generator, device=generator.device
    )[:, d * B:(d + 1) * B].to(dev)

    # word-level decisions (word ids are < L by construction)
    selected_w = u_sel < params.word_pred_prob
    mask_w = selected_w & (u_act < params.phoneme_mask_prob)
    replace_w = (
        selected_w
        & ~mask_w
        & (u_act < params.phoneme_mask_prob + params.replace_prob)
    )

    is_char = word_ids >= 0
    in_range = torch.arange(L, device=dev)[None, :] < lengths[:, None]
    valid_char = is_char & in_range

    safe_wid = word_ids.clamp(0, L - 1).long()
    char_masked = torch.gather(mask_w, 1, safe_wid) & valid_char
    char_replaced = torch.gather(replace_w, 1, safe_wid) & valid_char

    # replacement values drawn uniformly from each sample's own chars:
    # pick target ∈ [0, n_chars) then map to the target-th valid char
    # position via cumsum + searchsorted
    n_chars = valid_char.sum(dim=1)
    cums = torch.cumsum(valid_char.to(torch.int32), dim=1)  # [B, L]
    targets = (u_draw * n_chars.clamp_min(1)[:, None]).to(cums.dtype)
    src_pos = torch.searchsorted(cums, targets + 1, side="left").clamp(0, L - 1)
    replacement = torch.gather(label_ids, 1, src_pos)

    masked_ids = torch.where(char_masked, MASK_ID, label_ids)
    masked_ids = torch.where(char_replaced, replacement, masked_ids)
    return masked_ids, char_masked | char_replaced


def pack_sample(word_phonemes: list[str], max_seq_length: int, offset: int = 0):
    """Host-side packing: per-word phoneme strings → (label_ids, word_ids,
    length) numpy arrays with separators, cropped to the window starting
    at char-stream ``offset`` and padded to the static length. Word ids
    are re-based to the window's first visible word. This is the 'packed
    phoneme shard' layout the on-device path consumes."""
    ids_parts = []
    wid_parts = []
    for w_idx, word in enumerate(word_phonemes):
        wid = encode(word)
        ids_parts.append(wid)
        ids_parts.append(np.array([SEPARATOR_ID], np.int32))
        wid_parts.append(np.full(len(wid), w_idx, np.int32))
        wid_parts.append(np.array([-1], np.int32))
    ids = np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.int32)
    wids = np.concatenate(wid_parts) if wid_parts else np.zeros(0, np.int32)
    if offset:
        ids = ids[offset:]
        wids = wids[offset:]
    n = min(len(ids), max_seq_length)
    ids, wids = ids[:n], wids[:n]
    visible = wids >= 0
    if visible.any():
        wids = np.where(visible, wids - wids[visible][0], -1)
    out_ids = np.zeros(max_seq_length, np.int32)
    out_wids = np.full(max_seq_length, -1, np.int32)
    out_ids[:n] = ids
    out_wids[:n] = wids
    return out_ids, out_wids, n
