"""The batches a training run must see, worked out from the corpus.

The reference's own derivation of what the program's data plane hands
its step: the samples laid out with a separator after each word, packed
first-fit-decreasing into rows (``data/packed.py``'s packing) or masked
whole-word on the host (``data/masking.py``'s ``WholeWordMasker``), the
95/5 split and the epoch's shuffle (``data/pipeline.py``), each keyed by
the run's training seed as the program's data plane documents them; and
the step's own draws (a ``torch.Generator`` seeded with
``seed·2³² + step``: the masking seed and one dropout seed a site a
layer application, a micro-batch at a time) and its on-device masking
(``ops/ondevice_masking.py``). The harness compares these batches with
the ones the program's feed delivered, array by array, before the
reference trains on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.symbols import MASK_ID, SEPARATOR_ID, encode


def _layout(words: list[str], tokens: list[int] | None, token_separator: int):
    """(ids, word ids, grapheme ids) of a sample: each word's phonemes and
    a separator after it; word id −1 and grapheme id ``token_separator``
    at the separators."""
    ids, wids, toks = [], [], []
    for w, word in enumerate(words):
        e = encode(word)
        ids += [e, [SEPARATOR_ID]]
        wids += [np.full(len(e), w), [-1]]
        if tokens is not None:
            toks += [np.full(len(e), tokens[w]), [token_separator]]
    cat = lambda parts: np.concatenate(parts).astype(np.int32)  # noqa: E731
    return cat(ids), cat(wids), (cat(toks) if tokens is not None else None)


def split_train_val(total: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    val = min(int(total * 0.05), 10_000)
    perm = np.random.Generator(np.random.Philox(seed)).permutation(total)
    return perm[:total - val], perm[total - val:]


def packed_rows(corpus: list[dict], L: int, token_separator: int) -> dict:
    """Rows of first-fit-decreasing packed samples: label, word, segment,
    position and grapheme ids [rows, L] and lengths [rows]; word ids run
    on across a row's segments."""
    laid = [_layout(r["phonemes"], r.get("token_ids"), token_separator) for r in corpus]
    lens = np.array([min(len(ids), L) for ids, _, _ in laid], dtype=np.int32)
    order = np.argsort(lens)[::-1]
    nonzero = lens[lens > 0]
    min_len = int(nonzero.min()) if nonzero.size else 0
    bins, space, active, ub_max = [], [], [], -1
    for idx in order:
        n = int(lens[idx])
        if n == 0:
            continue
        placed = False
        if n <= ub_max:
            for pos, b in enumerate(active):
                if n <= space[b]:
                    bins[b].append(int(idx))
                    space[b] -= n
                    if space[b] < min_len:
                        active.pop(pos)
                    placed = True
                    break
        if not placed:
            bins.append([int(idx)])
            space.append(L - n)
            if L - n >= min_len:
                active.append(len(bins) - 1)
                ub_max = max(ub_max, L - n)
    rows = len(bins)
    out = {"label_ids": np.zeros((rows, L), np.int32),
           "word_ids": np.full((rows, L), -1, np.int32),
           "segment_ids": np.full((rows, L), -1, np.int32),
           "position_ids": np.zeros((rows, L), np.int32),
           "lengths": np.zeros(rows, np.int32)}
    has_tokens = bool(corpus) and "token_ids" in corpus[0]
    if has_tokens:
        out["token_ids"] = np.zeros((rows, L), np.int32)
    for r, members in enumerate(bins):
        pos = offset = 0
        for seg, idx in enumerate(members):
            ids, wids, toks = laid[idx]
            n = int(lens[idx])
            span = slice(pos, pos + n)
            out["label_ids"][r, span] = ids[:n]
            out["word_ids"][r, span] = np.where(wids[:n] >= 0, wids[:n] + offset, -1)
            out["segment_ids"][r, span] = seg
            out["position_ids"][r, span] = np.arange(n)
            if has_tokens:
                out["token_ids"][r, span] = toks[:n]
            offset += int(wids[:n].max()) + 1
            pos += n
        out["lengths"][r] = pos
    return out


def packed_batches(corpus: list[dict], L: int, batch: int, seed: int, token_separator: int,
                   epoch: int = 1):
    """The packed path's training batches of ``epoch``, in order."""
    rows = packed_rows(corpus, L, token_separator)
    train, _ = split_train_val(len(rows["lengths"]), seed)
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, epoch]))
    order = train[rng.permutation(len(train))]
    for lo in range(0, len(order) - len(order) % batch, batch):
        yield {k: v[order[lo:lo + batch]] for k, v in rows.items()}


def _mask_sample(words: list[str], epoch: int, index: int, seed: int, masking: dict, L: int):
    """(masked ids, label ids, mask positions) of one sample masked on the
    host, cropped to a window of ``L``."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, epoch, index]))
    parts = [encode(w) for w in words]
    lens = np.array([len(p) for p in parts], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens[:-1] + 1)]).astype(np.int64)
    total = int(lens.sum()) + len(parts)
    labels = np.full(total, SEPARATOR_ID, np.int32)
    flat = np.concatenate(parts)
    char_pos = np.concatenate([np.arange(s, s + n) for s, n in zip(starts, lens)])
    labels[char_pos] = flat
    selected = rng.random(len(parts)) < masking["word_pred_prob"]
    u = rng.random(len(parts))
    pm, pr = masking["phoneme_mask_prob"], masking["replace_prob"]
    do_mask = selected & (u < pm)
    do_replace = selected & ~do_mask & (u < pm + pr)
    masked = labels.copy()
    by_mask, by_replace = np.repeat(do_mask, lens), np.repeat(do_replace, lens)
    masked[char_pos[by_mask]] = MASK_ID
    n_repl = int(by_replace.sum())
    if n_repl:
        masked[char_pos[by_replace]] = flat[rng.integers(0, len(flat), size=n_repl)]
    positions = np.zeros(total, bool)
    positions[char_pos[by_mask | by_replace]] = True
    if total > L:
        start = int(rng.integers(0, total - L))
        masked, labels, positions = (a[start:start + L] for a in (masked, labels, positions))
    return masked, labels, positions


def host_masked_batches(corpus: list[dict], L: int, batch: int, seed: int, masking: dict,
                        epoch: int = 1):
    """The host-masking path's training batches of ``epoch``, in order."""
    train, _ = split_train_val(len(corpus), seed)
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 1, 0, epoch]))
    order = train[rng.permutation(len(train))]
    for lo in range(0, len(order) - len(order) % batch, batch):
        out = {"masked_ids": np.zeros((batch, L), np.int32),
               "label_ids": np.zeros((batch, L), np.int32),
               "mask_positions": np.zeros((batch, L), bool),
               "lengths": np.zeros(batch, np.int32)}
        for r, i in enumerate(order[lo:lo + batch]):
            masked, labels, positions = _mask_sample(corpus[int(i)]["phonemes"], epoch, int(i),
                                                     seed, masking, L)
            n = min(len(masked), L)
            out["masked_ids"][r, :n] = masked[:n]
            out["label_ids"][r, :n] = labels[:n]
            out["mask_positions"][r, :n] = positions[:n]
            out["lengths"][r] = n
        yield out


def step_draws(seed: int, step: int, micro: int, layers: int, ondevice: bool) -> list:
    """Each micro-batch's (masking seed or None, dropout seeds) of a step:
    the embedding's, then (attention, LayerNorm, LayerNorm) a layer."""
    gen = torch.Generator().manual_seed(seed * 2**32 + step)
    out = []
    for _ in range(micro):
        mask_seed = int(torch.randint(0, 2**62, (1,), generator=gen)) if ondevice else None
        out.append((mask_seed, torch.randint(0, 2**31 - 1, (1 + 3 * layers,),
                                             generator=gen).tolist()))
    return out


def mask_on_device(label_ids, word_ids, lengths, mask_seed: int, masking: dict):
    """Whole-word masking of packed rows from uniforms drawn on the rows'
    device with ``mask_seed``: a word is selected, then masked or
    replaced by a phoneme drawn from its own row. → (masked ids, mask
    positions)."""
    B, L = label_ids.shape
    dev = label_ids.device
    gen = torch.Generator(device=dev).manual_seed(mask_seed)
    u_sel, u_act, u_draw = torch.rand((3, B, L), generator=gen, device=dev)
    pm, pr = masking["phoneme_mask_prob"], masking["replace_prob"]
    selected = u_sel < masking["word_pred_prob"]
    mask_w = selected & (u_act < pm)
    replace_w = selected & ~mask_w & (u_act < pm + pr)
    valid = (word_ids >= 0) & (torch.arange(L, device=dev)[None, :] < lengths[:, None])
    wid = word_ids.clamp(0, L - 1).long()
    masked_c = torch.gather(mask_w, 1, wid) & valid
    replaced_c = torch.gather(replace_w, 1, wid) & valid
    n_chars = valid.sum(dim=1)
    cums = torch.cumsum(valid.to(torch.int32), dim=1)
    targets = (u_draw * n_chars.clamp_min(1)[:, None]).to(cums.dtype)
    src = torch.searchsorted(cums, targets + 1, side="left").clamp(0, L - 1)
    out = torch.where(masked_c, MASK_ID, label_ids)
    out = torch.where(replaced_c, torch.gather(label_ids, 1, src), out)
    return out, masked_c | replaced_c
