"""Masked cross-entropy over the phoneme head and the grapheme head, in
plain PyTorch.

The counterpart of ``pl_bert_tpu/ops/masked_ce.py`` (:26-58
``valid_positions`` and ``masked_phoneme_loss``; :61-128
``masked_lm_loss_chunked``; :131-265 ``masked_lm_loss_fused``; :268-326
``masked_lm_loss``; :329-419 ``masked_lm_metrics``; :439-450
``masked_accuracy``), with the reference's semantics:

    per-sample mean CE over that sample's masked positions,
    then mean over samples that have ≥1 masked position;
    0.0 if no sample in the batch has masks.

No kernel: the JAX side had none here either (its large-vocabulary head
is XLA). The grapheme head's functions take the head in ``nn.Linear``'s
layout (``weight`` [V, H], ``bias`` [V]; JAX's kernel is [H, V]) and
project ``chunk_size`` positions at a time, so only one [B, chunk, V]
plane lives at once. The head runs in the hidden states' dtype (the
compute dtype) with fp32 logits, as Flax's Dense does.

Vocabulary parallelism (JAX's ``token_predictor`` split
``P(None, model)``, where GSPMD inserts the collectives): given a
:class:`VocabSlice` (the model group and the global id of this rank's
first row), ``weight`` and ``bias`` are this rank's rows of the head and
each chunk's log-partition is formed over all of them: the row max
all-reduced (MAX), then the sum of exponentials and the label's logit
(from the rank that holds the label, 0 elsewhere) all-reduced together
(SUM). ``dh`` is summed over the group (the backward of
``copy_to_group``; in the fused forward, once a micro-batch over its fp32
partials), ``dW`` and ``db`` stay local. The argmax is the largest value
over all slices, the lowest global index among equal ones
(``jnp.argmax``'s rule). Without a slice (one model rank) the code path
is the replicated one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from pl_bert_tpu_torch.parallel import collectives as col
from pl_bert_tpu_torch.runtime.build import LaunchCounter

# how often the grapheme head's gather held every row's valid positions,
# and how often the exact full-length path ran instead
GATHERED = LaunchCounter("lm_head_gathered")
FALLBACKS = LaunchCounter("lm_head_full_length")
# the vocabulary-parallel head's collectives over the model group
VOCAB_COLLECTIVES = LaunchCounter("lm_head_vocab_collectives")


@dataclass(frozen=True)
class VocabSlice:
    """This model rank's rows of a vocabulary-parallel head: the model
    ``group`` (more than one rank: ``MultiTaskModel.vocab_slice`` is the
    one place that decides the head is split) and the global id of its
    first row."""

    group: object
    start: int


def _all_reduce(t, vocab, op=dist.ReduceOp.SUM):
    VOCAB_COLLECTIVES.add()
    return col.all_reduce_(t, vocab.group, op)


def _own_labels(labels, width: int, vocab):
    """(local row of each label, clamped into the slice; whether this
    rank holds it) from the labels [rows]."""
    local = labels.reshape(-1).long() - vocab.start
    own = (local >= 0) & (local < width)
    return local.clamp(0, width - 1), own


def _vocab_stats(logits, labels, vocab, top=None):
    """(log-partition, label's logit), fp32 [rows], over every slice of
    the vocabulary, from this slice's compute-dtype logits [rows, V_r]:
    the MAX all-reduce (skipped where ``top``, the global row max, is
    given), then one SUM all-reduce of the sum of exponentials and the
    label's logit."""
    with record_function("lm_head.ce"):
        x = logits.float()
        if top is None:
            top = _all_reduce(x.max(dim=-1).values, vocab, dist.ReduceOp.MAX)
        local, own = _own_labels(labels, x.shape[-1], vocab)
        picked = torch.where(own, x.gather(-1, local[:, None])[:, 0], 0.0)
        pair = torch.stack([torch.exp(x - top[:, None]).sum(dim=-1), picked])
        total, label_logit = _all_reduce(pair, vocab).unbind()
        return top + torch.log(total), label_logit


class _VocabNLL(torch.autograd.Function):
    """NLL [rows] (fp32) of the labels under the whole vocabulary, from
    this slice's logits; the backward is the slice's ``softmax − onehot``
    scaled by the cotangent, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, vocab):
        logz, label_logit = _vocab_stats(logits, labels, vocab)
        ctx.save_for_backward(logits, labels, logz)
        ctx.vocab = vocab
        return logz - label_logit

    @staticmethod
    def backward(ctx, g):
        logits, labels, logz = ctx.saved_tensors
        d = torch.exp(logits.float() - logz[:, None])
        local, own = _own_labels(labels, d.shape[-1], ctx.vocab)
        d.scatter_add_(-1, local[:, None], -own.float()[:, None])
        return (d * g[:, None]).to(logits.dtype), None, None


def valid_positions(mask_positions, lengths, L: int):
    """Masked positions restricted to each sample's real length — the
    validity rule every loss here and the train step's sample count
    share."""
    if lengths is None:
        return mask_positions.bool()
    in_range = torch.arange(L, device=mask_positions.device)[None, :] < lengths[:, None]
    return mask_positions.bool() & in_range


def _average(sums, counts):
    """Per-sample mean over masked positions, then the mean over the
    samples with ≥1 of them (0.0 if none has any), from fp32 per-sample
    sums and counts."""
    has_mask = counts > 0
    per_sample_mean = sums / counts.clamp_min(1.0)
    n_with_mask = has_mask.float().sum()
    total = torch.where(has_mask, per_sample_mean, 0.0).sum()
    return torch.where(n_with_mask > 0, total / n_with_mask.clamp_min(1.0), 0.0)


def masked_phoneme_loss(logits, labels, mask_positions, lengths=None):
    """Reference-equivalent masked CE (fp32 scalar tensor) from fp32
    logits [B, L, V], int labels [B, L], bool mask positions [B, L] and
    int lengths [B] (crops padding)."""
    valid = valid_positions(mask_positions, lengths, labels.shape[1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    w = valid.float()
    return _average((token_nll * w).sum(dim=1), w.sum(dim=1))


def chunk_size_for(L: int, chunk_size: int) -> int:
    """The largest divisor of ``L`` not above ``chunk_size`` — never one
    full-length chunk, which would make the [B, L, V] plane the chunking
    exists to avoid (JAX masked_ce.py:88-95)."""
    c = min(chunk_size, L)
    while L % c:
        c -= 1
    return c


def _logits(h, w_c, b_c):
    """A chunk's logits [B·c, V] in the compute dtype (fp32 accumulation)
    from its hidden states [B, c, H] or rows [B·c, H]. A chunk is copied
    to contiguous rows first: cuBLAS ran the strided [B, c, H] slice
    about 4.6 times slower on an H100 (PERF.md §6)."""
    with record_function("lm_head.logits"):
        return F.linear(h.reshape(-1, h.shape[-1]), w_c, b_c)


def _log_softmax(logits):
    """fp32 log-probabilities of compute-dtype logits (the cast inside
    the softmax's own pass)."""
    with record_function("lm_head.ce"):
        return torch.log_softmax(logits, dim=-1, dtype=torch.float32)


def _nll(logp, labels):
    """The NLL [B, c] of a chunk's labels [B, c] from its log-probabilities
    [B·c, V]."""
    return -logp.gather(-1, labels.reshape(-1, 1).long()).view(labels.shape)


def _chunk_stats(h, w_c, b_c, labels, valid, vocab=None):
    """(Σ NLL over the chunk's valid positions, their count), per sample."""
    if vocab is None:
        nll = _nll(_log_softmax(_logits(h, w_c, b_c)), labels)
    else:
        logits = _logits(col.copy_to_group(h, vocab.group), w_c, b_c)
        nll = _VocabNLL.apply(logits, labels.reshape(-1), vocab).view(labels.shape)
    w = valid.float()
    return (nll * w).sum(dim=1), w.sum(dim=1)


def masked_lm_loss_chunked(hidden, weight, bias, labels, mask_positions, lengths=None,
                           chunk_size: int = 64, vocab: VocabSlice | None = None):
    """Masked CE against a large-vocabulary head (``weight`` [V, H],
    ``bias`` [V], fp32 masters) from ``hidden`` [B, L, H] in the compute
    dtype, without the [B, L, V] logits: ``chunk_size`` positions of
    every row a step. Under autograd each chunk is recomputed in the
    backward (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint``),
    so no chunk's plane is kept; the head's gradient is summed over the
    chunks in the compute dtype, as JAX's scan sums it. ``vocab``: this
    rank's slice of a vocabulary-parallel head."""
    B, L, _ = hidden.shape
    c = chunk_size_for(L, chunk_size)
    valid = valid_positions(mask_positions, lengths, L)
    w_c, b_c = weight.to(hidden.dtype), bias.to(hidden.dtype)
    differentiated = torch.is_grad_enabled() and any(
        t.requires_grad for t in (hidden, weight, bias))
    sums = torch.zeros(B, device=hidden.device)
    counts = torch.zeros(B, device=hidden.device)
    for s in range(0, L, c):
        args = (hidden[:, s:s + c], w_c, b_c, labels[:, s:s + c], valid[:, s:s + c], vocab)
        if differentiated:
            ds, dc = checkpoint(_chunk_stats, *args, use_reentrant=False)
        else:
            ds, dc = _chunk_stats(*args)
        sums = sums + ds
        counts = counts + dc
    return _average(sums, counts)


def _mm_f32(a, b):
    """``a @ b`` from compute-dtype operands with fp32 accumulation and an
    fp32 result (JAX's ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()  # the products of bf16 values are exact in fp32


def _fused_forward(hidden, weight, bias, labels, valid, w_pos, chunk_size: int,
                   vocab=None):
    """JAX's ``_fused_fwd_impl`` (:182-232): the loss and its gradients
    in ``hidden``, ``weight`` and ``bias`` at a loss cotangent of 1, a
    chunk at a time. Each chunk's logit cotangent is
    ``w_pos · (softmax − onehot)``; ``dh`` is formed in the compute
    dtype, ``dW`` and ``db`` summed over the chunks in fp32 (``db`` as the
    product of the cotangent's fp32 rows with ``w_pos``). With ``vocab``
    the softmax is the whole vocabulary's, the onehot only where this
    slice holds the label, and ``dh``'s fp32 partials are summed over the
    group once, then rounded."""
    B, L, H = hidden.shape
    V = weight.shape[0]
    cdt = hidden.dtype
    w_c, b_c = weight.to(cdt), bias.to(cdt)
    sums = torch.zeros(B, device=hidden.device)
    dW = torch.zeros(V, H, device=hidden.device)
    db = torch.zeros(V, device=hidden.device)
    dh = []
    for s in range(0, L, chunk_size):
        h = hidden[:, s:s + chunk_size].reshape(-1, H)  # the chunk's rows, contiguous
        lab = labels[:, s:s + chunk_size]
        if vocab is None:
            logp = _log_softmax(_logits(h, w_c, b_c))
            with record_function("lm_head.ce"):
                nll = _nll(logp, lab)
                dlogits = logp.exp_()  # the softmax, in logp's place
                del logp
                idx = lab.reshape(-1, 1).long()
                dlogits.scatter_add_(-1, idx, torch.full_like(idx, -1.0, dtype=torch.float32))
        else:
            logits = _logits(h, w_c, b_c)
            logz, label_logit = _vocab_stats(logits, lab, vocab)
            with record_function("lm_head.ce"):
                nll = (logz - label_logit).view(lab.shape)
                dlogits = logits.float().sub_(logz[:, None]).exp_()
                del logits
                local, own = _own_labels(lab, dlogits.shape[-1], vocab)
                dlogits.scatter_add_(-1, local[:, None], -own.float()[:, None])
        with record_function("lm_head.ce"):
            sums = sums + (nll * valid[:, s:s + chunk_size].float()).sum(dim=1)
            w = w_pos[:, s:s + chunk_size].reshape(-1)
            db += torch.mv(dlogits.T, w)
            dl = torch.empty(dlogits.shape, dtype=cdt, device=hidden.device)
            torch.mul(dlogits, w[:, None], out=dl)  # w·(softmax − onehot), rounded once
            del dlogits
        with record_function("lm_head.dh"):
            part = dl @ w_c if vocab is None else _mm_f32(dl, w_c)
            dh.append(part.view(B, -1, H))
        with record_function("lm_head.dW"):
            dW += _mm_f32(dl.T, h)
        del dl
    dh = torch.cat(dh, dim=1)
    if vocab is not None:
        with record_function("lm_head.dh"):
            dh = _all_reduce(dh, vocab).to(cdt)
    return _average(sums, valid.float().sum(dim=1)), dh, dW, db


class _FusedLMLoss(torch.autograd.Function):
    """The loss with its gradients formed in the forward; the backward
    only scales them by the loss cotangent (JAX :235-262). Saves ``dh``
    [B, L, H], ``dW`` and ``db``: nothing of size [B, chunk, V]."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, valid, w_pos, chunk_size, vocab):
        loss, dh, dW, db = _fused_forward(hidden, weight, bias, labels, valid, w_pos,
                                          chunk_size, vocab)
        ctx.save_for_backward(dh, dW.to(weight.dtype), db.to(bias.dtype))
        return loss

    @staticmethod
    def backward(ctx, g):
        dh, dW, db = ctx.saved_tensors
        return ((g.float() * dh.float()).to(dh.dtype), g.to(dW.dtype) * dW,
                g.to(db.dtype) * db, None, None, None, None, None)


def masked_lm_loss_fused(hidden, weight, bias, labels, mask_positions, lengths=None,
                         chunk_size: int = 64, vocab: VocabSlice | None = None):
    """``masked_lm_loss_chunked`` with forward-computed gradients: one
    fewer [rows, H]×[H, V] product under differentiation. The value is
    the chunked path's bit for bit (the same chunks, the same per-sample
    order); the gradients agree with its autograd to compute-dtype
    rounding (here the products accumulate in fp32 and ``dW``, ``db`` are
    summed in fp32, as in JAX's fused path). A call that nothing
    differentiates is the chunked loss: no gradient work is done.
    ``vocab`` as in :func:`masked_lm_loss_chunked`."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (hidden, weight, bias))):
        return masked_lm_loss_chunked(hidden, weight, bias, labels, mask_positions, lengths,
                                      chunk_size, vocab)
    L = hidden.shape[1]
    c = chunk_size_for(L, chunk_size)
    valid = valid_positions(mask_positions, lengths, L)
    counts = valid.sum(dim=1).float()
    n_with_mask = (counts > 0).float().sum()
    # per-position loss weight: d loss / d nll[b, l]
    w_pos = valid.float() / (counts.clamp_min(1.0)[:, None] * n_with_mask.clamp_min(1.0))
    return _FusedLMLoss.apply(hidden, weight, bias, labels, valid, w_pos, c, vocab)


def gather_valid(hidden, labels, valid, capacity: int):
    """Each row's first ``capacity`` positions after a stable sort that
    puts its valid positions first, in order (JAX's
    ``argsort(~valid, stable=True)``): (hidden, labels, valid) gathered
    to [B, capacity]."""
    with record_function("lm_head.gather"):
        idx = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :capacity]
        h = hidden.gather(1, idx[..., None].expand(-1, -1, hidden.shape[-1]))
        return h, labels.gather(1, idx), valid.gather(1, idx)


def fits_capacity(valid, capacity: int, max_over=None) -> bool:
    """Whether every row's valid positions fit the gather: one read of
    the largest count back to the host (the JAX package decides on the
    device, with ``lax.cond``). ``max_over`` (int → int) takes that count's
    maximum over the data-parallel ranks, so every rank takes the branch
    JAX's global ``lax.cond`` takes."""
    with record_function("lm_head.capacity_read"):
        top = int(valid.sum(dim=1).max())
        fits = (top if max_over is None else max_over(top)) <= capacity
    (GATHERED if fits else FALLBACKS).add()
    return fits


def masked_lm_loss(hidden, weight, bias, labels, mask_positions, lengths=None,
                   capacity: int = 192, chunk_size: int = 64, fused: bool = False,
                   max_over=None, vocab: VocabSlice | None = None):
    """Large-vocabulary masked CE that projects only each row's valid
    masked positions, gathered up to ``capacity`` of them (JAX
    :268-326). If any row holds more, the exact full-length path runs
    instead, so the value never depends on the capacity;
    ``capacity <= 0`` or ``>= L`` always runs the full-length path.
    ``fused`` swaps the chunked CE for :func:`masked_lm_loss_fused` on
    both paths; ``max_over`` as in :func:`fits_capacity`; ``vocab`` as in
    :func:`masked_lm_loss_chunked` (every model rank holds the same
    hidden states, so they take the same branch)."""
    L = hidden.shape[1]
    inner = masked_lm_loss_fused if fused else masked_lm_loss_chunked
    if capacity <= 0 or capacity >= L:
        return inner(hidden, weight, bias, labels, mask_positions, lengths, chunk_size, vocab)
    valid = valid_positions(mask_positions, lengths, L)
    if not fits_capacity(valid, capacity, max_over):
        return inner(hidden, weight, bias, labels, valid, None, chunk_size, vocab)
    h, lab, val = gather_valid(hidden, labels, valid, capacity)
    return inner(h, weight, bias, lab, val, None, min(chunk_size, capacity), vocab)


@torch.no_grad()
def masked_lm_metrics(hidden, weight, bias, labels, mask_positions, lengths=None,
                      capacity: int = 192, chunk_size: int = 64, max_over=None,
                      vocab: VocabSlice | None = None):
    """Eval-only (loss, argmax accuracy) of the large-vocabulary head in
    one chunked pass, with :func:`masked_lm_loss`'s gather and averaging
    (JAX :329-419): each chunk's logits feed both the CE and the argmax.
    Accuracy is hits over valid masked positions; a batch without masks
    gives (0.0, 0.0). Both fp32 scalar tensors. ``vocab`` as in
    :func:`masked_lm_loss_chunked`."""
    B, L, _ = hidden.shape
    valid = valid_positions(mask_positions, lengths, L)
    w_c, b_c = weight.to(hidden.dtype), bias.to(hidden.dtype)
    h, lab, val = hidden, labels, valid
    if 0 < capacity < L and fits_capacity(valid, capacity, max_over):
        h, lab, val = gather_valid(hidden, labels, valid, capacity)
    c = chunk_size_for(h.shape[1], chunk_size)
    sums = torch.zeros(B, device=hidden.device)
    counts = torch.zeros(B, device=hidden.device)
    hits = torch.zeros((), device=hidden.device)
    for s in range(0, h.shape[1], c):
        logits = _logits(h[:, s:s + c], w_c, b_c)
        lab_k, val_k = lab[:, s:s + c], val[:, s:s + c]
        if vocab is None:
            nll = _nll(_log_softmax(logits), lab_k)
            pred = logits.argmax(dim=-1).view(lab_k.shape)
        else:
            pred, top = _vocab_argmax(logits, vocab)
            logz, label_logit = _vocab_stats(logits, lab_k, vocab, top)
            nll, pred = (logz - label_logit).view(lab_k.shape), pred.view(lab_k.shape)
        w = val_k.float()
        sums = sums + (nll * w).sum(dim=1)
        counts = counts + w.sum(dim=1)
        hits = hits + ((pred == lab_k.long()) & val_k).sum().float()
    acc = hits / valid.sum().clamp_min(1).float()
    return _average(sums, counts), acc


def _vocab_argmax(logits, vocab):
    """(global argmax [rows], the global row max in fp32 [rows]) of the
    slices' logits: the largest value over all slices (MAX all-reduce),
    and among the slices that hold it the lowest global index (MIN
    all-reduce)."""
    local = logits.argmax(dim=-1)
    value = logits.gather(-1, local[:, None])[:, 0].float()
    top = _all_reduce(value.clone(), vocab, dist.ReduceOp.MAX)
    index = torch.where(value == top, local + vocab.start, torch.iinfo(torch.int64).max)
    return _all_reduce(index, vocab, dist.ReduceOp.MIN), top


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
