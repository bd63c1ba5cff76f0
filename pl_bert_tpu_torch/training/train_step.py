"""Train and eval steps of the phoneme-only and the multi-task model, in PyTorch.

The counterpart of ``pl_bert_tpu/training/train_step.py`` (:39-97
``_decay_mask``, ``make_lr_schedule``, ``make_optimizer``; :175-321
``make_train_step`` with ``grad_accum``; :324-368 ``make_eval_step``):

- AdamW as optax builds it — the Adam moments, decoupled weight decay on
  every parameter but the pooler (left out by name: it gets no gradient,
  and the reference's torch AdamW skips it), the learning rate from the
  schedule indexed by the update count from 0 — after an optional clip
  of the global gradient norm as ``optax.clip_by_global_norm`` does it
  (no epsilon added to the norm);
- gradient accumulation over a leading micro-batch axis, each
  micro-batch's loss weighted by its samples with masks, so the update
  equals the concatenated batch's;
- the multi-task model's grapheme head (:class:`MultiTaskModel`): the
  phoneme loss plus ``masked_lm_loss`` on the hidden states, gathered up
  to ``lm_head_capacity`` masked positions a row (one host read a
  micro-batch decides whether they fit; if not, the exact full-length
  path runs) and, with ``fused_lm_head``, with forward-computed
  gradients (:100-150);
- metrics ``loss``, ``phoneme_loss``, ``token_loss`` (0: phoneme-only),
  ``grad_norm`` (the averaged gradient's norm before clipping) and ``lr``.

With ``masking_params`` the batch carries only packed arrays
(``label_ids``, ``word_ids``, ``lengths``, and for packed sequences
``segment_ids``/``position_ids``) and whole-word masking runs on the
device inside the step (``ops/ondevice_masking.py``), in the train, the
accumulation and the eval step alike (:152-172, :231-236, :290-296,
:348-350).

JAX's steps are pure; these update the model's parameters and the
optimizer state in place (no second copy of either). Per micro-step a
``torch.Generator`` seeded from (seed, step) draws, in this order, the
masking seed (on-device masking only) and one dropout seed per site per
layer application, as host ints, so a step is reproducible, reading a
seed never syncs the device, and one seed list drives every attention
path.

``training_params.remat`` is the model's (``models/albert.py``: each
layer application recomputed in the backward). Not ported yet, and
raising where asked for: more than one device (see :func:`check_ported`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from pl_bert_tpu_torch.data.pipeline import to_device
from pl_bert_tpu_torch.models.albert import MultiTaskModel, draw_dropout_seeds
from pl_bert_tpu_torch.ops.masked_ce import (
    masked_accuracy,
    masked_lm_loss,
    masked_lm_metrics,
    masked_phoneme_loss,
    samples_with_masks,
)


def check_ported(config) -> None:
    """Raise ``NotImplementedError`` for a config whose training path is
    not ported yet."""
    tp = config.training_params
    if (tp.data_axis, tp.model_axis) not in ((1, 1), (-1, 1)):
        raise NotImplementedError(
            f"data_axis {tp.data_axis} / model_axis {tp.model_axis}: more than one device "
            "is not yet ported to pl_bert_tpu_torch")


def decays(name: str) -> bool:
    """Weight decay applies to every parameter but the pooler's."""
    return "pooler" not in name.split(".")


def make_lr_schedule(tp) -> Callable[[int], float] | None:
    """Update count → learning rate, or None for the reference's
    constant rate; optax's linear/cosine schedules and linear warmup
    (pl_bert_tpu/training/train_step.py:52-77)."""
    peak, warm = tp.learning_rate, tp.warmup_steps
    if tp.lr_schedule == "constant" and warm == 0:
        return None
    decay_steps = max(tp.num_steps - warm, 1)
    floor = peak * tp.lr_min_ratio

    def main(count: int) -> float:
        t = min(max(count, 0), decay_steps)
        if tp.lr_schedule == "cosine":
            cos = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
            return peak * ((1 - tp.lr_min_ratio) * cos + tp.lr_min_ratio)
        if tp.lr_schedule == "linear":
            return (peak - floor) * (1 - t / decay_steps) + floor
        return peak

    def schedule(count: int) -> float:
        if warm and count < warm:
            return peak * min(max(count, 0), warm) / warm
        return main(count - warm if warm else count)

    return schedule


@dataclass
class AdamW:
    """optax's ``chain(clip_by_global_norm, adamw(mask=_decay_mask))``
    (``clip`` 0: no clip), on a model's named parameters."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip: float = 0.0
    schedule: Callable[[int], float] | None = None

    def lr(self, count: int) -> float:
        return self.learning_rate if self.schedule is None else self.schedule(count)

    def init(self, model: torch.nn.Module) -> "OptState":
        return OptState({
            n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in model.named_parameters()
        })

    @torch.no_grad()
    def update(self, model: torch.nn.Module, grads: dict, state: "OptState") -> None:
        """One update of ``model``'s parameters in place from ``grads``
        (name → fp32 tensor; a missing name has a zero gradient)."""
        if self.clip > 0:
            norm = global_norm(grads.values())
            grads = {n: torch.where(norm < self.clip, g, (g / norm) * self.clip)
                     for n, g in grads.items()}
        count = state.count + 1
        c1 = 1 - self.b1 ** count
        c2 = 1 - self.b2 ** count
        lr = self.lr(state.count)
        for name, p in model.named_parameters():
            mu, nu = state.moments[name]
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and decays(name):
                u = u + self.weight_decay * p
            p.add_(-lr * u)
        state.count = count


@dataclass
class OptState:
    moments: dict  # name → (mu, nu)
    count: int = 0


@dataclass
class TrainState:
    model: torch.nn.Module
    opt_state: OptState
    step: int = 0


def make_optimizer(tp) -> AdamW:
    """AdamW from a ``TrainingParams``."""
    return AdamW(
        learning_rate=tp.learning_rate, b1=tp.adam_b1, b2=tp.adam_b2, eps=tp.adam_eps,
        weight_decay=tp.weight_decay, clip=tp.grad_clip_norm,
        schedule=make_lr_schedule(tp),
    )


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (of fp32 gradients),
    on the device."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def _forward(model, mb: dict, deterministic: bool, dropout_seeds=None):
    """(fp32 phoneme logits, the multi-task model's hidden states or
    None) of one (micro-)batch; a packed batch's
    ``segment_ids``/``position_ids`` go to the model."""
    ids, lengths = mb["masked_ids"], mb["lengths"]
    L = ids.shape[1]
    attention_mask = (torch.arange(L, device=ids.device)[None, :] < lengths[:, None]).int()
    position_ids = mb.get("position_ids")
    kwargs = dict(segment_ids=mb.get("segment_ids"),
                  position_ids=None if position_ids is None else position_ids.long(),
                  deterministic=deterministic, dropout_seeds=dropout_seeds)
    if isinstance(model, MultiTaskModel):
        return model(ids.long(), attention_mask, project_tokens=False, **kwargs)
    return model(ids.long(), attention_mask, **kwargs), None


def _forward_loss(model, mb: dict, deterministic: bool, dropout_seeds=None,
                  lm_head_capacity: int = 144, fused_lm_head: bool = False):
    """(fp32 phoneme logits, phoneme loss, token loss) of one
    (micro-)batch; the token loss is 0 for the phoneme-only model. The
    multi-task model's grapheme head never makes its [B, L, V] logits:
    ``masked_lm_loss`` projects the hidden states chunk by chunk."""
    logits, hidden = _forward(model, mb, deterministic, dropout_seeds)
    loss_p = masked_phoneme_loss(logits, mb["label_ids"], mb["mask_positions"], mb["lengths"])
    if hidden is None:
        return logits, loss_p, torch.zeros((), device=logits.device)
    head = model.token_predictor
    loss_t = masked_lm_loss(
        hidden, head.weight, head.bias, mb["token_ids"], mb["mask_positions"], mb["lengths"],
        capacity=lm_head_capacity, fused=fused_lm_head,
    )
    return logits, loss_p, loss_t


def _apply_ondevice_masking(batch: dict, mask_seed: int, masking_params) -> dict:
    """Run the whole-word masking on the batch's device and assemble the
    forward batch — shared by the train and eval steps so their
    preprocessing can never diverge."""
    from pl_bert_tpu_torch.ops.ondevice_masking import mask_batch

    gen = torch.Generator(device=batch["label_ids"].device).manual_seed(mask_seed)
    masked_ids, mask_positions = mask_batch(
        batch["label_ids"], batch["word_ids"], batch["lengths"], gen, masking_params,
    )
    fwd = {
        "masked_ids": masked_ids,
        "label_ids": batch["label_ids"],
        "token_ids": batch.get("token_ids", batch["label_ids"]),
        "mask_positions": mask_positions,
        "lengths": batch["lengths"],
    }
    for key in ("segment_ids", "position_ids"):
        if key in batch:
            fwd[key] = batch[key]
    return fwd


def _check_batch(batch: dict, masking_params) -> None:
    """A packed batch (no ``masked_ids`` yet) is refused by a step built
    for host masking, not trained on as if it were masked."""
    if masking_params is None and "masked_ids" not in batch:
        raise ValueError(
            "batch has no masked_ids: a packed batch (label_ids, word_ids, lengths) needs a "
            "step built with masking_params (dataset_params.ondevice_masking)"
        )


def make_train_step(model, tx: AdamW, grad_accum: int = 1, seed: int = 1,
                    masking_params=None, fused_lm_head: bool = False,
                    lm_head_capacity: int = 144):
    """The step ``(state, batch) → (state, metrics)``. ``batch``: the
    arrays of ``data/collate.py``'s ``Batch`` (``masked_ids``,
    ``label_ids``, ``mask_positions``, ``lengths``; ``token_ids`` for the
    multi-task model), numpy or torch, with a leading ``[grad_accum]``
    axis when ``grad_accum > 1``. With ``masking_params`` the batch is a
    packed one (``label_ids``, ``word_ids``, ``lengths`` [+
    ``token_ids``, ``segment_ids``, ``position_ids``]) and the masking
    runs on the device inside the step. ``fused_lm_head`` and
    ``lm_head_capacity`` set the multi-task model's grapheme-head loss
    (:func:`masked_lm_loss`); the phoneme-only model ignores them.
    Metrics are 0-dim tensors on the model's device, except ``lr``, a
    float."""
    n_layers = model.cfg.num_hidden_layers
    head = dict(lm_head_capacity=lm_head_capacity, fused_lm_head=fused_lm_head)

    def masked(mb: dict, gen: torch.Generator) -> dict:
        if masking_params is None:
            return mb
        mask_seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        return _apply_ondevice_masking(mb, mask_seed, masking_params)

    def step(state: TrainState, batch: dict):
        _check_batch(batch, masking_params)
        device = next(state.model.parameters()).device
        batch = to_device(batch, device)
        gen = torch.Generator().manual_seed(seed * 2**32 + state.step)
        state.model.zero_grad(set_to_none=True)
        if grad_accum == 1:
            batch = masked(batch, gen)
            _, loss_p, loss_t = _forward_loss(state.model, batch, False,
                                              draw_dropout_seeds(gen, n_layers), **head)
            (loss_p + loss_t).backward()
            grads = {n: p.grad for n, p in state.model.named_parameters()
                     if p.grad is not None}
            loss_p, loss_t = loss_p.detach(), loss_t.detach()
        else:
            # each micro-batch's losses weighted by its samples with masks,
            # summed, and divided once by the total count (JAX :231-288)
            p_sum, t_sum, n_sum = (torch.zeros((), device=device) for _ in range(3))
            for i in range(grad_accum):
                mb = masked({k: v[i] for k, v in batch.items()}, gen)
                n = samples_with_masks(mb["mask_positions"], mb["lengths"])
                _, loss_p, loss_t = _forward_loss(state.model, mb, False,
                                                  draw_dropout_seeds(gen, n_layers), **head)
                ((loss_p + loss_t) * n).backward()
                p_sum += loss_p.detach() * n
                t_sum += loss_t.detach() * n
                n_sum += n
            denom = n_sum.clamp_min(1.0)
            grads = {n: p.grad / denom for n, p in state.model.named_parameters()
                     if p.grad is not None}
            loss_p, loss_t = p_sum / denom, t_sum / denom
        metrics = {
            "loss": loss_p + loss_t,
            "phoneme_loss": loss_p,
            "token_loss": loss_t,
            "grad_norm": global_norm(grads.values()),
            "lr": tx.lr(state.opt_state.count),
        }
        tx.update(state.model, grads, state.opt_state)
        state.model.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    return step


def batch_to_arrays(batch) -> dict:
    """``data/collate.py``'s ``Batch`` → the dict of arrays the steps take."""
    return {
        "masked_ids": batch.masked_ids,
        "label_ids": batch.label_ids,
        "token_ids": batch.token_ids,
        "mask_positions": batch.mask_positions,
        "lengths": batch.lengths,
    }


def make_eval_step(model, masking_params=None, lm_head_capacity: int = 144):
    """The eval step ``(batch, mask_seed) → (phoneme_loss, masked
    accuracy, n_masked)``, and for the multi-task model ``(…, token_loss,
    token accuracy)`` from ``masked_lm_metrics`` at ``lm_head_capacity``
    (JAX :324-368 uses 192 whatever the config says; the values do not
    depend on it): the deterministic forward (the serving kernels), no
    gradients. With ``masking_params`` the masking runs on the device
    from ``mask_seed`` (pass a fixed one per batch so validation is the
    same across runs). ``n_masked`` lets the caller leave batches without
    masks out of a validation mean, as the JAX trainer does."""

    @torch.no_grad()
    def step(batch: dict, mask_seed: int = 0):
        _check_batch(batch, masking_params)
        batch = to_device(batch, next(model.parameters()).device)
        if masking_params is not None:
            batch = _apply_ondevice_masking(batch, mask_seed, masking_params)
        logits, hidden = _forward(model, batch, True)
        mask, lengths = batch["mask_positions"], batch["lengths"]
        loss_p = masked_phoneme_loss(logits, batch["label_ids"], mask, lengths)
        acc = masked_accuracy(logits, batch["label_ids"], mask, lengths)
        n_masked = mask.long().sum()
        if hidden is None:
            return loss_p, acc, n_masked
        head = model.token_predictor
        loss_t, acc_t = masked_lm_metrics(hidden, head.weight, head.bias, batch["token_ids"],
                                          mask, lengths, capacity=lm_head_capacity)
        return loss_p, acc, n_masked, loss_t, acc_t

    return step
