"""Train and eval steps of the phoneme-only model, in PyTorch.

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
- metrics ``loss``, ``phoneme_loss``, ``token_loss`` (0: phoneme-only),
  ``grad_norm`` (the averaged gradient's norm before clipping) and ``lr``.

JAX's steps are pure; these update the model's parameters and the
optimizer state in place (no second copy of either). Dropout draws one
seed per site per layer application per micro-step as host ints from a
``torch.Generator`` seeded from (seed, step), so a step is reproducible
and reading a seed never syncs the device.

Not ported yet — each raises where asked for: on-device masking,
sequence packing, the multi-task grapheme head (see :func:`check_ported`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from pl_bert_tpu_torch.models.albert import draw_dropout_seeds
from pl_bert_tpu_torch.ops.masked_ce import (
    masked_accuracy,
    masked_phoneme_loss,
    samples_with_masks,
)


def check_ported(config) -> None:
    """Raise ``NotImplementedError`` for a config whose training path is
    not ported yet."""
    dp, mp = config.dataset_params, config.model_params
    for flag, what in ((dp.ondevice_masking, "dataset_params.ondevice_masking"),
                       (dp.sequence_packing, "dataset_params.sequence_packing"),
                       (mp.num_token_vocab > 0, "model_params.num_token_vocab > 0")):
        if flag:
            raise NotImplementedError(f"{what} is not yet ported to pl_bert_tpu_torch")


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


def _to_device(batch: dict, device) -> dict:
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        out[k] = t.to(device, non_blocking=True)
    return out


def _forward_loss(model, mb: dict, deterministic: bool, dropout_seeds=None):
    """(fp32 logits, phoneme loss) of one (micro-)batch."""
    ids, lengths = mb["masked_ids"], mb["lengths"]
    L = ids.shape[1]
    attention_mask = (torch.arange(L, device=ids.device)[None, :] < lengths[:, None]).int()
    logits = model(ids.long(), attention_mask, deterministic=deterministic,
                   dropout_seeds=dropout_seeds)
    return logits, masked_phoneme_loss(logits, mb["label_ids"], mb["mask_positions"], lengths)


def _check_batch(batch: dict) -> None:
    for key in ("segment_ids", "position_ids"):
        if key in batch:
            raise NotImplementedError(
                "sequence packing (segment_ids/position_ids batches) is not yet "
                "ported to pl_bert_tpu_torch"
            )


def make_train_step(model, tx: AdamW, grad_accum: int = 1, seed: int = 1):
    """The step ``(state, batch) → (state, metrics)``. ``batch``: the
    arrays of ``data/collate.py``'s ``Batch`` (``masked_ids``,
    ``label_ids``, ``mask_positions``, ``lengths``), numpy or torch, with a
    leading ``[grad_accum]`` axis when ``grad_accum > 1``. Metrics are
    0-dim tensors on the model's device, except ``lr``, a float. Host
    masking only: :func:`check_ported` refuses a config that asks for
    on-device masking."""
    n_layers = model.cfg.num_hidden_layers

    def step(state: TrainState, batch: dict):
        _check_batch(batch)
        device = next(state.model.parameters()).device
        batch = _to_device(batch, device)
        gen = torch.Generator().manual_seed(seed * 2**32 + state.step)
        state.model.zero_grad(set_to_none=True)
        if grad_accum == 1:
            _, loss = _forward_loss(state.model, batch, False,
                                    draw_dropout_seeds(gen, n_layers))
            loss.backward()
            grads = {n: p.grad for n, p in state.model.named_parameters()
                     if p.grad is not None}
            loss_p = loss.detach()
        else:
            p_sum = torch.zeros((), device=device)
            n_sum = torch.zeros((), device=device)
            for i in range(grad_accum):
                mb = {k: v[i] for k, v in batch.items()}
                n = samples_with_masks(mb["mask_positions"], mb["lengths"])
                _, loss = _forward_loss(state.model, mb, False,
                                        draw_dropout_seeds(gen, n_layers))
                (loss * n).backward()
                p_sum += loss.detach() * n
                n_sum += n
            denom = n_sum.clamp_min(1.0)
            grads = {n: p.grad / denom for n, p in state.model.named_parameters()
                     if p.grad is not None}
            loss_p = p_sum / denom
        metrics = {
            "loss": loss_p,
            "phoneme_loss": loss_p,
            "token_loss": torch.zeros((), device=device),
            "grad_norm": global_norm(grads.values()),
            "lr": tx.lr(state.opt_state.count),
        }
        tx.update(state.model, grads, state.opt_state)
        state.model.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(model):
    """The eval step ``batch → (phoneme_loss, masked accuracy,
    n_masked)``: the deterministic forward (the serving kernels), no
    gradients. ``n_masked`` lets the caller leave batches without masks
    out of a validation mean, as the JAX trainer does."""

    @torch.no_grad()
    def step(batch: dict):
        _check_batch(batch)
        batch = _to_device(batch, next(model.parameters()).device)
        logits, loss_p = _forward_loss(model, batch, True)
        acc = masked_accuracy(logits, batch["label_ids"], batch["mask_positions"],
                              batch["lengths"])
        return loss_p, acc, batch["mask_positions"].long().sum()

    return step
