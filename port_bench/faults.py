"""Faults planted under the program's training step, to show that the
numbers of ``compare.py`` catch them: each is a ``hook(trainer)`` for
``run.start``/``run.run`` that wraps the Trainer's step."""

from __future__ import annotations

import torch


def unchanged(trainer) -> None:
    """A step that returns its state unchanged: the parameters and the
    optimizer's moments are put back after it (its loss is the step's)."""
    step = trainer.train_step

    def broken(state, batch):
        params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        moments = {n: (m.clone(), v.clone()) for n, (m, v) in state.opt_state.moments.items()}
        count = state.opt_state.count
        state, metrics = step(state, batch)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(params[n])
            for n, (m, v) in state.opt_state.moments.items():
                m.copy_(moments[n][0])
                v.copy_(moments[n][1])
        state.opt_state.count = count
        return state, metrics

    trainer.train_step = broken


def half_batch(trainer) -> None:
    """Half of each micro-batch's rows left out (their lengths 0), the
    mean taken over the rest."""
    step = trainer.train_step

    def broken(state, batch):
        lengths = batch["lengths"].clone()
        lengths[..., lengths.shape[-1] // 2:] = 0
        return step(state, {**batch, "lengths": lengths})

    trainer.train_step = broken


def loss_altered(trainer) -> None:
    """The step's answer altered where it is produced: its loss 1% off."""
    step = trainer.train_step

    def broken(state, batch):
        state, metrics = step(state, batch)
        return state, {**metrics, "loss": metrics["loss"] * 1.01}

    trainer.train_step = broken


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "loss_altered": loss_altered}
