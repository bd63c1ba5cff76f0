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
layer application recomputed in the backward).

On a (data, model) mesh (``parallel/mesh.py``; the model's
``cfg.mesh``) each rank steps its batch slice and its parameter shard:

- the loss is the global batch's: each rank's loss sum (its per-sample
  means) and its count of samples with masks are all-reduced over the
  data group, the local sum over the global count is back-propagated,
  and the gradients are all-reduced (summed) over the data group; under
  accumulation the micro-batches keep JAX's weighting by ``n_sum``;
- with model ranks, each replicated parameter's gradient is made the
  same on all of them, so the parameters stay bitwise equal: under
  sequence parallelism the layer's saw only this rank's rows and are
  summed over the model group, the others are model rank 0's; the
  grapheme head is vocabulary-parallel (``ops/masked_ce.py``), so its
  gradient is a sharded parameter's, local to the rank's rows;
- the global gradient norm counts a sharded parameter's pieces once
  each and a replicated parameter once;
- with ``zero1`` each data rank keeps and updates only its
  ``zero1_partition`` slice of every moment and parameter, then the
  parameters are all-gathered: the update is elementwise, so it is the
  replicated update bit for bit (tests/test_zero1.py:66 for JAX);
- the on-device masking draws its uniforms at the global batch shape
  and slices them, and the grapheme head's capacity decision is taken on
  the largest count over the data ranks, so every rank takes one branch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from pl_bert_tpu_torch.data.pipeline import to_device
from pl_bert_tpu_torch.models.albert import MultiTaskModel, draw_dropout_seeds
from pl_bert_tpu_torch.parallel import collectives as col
from pl_bert_tpu_torch.parallel.mesh import mesh_shape, param_spec, zero1_partition
from pl_bert_tpu_torch.ops.masked_ce import (
    masked_accuracy,
    masked_lm_loss,
    masked_lm_metrics,
    masked_phoneme_loss,
    samples_with_masks,
)
from pl_bert_tpu_torch.utils.profiler import PREFIX, span


def check_ported(config) -> None:
    """Raise for a config this world cannot train: a (data_axis,
    model_axis) that does not divide the initialised world raises
    ``make_mesh``'s ``ValueError``."""
    tp = config.training_params
    mesh_shape(tp.data_axis, tp.model_axis)


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

    def init(self, model: torch.nn.Module, mesh=None, zero1: bool = False,
             full_shapes: dict | None = None) -> "OptState":
        """Zero moments for ``model``'s parameters (this rank's shards);
        with ``zero1`` on a mesh with data ranks, only this data rank's
        ``zero1_partition`` slice of each, chosen from the parameter's full
        shape: ``full_shapes[name]`` where the model holds shards (a shard's
        shape does not tell where an uneven split lies), else its own."""
        parts = {}
        moments = {}
        full_shapes = full_shapes or {}
        for n, p in model.named_parameters():
            dim = None
            if zero1 and mesh is not None:
                dim = zero1_partition(n, full_shapes.get(n, tuple(p.shape)), mesh)
            parts[n] = dim
            t = p if dim is None else p.chunk(mesh.data, dim)[mesh.data_index]
            moments[n] = (torch.zeros_like(t), torch.zeros_like(t))
        return OptState(moments, 0, parts if zero1 and mesh is not None else None, mesh)

    @torch.no_grad()
    def update(self, model: torch.nn.Module, grads: dict, state: "OptState",
               norm=None) -> None:
        """One update of ``model``'s parameters in place from ``grads``
        (name → fp32 tensor; a missing name has a zero gradient); ``norm``
        the gradients' global norm where the caller has it (a sharded
        model's must count every shard: :func:`sharded_norm`). Under
        ZeRO-1 each data rank updates its slices and the parameters are
        all-gathered over the data group."""
        if self.clip > 0:
            if norm is None:
                norm = global_norm(grads.values())
            grads = {n: torch.where(norm < self.clip, g, (g / norm) * self.clip)
                     for n, g in grads.items()}
        count = state.count + 1
        c1 = 1 - self.b1 ** count
        c2 = 1 - self.b2 ** count
        lr = self.lr(state.count)
        parts = state.zero1 or {}
        for name, p in model.named_parameters():
            mu, nu = state.moments[name]
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            dim = parts.get(name)
            full = p
            if dim is not None:
                mesh = state.mesh
                p, g = (t.chunk(mesh.data, dim)[mesh.data_index] for t in (p, g))
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay and decays(name):
                u = u + self.weight_decay * p
            p.add_(-lr * u)
            if dim is not None:
                full.copy_(col.all_gather(p, state.mesh.data_group, dim))
        state.count = count


@dataclass
class OptState:
    moments: dict  # name → (mu, nu); under ZeRO-1 this data rank's slices
    count: int = 0
    zero1: dict | None = None  # name → the dimension ZeRO-1 splits (or None)
    mesh: object = None


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


def sharded_norm(grads: dict, mesh) -> torch.Tensor:
    """The global norm of a model's gradients (name → this rank's fp32
    shard, each summed over the data ranks already): the tensor-parallel
    pieces' squares summed over the model group, each replicated
    parameter counted once."""
    if mesh is None or mesh.model == 1:
        return global_norm(grads.values())
    split = {True: [], False: []}
    for name, g in grads.items():
        split[param_spec(name) is not None].append((g * g).sum())
    sharded = torch.stack(split[True]).sum()
    col.all_reduce_(sharded, mesh.model_group)
    return torch.sqrt(torch.stack(split[False]).sum() + sharded)


def _flat(grads: dict, group, collective) -> dict:
    """``grads`` through one in-place ``collective(flat, group)`` on their
    concatenation."""
    if col.group_size(group) == 1 or not grads:
        return grads
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    collective(flat, group)
    out, at = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[at:at + g.numel()].view_as(g)
        at += g.numel()
    return out


def reduce_grads(grads: dict, mesh, sequence_parallel: bool) -> dict:
    """This rank's gradients made the global batch's (summed over the data
    group). With model ranks, each replicated parameter's gradient is made
    the same on all of them: under sequence parallelism the layer's are
    summed over the model group (each rank saw its rows); the others, which
    every model rank computed alike, are model rank 0's (the card's
    scatter-adds, the embeddings' backward among them, do not repeat bit
    for bit), so the replicated parameters stay bitwise equal."""
    if mesh is None or mesh.size == 1:
        return grads
    if mesh.model > 1:
        replicated = {n: g for n, g in grads.items() if param_spec(n) is None}
        rows = {n: g for n, g in replicated.items()
                if sequence_parallel and ".albert_layers." in n}
        alike = {n: g for n, g in replicated.items() if n not in rows}
        grads = {**grads, **_flat(rows, mesh.model_group, col.all_reduce_),
                 **_flat(alike, mesh.model_group, col.broadcast_)}
    return _flat(grads, mesh.data_group, col.all_reduce_)


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
                  lm_head_capacity: int = 144, fused_lm_head: bool = False, max_over=None):
    """(fp32 phoneme logits, phoneme loss, token loss) of one
    (micro-)batch; the token loss is 0 for the phoneme-only model. The
    multi-task model's grapheme head never makes its [B, L, V] logits:
    ``masked_lm_loss`` projects the hidden states chunk by chunk."""
    with span(PREFIX + "step.forward"):
        logits, hidden = _forward(model, mb, deterministic, dropout_seeds)
        loss_p = masked_phoneme_loss(logits, mb["label_ids"], mb["mask_positions"],
                                     mb["lengths"])
        if hidden is None:
            return logits, loss_p, torch.zeros((), device=logits.device)
        head = model.token_predictor
        loss_t = masked_lm_loss(
            hidden, head.weight, head.bias, mb["token_ids"], mb["mask_positions"],
            mb["lengths"], capacity=lm_head_capacity, fused=fused_lm_head, max_over=max_over,
            vocab=model.vocab_slice(),
        )
        return logits, loss_p, loss_t


def _apply_ondevice_masking(batch: dict, mask_seed: int, masking_params,
                            mesh=None) -> dict:
    """Run the whole-word masking on the batch's device and assemble the
    forward batch — shared by the train and eval steps so their
    preprocessing can never diverge. On a mesh the batch is this rank's
    data slice, masked as one process masks the global batch."""
    from pl_bert_tpu_torch.ops.ondevice_masking import mask_batch

    gen = torch.Generator(device=batch["label_ids"].device).manual_seed(mask_seed)
    rows = (0, 1) if mesh is None else (mesh.data_index, mesh.data)
    masked_ids, mask_positions = mask_batch(
        batch["label_ids"], batch["word_ids"], batch["lengths"], gen, masking_params, rows,
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
    float. On a mesh (``model.cfg.mesh``) ``batch`` is this rank's data
    slice and the metrics are the global batch's."""
    n_layers = model.cfg.num_hidden_layers
    mesh = model.cfg.mesh
    data = 1 if mesh is None else mesh.data
    sp = model.cfg.sequence_parallel
    head = dict(lm_head_capacity=lm_head_capacity, fused_lm_head=fused_lm_head,
                max_over=_max_over(mesh))

    def masked(mb: dict, gen: torch.Generator) -> dict:
        if masking_params is None:
            return mb
        mask_seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        with span(PREFIX + "step.mask"):
            return _apply_ondevice_masking(mb, mask_seed, masking_params, mesh)

    def step(state: TrainState, batch: dict):
        with span(PREFIX + "step"):
            return _step(state, batch)

    def _step(state: TrainState, batch: dict):
        _check_batch(batch, masking_params)
        device = next(state.model.parameters()).device
        batch = to_device(batch, device)
        gen = torch.Generator().manual_seed(seed * 2**32 + state.step)
        state.model.zero_grad(set_to_none=True)
        denom = None
        if grad_accum == 1 and data == 1:
            batch = masked(batch, gen)
            _, loss_p, loss_t = _forward_loss(state.model, batch, False,
                                              draw_dropout_seeds(gen, n_layers), **head)
            with span(PREFIX + "step.backward"):
                (loss_p + loss_t).backward()
            loss_p, loss_t = loss_p.detach(), loss_t.detach()
        else:
            # each micro-batch's losses weighted by its samples with masks,
            # summed, and divided once by the total count (JAX :231-288);
            # on data ranks the sums and the count are the global batch's
            p_sum, t_sum, n_sum = (torch.zeros((), device=device) for _ in range(3))
            for i in range(grad_accum):
                mb = masked({k: v[i] for k, v in batch.items()} if grad_accum > 1 else batch,
                            gen)
                n = samples_with_masks(mb["mask_positions"], mb["lengths"])
                _, loss_p, loss_t = _forward_loss(state.model, mb, False,
                                                  draw_dropout_seeds(gen, n_layers), **head)
                with span(PREFIX + "step.backward"):
                    ((loss_p + loss_t) * n).backward()
                p_sum += loss_p.detach() * n
                t_sum += loss_t.detach() * n
                n_sum += n
            if data > 1:
                sums = col.all_reduce_(torch.stack([p_sum, t_sum, n_sum]), mesh.data_group)
                p_sum, t_sum, n_sum = sums.unbind()
            denom = n_sum.clamp_min(1.0)
            loss_p, loss_t = p_sum / denom, t_sum / denom
        with span(PREFIX + "step.optimizer"):
            grads = reduce_grads({n: p.grad for n, p in state.model.named_parameters()
                                  if p.grad is not None}, mesh, sp)
            if denom is not None:
                grads = {n: g / denom for n, g in grads.items()}
            norm = sharded_norm(grads, mesh)
            metrics = {
                "loss": loss_p + loss_t,
                "phoneme_loss": loss_p,
                "token_loss": loss_t,
                "grad_norm": norm,
                "lr": tx.lr(state.opt_state.count),
            }
            tx.update(state.model, grads, state.opt_state, norm)
            state.model.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics

    return step


def _max_over(mesh):
    """int → its maximum over the data ranks (None on one data rank)."""
    if mesh is None or mesh.data == 1:
        return None
    device = "cpu" if col.dist.get_backend(mesh.data_group) == "gloo" else "cuda"
    return lambda value: col.reduce_int(value, mesh.data_group, device, col.dist.ReduceOp.MAX)


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
    masks out of a validation mean, as the JAX trainer does. On a mesh
    ``batch`` is this rank's data slice and the values are the global
    batch's: the losses averaged over the samples with masks, the
    accuracies over the valid masked positions, of every data rank."""
    mesh = model.cfg.mesh
    max_over = _max_over(mesh)

    @torch.no_grad()
    def step(batch: dict, mask_seed: int = 0):
        _check_batch(batch, masking_params)
        batch = to_device(batch, next(model.parameters()).device)
        if masking_params is not None:
            batch = _apply_ondevice_masking(batch, mask_seed, masking_params, mesh)
        logits, hidden = _forward(model, batch, True)
        mask, lengths = batch["mask_positions"], batch["lengths"]
        loss_p = masked_phoneme_loss(logits, batch["label_ids"], mask, lengths)
        acc = masked_accuracy(logits, batch["label_ids"], mask, lengths)
        n_masked = mask.long().sum()
        out = [loss_p, acc, n_masked]
        if hidden is not None:
            head = model.token_predictor
            out += masked_lm_metrics(hidden, head.weight, head.bias, batch["token_ids"],
                                     mask, lengths, capacity=lm_head_capacity,
                                     max_over=max_over, vocab=model.vocab_slice())
        if max_over is not None:
            out = _global_metrics(out, mask, lengths, mesh)
        return tuple(out)

    return step


def _global_metrics(out: list, mask, lengths, mesh) -> list:
    """A data slice's eval values made the global batch's: each loss
    weighted by the slice's samples with masks, each accuracy by its valid
    masked positions, summed over the data group and divided once."""
    from pl_bert_tpu_torch.ops.masked_ce import valid_positions

    n_s = samples_with_masks(mask, lengths)
    n_v = valid_positions(mask, lengths, mask.shape[1]).sum().float()
    weights = [n_s, n_v, None, n_s, n_v][:len(out)]
    parts = [v.float() * w if w is not None else v.float() for v, w in zip(out, weights)]
    sums = col.all_reduce_(torch.stack(parts + [n_s, n_v]), mesh.data_group)
    n_s, n_v = sums[-2].clamp_min(1.0), sums[-1].clamp_min(1.0)
    return [sums[0] / n_s, sums[1] / n_v, sums[2].long(), *(
        [sums[3] / n_s, sums[4] / n_v] if len(out) == 5 else [])]
