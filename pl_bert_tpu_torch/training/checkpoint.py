"""Checkpoint management.

The counterpart of ``pl_bert_tpu/training/checkpoint.py``. Keeps the
reference's artifact contract (reference: train.py:46-105, 412-425):
checkpoints named ``step_{N}`` inside the run directory, latest
discovered by parsing names. Storage is the reference's own
``step_N.pth`` torch pickle (``pl_bert_tpu/export/from_torch.py:3-4``),
not orbax::

    {'net': model.state_dict(), 'step': N, 'epoch': e,
     'optimizer': <torch.optim.AdamW state dict layout>,
     'batch_in_epoch': b}

with the AdamW moments laid out as ``torch.optim.AdamW.state_dict()``
does (``state[i] = {'step', 'exp_avg', 'exp_avg_sq'}`` keyed by the
parameter's index in state-dict order), so
``pl_bert_tpu.export.from_torch.import_reference_run`` reads a port
checkpoint as it reads the reference's, and ``load_params_only`` reads
a ``.pth`` that ``pl_bert_tpu.export.to_torch`` wrote. Unlike the
reference, the data-pipeline position (epoch, batch index) is saved so
resume is order-deterministic. A file is written under a temporary name
and renamed, so a crash never leaves a truncated ``step_N.pth``.

JAX's loaders return new trees; :func:`load_checkpoint` and
:func:`load_params_only` fill the model and the optimizer state in place.

On a (data, model) mesh the file is the same one a single device writes:
:func:`gather_state` all-gathers the tensor-parallel parameter and moment
shards over the model group and the ZeRO-1 moment slices over the data
group (every rank takes part; rank 0 writes), and the loaders cut the
full tensors back to this rank's shard and slice, so a checkpoint
resumes on any (data, model).
"""

from __future__ import annotations

import os
import re
import threading

import torch

from pl_bert_tpu_torch.parallel import collectives as col
from pl_bert_tpu_torch.parallel.mesh import param_spec, shard, zero1_shard

_STEP_RE = re.compile(r"^step_(\d+)\.pth$")


def list_checkpoints(log_dir: str) -> list[int]:
    """Every step_N.pth in the run dir, ascending (empty on a missing or
    checkpoint-free dir)."""
    try:
        return sorted(
            int(m.group(1))
            for name in os.listdir(log_dir)
            if (m := _STEP_RE.match(name))
            and os.path.isfile(os.path.join(log_dir, name))
        )
    except OSError:
        return []


def find_latest_checkpoint(log_dir: str) -> tuple[bool, int]:
    """Scan run dir for step_*.pth checkpoints → (found, latest_step)."""
    steps = list_checkpoints(log_dir)
    return (True, steps[-1]) if steps else (False, 0)


def checkpoint_path(log_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(log_dir), f"step_{step}.pth")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def _payload(params: dict, opt_state, step: int, epoch: int, batch_in_epoch: int) -> dict:
    """The ``.pth`` contents from a state dict and an ``OptState``, all
    tensors on the host."""
    names = list(params)
    count = torch.tensor(float(opt_state.count))
    state = {}
    for i, name in enumerate(names):
        mu, nu = opt_state.moments[name]
        state[i] = {"step": count.clone(), "exp_avg": _cpu(mu), "exp_avg_sq": _cpu(nu)}
    return {
        "net": {name: _cpu(t) for name, t in params.items()},
        "step": int(step),
        "epoch": int(epoch),
        "optimizer": {"state": state, "param_groups": [{"params": list(range(len(names)))}]},
        "batch_in_epoch": int(batch_in_epoch),
    }


def _write(log_dir: str, step: int, payload: dict, keep: int) -> str:
    path = checkpoint_path(log_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    if keep > 0:
        for old in list_checkpoints(log_dir)[:-keep]:
            try:
                os.remove(checkpoint_path(log_dir, old))
            except OSError:
                pass
    return path


def save_checkpoint(
    log_dir: str,
    step: int,
    params: dict,
    opt_state,
    epoch: int = 0,
    batch_in_epoch: int = 0,
    keep: int = 0,
) -> str:
    """Write step_{N}.pth from ``params`` (a model's ``state_dict()``) and
    ``opt_state`` (``train_step.OptState``); optionally retain only the
    newest ``keep``."""
    return _write(log_dir, step, _payload(params, opt_state, step, epoch, batch_in_epoch), keep)


class AsyncCheckpointWriter:
    """Overlap checkpoint writes with training (training_params.async_save).

    ``submit`` snapshots the state into fresh device buffers (the train
    step updates parameters and moments in place, so the snapshot must
    not alias them) and runs the device→host copy, the ``torch.save``
    and the retention janitor in a background thread. The train loop
    stalls only for the on-device clone — not the host transfer or the
    disk IO the reference's ``accelerator.save`` blocks on every
    save_interval (reference: train.py:369-370, 412-425).

    One write in flight at a time: ``submit`` joins the previous write
    first (a save_interval's worth of compute is the natural write
    budget). Call ``wait()`` before reading checkpoints back or exiting.
    A failed write re-raises from the next ``wait()``/``submit`` — a
    checkpoint that silently never landed would defeat elastic resume.
    """

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def submit(
        self,
        log_dir: str,
        step: int,
        params: dict,
        opt_state,
        epoch: int = 0,
        batch_in_epoch: int = 0,
        keep: int = 0,
    ) -> None:
        from pl_bert_tpu_torch.training.train_step import OptState

        self.wait()
        snap_params = {n: t.detach().clone() for n, t in params.items()}
        snap_opt = OptState(
            {n: (mu.clone(), nu.clone()) for n, (mu, nu) in opt_state.moments.items()},
            opt_state.count,
        )

        def _run() -> None:
            try:
                save_checkpoint(log_dir, step, snap_params, snap_opt, epoch=epoch,
                                batch_in_epoch=batch_in_epoch, keep=keep)
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(
            target=_run, name=f"ckpt-write-step-{step}", daemon=True
        )
        self._thread.start()


@torch.no_grad()
def gather_state(model: torch.nn.Module, opt_state, mesh):
    """``(state dict, OptState)`` with full tensors, from this rank's
    shards (the model's parameters, and the moments' ZeRO-1 slices of
    them): the ones a single device holds. Every rank of the mesh must
    call it."""
    from pl_bert_tpu_torch.training.train_step import OptState

    def full(name: str, t: torch.Tensor) -> torch.Tensor:
        dim = param_spec(name)
        if mesh.model > 1 and dim is not None:  # the head's rows may be uneven
            return col.all_gather_uneven(t, mesh.model_group, dim)
        return t

    params = {n: full(n, t.detach()) for n, t in model.state_dict().items()}
    if opt_state is None:
        return params, None
    parts = opt_state.zero1 or {}
    moments = {}
    for name, pair in opt_state.moments.items():
        dim = parts.get(name)
        if dim is not None:
            pair = tuple(col.all_gather(t, mesh.data_group, dim) for t in pair)
        moments[name] = tuple(full(name, t) for t in pair)
    return params, OptState(moments, opt_state.count)


def _strip_ddp_prefix(state_dict: dict) -> dict:
    # reference: train.py:98 — DDP wraps keys as 'module.<name>'
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def _load(path: str) -> dict:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def _fill_params(model: torch.nn.Module, net: dict, mesh=None) -> None:
    net = _strip_ddp_prefix(net)
    if mesh is not None:
        net = {n: shard(n, t, mesh) for n, t in net.items()}
    with torch.no_grad():
        model.load_state_dict(net, strict=True)


def load_checkpoint(path: str, model: torch.nn.Module, opt_state, mesh=None) -> dict:
    """Restore ``model``'s parameters and ``opt_state`` (moments and
    update count) in place from a ``step_N.pth``; returns the meta
    ``{'step', 'epoch', 'batch_in_epoch'}``. On a ``mesh``, each full
    tensor is cut to this rank's shard (and ZeRO-1 slice)."""
    ckpt = _load(path)
    _fill_params(model, ckpt["net"], mesh)
    optimizer = ckpt.get("optimizer") or {}
    state = optimizer.get("state") or {}
    names = [n for n, _ in model.named_parameters()]
    # torch's AdamW indexes every parameter it was given but keeps state
    # only for those it stepped: the reference never steps the unused
    # pooler, so a reference save has no entry for it, and its moments
    # start at zero (JAX export/from_torch.py:134-187 aligns them so)
    indexed = sum(len(g["params"]) for g in optimizer.get("param_groups") or []) or len(state)
    if indexed != len(names) or not state:
        raise ValueError(
            f"{path}: optimizer state indexes {indexed} parameters ({len(state)} with "
            f"state), the model has {len(names)}"
        )
    count = 0
    with torch.no_grad():
        for i, name in enumerate(names):
            entry = state.get(i, state.get(str(i)))
            mu, nu = opt_state.moments[name]
            if entry is None:
                mu.zero_()
                nu.zero_()
                continue
            for dst, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                src = entry[key]
                if mesh is not None:
                    src = shard(name, src, mesh)
                    if opt_state.zero1 is not None:
                        src = zero1_shard(name, src, entry[key].shape, mesh)
                dst.copy_(src)
            count = max(count, int(entry["step"]))
    opt_state.count = count
    return {"step": int(ckpt.get("step", 0)), "epoch": int(ckpt.get("epoch", 0)),
            "batch_in_epoch": int(ckpt.get("batch_in_epoch", 0))}


def load_checkpoint_meta(path: str) -> dict:
    """Just the ``{'step', 'epoch', ...}`` meta of a ``.pth`` (a bare
    state dict has none: zeros)."""
    ckpt = _load(path)
    if isinstance(ckpt, dict) and "net" in ckpt:
        return {"step": int(ckpt.get("step", 0)), "epoch": int(ckpt.get("epoch", 0)),
                "batch_in_epoch": int(ckpt.get("batch_in_epoch", 0))}
    return {"step": 0, "epoch": 0, "batch_in_epoch": 0}


def load_params_only(path: str, model: torch.nn.Module, mesh=None) -> None:
    """Warm-start: restore parameters only, ignore optimizer state
    (reference pretrained_model semantics, train.py:274-276). Accepts a
    training save (``{'net': ...}``: the port's, the reference's, or
    ``pl_bert_tpu.export.to_torch``'s) or a bare model state dict. On a
    ``mesh``, each tensor is cut to this rank's shard."""
    ckpt = _load(path)
    _fill_params(model, ckpt["net"] if isinstance(ckpt, dict) and "net" in ckpt else ckpt,
                 mesh)
