"""Standalone checkpoint evaluation: phoneme loss and masked accuracy on
the validation split, without a training run.

The counterpart of ``pl_bert_tpu/training/evaluate.py`` (:102
``evaluate``, :120 ``evaluate_all``, :155 ``main``): any checkpoint is
scored against the dataset the YAML configures, with the Trainer's own
validation — the same 95/5 split, the same masking stream, the same
padding — on an eval-only Trainer (no AdamW state, no train step).

Accepted checkpoints: a ``step_N.pth`` (the port's Trainer's, the
reference's, or ``pl_bert_tpu.export.to_torch``'s), a bare model state
dict, or a run directory, whose latest ``step_N.pth`` is taken (the
resume rule)::

    python -m pl_bert_tpu_torch.training.evaluate \\
        --config_path configs/config.yml --checkpoint runs/r/step_1000.pth \\
        [--device cpu]

Prints ONE JSON line ``{"checkpoint", "val_phoneme_loss",
"val_masked_accuracy", "val_batches"}``, plus ``{"val_token_loss",
"val_token_accuracy"}`` for a multi-task config. With ``--all`` the
checkpoint is a run directory and every ``step_N.pth`` in it is scored
(ascending, one line each, one Trainer), then a summary line names the
best by ``val_phoneme_loss``. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.training.checkpoint import (
    checkpoint_path,
    find_latest_checkpoint,
    list_checkpoints,
    load_params_only,
)


def _resolve_checkpoint(path: str) -> str:
    """A run directory resolves to its latest step_N.pth; a file passes
    through."""
    if os.path.isdir(path):
        found, latest = find_latest_checkpoint(path)
        if found:
            return checkpoint_path(path, latest)
    return path


def _load_config(args: dict) -> Config:
    config = Config.load(args["config_path"])
    # the scored parameters come from --checkpoint alone, never from a
    # warm start
    config.model_params = dataclasses.replace(config.model_params, pretrained_model="")
    if args.get("dataset_path"):
        config.training_params = dataclasses.replace(
            config.training_params, training_dataset=args["dataset_path"]
        )
    return config


def _score(trainer, ckpt: str) -> dict:
    """Load ``ckpt``'s parameters into the live Trainer and validate."""
    load_params_only(ckpt, trainer.model, trainer.model.cfg.mesh)
    result = trainer.validate()
    if result is None:
        raise SystemExit(
            "no usable validation batches (empty split, or masking selected zero "
            "positions everywhere) — nothing to evaluate"
        )
    loss, acc = result
    out = {
        "checkpoint": ckpt,
        "val_phoneme_loss": round(loss, 6),
        "val_masked_accuracy": round(acc, 6),
        "val_batches": trainer._last_val_batches,
    }
    if trainer.last_val_extras:  # multi-task: the grapheme head's metrics
        out.update({k: round(v, 6) for k, v in trainer.last_val_extras.items()})
    print(json.dumps(out), flush=True)
    return out


def _with_trainer(args: dict, dataset, fn):
    from pl_bert_tpu_torch.training.train import Trainer

    config = _load_config(args)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(config, tmp, False, dataset=dataset,
                          device=args.get("device", "cuda"), eval_only=True)
        try:
            return fn(trainer)
        finally:
            trainer.metrics.close()


def evaluate(args: dict, dataset=None) -> dict:
    """Score one checkpoint (``args``: ``checkpoint``, ``config_path``
    [, ``dataset_path``, ``device``]); ``dataset`` overrides the
    configured one, as in ``training.train.train``."""
    ckpt = _resolve_checkpoint(args["checkpoint"])
    return _with_trainer(args, dataset, lambda trainer: _score(trainer, ckpt))


def evaluate_all(args: dict, dataset=None) -> list[dict]:
    """Score every step_N.pth of the run directory ``args["checkpoint"]``
    (ascending), then print a summary line naming the best (lowest
    ``val_phoneme_loss``). Validation masking is a fixed stream, so the
    scores compare across steps."""
    run_dir = args["checkpoint"]
    steps = list_checkpoints(run_dir)
    if not steps:
        raise SystemExit(f"no step_N.pth checkpoints under {run_dir!r}")
    results = _with_trainer(args, dataset, lambda trainer: [
        _score(trainer, checkpoint_path(run_dir, step)) for step in steps
    ])
    best = min(results, key=lambda r: r["val_phoneme_loss"])
    print(json.dumps({
        "best_checkpoint": best["checkpoint"],
        "best_val_phoneme_loss": best["val_phoneme_loss"],
        "checkpoints_scored": len(results),
    }), flush=True)
    return results


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Evaluate a checkpoint on the configured dataset's validation split "
        "(loss + masked accuracy)."
    )
    parser.add_argument("--checkpoint", required=True,
                        help="a step_N.pth, or a run dir (its latest step_N.pth)")
    parser.add_argument("--config_path", default="configs/config.yml",
                        help="YAML config naming the dataset and model shape")
    parser.add_argument("--dataset_path", default="",
                        help="override training_params.training_dataset")
    parser.add_argument("--all", action="store_true",
                        help="--checkpoint is a run dir: score every step_N.pth in it "
                        "(ascending) and report the best by val_phoneme_loss")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; a missing card is an error, not a "
                        "fallback")
    ns = parser.parse_args(argv)
    fn = evaluate_all if ns.all else evaluate
    fn({"checkpoint": ns.checkpoint, "config_path": ns.config_path,
        "dataset_path": ns.dataset_path, "device": ns.device})


if __name__ == "__main__":
    main()
