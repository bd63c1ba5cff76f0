"""Metrics tracking / logging.

A copy of ``pl_bert_tpu/training/metrics.py`` (``is_main_process``,
``MetricsLogger``); the main process is rank 0 of a ``torch.distributed``
world, as JAX's is process 0.

Reference contract (reference: train.py:231-240, 392-410): per-step
phoneme_loss, rolling mean over ``log_interval`` steps, validation loss
each save interval, all rank-0 gated; wandb backend when available.

Additions: a JSONL metrics file in the run dir (observability without
network egress), throughput (steps/sec, and tokens/sec over the tokens
the caller counts: the port's Trainer counts real, non-pad ones), and
where the caller passes them, the mean host wait a step for the batch
(``feed_wait_ms``) and the grapheme head's full-length fallbacks
(``lm_head_fallbacks``) since the last record.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque

import numpy as np


def is_main_process() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` world, or the one
    process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


class MetricsLogger:
    def __init__(
        self,
        log_dir: str,
        log_interval: int = 10,
        wandb_project: str = "",
        config: dict | None = None,
    ) -> None:
        self.log_interval = log_interval
        self.rolling = deque(maxlen=log_interval)
        self.enabled = is_main_process()
        self._pending = None
        self._wandb = None
        self._file = None
        self._last_time = time.perf_counter()
        self._last_step = None
        self._window_tokens = 0
        self._window_steps = 0
        self._window_wait_s = None
        self._window_fallbacks = None
        if not self.enabled:
            return
        if wandb_project:
            try:
                import wandb

                wandb.init(project=wandb_project, config=config or {})
                self._wandb = wandb
            except Exception as e:  # wandb absent or offline — degrade
                print(f"[metrics] wandb unavailable ({e}); using stdout/jsonl")
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    def log_step(self, step: int, epoch: int, metrics: dict, tokens_per_batch: int = 0,
                 feed_wait_s: float | None = None, lm_head_fallbacks: int | None = None):
        """Record one step's metrics; ``feed_wait_s`` (host seconds the
        step waited for its batch) and ``lm_head_fallbacks`` (the
        grapheme head's full-length fallbacks in the step) are summed up
        to the next record.

        ``metrics`` values may be device arrays — they are buffered as-is
        and only materialized every ``log_interval`` steps, so logging
        adds NO host-device synchronization to the steps in between
        (the reference's ``.item()`` per step forces one; with CUDA's
        asynchronous launches that would serialize every step)."""
        if not self.enabled:
            return
        self.rolling.append(metrics.get("phoneme_loss", metrics.get("loss", 0.0)))
        # accumulate EVERY step's real token count: throughput must be
        # window-total / window-time, not steps/sec × the boundary
        # step's tokens (a ragged grad-accum tail landing on the log
        # boundary would scale the whole window down by its fraction)
        self._window_tokens += tokens_per_batch
        self._window_steps += 1
        if feed_wait_s is not None:
            self._window_wait_s = (self._window_wait_s or 0.0) + feed_wait_s
        if lm_head_fallbacks is not None:
            self._window_fallbacks = (self._window_fallbacks or 0) + lm_head_fallbacks
        if step % self.log_interval != 0:
            # keep the newest metrics so flush() can emit the final
            # partial window at the end of training
            self._pending = (step, epoch, metrics, tokens_per_batch)
            return
        self._pending = None
        record = {
            "step": step,
            "epoch": epoch,
            **{k: float(v) for k, v in metrics.items()},
        }
        loss = record.get("phoneme_loss", record.get("loss", 0.0))
        if len(self.rolling) == self.log_interval:
            record["phoneme_loss_avg"] = float(
                np.mean([float(v) for v in self.rolling])
            )
        now = time.perf_counter()
        if self._last_step is not None and now > self._last_time:
            sps = (step - self._last_step) / (now - self._last_time)
            record["steps_per_sec"] = sps
            if self._window_tokens:
                record["tokens_per_sec"] = (
                    self._window_tokens / (now - self._last_time)
                )
        self._last_time, self._last_step = now, step
        self._window_tokens = 0
        self._emit(self._with_counters(record))
        parts = [f"step {step}", f"epoch {epoch}", f"loss {loss:.4f}"]
        if "phoneme_loss_avg" in record:
            parts.append(f"avg {record['phoneme_loss_avg']:.4f}")
        if "tokens_per_sec" in record:
            parts.append(f"{record['tokens_per_sec']:,.0f} tok/s")
        print("  ".join(parts), flush=True)

    def flush(self) -> None:
        """Emit the final partial-step record (training ended off the
        log_interval grid)."""
        if not self.enabled or getattr(self, "_pending", None) is None:
            return
        step, epoch, metrics, _ = self._pending
        self._pending = None
        record = {
            "step": step,
            "epoch": epoch,
            **{k: float(v) for k, v in metrics.items()},
        }
        self._emit(self._with_counters(record))

    def _with_counters(self, record: dict) -> dict:
        """``record`` with the counters summed since the last record (the
        feed wait as a mean a step, in ms), which start again from 0."""
        if self._window_wait_s is not None:
            record["feed_wait_ms"] = 1e3 * self._window_wait_s / max(self._window_steps, 1)
        if self._window_fallbacks is not None:
            record["lm_head_fallbacks"] = self._window_fallbacks
        self._window_steps, self._window_wait_s, self._window_fallbacks = 0, None, None
        return record

    def log_validation(
        self, step: int, epoch: int, val_loss: float, val_acc: float,
        extras: dict | None = None,
    ):
        """``extras`` carries the multi-task grapheme-head metrics
        (val_token_loss/val_token_accuracy) when the Trainer runs with
        token ids; merged into the same record."""
        if not self.enabled:
            return
        self._emit(
            {
                "step": step,
                "epoch": epoch,
                "val_phoneme_loss": val_loss,
                "val_masked_accuracy": val_acc,
                **(extras or {}),
            }
        )
        line = (
            f"Validation at step {step}: Phoneme Loss: {val_loss:.4f} "
            f"Masked Acc: {val_acc:.4f}"
        )
        if extras:
            line += (
                f" Token Loss: {extras['val_token_loss']:.4f} "
                f"Token Acc: {extras['val_token_accuracy']:.4f}"
            )
        print(line, flush=True)

    def _emit(self, record: dict) -> None:
        if self._wandb is not None:
            self._wandb.log(record)
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
