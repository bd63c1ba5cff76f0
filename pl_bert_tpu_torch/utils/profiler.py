"""Profiling / tracing support.

The counterpart of ``pl_bert_tpu/utils/profiler.py`` on
``torch.profiler``: Chrome traces (viewable in Perfetto) of host and
device activity. Enable in training via the ``PLBERT_PROFILE_DIR`` env
var (traces the configured step window) or use :func:`profile_trace`
directly around any region.
"""

from __future__ import annotations

import contextlib
import os

import torch


def _start():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop(prof, log_dir: str, name: str) -> str:
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace for the enclosed region into
    ``log_dir/trace.json``."""
    prof = _start()
    try:
        yield log_dir
    finally:
        _stop(prof, log_dir, "trace.json")


class maybe_profile:
    """Step-window profiler driven by env vars:

    - ``PLBERT_PROFILE_DIR``: trace output directory (unset → disabled)
    - ``PLBERT_PROFILE_START`` (default 10) / ``PLBERT_PROFILE_STEPS``
      (default 5): which training steps to capture.

    Call ``tick(step)`` once per training step.
    """

    def __init__(self) -> None:
        self.log_dir = os.environ.get("PLBERT_PROFILE_DIR", "")
        self.start = int(os.environ.get("PLBERT_PROFILE_START", "10"))
        self.steps = int(os.environ.get("PLBERT_PROFILE_STEPS", "5"))
        self._prof = None
        self._done = False

    def tick(self, step: int) -> None:
        if not self.log_dir or self._done:
            return
        if self._prof is None and self.start <= step < self.start + self.steps:
            # strictly inside the window: a resumed run whose first tick
            # already jumped PAST it must capture nothing rather than a
            # 1-step trace at an arbitrary step
            self._prof = _start()
        elif step >= self.start + self.steps:
            self._done = True
            self.close()

    def close(self) -> None:
        """Stop an open window (training ended/crashed inside it) — the
        trace is written only on stop, so skipping this silently discards
        the capture. Trainer.train() calls it on the way out."""
        if self._prof is not None:
            prof, self._prof = self._prof, None
            self._done = True
            path = _stop(prof, self.log_dir, f"trace_step_{self.start}.json")
            print(f"[profiler] trace written to {path}", flush=True)
