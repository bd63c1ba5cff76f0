"""Profiling / tracing support.

The counterpart of ``pl_bert_tpu/utils/profiler.py`` on
``torch.profiler``: Chrome traces (viewable in Perfetto) of host and
device activity, of every thread (the Trainer's prefetch thread among
them). Enable in training via the ``PLBERT_PROFILE_DIR`` env var (traces
the configured step window).

:func:`span` marks the port's layers on the training path in whatever
``torch.profiler`` runs: the feed, the step and its phases (masking,
forward, backward, optimizer) and the grapheme head's parts.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as _autograd_profiler

# the first part of every span name the port records on the training
# path (the grapheme head's ``lm_head.*`` ranges keep their own names)
PREFIX = "plbert."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A range called ``name`` in the trace of a running
    ``torch.profiler``, on its clock, with the device time of the kernels
    launched inside it (``device_time_total``); one shared no-op context
    when no profiler runs, so the check is all an untraced step pays.

    The range is a plain function-scope record, not a
    ``record_function`` user annotation: a user annotation also leaves a
    copy of itself among the device's events, which a reader of the
    trace would count as a kernel. The module-level flag is read because
    it is True in every thread while a profiler runs, where
    ``torch.autograd._profiler_enabled()`` answers for the calling
    thread alone."""
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def _start():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # every thread's ranges: without it the profiler records only the
    # thread that started it, and the feed's spans are lost
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(activities=acts, experimental_config=every_thread)
    prof.start()
    return prof


def _stop(prof, log_dir: str, name: str) -> str:
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    return path


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
