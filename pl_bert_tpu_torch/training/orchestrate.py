"""Elastic launch / preemption handling.

A copy of ``pl_bert_tpu/training/orchestrate.py`` (``RestartTracker``
:28, ``launch`` :60, ``launch_subprocess`` :96, ``main`` :165) over the
port's Trainer: the reference's Modal orchestration (reference:
modal_main.py:5-51) counts pre-emptions in a ``modal.Dict`` and relies on
Modal restarting the 24h-timeout function, with filename-based
auto-resume doing the rest. Here the same semantics run anywhere: a
file-backed restart tracker (persistent across preemptions when placed
on durable storage), a supervised retry loop that relaunches training
after crashes/preemptions, and the trainer's own ``step_N.pth``
auto-resume (training/train.py) continuing from the last checkpoint.

CLI: ``python -m pl_bert_tpu_torch.training.orchestrate --config_path ...
--run_name ... [--max_restarts N] [--device cuda|cpu]``; ``--device``
(default ``cuda``) is passed on to each training child.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback


class RestartTracker:
    """File-backed preemption counter (reference: modal_main.py:9-18)."""

    def __init__(self, state_path: str) -> None:
        self.state_path = state_path

    def track(self) -> int:
        state = {}
        if os.path.exists(self.state_path):
            try:
                with open(self.state_path) as f:
                    state = json.load(f)
            except (OSError, ValueError):
                state = {}
        if "count" not in state:
            count = 0
            print(f"Starting first time. preemption_count={count}")
        else:
            count = int(state["count"]) + 1
            print(f"Restarting after pre-emption. preemption_count={count}")
        state["count"] = count
        state["last_start"] = time.time()
        os.makedirs(os.path.dirname(os.path.abspath(self.state_path)), exist_ok=True)
        # atomic write: a preemption mid-dump would otherwise truncate
        # the file and reset the very counter that counts preemptions
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.state_path)
        return count


def launch(
    args: dict,
    max_restarts: int = 100,
    restart_delay: float = 10.0,
    train_fn=None,
) -> int:
    """Supervised training loop: restart (with auto-resume) after any
    crash/preemption, up to ``max_restarts`` times."""
    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.training.train import train

    train_fn = train_fn or train
    config = Config.load(args["config_path"])
    run_dir = os.path.join(config.training_params.output_dir, args["run_name"])
    tracker = RestartTracker(os.path.join(run_dir, "restart_tracker.json"))

    attempts = 0
    while True:
        tracker.track()
        try:
            return train_fn(args)
        except KeyboardInterrupt:
            raise
        except Exception:
            attempts += 1
            traceback.print_exc()
            if attempts > max_restarts:
                print(f"Giving up after {max_restarts} restarts")
                raise
            print(
                f"Training attempt {attempts} failed; restarting in "
                f"{restart_delay}s (auto-resume from latest step_N)"
            )
            time.sleep(restart_delay)


def launch_subprocess(
    args: dict,
    max_restarts: int = 100,
    restart_delay: float = 10.0,
    env: dict | None = None,
) -> int:
    """Supervised training with WHOLE-PROCESS restarts.

    Matches the reference's Modal semantics (a preempted run comes back
    in a fresh container, reference: modal_main.py:40-47): each attempt
    is a new ``python -m pl_bert_tpu_torch.training.train --device
    <args["device"]>`` process, so a wedged CUDA context from the failed
    attempt cannot leak into the retry (unlike :func:`launch`, which
    retries in-process). Auto-resume from the latest ``step_N.pth``
    checkpoint is the trainer's own behavior.

    The child's pid is written to ``<run_dir>/launcher_child.pid`` for
    external supervision (and for the kill-mid-run test).
    Returns the final child's exit code (0 on success).
    """
    from pl_bert_tpu_torch.config import Config

    config = Config.load(args["config_path"])
    run_dir = os.path.join(config.training_params.output_dir, args["run_name"])
    os.makedirs(run_dir, exist_ok=True)
    tracker = RestartTracker(os.path.join(run_dir, "restart_tracker.json"))
    pid_path = os.path.join(run_dir, "launcher_child.pid")

    attempts = 0
    while True:
        tracker.track()
        cmd = [
            sys.executable, "-m", "pl_bert_tpu_torch.training.train",
            "--config_path", args["config_path"],
            "--run_name", args["run_name"],
            "--device", args.get("device", "cuda"),
        ]
        proc = subprocess.Popen(cmd, env=env if env is not None else None)
        with open(pid_path, "w") as f:
            f.write(str(proc.pid))
        try:
            rc = proc.wait()
        except BaseException:
            # launcher dying (supervisor SIGTERM → KeyboardInterrupt /
            # SystemExit) must not orphan a live trainer: a relaunched
            # launcher would start a SECOND trainer racing the first on
            # the same run dir's checkpoints and restart tracker
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
            raise
        if rc == 0:
            return 0
        attempts += 1
        if attempts > max_restarts:
            raise RuntimeError(
                f"training child kept failing (rc={rc}) after "
                f"{max_restarts} restarts"
            )
        print(
            f"Training child exited rc={rc} (attempt {attempts}); "
            f"relaunching in {restart_delay}s (auto-resume from latest "
            f"step_N)",
            flush=True,
        )
        time.sleep(restart_delay)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Elastic PL-BERT training launch")
    parser.add_argument("--config_path", type=str, default="configs/config.yml")
    parser.add_argument("--run_name", type=str, default="default")
    parser.add_argument("--max_restarts", type=int, default=100)
    parser.add_argument("--restart_delay", type=float, default=10.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu, passed on to the trainer")
    parser.add_argument(
        "--in_process", action="store_true",
        help="retry inside this process instead of relaunching a child "
        "(subprocess relaunch is the default: it matches the reference's "
        "fresh-container-per-preemption semantics)",
    )
    a = parser.parse_args(argv)
    launcher = launch if a.in_process else launch_subprocess
    launcher(
        {"config_path": a.config_path, "run_name": a.run_name, "device": a.device},
        max_restarts=a.max_restarts,
        restart_delay=a.restart_delay,
    )


if __name__ == "__main__":
    main()
