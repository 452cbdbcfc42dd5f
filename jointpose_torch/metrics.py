"""Metrics and tracing (counterpart of ``jointpose/metrics.py``).

``MetricLogger``: a JSONL event stream, ``<workdir>/metrics.jsonl``, with
the reference's records (``step``, ``time`` and the keyword metrics,
scalars as floats), echoed to stdout, and a tensorboardX writer beside it
where one is asked for and tensorboardX is importable.

``ProfilerHook``: a ``torch.profiler`` trace of a window of training
steps, with the CPU and (where the process has CUDA) the CUDA activity,
written to ``<workdir>/profile/`` as a Chrome trace that
``devtime.parse_trace(trace_dir, "train")`` reads and TensorBoard's
profile plugin shows.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    def __init__(self, workdir: str, use_tensorboard: bool = False, enabled: bool = True):
        # ``enabled=False`` makes every method a no-op, so that in a run of
        # several processes one of them alone owns metrics.jsonl while the
        # call sites stay the same in all.
        self.enabled = enabled
        self._file = None
        self._tb = None
        if not enabled:
            self.path = None
            return
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "metrics.jsonl")
        self._file = open(self.path, "a", buffering=1)
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(workdir, "tb"))
            except ImportError:
                pass

    def log(self, step: int, **metrics: Any) -> None:
        if not self.enabled:
            return
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._file.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                if hasattr(v, "__float__"):
                    self._tb.add_scalar(k, float(v), step)
        scalars = ", ".join(
            f"{k}={float(v):.4g}" for k, v in metrics.items() if hasattr(v, "__float__")
        )
        print(f"[step {step}] {scalars}", flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


class ProfilerHook:
    """A ``torch.profiler`` trace of steps ``start_step`` to
    ``start_step + num_steps - 1``.

    The loop calls ``on_step(step)`` before each step and runs the step
    inside ``annotation(step)``, a range named ``train#<step>``.  The trace
    starts at ``start_step``, once the card has finished the earlier
    steps, and is written when the window ends (or at ``close``, if
    training ends first), once the card has finished the window's work.
    """

    def __init__(self, workdir: str, start_step: int, num_steps: int):
        self.trace_dir = os.path.join(workdir, "profile")
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def on_step(self, step: int) -> None:
        if step == self.start_step and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()  # the window holds its own steps' work alone
            self._prof = profile(activities=activities)
            self._prof.start()
        elif step >= self.stop_step and self._prof is not None:
            self._stop()

    def close(self) -> None:
        """Write a trace still open (training ended before the window did)."""
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        import torch

        from jointpose_torch.devtime import trace_path

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        prof.export_chrome_trace(trace_path(self.trace_dir))

    def annotation(self, step: int):
        from torch.profiler import record_function

        return record_function(f"train#{step}")
