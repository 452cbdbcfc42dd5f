"""Metrics and tracing (counterpart of ``jointpose/metrics.py``).

``MetricLogger``: a JSONL event stream, ``<workdir>/metrics.jsonl``, with
the reference's records (``step``, ``time`` and the keyword metrics,
scalars as floats), echoed to stdout, and a tensorboardX writer beside it
where one is asked for and tensorboardX is importable.

``ProfilerHook``: a ``torch.profiler`` trace of a window of whole
dispatches of training steps, with the CPU and (where the process has
CUDA) the CUDA activity, written to ``<workdir>/profile/`` as a Chrome
trace that ``devtime.parse_trace(trace_dir, "train")`` reads and
TensorBoard's profile plugin shows.

``span(name)``: a ``torch.profiler`` range ``jointpose/<name>`` around a
layer's host work while a profiler is collecting, in the same trace and
on the same clock as the kernels it launches; with no profiler
collecting, a shared null context, at the cost of one flag's check.  The
spans are flat: none encloses another on a thread.

- the predictor (``predict.predictor_for``), eagerly: ``input`` (the
  batch's copy to the device), ``detector`` and ``mrf``
  (``PoseModel.forward``), and ``decode`` (heatmaps and coordinates); by
  its CUDA graph (``predict.PredictorGraphs``): ``input`` (the copy into
  the graph's static buffer) and ``replay`` (the graph's launch and the
  clones of its outputs).  A key's capture opens the eager call's spans
  once.  Its counters ``PredictorGraphs.captures`` and ``.replays``
  (``predict.graphs`` on the returned function) count the calls that
  captured a graph and those that replayed one captured before;
- the K-step dispatch (``train.DispatchGraphs.run``, ``_eager_steps``):
  ``dispatch.prepare`` (the graphs' refresh and the static inputs'
  copies), ``dispatch.rates`` (the K learning rates), ``dispatch.replay``
  (the graph's launch and the launch counters it adds) and
  ``dispatch.outputs`` (the step count, gradients and metrics after it).
  No span encloses a capture, which would enclose the model's spans;
- the fused Fourier MRF pass's backward (``ops/mrf_fft_fused._FusedPass``):
  ``mrf.vjp`` (the plain Fourier pass recomputed under autograd and its
  VJP), on the thread that runs the backward (the autograd engine's, on
  the card), once a step.  Its counter ``_FusedPass.recomputes`` is one
  of ``ops.launch_counters()``, so a replayed K-step graph adds K to it.
  A replayed graph opens no host span: there the recompute shows only as
  its kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "jointpose/"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range ``jointpose/<name>`` while a profiler collects, else a null
    context (the module docstring)."""
    # A flag that profile.start() and stop() set: record_function costs
    # microseconds an entry even with no profiler running.
    if _autograd_profiler._is_profiler_enabled:
        return record_function(SPAN_PREFIX + name)
    return _NO_SPAN


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
    """A ``torch.profiler`` trace of whole dispatches of training steps:
    from the first dispatch that holds a step at or after ``start_step``
    and that the loop calls ``ready``, through the dispatch that brings
    the traced steps to ``num_steps`` or more.

    The loop calls ``on_step(step, steps, ready)`` before each dispatch
    (steps ``step`` to ``step + steps - 1``) and runs the dispatch inside
    ``annotation(step)``, a range named ``train#<step>``.  The trace starts
    once the card has finished the earlier dispatches, and is written at
    the first dispatch boundary past the window (or at ``close``, if
    training ends first), once the card has finished the window's work.

    The trace goes to ``<workdir>/profile``; with ``rank`` (a rank of a
    mesh of several processes, each tracing its own window) to
    ``<workdir>/profile/rank<rank>``.  ``devtime.parse_trace`` reads the
    newest trace under the directory it is given, its subdirectories
    included: over a mesh, name a rank's directory.
    """

    def __init__(self, workdir: str, start_step: int, num_steps: int, rank: int | None = None):
        self.trace_dir = os.path.join(workdir, "profile")
        if rank is not None:
            self.trace_dir = os.path.join(self.trace_dir, f"rank{rank}")
        self.start_step = start_step
        self.num_steps = num_steps
        self.stop_step: int | None = None  # set when the window opens
        self._prof = None

    def on_step(self, step: int, steps: int = 1, ready: bool = True) -> None:
        if self.stop_step is None:
            if ready and step + steps > self.start_step:
                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                    torch.cuda.synchronize()  # the window holds its own dispatches' work alone
                self._prof = profile(activities=activities)
                self._prof.start()
                self.stop_step = step + self.num_steps
        elif step >= self.stop_step and self._prof is not None:
            self._stop()

    def close(self) -> None:
        """Write a trace still open (training ended before the window did)."""
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        from jointpose_torch.devtime import trace_path

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        prof.export_chrome_trace(trace_path(self.trace_dir))

    def annotation(self, step: int):
        return record_function(f"train#{step}")
