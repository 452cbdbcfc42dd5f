"""Device time measured from a ``torch.profiler`` trace (counterpart of
``jointpose/devtime.py``).

``measure_device_time`` runs a function a number of times under
``torch.profiler`` with the CPU and CUDA activities, each run inside a
``record_function`` range named ``<program>#<i>``, exports the Chrome
trace and parses it; ``parse_trace`` reads such a trace, or the one
``metrics.ProfilerHook`` writes for a window of ``fit`` (ranges
``train#<step>``).

What the trace gives:

- device ops: the events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``, summed per name with counts.  ``gpu_user_annotation``
  events are left out: they span kernels that are already counted.
- per-run device time: each run is a CPU range (a ``user_annotation``
  event named ``<program>`` or ``<program>#<n>``); a device op belongs to
  the run during which its launch (the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``correlation``) took place, on any
  thread, so the backward pass, which autograd launches from a thread of
  its own, counts with its step.  A run's device time is the span from
  the start of its first device op to the end of its last: its kernels
  and the gaps between them, as the reference's per-run time is the
  device duration of one executable.  The device-busy time of a run is
  the sum of its ops' times (``sum(o.duration_s for o in ops) /
  num_runs``).  Launches of kernels the trace holds no launch event for
  are counted in ``ops`` and belong to no run.

Trace timestamps are microseconds.  A CUDA trace holds no FLOP or byte
counts (``perf.count_cost`` counts both).
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
import shutil
import socket
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


@dataclass
class OpTime:
    """One device op's time, summed over every launch in a trace."""

    name: str
    duration_s: float
    category: str = ""
    count: int = 0


@dataclass
class DeviceTiming:
    """Parsed device-side timing of one traced program."""

    # Per-run device time (first device op's start to last one's end), s.
    run_durations_s: list[float]
    ops: list[OpTime] = field(default_factory=list)

    @property
    def num_runs(self) -> int:
        return len(self.run_durations_s)

    @property
    def median_run_s(self) -> float:
        d = sorted(self.run_durations_s)
        return d[len(d) // 2] if d else float("nan")

    def top_ops(self, n: int = 12) -> list[OpTime]:
        return sorted(self.ops, key=lambda o: -o.duration_s)[:n]


def trace_path(trace_dir: str) -> str:
    """Where a new trace goes: TensorBoard's profile plugin names."""
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    return os.path.join(trace_dir, name)


def _load_trace_events(trace_dir: str) -> list[dict]:
    paths = [p for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)]
    if not paths:
        return []
    latest = max(paths, key=os.path.getmtime)
    opener = gzip.open if latest.endswith(".gz") else open
    with opener(latest, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _correlation(event: dict):
    return (event.get("args") or {}).get("correlation")


def parse_trace(trace_dir: str, program_name: str) -> DeviceTiming | None:
    """Device timing of the runs of ``program_name`` in the newest Chrome
    trace under ``trace_dir``, its subdirectories included (see the module
    docstring): a profiled ``fit`` over a mesh writes a trace for each rank
    under ``<workdir>/profile/rank<r>/``, so name a rank's directory there,
    or its newest trace of any rank is read.  None when the
    trace holds no device op launched inside a run of the program: no
    trace, a trace of the CPU alone, or no such run."""
    events = [e for e in _load_trace_events(trace_dir) if e.get("ph") == "X"]
    run_name = re.compile(rf"{re.escape(program_name)}(#\d+)?")
    runs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                  if e.get("cat") == "user_annotation" and run_name.fullmatch(str(e.get("name"))))
    launches = {_correlation(e): float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and _correlation(e) is not None}
    starts = [r[0] for r in runs]
    spans: dict[int, tuple[float, float]] = {}
    ops: dict[str, OpTime] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        name = str(e.get("name", ""))
        op = ops.get(name)
        if op is None:
            op = ops[name] = OpTime(name=name, duration_s=0.0, category=e["cat"])
        op.duration_s += dur * 1e-6
        op.count += 1
        launched = launches.get(_correlation(e))
        i = bisect.bisect_right(starts, launched) - 1 if launched is not None else -1
        if i >= 0 and launched <= runs[i][1]:
            lo, hi = spans.get(i, (ts, ts + dur))
            spans[i] = (min(lo, ts), max(hi, ts + dur))
    if not spans:
        return None
    return DeviceTiming(run_durations_s=[(hi - lo) * 1e-6 for _, (lo, hi) in sorted(spans.items())],
                        ops=sorted(ops.values(), key=lambda o: -o.duration_s))


def measure_device_time(
    fn, *args, iters: int = 10, warmup: int = 2, trace_dir: str | None = None,
    program_name: str | None = None,
) -> DeviceTiming | None:
    """Run ``fn(*args)`` ``iters`` times under a profiler trace, after
    ``warmup`` untraced calls (cuDNN's algorithm choice, kernel builds);
    return the measured timing, or None when the trace holds no device
    events (on the CPU).  The trace is kept only in a ``trace_dir`` the
    caller gives; a directory of its own is removed in every case."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    name = program_name or getattr(fn, "__name__", None) or "fn"
    cuda = torch.cuda.is_available()
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
    own = trace_dir is None
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="jp_devtime_")
    try:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            for i in range(iters):
                with record_function(f"{name}#{i}"):
                    fn(*args)
            if cuda:
                torch.cuda.synchronize()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(trace_path(trace_dir))
        return parse_trace(trace_dir, name)
    finally:
        if own:
            shutil.rmtree(trace_dir, ignore_errors=True)
