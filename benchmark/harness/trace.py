"""A traced slice of a run's window: ``torch.profiler`` with the CPU and CUDA
activities, its Chrome trace read into a summary that the per-layer metrics
read.

The reading follows the port's ``devtime.parse_trace`` (frozen here, with
the additions below): device ops are the events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; a device op belongs to the CPU range
(``user_annotation``) during which its launch (the ``cuda_runtime`` or
``cuda_driver`` event of the same ``correlation``) took place on the same
thread.

The summary (JSON-able, so that a rank can hand it to the parent):
- ``window_s``: the slice, the span of the range ``bench_slice``;
- ``busy_s``: the union of the device ops' intervals inside the slice;
- ``ops``: name -> [count, seconds] of the device ops inside the slice;
- ``ops_by_range``: range name -> name -> [count, seconds], for the ops
  whose launch lies in a range the benchmark opened (``SPAN_PREFIX``);
- ``gaps``: what the host was doing while the device was idle: for each
  idle gap inside the slice, the host event (a CPU op or range; outermost)
  that covers most of the gap on the thread that launched the op ending
  it, else on the thread most busy in the gap, seconds summed by that
  event's name (``idle`` where none ran).
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import shutil
import tempfile

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
SLICE = "bench_slice"
SPAN_PREFIX = "bench:"


class Profiler:
    """Starts and stops a profiler around a slice (each a synchronise of the
    card); ``summarize`` once the window has closed reads the trace from a
    temporary directory (under ``TMPDIR``), removed once read."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             experimental_config=_all_threads())
        self._range = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.start()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()

    def summarize(self) -> dict:
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            return summarize(load_events(path))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def _all_threads():
    """CPU ops of every thread (the service's dispatcher launches from a
    thread of its own), where this PyTorch has the option.  Read the trace
    before any profiled thread ends."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up: CUPTI's first start is
    slow, and must not fall inside the window."""
    p = Profiler()
    p.start()
    torch.zeros(1, device="cuda").add_(1)
    p.stop()


def load_events(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]


def _corr(e: dict):
    return (e.get("args") or {}).get("correlation")


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: list[dict]) -> dict:
    """The summary of one trace (module docstring); times in seconds."""
    slices = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == SLICE]
    if not slices:
        raise ValueError(f"the trace holds no range {SLICE!r}")
    lo = float(slices[0]["ts"])
    hi = lo + float(slices[0].get("dur", 0))
    launches = {_corr(e): e for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and _corr(e) is not None}
    spans: dict[object, list[tuple[float, float, str]]] = {}
    cpu_ops: dict[object, list[tuple[float, float, str]]] = {}
    for e in events:
        cat, name = e.get("cat"), str(e.get("name", ""))
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.setdefault(e.get("tid"), []).append((ts, end, name[len(SPAN_PREFIX):]))
        elif cat in HOST_CATEGORIES and name != SLICE and not name.startswith("PyTorch Profiler"):
            cpu_ops.setdefault(e.get("tid"), []).append((ts, end, name))
    span_index = {tid: ([a for a, _, _ in sorted(v)], sorted(v)) for tid, v in spans.items()}
    outer = {tid: _outermost(v) for tid, v in cpu_ops.items()}
    ops: dict[str, list] = {}
    by_range: dict[str, dict[str, list]] = {}
    intervals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if end <= lo or ts >= hi:
            continue
        ts, end = max(ts, lo), min(end, hi)
        name = str(e.get("name", ""))
        entry = ops.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (end - ts) * 1e-6
        intervals.append((ts, end, e))
        launch = launches.get(_corr(e))
        if launch is not None:
            rng = _covering(span_index.get(launch.get("tid"), ([], [])), float(launch["ts"]))
            if rng is not None:
                r = by_range.setdefault(rng, {}).setdefault(name, [0, 0.0])
                r[0] += 1
                r[1] += (end - ts) * 1e-6
    busy = _union([(a, b) for a, b, _ in intervals])
    gaps: dict[str, float] = {}
    starts = sorted(((a, e) for a, _, e in intervals), key=lambda x: x[0])
    start_ts = [s for s, _ in starts]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        i = bisect.bisect_left(start_ts, b)
        what = None
        if i < len(starts):
            launch = launches.get(_corr(starts[i][1]))
            if launch is not None:
                what = _host_activity(outer.get(launch.get("tid"), ([], [])), a, b)
        if what is None:  # nothing on the launching thread: any thread's
            found = [(_overlap(o, a, b), _host_activity(o, a, b)) for o in outer.values()]
            what = max(found, default=(0.0, None))[1] or "idle"
        gaps[what] = gaps.get(what, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "ops": ops,
        "ops_by_range": by_range,
        "gaps": gaps,
    }


def _covering(index, t: float) -> str | None:
    """The name of the benchmark's range (not nested in one another) that
    holds time ``t`` on a thread, or None."""
    starts, ranges = index
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i][1] >= t:
        return ranges[i][2]
    return None


def _outermost(ops: list[tuple[float, float, str]]):
    """The ops of one thread that no other op of it encloses, by start, and
    their starts."""
    out, end = [], -1.0
    for s, e, name in sorted(ops):
        if s >= end:
            out.append((s, e, name))
            end = e
    return [s for s, _, _ in out], out


def _overlap(outer, a: float, b: float) -> float:
    starts, ops = outer
    return sum(max(min(e, b) - max(s, a), 0.0)
               for s, e, _ in ops[max(bisect.bisect_right(starts, a) - 1, 0):] if s < b)


def _host_activity(outer, a: float, b: float) -> str | None:
    """The outermost CPU op that overlaps [a, b] most."""
    starts, ops = outer
    best, best_overlap = None, 0.0
    for s, e, name in ops[max(bisect.bisect_right(starts, a) - 1, 0):]:
        if s >= b:
            break
        overlap = min(e, b) - max(s, a)
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    return best


def top(table: dict, n: int = 10) -> list[list]:
    """The ``n`` largest entries of a name -> seconds (or [count, seconds])
    table as [[name, seconds], ...]."""
    items = [(k, v[1] if isinstance(v, list) else v) for k, v in table.items()]
    return [[k, s] for k, s in sorted(items, key=lambda kv: -kv[1])[:n]]
