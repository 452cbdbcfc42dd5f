"""The contract of ``jointpose_torch.devtime.parse_trace``, the port's
counterpart of ``jointpose/devtime.py`` (tests/test_devtime.py holds the
reference's): Chrome traces in ``torch.profiler``'s format, written by the
test.  Device ops are chosen by category (kernels, copies, memsets; the
``gpu_user_annotation`` spans left out), summed per name with counts; a
run is a CPU range named ``<program>`` or ``<program>#<n>``, and its
device time is the span of the device ops launched inside it; None
without device events.  Also: ``measure_device_time`` on the CPU returns
None and leaves no directory behind."""

import glob
import gzip
import json
import os
import tempfile

import pytest
import torch

from jointpose_torch.devtime import DeviceTiming, measure_device_time, parse_trace

CPU_PID, GPU_PID = 100, 0


def write_trace(d, events, name="host_1.1.pt.trace.json", gz=False):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name + (".gz" if gz else ""))
    with (gzip.open if gz else open)(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return str(d)


def run(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": CPU_PID, "tid": tid,
            "ts": ts, "dur": dur, "args": {}}


def launch(corr, ts, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "pid": CPU_PID, "tid": tid,
            "ts": ts, "dur": 2, "args": {"correlation": corr}}


def device(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": GPU_PID, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr, "device": 0, "stream": 7}}


def standard_events():
    """Three runs of 'step' (ranges at 0, 1000, 2000 us): 'conv' in each,
    'warp' in the first two, a copy and a memset in the first; the
    kernels run after their launches, the third run's on the backward's
    thread; a GPU annotation spans each run."""
    ev = [{"ph": "M", "name": "process_name", "pid": CPU_PID, "args": {"name": "python"}}]
    for i, t0 in enumerate((0, 1000, 2000)):
        ev.append(run(f"step#{i}", t0, 500))
        tid = 2 if i == 2 else 1
        ev += [launch(10 * i + 1, t0 + 10, tid), device("conv", 10 * i + 1, t0 + 100, 200)]
        if i < 2:
            ev += [launch(10 * i + 2, t0 + 20, tid), device("warp", 10 * i + 2, t0 + 400, 100)]
        ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": f"step#{i}", "pid": GPU_PID,
                   "tid": 7, "ts": t0 + 100, "dur": 400, "args": {}})
    ev += [launch(3, 30, cat="cuda_driver"), device("Memcpy HtoD", 3, 50, 10, "gpu_memcpy"),
           launch(4, 40), device("Memset", 4, 60, 5, "gpu_memset")]
    return ev


def test_runs_are_spans_of_the_device_ops_they_launched(tmp_path):
    t = parse_trace(write_trace(tmp_path, standard_events()), "step")
    assert isinstance(t, DeviceTiming) and t.num_runs == 3
    # run 0: memcpy at 50 to warp's end at 500; run 1: 1100 to 1500; run 2: conv alone.
    assert t.run_durations_s == pytest.approx([450e-6, 400e-6, 200e-6])
    assert t.median_run_s == pytest.approx(400e-6)


def test_device_ops_by_category_summed_per_name(tmp_path):
    t = parse_trace(write_trace(tmp_path, standard_events()), "step")
    ops = {o.name: o for o in t.ops}
    assert set(ops) == {"conv", "warp", "Memcpy HtoD", "Memset"}  # no gpu_user_annotation
    assert (ops["conv"].count, ops["conv"].duration_s) == (3, pytest.approx(600e-6))
    assert (ops["warp"].count, ops["warp"].duration_s) == (2, pytest.approx(200e-6))
    assert [ops[n].category for n in ("conv", "Memcpy HtoD", "Memset")] == [
        "kernel", "gpu_memcpy", "gpu_memset"]
    assert [o.name for o in t.top_ops(2)] == ["conv", "warp"]
    assert t.total_flops == 0 and t.total_bytes == 0  # a CUDA trace counts neither


def test_other_programs_and_unlaunched_ops(tmp_path):
    ev = standard_events() + [
        run("other#0", 3000, 100), launch(90, 3010), device("conv", 90, 3050, 50),
        device("orphan", 91, 3200, 7),  # no launch event: counted, in no run
        {"ph": "i", "cat": "kernel", "name": "conv", "pid": GPU_PID, "ts": 1},  # not a span
    ]
    t = parse_trace(write_trace(tmp_path, ev), "step")
    assert t.num_runs == 3
    ops = {o.name: o for o in t.ops}
    assert ops["conv"].count == 4 and ops["orphan"].count == 1
    assert parse_trace(str(tmp_path), "other").run_durations_s == pytest.approx([50e-6])
    # "step" must not match "steps#0" or "step#x".
    ev = [run("steps#0", 0, 100), run("step#x", 200, 100), launch(1, 10), device("k", 1, 20, 5),
          launch(2, 210), device("k", 2, 220, 5)]
    assert parse_trace(write_trace(tmp_path / "b", ev), "step") is None


def test_a_bare_program_name_is_a_run(tmp_path):
    ev = [run("forward", 0, 100), launch(1, 10), device("k", 1, 20, 30),
          run("forward", 200, 100), launch(2, 210), device("k", 2, 250, 40)]
    t = parse_trace(write_trace(tmp_path, ev, gz=True), "forward")
    assert t.run_durations_s == pytest.approx([30e-6, 40e-6])


def test_none_without_device_events(tmp_path):
    assert parse_trace(str(tmp_path / "missing"), "step") is None
    assert parse_trace(write_trace(tmp_path / "empty", []), "step") is None
    cpu_only = [run("step#0", 0, 100), {"ph": "X", "cat": "cpu_op", "name": "aten::mul",
                                         "pid": CPU_PID, "tid": 1, "ts": 10, "dur": 5}]
    assert parse_trace(write_trace(tmp_path / "cpu", cpu_only), "step") is None
    assert parse_trace(write_trace(tmp_path / "std", standard_events()), "absent") is None


def test_the_newest_trace_is_read(tmp_path):
    old = write_trace(tmp_path, [run("f", 0, 100), launch(1, 10), device("k", 1, 20, 10)], "old.pt.trace.json")
    os.utime(os.path.join(old, "old.pt.trace.json"), (1, 1))
    write_trace(tmp_path / "sub", [run("f", 0, 100), launch(1, 10), device("k", 1, 20, 70)])
    assert parse_trace(str(tmp_path), "f").run_durations_s == pytest.approx([70e-6])


def test_measure_device_time_on_the_cpu_returns_none_and_cleans_up():
    before = set(glob.glob(os.path.join(tempfile.gettempdir(), "jp_devtime_*")))
    calls = []

    def double(x):
        calls.append(1)
        return x * 2.0

    assert measure_device_time(double, torch.ones(4), iters=3, warmup=1) is None
    assert len(calls) == 4
    assert set(glob.glob(os.path.join(tempfile.gettempdir(), "jp_devtime_*"))) == before


def test_measure_device_time_keeps_a_trace_dir_it_was_given(tmp_path):
    assert measure_device_time(lambda x: x + 1, torch.ones(2), iters=2, warmup=0,
                               trace_dir=str(tmp_path), program_name="inc") is None
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"inc#0", "inc#1"} <= names
