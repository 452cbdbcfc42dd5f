"""The program's spans in a trace's summary: an idle gap during which the
host was inside a ``jointpose/`` range is named after it (``trace.summarize``
names a gap after the outermost host event), and the readers of
``device_idle_pct.predict.offline`` and ``device_idle_pct.dispatch.train``
sum those gaps over the slice, or give None for a program without spans."""

import pytest

from benchmark.harness import spec, trace


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_an_idle_gap_is_named_after_the_program_span_the_host_was_in():
    events = [
        _ev("user_annotation", trace.SLICE, 0.0, 100.0),
        _ev("user_annotation", "jointpose/input", 0.0, 30.0),
        _ev("cpu_op", "aten::to", 2.0, 27.0),  # inside the span: not outermost
        _ev("cuda_runtime", "cudaMemcpyAsync", 25.0, 1.0, corr=1),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 26.0, 4.0, corr=1),
        _ev("user_annotation", "jointpose/detector", 31.0, 20.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 45.0, 1.0, corr=2),
        _ev("kernel", "conv", 46.0, 30.0, corr=2),
        _ev("cpu_op", "aten::to", 80.0, 15.0),  # the client's copy of the answer
        _ev("cuda_runtime", "cudaMemcpyAsync", 90.0, 1.0, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 92.0, 2.0, corr=3),
    ]
    gaps = trace.summarize(events)["gaps"]
    assert gaps == {"jointpose/input": pytest.approx(26e-6),
                    "jointpose/detector": pytest.approx(16e-6),
                    "aten::to": pytest.approx(16e-6 + 6e-6)}


def test_the_idle_readers_sum_the_gaps_under_the_program_spans():
    summary = {"window_s": 2.0, "busy_s": 1.5, "ops": {}, "ops_by_range": {},
               "gaps": {"jointpose/input": 0.06, "jointpose/decode": 0.01, "aten::to": 0.05,
                        "jointpose/dispatch.rates": 0.02, "jointpose/dispatch.replay": 0.04,
                        "idle": 0.3}}

    def read(name, *traces):
        return spec.metric_reader(name)({"traces": list(traces)})

    assert read("device_idle_pct.predict.offline", summary) == pytest.approx(
        100 * (0.06 + 0.01 + 0.02 + 0.04) / 2.0)
    assert read("device_idle_pct.dispatch.train", summary,
                dict(summary, gaps={"jointpose/dispatch.replay": 0.1})) == pytest.approx(5.0)
    parent = dict(summary, gaps={"aten::to": 0.05, "idle": 0.3})  # a program without spans
    assert read("device_idle_pct.predict.offline", parent) is None
    assert read("device_idle_pct.dispatch.train", parent) is None
