"""The open-loop schedule, the percentile and rate arithmetic, and the
reading of a device trace."""

import math

import numpy as np
import pytest

from benchmark.harness import stats, trace
from benchmark.loops import open_serve

TRAFFIC = {"sizes": [1, 16], "pool_images": 256}


def test_the_schedule_is_the_same_for_a_seed():
    a = open_serve.schedule(TRAFFIC, 250.0, 10.0, 2**33 + 5)
    b = open_serve.schedule(TRAFFIC, 250.0, 10.0, 2**33 + 5)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_every_seed_gets_the_same_sizes_and_gaps_in_its_own_order():
    a = open_serve.schedule(TRAFFIC, 250.0, 10.0, 1)
    b = open_serve.schedule(TRAFFIC, 250.0, 10.0, 2)
    assert len(a["due"]) == len(b["due"]) == 2500
    assert not np.array_equal(a["sizes"], b["sizes"])
    np.testing.assert_array_equal(np.sort(a["sizes"]), np.sort(b["sizes"]))
    # The same gaps but the last, which each order leaves out of its due times.
    ga, gb = np.sort(np.diff(a["due"])), np.sort(np.diff(b["due"]))
    assert np.isin(np.round(ga, 9), np.round(gb, 9)).mean() > 0.99
    assert a["due"][0] == 0.0 and a["due"][-1] < 10.0
    assert np.bincount(a["sizes"])[1:].tolist() == [2500 // 16 + (i < 2500 % 16) for i in range(16)]
    assert (a["offsets"] + a["sizes"] <= 256).all()


def test_percentiles_interpolate_as_numpy_does():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0, 10.0, 7.0]
    for q in (0, 25, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_a_failed_request_is_later_than_every_served_one():
    due = [0.0, 1.0, 2.0, 3.0]
    done = [0.010, 1.500, None, 3.020]
    lat = stats.latencies_ms(due, done, gave_up=2.100)
    assert lat[:2] == pytest.approx([10.0, 500.0]) and lat[3] == pytest.approx(20.0)
    assert lat[2] == pytest.approx(500.0)  # gave up 100 ms after it was due: the slowest served
    lat = stats.latencies_ms(due, done, gave_up=5.0)
    assert lat[2] == pytest.approx(3000.0)
    assert stats.percentile(lat, 95) > max(lat[0], lat[1], lat[3])


def test_rates_take_all_the_work_over_the_whole_window():
    assert stats.rate(1280, 0.5) == 2560.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_a_trace_summary_counts_busy_time_ops_ranges_and_gaps():
    events = [
        _ev("user_annotation", trace.SLICE, 0.0, 100.0),
        _ev("user_annotation", "bench:dispatch#8", 0.0, 30.0, tid=2),
        _ev("user_annotation", "bench:dispatch#16", 40.0, 30.0, tid=2),
        _ev("cpu_op", "aten::cat", 5.0, 40.0, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 10.0, 1.0, tid=2, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 50.0, 1.0, tid=2, corr=2),
        _ev("kernel", "k_a", 10.0, 20.0, corr=1),
        _ev("kernel", "k_b", 20.0, 20.0, corr=2),
        _ev("gpu_memcpy", "Memcpy HtoD", 60.0, 10.0),
        _ev("kernel", "outside", 200.0, 10.0),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)  # [10, 40] and [60, 70]
    assert s["ops"]["k_a"] == [1, pytest.approx(20e-6)] and "outside" not in s["ops"]
    assert s["ops_by_range"] == {"dispatch#8": {"k_a": [1, pytest.approx(20e-6)]},
                                 "dispatch#16": {"k_b": [1, pytest.approx(20e-6)]}}
    assert math.isclose(sum(s["gaps"].values()), 60e-6, rel_tol=1e-9)
    assert trace.top({"a": [1, 2.0], "b": [3, 5.0]}) == [["b", 5.0], ["a", 2.0]]


def test_the_metric_readers_read_counts_and_trace_summaries():
    from benchmark.harness import spec, work

    flagship = spec.load_json(spec.BENCH_DIR / "configs" / "flagship.json")["config"]
    summary = {"window_s": 2.0, "busy_s": 1.5, "gaps": {},
               "ops": {"void shear_warp_fused_kernel<0>": [40, 0.002],
                       "ncclDevKernel_AllReduce_Sum_f32": [10, 0.03]}}
    ctx = {"config": flagship, "traffic": {"rows_per_rank": 32}, "chips": 4, "traces": [summary],
           "counts": {"untraced_s": 5.0, "untraced_images": 50_000}}

    def read(name, **kw):
        return spec.metric_reader(name)(dict(ctx, **kw))

    assert read("device_idle_pct.train") == pytest.approx(25.0)
    assert read("roofline_pct.warp.train") == pytest.approx(
        100 * 40 * work.warp_bound_s(flagship, 32) / 0.002)
    assert read("mfu.train") == pytest.approx(
        100 * 50_000 * 3 * work.forward_flops_per_image(flagship) / 5.0 / (4 * 989e12))
    assert read("mfu.offline", counts={}) is None
    assert read("roofline_pct.warp.train", traces=[dict(summary, ops={})]) is None
