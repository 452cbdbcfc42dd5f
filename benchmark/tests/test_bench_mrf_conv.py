"""The readers of ``roofline_pct.mrf_conv.offline`` and ``.train``: launches
of the grouped correlation kernel x one call's bound at the cell's rows, over
the kernel's device time, summed over the traces; None for a program that
does not launch it (the parent, which hands the conv to cuDNN)."""

import pytest

from benchmark.harness import spec

KERNEL = "void (anonymous namespace)::mrf_grouped_corr_kernel<__nv_bfloat16, 2>(...)"
CUDNN = "sm80_xmma_fprop_implicit_gemm_indexed_tf32f32_tf32f32_f32_nhwckr"


def _bound_s(batch: int) -> float:
    """flagship's coarse grid 30x45, 9 joints, a 17x25 window, by hand."""
    pixels = batch * 30 * 45
    flops = 2 * pixels * 81 * 425
    n_bytes = 2 * pixels * 9 + 2 * 425 * 81 + 4 * pixels * 81
    return max(flops / 989e12, n_bytes / 3.35e12)


def _ctx(traffic, *ops):
    cfg = spec.load_json(spec.ROOT / "benchmark" / "configs" / "flagship.json")["config"]
    return {"config": cfg, "traffic": traffic, "chips": 1,
            "traces": [{"ops": o, "gaps": {}, "window_s": 2.0, "busy_s": 1.9} for o in ops]}


@pytest.mark.parametrize("metric,traffic,rows", [
    ("roofline_pct.mrf_conv.offline", {"batch": 128}, 128),
    ("roofline_pct.mrf_conv.train", {"rows_per_rank": 32}, 32),
])
def test_the_readers_put_the_launches_bound_over_their_time(metric, traffic, rows):
    read = spec.metric_reader(metric)
    assert _bound_s(128) == pytest.approx(17.662e-6, rel=1e-4)  # bytes bind it
    ops = {KERNEL: [10, 10 * 175e-6], CUDNN: [1, 0.5]}
    want = 100 * 10 * _bound_s(rows) / (10 * 175e-6)
    assert read(_ctx(traffic, ops)) == pytest.approx(want, rel=1e-9)
    # Two ranks' traces add launches and time.
    other = {KERNEL: [30, 30 * 100e-6]}
    want2 = 100 * 40 * _bound_s(rows) / (10 * 175e-6 + 30 * 100e-6)
    assert read(_ctx(traffic, ops, other)) == pytest.approx(want2, rel=1e-9)
    assert read(_ctx(traffic, {CUDNN: [10, 0.1]})) is None
