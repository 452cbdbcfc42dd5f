"""The cell ``joint_train.train_b32``: its files found by name with the
per-layer metrics it reports, and row 3's roofline reader."""

import pytest

from benchmark.harness import spec

READER = "roofline_pct.mrf_fft_tail.train"
TRAIN_METRICS = {"mfu.train", "device_idle_pct.train", "device_idle_pct.dispatch.train",
                 "roofline_pct.warp.train"}


def _reader():
    return spec._module(spec.BENCH_DIR / "metrics" / f"{READER}.py", READER)


def _joint() -> dict:
    return spec.load_json(spec.BENCH_DIR / "configs" / "joint_train.json")["config"]


@pytest.mark.parametrize("batch, ms", [(8, 0.022468), (32, 0.0899)])
def test_row_3_s_bound_is_three_tf32_passes_of_its_products(batch, ms):
    assert _reader().call_bound_s(_joint(), batch) * 1e3 == pytest.approx(ms, rel=1e-3)


def test_row_3_s_reader_reads_its_launches_and_none_without_one():
    ctx = {"config": _joint(), "traffic": {"rows_per_rank": 32}, "chips": 1,
           "traces": [{"ops": {"void (anonymous namespace)::mrf_fft_tail_kernel<3>(Args)":
                               [10, 0.002],
                               "(anonymous namespace)::mrf_fft_tail_combine_kernel(float*)":
                               [10, 0.0005],
                               "sm90_xmma_wgrad": [40, 0.1]}}]}
    bound = 10 * _reader().call_bound_s(_joint(), 32)
    assert _reader().read(ctx) == pytest.approx(100.0 * bound / 0.0025)
    ctx["traces"][0]["ops"] = {"sm90_xmma_wgrad": [40, 0.1]}
    assert _reader().read(ctx) is None


def test_the_new_cell_loads_with_its_metrics():
    c = spec.find_cell("joint_train.train_b32")
    assert c.chips == 1 and c.traffic["loop"] == "train_steps"
    assert {m["name"] for m in c.end_to_end} == {"train_images_per_s", "setup_s"}
    assert {m["name"] for m in c.per_layer} == TRAIN_METRICS | {READER}
    # The checked dispatches' losses are left out: here a sound run's last
    # loss strays up to 0.017 from the fp32 reference's (which strays 0.004
    # from itself on the same seed), a state left unchanged reads from
    # 0.025; ``step_gap`` compares those dispatches' parameters instead.
    accepted = spec.find_cell("flagship.train_b32").limits
    assert c.limits == {k: v for k, v in accepted.items() if k != "dispatch_loss_gap"}


def test_joint_train_is_the_joint_preset_with_the_shear_warp_beside_it():
    doc = spec.load_json(spec.BENCH_DIR / "configs" / "joint_train.json")
    cfg = spec.port_config(doc)
    assert doc["preset"] == "joint" and doc["set_beside_preset"] == {"augment.warp_impl": "shear"}
    assert cfg.mrf.precision == "high" and cfg.augment.warp_impl == "shear"
    assert doc["reduced"] == [] and spec.find_cell("joint_train.train_b32").traffic["ranks"] == 1
