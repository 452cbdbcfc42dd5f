"""The plain reference against the program (``jointpose_torch``) on the CPU
at small sizes, and the work formulas against torch's FLOP counter."""

import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import inputs, spec, work
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

from jointpose_torch.configs import get_config
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.ops.heatmaps import decode_probs, model_probs


def tiny(kind: str):
    c = get_config("tiny")
    if kind == "flagship-like":  # the flagship's paths at the tiny preset's widths
        c = c.replace(detector=dataclasses.replace(c.detector, pool_mode="stride"),
                      mrf=dataclasses.replace(c.mrf, stride=2, window=(5, 7)),
                      augment=dataclasses.replace(c.augment, warp_impl="shear"),
                      decode_refine=True)
    return c


def as_dict(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


@pytest.mark.parametrize("kind", ["tiny", "flagship-like"])
def test_the_reference_forward_and_decode_agree_with_the_program(kind):
    cfg = tiny(kind)
    d = as_dict(cfg)
    weights = inputs.make_weights(d, 2**32 + 3, "cpu")
    images = inputs.make_images(6, tuple(d["data"]["image_hw"]), 2**32 + 3, 9, "cpu")
    model = PoseModel(cfg)
    model.load_state_dict(weights)
    with torch.no_grad():
        got = model(images)
        want = ref.forward(weights, d, images)
    for key in ("detector_logits", "mrf_log_heatmaps"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-4)
    probs = model_probs(got)
    refine = d["decode_refine"]
    torch.testing.assert_close(ref.decode(probs, 4, refine), decode_probs(probs, 4, refine=refine),
                               rtol=0, atol=1e-4)


def test_the_reference_training_steps_agree_with_the_program():
    d = as_dict(tiny("flagship-like"))
    tr = {"loop": "train_steps", "ranks": 1, "rows_per_rank": 4, "steps_per_dispatch": 2,
          "pool_dispatches": 2, "checked_dispatches": 2, "warm_dispatches": 1, "timed_dispatches": 1,
          "trace_slice": {"start": 0.3, "dispatches": 1}}
    cell = spec.Cell(name="t", chips=1, config={"preset": "tiny", "config": d}, traffic=tr,
                     limits={}, end_to_end=[], per_layer=[])
    out = spec.loop_module("train_steps").run(cell, 11, 0.2, False, device="cpu")
    for number in ("first_loss_gap", "dispatch_loss_gap", "grad_gap", "grad_diff", "step_gap"):
        assert out["numbers"][number] < 1e-5, number


def test_the_reference_warp_draws_and_warps_as_the_program():
    from jointpose_torch.configs import AugmentConfig
    from jointpose_torch.data.augment import augment_batch, random_augment_params

    cfg = AugmentConfig(enabled=True, warp_impl="shear", crop_frac_range=(0.8, 1.0))
    hw = (48, 64)
    images = inputs.make_images(3, hw, 5, 1, "cpu")
    joints, visible = inputs.make_joints(3, hw, 5, 2, "cpu")
    params = random_augment_params(torch.Generator().manual_seed(7), 3, cfg, hw)
    want = augment_batch(images, joints, visible, params, warp_impl="shear")
    p = ref_train.draw_augment(torch.Generator().manual_seed(7), 3, dataclasses.asdict(cfg), hw)
    a_inv, b_inv = ref_train.inverse_affine(p, hw)
    got_img = ref_train.shear_warp(images.float() / 255.0, a_inv, b_inv)
    got_j, got_v = ref_train.transform_joints(joints, visible, p, hw)
    torch.testing.assert_close(got_img, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_j, want[1])
    torch.testing.assert_close(got_v, want[2])


@pytest.mark.parametrize("config, flops", [("flagship", 5_593_949_100), ("joint", 79_034_475_600)])
def test_the_flop_formula_matches_torch_s_counter_on_the_reference_forward(config, flops):
    # The reference computes the MRF's correlation as a grouped conv, which
    # the counter charges as its direct taps, as the formula does.
    d = spec.load_json(spec.BENCH_DIR / "configs" / f"{config}.json")["config"]
    weights = inputs.make_weights(d, 1, "cpu")
    images = inputs.make_images(1, tuple(d["data"]["image_hw"]), 1, 1, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.forward(weights, d, images)
    assert counter.get_total_flops() == work.forward_flops_per_image(d) == flops
    assert work.train_flops_per_image(d) == 3 * flops


def test_the_kernel_bounds_match_their_recorded_values():
    d = spec.load_json(spec.BENCH_DIR / "configs" / "joint.json")["config"]
    f = spec.load_json(spec.BENCH_DIR / "configs" / "flagship.json")["config"]
    assert work.mrf_tail_bound_s(d, 8) * 1e3 == pytest.approx(0.007489, rel=1e-3)
    assert work.mrf_tail_bound_s(d, 32) * 1e3 == pytest.approx(0.029957, rel=1e-3)
    assert work.warp_bound_s(f, 32) * 1e3 == pytest.approx(0.019808, rel=1e-3)
