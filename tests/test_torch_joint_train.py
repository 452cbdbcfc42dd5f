"""The paper model's training path (``joint``: max pools, multires, the
stride-1 MRF through the fused Fourier pass at 'high') held against the
benchmark's plain reference, at the ``tiny`` preset's widths on the CPU.

"joint-like" is ``tiny`` with the MRF at stride 1 over a (23, 31) window,
713 taps, so that 'auto' resolves to 'fft' and, with ``use_pallas``, to
``_FusedPass``; the shear warp and crops of (0.8, 1.0) as the benchmark's
``joint_train`` configuration trains (``tests/test_torch_train.py`` holds
one such step against the JAX package).  Also: the backward's span
``jointpose/mrf.vjp`` and its counter ``_FusedPass.recomputes``.

The test marked ``cuda`` replays a captured K-step dispatch on the card:
``python -m pytest --noconftest tests/test_torch_joint_train.py -m cuda``."""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import inputs, spec
from benchmark.reference import model as ref
from jointpose_torch import ops
from jointpose_torch.configs import get_config
from jointpose_torch.models.mrf import select_impl
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.ops.mrf_fft_fused import _FusedPass

SPAN = "jointpose/mrf.vjp"


def joint_like():
    c = get_config("tiny")
    return c.replace(mrf=dataclasses.replace(c.mrf, window=(23, 31), use_pallas=True),
                     augment=dataclasses.replace(c.augment, warp_impl="shear",
                                                 crop_frac_range=(0.8, 1.0)),
                     mesh=dataclasses.replace(c.mesh, data=-1))


def as_dict(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def train_cell(cfg) -> spec.Cell:
    tr = {"loop": "train_steps", "ranks": 1, "rows_per_rank": 4, "steps_per_dispatch": 2,
          "pool_dispatches": 2, "checked_dispatches": 2, "warm_dispatches": 1,
          "timed_dispatches": 1, "trace_slice": {"start": 0.3, "dispatches": 1}}
    return spec.Cell(name="joint-like", chips=1, config={"preset": "tiny", "config": as_dict(cfg)},
                     traffic=tr, limits={}, end_to_end=[], per_layer=[])


def batches(cfg, n: int, k: int | None = None, seed: int = 5) -> dict:
    hw = cfg.data.image_hw
    rows = n * (k or 1)
    joints, visible = inputs.make_joints(rows, hw, seed, 2, "cpu")
    batch = {"image": inputs.make_images(rows, hw, seed, 1, "cpu"), "joints": joints,
             "visible": visible}
    return batch if k is None else {name: v.reshape(k, n, *v.shape[1:]) for name, v in batch.items()}


def test_joint_like_takes_the_fused_fourier_pass_at_high():
    cfg = joint_like()
    assert cfg.detector.pool_mode == "max" and cfg.detector.multires
    assert cfg.mrf.stride == 1 and cfg.mrf.window[0] * cfg.mrf.window[1] == 713
    assert select_impl(cfg.mrf) == "fft" and cfg.mrf.precision == "high"
    assert PoseModel(cfg).spatial_model.pass_fn.__name__ == "mrf_message_pass_fft_fused"
    assert (_FusedPass, "recomputes") in ops.launch_counters()


def test_the_forward_agrees_with_the_plain_reference():
    cfg = joint_like()
    d = as_dict(cfg)
    weights = inputs.make_weights(d, 2**32 + 7, "cpu")
    images = inputs.make_images(4, tuple(d["data"]["image_hw"]), 2**32 + 7, 3, "cpu")
    model = PoseModel(cfg)
    model.load_state_dict(weights)
    with torch.no_grad():
        got = model(images)
        want = ref.forward(weights, d, images)
    for key in ("detector_logits", "mrf_log_heatmaps"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-4)


def test_the_training_steps_agree_with_the_plain_reference():
    out = spec.loop_module("train_steps").run(train_cell(joint_like()), 13, 0.2, False,
                                              device="cpu")
    for number in ("first_loss_gap", "dispatch_loss_gap", "grad_gap", "grad_diff", "step_gap"):
        assert out["numbers"][number] < 1e-5, number


def _spans(events, name: str) -> list:
    return [e for e in events if e.name == name]


def test_the_vjp_span_opens_once_a_step_flat_and_counts_each_recompute():
    from jointpose_torch.train import create_state, make_train_step

    cfg = joint_like()
    state = create_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, "joint")
    before = _FusedPass.recomputes
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            state, _ = step(state, batches(cfg, 2, seed=i))
    assert _FusedPass.recomputes - before == 2
    events = prof.events()
    vjps = _spans(events, SPAN)
    assert len(vjps) == 2
    others = [e for e in events if e.name.startswith("jointpose/") and e.name != SPAN]
    for v in vjps:  # no span encloses it, and it encloses none
        for o in others:
            if o.thread == v.thread:
                disjoint = (o.time_range.end <= v.time_range.start
                            or v.time_range.end <= o.time_range.start)
                assert disjoint, o.name
    # With no profiler collecting, the span is the shared null context.
    before = _FusedPass.recomputes
    step(state, batches(cfg, 2, seed=3))
    assert _FusedPass.recomputes - before == 1


def test_an_eager_k_step_dispatch_counts_k_recomputes():
    from jointpose_torch.train import create_state, make_train_multistep_arrays

    cfg = joint_like()
    state = create_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    multi = make_train_multistep_arrays(cfg, "joint", 3)
    before = _FusedPass.recomputes
    state, metrics = multi(state, batches(cfg, 2, k=3))
    assert _FusedPass.recomputes - before == 3 and torch.isfinite(metrics["loss"])


@pytest.mark.cuda
def test_a_replayed_dispatch_adds_k_recomputes_and_row_3_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the K-step dispatch is a CUDA graph only there")
    from jointpose_torch.ops.mrf_fft_fused import fused_tail
    from jointpose_torch.train import create_state, make_train_multistep_arrays

    cfg = joint_like()
    k = 3
    state = create_state(cfg, torch.Generator().manual_seed(0), device=torch.device("cuda"))
    multi = make_train_multistep_arrays(cfg, "joint", k)
    pool = batches(cfg, 2, k=k)
    for _ in range(2):  # warm, then capture and replay
        state, _ = multi(state, pool)
    assert state.graphs.replays(multi, state)
    before = (_FusedPass.recomputes, fused_tail.launches)
    for _ in range(2):
        state, metrics = multi(state, pool)
    torch.cuda.synchronize()
    assert (_FusedPass.recomputes - before[0], fused_tail.launches - before[1]) == (2 * k, 2 * k)
    assert torch.isfinite(metrics["loss"])
    state.graphs.release()
