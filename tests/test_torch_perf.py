"""``jointpose_torch.perf`` against ``jointpose/perf.py`` and against the
shapes it counts.

- ``roofline_images_per_sec`` is the reference's maths: equal for the same
  arguments, the peaks passed explicitly (the memory rate set alike).
- ``step_cost`` of the ``tiny`` detector's forward counts the
  convolutions' 2·MACs exactly, worked out here from the config.
- Its FLOPs stand within ``XLA_FLOPS_RTOL`` of the reference's
  ``compiled_cost`` for the same forward on the CPU: XLA's cost analysis
  counts each conv's valid taps only, the SAME padding's zero taps left
  out, where PyTorch's formula charges every tap (measured +10.3% at
  batch 1 and 4).
- The kernels' cost formulas, which ``chip_smoke.py``'s bounds read, give
  at the main-path shapes the bounds ``PERF.md`` records for rows 1 to 8
  (computed on meta tensors: shapes only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose import perf as jperf
from jointpose.configs import get_config as jax_get_config
from jointpose.models.detector import Detector as JaxDetector
from jointpose_torch import get_config, perf
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.predict import init_state_dict

XLA_FLOPS_RTOL = 0.12


@pytest.mark.parametrize("flops,bytes_,peak,util,eff", [
    (6.0e9, 40e6, 197e12, 0.6, 0.8), (6.0e9, 0.0, 989e12, 1.0, 1.0),
    (1.2e9, 9e8, 989e12, 1.0, 1.0), (2.5e10, 1e7, 1979e12, 0.77, 1.0), (0.0, 1e6, 989e12, 1, 1),
])
def test_roofline_equals_reference(monkeypatch, flops, bytes_, peak, util, eff):
    monkeypatch.setattr(jperf, "HBM_BYTES_PER_SEC", perf.HBM_BYTES_PER_S)
    got = perf.roofline_images_per_sec(flops, bytes_, peak_flops=peak, mxu_util=util, hbm_eff=eff)
    want = jperf.roofline_images_per_sec(flops, bytes_, peak_flops=peak, mxu_util=util,
                                         hbm_eff=eff)
    assert got == want
    if flops > 0:  # the defaults are the bound: the whole peak, the raw rate
        assert perf.roofline_images_per_sec(flops, bytes_) == min(
            perf.BF16_FLOPS_PER_S / flops,
            perf.HBM_BYTES_PER_S / bytes_ if bytes_ else float("inf"))


def detector_conv_flops(cfg, batch: int) -> int:
    """2·MACs of every conv of the detector, from the config's shapes."""
    d = cfg.detector
    h, w = cfg.data.image_hw

    def trunk(h, w):
        macs, cin = 0, 3
        for feats, pooled in zip(d.trunk_features, d.trunk_pool):
            stride = 2 if pooled and d.pool_mode == "stride" else 1
            ho, wo = -(-h // stride), -(-w // stride)
            macs += ho * wo * feats * cin * d.trunk_kernel ** 2
            h, w, cin = (-(-ho // 2), -(-wo // 2), feats) if pooled and stride == 1 else (ho, wo, feats)
        return macs, h, w

    macs, hh, ww = trunk(h, w)
    if d.multires:
        macs += trunk(h // 2, w // 2)[0]
    cin = d.trunk_features[-1]
    for i, feats in enumerate(d.head_features):
        macs += hh * ww * feats * cin * (d.head_kernel ** 2 if i == 0 else 1)
        cin = feats
    macs += hh * ww * cfg.num_joints * cin
    return 2 * macs * batch


@pytest.mark.parametrize("batch", [1, 4])
def test_step_cost_counts_the_detector_convs_and_stays_near_xla(batch):
    cfg = get_config("tiny")
    x = np.random.RandomState(0).rand(batch, *cfg.data.image_hw, 3).astype(np.float32)
    model = PoseModel(cfg)
    model.load_state_dict(init_state_dict(cfg, torch.Generator().manual_seed(0)))
    with torch.no_grad():
        cost = perf.step_cost(model.detector, torch.from_numpy(x))
    assert cost["flops"] == detector_conv_flops(cfg, batch) == batch * 15_919_104
    # every op reads its operands and writes its result: at least the input and the logits
    assert cost["bytes"] >= x.nbytes + batch * 12 * 16 * cfg.num_joints * 4

    jcfg = jax_get_config("tiny")
    det = JaxDetector(jcfg.detector, num_joints=jcfg.num_joints)
    params = det.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jperf.compiled_cost(jax.jit(det.apply), params, jnp.asarray(x))
    assert abs(cost["flops"] / want["flops"] - 1) <= XLA_FLOPS_RTOL


def test_kernels_report_their_cost_only_inside_a_count():
    calls = []

    def cost_fn(n):
        calls.append(n)
        return 10 * n, n

    perf.count_kernel("k", cost_fn, 3)  # no count open: the formula is not even called
    assert calls == []
    with perf.count_cost() as outer:
        perf.count_kernel("k", cost_fn, 3)
        with perf.count_cost() as inner:
            perf.count_kernel("k", cost_fn, 5)
    assert (outer.flops, outer.bytes) == (8, 80) and (inner.flops, inner.bytes) == (5, 50)
    assert outer.kernels["k"] == {"launches": 2, "flops": 8, "bytes": 80}
    perf.count_kernel("k", cost_fn, 7)
    assert calls == [3, 5] and outer.flops == 8


def test_a_wrapper_on_cpu_tensors_reports_no_kernel():
    from jointpose_torch.ops.mrf_epilogue import mrf_epilogue

    resp, bias = torch.rand(2, 3, 4, 9, 9), torch.rand(9, 9)
    with perf.count_cost() as cost:
        mrf_epilogue(resp, bias)
    assert not cost.kernels  # the plain version ran: aten ops, counted as such
    assert cost.bytes >= perf.nbytes(resp, bias)


def test_view_and_in_place_ops_are_charged_as_documented():
    x = torch.ones(4, 4)
    with perf.count_cost() as cost:
        x.view(16)  # a view: free
        torch.empty(1000)  # an allocation: free
        x.add_(1.0)  # reads x, writes x
    assert cost.bytes == 2 * x.numel() * 4 and cost.flops == 0


def test_kernel_cost_formulas_give_the_recorded_bounds():
    """PERF.md's bound for each row, from the formulas at its main-path shape."""
    from jointpose_torch.ops import fft_conv as fc
    from jointpose_torch.ops.mrf_epilogue import bwd_cost, fwd_cost
    from jointpose_torch.ops.mrf_fft import forward_ffts
    from jointpose_torch.ops.mrf_fft_fused import tail_cost
    from jointpose_torch.ops.warp import warp_cost

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    bias = meta(9, 9)
    for batch, want in ((8, 0.000638), (32, 0.002553)):
        got = perf.bound_ms(*fwd_cost(meta(batch, 30, 45, 9, 9, dtype=torch.bfloat16), bias))
        assert got[1] == "bytes" and round(got[0], 6) == want
    resp = meta(32, 30, 45, 9, 9, dtype=torch.bfloat16)
    assert round(perf.bound_ms(*bwd_cost(resp, bias, meta(32, 30, 45, 9)))[0], 6) == 0.004643
    warp = warp_cost(meta(32, 240, 360, 3), meta(32, 2, 2), meta(32, 2))
    assert round(perf.bound_ms(*warp)[0], 6) == 0.019808

    pf, kf, tables = forward_ffts(torch.rand(8, 60, 90, 9), torch.rand(45, 67, 9, 9))
    n_bytes, n_ops = tail_cost(pf, kf, tables, torch.rand(9, 9))
    for passes, want in ((3, 0.022468), (1, 0.007489)):
        t = max(n_bytes / perf.HBM_BYTES_PER_S * 1e3, perf.tf32_ops_ms(n_ops, passes))
        assert round(t, 6) == want

    kernel = meta(9, 9, 128, 512)
    for batch, built, want in ((8, True, 0.054299), (32, True, 0.111521), (8, False, 0.300791)):
        (xr, xi), (a_re, a_im), t = fc.forward_spectra(meta(batch, 60, 90, 128).bfloat16(), kernel)
        kr, ki = (a_re, a_im) if built else fc._kf_from_a(a_re, a_im, t)
        got = perf.bound_ms(*fc.tail_cost(xr, xi, kr, ki, t, built), perf.BF16_FLOPS_PER_S)
        assert got[1] == "bytes" and round(got[0], 6) == want
