"""The port's int8 post-training quantization (jointpose_torch.ops.quant)
against the reference's (jointpose.ops.quant) on the `tiny` preset, fp32
on the CPU, from one seeded flax init converted by params_from_flax.

Tolerances: the fp32 calibration graph and its amax values within 1e-5
relative (two frameworks' fp32 convs); the int8 weights bit-equal (the
same IEEE divisions and round-half-even).  Given the reference's qparams,
the int8 activations may differ by one step where a value sits on a
rounding edge after another fp32 summation order (the 2×2 average
pyramid), at under 0.1% of elements; the logits within 1e-5 of their
range, the decoded coordinates within 1e-3 px.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.configs import get_config as jax_get_config
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose.models.pose import make_logits_tail_fn as jax_make_logits_tail_fn
from jointpose.ops import mrf_xla as jxla
from jointpose.ops import quant as jq
from jointpose_torch import get_config
from jointpose_torch.convert import params_from_flax
from jointpose_torch.models.detector import Detector
from jointpose_torch.models.pose import PoseModel, make_logits_tail_fn
from jointpose_torch.ops import mrf_xla as txla
from jointpose_torch.ops import quant as tq

FP_RTOL = 1e-5
LOGIT_RTOL = 1e-5
COORD_ATOL = 1e-3
LSB_SHARE = 1e-3

LAYOUTS = {"shared": {}, "unshared_multires": {"share_trunk": False},
           "unshared_single_res": {"share_trunk": False, "multires": False}}


def _cfgs(**det):
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("tiny")
        out.append(cfg.replace(detector=dataclasses.replace(cfg.detector, head_conv_impl="direct",
                                                            **det)))
    return out


def _setup(seed=0, **det):
    jcfg, tcfg = _cfgs(**det)
    h, w = jcfg.data.image_hw
    variables = jax.tree_util.tree_map(
        np.asarray, JaxPoseModel(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3))))
    sm = variables["params"]["spatial_model"]
    rs = np.random.RandomState(seed)
    sm["raw_kernels"] = sm["raw_kernels"] + 0.5 * rs.randn(*sm["raw_kernels"].shape).astype(np.float32)
    calib = rs.rand(8, h, w, 3).astype(np.float32)
    return jcfg, tcfg, variables, params_from_flax(variables), calib


@pytest.fixture(scope="module")
def shared():
    jcfg, tcfg, variables, state, calib = _setup()
    return jcfg, tcfg, variables, state, calib, jq.quantize_detector(jcfg, variables, jnp.asarray(calib))


def _to_port(jqparams):
    """The reference's qparams as the port's: w_q HWIO -> OIHW, CPU tensors."""
    out = {}
    for name, node in jqparams.items():
        node = {f: np.asarray(v) for f, v in node.items()}
        node["w_q"] = node["w_q"].transpose(3, 2, 0, 1)
        out[name] = {f: torch.from_numpy(v.copy()) for f, v in node.items()}
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_fp_reference_logits_match_detector_and_reference(shared, uint8):
    jcfg, tcfg, variables, state, calib, _ = shared
    images = (calib * 255).astype(np.uint8) if uint8 else calib
    got = tq.fp_reference_logits(tcfg, state, _t(images))
    want = jq.fp_reference_logits(jcfg, variables, jnp.asarray(images))
    assert got.shape == want.shape
    assert _rel(got, want) <= FP_RTOL
    det = Detector(tcfg.detector, tcfg.num_joints)
    det.load_state_dict({k[len("detector."):]: v for k, v in state.items() if k.startswith("detector.")})
    with torch.no_grad():
        x = _t(images).float() / 255.0 if uint8 else _t(images)
        assert _rel(got, det(x)) <= FP_RTOL


def test_calibration_scales_match_reference(shared):
    jcfg, tcfg, variables, state, calib, _ = shared
    want = jq.calibrate_detector(jcfg, variables, jnp.asarray(calib), batch_size=3)
    got = tq.calibrate_detector(tcfg, state, _t(calib), batch_size=3, device="cpu")
    assert set(got) == set(want) == set(tq._conv_names(tcfg.detector))
    for name in want:
        assert abs(got[name] - want[name]) <= FP_RTOL * want[name], name


def test_quantized_weights_equal_reference(shared):
    jcfg, tcfg, variables, state, calib, jqp = shared
    got = tq.quantize_detector(tcfg, state, _t(calib), device="cpu")
    want = _to_port(jqp)
    assert list(got) == list(want)
    for name, node in want.items():
        assert got[name]["w_q"].dtype == torch.int8
        assert torch.equal(got[name]["w_q"], node["w_q"]), name
        assert torch.equal(got[name]["w_scale"], node["w_scale"]), name
        assert torch.equal(got[name]["bias"], node["bias"]), name
        assert got[name]["in_scale"].shape == () and got[name]["in_scale"].dtype == torch.float32
        assert abs(float(got[name]["in_scale"]) - float(node["in_scale"])) <= FP_RTOL * float(
            node["in_scale"])


def _int8_inputs_of_reference(monkeypatch, fn):
    """Run ``fn`` recording the int8 lhs of every conv the reference makes."""
    seen = []
    conv = jax.lax.conv_general_dilated

    def recording(lhs, *args, **kwargs):
        if lhs.dtype == jnp.int8:
            seen.append(np.asarray(lhs))
        return conv(lhs, *args, **kwargs)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", recording)
    out = fn()
    monkeypatch.setattr(jax.lax, "conv_general_dilated", conv)
    return out, seen


def _int8_inputs_of_port(monkeypatch, fn):
    seen = []
    conv = tq.int_conv

    def recording(xq, w_q, stride=1):
        seen.append(xq.permute(0, 2, 3, 1).numpy())
        return conv(xq, w_q, stride)

    monkeypatch.setattr(tq, "int_conv", recording)
    out = fn()
    monkeypatch.setattr(tq, "int_conv", conv)
    return out, seen


def _compare_quantized(monkeypatch, jcfg, tcfg, jqp, images):
    """Port vs reference given the reference's qparams: logits within the
    bar, int8 activations equal or one step apart at under 0.1%."""
    want, j_int8 = _int8_inputs_of_reference(
        monkeypatch, lambda: jq.quant_detector_logits(jcfg, jqp, jnp.asarray(images)))
    got, t_int8 = _int8_inputs_of_port(
        monkeypatch, lambda: tq.quant_detector_logits(tcfg, _to_port(jqp), _t(images)))
    assert len(t_int8) == len(j_int8) == len(tq._conv_names(tcfg.detector)) + (
        len(tcfg.detector.trunk_features) if tcfg.detector.multires and tcfg.detector.share_trunk
        else 0)
    off, total = 0, 0
    for a, b in zip(t_int8, j_int8):
        assert a.shape == b.shape
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1
        off, total = off + int((d > 0).sum()), total + d.size
    print(f"int8 activations one step apart: {off} of {total}")
    assert off <= LSB_SHARE * total
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= LOGIT_RTOL * np.ptp(np.asarray(want))
    return got


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_quantized_logits_match_reference_given_its_qparams(shared, monkeypatch, uint8):
    jcfg, tcfg, variables, state, calib, jqp = shared
    images = np.random.RandomState(1).rand(4, *tcfg.data.image_hw, 3).astype(np.float32)
    if uint8:
        images = (images * 255).astype(np.uint8)
    got = _compare_quantized(monkeypatch, jcfg, tcfg, jqp, images)
    # uint8 is the same as its float image (the reference's check).
    if uint8:
        again = tq.quant_detector_logits(tcfg, _to_port(jqp), _t(images).float() / 255.0)
        np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)
    # int8 tracks fp32 within the reference's PTQ bar.
    fp = tq.fp_reference_logits(tcfg, state, _t(images))
    assert (got - fp).abs().max() <= 0.08 * fp.abs().max()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_trunk_layout_quantizes_like_the_reference(monkeypatch, layout):
    jcfg, tcfg, variables, state, calib = _setup(seed=6, **LAYOUTS[layout])
    assert tq._conv_names(tcfg.detector) == jq._conv_names(jcfg.detector)
    assert set(PoseModel(tcfg).state_dict()) == set(state)
    jqp = jq.quantize_detector(jcfg, variables, jnp.asarray(calib))
    got = tq.quantize_detector(tcfg, state, _t(calib), device="cpu")
    for name, node in _to_port(jqp).items():
        assert torch.equal(got[name]["w_q"], node["w_q"]), name
    _compare_quantized(monkeypatch, jcfg, tcfg, jqp, calib[:2])


def test_artifacts_read_across_the_packages(shared, tmp_path):
    jcfg, tcfg, variables, state, calib, jqp = shared
    ours = tq.quantize_detector(tcfg, state, _t(calib), device="cpu")
    tq.save_quantized(str(tmp_path / "port.npz"), ours)
    jq.save_quantized(str(tmp_path / "ref.npz"), jqp)
    # The reference reads the port's artifact: the same tensors, HWIO.
    read = jq.load_quantized(str(tmp_path / "port.npz"))
    assert set(read) == set(ours)
    for name, node in ours.items():
        assert read[name]["w_q"].dtype == jnp.int8
        np.testing.assert_array_equal(np.asarray(read[name]["w_q"]),
                                      node["w_q"].numpy().transpose(2, 3, 1, 0))
        assert np.asarray(read[name]["in_scale"]).shape == ()
        for field in ("w_scale", "bias", "in_scale"):
            assert np.asarray(read[name][field]).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(read[name][field]), node[field].numpy())
    # The port reads the reference's, and its own, back to equal tensors.
    for path, want in (("ref.npz", _to_port(jqp)), ("port.npz", ours)):
        loaded = tq.load_quantized(str(tmp_path / path))
        assert set(loaded) == set(want)
        for name, node in want.items():
            for field, t in node.items():
                assert loaded[name][field].shape == t.shape and loaded[name][field].dtype == t.dtype
                assert torch.equal(loaded[name][field], t)
    images = _t(calib[:2])
    assert torch.equal(tq.quant_detector_logits(tcfg, loaded, images),
                       tq.quant_detector_logits(tcfg, ours, images))


CONV_CASES = [  # (C_in, C_out, kernel, stride, H, W): K = 75, N = 9, asymmetric stride 2, odd sizes
    (3, 8, 5, 1, 12, 16), (16, 9, 1, 1, 6, 8), (16, 32, 5, 2, 12, 16), (8, 16, 5, 2, 7, 9),
    (32, 20, 9, 1, 6, 8),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_card_route_of_the_int8_conv_is_exact_on_the_cpu(case):
    """The card's route (im2col, then ``torch._int_mm``, which the CPU has
    too) against the int32 conv, on extreme int8 values."""
    cin, cout, k, s, h, w = case
    rs = np.random.RandomState(sum(case))
    x = _t(rs.choice([-127, -1, 0, 1, 127], (2, cin, h, w)).astype(np.int8))
    wq = _t(rs.randint(-127, 128, (cout, cin, k, k)).astype(np.int8))
    got = tq.int_conv_im2col(x, wq, s)
    want = tq.int_conv_plain(x, wq, s)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(wq.permute(2, 3, 1, 0).numpy()),
        (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(want.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    assert tq.int_conv(x, wq, s).equal(want)


@pytest.mark.parametrize("hw", [(4, 6), (5, 7)])
def test_int_pool_matches_reference(hw):
    x = np.random.RandomState(0).randint(-128, 128, (2, *hw, 3)).astype(np.int8)
    got = tq._pool_int(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._pool_int(jnp.asarray(x))))


@pytest.mark.parametrize("normalize_input", [True, False])
def test_logits_tail_matches_reference_and_the_model(shared, normalize_input):
    jcfg, tcfg, variables, state, calib, _ = shared
    jcfg = jcfg.replace(mrf=dataclasses.replace(jcfg.mrf, normalize_input=normalize_input))
    tcfg = tcfg.replace(mrf=dataclasses.replace(tcfg.mrf, normalize_input=normalize_input))
    logits = np.random.RandomState(2).randn(2, *tcfg.heatmap_hw, 9).astype(np.float32)
    want = jax_make_logits_tail_fn(jcfg, variables)(jnp.asarray(logits))
    model = PoseModel(tcfg)
    model.load_state_dict(state)
    with torch.no_grad():
        from_sd = make_logits_tail_fn(tcfg, state)(_t(logits))
        from_model = make_logits_tail_fn(tcfg, model)(_t(logits))
        full = model(_t(calib[:2]))
        tail_of_full = make_logits_tail_fn(tcfg, model)(full["detector_logits"])
    assert set(from_sd) == set(want) == {"detector_logits", "mrf_log_heatmaps"}
    assert _rel(from_sd["mrf_log_heatmaps"], want["mrf_log_heatmaps"]) <= 1e-3
    assert torch.equal(from_sd["mrf_log_heatmaps"], from_model["mrf_log_heatmaps"])
    assert torch.equal(tail_of_full["mrf_log_heatmaps"], full["mrf_log_heatmaps"])
    bare = make_logits_tail_fn(tcfg.replace(mrf=None), state)(_t(logits))
    assert list(bare) == ["detector_logits"]


def test_direct_oracle_matches_reference_and_the_log_space_pass():
    rs = np.random.RandomState(3)
    p = rs.rand(2, 7, 9, 4).astype(np.float32)
    p /= p.sum(axis=(1, 2), keepdims=True)
    kernels = (rs.rand(5, 3, 4, 4) * 0.2).astype(np.float32)
    biases = (rs.rand(4, 4) * 1e-3).astype(np.float32)
    got = txla.mrf_message_pass_direct(_t(p), _t(kernels), _t(biases))
    want = jxla.mrf_message_pass_direct(jnp.asarray(p), jnp.asarray(kernels), jnp.asarray(biases))
    assert _rel(got, want) <= 1e-5
    assert _rel(got, txla.mrf_message_pass_xla(_t(p), _t(kernels), _t(biases))) <= 1e-5


def test_quantized_predictor_matches_reference(shared):
    jcfg, tcfg, variables, state, calib, jqp = shared
    images = (np.random.RandomState(4).rand(4, *tcfg.data.image_hw, 3) * 255).astype(np.uint8)
    for flip in (False, True):
        jc, tc = jcfg.replace(eval_flip_tta=flip), tcfg.replace(eval_flip_tta=flip)
        want_c, want_p = jq.build_quantized_predictor(jc, variables, qparams=jqp)(jnp.asarray(images))
        got_c, got_p = tq.build_quantized_predictor(tc, state, qparams=_to_port(jqp), device="cpu")(
            _t(images))
        assert _rel(got_p, want_p) <= 1e-3
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=COORD_ATOL)
    # Calibrating in the port gives a working predictor of the same shapes.
    c, p = tq.build_quantized_predictor(tcfg, state, _t(calib), device="cpu")(_t(images))
    assert c.shape == (4, 9, 2) and bool(torch.isfinite(p).all())


def test_quantized_model_is_a_module_on_its_device(shared, monkeypatch):
    _, tcfg, _, state, calib, jqp = shared
    bare = tcfg.replace(mrf=None)
    state = {k: v for k, v in state.items() if k.startswith("detector.")}
    model = tq.make_quantized_apply_fn(bare, state, qparams=_to_port(jqp), device="cpu")
    assert isinstance(model, torch.nn.Module) and not list(model.parameters())
    assert {b.device.type for b in model.buffers()} == {"cpu"}
    out = model(_t(calib[:2]))
    assert list(out) == ["detector_logits"] and out["detector_logits"].shape == (2, 12, 16, 9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tq.make_quantized_apply_fn(bare, state, qparams=_to_port(jqp), device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            tq.quantize_detector(bare, state, _t(calib), device=device)
