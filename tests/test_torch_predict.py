"""The whole served slice on the `tiny` preset, port against reference, in
fp32 on the CPU: uint8 images -> PoseModel -> model_probs -> decode_probs,
with the same weights on both sides (converted by params_from_flax).

Three MRF paths: the Fourier pass through the fused tail (`impl='fft'`,
`use_pallas=True`; the reference's Pallas kernel in interpret mode), the
coarse stride-2 pass through the fused epilogue (`impl='pallas'`), and the
coarse stride-2 pass as `flagship`'s preset leaves it (`impl='auto'`, which
both packages resolve to the direct grouped conv, 'xla').  The first also
runs with the Fourier head conv (`head_conv_impl='fft'`, the reference's
fused tail in interpret mode) in place of the direct one.  Each path also
runs at MRF precision 'default', the serving default, with the JAX side
built by with_mrf_precision (on the CPU both are fp32).

`flagship`'s own path also runs in bf16, its compute dtype, where the
pairwise conv goes through the grouped conv's autograd function
(`ops/mrf_xla.grouped_conv_f32`), at a bar of a few bf16 roundings."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.configs import get_config as jax_get_config
from jointpose.configs import with_mrf_precision as jax_with_mrf_precision
from jointpose.models.mrf import select_impl as jax_select_impl
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose.ops.heatmaps import decode_probs, model_probs
from jointpose_torch import get_config
from jointpose_torch.configs import with_mrf_precision
from jointpose_torch.convert import params_from_flax
from jointpose_torch.models.mrf import select_impl
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.ops import mrf_xla
from jointpose_torch.predict import build_predictor, init_state_dict

# MRF log-heatmaps: the reference's parity tolerance for every
# message-pass path (BENCH_r05.json parity_tolerances), max|Δ| / max|ref|.
MRF_RTOL = 1e-3
# Conv stacks in fp32 (detector logits), max|Δ| / max|ref|.
CONV_RTOL = 1e-4
# Decoded coordinates in image pixels.
COORD_ATOL = 1e-3
# bf16 compute on both sides (flagship's dtype), max|Δ| / max|ref| for the
# logits and the MRF log-heatmaps alike: the two packages round the same
# bf16 conv stacks in other orders, a few roundings of 2^-8 each.
BF16_RTOL = 2e-2

PATHS = {
    "fft_fused": {"impl": "fft", "use_pallas": True},
    "coarse_epilogue": {"impl": "pallas", "stride": 2},
    "fft_fused_fft_head": {"impl": "fft", "use_pallas": True},
    # flagship's MRF fields as its preset leaves them: 'auto' at stride 2.
    "coarse_auto": {"impl": "auto", "stride": 2},
}
# The concrete pass each path resolves to, in both packages.
RESOLVED = {"fft_fused": "fft", "coarse_epilogue": "pallas", "fft_fused_fft_head": "fft",
            "coarse_auto": "xla"}
HEADS = {"fft_fused_fft_head": "fft"}


def _configs(path: str, normalize_input: bool, precision: str = "high",
             compute_dtype: str = "float32"):
    out = []
    for get, with_precision in ((jax_get_config, jax_with_mrf_precision),
                                (get_config, with_mrf_precision)):
        cfg = get("tiny")
        out.append(with_precision(cfg.replace(
            detector=dataclasses.replace(cfg.detector, head_conv_impl=HEADS.get(path, "direct")),
            mrf=dataclasses.replace(cfg.mrf, normalize_input=normalize_input, **PATHS[path]),
            decode_refine=True, compute_dtype=compute_dtype,
        ), precision))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("normalize_input", [True, False])
def test_served_slice_matches_reference(path, normalize_input):
    _check_served_slice(path, normalize_input, "high")


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("normalize_input", [True, False])
def test_served_slice_matches_reference_at_default_precision(path, normalize_input):
    _check_served_slice(path, normalize_input, "default")


def _check_served_slice(path, normalize_input, precision):
    jcfg, tcfg = _configs(path, normalize_input, precision)
    assert jcfg.mrf.precision == tcfg.mrf.precision == precision
    assert jax_select_impl(jcfg.mrf) == select_impl(tcfg.mrf) == RESOLVED[path]
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, size=(2, *jcfg.data.image_hw, 3)).astype(np.uint8)
    jmodel = JaxPoseModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # Perturb the uniform spatial kernels so each target joint differs.
    sm = variables["params"]["spatial_model"]
    sm["raw_kernels"] = sm["raw_kernels"] + 0.5 * rs.randn(*sm["raw_kernels"].shape).astype(np.float32)

    out_j = jmodel.apply(variables, jnp.asarray(images))
    probs_j = model_probs(out_j)
    coords_j = decode_probs(probs_j, jcfg.data.heatmap_stride, refine=True)

    state = params_from_flax(variables)
    model = PoseModel(tcfg)
    model.load_state_dict(state)
    with torch.no_grad():
        out_t = model(torch.from_numpy(images))
    assert _rel(out_t["detector_logits"], out_j["detector_logits"]) <= CONV_RTOL
    assert _rel(out_t["mrf_log_heatmaps"], out_j["mrf_log_heatmaps"]) <= MRF_RTOL

    coords_t, probs_t = build_predictor(tcfg, state, device="cpu")(torch.from_numpy(images))
    assert probs_t.shape == probs_j.shape and coords_t.shape == coords_j.shape
    assert _rel(probs_t, probs_j) <= MRF_RTOL
    np.testing.assert_allclose(coords_t.numpy(), np.asarray(coords_j), rtol=0, atol=COORD_ATOL)


def test_served_flagship_path_in_bf16_matches_reference(monkeypatch):
    """`flagship`'s MRF path as its preset stands ('auto' at stride 2, bf16
    compute, uint8 images, precision 'default') on `tiny`'s widths: the
    port's PoseModel against the reference's on the same converted weights.
    The coarse pass reaches the grouped conv's autograd function with all 9
    sources.  The decoded coordinates are printed, not held: seeded weights
    give near-ties that a bf16 rounding tips."""
    jcfg, tcfg = _configs("coarse_auto", True, "default", "bfloat16")
    assert jax_select_impl(jcfg.mrf) == select_impl(tcfg.mrf) == "xla"
    rs = np.random.RandomState(5)
    images = rs.randint(0, 256, size=(4, *jcfg.data.image_hw, 3)).astype(np.uint8)
    jmodel = JaxPoseModel(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(2), jnp.asarray(images)))
    sm = variables["params"]["spatial_model"]
    sm["raw_kernels"] = sm["raw_kernels"] + 0.5 * rs.randn(*sm["raw_kernels"].shape).astype(np.float32)
    out_j = jmodel.apply(variables, jnp.asarray(images))
    coords_j = decode_probs(model_probs(out_j), jcfg.data.heatmap_stride, refine=True)

    groups = []
    function = mrf_xla.grouped_conv_f32

    def recording(p, kern, n):
        groups.append((p.dtype, n))
        return function(p, kern, n)

    monkeypatch.setattr(mrf_xla, "grouped_conv_f32", recording)
    state = params_from_flax(variables)
    model = PoseModel(tcfg)
    model.load_state_dict(state)
    with torch.no_grad():
        out_t = model(torch.from_numpy(images))
    assert groups == [(torch.bfloat16, tcfg.num_joints)]
    errs = {key: _rel(out_t[key].float(), out_j[key].astype(jnp.float32))
            for key in ("detector_logits", "mrf_log_heatmaps")}
    coords_t, _ = build_predictor(tcfg, state, device="cpu")(torch.from_numpy(images))
    equal = float((np.abs(coords_t.numpy() - np.asarray(coords_j)) <= COORD_ATOL).mean())
    print(f"bf16 served slice ('auto' -> 'xla', stride 2): logits {errs['detector_logits']:.3e}, "
          f"MRF log-heatmaps {errs['mrf_log_heatmaps']:.3e} of the largest (bar {BF16_RTOL:g}); "
          f"{equal:.4f} of the coordinates within {COORD_ATOL:g} px (not held)")
    assert all(e <= BF16_RTOL for e in errs.values()), errs


def test_state_dict_matches_reference_layout():
    jcfg, tcfg = _configs("fft_fused", True)
    variables = JaxPoseModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *jcfg.data.image_hw, 3), jnp.float32)
    )
    converted = params_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    seeded = init_state_dict(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in converted.items()} == {
        k: tuple(v.shape) for k, v in seeded.items()
    }
    again = init_state_dict(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(seeded[k], again[k]) for k in seeded)
    # The uniform spatial-model init equals the reference's.
    for name in ("raw_kernels", "raw_bias"):
        np.testing.assert_allclose(
            seeded[f"spatial_model.{name}"].numpy(),
            converted[f"spatial_model.{name}"].numpy(), rtol=1e-6,
        )


@pytest.mark.parametrize("path", ["fft_fused", "coarse_epilogue"])
def test_flip_tta_predictor_matches_reference(path):
    from jointpose.predict import build_predictor as jax_build_predictor

    jcfg, tcfg = (c.replace(eval_flip_tta=True) for c in _configs(path, True))
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, size=(2, *jcfg.data.image_hw, 3)).astype(np.uint8)
    variables = JaxPoseModel(jcfg).init(jax.random.PRNGKey(1), jnp.asarray(images))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sm = variables["params"]["spatial_model"]
    sm["raw_kernels"] = sm["raw_kernels"] + 0.5 * rs.randn(*sm["raw_kernels"].shape).astype(np.float32)
    coords_j, probs_j = jax_build_predictor(jcfg, variables)(jnp.asarray(images))
    state = params_from_flax(variables)
    coords_t, probs_t = build_predictor(tcfg, state, device="cpu")(torch.from_numpy(images))
    assert _rel(probs_t, probs_j) <= MRF_RTOL
    np.testing.assert_allclose(coords_t.numpy(), np.asarray(coords_j), rtol=0, atol=COORD_ATOL)
    # The average is not the plain forward's heatmap.
    plain = build_predictor(tcfg.replace(eval_flip_tta=False), state, device="cpu")(
        torch.from_numpy(images))[1]
    assert _rel(plain, probs_j) > MRF_RTOL


def test_unported_options_raise(tmp_path):
    """MRF precision 'default', quantized serving and meshes of more than one
    device are ported: the model builds and serves, and the mesh flags reach
    the service (tests/test_torch_spatial.py), which refuses a mesh with the
    int8 detector as the reference does."""
    from jointpose_torch import serve

    cfg = with_mrf_precision(get_config("tiny"), "default")
    model = PoseModel(cfg)
    assert model.spatial_model.config.precision == "default"
    coords, _ = build_predictor(cfg, init_state_dict(cfg, torch.Generator().manual_seed(0)),
                                device="cpu")(torch.zeros(1, *cfg.data.image_hw, 3, dtype=torch.uint8))
    assert coords.shape == (1, cfg.num_joints, 2)
    with pytest.raises(ValueError, match="precision"):
        PoseModel(cfg.replace(mrf=dataclasses.replace(cfg.mrf, precision="bf16")))
    for flags in (["--mesh-data", "2"], ["--mesh-model", "2"]):
        with pytest.raises(FileNotFoundError, match="checkpoint"):  # past the mesh flags
            serve.main(["--config", "tiny", "--checkpoint", str(tmp_path), "--device", "cpu",
                        *flags])
    with pytest.raises(ValueError, match="exclusive"):
        serve.main(["--config", "tiny", "--checkpoint", str(tmp_path), "--device", "cpu",
                    "--quantize-artifact", "q.npz", "--mesh-data", "2"])


@pytest.mark.parametrize("case", ["pose_on_cuda", "pose_on_cpu", "pose_over_a_process_mesh",
                                  "device_mesh_model", "int8_model"])
def test_graphs_engage_only_for_a_one_device_pose_model_on_cuda(case):
    """``predict.graph_predictor``'s rule, decided from what the predictor
    is given (no card is needed to decide it)."""
    from jointpose_torch.ops.quant import QuantizedPoseModel
    from jointpose_torch.parallel.mesh import Mesh, make_device_mesh
    from jointpose_torch.predict import DeviceMeshModel, graph_predictor

    cfg = get_config("tiny")
    cuda = torch.device("cuda")
    model, device = {
        "pose_on_cuda": lambda: (PoseModel(cfg), cuda),
        "pose_on_cpu": lambda: (PoseModel(cfg), torch.device("cpu")),
        "pose_over_a_process_mesh": lambda: (PoseModel(cfg, mesh=Mesh(1, 2)), cuda),
        "device_mesh_model": lambda: (DeviceMeshModel(
            cfg, init_state_dict(cfg, torch.Generator().manual_seed(0)),
            make_device_mesh(2, 1, "cpu")), cuda),
        "int8_model": lambda: (QuantizedPoseModel(cfg, {}, PoseModel(cfg).spatial_model), cuda),
    }[case]()
    assert graph_predictor(device, model) == (case == "pose_on_cuda")
