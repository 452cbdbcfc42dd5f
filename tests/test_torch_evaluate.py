"""The port's evaluation (jointpose_torch.evaluate) against the JAX
reference on the CPU: the PDJ arithmetic exactly, and ``evaluate`` on the
``tiny`` preset over the same host arrays and converted weights.

Tolerances: counts, flips and torso diameters are exact or one fp32 step.
In ``evaluate`` the two frameworks' fp32 heatmaps differ by ~1e-6, which
can move a decoded peak that sits on a threshold, so the PDJ curves may
differ by one count per joint and threshold; ``num_examples`` and
``num_torso_excluded`` are equal.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose import evaluate as jev
from jointpose.configs import get_config as jax_get_config
from jointpose.data import pipeline as jpipe
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose_torch import evaluate as tev
from jointpose_torch import get_config, skeleton
from jointpose_torch.convert import params_from_flax
from jointpose_torch.data import pipeline as tpipe
from jointpose_torch.models.pose import PoseModel

K = 9


def _t(x):
    return torch.from_numpy(np.array(x))


def test_thresholds_equal_reference():
    assert tev.DEFAULT_THRESHOLDS == jev.DEFAULT_THRESHOLDS


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (1, 5, 7, 9)])
def test_flip_images_is_exact(shape):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(tev.flip_images(_t(x)).numpy(), np.asarray(jev.flip_images(jnp.asarray(x))))


def test_unflip_heatmaps_is_exact_and_swaps_left_and_right():
    x = np.random.RandomState(1).rand(2, 6, 8, K).astype(np.float32)
    got = tev.unflip_heatmaps(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jev.unflip_heatmaps(jnp.asarray(x))))
    li, ri = skeleton.JOINT_INDEX["lwri"], skeleton.JOINT_INDEX["rwri"]
    assert torch.equal(got[..., li], _t(x)[..., ri].flip(2))
    assert torch.equal(tev.unflip_heatmaps(got), _t(x))  # an involution


def test_torso_diameter_matches_reference():
    j = (np.random.RandomState(2).rand(5, K, 2) * 100).astype(np.float32)
    np.testing.assert_allclose(tev.torso_diameter(_t(j)).numpy(),
                               np.asarray(jev.torso_diameter(jnp.asarray(j))), rtol=1e-6)
    assert tev.torso_diameter(_t(j)[0]).shape == ()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pdj_counts_match_reference(seed):
    rs = np.random.RandomState(seed)
    gt = (rs.rand(16, K, 2) * [64, 48]).astype(np.float32)
    pred = gt + rs.randn(16, K, 2).astype(np.float32) * 2.0
    pred[:4] = gt[:4]  # exact hits count at threshold 0
    visible = (rs.rand(16, K) > 0.2).astype(np.float32)
    thr = np.asarray(tev.DEFAULT_THRESHOLDS, np.float32)
    want = jev.pdj_counts(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(visible), jnp.asarray(thr))
    got = tev.pdj_counts(_t(pred), _t(gt), _t(visible), _t(thr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (21, K) and got[1].shape == (K,) and got[2].shape == ()


def test_pdj_counts_exclude_examples_without_a_torso():
    gt = np.full((2, K, 2), 10.0, np.float32)
    gt[:, skeleton.JOINT_INDEX["rhip"]] = [40.0, 50.0]
    visible = np.ones((2, K), np.float32)
    visible[1, skeleton.JOINT_INDEX["lsho"]] = 0.0
    d, v, t = tev.pdj_counts(_t(gt), _t(gt), _t(visible), torch.tensor([0.05]))
    assert t.item() == 1.0 and (v == 1).all() and (d == 1).all()


def _setup(n, tta, uint8_images=True, seed=0):
    jcfg, tcfg = (get("tiny").replace(eval_flip_tta=tta) for get in (jax_get_config, get_config))
    rs = np.random.RandomState(seed)
    h, w = tcfg.data.image_hw
    images = rs.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    if not uint8_images:
        images = (images / 255.0).astype(np.float32)
    joints = rs.uniform([4, 4], [w - 5, h - 5], (n, K, 2)).astype(np.float32)
    visible = (rs.rand(n, K) > 0.1).astype(np.float32)
    visible[0, skeleton.JOINT_INDEX["lsho"]] = 0.0  # one example without a torso
    arrays = {"image": images, "joints": joints, "visible": visible}
    jmodel = JaxPoseModel(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, 3), jnp.float32)))
    sm = variables["params"]["spatial_model"]
    sm["raw_kernels"] = sm["raw_kernels"] + 0.5 * rs.randn(*sm["raw_kernels"].shape).astype(np.float32)
    model = PoseModel(tcfg)
    model.load_state_dict(params_from_flax(variables))
    return jcfg, tcfg, arrays, jmodel, variables, model.eval()


def _assert_evals_agree(got, want, visible_counts):
    assert got["num_examples"] == want["num_examples"]
    assert got["num_torso_excluded"] == want["num_torso_excluded"]
    assert got["thresholds"] == want["thresholds"]
    diff = np.abs(np.asarray(got["pdj_curves"]) - np.asarray(want["pdj_curves"]))
    assert (diff * np.maximum(visible_counts, 1.0)[None] <= 1.0 + 1e-6).all()
    assert set(got["pdj_at_05"]) == set(want["pdj_at_05"])
    assert abs(got["pdj_at_05_wrist_elbow"] - want["pdj_at_05_wrist_elbow"]) <= 1.0 / visible_counts.min()


def _visible_counts(arrays, n_used):
    vis = arrays["visible"][:n_used]
    ok = vis[:, skeleton.JOINT_INDEX["lsho"]] * vis[:, skeleton.JOINT_INDEX["rhip"]]
    return (vis * ok[:, None]).sum(axis=0)


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("n", [8, 10])  # 10 is no multiple of the batch of 4
def test_evaluate_matches_reference(n, tta):
    jcfg, tcfg, arrays, jmodel, variables, model = _setup(n, tta)
    want = jev.evaluate(variables, jpipe.from_host_arrays(arrays), jcfg, jmodel.apply)
    got = tev.evaluate(model, tpipe.from_host_arrays(arrays), tcfg)
    assert got["num_examples"] == n and got["num_torso_excluded"] >= 1.0
    _assert_evals_agree(got, want, _visible_counts(arrays, n))


def test_evaluate_max_batches_and_uint8_ingest_match_reference():
    jcfg, tcfg, arrays, jmodel, variables, model = _setup(10, tta=False, uint8_images=False, seed=1)
    kw = dict(max_batches=2, uint8_ingest=True)
    want = jev.evaluate(variables, jpipe.from_host_arrays(arrays), jcfg, jmodel.apply, **kw)
    got = tev.evaluate(model, tpipe.from_host_arrays(arrays), tcfg, **kw)
    assert got["num_examples"] == 8.0
    _assert_evals_agree(got, want, _visible_counts(arrays, 8))
    # uint8 splits pass through uint8_ingest untouched.
    as_u8 = dict(arrays, image=np.round(arrays["image"] * 255.0).astype(np.uint8))
    again = tev.evaluate(model, tpipe.from_host_arrays(as_u8), tcfg, **kw)
    assert again["pdj_curves"] == got["pdj_curves"]


def test_detector_only_eval_step_and_threshold_check():
    _, tcfg, arrays, _, _, model = _setup(8, tta=False)
    ds = tpipe.from_host_arrays(arrays)
    calls = []
    model.spatial_model.register_forward_hook(lambda *a: calls.append(1))
    step = tev.make_eval_step(tcfg, functools.partial(model, detector_only=True))
    det = tev.evaluate(model, ds, tcfg, eval_step=step)
    assert not calls and det["num_examples"] == 8.0
    # The detector-only score is that of the same config without an MRF.
    bare = PoseModel(tcfg.replace(mrf=None))
    bare.load_state_dict({k: v for k, v in model.state_dict().items() if k.startswith("detector.")})
    assert tev.evaluate(bare, ds, tcfg.replace(mrf=None))["pdj_curves"] == det["pdj_curves"]
    tev.evaluate(model, ds, tcfg)
    assert calls
    with pytest.raises(AssertionError, match="thresholds"):
        tev.evaluate(model, ds, tcfg, thresholds=(0.05, 0.1), eval_step=step)


def test_evaluate_main_reads_a_fit_checkpoint(tmp_path, capsys):
    from jointpose_torch.train import fit

    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, detector_steps=1, joint_steps=1,
                                                eval_every=2, log_every=2))
    fit(cfg, str(tmp_path / "run"), eval_max_batches=1, device="cpu")
    out = tmp_path / "ev.json"
    tev.main(["--config", "tiny", "--checkpoint", str(tmp_path / "run" / "checkpoints"), "--best",
              "--tta", "--max-batches", "1", "--json-out", str(out), "--device", "cpu"])
    assert "checkpoint step 2, test split, 4 examples" in capsys.readouterr().out
    assert out.exists()


@pytest.mark.parametrize("tta", [False, True])
def test_evaluate_int8_model_matches_reference(tmp_path, tta):
    """The PDJ harness on the int8 detector: one artifact of the reference's
    qparams, read by both packages, over the same host arrays."""
    from jointpose.ops import quant as jq
    from jointpose_torch.ops import quant as tq

    jcfg, tcfg, arrays, jmodel, variables, model = _setup(10, tta)
    jqp = jq.quantize_detector(jcfg, variables, jnp.asarray(arrays["image"][:4]))
    jq.save_quantized(str(tmp_path / "int8.npz"), jqp)
    apply_fn = jq.make_quantized_apply_fn(jcfg, variables, qparams=jq.load_quantized(
        str(tmp_path / "int8.npz")))
    want = jev.evaluate(variables, jpipe.from_host_arrays(arrays), jcfg, apply_fn)
    qmodel = tq.make_quantized_apply_fn(tcfg, model.state_dict(), device="cpu",
                                        qparams=tq.load_quantized(str(tmp_path / "int8.npz")))
    got = tev.evaluate(qmodel, tpipe.from_host_arrays(arrays), tcfg)
    _assert_evals_agree(got, want, _visible_counts(arrays, 10))
    # Without an MRF the int8 model holds buffers alone; evaluate finds its device.
    bare = tq.make_quantized_apply_fn(tcfg.replace(mrf=None), model.state_dict(), device="cpu",
                                      qparams=qmodel.qparams())
    assert tev.evaluate(bare, tpipe.from_host_arrays(arrays), tcfg.replace(mrf=None))[
        "num_examples"] == 10.0


def test_evaluate_main_scores_the_int8_model(tmp_path, capsys):
    from jointpose_torch import quantize
    from jointpose_torch.train import fit

    cfg = get_config("tiny")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, detector_steps=1, joint_steps=1,
                                                eval_every=2, log_every=2))
    fit(cfg, str(tmp_path / "run"), eval_max_batches=1, device="cpu")
    ckpt = str(tmp_path / "run" / "checkpoints")
    artifact = str(tmp_path / "int8.npz")
    quantize.main(["--config", "tiny", "--checkpoint", ckpt, "--calib", "4", "--out", artifact,
                   "--device", "cpu"])
    common = ["--config", "tiny", "--checkpoint", ckpt, "--max-batches", "2", "--device", "cpu",
              "--mesh-data", "1", "--mesh-model", "1"]
    tev.main([*common, "--quantize-artifact", artifact, "--json-out", str(tmp_path / "a.json")])
    tev.main([*common, "--quantize", "4", "--json-out", str(tmp_path / "c.json")])
    out = capsys.readouterr().out
    assert f"int8 detector (artifact {artifact})" in out
    assert "int8 detector (calibrated on 4 train images)" in out
    with open(tmp_path / "a.json") as f, open(tmp_path / "c.json") as g:
        a, c = json.load(f), json.load(g)
    assert a == c and a["num_examples"] == 8.0 and 0.0 <= a["pdj_at_05_wrist_elbow"] <= 1.0
    # A mesh is one process per device: without a launcher one process holds
    # a mesh of one (evaluate.main over the launcher: tests/test_torch_parallel.py).
    for flags in (["--mesh-data", "2"], ["--mesh-model", "2"]):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            tev.main(["--config", "tiny", "--checkpoint", ckpt, "--device", "cpu", *flags])
