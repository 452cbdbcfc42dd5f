"""The port's two-stage pipelined predictor (jointpose_torch.parallel.pipeline)
against the JAX single program, on repeated CPU devices: the counterparts
of ``tests/test_pipeline.py`` (the split, the match in float32 and uint8,
'auto' head conv, flip TTA, indivisible batches, the int8 stage 0, no MRF)
at its tolerances, and ``predict.main --pipeline``.

``["cpu"] * n`` stands in for the reference's fake CPU devices: the port
runs one process, and a device list may repeat a device.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.configs import get_config as jax_get_config
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose.ops import quant as jq
from jointpose.predict import build_predictor as jax_build_predictor
from jointpose_torch import get_config
from jointpose_torch import predict as tpredict
from jointpose_torch.convert import params_from_flax, write_initial_checkpoint
from jointpose_torch.ops.quant import load_quantized
from jointpose_torch.parallel.pipeline import build_pipelined_predictor, split_stage_devices

# tests/test_pipeline.py:54-57.
PROB_RTOL, PROB_ATOL = 1e-5, 1e-6
COORD_RTOL, COORD_ATOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def tiny_params():
    cfg = jax_get_config("tiny")
    h, w = cfg.data.image_hw
    params = JaxPoseModel(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)))
    return params, params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _images(n, seed=0, dtype=np.float32):
    h, w = get_config("tiny").data.image_hw
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, (n, h, w, 3), dtype=np.uint8)
    return rs.rand(n, h, w, 3).astype(np.float32)


def _assert_match(got, want):
    (got_c, got_p), (want_c, want_p) = got, want
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=PROB_RTOL, atol=PROB_ATOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=COORD_RTOL, atol=COORD_ATOL)


def test_split_stage_devices():
    g0, g1 = split_stage_devices(["cpu"] * 8)
    assert len(g0) == 4 and len(g1) == 4
    g0, g1 = split_stage_devices(["cpu"] * 3)
    assert len(g0) == 2 and len(g1) == 1
    assert g0[0] == torch.device("cpu")
    with pytest.raises(ValueError, match=">= 2 devices"):
        split_stage_devices(["cpu"])


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pipeline_matches_single_program(tiny_params, dtype):
    params, state_dict = tiny_params
    imgs = _images(8, seed=1, dtype=dtype)
    want = jax_build_predictor(jax_get_config("tiny"), params)(jnp.asarray(imgs))
    pp = build_pipelined_predictor(get_config("tiny"), state_dict, devices=["cpu"] * 8, n_micro=2)
    _assert_match(pp(torch.from_numpy(imgs)), want)


def test_pipeline_pins_auto_head_impl(tiny_params):
    # The port resolves 'auto' by a rule on the config alone, so stage 0 at
    # the microbatch size runs the head the single program runs: 'direct',
    # held against the reference's single program with 'direct'.
    params, state_dict = tiny_params
    tcfg = get_config("tiny")
    tcfg = tcfg.replace(detector=dataclasses.replace(tcfg.detector, head_conv_impl="auto"))
    jcfg = jax_get_config("tiny")
    jcfg = jcfg.replace(detector=dataclasses.replace(jcfg.detector, head_conv_impl="direct"))
    imgs = _images(8, seed=3)
    want = jax_build_predictor(jcfg, params)(jnp.asarray(imgs))
    single = tpredict.build_predictor(tcfg, state_dict, device="cpu")(torch.from_numpy(imgs))
    got = build_pipelined_predictor(tcfg, state_dict, devices=["cpu"] * 4, n_micro=2)(
        torch.from_numpy(imgs))
    _assert_match(got, want)
    assert torch.equal(got[1], single[1])


def test_pipeline_with_flip_tta(tiny_params):
    params, state_dict = tiny_params
    imgs = _images(4, seed=2)
    want = jax_build_predictor(jax_get_config("tiny").replace(eval_flip_tta=True), params)(
        jnp.asarray(imgs))
    pp = build_pipelined_predictor(get_config("tiny").replace(eval_flip_tta=True), state_dict,
                                   devices=["cpu"] * 4, n_micro=2)
    _assert_match(pp(torch.from_numpy(imgs)), want)


def test_pipeline_rejects_indivisible_batches(tiny_params):
    _, state_dict = tiny_params
    pp = build_pipelined_predictor(get_config("tiny"), state_dict, devices=["cpu"] * 4, n_micro=2)
    with pytest.raises(ValueError, match="microbatches"):
        pp(torch.from_numpy(_images(5)))
    with pytest.raises(ValueError, match="stage device counts"):
        pp(torch.from_numpy(_images(2)))  # microbatch 1 vs 2-device stage


def test_pipeline_with_int8_stage0(tiny_params, tmp_path):
    # The reference's qparams through its artifact, read by the port.
    params, state_dict = tiny_params
    jcfg = jax_get_config("tiny")
    jcfg = jcfg.replace(detector=dataclasses.replace(jcfg.detector, head_conv_impl="direct"))
    q = jq.quantize_detector(jcfg, params, jnp.asarray(_images(4, seed=7)))
    jq.save_quantized(str(tmp_path / "q.npz"), q)
    imgs = _images(4, seed=8)
    want = jq.build_quantized_predictor(jcfg, params, qparams=q)(jnp.asarray(imgs))
    tcfg = get_config("tiny")
    tcfg = tcfg.replace(detector=dataclasses.replace(tcfg.detector, head_conv_impl="direct"))
    pp = build_pipelined_predictor(tcfg, state_dict, devices=["cpu"] * 4, n_micro=2,
                                   qparams=load_quantized(str(tmp_path / "q.npz")))
    _assert_match(pp(torch.from_numpy(imgs)), want)


def test_pipeline_detector_only():
    jcfg = dataclasses.replace(jax_get_config("tiny"), mrf=None)
    h, w = jcfg.data.image_hw
    params = JaxPoseModel(jcfg).init(jax.random.PRNGKey(3), jnp.zeros((1, h, w, 3)))
    imgs = _images(4, seed=4)
    want_c, _ = jax_build_predictor(jcfg, params)(jnp.asarray(imgs))
    pp = build_pipelined_predictor(dataclasses.replace(get_config("tiny"), mrf=None),
                                   params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
                                   devices=["cpu"] * 4, n_micro=2)
    got_c, _ = pp(torch.from_numpy(imgs))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=COORD_RTOL, atol=COORD_ATOL)


def _records(workdir):
    with open(os.path.join(workdir, "predictions.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_predict_main_pipeline(tiny_params, tmp_path, capsys):
    """--pipeline N gives the single program's records, composes with
    --quantize, and checks its divisibility and exclusivity as the
    reference's main does."""
    _, state_dict = tiny_params
    cfg = get_config("tiny")
    ckpt = str(tmp_path / "ckpt")
    write_initial_checkpoint(cfg, ckpt, state_dict)
    common = ["--config", "tiny", "--checkpoint", ckpt, "--num", "6", "--batch-size", "4",
              "--split", "train", "--device", "cpu"]
    for name, flags in (("single", []), ("pipelined", ["--pipeline", "2"]),
                        ("int8", ["--quantize", "4"]), ("int8_pipelined", ["--quantize", "4",
                                                                           "--pipeline", "4"])):
        tpredict.main([*common, "--workdir", str(tmp_path / name), *flags])
    assert "int8 detector (calibrated on 4 train images)" in capsys.readouterr().out
    for a, b in (("single", "pipelined"), ("int8", "int8_pipelined")):
        got, want = _records(tmp_path / b), _records(tmp_path / a)
        assert [r["example"] for r in got] == list(range(6))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(list(g["joints"].values())),
                                       np.asarray(list(w["joints"].values())), atol=COORD_ATOL)
    with pytest.raises(SystemExit, match="must divide --batch-size"):
        tpredict.main([*common, "--workdir", str(tmp_path / "x"), "--pipeline", "3"])
    with pytest.raises(SystemExit, match="exclusive"):
        tpredict.main([*common, "--workdir", str(tmp_path / "x"), "--pipeline", "2",
                       "--mesh-data", "2"])
