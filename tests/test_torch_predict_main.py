"""The deployment path's CLIs, port against reference, on the CPU: both
packages' ``quantize.main`` and ``predict.main`` on one written FLIC
directory (tests/test_torch_pipeline.py:make_fake_flic) and one seeded
checkpoint written for each package (the reference's Checkpointer; the
same parameters converted for the port), `tiny` in fp32.

Both ``main``s read their config from ``get_config`` alone, so the tests
point it at the FLIC directory in both packages' namespaces.  The records
agree within 1e-3 px (tests/test_torch_predict.py), with and without the
int8 detector; five test examples at batch 2 make a last batch padded by
edge."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jointpose.configs
import jointpose.predict
from jointpose import quantize as jquantize
from jointpose.checkpoint import Checkpointer as JaxCheckpointer
from jointpose.configs import get_config as jax_get_config
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose.ops import quant as jq
from jointpose.train import create_state as jax_create_state
import jointpose_torch.configs
from jointpose_torch import predict, quantize
from jointpose_torch.convert import params_from_flax, write_initial_checkpoint
from jointpose_torch.ops import quant as tq

from test_torch_pipeline import make_fake_flic

COORD_ATOL = 1e-3
N_TEST = 5


def _cfg(get, flic_dir):
    cfg = get("tiny")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, source="flic", flic_dir=flic_dir, train_size=6,
                                 test_size=N_TEST),
        detector=dataclasses.replace(cfg.detector, head_conv_impl="direct"),
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("deploy")
    flic_dir = str(root / "flic")
    make_fake_flic(flic_dir, n_train=6, n_test=N_TEST)
    jcfg, tcfg = _cfg(jax_get_config, flic_dir), _cfg(jointpose_torch.configs.get_config, flic_dir)
    state = jax_create_state(jcfg, JaxPoseModel(jcfg), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, dict(state.params))
    params = {**params, "spatial_model": dict(params["spatial_model"])}
    raw = params["spatial_model"]["raw_kernels"]
    params["spatial_model"]["raw_kernels"] = raw + 0.5 * np.random.RandomState(0).randn(
        *raw.shape).astype(np.float32)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jdir, tdir = str(root / "jax_ck"), str(root / "torch_ck")
    ckpt = JaxCheckpointer(jdir, keep=1)
    ckpt.save(0, state)
    ckpt.close()
    write_initial_checkpoint(tcfg, tdir, params_from_flax(params))
    return root, jcfg, tcfg, jdir, tdir


@pytest.fixture
def configs(setup, monkeypatch):
    _, jcfg, tcfg, _, _ = setup
    monkeypatch.setattr(jointpose.predict, "get_config", lambda name: jcfg)
    monkeypatch.setattr(jointpose.configs, "get_config", lambda name: jcfg)
    monkeypatch.setattr(jointpose_torch.configs, "get_config", lambda name: tcfg)
    return setup


def _records(workdir):
    with open(f"{workdir}/predictions.jsonl") as f:
        return [json.loads(line) for line in f]


def _assert_records_agree(got, want):
    assert [(r["example"], r["split"], list(r["joints"])) for r in got] == [
        (r["example"], r["split"], list(r["joints"])) for r in want]
    xy = lambda recs: np.array([list(r["joints"].values()) for r in recs])  # noqa: E731
    np.testing.assert_allclose(xy(got), xy(want), rtol=0, atol=COORD_ATOL)


def test_quantize_main_writes_the_reference_artifact(configs, capsys):
    root, _, _, jdir, tdir = configs
    jquantize.main(["--config", "tiny", "--checkpoint", jdir, "--calib", "4",
                    "--out", str(root / "ref_int8.npz"), "--platform", "cpu"])
    quantize.main(["--config", "tiny", "--checkpoint", tdir, "--calib", "4",
                   "--out", str(root / "port_int8.npz"), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    summary = [line for line in out if line.startswith("quantized ")]
    assert len(summary) == 2
    # The same line but for the path and the size on disk.
    assert summary[0].split(" -> ")[0] == summary[1].split(" -> ")[0]
    assert "from checkpoint step 0, calibrated on 4 images" in summary[1]
    ref, ours = jq.load_quantized(str(root / "ref_int8.npz")), tq.load_quantized(
        str(root / "port_int8.npz"))
    assert set(ref) == set(ours)
    for name, node in ref.items():
        np.testing.assert_array_equal(ours[name]["w_q"].numpy().transpose(2, 3, 1, 0),
                                      np.asarray(node["w_q"]))
        np.testing.assert_allclose(ours[name]["in_scale"].numpy(), np.asarray(node["in_scale"]),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8_artifact"])
def test_predict_main_matches_reference(configs, capsys, int8):
    root, jcfg, tcfg, jdir, tdir = configs
    flags = ["--config", "tiny", "--num", str(N_TEST), "--batch-size", "2"]
    if int8:
        artifact = str(root / "int8_for_both.npz")
        quantize.main(["--config", "tiny", "--checkpoint", tdir, "--calib", "4", "--out", artifact,
                       "--device", "cpu"])
        flags += ["--quantize-artifact", artifact]
    jointpose.predict.main(["--checkpoint", jdir, "--workdir", str(root / "jax_out"),
                            "--platform", "cpu", *flags])
    predict.main(["--checkpoint", tdir, "--workdir", str(root / "torch_out"), "--device", "cpu",
                  *flags])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith(("wrote", "int8 detector"))]
    half = len(lines) // 2
    assert [line.replace("jax_out", "out") for line in lines[:half]] == [
        line.replace("torch_out", "out") for line in lines[half:]]
    got, want = _records(root / "torch_out"), _records(root / "jax_out")
    assert [r["example"] for r in got] == list(range(N_TEST))
    assert all(r["split"] == "test" for r in got)
    _assert_records_agree(got, want)


def test_predict_main_calibrates_like_the_artifact(configs, capsys):
    """``--quantize N`` calibrates on the train split's first N images, as
    ``quantize --calib N`` does: the same records."""
    root, _, _, _, tdir = configs
    artifact = str(root / "int8_calib3.npz")
    quantize.main(["--config", "tiny", "--checkpoint", tdir, "--calib", "3", "--out", artifact,
                   "--device", "cpu"])
    common = ["--config", "tiny", "--checkpoint", tdir, "--num", "4", "--batch-size", "4",
              "--split", "train", "--device", "cpu"]
    predict.main([*common, "--workdir", str(root / "calib"), "--quantize", "3"])
    predict.main([*common, "--workdir", str(root / "artifact"), "--quantize-artifact", artifact])
    assert "int8 detector (calibrated on 3 train images)" in capsys.readouterr().out
    assert _records(root / "calib") == _records(root / "artifact")
    assert all(r["split"] == "train" for r in _records(root / "calib"))


# --pipeline (tests/test_torch_pipeline_parallel.py) and inference meshes of
# more than one device are ported: a mesh over ["cpu"] * (data x model)
# writes the one-device records; the reference's refusals stand.
@pytest.mark.parametrize("flags", [["--mesh-data", "2"], ["--mesh-model", "2"],
                                   ["--mesh-data", "2", "--mesh-model", "2"]])
def test_unported_predict_flags_raise(configs, capsys, flags):
    root, _, _, _, tdir = configs
    common = ["--config", "tiny", "--checkpoint", tdir, "--num", str(N_TEST), "--batch-size",
              "2", "--device", "cpu"]
    predict.main([*common, "--workdir", str(root / "one")])
    name = "mesh" + "_".join(flags)
    predict.main([*common, "--workdir", str(root / name), *flags])
    assert "inference over DeviceMesh" in capsys.readouterr().out
    _assert_records_agree(_records(root / name), _records(root / "one"))
    for extra in (["--batch-size", "3"], ["--pipeline", "2"], ["--quantize", "2"]):
        with pytest.raises(SystemExit):
            predict.main([*common, "--workdir", str(root / "x"), "--mesh-data", "2", *extra])


def test_one_device_mesh_flags_predict(configs):
    root, _, _, _, tdir = configs
    predict.main(["--config", "tiny", "--checkpoint", tdir, "--workdir", str(root / "mesh1"),
                  "--num", "2", "--batch-size", "2", "--device", "cpu", "--mesh-data", "-1",
                  "--mesh-model", "1"])
    assert len(_records(root / "mesh1")) == 2


def test_deployment_entry_points_need_cuda_unless_asked_for_cpu(configs, monkeypatch):
    import torch

    from jointpose_torch import serve

    root, _, tcfg, _, tdir = configs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, flags in ((quantize.main, ["--out", str(root / "x.npz")]),
                        (predict.main, ["--workdir", str(root / "x")]),
                        (predict.main, ["--workdir", str(root / "x"), "--quantize", "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--config", "tiny", "--checkpoint", tdir, *flags])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.PoseService(tcfg, tdir, batch_size=2, best=False, quantize_calib=2)
