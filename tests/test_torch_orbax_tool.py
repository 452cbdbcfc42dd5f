"""``tools/orbax_to_torch.py`` and the port's ``fit`` at steps_per_dispatch 4,
both against one run of the reference's ``fit`` (``tiny``, fp32 on the CPU,
a FLIC directory the test writes, augmentation off, 4 + 4 steps in
dispatches of 4, the trunk's pool_mode 'stride' where the preset says
'max').

- The port's ``fit`` at the same K, from the reference's initial weights
  (a step-0 checkpoint of the port, as ``tests/test_torch_fit.py`` starts
  it): parameters within PARAM_TOL of the reference's, max|Δ| / max(1,
  max|ref|) per tensor (one Adam update moves a parameter by up to lr =
  3e-4), and the same logged step/stage cadence.
- The converter on the run's ``latest`` step, on ``--best`` and on a copy
  in the legacy layout (step directories at the root): the port restores
  what it wrote and serves it on the CPU; against the reference's
  predictor on the same checkpoint and images, the argmax cells are equal
  and the decoded coordinates within COORD_TOL px.  The recorded trunk
  mode and head-conv implementation come across into the port's
  ``run_config.json``.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from jointpose import predict as jpredict
from jointpose import train as jtrain
from jointpose.checkpoint import reconcile_config as jax_reconcile
from jointpose.configs import get_config as jax_get_config
from jointpose.configs import with_pool_mode as jax_with_pool_mode
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose_torch import get_config
from jointpose_torch import train as ttrain
from jointpose_torch.checkpoint import load_run_metadata, reconcile_config
from jointpose_torch.configs import with_pool_mode
from jointpose_torch.convert import params_from_flax, write_initial_checkpoint
from jointpose_torch.data.pipeline import make_dataset
from jointpose_torch.predict import build_predictor, restore_params

from test_torch_pipeline import make_fake_flic

ROOT = Path(__file__).resolve().parent.parent
PARAM_TOL = 1e-5
COORD_TOL = 1e-3


def _tool():
    path = ROOT / "tools" / "orbax_to_torch.py"
    spec = importlib.util.spec_from_file_location("orbax_to_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tiny(get, with_pool_mode_fn, data):
    c = with_pool_mode_fn(get("tiny"), "stride")
    return c.replace(
        augment=dataclasses.replace(c.augment, enabled=False),
        data=dataclasses.replace(c.data, **data),
        train=dataclasses.replace(c.train, detector_steps=4, joint_steps=4, eval_every=4,
                                  log_every=4, steps_per_dispatch=4),
    )


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    make_fake_flic(str(root / "flic"), n_train=8, n_test=6)
    data = dict(source="flic", flic_dir=str(root / "flic"), train_size=8, test_size=6)
    jcfg = _tiny(jax_get_config, jax_with_pool_mode, data)
    tcfg = _tiny(get_config, with_pool_mode, data)
    assert get_config("tiny").detector.pool_mode == "max"
    result = jtrain.fit(jcfg, str(root / "jax"))
    return types.SimpleNamespace(root=root, jcfg=jcfg, tcfg=tcfg, result=result,
                                 ckpt=str(root / "jax" / jcfg.train.checkpoint_dir))


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_in_dispatches_of_4_matches_the_reference(reference, tmp_path):
    jcfg, tcfg = reference.jcfg, reference.tcfg
    initial = jtrain.create_state(jcfg, JaxPoseModel(jcfg), jax.random.PRNGKey(jcfg.train.seed))
    write_initial_checkpoint(
        tcfg, str(tmp_path / tcfg.train.checkpoint_dir),
        params_from_flax(jax.tree_util.tree_map(np.asarray, initial.params)))
    got = ttrain.fit(tcfg, str(tmp_path), resume=True, device="cpu")

    want = reference.result
    assert got.state.step == int(want.state.step) == 8
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, want.state.params))
    params = dict(got.state.model.named_parameters())
    assert set(params) == set(ref)
    for name, w in ref.items():
        err = (params[name].detach() - w).abs().max().item() / max(1.0, w.abs().max().item())
        assert err <= PARAM_TOL, (name, err)

    def cadence(recs):
        return [(r["step"], r.get("stage", r.get("eval_stage"))) for r in recs]

    assert cadence(_records(got.workdir)) == cadence(_records(want.workdir)) == [
        (4, "detector"), (4, "detector"), (8, "joint"), (8, "joint")]


def _legacy_copy(src, dst):
    """The reference's legacy layout: the step directories at the root."""
    os.makedirs(dst)
    for step in os.listdir(os.path.join(src, "latest")):
        shutil.copytree(os.path.join(src, "latest", step), os.path.join(dst, step))
    shutil.copy(os.path.join(src, "run_config.json"), dst)
    return dst


@pytest.mark.parametrize("which", ["latest", "best", "legacy"])
def test_a_converted_checkpoint_serves_like_the_reference(reference, tmp_path, which):
    src = (_legacy_copy(reference.ckpt, str(tmp_path / "legacy")) if which == "legacy"
           else reference.ckpt)
    out = str(tmp_path / "torch" / "checkpoints")
    best = ["--best"] if which == "best" else []
    assert _tool().main(["--src", src, "--out", out, "--platform", "cpu", *best]) == 0

    recorded = load_run_metadata(src)
    assert recorded["pool_mode"] == "stride"
    meta = load_run_metadata(out)
    assert (meta["pool_mode"], meta["head_conv_impl_resolved"]) == (
        recorded["pool_mode"], recorded["head_conv_impl_resolved"])

    tcfg = reconcile_config(get_config("tiny"), out)
    assert tcfg.detector.pool_mode == "stride"
    state_dict, step = restore_params(tcfg, out)
    assert step == 0
    images = make_dataset(reference.tcfg.data, "cpu")[1].get_batch(np.arange(6))["image"]
    coords, probs = build_predictor(tcfg, state_dict, device="cpu")(images)

    jcfg = jax_reconcile(jax_get_config("tiny"), src)
    variables, _ = jpredict.restore_params(jcfg, src, best=which == "best")
    want_coords, want_probs = jpredict.build_predictor(jcfg, variables)(images.numpy())
    want_probs = np.asarray(want_probs)
    b, h, w, k = want_probs.shape
    np.testing.assert_array_equal(probs.numpy().reshape(b, h * w, k).argmax(axis=1),
                                  want_probs.reshape(b, h * w, k).argmax(axis=1))
    assert np.abs(coords.numpy() - np.asarray(want_coords)).max() <= COORD_TOL


def test_the_recorded_head_impl_comes_across(reference, tmp_path):
    """A source whose run resolved the head conv to 'fft' (edited into a
    copy of the record): the port's config pins it, and its record says so."""
    src = str(tmp_path / "src")
    shutil.copytree(os.path.join(reference.ckpt, "latest"), os.path.join(src, "latest"))
    meta = load_run_metadata(reference.ckpt)
    with open(os.path.join(src, "run_config.json"), "w") as f:
        json.dump({**meta, "head_conv_impl_resolved": "fft"}, f)
    out = str(tmp_path / "out")
    assert _tool().main(["--src", src, "--out", out, "--config", "tiny", "--platform", "cpu"]) == 0
    got = load_run_metadata(out)
    assert (got["config_name"], got["pool_mode"], got["head_conv_impl_resolved"]) == (
        "tiny", "stride", "fft")
    with pytest.raises(SystemExit):  # the port's directory now holds a checkpoint
        _tool().main(["--src", src, "--out", out, "--platform", "cpu"])
