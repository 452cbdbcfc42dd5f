"""The whole training slice: the port's ``fit`` against the reference's on
the ``tiny`` preset, fp32 on the CPU, over a small FLIC directory the test
writes itself (``source='flic'``, augmentation off, 4 + 4 steps).

Both runs start from the same weights: the reference's initial parameters
(``create_state`` with ``PRNGKey(config.train.seed)``) are converted and
written as a step-0 checkpoint of the port, which ``fit(resume=True)``
continues from.  Final parameters agree within the tolerance of
tests/test_torch_train.py per tensor, max|Δ| / max(1, max|ref|) <= 1e-5
(measured 1.6e-7; each Adam update moves a parameter by up to lr = 3e-4,
so a skipped or mis-counted update misses by ~3e-4); the eval curves
within one count per joint and threshold.  The frames have contrast at
the working resolution: on grey frames the gradients nearly cancel, and
Adam turns their last-bit differences between the frameworks into
differences of a whole update.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from jointpose import train as jtrain
from jointpose.configs import get_config as jax_get_config
from jointpose.models.pose import PoseModel as JaxPoseModel
from jointpose_torch import get_config
from jointpose_torch import train as ttrain
from jointpose_torch.checkpoint import Checkpointer
from jointpose_torch.convert import params_from_flax, write_initial_checkpoint
from jointpose_torch.predict import build_predictor, restore_params

from test_torch_pipeline import make_fake_flic

PARAM_TOL = 1e-5


def _tiny(get, **kw):
    c = get("tiny")
    return c.replace(
        augment=dataclasses.replace(c.augment, enabled=kw.pop("augment", False)),
        data=dataclasses.replace(c.data, **kw.pop("data", {})),
        train=dataclasses.replace(c.train, **{**dict(detector_steps=4, joint_steps=4,
                                                     eval_every=4, log_every=2), **kw}),
    )


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_matches_reference_on_a_flic_directory(tmp_path):
    make_fake_flic(str(tmp_path / "flic"), n_train=8, n_test=6)
    data = dict(source="flic", flic_dir=str(tmp_path / "flic"), train_size=8, test_size=6)
    jcfg, tcfg = _tiny(jax_get_config, data=data), _tiny(get_config, data=data)
    want = jtrain.fit(jcfg, str(tmp_path / "jax"))
    initial = jtrain.create_state(jcfg, JaxPoseModel(jcfg), jax.random.PRNGKey(jcfg.train.seed))
    write_initial_checkpoint(
        tcfg, str(tmp_path / "torch" / tcfg.train.checkpoint_dir),
        params_from_flax(jax.tree_util.tree_map(np.asarray, initial.params)))
    got = ttrain.fit(tcfg, str(tmp_path / "torch"), resume=True, device="cpu")

    assert got.state.step == int(want.state.step) == 8
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, want.state.params))
    params = dict(got.state.model.named_parameters())
    assert set(params) == set(ref)
    for name, w in ref.items():
        err = (params[name].detach() - w).abs().max().item() / max(1.0, w.abs().max().item())
        assert err <= PARAM_TOL, (name, err)
    # The prior init happened on both sides: the kernels left their uniform init.
    assert params["spatial_model.raw_kernels"].std() > 0.1

    for key in ("num_examples", "num_torso_excluded", "eval_stage", "thresholds"):
        assert got.metrics[key] == want.metrics[key], key
    diff = np.abs(np.asarray(got.metrics["pdj_curves"]) - np.asarray(want.metrics["pdj_curves"]))
    assert (diff * got.metrics["num_examples"] <= 1.0 + 1e-6).all()
    jrec, trec = _records(want.workdir), _records(got.workdir)
    losses = lambda recs: [(r["step"], r["stage"]) for r in recs if "loss" in r]  # noqa: E731
    evals = lambda recs: [(r["step"], r["eval_stage"]) for r in recs if "eval_stage" in r]  # noqa: E731
    assert losses(trec) == losses(jrec) == [(2, "detector"), (4, "detector"), (6, "joint"), (8, "joint")]
    assert evals(trec) == evals(jrec) == [(4, "detector"), (8, "joint")]
    for t, j in zip([r for r in trec if "loss" in r], [r for r in jrec if "loss" in r]):
        for key in ("loss", "detector_loss", "mrf_loss", "grad_norm"):
            assert (key in t) == (key in j)
            if key in j:
                assert t[key] == pytest.approx(j[key], rel=1e-4), (t["step"], key)
        assert "images_per_sec" in t and "dispatch_images_per_sec" in j


def test_fit_cadence_checkpoints_and_resume(tmp_path, capsys):
    cfg = _tiny(get_config, augment=True, detector_steps=3, joint_steps=3, eval_every=2,
                log_every=3, keep_checkpoints=2)
    workdir = str(tmp_path / "run")
    result = ttrain.fit(cfg, workdir, eval_max_batches=1, device="cpu")
    assert result.state.step == 6 and result.metrics["eval_stage"] == "joint"
    recs = _records(workdir)
    assert [(r["step"], r["stage"]) for r in recs if "loss" in r] == [(3, "detector"), (6, "joint")]
    assert [(r["step"], r["eval_stage"]) for r in recs if "eval_stage" in r] == [
        (2, "detector"), (4, "joint"), (6, "joint")]
    assert all(np.isfinite(r["loss"]) and r["images_per_sec"] > 0 for r in recs if "loss" in r)
    ckpt_dir = os.path.join(workdir, cfg.train.checkpoint_dir)
    assert sorted(os.listdir(os.path.join(ckpt_dir, "latest"))) == ["4", "6"]
    # Only full-model evals rank the kept best: never the detector-stage step 2.
    best = Checkpointer(ckpt_dir).best_step()
    assert best in (4, 6)
    assert capsys.readouterr().out.count("estimating pairwise priors") == 1

    # What was saved is what serves.
    state_dict, step = restore_params(cfg, ckpt_dir)
    assert step == 6
    images = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 48, 64, 3)).astype(np.uint8))
    want = build_predictor(cfg, result.state.model.state_dict(), device="cpu")(images)
    got = build_predictor(cfg, state_dict, device="cpu")(images)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    # Resume takes exactly the steps that are left and does not re-apply the priors.
    longer = cfg.replace(train=dataclasses.replace(cfg.train, joint_steps=5))
    resumed = ttrain.fit(longer, workdir, eval_max_batches=1, resume=True, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "estimating pairwise priors" not in out
    assert resumed.state.step == 8
    assert [r["step"] for r in _records(workdir) if "loss" in r] == [3, 6, 8]
    # The same run without the interruption ends on the same parameters:
    # the batch and the augmentation draw of a step depend on seed and step alone.
    straight = ttrain.fit(longer, str(tmp_path / "straight"), eval_max_batches=1, device="cpu")
    for (n, p), (_, q) in zip(resumed.state.model.named_parameters(),
                              straight.state.model.named_parameters()):
        assert torch.equal(p, q), n


def test_resume_at_the_stage_boundary_still_applies_the_priors(tmp_path, capsys):
    cfg = _tiny(get_config, detector_steps=2, joint_steps=0, eval_every=2, log_every=2)
    ttrain.fit(cfg, str(tmp_path), eval_max_batches=1, device="cpu")
    capsys.readouterr()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, joint_steps=1))
    result = ttrain.fit(cfg, str(tmp_path), eval_max_batches=1, resume=True, device="cpu")
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "estimating pairwise priors" in out
    assert result.state.step == 3


def test_fit_without_an_mrf_ranks_every_eval(tmp_path):
    cfg = _tiny(get_config, detector_steps=2, eval_every=1, log_every=1).replace(mrf=None)
    result = ttrain.fit(cfg, str(tmp_path), eval_max_batches=1, device="cpu")
    assert result.state.step == 2 and result.metrics["eval_stage"] == "detector"
    assert Checkpointer(os.path.join(str(tmp_path), "checkpoints")).best_step() in (1, 2)


def test_fit_caches_a_host_split_on_the_device(tmp_path):
    make_fake_flic(str(tmp_path / "flic"), n_train=5, n_test=3)
    data = dict(source="flic", flic_dir=str(tmp_path / "flic"), train_size=5, test_size=3)
    streamed = ttrain.fit(_tiny(get_config, data=data, joint_steps=1), str(tmp_path / "a"), device="cpu")
    cached = ttrain.fit(_tiny(get_config, data={**data, "device_cache_gb": 1.0}, joint_steps=1),
                        str(tmp_path / "b"), device="cpu")
    for p, q in zip(streamed.state.model.parameters(), cached.state.model.parameters()):
        assert torch.equal(p, q)


def test_unported_options_raise(tmp_path):
    # --figures (tests/test_torch_visualize.py) and profile_steps
    # (tests/test_torch_metrics.py) are ported; meshes are not.
    for flags in (["--mesh-data", "2"], ["--mesh-model", "2"], ["--mesh-spatial"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.main(["--config", "tiny", "--workdir", str(tmp_path), "--device", "cpu", *flags])


def test_main_runs_resumes_and_needs_cuda_unless_asked_for_cpu(tmp_path, capsys, monkeypatch):
    workdir = str(tmp_path / "run")
    argv = ["--config", "tiny", "--workdir", workdir, "--detector-steps", "4", "--joint-steps", "4",
            "--eval-max-batches", "1", "--steps-per-dispatch", "5"]
    ttrain.main([*argv, "--device", "cpu"])
    assert "final:" in capsys.readouterr().out
    ckpt_dir = os.path.join(workdir, "checkpoints")
    assert os.path.exists(os.path.join(workdir, "metrics.jsonl"))
    assert os.path.exists(os.path.join(ckpt_dir, "run_config.json"))
    assert os.listdir(os.path.join(ckpt_dir, "latest")) == ["8"]
    assert os.listdir(os.path.join(ckpt_dir, "best")) == ["8"]
    ttrain.main([*argv[:7], "6", *argv[8:], "--device", "cpu", "--resume", "--learning-rate", "1e-4",
                 "--mrf-loss", "mse", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "resumed from step 8" in out and "[step 10]" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(argv)
