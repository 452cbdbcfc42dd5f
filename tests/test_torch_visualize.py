"""The port's figures (jointpose_torch.visualize) against the reference's
(jointpose.visualize) on the same arrays, and the entry points that write
them: ``predict.main --figures``, ``train.main --figures`` and
``evaluate.main --curves``.  The functions are the reference's code with
the port's skeleton, so the same arrays give the same PNG bytes.  Each
test skips when matplotlib is absent (the card's machine has none)."""

import os

import numpy as np
import pytest

from jointpose import visualize as jvis
from jointpose_torch import evaluate, predict, skeleton, train
from jointpose_torch import visualize as tvis

K = skeleton.NUM_JOINTS


@pytest.fixture
def mpl():
    return pytest.importorskip("matplotlib")


def _same_png(tmp_path, name, call):
    paths = [call(mod, str(tmp_path / f"{tag}_{name}.png"))
             for tag, mod in (("ref", jvis), ("port", tvis))]
    data = [open(p, "rb").read() for p in paths]
    assert data[0][:8] == b"\x89PNG\r\n\x1a\n" and len(data[0]) > 1000
    assert data[0] == data[1]


def test_heatmap_overlays_equal_reference(tmp_path, mpl):
    rs = np.random.RandomState(0)
    images = rs.rand(2, 48, 64, 3).astype(np.float32)
    heatmaps = rs.rand(2, 12, 16, K).astype(np.float32)
    joints = rs.uniform(0, 48, (2, K, 2)).astype(np.float32)
    _same_png(tmp_path, "hm", lambda m, p: m.save_heatmap_overlays(images, heatmaps, p, joints))


def test_prior_grid_equals_reference(tmp_path, mpl):
    priors = np.random.RandomState(1).rand(11, 15, K, K).astype(np.float32)
    _same_png(tmp_path, "priors", lambda m, p: m.save_prior_grid(priors, p))


def test_pdj_curves_equal_reference(tmp_path, mpl):
    thresholds = np.linspace(0, 0.2, 21)
    curves = np.clip(thresholds[:, None] * 5 + np.random.RandomState(2).rand(21, K) * 0.1, 0, 1)
    metrics = {"thresholds": thresholds.tolist(), "pdj_curves": curves.tolist()}
    _same_png(tmp_path, "pdj", lambda m, p: m.save_pdj_curves(metrics, p))


def test_entry_points_write_their_figures(tmp_path, mpl, capsys):
    workdir = str(tmp_path / "run")
    train.main(["--config", "tiny", "--workdir", workdir, "--device", "cpu", "--detector-steps",
                "1", "--joint-steps", "1", "--eval-max-batches", "1", "--figures"])
    assert sorted(os.listdir(os.path.join(workdir, "figures"))) == [
        "heatmaps.png", "pdj_curves.png", "priors.png"]
    ckpt = os.path.join(workdir, "checkpoints")
    predict.main(["--config", "tiny", "--checkpoint", ckpt, "--workdir", str(tmp_path / "pred"),
                  "--num", "3", "--batch-size", "2", "--figures", "--device", "cpu"])
    assert os.path.getsize(tmp_path / "pred" / "predictions.png") > 1000
    curves = str(tmp_path / "ev" / "pdj.png")
    evaluate.main(["--config", "tiny", "--checkpoint", ckpt, "--max-batches", "1", "--curves",
                   curves, "--device", "cpu"])
    assert os.path.getsize(curves) > 1000
    assert f"curves -> {curves}" in capsys.readouterr().out
