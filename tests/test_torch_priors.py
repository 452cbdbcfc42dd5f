"""The port's pairwise priors (jointpose_torch.priors, numpy) against the
reference's on seeded joints.  Both are float64 numpy rounded to float32 at
the end, so they agree to 1e-7 (one float32 step of values below 1)."""

import dataclasses

import numpy as np
import pytest

from jointpose import priors as jpri
from jointpose.configs import get_config as jax_get_config
from jointpose.data import pipeline as jpipe
from jointpose_torch import get_config
from jointpose_torch import priors as tpri
from jointpose_torch.data import pipeline as tpipe

ATOL = 1e-7
K = 9


def _joints(seed, n=200, hw=(60, 90)):
    rs = np.random.RandomState(seed)
    centre = rs.uniform([20, 15], [hw[1] - 20, hw[0] - 15], (n, 1, 2))
    joints = centre + rs.randn(n, K, 2) * [6.0, 4.0]
    visible = (rs.rand(n, K) > 0.15).astype(np.float32)
    return joints.astype(np.float32), visible


@pytest.mark.parametrize("window", [(11, 15), (5, 7), (21, 31)])
@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.5])
def test_histograms_match_reference(window, sigma):
    joints, visible = _joints(0)
    want = jpri.pairwise_displacement_histograms(joints, visible, window, sigma)
    got = tpri.pairwise_displacement_histograms(joints, visible, window, sigma)
    assert got.shape == (*window, K, K) and got.dtype == np.float32
    assert np.abs(got - want).max() <= ATOL
    np.testing.assert_allclose(got.sum(axis=(0, 1)), 1.0, atol=1e-5)


def test_unobserved_pairs_fall_back_to_uniform():
    joints, visible = _joints(1, n=20)
    visible[:, 3] = 0.0
    got = tpri.pairwise_displacement_histograms(joints, visible, (5, 7))
    np.testing.assert_allclose(got[:, :, 3, :], 1.0 / 35)
    np.testing.assert_allclose(got[:, :, :, 3], 1.0 / 35)


def test_even_window_is_refused():
    joints, visible = _joints(2, n=4)
    with pytest.raises(AssertionError):
        tpri.pairwise_displacement_histograms(joints, visible, (4, 7))


@pytest.mark.parametrize("sigma", [0.5, 1.0, 3.0])
def test_gaussian_blur_matches_reference(sigma):
    hist = np.random.RandomState(3).rand(9, 13, 4, 4)
    np.testing.assert_array_equal(tpri._gaussian_blur2d(hist, sigma), jpri._gaussian_blur2d(hist, sigma))
    assert tpri._gaussian_blur2d(hist, 0.0) is hist


def test_expected_displacement_matches_reference_and_tap_convention():
    joints, visible = _joints(4)
    priors = tpri.pairwise_displacement_histograms(joints, visible, (21, 31), 1.0)
    np.testing.assert_array_equal(tpri.expected_displacement(priors), jpri.expected_displacement(priors))
    # A fixed displacement d = pos_a - pos_v comes back as the mean.
    fixed = np.zeros((50, K, 2), np.float32) + [40.0, 30.0]
    fixed[:, 1] += [3.0, -2.0]
    p = tpri.pairwise_displacement_histograms(fixed, np.ones((50, K), np.float32), (11, 15), 0.0)
    np.testing.assert_allclose(tpri.expected_displacement(p)[0, 1], [3.0, -2.0], atol=1e-6)
    np.testing.assert_allclose(tpri.expected_displacement(p)[1, 0], [-3.0, 2.0], atol=1e-6)


@pytest.mark.parametrize("max_examples", [None, 7, 300])
@pytest.mark.parametrize("mrf_stride", [1, 2])
def test_estimate_priors_matches_reference(max_examples, mrf_stride):
    def cfg(get):
        c = get("tiny")
        return c.replace(mrf=dataclasses.replace(c.mrf, stride=mrf_stride))

    joints, visible = _joints(5, n=40, hw=(48, 64))
    arrays = {"image": np.zeros((40, 4, 4, 3), np.uint8), "joints": joints, "visible": visible}
    want = jpri.estimate_priors(jpipe.from_host_arrays(arrays), cfg(jax_get_config), max_examples)
    got = tpri.estimate_priors(tpipe.from_host_arrays(arrays), cfg(get_config), max_examples)
    assert got.shape == (*cfg(get_config).mrf.window, K, K)
    assert np.abs(got - want).max() <= ATOL


def test_estimate_priors_reads_the_synthetic_source():
    cfg = get_config("tiny")
    train, _ = tpipe.make_dataset(cfg.data, "cpu")
    got = tpri.estimate_priors(train, cfg, max_examples=16)
    assert got.shape == (*cfg.mrf.window, K, K) and np.isfinite(got).all()
    # Shoulders: the right one lies to the right of the left one on average.
    dx = tpri.expected_displacement(got)[1, 2, 0]
    assert dx > 0
