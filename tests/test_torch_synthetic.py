"""The port's synthetic source (jointpose_torch.data.synthetic) against the
JAX reference, on the CPU.

``jax.random`` streams cannot be reproduced in PyTorch, so the arithmetic
is compared with the draws shared: the tests repeat the reference's own
key splits and draws and feed them to ``pose_from_draws`` and
``render_from_draws``.  The port's own generator is checked for what the
pipeline needs of it: example ``i`` is a pure function of (seed, i).

Tolerances: joints 1e-3 px (fp32 sin/cos and sums at coordinates up to
360 px, ulp 3e-5); images 1e-5 absolute on [0, 1] (fp32 exp and a
ten-term sum per pixel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.data import synthetic as jsyn
from jointpose_torch import get_config
from jointpose_torch.data import synthetic as tsyn
from jointpose_torch.data.pipeline import make_dataset

JOINT_ATOL = 1e-3
IMAGE_ATOL = 1e-5
SIZES = [(48, 64), (60, 90), (240, 360)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _pose_draws(rng, image_hw):
    """The draws of jointpose/data/synthetic.py:sample_pose, in its order."""
    h, w = float(image_hw[0]), float(image_hw[1])
    ks = jax.random.split(rng, 8)
    return dict(
        s=jax.random.uniform(ks[0], (), minval=0.07, maxval=0.13) * w,
        cx=jax.random.uniform(ks[1], (), minval=0.3, maxval=0.7) * w,
        cy=jax.random.uniform(ks[2], (), minval=0.3, maxval=0.55) * h,
        lean=jax.random.uniform(ks[3], (), minval=-0.3, maxval=0.3),
        ua=jax.random.uniform(ks[4], (2,), minval=-2.2, maxval=2.2),
        fa=jax.random.uniform(ks[5], (2,), minval=-2.4, maxval=2.4),
    )


@pytest.mark.parametrize("image_hw", SIZES)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pose_from_draws_matches_sample_pose(seed, image_hw):
    rng = jax.random.PRNGKey(seed)
    want, want_vis = jsyn.sample_pose(rng, image_hw)
    draws = {k: _t(v) for k, v in _pose_draws(rng, image_hw).items()}
    got, vis = tsyn.pose_from_draws(**draws, image_hw=image_hw)
    assert got.shape == (9, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=JOINT_ATOL)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(want_vis))


def test_pose_from_draws_is_batched():
    hw = (48, 64)
    rngs = [jax.random.PRNGKey(s) for s in range(5)]
    draws = [_pose_draws(r, hw) for r in rngs]
    stacked = {k: _t(np.stack([np.asarray(d[k]) for d in draws])) for k in draws[0]}
    got, vis = tsyn.pose_from_draws(**stacked, image_hw=hw)
    want = np.stack([np.asarray(jsyn.sample_pose(r, hw)[0]) for r in rngs])
    assert got.shape == (5, 9, 2) and vis.shape == (5, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JOINT_ATOL)


@pytest.mark.parametrize("image_hw", SIZES[:2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_from_draws_matches_render_person(seed, image_hw):
    h, w = image_hw
    k_pose, k_render = jax.random.split(jax.random.PRNGKey(seed))
    joints, _ = jsyn.sample_pose(k_pose, image_hw)
    want = jsyn.render_person(k_render, joints, image_hw)
    # The draws of render_person: c and base come from the same key there.
    k_bg, k_noise = jax.random.split(k_render)
    c = jax.random.uniform(k_bg, (3, 3), minval=-0.15, maxval=0.15)
    base = jax.random.uniform(k_bg, (3,), minval=0.25, maxval=0.75)
    noise = jax.random.normal(k_noise, (h, w, 3))
    got = tsyn.render_from_draws(_t(joints)[None], _t(c)[None], _t(base)[None], _t(noise)[None],
                                 image_hw)
    assert got.shape == (1, h, w, 3) and got.dtype == torch.float32
    assert np.abs(got[0].numpy() - np.asarray(want)).max() <= IMAGE_ATOL


def test_example_is_a_pure_function_of_seed_and_index():
    cfg = get_config("tiny").data
    train, test = make_dataset(cfg, "cpu")
    a = train.get_batch(np.arange(6, dtype=np.int32))
    b = train.get_batch(np.array([5, 2, 11, 0], dtype=np.int32))
    c = train.get_batch(torch.tensor([2]))
    for key in ("image", "joints", "visible"):
        assert torch.equal(a[key][5], b[key][0]) and torch.equal(a[key][2], b[key][1])
        assert torch.equal(a[key][0], b[key][3]) and torch.equal(a[key][2], c[key][0])
    assert not torch.equal(a["image"][0], a["image"][1])
    # The test split is the train generator offset by train_size.
    t = test.get_batch([0, 3])
    u = train.get_batch([cfg.train_size, cfg.train_size + 3])
    assert all(torch.equal(t[k], u[k]) for k in t)
    # Another seed, another example.
    other, _ = make_dataset(dataclasses.replace(cfg, seed=cfg.seed + 1), "cpu")
    assert not torch.equal(other.get_batch([0])["image"], a["image"][:1])


def test_batch_has_the_reference_layout():
    cfg = get_config("tiny").data
    train, _ = make_dataset(cfg, "cpu")
    got = train.get_batch(np.arange(3))
    want = jsyn.make_synthetic_flic(cfg)(jnp.arange(3))
    for key in ("image", "joints", "visible"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert got[key].dtype == torch.float32
    h, w = cfg.image_hw
    assert 0.0 <= got["image"].min() and got["image"].max() <= 1.0
    assert (got["joints"][..., 0] >= 4).all() and (got["joints"][..., 0] <= w - 5).all()
    assert (got["joints"][..., 1] >= 4).all() and (got["joints"][..., 1] <= h - 5).all()
    assert (got["visible"] == 1).all()


def test_generator_draws():
    idx = torch.arange(200)
    u = tsyn.uniform(7, idx, 0, 500)
    assert u.shape == (200, 500) and u.dtype == torch.float32
    assert (u >= 0).all() and (u < 1).all()
    # 24-bit uniforms: exact multiples of 2^-24, so equal on any device.
    assert torch.equal(u * 2.0**24, (u * 2.0**24).round())
    assert abs(u.mean().item() - 0.5) < 5e-3 and abs(u.var().item() * 12 - 1) < 2e-2
    # Streams, seeds and examples are independent draws; elements do not
    # depend on how many are asked for.
    assert torch.equal(tsyn.uniform(7, idx, 0, 8), u[:, :8])
    assert not torch.equal(tsyn.uniform(7, idx, 1, 500), u)
    assert not torch.equal(tsyn.uniform(8, idx, 0, 500), u)
    assert abs(np.corrcoef(u[0].numpy(), u[1].numpy())[0, 1]) < 0.15
    n = tsyn.normal(7, idx, 2, 2000)
    assert torch.isfinite(n).all()
    assert abs(n.mean().item()) < 1e-2 and abs(n.std().item() - 1) < 1e-2
    assert abs((n.abs() > 1.96).float().mean().item() - 0.05) < 5e-3
