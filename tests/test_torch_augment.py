"""The port's augmentation (jointpose_torch.data.augment) against the JAX
reference on the CPU, fed the same AugmentParams: the two frameworks'
random streams differ, so the draw itself is checked for its ranges and
its repeatability instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.configs import AugmentConfig as JaxAugmentConfig
from jointpose.data import augment as ja
from jointpose_torch.configs import AugmentConfig
from jointpose_torch.data import augment as ta

HW = (24, 36)
K = 9
# Coordinates: elementwise fp32 maths, 1e-5 of the image size.
COORD_ATOL = 1e-5 * max(HW)
# Warped pixels in [0, 1]: the reference's warp tolerance for the gather
# path (an fp32 bilinear blend of four taps)...
GATHER_ATOL = 1e-5
# ...and for the shear warp against its oracle (tests/test_warp_pallas.py).
SHEAR_ATOL = 2e-5


def _params(seed, batch=3, crop=True):
    rs = np.random.RandomState(seed)
    p = {
        "scale": rs.uniform(0.7, 1.3, batch), "angle": rs.uniform(-0.4, 0.4, batch),
        "tx": rs.uniform(-3, 3, batch), "ty": rs.uniform(-2, 2, batch),
        "flip": (rs.rand(batch) < 0.5).astype(np.float64),
    }
    if crop:
        frac = rs.uniform(0.8, 1.0, batch)
        p.update(crop_frac=frac, crop_x0=rs.rand(batch) * (1 - frac) * (HW[1] - 1),
                 crop_y0=rs.rand(batch) * (1 - frac) * (HW[0] - 1))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return (ja.AugmentParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            ta.AugmentParams(**{k: torch.from_numpy(v) for k, v in p.items()}))


def _batch(seed, batch=3):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (batch, *HW, 3)).astype(np.uint8)
    joints = rs.uniform([0, 0], [HW[1] - 1, HW[0] - 1], (batch, K, 2)).astype(np.float32)
    visible = (rs.rand(batch, K) > 0.2).astype(np.float32)
    return images, joints, visible


@pytest.mark.parametrize("crop", [True, False])
def test_forward_affine_matches_reference(crop):
    jp, tp = _params(0, crop=crop)
    for got, want in zip(ta._forward_affine(tp, HW), ja._forward_affine(jp, HW)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=COORD_ATOL)


def test_identity_params_match_reference():
    tp, jp = ta.identity_augment_params(4), ja.identity_augment_params(4)
    for name in ja.AugmentParams._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))


def test_transform_joints_matches_reference():
    jp, tp = _params(1, batch=4)
    _, joints, visible = _batch(1, batch=4)
    joints[0, 0] = (-5.0, 3.0)  # starts and stays out of frame
    want_j, want_v = ja.transform_joints(jnp.asarray(joints), jnp.asarray(visible), jp, HW)
    got_j, got_v = ta.transform_joints(torch.from_numpy(joints), torch.from_numpy(visible), tp, HW)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=0, atol=COORD_ATOL)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.numpy().sum() < visible.sum()  # some joints left the frame or were hidden


def test_gather_warp_matches_map_coordinates():
    jp, _ = _params(2)
    rs = np.random.RandomState(2)
    images = rs.rand(3, *HW, 3).astype(np.float32)
    a, b = ja._forward_affine(jp, HW)
    a_inv = np.linalg.inv(np.asarray(a, np.float64)).astype(np.float32)
    b_inv = -np.einsum("bij,bj->bi", a_inv, np.asarray(b)).astype(np.float32)
    want = ja._warp_images(jnp.asarray(images), jnp.asarray(a_inv), jnp.asarray(b_inv))
    got = ta._warp_images(torch.from_numpy(images), torch.from_numpy(a_inv), torch.from_numpy(b_inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GATHER_ATOL)


@pytest.mark.parametrize("warp_impl,atol", [("gather", GATHER_ATOL), ("shear", SHEAR_ATOL)])
def test_augment_batch_matches_reference(warp_impl, atol):
    jp, tp = _params(3)
    images, joints, visible = _batch(3)
    want = ja.augment_batch(jnp.asarray(images), jnp.asarray(joints), jnp.asarray(visible), jp,
                            warp_impl=warp_impl)
    got = ta.augment_batch(torch.from_numpy(images), torch.from_numpy(joints),
                           torch.from_numpy(visible), tp, warp_impl=warp_impl)
    assert got[0].dtype == torch.float32 and got[0].shape == images.shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=atol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=COORD_ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_random_augment_params_in_range_and_repeatable():
    cfg = AugmentConfig(crop_frac_range=(0.8, 1.0))
    assert cfg == AugmentConfig(**vars(JaxAugmentConfig(crop_frac_range=(0.8, 1.0))))
    h, w = HW
    draws = [ta.random_augment_params(torch.Generator().manual_seed(s), 4096, cfg, HW)
             for s in (5, 5, 6)]
    for name in ta.AugmentParams._fields:
        assert torch.equal(getattr(draws[0], name), getattr(draws[1], name)), name
        assert not torch.equal(getattr(draws[0], name), getattr(draws[2], name)), name
    p = draws[0]
    max_rad = np.deg2rad(cfg.rotate_deg)
    assert all(t.dtype == torch.float32 and t.shape == (4096,) for t in p)
    assert cfg.scale_range[0] <= p.scale.min() and p.scale.max() <= cfg.scale_range[1]
    assert -max_rad <= p.angle.min() and p.angle.max() <= max_rad
    assert p.tx.abs().max() <= cfg.translate_frac * w and p.ty.abs().max() <= cfg.translate_frac * h
    assert set(p.flip.unique().tolist()) == {0.0, 1.0}
    assert abs(p.flip.mean().item() - cfg.flip_prob) < 0.05
    assert cfg.crop_frac_range[0] <= p.crop_frac.min() and p.crop_frac.max() <= cfg.crop_frac_range[1]
    assert (p.crop_x0 >= 0).all() and (p.crop_x0 <= (1 - p.crop_frac) * (w - 1) + 1e-4).all()
    assert (p.crop_y0 >= 0).all() and (p.crop_y0 <= (1 - p.crop_frac) * (h - 1) + 1e-4).all()


def test_unknown_warp_impl_raises():
    _, tp = _params(4)
    images, joints, visible = _batch(4)
    with pytest.raises(ValueError, match="warp_impl"):
        ta.augment_batch(torch.from_numpy(images), torch.from_numpy(joints),
                         torch.from_numpy(visible), tp, warp_impl="pallas")
