"""The port's two-pass shear warp (jointpose_torch.ops.warp) on the CPU:
its plain version against the reference's Pallas kernels in interpret
mode, in both orientations, plus the reference's own contract (exact
identity and integer shift, image content following the joints)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.configs import AugmentConfig as JaxAugmentConfig
from jointpose.data import augment as ja
from jointpose.ops import warp_pallas as jw
from jointpose_torch.configs import AugmentConfig
from jointpose_torch.data import augment as ta
from jointpose_torch.ops import warp as tw

# The reference's tolerance for its shear kernel against its oracle
# (tests/test_warp_pallas.py), on pixels in [0, 1].
WARP_ATOL = 2e-5
EXACT_ATOL = 1e-6


def _inverse(params, hw):
    a, b = ja._forward_affine(params, hw)
    a_inv = np.linalg.inv(np.asarray(a, np.float64)).astype(np.float32)
    b_inv = -np.einsum("bij,bj->bi", a_inv, np.asarray(b)).astype(np.float32)
    return a_inv, b_inv


def _draw(seed, batch, hw):
    p = ja.random_augment_params(jax.random.PRNGKey(seed), batch, JaxAugmentConfig(), hw)
    images = np.random.RandomState(seed).rand(batch, *hw, 3).astype(np.float32)
    return images, *_inverse(p, hw)


def test_pass_params_match_reference():
    _, a_inv, b_inv = _draw(0, 4, (24, 36))
    want = jw._pass_params(jnp.asarray(a_inv), jnp.asarray(b_inv))
    got = tw._pass_params(torch.from_numpy(a_inv), torch.from_numpy(b_inv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("entry", ["shear_warp", "shear_warp_rowmajor"])
def test_plain_warp_matches_reference_kernels(entry):
    images, a_inv, b_inv = _draw(7, 2, (24, 36))
    want = getattr(jw, entry)(jnp.asarray(images), jnp.asarray(a_inv), jnp.asarray(b_inv))
    before = getattr(tw, entry).launches
    got = getattr(tw, entry)(torch.from_numpy(images), torch.from_numpy(a_inv),
                             torch.from_numpy(b_inv))
    assert getattr(tw, entry).launches == before  # CPU tensors never launch
    assert got.shape == images.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=WARP_ATOL)


def test_identity_and_integer_shift_are_exact():
    images = torch.from_numpy(np.random.RandomState(1).rand(2, 24, 32, 3).astype(np.float32))
    a_inv, b_inv = _inverse(ja.identity_augment_params(2), (24, 32))
    out = tw.shear_warp(images, torch.from_numpy(a_inv), torch.from_numpy(b_inv))
    np.testing.assert_allclose(out.numpy(), images.numpy(), rtol=0, atol=EXACT_ATOL)
    z = jnp.zeros((2,), jnp.float32)
    shift = ja._fill_crop_identity(ja.AugmentParams(
        scale=jnp.ones((2,)), angle=z, tx=z + 3.0, ty=z - 2.0, flip=z))
    a_inv, b_inv = _inverse(shift, (24, 32))
    out = tw.shear_warp(images, torch.from_numpy(a_inv), torch.from_numpy(b_inv)).numpy()
    ref = np.zeros_like(out)  # dst = src + (3, -2): content moves right 3 and up 2
    ref[:, : 24 - 2, 3:, :] = images.numpy()[:, 2:, : 32 - 3, :]
    np.testing.assert_allclose(out, ref, rtol=0, atol=EXACT_ATOL)


@pytest.mark.parametrize("seed", [1, 5])
def test_content_follows_joints_under_full_draw(seed):
    """A bright dot at each joint, warped by the shear path, lands at the
    joint's transformed coordinate (within the integer argmax's 1.25 px)."""
    h, w = 48, 64
    rng = np.random.default_rng(seed)
    joints = torch.from_numpy(rng.uniform([10, 10], [w - 11, h - 11], (2, 9, 2)).astype(np.float32))
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    d2 = (gx[None, :, :, None] - joints[:, None, None, :, 0]) ** 2 + (
        gy[None, :, :, None] - joints[:, None, None, :, 1]) ** 2
    images = torch.exp(-d2 / 4.0)  # (2, H, W, 9): channel k holds joint k's dot
    cfg = AugmentConfig(rotate_deg=25.0, crop_frac_range=(0.8, 1.0))
    p = ta.random_augment_params(torch.Generator().manual_seed(seed), 2, cfg, (h, w))
    warped, _, _ = ta.augment_batch(images, joints, torch.ones(2, 9), p, warp_impl="shear")
    a, b_off = ta._forward_affine(p, (h, w))
    expect = torch.einsum("bij,bkj->bki", a, joints) + b_off[:, None, :]
    checked = 0
    for b in range(2):
        for k in range(9):
            ex, ey = float(expect[b, k, 0]), float(expect[b, k, 1])
            if not (3 <= ex <= w - 4 and 3 <= ey <= h - 4):
                continue  # dot clipped at the frame edge
            py, px = divmod(int(warped[b, :, :, k].argmax()), w)
            assert abs(px - ex) < 1.25 and abs(py - ey) < 1.25, (b, k, px, py, ex, ey)
            checked += 1
    assert checked >= 9


def test_strip_width_is_a_rule_on_shapes():
    # The training shape: 8 columns of 240 x 3 fp32 (23 KB, eight blocks an SM).
    assert tw.strip_width(240, 3) == 8
    assert tw.strip_width(48, 3) == 32
    assert tw.strip_width(240, 9) == 2
    # Too tall for an eighth of the shared memory: one column a block.
    assert tw.strip_width(5000, 3) == 1
    assert tw.strip_width(19370, 3) == 1
    # Too tall for any block: raises, naming the limit.
    with pytest.raises(ValueError, match="at most 19370 rows"):
        tw.strip_width(19371, 3)


def _extreme_affines(h, w):
    """(a_inv, b_inv) of rotations up to ±60°, scales 0.5 and 2, flips and
    shifts about the centre, and one map whose a11 is small but nonzero."""
    maps = []
    for angle, scale, flip, shift in ((60.0, 0.5, 1.0, (3.0, -2.0)), (-60.0, 2.0, -1.0, (0.0, 5.0)),
                                      (45.0, 2.0, 1.0, (-7.0, 1.0)), (-30.0, 0.5, -1.0, (2.5, 0.5))):
        t = np.deg2rad(angle)
        rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        maps.append(rot @ np.diag([flip, 1.0]) / scale)
    maps.append(np.array([[0.3, 1.1], [-0.9, 1e-3]]))
    a_inv = np.stack(maps).astype(np.float32)
    centre = np.array([(w - 1) / 2, (h - 1) / 2])
    shifts = np.array([[3.0, -2.0], [0.0, 5.0], [-7.0, 1.0], [2.5, 0.5], [1.0, -1.0]])
    b_inv = (centre - np.einsum("bij,j->bi", a_inv, centre) + shifts).astype(np.float32)
    return torch.from_numpy(a_inv), torch.from_numpy(b_inv)


@pytest.mark.parametrize("shape", [(17, 29, 3), (24, 36, 2)])
def test_strip_emulation_matches_reference_on_extreme_affines(shape):
    """The fused kernel's arithmetic, strip by strip, against the dense-hat
    oracle on extreme maps; any strip width gives the same bits, because a
    strip's columns depend on nothing outside it."""
    a_inv, b_inv = _extreme_affines(*shape[:2])
    images = torch.from_numpy(np.random.RandomState(11).rand(len(a_inv), *shape).astype(np.float32))
    want = tw.shear_warp_reference(images, a_inv, b_inv)
    got = tw.shear_warp_strips(images, a_inv, b_inv)
    assert (got - want).abs().max().item() <= WARP_ATOL
    # The rotations keep some of the image (the small-a11 map may keep none).
    assert got[:4].abs().sum(dim=(1, 2, 3)).min() > 0
    for width in (1, 5, shape[1]):
        assert torch.equal(tw.shear_warp_strips(images, a_inv, b_inv, tw=width), got)


def test_strip_emulation_matches_reference_on_a_full_draw():
    images, a_inv, b_inv = map(torch.from_numpy, _draw(3, 3, (24, 36)))
    got = tw.shear_warp_strips(images, a_inv, b_inv)
    assert (got - tw.shear_warp_reference(images, a_inv, b_inv)).abs().max().item() <= WARP_ATOL
