"""Target rendering and the heatmap losses of the port
(jointpose_torch.data.targets, jointpose_torch.losses) against the JAX
reference, in fp32 on the CPU, with the same numpy inputs on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose import losses as jl
from jointpose.data import targets as jt
from jointpose_torch import losses as tl
from jointpose_torch.data import targets as tt

# Elementwise fp32 maths and fp32 sums of a few thousand terms in another
# order: 1e-6 relative.
RTOL = 1e-6
# Loss gradients, max|Δ| / max|ref|: the CE gradient is softmax − target,
# whose fp32 log-sum-exp differs by an ulp of its largest term.
GRAD_RTOL = 1e-5
HM = (12, 16)
K = 9


def _joints(seed=0, batch=3):
    rs = np.random.RandomState(seed)
    joints = rs.uniform([-2.0, -2.0], [HM[1] + 1.0, HM[0] + 1.0], (batch, K, 2)).astype(np.float32)
    visible = (rs.rand(batch, K) > 0.3).astype(np.float32)
    visible[0] = 0.0  # one image with no visible joint: the denominators' floor
    return joints, visible


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=rtol)


def test_image_to_heatmap_coords_matches_reference():
    pts = np.random.RandomState(1).uniform(0, 240, (4, K, 2)).astype(np.float32)
    for stride in (2, 4):
        _close(tt.image_to_heatmap_coords(torch.from_numpy(pts), stride),
               jt.image_to_heatmap_coords(jnp.asarray(pts), stride))


@pytest.mark.parametrize("normalize", [False, True])
def test_render_gaussian_heatmaps_matches_reference(normalize):
    joints, visible = _joints()
    want = jt.render_gaussian_heatmaps(jnp.asarray(joints), jnp.asarray(visible), HM, 1.5,
                                       normalize=normalize)
    got = tt.render_gaussian_heatmaps(torch.from_numpy(joints), torch.from_numpy(visible), HM, 1.5,
                                      normalize=normalize)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want)


def _loss_inputs(seed):
    joints, visible = _joints(seed)
    rs = np.random.RandomState(seed + 10)
    pred = rs.randn(3, *HM, K).astype(np.float32)
    targets = {
        "peak1": jt.render_gaussian_heatmaps(jnp.asarray(joints), jnp.asarray(visible), HM, 1.5),
        "dist": jt.render_gaussian_heatmaps(jnp.asarray(joints), jnp.asarray(visible), HM, 1.5,
                                            normalize=True),
    }
    targets = {k: np.array(v) for k, v in targets.items()}
    return pred, targets, visible


@pytest.mark.parametrize("kind", ["mse", "ce"])
@pytest.mark.parametrize("head", ["detector", "mrf"])
def test_losses_and_gradients_match_reference(kind, head):
    pred, targets, visible = _loss_inputs(seed=2 if head == "mrf" else 3)
    if head == "mrf":
        pred = pred * 4.0 - 30.0  # log-space scores, far from 0
    jfn, tfn = (jl.heatmap_loss, tl.heatmap_loss) if head == "detector" else (
        jl.mrf_heatmap_loss, tl.mrf_heatmap_loss)
    jt_ = {k: jnp.asarray(v) for k, v in targets.items()}
    want, want_grad = jax.value_and_grad(
        lambda p: jfn(kind, p, jt_, jnp.asarray(visible)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tfn(kind, p, {k: torch.from_numpy(v) for k, v in targets.items()},
              torch.from_numpy(visible))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want)
    g = np.asarray(want_grad)
    np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=GRAD_RTOL * np.abs(g).max())


def test_loss_kinds_are_checked():
    pred, targets, visible = _loss_inputs(seed=4)
    t = {k: torch.from_numpy(v) for k, v in targets.items()}
    for fn in (tl.heatmap_loss, tl.mrf_heatmap_loss):
        with pytest.raises(ValueError, match="unknown loss kind"):
            fn("l1", torch.from_numpy(pred), t, torch.from_numpy(visible))
