"""Parity of the port's heatmap maths and decode (jointpose_torch.ops.heatmaps,
jointpose_torch.data.targets) against the JAX reference: argmax ties,
peaks on every border and corner, and the refined 3×3 centroid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.data import targets as jt
from jointpose.ops import heatmaps as jh
from jointpose_torch.data import targets as tt
from jointpose_torch.ops import heatmaps as th

# Coordinates: the same fp32 centroid arithmetic; 1e-3 px is far below
# any decode step (a heatmap pixel is `stride` image pixels).
COORD_ATOL = 1e-3
# Softmax in fp32 over a few hundred cells.
SOFTMAX_ATOL = 1e-6

HM, WM, K = 10, 14, 9


def _heatmaps(seed: int) -> np.ndarray:
    """Random heatmaps whose channels peak on borders, corners, ties."""
    rs = np.random.RandomState(seed)
    hm = rs.rand(3, HM, WM, K).astype(np.float32)
    peaks = [(0, 0), (0, WM - 1), (HM - 1, 0), (HM - 1, WM - 1), (0, 5), (4, 0),
             (HM - 1, 7), (6, WM - 1), (5, 6)]
    for b in range(3):
        for k, (y, x) in enumerate(peaks):
            hm[b, y, x, k] = 2.0 + b
    hm[1, 2, 3, 8] = hm[1, 7, 9, 8] = 9.0  # tie: the first in row-major order wins
    hm[2, :, :, 4] = 0.5  # a flat channel: every cell ties
    return hm


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_heatmap_to_coords_matches_reference(refine, stride, seed):
    hm = _heatmaps(seed)
    want = np.asarray(jt.heatmap_to_coords(jnp.asarray(hm), stride, refine=refine))
    got = tt.heatmap_to_coords(torch.from_numpy(hm), stride, refine=refine).numpy()
    assert got.shape == want.shape == (3, K, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=COORD_ATOL)


def test_heatmap_to_image_coords_matches_reference():
    c = np.random.RandomState(2).rand(4, K, 2).astype(np.float32) * 20
    np.testing.assert_allclose(
        tt.heatmap_to_image_coords(torch.from_numpy(c), 4).numpy(),
        np.asarray(jt.heatmap_to_image_coords(jnp.asarray(c), 4)),
        rtol=0, atol=COORD_ATOL,
    )


def test_softmax_and_decode_probs_match_reference():
    logits = np.random.RandomState(3).randn(2, HM, WM, K).astype(np.float32) * 4
    out_j = {"detector_logits": jnp.asarray(logits), "mrf_log_heatmaps": jnp.asarray(logits[::-1])}
    out_t = {"detector_logits": torch.from_numpy(logits),
             "mrf_log_heatmaps": torch.from_numpy(logits[::-1].copy())}
    np.testing.assert_allclose(
        th.spatial_log_softmax(torch.from_numpy(logits)).numpy(),
        np.asarray(jh.spatial_log_softmax(jnp.asarray(logits))), rtol=0, atol=1e-5)
    probs_j = jh.model_probs(out_j)
    probs_t = th.model_probs(out_t)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j), rtol=0, atol=SOFTMAX_ATOL)
    np.testing.assert_allclose(
        th.model_probs({"detector_logits": torch.from_numpy(logits)}).numpy(),
        np.asarray(jh.model_probs({"detector_logits": jnp.asarray(logits)})),
        rtol=0, atol=SOFTMAX_ATOL)
    np.testing.assert_allclose(
        th.decode_probs(probs_t, 4, refine=True).numpy(),
        np.asarray(jh.decode_probs(probs_j, 4, refine=True)), rtol=0, atol=COORD_ATOL)
