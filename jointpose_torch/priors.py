"""Empirical pairwise displacement priors (own copy of ``jointpose/priors.py``,
whose module imports the reference's JAX pipeline; arXiv:1406.2984 §3.2).

For every ordered joint pair (v, a), the histogram of displacements
(x_a - x_v, y_a - y_v) over the training set at heatmap resolution; the
normalized, smoothed histograms initialize the MRF kernels so the
spatial model starts as the empirical prior.

Kernel-tap convention (must match ``jointpose_torch.ops.mrf_xla``
correlation semantics): a displacement d = pos_a - pos_v in heatmap
pixels deposits mass at kernel index (center - d), so that
conv(kernel, p_v) peaks at pos_v + d.

This runs once at setup on a few thousand examples: numpy on the host,
whatever device the dataset's batches lie on.
"""

from __future__ import annotations

import numpy as np

from jointpose_torch.configs import Config
from jointpose_torch.data.pipeline import Dataset, batch_iterator


def _gaussian_blur2d(hist: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur of (wh, ww, ...) along the two leading axes."""
    if sigma <= 0:
        return hist
    radius = max(1, int(3 * sigma))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(xs**2) / (2 * sigma**2))
    g /= g.sum()

    def blur_axis(x: np.ndarray, axis: int) -> np.ndarray:
        x = np.moveaxis(x, axis, 0)
        padded = np.pad(x, [(radius, radius)] + [(0, 0)] * (x.ndim - 1))
        out = np.zeros_like(x)
        for i, w in enumerate(g):
            out += w * padded[i : i + x.shape[0]]
        return np.moveaxis(out, 0, axis)

    return blur_axis(blur_axis(hist, 0), 1)


def pairwise_displacement_histograms(
    joints_hm: np.ndarray,
    visible: np.ndarray,
    window: tuple[int, int],
    smooth_sigma: float = 1.0,
) -> np.ndarray:
    """Build normalized pairwise displacement priors.

    Args:
      joints_hm: (N, K, 2) joint coords in *heatmap* pixels, (x, y).
      visible: (N, K) mask; a pair contributes only if both ends visible.
      window: (wh, ww) odd kernel extents in heatmap pixels.
      smooth_sigma: Gaussian smoothing of the histogram, heatmap px.

    Returns:
      (wh, ww, K, K) float32 priors; priors[..., v, a] sums to 1.
    """
    joints_hm = np.asarray(joints_hm, np.float64)
    visible = np.asarray(visible, np.float64)
    n, k, _ = joints_hm.shape
    wh, ww = window
    assert wh % 2 == 1 and ww % 2 == 1, window
    cy, cx = wh // 2, ww // 2

    # d[n, v, a, :] = pos_a - pos_v  (x, y)
    d = joints_hm[:, None, :, :] - joints_hm[:, :, None, :]
    pair_vis = visible[:, :, None] * visible[:, None, :]  # (N, K, K)

    # Kernel index = center - displacement (rounded to nearest bin).
    iy = cy - np.rint(d[..., 1]).astype(np.int64)  # (N, K, K)
    ix = cx - np.rint(d[..., 0]).astype(np.int64)
    in_win = (iy >= 0) & (iy < wh) & (ix >= 0) & (ix < ww) & (pair_vis > 0)

    hist = np.zeros((wh, ww, k, k), np.float64)
    vv, aa = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    vv = np.broadcast_to(vv, (n, k, k))
    aa = np.broadcast_to(aa, (n, k, k))
    np.add.at(
        hist,
        (iy[in_win], ix[in_win], vv[in_win], aa[in_win]),
        1.0,
    )

    hist = _gaussian_blur2d(hist, smooth_sigma)
    sums = hist.sum(axis=(0, 1), keepdims=True)
    # Pairs with no observations fall back to uniform.
    uniform = 1.0 / (wh * ww)
    hist = np.where(sums > 0, hist / np.maximum(sums, 1e-12), uniform)
    return hist.astype(np.float32)


def estimate_priors(
    dataset: Dataset,
    config: Config,
    max_examples: int | None = None,
    smooth_sigma: float = 1.0,
) -> np.ndarray:
    """Estimate priors from a dataset split on the config's MRF grid.

    The histogram is binned at the MRF grid resolution: heatmap stride x
    the MRF's own stride (MRFConfig.stride, >1 for the coarse variant).
    """
    assert config.mrf is not None, "config has no MRF; priors are unused"
    stride = config.data.heatmap_stride * config.mrf.stride
    n = dataset.size if max_examples is None else min(dataset.size, max_examples)
    joints, visible = [], []
    batch = 256
    for idx in batch_iterator(dataset, min(batch, n), drop_remainder=False):
        got = dataset.get_batch(idx)
        joints.append(got["joints"].cpu().numpy())
        visible.append(got["visible"].cpu().numpy())
        if sum(j.shape[0] for j in joints) >= n:
            break
    joints_np = np.concatenate(joints)[:n] / stride
    visible_np = np.concatenate(visible)[:n]
    return pairwise_displacement_histograms(
        joints_np, visible_np, config.mrf.window, smooth_sigma
    )


def expected_displacement(priors: np.ndarray) -> np.ndarray:
    """Mean displacement (dx, dy) encoded by each prior map — for tests/viz.

    Inverts the tap convention: tap (iy, ix) encodes displacement
    (dy, dx) = (cy - iy, cx - ix).
    """
    wh, ww, k, _ = priors.shape
    cy, cx = wh // 2, ww // 2
    iy = np.arange(wh)[:, None, None, None]
    ix = np.arange(ww)[None, :, None, None]
    dy = (cy - iy) * priors
    dx = (cx - ix) * priors
    return np.stack(
        [dx.sum(axis=(0, 1)), dy.sum(axis=(0, 1))], axis=-1
    )  # (K, K, 2) (dx, dy)
