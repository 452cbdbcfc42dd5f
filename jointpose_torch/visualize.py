"""Figures (counterpart of ``jointpose/visualize.py``): heatmap overlays,
the pairwise priors and PDJ curves, as PNGs (headless Agg backend).

Host-only numpy and matplotlib; matplotlib is imported at the first call,
so the package imports without it.  Callers hand numpy arrays
(``tensor.cpu().numpy()``).
"""

from __future__ import annotations

import os

import numpy as np

from jointpose_torch import skeleton


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_heatmap_overlays(
    images: np.ndarray,
    heatmaps: np.ndarray,
    out_path: str,
    joints_xy: np.ndarray | None = None,
    max_images: int = 4,
) -> str:
    """Grid of images with per-joint heatmap overlays.

    Args:
      images: (B, H, W, 3) in [0, 1], or uint8 RGB.
      heatmaps: (B, Hm, Wm, K).
      joints_xy: optional (B, K, 2) joints to mark (image pixels).
    """
    plt = _plt()
    n = min(max_images, images.shape[0])
    k = heatmaps.shape[-1]
    fig, axes = plt.subplots(n, 2, figsize=(8, 3 * n), squeeze=False)
    h, w = images.shape[1:3]
    for i in range(n):
        axes[i][0].imshow(np.asarray(images[i]))
        axes[i][0].set_title("input")
        hm = np.asarray(heatmaps[i])
        combined = hm.max(axis=-1)
        axes[i][1].imshow(np.asarray(images[i]), extent=(0, w, h, 0))
        axes[i][1].imshow(
            combined, alpha=0.6, cmap="inferno", extent=(0, w, h, 0)
        )
        axes[i][1].set_title(f"max over {k} joint heatmaps")
        if joints_xy is not None:
            axes[i][1].scatter(
                np.asarray(joints_xy[i][:, 0]),
                np.asarray(joints_xy[i][:, 1]),
                s=12, c="cyan", marker="x",
            )
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def save_prior_grid(priors: np.ndarray, out_path: str) -> str:
    """K x K grid of pairwise displacement priors (reference README figure)."""
    plt = _plt()
    k = priors.shape[-1]
    fig, axes = plt.subplots(k, k, figsize=(1.4 * k, 1.4 * k))
    for v in range(k):
        for a in range(k):
            ax = axes[v][a]
            ax.imshow(np.asarray(priors[:, :, v, a]), cmap="viridis")
            ax.set_xticks([])
            ax.set_yticks([])
            if v == 0:
                ax.set_title(skeleton.JOINTS[a], fontsize=7)
            if a == 0:
                ax.set_ylabel(skeleton.JOINTS[v], fontsize=7)
    fig.suptitle("pairwise displacement priors  p(a at offset | v)", fontsize=10)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def save_pdj_curves(eval_metrics: dict, out_path: str) -> str:
    """PDJ-vs-threshold curves per joint (reference README figure)."""
    plt = _plt()
    thresholds = np.asarray(eval_metrics["thresholds"])
    curves = np.asarray(eval_metrics["pdj_curves"])  # (T, K)
    fig, ax = plt.subplots(figsize=(6, 4))
    for j, name in enumerate(skeleton.JOINTS):
        style = "-" if name in skeleton.HEADLINE_JOINTS else "--"
        ax.plot(thresholds, curves[:, j], style, label=name, linewidth=1.2)
    ax.axvline(0.05, color="gray", linewidth=0.6)
    ax.set_xlabel("threshold (fraction of torso diameter)")
    ax.set_ylabel("PDJ")
    ax.set_ylim(0, 1.02)
    ax.legend(fontsize=7, ncol=3)
    ax.set_title("PDJ curves")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
