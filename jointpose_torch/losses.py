"""Heatmap losses (counterpart of ``jointpose/losses.py``).

Per-pixel MSE against the peak-1 Gaussian (the paper's regression) and a
per-joint spatial softmax cross-entropy against the normalized target,
selected by ``TrainConfig.detector_loss`` / ``mrf_loss``.  Every loss
masks invisible joints and reduces in fp32, with the reference's
denominators.

Under a mesh (``mesh=``, ``parallel.mesh.Mesh``) each rank holds its rows
of the global batch, and the reference's loss is over the global batch:
the denominators (the visible counts) are summed over 'data' as
constants, so that the sum of the ranks' losses, and of their gradients,
is the global loss and its gradient.
"""

from __future__ import annotations

import torch

from jointpose_torch.ops.heatmaps import spatial_log_softmax


def _global_count(count: torch.Tensor, mesh) -> torch.Tensor:
    """``count`` summed over the mesh's 'data' axis, as a constant."""
    if mesh is None or mesh.shape["data"] == 1:
        return count
    return mesh.all_reduce(count.detach().clone(), "data")


def heatmap_mse(pred: torch.Tensor, target: torch.Tensor, visible: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Masked per-pixel MSE of (B, H, W, K) heatmaps; ``visible`` (B, K)."""
    pred = pred.float()
    vis = visible.float()[:, None, None, :]
    se = (pred - target.float()) ** 2 * vis
    denom = _global_count(vis.sum(), mesh).clamp_min(1.0) * pred.shape[1] * pred.shape[2]
    return se.sum() / denom


def heatmap_ce(logits: torch.Tensor, target_dist: torch.Tensor, visible: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """Per-joint spatial cross-entropy of (B, H, W, K) scores against
    target distributions, averaged over visible joints."""
    logp = spatial_log_softmax(logits)
    vis = visible.float()
    ce = -(target_dist.float() * logp).sum(dim=(1, 2))  # (B, K)
    return (ce * vis).sum() / _global_count(vis.sum(), mesh).clamp_min(1.0)


def mrf_heatmap_loss(
    kind: str, log_heatmaps: torch.Tensor, targets: dict, visible: torch.Tensor, mesh=None
) -> torch.Tensor:
    """Loss on the spatial model's log-space output.

    'ce': log p̄ goes straight into the spatial softmax CE.  'mse': the
    peak-normalized heatmap exp(log p̄ − max log p̄) against the 'peak1'
    target, itself normalized to peak exactly 1.
    """
    if kind == "ce":
        return heatmap_ce(log_heatmaps, targets["dist"], visible, mesh)
    if kind == "mse":
        lhm = log_heatmaps.float()
        peak = lhm.amax(dim=(1, 2), keepdim=True)
        tgt = targets["peak1"].float()
        tgt = tgt / tgt.amax(dim=(1, 2), keepdim=True).clamp_min(1e-6)
        return heatmap_mse(torch.exp(lhm - peak), tgt, visible, mesh)
    raise ValueError(f"unknown loss kind {kind!r}")


def heatmap_loss(kind: str, pred: torch.Tensor, targets: dict, visible: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Dispatch on loss kind: 'mse' against ``targets['peak1']``, 'ce'
    against ``targets['dist']``."""
    if kind == "mse":
        return heatmap_mse(pred, targets["peak1"], visible, mesh)
    if kind == "ce":
        return heatmap_ce(pred, targets["dist"], visible, mesh)
    raise ValueError(f"unknown loss kind {kind!r}")
