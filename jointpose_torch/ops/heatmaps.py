"""Heatmap maths shared by the model and the decode (``jointpose/ops/heatmaps.py``)."""

from __future__ import annotations

import torch


def spatial_log_softmax(x: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the two spatial axes of (..., H, W, K), fp32."""
    x = x.float()
    m = x.amax(dim=(-3, -2), keepdim=True)
    z = x - m
    lse = torch.log(torch.exp(z).sum(dim=(-3, -2), keepdim=True))
    return z - lse


def spatial_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the two spatial axes of (..., H, W, K), fp32."""
    return torch.exp(spatial_log_softmax(x))


def model_scores(out: dict) -> torch.Tensor:
    """The model's final heatmap scores: MRF log-heatmaps when the
    spatial model ran, detector logits otherwise."""
    return out.get("mrf_log_heatmaps", out["detector_logits"])


def model_probs(out: dict) -> torch.Tensor:
    """Per-joint probability heatmaps from a PoseModel output dict."""
    return spatial_softmax(model_scores(out))


def decode_probs(probs: torch.Tensor, stride: int, refine: bool = False) -> torch.Tensor:
    """Probability heatmaps (..., H, W, K) -> image coords (..., K, 2)."""
    from jointpose_torch.data.targets import heatmap_to_coords

    return heatmap_to_coords(probs, stride, refine=refine)
