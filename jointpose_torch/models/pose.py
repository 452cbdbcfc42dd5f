"""Joint CNN+MRF composition (counterpart of ``jointpose/models/pose.py``).

Images in, per-joint heatmaps out: detector logits always, MRF-refined
log-heatmaps when the config enables the spatial model.
"""

from __future__ import annotations

import torch
from torch import nn

from jointpose_torch.configs import Config
from jointpose_torch.models.detector import Detector
from jointpose_torch.models.mrf import SpatialModel
from jointpose_torch.ops.heatmaps import spatial_softmax


class PoseModel(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        self.dtype = getattr(torch, config.compute_dtype)
        self.detector = Detector(config.detector, config.num_joints, dtype=self.dtype)
        self.spatial_model = (
            SpatialModel(config.mrf, config.num_joints, dtype=self.dtype)
            if config.mrf is not None else None
        )

    def forward(
        self, images: torch.Tensor, freeze_detector: bool = False, detector_only: bool = False
    ) -> dict[str, torch.Tensor]:
        """``images`` (B, H, W, 3): float in [0, 1], or raw uint8 RGB,
        normalized here in the compute dtype.

        ``freeze_detector`` stops gradients at the detector logits, so the
        spatial model trains on fixed unaries and the detector's backward
        never runs.  ``detector_only`` returns the detector logits alone,
        without running the spatial model (evaluation before the spatial
        model has its prior init)."""
        if images.dtype == torch.uint8:
            images = images.to(self.dtype) * torch.tensor(
                1.0 / 255.0, dtype=self.dtype, device=images.device
            )
        logits = self.detector(images)
        if freeze_detector:
            logits = logits.detach()
        out = {"detector_logits": logits}
        if self.spatial_model is not None and not detector_only:
            if self.config.mrf.normalize_input:
                unaries = spatial_softmax(logits)
            else:
                unaries = logits.clamp_min(0.0)
            out["mrf_log_heatmaps"] = self.spatial_model(unaries)
        return out
