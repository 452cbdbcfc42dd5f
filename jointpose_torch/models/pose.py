"""Joint CNN+MRF composition (counterpart of ``jointpose/models/pose.py``).

Images in, per-joint heatmaps out: detector logits always, MRF-refined
log-heatmaps when the config enables the spatial model.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from jointpose_torch.configs import Config
from jointpose_torch.models.detector import Detector
from jointpose_torch.models.mrf import SpatialModel
from jointpose_torch.ops.heatmaps import spatial_softmax


def _unaries(config: Config, logits: torch.Tensor) -> torch.Tensor:
    """The spatial model's input: softmaxed or rectified detector logits."""
    if config.mrf.normalize_input:
        return spatial_softmax(logits)
    return logits.clamp_min(0.0)


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
            out["mrf_log_heatmaps"] = self.spatial_model(_unaries(self.config, logits))
        return out


class LogitsTail(nn.Module):
    """fp32 detector logits (B, Hm, Wm, K) -> the ``PoseModel`` output dict,
    through the same spatial model and MRF route as ``PoseModel.forward``."""

    def __init__(self, config: Config, spatial_model: SpatialModel | None):
        super().__init__()
        self.config = config
        self.spatial_model = spatial_model

    def forward(self, logits: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {"detector_logits": logits}
        if self.spatial_model is not None:
            out["mrf_log_heatmaps"] = self.spatial_model(_unaries(self.config, logits))
        return out


def make_logits_tail_fn(config: Config, state_dict_or_model: Mapping | PoseModel) -> LogitsTail:
    """The MRF tail of ``PoseModel`` for logits made elsewhere (the int8
    detector of ``ops/quant.py``).  Takes the model's ``state_dict`` (only
    its ``spatial_model.*`` entries are read) or a ``PoseModel``, whose
    spatial model it shares.  A config without an MRF gives a tail that
    returns the logits alone."""
    if config.mrf is None:
        return LogitsTail(config, None)
    if isinstance(state_dict_or_model, PoseModel):
        return LogitsTail(config, state_dict_or_model.spatial_model)
    spatial = SpatialModel(config.mrf, config.num_joints, dtype=getattr(torch, config.compute_dtype))
    prefix = "spatial_model."
    spatial.load_state_dict({k[len(prefix):]: v for k, v in state_dict_or_model.items()
                             if k.startswith(prefix)})
    return LogitsTail(config, spatial)
