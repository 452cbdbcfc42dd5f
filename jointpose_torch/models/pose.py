"""Joint CNN+MRF composition (counterpart of ``jointpose/models/pose.py``).

Images in, per-joint heatmaps out: detector logits always, MRF-refined
log-heatmaps when the config enables the spatial model.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn

from jointpose_torch.configs import Config
from jointpose_torch.metrics import span
from jointpose_torch.models.detector import Detector
from jointpose_torch.models.mrf import SpatialModel
from jointpose_torch.ops.heatmaps import spatial_softmax
from jointpose_torch.parallel.mesh import param_shardings


def _unaries(config: Config, logits: torch.Tensor) -> torch.Tensor:
    """The spatial model's input: softmaxed or rectified detector logits."""
    if config.mrf.normalize_input:
        return spatial_softmax(logits)
    return logits.clamp_min(0.0)


def unit_images(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Raw uint8 RGB -> ``dtype`` in [0, 1], on the images' device; float
    images pass through."""
    if images.dtype != torch.uint8:
        return images
    # A fill on the device, not a copy from the host: a CUDA graph can
    # capture it.
    return images.to(dtype) * torch.full((), 1.0 / 255.0, dtype=dtype, device=images.device)


class PoseModel(nn.Module):
    """``mesh`` (``parallel.mesh.Mesh``): tensor parallelism over its
    'model' axis, engaged only when that axis is larger than 1 (the head's
    split convs, the MRF's source joints); the parameters are the same
    either way.  ``spatial=True`` also splits the trunk's image rows over
    'model' (``parallel/spatial.py``), again only when that axis is larger
    than 1."""

    def __init__(self, config: Config, mesh=None, spatial: bool = False):
        super().__init__()
        self.config = config
        self.mesh = mesh
        self.dtype = getattr(torch, config.compute_dtype)
        self.spatial = spatial and mesh is not None and mesh.shape["model"] > 1
        self.detector = Detector(config.detector, config.num_joints, dtype=self.dtype,
                                 mesh=mesh, spatial=self.spatial)
        self.spatial_model = (
            SpatialModel(config.mrf, config.num_joints, dtype=self.dtype, mesh=mesh)
            if config.mrf is not None else None
        )

    def model_sliced_parameters(self) -> set[str]:
        """Names of the parameters that this rank uses only in a 'model'
        slice: their gradients must be summed over 'model' too."""
        names = set()
        if self.mesh is not None:  # the rule that slices the head's convs
            names = {n for n, rule in param_shardings(self, self.mesh).items() if rule}
        if self.spatial_model is not None and self.spatial_model.tp:  # sliced activations
            names |= {"spatial_model.raw_kernels", "spatial_model.raw_bias"}
        if self.spatial:  # the trunk sees this rank's rows only
            names |= {f"detector.{n}" for n, _ in self.detector.named_parameters()
                      if n.startswith("trunk")}
        return names

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
        with span("detector"):
            logits = self.detector(unit_images(images, self.dtype))
        if freeze_detector:
            logits = logits.detach()
        out = {"detector_logits": logits}
        if self.spatial_model is not None and not detector_only:
            with span("mrf"):
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
