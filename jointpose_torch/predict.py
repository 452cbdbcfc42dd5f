"""Batch inference entry: images -> joint coordinates and heatmaps
(counterpart of ``jointpose/predict.py:build_predictor``, one device).

    config = get_config("joint")
    state = init_state_dict(config, torch.Generator().manual_seed(0))
    predict = build_predictor(config, state)           # on the GPU
    coords, probs = predict(images_uint8_nhwc)
"""

from __future__ import annotations

import math

import torch

from jointpose_torch.configs import Config
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.ops.heatmaps import decode_probs, model_probs


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jointpose_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions of its kernels"
        )
    return device


def build_predictor(config: Config, state_dict: dict, device: str | torch.device | None = None):
    """Return fn: images (B, H, W, 3) -> (coords (B, K, 2), probs (B, Hm, Wm, K)).

    ``images`` are uint8 RGB or float in [0, 1], on any device; they are
    moved to the predictor's device.  Coordinates are image pixels (x, y).
    """
    if config.eval_flip_tta:
        raise NotImplementedError(
            "eval_flip_tta is not ported yet (evaluate.flip_images); see ROADMAP.md"
        )
    device = resolve_device(device)
    model = PoseModel(config)
    model.load_state_dict(state_dict)
    model = model.to(device).eval()
    stride = config.data.heatmap_stride

    @torch.inference_mode()
    def predict(images: torch.Tensor):
        probs = model_probs(model(images.to(device)))
        coords = decode_probs(probs, stride, refine=config.decode_refine)
        return coords, probs

    return predict


def init_state_dict(config: Config, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Seeded random weights for ``config``, on the CPU.

    Conv kernels are N(0, 1/fan_in) (LeCun normal, the reference's conv
    default up to truncation), biases zero; the spatial model starts at
    its uniform-kernel init, as the reference's does.
    """
    out: dict[str, torch.Tensor] = {}
    for name, param in PoseModel(config).named_parameters():
        if name.startswith("spatial_model."):
            out[name] = param.detach().clone()
        elif name.endswith(".weight"):
            fan_in = math.prod(param.shape[1:])
            out[name] = torch.randn(param.shape, generator=generator) / math.sqrt(fan_in)
        else:
            out[name] = torch.zeros(param.shape)
    return out
