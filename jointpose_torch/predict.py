"""Batch inference entry: images -> joint coordinates and heatmaps
(counterpart of ``jointpose/predict.py:build_predictor``, one device).

    config = get_config("joint")
    state = init_state_dict(config, torch.Generator().manual_seed(0))
    predict = build_predictor(config, state)           # on the GPU
    coords, probs = predict(images_uint8_nhwc)

    state, step = restore_params(config, "runs/joint/checkpoints", best=True)
    predict = build_predictor(reconcile_config(config, "runs/joint/checkpoints"), state)
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
    With ``config.eval_flip_tta`` the heatmaps are averaged with those of
    the mirrored images.
    """
    from jointpose_torch.evaluate import flip_images, unflip_heatmaps

    device = resolve_device(device)
    model = PoseModel(config)
    model.load_state_dict(state_dict)
    model = model.to(device).eval()
    stride = config.data.heatmap_stride

    @torch.inference_mode()
    def predict(images: torch.Tensor):
        images = images.to(device)
        probs = model_probs(model(images))
        if config.eval_flip_tta:
            probs = 0.5 * (probs + unflip_heatmaps(model_probs(model(flip_images(images)))))
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


def restore_params(
    config: Config, checkpoint_dir: str, step: int | None = None, best: bool = False
) -> tuple[dict[str, torch.Tensor], int]:
    """The model's ``state_dict`` (on the CPU) from a checkpoint directory
    that ``train.fit`` wrote, and its step.  ``best=True`` picks the
    checkpoint kept for the highest PDJ; otherwise the given ``step`` or
    the latest.  The weights alone are read, so inference does not depend
    on the saving run's optimizer; they are checked against the shapes of
    ``config`` as the checkpoint's recorded run config resolves it."""
    from jointpose_torch.checkpoint import Checkpointer, reconcile_config

    ckpt = Checkpointer(checkpoint_dir, keep=1)
    if best and step is None:
        step = ckpt.best_step()
        if step is None:
            raise FileNotFoundError(
                f"no best checkpoint recorded under {checkpoint_dir} (the run ended before "
                "its first full-model eval); pass an explicit step or best=False for the latest"
            )
    if step is None:
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    state_dict = ckpt.restore_subtree(("model",), step=step)["model"]
    template = PoseModel(reconcile_config(config, checkpoint_dir)).state_dict()
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    want = {k: tuple(v.shape) for k, v in template.items()}
    if got != want:
        raise ValueError(
            f"checkpoint {checkpoint_dir} step {step} does not fit config {config.name!r}: "
            f"{sorted(set(got.items()) ^ set(want.items()))}"
        )
    return state_dict, int(step)
