"""Inputs and weights made from ``--seed``: the same seed gives the same
tensors.  Both are made on the run's device with a ``torch.Generator``
there, in a few large calls, and handed alike to the program and to the
reference.

Weights (a configuration file's ``assumed`` says so too): conv kernels
N(0, 1/fan_in), the program's ``init_state_dict`` distribution; conv biases
N(0, 0.1²) and the MRF's raw kernels and biases at the program's initial
values plus N(0, 1) and N(0, 0.5²) noise, so that a bias left out or a
correlation turned round shows in the comparison.

Images: uint8 RGB with structure at several scales (a few blurred random
fields summed), so that the detector's heatmaps have peaks and not only
noise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.model import param_shapes

SEED_MASK = (1 << 63) - 1


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator for one purpose (``salt``) of one run (``seed``)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) & SEED_MASK)
    return g


def _inverse_softplus(y: float) -> float:
    return math.log(math.expm1(y))


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 parameters under the program's names, on ``device``."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    noise = torch.randn(total, generator=generator(seed, 1, device), device=device)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = noise[offset:offset + n].reshape(shape)
        offset += n
        if name == "spatial_model.raw_kernels":
            wh, ww = shape[:2]
            out[name] = _inverse_softplus(1.0 / (wh * ww)) + z
        elif name == "spatial_model.raw_bias":
            out[name] = _inverse_softplus(1e-4) + 0.5 * z
        elif name.endswith(".weight"):
            out[name] = z / math.sqrt(math.prod(shape[1:]))
        else:
            out[name] = 0.1 * z
    return out


def make_images(n: int, hw: tuple[int, int], seed: int, salt: int, device) -> torch.Tensor:
    """(n, H, W, 3) uint8 images on ``device``."""
    h, w = hw
    g = generator(seed, salt, device)
    img = torch.zeros((n, 3, h, w), device=device)
    for cells, weight in ((4, 0.5), (16, 0.3), (64, 0.2)):
        field = torch.rand((n, 3, max(h // cells, 2), max(w // cells, 2)), generator=g,
                           device=device)
        img += weight * F.interpolate(field, size=(h, w), mode="bilinear", align_corners=False)
    img += 0.05 * torch.randn((n, 3, h, w), generator=g, device=device)
    return (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def make_joints(n: int, hw: tuple[int, int], seed: int, salt: int, device):
    """(n, 9, 2) joints (x, y) inside the frame and (n, 9) visibility,
    nine in ten visible, fp32 on ``device``."""
    h, w = hw
    g = generator(seed, salt, device)
    u = torch.rand((n, 9, 3), generator=g, device=device)
    joints = torch.stack([u[..., 0] * (w - 1), u[..., 1] * (h - 1)], dim=-1)
    return joints, (u[..., 2] < 0.9).float()
