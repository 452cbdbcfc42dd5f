"""Crop/scale/rotate/flip augmentation on the device (counterpart of
``jointpose/data/augment.py``).

The whole geometric transform is one affine map per image: images are
resampled through its inverse (the gather warp, or the two-pass shear
warp of ``ops/warp.py``), joints go through the forward map, and the
left/right joint labels swap under a horizontal flip
(``skeleton.FLIP_PERM``).  All 2x2 algebra is written out elementwise,
so coordinate maths never rounds through a reduced-precision matmul.

``random_augment_params`` draws from an explicit ``torch.Generator`` with
the reference's distributions and ranges; its stream differs from
``jax.random``'s, so tests hand both sides the same ``AugmentParams``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from jointpose_torch import skeleton
from jointpose_torch.configs import AugmentConfig
from jointpose_torch.ops.warp import shear_warp


class AugmentParams(NamedTuple):
    """Per-image augmentation draw, each a (B,) fp32 tensor."""

    scale: torch.Tensor
    angle: torch.Tensor  # radians
    tx: torch.Tensor  # pixels
    ty: torch.Tensor  # pixels
    flip: torch.Tensor  # {0., 1.}
    # Crop: a (crop_frac·H, crop_frac·W) window at (crop_x0, crop_y0)
    # resampled back to (H, W); None means the identity (frac 1, origin 0).
    crop_frac: torch.Tensor | None = None
    crop_x0: torch.Tensor | None = None
    crop_y0: torch.Tensor | None = None


def _fill_crop_identity(p: AugmentParams) -> AugmentParams:
    if p.crop_frac is not None:
        return p
    z = torch.zeros_like(p.scale, dtype=torch.float32)
    return p._replace(crop_frac=torch.ones_like(z), crop_x0=z, crop_y0=z)


def identity_augment_params(batch: int) -> AugmentParams:
    z = torch.zeros(batch, dtype=torch.float32)
    return _fill_crop_identity(
        AugmentParams(scale=torch.ones_like(z), angle=z, tx=z, ty=z, flip=z)
    )


def random_augment_params(
    generator: torch.Generator, batch: int, cfg: AugmentConfig, image_hw: tuple[int, int]
) -> AugmentParams:
    """Draw per-image scale/rotation/translation/flip/crop on the
    generator's device: the reference's uniform ranges, another stream."""
    h, w = image_hw
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=dev, dtype=torch.float32)
        return lo + (hi - lo) * u

    scale = uniform(batch, *cfg.scale_range)
    max_rad = cfg.rotate_deg * math.pi / 180.0
    angle = uniform(batch, -max_rad, max_rad)
    t = uniform((batch, 2), -cfg.translate_frac, cfg.translate_frac)
    flip = (uniform(batch) < cfg.flip_prob).float()
    frac = uniform(batch, *cfg.crop_frac_range)
    o = uniform((batch, 2))  # uniform in-frame origin: 0 <= x0 <= (1 - frac)(w - 1)
    return AugmentParams(
        scale=scale, angle=angle, tx=t[:, 0] * w, ty=t[:, 1] * h, flip=flip,
        crop_frac=frac,
        crop_x0=o[:, 0] * (1.0 - frac) * (w - 1.0),
        crop_y0=o[:, 1] * (1.0 - frac) * (h - 1.0),
    )


@functools.cache
def _flip_perm(device: torch.device) -> torch.Tensor:
    """``skeleton.FLIP_PERM`` on ``device``, copied from the host once per
    device (a copy on every step could not be captured in a CUDA graph),
    outside inference mode."""
    with torch.inference_mode(False):
        return torch.tensor(skeleton.FLIP_PERM, device=device)


def _forward_affine(params: AugmentParams, image_hw: tuple[int, int]):
    """(B, 2, 2) matrix and (B, 2) offset of the forward map dst = A src + b.

    Crop first (an isotropic zoom about the crop origin), then rotate by
    ``angle`` and scale about the image centre, translate by (tx, ty),
    and mirror horizontally where ``flip``.  Coordinates are (x, y).
    """
    h, w = image_hw
    params = _fill_crop_identity(params)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos = torch.cos(params.angle) * params.scale
    sin = torch.sin(params.angle) * params.scale
    axx, axy, ayx, ayy = cos, -sin, sin, cos
    bx = cx - (axx * cx + axy * cy) + params.tx
    by = cy - (ayx * cx + ayy * cy) + params.ty
    zoom = 1.0 / params.crop_frac
    ox, oy = -params.crop_x0 * zoom, -params.crop_y0 * zoom
    bx = axx * ox + axy * oy + bx
    by = ayx * ox + ayy * oy + by
    axx, axy, ayx, ayy = axx * zoom, axy * zoom, ayx * zoom, ayy * zoom
    f = params.flip
    axx = (1 - f) * axx + f * (-axx)
    axy = (1 - f) * axy + f * (-axy)
    bx = (1 - f) * bx + f * (w - 1.0 - bx)
    a = torch.stack([torch.stack([axx, axy], -1), torch.stack([ayx, ayy], -1)], -2)
    return a, torch.stack([bx, by], -1)


def _apply_affine(a: torch.Tensor, b: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Per-image affine (B, 2, 2), (B, 2) on points (B, K, 2), elementwise."""
    x, y = pts[..., 0], pts[..., 1]
    ox = a[:, None, 0, 0] * x + a[:, None, 0, 1] * y + b[:, None, 0]
    oy = a[:, None, 1, 0] * x + a[:, None, 1, 1] * y + b[:, None, 1]
    return torch.stack([ox, oy], dim=-1)


def transform_joints(
    joints_xy: torch.Tensor, visible: torch.Tensor, params: AugmentParams,
    image_hw: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward affine on (B, K, 2) joints; labels swap under flip, and
    joints that leave the frame become invisible."""
    h, w = image_hw
    a, b = _forward_affine(params, image_hw)
    out = _apply_affine(a, b, joints_xy)
    perm = _flip_perm(out.device)
    f = params.flip[:, None, None]
    out = (1 - f) * out + f * out[:, perm, :]
    fv = params.flip[:, None]
    vis = (1 - fv) * visible + fv * visible[:, perm]
    in_frame = (
        (out[..., 0] >= 0.0) & (out[..., 0] <= w - 1.0)
        & (out[..., 1] >= 0.0) & (out[..., 1] <= h - 1.0)
    )
    return out, vis * in_frame.to(visible.dtype)


def _warp_images(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor) -> torch.Tensor:
    """Bilinear inverse warp src = A_inv dst + b_inv of (B, H, W, C) images,
    zero outside the frame: ``map_coordinates(order=1, mode='constant')``,
    with the reference's corner order and weights."""
    bsz, h, w, c = images.shape
    ys = torch.arange(h, dtype=torch.float32, device=images.device)
    xs = torch.arange(w, dtype=torch.float32, device=images.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)

    def coef(i, j):
        return a_inv[:, i, j, None, None]

    src_x = coef(0, 0) * gx + coef(0, 1) * gy + b_inv[:, 0, None, None]
    src_y = coef(1, 0) * gx + coef(1, 1) * gy + b_inv[:, 1, None, None]
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    fx, fy = src_x - x0, src_y - y0
    flat = images.reshape(bsz, h * w, c)
    out = torch.zeros_like(images)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yi, xi = (y0 + dy).long(), (x0 + dx).long()
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(bsz, h * w, 1)
            val = torch.gather(flat, 1, idx.expand(bsz, h * w, c)).reshape(bsz, h, w, c)
            out = out + (wy * wx)[..., None] * torch.where(ok[..., None], val, 0.0)
    return out


def inverse_affine(params: AugmentParams, image_hw: tuple[int, int]):
    """(B, 2, 2) matrix and (B, 2) offset of the inverse map src = A_inv dst + b_inv,
    by the closed-form 2x2 inverse, elementwise."""
    a, b = _forward_affine(params, image_hw)
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv00 = a[:, 1, 1] / det
    inv01 = -a[:, 0, 1] / det
    inv10 = -a[:, 1, 0] / det
    inv11 = a[:, 0, 0] / det
    a_inv = torch.stack([torch.stack([inv00, inv01], -1), torch.stack([inv10, inv11], -1)], -2)
    b_inv = torch.stack(
        [-(inv00 * b[:, 0] + inv01 * b[:, 1]), -(inv10 * b[:, 0] + inv11 * b[:, 1])], -1
    )
    return a_inv, b_inv


def augment_batch(
    images: torch.Tensor, joints_xy: torch.Tensor, visible: torch.Tensor,
    params: AugmentParams, warp_impl: str = "gather",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp a batch of (B, H, W, C) images (float in [0, 1] or uint8,
    converted to fp32 here) and transform their (B, K, 2) joints.

    ``warp_impl``: 'gather' (single-pass bilinear) or 'shear' (the
    two-pass warp of ``ops/warp.py``, its kernel on the card).
    """
    if warp_impl not in ("gather", "shear"):
        raise ValueError(f"unknown warp_impl {warp_impl!r}")
    if images.dtype == torch.uint8:
        images = images.float() * (1.0 / 255.0)
    image_hw = (images.shape[1], images.shape[2])
    a_inv, b_inv = inverse_affine(params, image_hw)
    if warp_impl == "shear":
        warped = shear_warp(images.float().contiguous(), a_inv, b_inv)
    else:
        warped = _warp_images(images.float(), a_inv, b_inv)
    joints_out, vis_out = transform_joints(joints_xy, visible, params, image_hw)
    return warped, joints_out, vis_out
