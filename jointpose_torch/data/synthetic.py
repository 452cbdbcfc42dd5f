"""Deterministic synthetic-FLIC source (counterpart of
``jointpose/data/synthetic.py``), generated on the dataset's device.

FLIC's geometry (9 upper-body joints, frames at the configured input
size, 3987/1016 split) without the dataset: example ``i`` is a pure
function of ``(cfg.seed, i)``, a pose with plausible articulated
kinematics rendered as soft limb capsules and a head blob over a smooth
random background.  Everything is plain tensor code on the device the
source was built for, so on the card a batch never crosses the host.

Each reference function is split into its draws and its arithmetic:
``pose_from_draws`` and ``render_from_draws`` hold the arithmetic (the
tests feed them the reference's own draws), ``sample_pose`` and
``render_person`` draw from this module's generator.  ``jax.random``
streams cannot be reproduced and a ``torch.Generator`` would tie an
example to the batch it is drawn in, so the draws come from a
counter-based generator written with integer tensor ops: a 64-bit mix
(the splitmix64 finalizer) of seed, example index, stream and element
number, whose top 24 bits are the uniform.  The integers and the
uniforms are bit-equal on the CPU and on the card; only ``log``,
``exp``, ``sin`` and ``cos`` differ there by rounding.

Deliberate difference: the reference draws the background's gradient
``c`` and its base colour from the same key, so they are correlated;
here they are independent draws.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from jointpose_torch import skeleton
from jointpose_torch.configs import DataConfig
from jointpose_torch.data.pipeline import as_index

_LIMB_IDX = np.asarray(
    [[skeleton.JOINT_INDEX[a], skeleton.JOINT_INDEX[b]] for a, b in skeleton.LIMBS],
    dtype=np.int64,
)

# Per-limb RGB so limbs are visually distinguishable (helps the detector
# break left/right symmetry, like clothing and context do in real FLIC).
_LIMB_COLORS = np.asarray(
    [
        [0.9, 0.4, 0.3],
        [0.3, 0.9, 0.4],
        [0.8, 0.8, 0.2],
        [0.2, 0.5, 0.9],
        [0.9, 0.2, 0.8],
        [0.2, 0.9, 0.9],
        [0.9, 0.6, 0.1],
        [0.5, 0.3, 0.9],
        [0.4, 0.9, 0.6],
        [0.7, 0.7, 0.7],
    ],
    dtype=np.float32,
)
_HEAD_COLOR = (0.95, 0.85, 0.7)


@functools.cache
def _render_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The limbs' joint pairs, their colours and the head's colour on
    ``device``, copied from the host once per device: a copy on every batch
    could not be captured in a CUDA graph.  Made outside inference mode, so
    that a first batch drawn under it leaves tensors any later step can use."""
    with torch.inference_mode(False):
        return (torch.from_numpy(_LIMB_IDX).to(device), torch.from_numpy(_LIMB_COLORS).to(device),
                torch.tensor(_HEAD_COLOR, device=device))

# Streams of the generator: one per group of draws.
_POSE, _BACKGROUND, _NOISE = 0, 1, 2


def _i64(x: int) -> int:
    """A 64-bit constant as the signed value int64 tensors hold."""
    return x - (1 << 64) if x >= 1 << 63 else x


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer; int64 arithmetic wraps."""
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def random_bits(seed: int, index: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """64 random bits for each of ``n`` elements of every example:
    (...,) int64 indices -> (..., n) int64, a function of (seed, index,
    stream, element) alone."""
    index = index.to(torch.int64)
    key = _mix(_mix(index * _GOLDEN + _i64(seed & ((1 << 64) - 1))) + stream)
    element = torch.arange(1, n + 1, dtype=torch.int64, device=index.device)
    return _mix(key.unsqueeze(-1) + element * _GOLDEN)


def uniform(seed: int, index: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """(..., n) float32 uniforms in [0, 1): the top 24 bits, exact."""
    return _shr(random_bits(seed, index, stream, n), 40).to(torch.float32) * 2.0**-24


def normal(seed: int, index: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """(..., n) float32 standard normals by Box-Muller, from two 24-bit
    uniforms of each element's 64 bits (the first in (0, 1])."""
    bits = random_bits(seed, index, stream, n)
    u1 = (_shr(bits, 40) + 1).to(torch.float32) * 2.0**-24
    u2 = (_shr(bits, 16) & 0xFFFFFF).to(torch.float32) * 2.0**-24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def pose_from_draws(
    s: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, lean: torch.Tensor,
    ua: torch.Tensor, fa: torch.Tensor, image_hw: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pose arithmetic of the reference's ``sample_pose``.

    ``s`` shoulder half-width in pixels, ``cx``, ``cy`` torso centre in
    pixels, ``lean`` torso lean in radians, all (...,); ``ua``, ``fa``
    (..., 2) left and right upper-arm and forearm angles.  Returns
    (joints (..., K, 2) image pixels (x, y), visible (..., K) ones).
    """
    h, w = float(image_hw[0]), float(image_hw[1])
    cos, sin = torch.cos(lean), torch.sin(lean)
    zero = torch.zeros_like(s)

    def rot(px, py):
        return torch.stack([px * cos - py * sin, px * sin + py * cos], dim=-1)

    lsho, rsho = rot(-s, zero), rot(s, zero)
    torso_len = 1.9 * s
    lhip, rhip = rot(-0.75 * s, torso_len), rot(0.75 * s, torso_len)
    nose = rot(zero, -0.9 * s)
    arm_len = (1.15 * s).unsqueeze(-1)

    def arm(sho, upper_ang, fore_ang, side: float):
        # angle 0 = hanging down; positive rotates outward from the body.
        a1 = upper_ang * side
        elb = sho + arm_len * torch.stack([torch.sin(a1), torch.cos(a1)], dim=-1)
        a2 = a1 + fore_ang * side
        wri = elb + arm_len * torch.stack([torch.sin(a2), torch.cos(a2)], dim=-1)
        return elb, wri

    lelb, lwri = arm(lsho, ua[..., 0], fa[..., 0], -1.0)
    relb, rwri = arm(rsho, ua[..., 1], fa[..., 1], 1.0)
    local = {"nose": nose, "lsho": lsho, "rsho": rsho, "lelb": lelb, "relb": relb,
             "lwri": lwri, "rwri": rwri, "lhip": lhip, "rhip": rhip}
    joints = torch.stack([local[name] for name in skeleton.JOINTS], dim=-2)
    joints = joints + torch.stack([cx, cy], dim=-1).unsqueeze(-2)
    # Keep inside the frame with a small margin so all joints stay visible.
    margin = 4.0
    joints = torch.stack(
        [joints[..., 0].clamp(margin, w - 1 - margin), joints[..., 1].clamp(margin, h - 1 - margin)],
        dim=-1,
    )
    return joints.float(), torch.ones(joints.shape[:-1], dtype=torch.float32, device=joints.device)


def render_from_draws(
    joints_xy: torch.Tensor, c: torch.Tensor, base: torch.Tensor, noise: torch.Tensor,
    image_hw: tuple[int, int],
) -> torch.Tensor:
    """The rendering arithmetic of the reference's ``render_person``,
    batched: joints (B, K, 2), background gradient ``c`` (B, 3, 3) and
    ``base`` colour (B, 3), standard-normal ``noise`` (B, H, W, 3) ->
    (B, H, W, 3) float32 images in [0, 1]."""
    h, w = image_hw
    dev = joints_xy.device
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij",
    )
    bg = (
        base[:, None, None, :]
        + c[:, None, None, 0, :] * (gx / w)[..., None]
        + c[:, None, None, 1, :] * (gy / h)[..., None]
        + c[:, None, None, 2, :] * (gx * gy / (w * h))[..., None]
    )

    limb_w = 0.018 * w  # capsule half-width in px
    idx, colors, head_color = _render_tables(dev)
    p1 = joints_xy[:, idx[:, 0]][..., None, None]  # (B, L, 2, 1, 1)
    p2 = joints_xy[:, idx[:, 1]][..., None, None]
    dx, dy = p2[:, :, 0] - p1[:, :, 0], p2[:, :, 1] - p1[:, :, 1]  # (B, L, 1, 1)
    len2 = (dx * dx + dy * dy).clamp_min(1e-6)
    t = (((gx - p1[:, :, 0]) * dx + (gy - p1[:, :, 1]) * dy) / len2).clamp(0.0, 1.0)
    px, py = p1[:, :, 0] + t * dx, p1[:, :, 1] + t * dy
    d2 = (gx - px) ** 2 + (gy - py) ** 2
    masks = torch.exp(-d2 / (2.0 * limb_w * limb_w))  # (B, L, H, W)
    limb_rgb = torch.einsum("blhw,lc->bhwc", masks, colors)
    alpha = masks.sum(dim=1).clamp(0.0, 1.0)[..., None]

    # Head: round blob at the nose.
    nose = joints_xy[:, skeleton.JOINT_INDEX["nose"]]
    head_r = 0.035 * w
    d2 = (gx - nose[:, 0, None, None]) ** 2 + (gy - nose[:, 1, None, None]) ** 2
    head = torch.exp(-d2 / (2.0 * head_r * head_r))[..., None]

    img = bg * (1 - alpha) + limb_rgb + head * head_color
    return (img + 0.02 * noise).clamp(0.0, 1.0).float()


def sample_pose(
    seed: int, index: torch.Tensor, image_hw: tuple[int, int]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Poses of examples ``index`` (B,): (joints (B, K, 2), visible (B, K));
    the reference's uniform ranges, this module's stream."""
    h, w = float(image_hw[0]), float(image_hw[1])
    u = uniform(seed, index, _POSE, 8)

    def between(col, lo: float, hi: float):
        return lo + (hi - lo) * u[..., col]

    return pose_from_draws(
        s=between(0, 0.07, 0.13) * w, cx=between(1, 0.3, 0.7) * w, cy=between(2, 0.3, 0.55) * h,
        lean=between(3, -0.3, 0.3), ua=between(slice(4, 6), -2.2, 2.2),
        fa=between(slice(6, 8), -2.4, 2.4), image_hw=image_hw,
    )


def render_person(
    seed: int, index: torch.Tensor, joints_xy: torch.Tensor, image_hw: tuple[int, int]
) -> torch.Tensor:
    """Images (B, H, W, 3) of the stick persons over random backgrounds."""
    h, w = image_hw
    u = uniform(seed, index, _BACKGROUND, 12)
    c = (-0.15 + 0.30 * u[..., :9]).reshape(*index.shape, 3, 3)
    base = 0.25 + 0.50 * u[..., 9:]
    noise = normal(seed, index, _NOISE, h * w * 3).reshape(*index.shape, h, w, 3)
    return render_from_draws(joints_xy, c, base, noise, image_hw)


def make_example(seed: int, index: torch.Tensor, image_hw: tuple[int, int]):
    """Examples ``index`` (B,) int64: (image, joints_xy, visible)."""
    joints, visible = sample_pose(seed, index, image_hw)
    return render_person(seed, index, joints, image_hw), joints, visible


def make_synthetic_flic(cfg: DataConfig, device: str | torch.device = "cpu"):
    """``get_batch(indices) -> dict`` generating on ``device``, usable for
    both splits: train indices live in [0, train_size), the test split's
    are offset by ``train_size`` so the splits are disjoint."""
    device = torch.device(device)

    @torch.no_grad()
    def get_batch(indices) -> dict:
        index = as_index(indices).to(device, torch.int64)
        image, joints, visible = make_example(cfg.seed, index, cfg.image_hw)
        return {"image": image, "joints": joints, "visible": visible}

    return get_batch
