"""Plain PyTorch reference of a joint-stage training step: the augmentation
draw, the affine warp of images and joints, the Gaussian targets, both
losses, the backward pass and the AdamW update, in fp32.

The augmentation is drawn from a ``torch.Generator`` on the card seeded as
the benchmark seeds the program's, with the same calls in the same order
(the configuration's uniform ranges), so both sides warp alike.  The warp
is the two-pass shear resample written with dense hat matrices; the
affine maps are written out elementwise.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as ref
from benchmark.reference.model import FP32

FLIP_PERM = (0, 2, 1, 4, 3, 6, 5, 8, 7)  # nose; l/r shoulder, elbow, wrist, hip swap


def draw_augment(gen: torch.Generator, n: int, aug: dict, hw) -> dict:
    """Per-image scale, angle (radians), tx, ty (pixels), flip, crop."""
    h, w = hw
    dev = gen.device

    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)

    scale = uniform(n, *aug["scale_range"])
    rad = aug["rotate_deg"] * math.pi / 180.0
    angle = uniform(n, -rad, rad)
    t = uniform((n, 2), -aug["translate_frac"], aug["translate_frac"])
    flip = (uniform(n) < aug["flip_prob"]).float()
    frac = uniform(n, *aug["crop_frac_range"])
    o = uniform((n, 2))
    return {"scale": scale, "angle": angle, "tx": t[:, 0] * w, "ty": t[:, 1] * h, "flip": flip,
            "crop_frac": frac, "crop_x0": o[:, 0] * (1.0 - frac) * (w - 1.0),
            "crop_y0": o[:, 1] * (1.0 - frac) * (h - 1.0)}


def forward_affine(p: dict, hw):
    """dst = A src + b: zoom into the crop, rotate and scale about the
    centre, translate, mirror where flipped; A as (axx, axy, ayx, ayy)."""
    h, w = hw
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos = torch.cos(p["angle"]) * p["scale"]
    sin = torch.sin(p["angle"]) * p["scale"]
    axx, axy, ayx, ayy = cos, -sin, sin, cos
    bx = cx - (axx * cx + axy * cy) + p["tx"]
    by = cy - (ayx * cx + ayy * cy) + p["ty"]
    zoom = 1.0 / p["crop_frac"]
    ox, oy = -p["crop_x0"] * zoom, -p["crop_y0"] * zoom
    bx = axx * ox + axy * oy + bx
    by = ayx * ox + ayy * oy + by
    axx, axy, ayx, ayy = axx * zoom, axy * zoom, ayx * zoom, ayy * zoom
    f = p["flip"]
    axx = (1 - f) * axx + f * (-axx)
    axy = (1 - f) * axy + f * (-axy)
    bx = (1 - f) * bx + f * (w - 1.0 - bx)
    return (axx, axy, ayx, ayy), (bx, by)


def inverse_affine(p: dict, hw):
    (axx, axy, ayx, ayy), (bx, by) = forward_affine(p, hw)
    det = axx * ayy - axy * ayx
    i00, i01, i10, i11 = ayy / det, -axy / det, -ayx / det, axx / det
    return (i00, i01, i10, i11), (-(i00 * bx + i01 * by), -(i10 * bx + i11 * by))


def transform_joints(joints: torch.Tensor, visible: torch.Tensor, p: dict, hw):
    h, w = hw
    (axx, axy, ayx, ayy), (bx, by) = forward_affine(p, hw)
    x, y = joints[..., 0], joints[..., 1]
    ox = axx[:, None] * x + axy[:, None] * y + bx[:, None]
    oy = ayx[:, None] * x + ayy[:, None] * y + by[:, None]
    out = torch.stack([ox, oy], dim=-1)
    perm = torch.tensor(FLIP_PERM, device=joints.device)
    f = p["flip"][:, None, None]
    out = (1 - f) * out + f * out[:, perm, :]
    fv = p["flip"][:, None]
    vis = (1 - fv) * visible + fv * visible[:, perm]
    inside = (out[..., 0] >= 0) & (out[..., 0] <= w - 1.0) & (out[..., 1] >= 0) & (out[..., 1] <= h - 1.0)
    return out, vis * inside.float()


def _hat_resample(src: torch.Tensor, alpha, shear, offset, s_out: int) -> torch.Tensor:
    """(N, S_in, C) -> (N, S_out, C): out[n, o] = Σ_i max(0, 1 - |i - pos|) src[n, i],
    pos = alpha·o + shear·n + offset."""
    n, s_in, _ = src.shape
    dev = src.device
    pos = (alpha * torch.arange(s_out, dtype=torch.float32, device=dev)[None, :]
           + shear * torch.arange(n, dtype=torch.float32, device=dev)[:, None] + offset)
    ins = torch.arange(s_in, dtype=torch.float32, device=dev)
    hat = (1.0 - (ins[None, None, :] - pos[..., None]).abs()).clamp_min(0.0)
    return torch.einsum("noi,nic->noc", hat, src)


def shear_warp(images: torch.Tensor, a_inv, b_inv) -> torch.Tensor:
    """Two-pass warp of (B, H, W, C) fp32 images by src = A_inv dst + b_inv:
    an x-resample at each source row, then a y-resample at each output
    column, zero outside the frame."""
    i00, i01, i10, i11 = a_inv
    b0, b1 = b_inv
    det = i00 * i11 - i01 * i10
    h, w = images.shape[1], images.shape[2]
    out = []
    for j, img in enumerate(images):
        t1 = _hat_resample(img, det[j] / i11[j], i01[j] / i11[j], b0[j] - i01[j] * b1[j] / i11[j], w)
        t2 = _hat_resample(t1.transpose(0, 1), i11[j], i10[j], b1[j], h)
        out.append(t2.transpose(0, 1))
    return torch.stack(out)


def gaussian_targets(joints: torch.Tensor, visible: torch.Tensor, cfg: dict) -> dict:
    s = cfg["data"]["heatmap_stride"]
    h, w = cfg["data"]["image_hw"][0] // s, cfg["data"]["image_hw"][1] // s
    sigma = cfg["data"]["sigma"]
    hm = (joints - (s - 1) / 2.0) / s
    ys = torch.arange(h, dtype=torch.float32, device=joints.device)
    xs = torch.arange(w, dtype=torch.float32, device=joints.device)
    d2 = (ys[None, :, None, None] - hm[:, None, None, :, 1]) ** 2 \
        + (xs[None, None, :, None] - hm[:, None, None, :, 0]) ** 2
    peak = torch.exp(-d2 / (2.0 * sigma * sigma))
    dist = peak / peak.sum(dim=(1, 2), keepdim=True).clamp_min(1e-12)
    v = visible[:, None, None, :]
    return {"peak1": peak * v, "dist": dist * v}


def loss(cfg: dict, out: dict, targets: dict, visible: torch.Tensor) -> torch.Tensor:
    """Detector MSE against the peak-1 targets plus the MRF's spatial
    cross-entropy against the normalized ones, over visible joints."""
    t = cfg["train"]
    if (t["detector_loss"], t["mrf_loss"]) != ("mse", "ce"):
        raise NotImplementedError("the reference has the mse detector and ce MRF losses")
    logits = out["detector_logits"]
    v = visible[:, None, None, :]
    n_vis = v.sum().clamp_min(1.0)
    mse = ((logits - targets["peak1"]) ** 2 * v).sum() / (n_vis * logits.shape[1] * logits.shape[2])
    logp = ref.spatial_log_softmax(out["mrf_log_heatmaps"])
    ce = (-(targets["dist"] * logp).sum(dim=(1, 2)) * visible).sum() / n_vis
    return mse + ce


def train(cfg: dict, weights: dict, batches: list[dict], aug_seed: int, quant=FP32,
          rows: slice | None = None, marks=(), still: bool = False) -> dict:
    """``len(batches)`` joint-stage steps from ``weights`` with AdamW.

    Each batch is the global batch (uint8 'image', 'joints', 'visible' on
    the card); the augmentation of the whole batch is drawn each step.
    ``rows`` trains on those rows of each batch alone, and ``still`` leaves
    the parameters where they are (planted faults).
    Returns each step's loss, the first step's gradients, and the
    parameters after each step count in ``marks``."""
    t, aug = cfg["train"], cfg["augment"]
    if t["optimizer"] != "adamw" or t["lr_schedule"] != "constant" or t["freeze_detector_in_joint"]:
        raise NotImplementedError("the reference trains with constant-rate AdamW, all parameters")
    if aug["warp_impl"] != "shear" or not aug["enabled"]:
        raise NotImplementedError("the reference warps with the two-pass shear resample")
    hw = tuple(cfg["data"]["image_hw"])
    dev = batches[0]["image"].device
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=t["learning_rate"], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=t["weight_decay"], foreach=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(aug_seed)
    losses, first_grads, at = [], None, {}
    with ref.fp32_mode():
        for step, batch in enumerate(batches, start=1):
            p = draw_augment(gen, batch["image"].shape[0], aug, hw)
            sel = slice(None) if rows is None else rows
            p = {k: v[sel] for k, v in p.items()}
            images = batch["image"][sel].float() * (1.0 / 255.0)
            a_inv, b_inv = inverse_affine(p, hw)
            warped = shear_warp(images, a_inv, b_inv)
            joints, vis = transform_joints(batch["joints"][sel].float(), batch["visible"][sel].float(),
                                           p, hw)
            targets = gaussian_targets(joints, vis, cfg)
            opt.zero_grad(set_to_none=True)
            total = loss(cfg, ref.forward(params, cfg, warped, quant), targets, vis)
            total.backward()
            losses.append(float(total.detach()))
            if first_grads is None:
                first_grads = {k: v.grad.detach().clone() for k, v in params.items()}
            if not still:
                opt.step()
            if step in marks:
                at[step] = {k: v.detach().clone() for k, v in params.items()}
    return {"losses": losses, "first_grads": first_grads, "params": at}
