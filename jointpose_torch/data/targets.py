"""Heatmap decode (the inference half of ``jointpose/data/targets.py``).

Coordinate convention: heatmap cell j covers image pixels [j*s, (j+1)*s)
and its centre sits at image coordinate j*s + (s-1)/2.
"""

from __future__ import annotations

import torch


def image_to_heatmap_coords(joints_xy: torch.Tensor, stride: int) -> torch.Tensor:
    """Image-pixel coords -> heatmap coords (pixel-centre convention)."""
    return (joints_xy - (stride - 1) / 2.0) / stride


def render_gaussian_heatmaps(
    joints_hm: torch.Tensor,
    visible: torch.Tensor,
    heatmap_hw: tuple[int, int],
    sigma: float,
    normalize: bool = False,
) -> torch.Tensor:
    """Per-joint Gaussian targets: joints (..., K, 2) in heatmap pixels (x, y)
    and visibility (..., K) -> (..., Hm, Wm, K) fp32.

    ``normalize=False`` peaks at 1 (the regression target); ``True`` makes
    each visible channel sum to 1 (the CE target).  Invisible joints
    render as zero.
    """
    hm_h, hm_w = heatmap_hw
    x = joints_hm[..., 0].float()
    y = joints_hm[..., 1].float()
    ys = torch.arange(hm_h, dtype=torch.float32, device=joints_hm.device)
    xs = torch.arange(hm_w, dtype=torch.float32, device=joints_hm.device)
    dy = ys[:, None, None] - y[..., None, None, :]  # (..., Hm, 1, K)
    dx = xs[None, :, None] - x[..., None, None, :]  # (..., 1, Wm, K)
    d2 = dy * dy + dx * dx
    hm = torch.exp(-d2 / (2.0 * sigma * sigma))
    if normalize:
        denom = hm.sum(dim=(-3, -2), keepdim=True)
        hm = hm / denom.clamp_min(1e-12)
    return hm * visible.float()[..., None, None, :]


def heatmap_to_image_coords(coords_hm: torch.Tensor, stride: int) -> torch.Tensor:
    """Heatmap coords -> image-pixel coords (pixel-centre convention)."""
    return coords_hm * stride + (stride - 1) / 2.0


def heatmap_to_coords(
    heatmaps: torch.Tensor, stride: int, refine: bool = False
) -> torch.Tensor:
    """Argmax decode: heatmaps (..., Hm, Wm, K) -> image coords (..., K, 2) as (x, y).

    The argmax takes the first maximum in row-major order.  ``refine=True``
    adds a value-weighted centroid over the valid 3x3 neighbours of the
    argmax, floored at their local minimum, with the offset of an axis
    zeroed where the peak sits on that axis' border.
    """
    hm_h, hm_w, k = heatmaps.shape[-3:]
    lead = heatmaps.shape[:-3]
    flat = heatmaps.reshape(*lead, hm_h * hm_w, k)
    idx = torch.argmax(flat, dim=-2)  # (..., K), first maximum
    iy = torch.div(idx, hm_w, rounding_mode="floor")
    ix = idx - iy * hm_w
    coords_hm = torch.stack([ix.float(), iy.float()], dim=-1)

    if refine:
        h = flat.float()
        shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

        def neighbor(dy: int, dx: int):
            ny, nx = iy + dy, ix + dx
            ok = ((ny >= 0) & (ny < hm_h) & (nx >= 0) & (nx < hm_w)).float()
            nidx = ny.clamp(0, hm_h - 1) * hm_w + nx.clamp(0, hm_w - 1)
            val = torch.gather(h, -2, nidx.unsqueeze(-2)).squeeze(-2)
            return val, ok

        vals = {s: neighbor(*s) for s in shifts}
        center = vals[(0, 0)][0]
        m = center
        for s in shifts:
            if s != (0, 0):
                val, ok = vals[s]
                m = torch.minimum(m, torch.where(ok > 0, val, center))
        den = torch.zeros_like(center)
        num_x = torch.zeros_like(center)
        num_y = torch.zeros_like(center)
        for dy, dx in shifts:
            val, ok = vals[(dy, dx)]
            wgt = (val - m) * ok
            den = den + wgt
            num_x = num_x + dx * wgt
            num_y = num_y + dy * wgt
        den = den.clamp_min(1e-12)
        sel = torch.stack([num_x / den, num_y / den], dim=-1)
        x_interior = ((coords_hm[..., 0] > 0) & (coords_hm[..., 0] < hm_w - 1)).float()
        y_interior = ((coords_hm[..., 1] > 0) & (coords_hm[..., 1] < hm_h - 1)).float()
        interior = torch.stack([x_interior, y_interior], dim=-1)
        coords_hm = coords_hm + sel.clamp(-1.0, 1.0) * interior

    return heatmap_to_image_coords(coords_hm, stride)
