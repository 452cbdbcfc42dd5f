"""Work counts from a configuration's shapes, and the H100's published peaks.

FLOPs count two per multiply-add.  Every conv is charged at its widths
(output pixels x output channels x input channels per group x taps).  The
MRF's pairwise correlation is charged as its direct taps, K² pairs x grid
pixels x window taps x 2, whatever implements it (a grouped conv, a
Fourier tail, a dense rewrite), so that every implementation reads against
the same work.  Elementwise ops, pools, softmaxes and the decode are not
charged.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12


def _conv(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1) -> tuple[int, int, int]:
    """(FLOPs, output height, output width) of a SAME k x k conv."""
    ho, wo = -(-h // stride), -(-w // stride)
    return 2 * ho * wo * cout * cin * k * k, ho, wo


def _trunk(det: dict, h: int, w: int) -> tuple[int, int, int, int]:
    flops, cin = 0, 3
    for cout, pooled in zip(det["trunk_features"], det["trunk_pool"]):
        stride = 2 if pooled and det["pool_mode"] == "stride" else 1
        f, h, w = _conv(h, w, cin, cout, det["trunk_kernel"], stride)
        flops += f
        if pooled and det["pool_mode"] == "max":
            h, w = -(-h // 2), -(-w // 2)
        cin = cout
    return flops, h, w, cin


def forward_flops_per_image(cfg: dict) -> int:
    """FLOPs of one image's forward pass: detector and MRF."""
    det = cfg["detector"]
    h, w = cfg["data"]["image_hw"]
    flops, hm, wm, c = _trunk(det, h, w)
    if det["multires"]:
        flops += _trunk(det, h // 2, w // 2)[0]
    heads = det["head_features"]
    flops += _conv(hm, wm, c, heads[0], det["head_kernel"])[0]
    for cin, cout in zip(heads, heads[1:] + [9]):
        flops += _conv(hm, wm, cin, cout, 1)[0]
    if cfg.get("mrf") is not None:
        s = cfg["mrf"]["stride"]
        wh, ww = cfg["mrf"]["window"]
        flops += 2 * 81 * (hm // s) * (wm // s) * wh * ww
    return flops


def train_flops_per_image(cfg: dict) -> int:
    """A training image: the forward, the input gradients and the weight
    gradients, each charged as the forward."""
    return 3 * forward_flops_per_image(cfg)


def bound_s(n_bytes: float, n_flops: float, peak: float) -> float:
    """The least time the card could take: bytes at HBM's rate or operations
    at ``peak``, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / peak)


def mrf_tail_bound_s(cfg: dict, batch: int) -> float:
    """Row 3′ (the single-pass Fourier MRF tail) at a dispatched batch: its
    function's TF32 products done once at the TF32 peak, or its bytes (the
    unaries' and kernels' half spectra, the inverse tables and the biases
    read once, the fp32 (B, K, H, W) output written once) at HBM's rate."""
    h, w = cfg["data"]["image_hw"][0] // cfg["data"]["heatmap_stride"], \
        cfg["data"]["image_hw"][1] // cfg["data"]["heatmap_stride"]
    wh, ww = cfg["mrf"]["window"]
    k = 9
    ph, g = h + wh - 1, (w + ww - 1) // 2 + 1
    per_pair = 6 * ph * g + 8 * h * ph * g + 4 * h * g * w + 4 * h * w
    n_bytes = 4 * (2 * batch * k * ph * g + 2 * k * k * ph * g + h * ph * 2 + 2 * g * w + k * k
                   + batch * k * h * w)
    return bound_s(n_bytes, batch * k * k * per_pair, TF32_FLOPS_PER_S)


def warp_bound_s(cfg: dict, rows: int) -> float:
    """Row 4 (the fused shear warp) over one step's rows: each fp32 input
    byte read once and each output byte written once, the (B, 2, 2) and
    (B, 2) maps read once; 22 operations an output value."""
    h, w = cfg["data"]["image_hw"]
    values = rows * h * w * 3
    return bound_s(2 * 4 * values + 4 * 6 * rows, 22 * values, FP32_FLOPS_PER_S)
