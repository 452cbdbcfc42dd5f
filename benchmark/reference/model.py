"""Plain PyTorch reference of the pose model: detector, MRF message pass
and heatmap decode, written from the paper (arXiv:1406.2984 §3) and the
configuration file alone.

It imports nothing of the program.  Parameters are a dict of fp32
tensors under the names the benchmark makes them with (``param_shapes``),
so that the same weights go to the program and to this reference.  The
functions take ``quant``, a ``Rounding``: what is rounded to each conv's
operands and to the MRF's pairwise responses, and in a backward pass to
their gradients.  ``FP32`` rounds nothing;
the lower-precision control rounds (``reference/precision.py``).

Callers turn TF32 off (``fp32_mode``): this reference is fp32 throughout.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

NUM_JOINTS = 9
# The heatmap channels, in order: FLIC's upper-body joints.
JOINTS = ("nose", "lsho", "rsho", "lelb", "relb", "lwri", "rwri", "lhip", "rhip")


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Rounding:
    """What the reference rounds: each conv's operands (``operand``) and the
    MRF's pairwise responses (``response``); in a backward pass, the
    gradient of each detector conv's output (``grad``) and of the MRF's
    responses (``response_grad``), as the backward convs read them."""

    def __init__(self, operand=identity, response=identity, grad=identity,
                 response_grad=identity):
        self.operand, self.response = operand, response
        self.grad, self.response_grad = grad, response_grad


FP32 = Rounding()


@contextlib.contextmanager
def fp32_mode():
    """TF32 off for cuDNN's convolutions and for matmuls, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def trunk_names(det: dict) -> tuple[str, str | None]:
    if det["share_trunk"]:
        return "trunk", "trunk" if det["multires"] else None
    return "trunk_full", "trunk_half" if det["multires"] else None


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter, in the order they are drawn."""
    det = cfg["detector"]
    k = det["trunk_kernel"]
    shapes: dict[str, tuple[int, ...]] = {}
    full, half = trunk_names(det)
    for trunk in dict.fromkeys([full, half]):
        if trunk is None:
            continue
        cin = 3
        for i, cout in enumerate(det["trunk_features"]):
            shapes[f"detector.{trunk}.conv{i}.weight"] = (cout, cin, k, k)
            shapes[f"detector.{trunk}.conv{i}.bias"] = (cout,)
            cin = cout
    hk = det["head_kernel"]
    heads = det["head_features"]
    shapes["detector.head_wide.weight"] = (heads[0], cin, hk, hk)
    shapes["detector.head_wide.bias"] = (heads[0],)
    c = heads[0]
    for i, cout in enumerate(heads[1:]):
        shapes[f"detector.head_1x1_{i}.weight"] = (cout, c, 1, 1)
        shapes[f"detector.head_1x1_{i}.bias"] = (cout,)
        c = cout
    shapes["detector.head_out.weight"] = (NUM_JOINTS, c, 1, 1)
    shapes["detector.head_out.bias"] = (NUM_JOINTS,)
    if cfg.get("mrf") is not None:
        wh, ww = cfg["mrf"]["window"]
        shapes["spatial_model.raw_kernels"] = (wh, ww, NUM_JOINTS, NUM_JOINTS)
        shapes["spatial_model.raw_bias"] = (NUM_JOINTS, NUM_JOINTS)
    return shapes


def same_pad(n: int, k: int, s: int = 1) -> tuple[int, int]:
    """(before, after) padding of a SAME window of extent k at stride s."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int = 1,
         groups: int = 1, quant=FP32) -> torch.Tensor:
    """SAME cross-correlation of NCHW x with OIHW w, fp32 result."""
    (pt, pb), (pl, pr) = same_pad(x.shape[2], w.shape[2], stride), same_pad(x.shape[3], w.shape[3], stride)
    y = quant.grad(F.conv2d(F.pad(quant.operand(x), (pl, pr, pt, pb)), quant.operand(w), None,
                            stride=stride, groups=groups))
    return y if b is None else y + b[None, :, None, None]


def trunk(params: dict, det: dict, name: str, x: torch.Tensor, quant=FP32) -> torch.Tensor:
    for i, pooled in enumerate(det["trunk_pool"]):
        stride = 2 if pooled and det["pool_mode"] == "stride" else 1
        x = F.relu(conv(x, params[f"detector.{name}.conv{i}.weight"],
                        params[f"detector.{name}.conv{i}.bias"], stride, quant=quant))
        if pooled and det["pool_mode"] == "max":
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
    return x


def detector_logits(params: dict, cfg: dict, images: torch.Tensor, quant=FP32) -> torch.Tensor:
    """uint8 or [0, 1] float (B, H, W, 3) images -> (B, Hm, Wm, K) fp32 logits."""
    det = cfg["detector"]
    x = images.float() / 255.0 if images.dtype == torch.uint8 else images.float()
    x = ((x - 0.5) * 2.0).permute(0, 3, 1, 2)
    full_name, half_name = trunk_names(det)
    feats = trunk(params, det, full_name, x, quant)
    if half_name is not None:
        b, c, h, w = x.shape
        half = x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
        g = trunk(params, det, half_name, half, quant)
        feats = feats + g.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    y = F.relu(conv(feats, params["detector.head_wide.weight"], params["detector.head_wide.bias"],
                    quant=quant))
    for i in range(len(det["head_features"]) - 1):
        y = F.relu(conv(y, params[f"detector.head_1x1_{i}.weight"],
                        params[f"detector.head_1x1_{i}.bias"], quant=quant))
    y = conv(y, params["detector.head_out.weight"], params["detector.head_out.bias"], quant=quant)
    return y.permute(0, 2, 3, 1)


def spatial_log_softmax(x: torch.Tensor) -> torch.Tensor:
    """log-softmax over the H, W axes of (B, H, W, K)."""
    b, h, w, k = x.shape
    return torch.log_softmax(x.float().reshape(b, h * w, k), dim=1).reshape(b, h, w, k)


def message_pass(p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float,
                 quant=FP32) -> torch.Tensor:
    """log p̄[b, y, x, a] = Σ_v log(max(Σ_{dy,dx} k[dy, dx, v, a] p[b, y+dy-c_y, x+dx-c_x, v]
    + bias[v, a], eps)), the window's centre c = (extent - 1) // 2, zero outside the map:
    all K² correlations as one grouped conv (group v holds the Ka kernels of source v)."""
    wh, ww, kv, ka = kernels.shape
    weight = kernels.permute(2, 3, 0, 1).reshape(kv * ka, 1, wh, ww)
    x = p.permute(0, 3, 1, 2)
    pad = ((ww - 1) // 2, ww // 2, (wh - 1) // 2, wh // 2)
    resp = quant.response(quant.response_grad(
        F.conv2d(F.pad(quant.operand(x), pad), quant.operand(weight), groups=kv)))  # (B, Kv*Ka, H, W)
    b, _, h, w = resp.shape
    resp = resp.reshape(b, kv, ka, h, w) + biases[None, :, :, None, None]
    return torch.log(resp.clamp_min(eps)).sum(dim=1).permute(0, 2, 3, 1)


def mrf_log_heatmaps(params: dict, cfg: dict, logits: torch.Tensor, quant=FP32) -> torch.Tensor:
    mrf = cfg["mrf"]
    p = torch.exp(spatial_log_softmax(logits)) if mrf["normalize_input"] else logits.clamp_min(0.0)
    kernels = F.softplus(params["spatial_model.raw_kernels"].float())
    biases = F.softplus(params["spatial_model.raw_bias"].float())
    eps, s = mrf["eps"], mrf["stride"]
    if s == 1:
        return message_pass(p, kernels, biases, eps, quant)
    b, h, w, k = p.shape
    pooled = p.reshape(b, h // s, s, w // s, s, k).sum(dim=(2, 4))
    coarse = message_pass(pooled, kernels, biases, eps, quant)
    up = F.interpolate(coarse.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1)
    return torch.log(p.clamp_min(eps)) + up


def forward(params: dict, cfg: dict, images: torch.Tensor, quant=FP32) -> dict:
    """The model's outputs: detector logits, and MRF log-heatmaps where the
    configuration has an MRF."""
    if cfg.get("eval_flip_tta"):
        raise NotImplementedError("flip test-time augmentation is not in the reference")
    logits = detector_logits(params, cfg, images, quant)
    out = {"detector_logits": logits}
    if cfg.get("mrf") is not None:
        out["mrf_log_heatmaps"] = mrf_log_heatmaps(params, cfg, logits, quant)
    return out


def log_probs(out: dict) -> torch.Tensor:
    """Per-joint log-probability heatmaps (B, H, W, K) of the final scores."""
    return spatial_log_softmax(out.get("mrf_log_heatmaps", out["detector_logits"]))


def refined_offsets(probs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, K, 2) refine offsets (x, y), in cells, that the decode adds
    if the argmax sits at each cell: the value-weighted centroid of the valid
    3x3 neighbours, floored at their minimum, clamped to [-1, 1], zero on an
    axis where the cell lies on that axis' border."""
    b, h, w, k = probs.shape
    x = probs.permute(0, 3, 1, 2).reshape(b * k, 1, h, w)
    ok = torch.ones_like(x)
    vals = F.unfold(F.pad(x, (1, 1, 1, 1)), 3).reshape(b * k, 9, h, w)
    valid = F.unfold(F.pad(ok, (1, 1, 1, 1)), 3).reshape(b * k, 9, h, w)
    center = vals[:, 4]
    m = torch.where(valid > 0, vals, center[:, None]).amin(dim=1)
    wgt = (vals - m[:, None]) * valid
    d = torch.tensor([-1.0, 0.0, 1.0], device=probs.device)
    dy, dx = d.repeat_interleave(3), d.repeat(3)
    den = wgt.sum(dim=1).clamp_min(1e-12)
    ox = ((wgt * dx[None, :, None, None]).sum(dim=1) / den).clamp(-1.0, 1.0)
    oy = ((wgt * dy[None, :, None, None]).sum(dim=1) / den).clamp(-1.0, 1.0)
    ys = torch.arange(h, device=probs.device)[:, None]
    xs = torch.arange(w, device=probs.device)[None, :]
    ox = ox * ((xs > 0) & (xs < w - 1))
    oy = oy * ((ys > 0) & (ys < h - 1))
    return torch.stack([ox, oy], dim=-1).reshape(b, k, h, w, 2).permute(0, 2, 3, 1, 4)


def cell_coords(probs: torch.Tensor, stride: int, refine: bool) -> torch.Tensor:
    """(B, H, W, K, 2) image coordinates (x, y) the decode would answer were
    the argmax at each cell: the cell centre j·s + (s-1)/2, plus the refine
    offset when the configuration refines."""
    b, h, w, k = probs.shape
    ys = torch.arange(h, dtype=torch.float32, device=probs.device)
    xs = torch.arange(w, dtype=torch.float32, device=probs.device)
    grid = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None]), dim=-1)  # (H, W, 2)
    cells = grid[None, :, :, None, :].expand(b, h, w, k, 2)
    if refine:
        cells = cells + refined_offsets(probs)
    return cells * stride + (stride - 1) / 2.0


def decode(probs: torch.Tensor, stride: int, refine: bool) -> torch.Tensor:
    """Argmax decode (the first maximum in row-major order), refined where
    asked: (B, H, W, K) -> (B, K, 2) image coordinates (x, y)."""
    b, h, w, k = probs.shape
    idx = probs.reshape(b, h * w, k).argmax(dim=1)  # (B, K)
    coords = cell_coords(probs, stride, refine).reshape(b, h * w, k, 2)
    return torch.gather(coords, 1, idx[:, None, :, None].expand(b, 1, k, 2))[:, 0]

