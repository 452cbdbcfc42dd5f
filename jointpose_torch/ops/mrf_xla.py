"""MRF log-space message pass, direct-conv forward (``jointpose/ops/mrf_xla.py``).

    log p̄_A = Σ_v log( k_{A|v} ⊛ p_v + b_{v→A} )

All K^2 pairwise correlations run as one grouped ``F.conv2d``
(``groups=Kv``); output channel v*Ka + a is k_{a|v} ⊛ p_v.  The
correlation is the reference's SAME cross-correlation: a window of
extent k is padded (k-1)//2 before and k//2 after.

``precision`` is taken and passed down as the reference does, and
changes nothing here: the reference's None and ``Precision.DEFAULT``
both leave its direct conv at the backend's default
(``jointpose/ops/mrf_xla.py:196-197``), and the port's conv runs at
PyTorch's (cuDNN's TF32 flag) for either value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jointpose_torch.ops.mrf_fft import single_pass


def same_pad(n: int, k: int, s: int = 1) -> tuple[int, int]:
    """(before, after) padding of a SAME window: the reference's convention."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pairwise_conv(
    p: torch.Tensor, kernels: torch.Tensor, out_dtype: torch.dtype | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """All Kv*Ka pairwise correlations as one grouped conv.

    Args:
      p: (B, H, W, Kv) unary heatmaps.
      kernels: (wh, ww, Kv, Ka); kernels[:, :, v, a] is k_{a|v}.
      out_dtype: float32 computes in fp32 whatever p's dtype (the
        reference's fp32-accumulator output); None keeps p's dtype.
      precision: None, 'high' or 'default', all the backend's default.
    Returns:
      (B, H, W, Kv, Ka) responses, contiguous (one row of Kv*Ka per pixel).
    """
    wh, ww, kv, ka = kernels.shape
    b, h, w, _ = p.shape
    single_pass(precision)  # validates the value
    if p.shape[-1] != kv:
        raise ValueError(f"p {tuple(p.shape)} does not match kernels {tuple(kernels.shape)}")
    dtype = torch.float32 if out_dtype == torch.float32 else p.dtype
    # (o = v*Ka + a, 1, wh, ww): group v holds the Ka kernels of source v.
    weight = kernels.to(dtype).permute(2, 3, 0, 1).reshape(kv * ka, 1, wh, ww)
    # An NHWC tensor viewed as NCHW is channels_last in memory, so the conv
    # writes channels_last too and the permute back below is free.
    x = p.to(dtype).permute(0, 3, 1, 2)
    (ht, hb), (wl, wr) = same_pad(h, wh), same_pad(w, ww)
    if ht == hb and wl == wr:
        resp = F.conv2d(x, weight, padding=(ht, wl), groups=kv)
    else:
        resp = F.conv2d(F.pad(x, (wl, wr, ht, hb)), weight, groups=kv)
    return resp.permute(0, 2, 3, 1).contiguous().reshape(b, h, w, kv, ka)


def mrf_message_pass_xla(
    p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6,
    precision: str | None = None,
) -> torch.Tensor:
    """Log-space message pass; returns unnormalized log p̄ (B, H, W, K) fp32."""
    resp = pairwise_conv(p, kernels, out_dtype=torch.float32, precision=precision)
    resp = resp + biases.float()
    return torch.log(resp.clamp_min(eps)).sum(dim=-2)


def mrf_message_pass_coarse(
    p: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    eps: float = 1e-6,
    stride: int = 2,
    message_pass=None,
    precision: str | None = None,
) -> torch.Tensor:
    """Coarse message pass (MRFConfig.stride > 1):

        log p̄_A = log p_A  +  up( Σ_v log( k_{A|v} ⊛ pool(p)_v + b ) )

    with a sum-pool to the coarse grid and a bilinear (half-pixel) upsample
    back.  Returns (B, H, W, K) fp32.
    """
    b, h, w, k = p.shape
    if h % stride or w % stride:
        raise ValueError(f"p {tuple(p.shape)} is not divisible by stride {stride}")
    pc = p.reshape(b, h // stride, stride, w // stride, stride, k).sum(dim=(2, 4))
    pass_fn = message_pass or mrf_message_pass_xla
    coarse = pass_fn(pc, kernels, biases, eps=eps, precision=precision)
    up = F.interpolate(
        coarse.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)
    unary = torch.log(p.float().clamp_min(eps))
    return unary + up


def mrf_message_pass_direct(
    p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6,
    precision: str | None = None,
) -> torch.Tensor:
    """Direct-space oracle: log Π_v max(k⊛p_v + b, eps), for tests.

    Mathematically the log-space pass of ``mrf_message_pass_xla``; the
    product underflows for large K, which is why the model sums logs.
    """
    resp = pairwise_conv(p, kernels, precision=precision).float()
    return torch.log((resp + biases.float()).clamp_min(eps).prod(dim=-2))
