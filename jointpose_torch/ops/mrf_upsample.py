"""The coarse MRF pass's last step, with its backward, on the card
(``csrc/mrf_upsample.cu``):

    out[b, y, x, k] = log(max(p[b, y, x, k], eps)) + up(coarse)[b, y, x, k]

``up`` is the bilinear upsample with half-pixel centres
(``F.interpolate(..., mode='bilinear', align_corners=False)``) of the
coarse log-message (B, Hc, Wc, K) fp32 to (B, s·Hc, s·Wc, K) for an
integer stride s; p (B, s·Hc, s·Wc, K) are the unaries in fp32, bf16 or
fp16; out is fp32.  It replaces no TPU kernel: the reference leaves this
step to XLA (``jointpose/ops/mrf_xla.py``, ``mrf_message_pass_coarse``).

``mrf_upsample_log`` runs the plain version ``mrf_upsample_log_plain``
(the composition of PyTorch ops the coarse pass ran before the kernel)
for CPU tensors, autograd giving its backward.  For CUDA tensors it is a
``torch.autograd.Function`` whose forward launches the forward kernel and
whose backward launches the backward kernel, or raises.  The backward
gathers each coarse gradient from the fine gradients whose taps reach it,
in a fixed order; ``dcoarse_emulated`` repeats its index and weight
arithmetic in plain PyTorch: fine rows s·(c-1) .. s·(c+2)-1 tried for
coarse row c, each with its two taps (``source_taps``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from jointpose_torch import _build, perf

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "mrf_upsample_log_fwd": ([_P, _P, _I, _P] + [_I] * 5 + [_F, _P], _I),
    "mrf_upsample_log_bwd": ([_P, _P, _I, _P, _P] + [_I] * 5 + [_F, _P], _I),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Flat indices are ints in the kernels, with a block's overrun beside them.
MAX_VALUES = 2**31 - 1 - 1024


def mrf_upsample_log_plain(coarse: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: log(max(p, eps)) in fp32 plus the bilinear upsample of
    ``coarse`` to p's height and width, (B, H, W, K) fp32."""
    h, w = p.shape[1], p.shape[2]
    up = F.interpolate(
        coarse.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)
    unary = torch.log(p.float().clamp_min(eps))
    return unary + up


def source_taps(n_out: int, n_in: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(i0, i1, l0, l1) of each output index along one axis, as the kernels
    (and PyTorch's half-pixel rule) take them: src = scale·(dst + 0.5) - 0.5
    in fp32 with scale = n_in / n_out, clamped at 0; i0 its integer part,
    i1 the next index or i0 at the last; l1 = src - i0, l0 = 1 - l1."""
    scale = torch.tensor(n_in, dtype=torch.float32) / n_out
    src = (scale * (torch.arange(n_out, dtype=torch.float32) + 0.5) - 0.5).clamp_min(0.0)
    i0 = src.to(torch.int64)
    i1 = i0 + (i0 < n_in - 1).to(torch.int64)
    l1 = src - i0.to(torch.float32)
    return i0, i1, 1.0 - l1, l1


def _gather_weights(n_in: int, stride: int) -> torch.Tensor:
    """(n_in, n_out, 2) fp32: [c, dst, t] is tap t's weight where that tap of
    fine index dst is coarse index c and dst is among the kernel's tried
    indices s·(c-1) .. s·(c+2)-1, else 0."""
    n_out = n_in * stride
    i0, i1, l0, l1 = source_taps(n_out, n_in)
    c = torch.arange(n_in)[:, None]
    dst = torch.arange(n_out)[None, :]
    tried = (dst >= stride * (c - 1)) & (dst < stride * (c + 2))
    return torch.stack([torch.where(tried & (i == c), l, 0.0) for i, l in ((i0, l0), (i1, l1))],
                       dim=-1)


def dcoarse_emulated(g: torch.Tensor, stride: int) -> torch.Tensor:
    """The backward kernel's coarse gradient in plain PyTorch: the same
    tried indices, taps and fp32 weights (h·w)·g, summed in float64 (the
    kernel sums in fp32, in its own order).  g (B, H, W, K) -> (B, H/s, W/s, K)."""
    _, h, w, _ = g.shape
    wy, wx = _gather_weights(h // stride, stride), _gather_weights(w // stride, stride)
    hw = wy[:, :, None, None, :, None] * wx[None, None, :, :, None, :]  # (hc, h, wc, w, 2, 2)
    return torch.einsum("cydxtu,byxk->bcdk", hw.double(), g.double())


def fwd_cost(coarse: torch.Tensor, p: torch.Tensor) -> tuple[int, int]:
    """(bytes, operations) of the forward's function: coarse and p read once,
    the fp32 output written once; per output six products and three sums of
    the taps, the clamp, the log and the add."""
    return perf.nbytes(coarse, p) + 4 * p.numel(), 12 * p.numel()


def bwd_cost(g: torch.Tensor, p: torch.Tensor, coarse_numel: int) -> tuple[int, int]:
    """(bytes, operations) of the backward's function: g and p read once,
    dcoarse (fp32) and dp (p's type) written once; per fine value its four
    taps' weight product, product and sum, the compare and the division."""
    return perf.nbytes(g, p, p) + 4 * coarse_numel, 14 * p.numel()


def _stride(coarse: torch.Tensor, p: torch.Tensor) -> int:
    """The integer stride s with p (B, s·Hc, s·Wc, K) over coarse (B, Hc, Wc, K); raises otherwise."""
    if coarse.dim() != 4 or p.dim() != 4:
        raise ValueError(f"mrf_upsample_log: coarse {tuple(coarse.shape)} and p "
                         f"{tuple(p.shape)} must both be (B, H, W, K)")
    b, hc, wc, k = coarse.shape
    s = p.shape[1] // hc if hc else 0
    if (p.shape[0], p.shape[3]) != (b, k) or s < 1 or tuple(p.shape[1:3]) != (s * hc, s * wc):
        raise ValueError(f"mrf_upsample_log: p {tuple(p.shape)} is not coarse "
                         f"{tuple(coarse.shape)} upsampled by one integer stride")
    return s


def _check(coarse: torch.Tensor, p: torch.Tensor) -> int:
    """Validates the kernels' operands; returns the stride."""
    s = _stride(coarse, p)
    if coarse.dtype != torch.float32 or p.dtype not in _DTYPES:
        raise TypeError(f"mrf_upsample_log: coarse must be fp32 and p fp32, bf16 or fp16, got "
                        f"{coarse.dtype} and {p.dtype}")
    if not (coarse.is_contiguous() and p.is_contiguous()):
        raise ValueError("mrf_upsample_log: coarse and p must be contiguous")
    if p.numel() > MAX_VALUES:
        raise ValueError(f"mrf_upsample_log: {p.numel()} values exceed the kernels' {MAX_VALUES}")
    if p.device.type != "cuda" or coarse.device != p.device:
        raise ValueError("mrf_upsample_log: coarse and p must lie on one CUDA device")
    return s


def mrf_upsample_log_fwd(coarse: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The forward kernel: (B, H, W, K) fp32, contiguous."""
    s = _check(coarse, p)
    b, hc, wc, k = coarse.shape
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    lib = _build.load("mrf_upsample", _SIGNATURES)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_upsample_log_fwd(coarse.data_ptr(), p.data_ptr(), _DTYPES[p.dtype],
                                       out.data_ptr(), b, hc, wc, k, s, eps, stream)
    _build.check(err, "mrf_upsample_log_fwd")
    mrf_upsample_log.launches += 1
    perf.count_kernel("mrf_upsample_log", fwd_cost, coarse, p)
    return out


def mrf_upsample_log_bwd(
    g: torch.Tensor, p: torch.Tensor, coarse_shape: tuple[int, ...], eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: (dcoarse fp32, dp in p's type) from the output's
    fp32 gradient ``g``."""
    dcoarse = torch.empty(coarse_shape, dtype=torch.float32, device=p.device)
    s = _check(dcoarse, p)
    if g.device != p.device or g.dtype != torch.float32 or g.shape != p.shape:
        raise ValueError(f"mrf_upsample_log_bwd: g must be fp32 {tuple(p.shape)} on p's device")
    g = g.contiguous()
    b, hc, wc, k = coarse_shape
    dp = torch.empty_like(p)
    lib = _build.load("mrf_upsample", _SIGNATURES)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_upsample_log_bwd(g.data_ptr(), p.data_ptr(), _DTYPES[p.dtype],
                                       dcoarse.data_ptr(), dp.data_ptr(), b, hc, wc, k, s, eps,
                                       stream)
    _build.check(err, "mrf_upsample_log_bwd")
    mrf_upsample_log_bwd.launches += 1
    perf.count_kernel("mrf_upsample_log_bwd", bwd_cost, g, p, dcoarse.numel())
    return dcoarse, dp


mrf_upsample_log_bwd.launches = 0


class _UpsampleLog(torch.autograd.Function):
    @staticmethod
    def forward(ctx, coarse, p, eps):
        ctx.eps, ctx.coarse_shape = eps, tuple(coarse.shape)
        ctx.save_for_backward(p)
        return mrf_upsample_log_fwd(coarse, p, eps)

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        dcoarse, dp = mrf_upsample_log_bwd(g.float(), p, ctx.coarse_shape, ctx.eps)
        return dcoarse, dp, None


def mrf_upsample_log(coarse: torch.Tensor, p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """log(max(p, eps)) + the bilinear upsample of ``coarse`` (B, Hc, Wc, K)
    fp32 to p's (B, s·Hc, s·Wc, K), fp32; differentiable in both."""
    if p.device.type == "cpu":
        _stride(coarse, p)
        return mrf_upsample_log_plain(coarse, p, eps)
    return _UpsampleLog.apply(coarse, p, eps)


mrf_upsample_log.launches = 0
