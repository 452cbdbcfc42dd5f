"""A stride-1 conv whose weight gradient is taken as matrix products.

On the H100, cuDNN has no tensor-core weight gradient for bf16 convs of 7x7
kernels or wider: it runs ``wgrad_alg1_engine``, at about 28 TFLOP/s, 65 ms
for ``joint``'s 9x9x128->512 head at batch 32 (its forward 3.4 ms, its
input gradient 2.7 ms), with ``cudnn.benchmark`` too.  ``wide_conv``
keeps cuDNN's forward, input and bias gradients and takes the weight
gradient as k x k products on the tensor cores (cuBLAS), with no copy of
the input per tap:

    dW[:, :, i, j] = G^T @ X[i*Wp + j : i*Wp + j + N]

X is the zero-padded input as (B*Hp*Wp, C) rows (NHWC), G the output
gradient on the same padded grid, (B*Hp*Wp, O), zero outside the output;
a tap's rows of X are then one contiguous slice, and the rows G leaves
zero at its end cover the largest shift.  A row of taps is one batched
product over its k shifts.  Each product sums its N rows in fp32 and
rounds once to the input's dtype, as cuDNN's bf16 weight gradient does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The narrowest kernel whose bf16 weight gradient cuDNN leaves to its
# CUDA-core engine on the H100 (5x5 takes a tensor-core kernel).
MIN_KERNEL = 7


def takes_wide_route(x: torch.Tensor, weight: torch.Tensor, stride: int) -> bool:
    """Whether a conv takes ``wide_conv``: on CUDA, in bf16 or fp16, stride
    1, a square kernel of ``MIN_KERNEL`` or more, with a weight gradient
    to take."""
    k = weight.shape[-1]
    return (k >= MIN_KERNEL and stride == 1 and weight.shape[-2] == k and x.is_cuda
            and x.dtype in (torch.bfloat16, torch.float16) and torch.is_grad_enabled()
            and weight.requires_grad)


def weight_grad(x: torch.Tensor, g: torch.Tensor, k: int, padding: tuple[int, int]) -> torch.Tensor:
    """dL/dW (O, C, k, k) of the stride-1 conv of ``x`` (B, C, H, W) padded
    by ``padding`` (rows, columns) on each side, from its output gradient
    ``g`` (B, O, H + 2*rows - k + 1, W + 2*cols - k + 1), in ``x``'s dtype."""
    b, c = x.shape[:2]
    o, ho, wo = g.shape[1:]
    ph, pw = padding
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))  # (B, Hp, Wp, C)
    hp, wp = xp.shape[1:3]
    if (ho, wo) != (hp - k + 1, wp - k + 1):
        raise ValueError(f"output gradient {tuple(g.shape)} does not match a {k}x{k} conv of "
                         f"{tuple(x.shape)} padded by {padding}")
    rows = xp.reshape(b * hp * wp, c)
    grid = F.pad(g.permute(0, 2, 3, 1).to(x.dtype), (0, 0, 0, wp - wo, 0, hp - ho))
    n = b * hp * wp - (k - 1) * (wp + 1)  # the rows every shift keeps in range
    gt = grid.reshape(b * hp * wp, o)[:n].t().expand(k, o, n)
    taps = []
    for i in range(k):  # the row's k shifts, each a contiguous (N, C) slice of X
        shifted = rows.as_strided((k, n, c), (c, c, 1), (i * wp) * c + rows.storage_offset())
        taps.append(torch.bmm(gt, shifted))  # (k, O, C)
    return torch.stack(taps, dim=0).permute(2, 3, 0, 1)  # (O, C, k, k)


class _WideConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding, ctx.has_bias = padding, bias is not None
        return F.conv2d(x, weight, bias, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        dx = db = dw = None
        if want_x or want_b:
            dx, _, db = torch.ops.aten.convolution_backward(
                g, x, weight, [weight.shape[0]] if ctx.has_bias else None, [1, 1],
                list(ctx.padding), [1, 1], False, [0, 0], 1, [want_x, False, want_b])
        if want_w:
            dw = weight_grad(x, g, weight.shape[-1], ctx.padding)
        return dx, dw, db, None


def wide_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
              padding: tuple[int, int]) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, padding=padding)`` (stride 1), its
    weight gradient by ``weight_grad``."""
    return _WideConv.apply(x, weight, bias, tuple(padding))
