"""The lower-precision control: the reference with each precision the
configurations state lowered one step, as a faster path of the program
would lower it.  The detector's convs run in bfloat16 there: their
operands (activations, weights; and the MRF's unaries and kernels, cast to
the compute type too) are rounded to fp8 (e4m3) with a per-tensor scale.
The MRF's pairwise products run at one TF32 pass (precision 'default'):
its responses are rounded to bfloat16.  A training step's backward convs
read their gradients one step lower too: the gradient of each detector
conv's output in fp8 (e4m3, per-tensor scale), of the MRF's responses in
bfloat16.  Sums stay fp32.
"""

from __future__ import annotations

import torch

from benchmark.reference.model import Rounding

FP8_MAX = 448.0


class _Round(torch.autograd.Function):
    """A rounding with a straight-through gradient, so that the control can
    also train."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


CONTROL = Rounding(operand=lambda x: _Round.apply(x, _fp8),
                   response=lambda x: _Round.apply(x, _bf16),
                   grad=lambda x: _RoundGrad.apply(x, _fp8),
                   response_grad=lambda x: _RoundGrad.apply(x, _bf16))
