"""MRF spatial model (counterpart of ``jointpose/models/mrf.py``).

Softplus-parameterized kernels and biases around the log-space message
pass; the raw parameters can be set to softplus^-1(prior) so the first
forward pass reproduces the empirical pairwise priors.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from jointpose_torch.configs import MRFConfig
from jointpose_torch.ops.mrf_xla import mrf_message_pass_coarse, mrf_message_pass_xla
from jointpose_torch.parallel.mrf_tp import mrf_message_pass_tp


def inverse_softplus(y, floor: float = 1e-8) -> torch.Tensor:
    """x such that softplus(x) = y (y > 0), fp32-safe in both regimes."""
    y = torch.as_tensor(y, dtype=torch.float32).clamp_min(floor)
    small = torch.log(torch.expm1(y.clamp_max(15.0)))
    return torch.where(y < 15.0, small, y)


def uniform_kernel_init(window: tuple[int, int], num_joints: int) -> torch.Tensor:
    """Raw-parameter init giving a uniform positive kernel (pre-softplus)."""
    wh, ww = window
    val = inverse_softplus(1.0 / (wh * ww))
    return torch.full((wh, ww, num_joints, num_joints), float(val), dtype=torch.float32)


def priors_to_raw_kernels(priors, blend: float = 0.5) -> torch.Tensor:
    """Normalized prior maps (wh, ww, K, K) -> raw kernel params, blended
    with a uniform floor so no displacement starts at zero probability."""
    priors = torch.as_tensor(priors, dtype=torch.float32)
    wh, ww = priors.shape[0], priors.shape[1]
    uniform = 1.0 / (wh * ww)
    return inverse_softplus(blend * priors + (1.0 - blend) * uniform)


# Below this tap count the direct grouped conv beats the Fourier path's
# fixed transform cost (the reference's rule, kept as is).
_FFT_MIN_TAPS = 512


def select_impl(config: MRFConfig) -> str:
    """Resolve MRFConfig.impl='auto' to a concrete message-pass impl:
    'fft' for stride-1 windows of at least 512 taps, else 'xla'."""
    if config.impl != "auto":
        if config.impl not in ("xla", "pallas", "fft"):
            raise ValueError(f"unknown MRF impl {config.impl!r}")
        return config.impl
    wh, ww = config.window
    if config.stride == 1 and wh * ww >= _FFT_MIN_TAPS:
        return "fft"
    return "xla"


def message_pass_fn(config: MRFConfig):
    """The message-pass function the config selects.

    'fft' with ``use_pallas`` runs the fused Fourier tail kernel, 'pallas'
    the direct conv with the fused epilogue kernel; the names follow the
    reference's config values.
    """
    impl = select_impl(config)
    if impl == "fft":
        if config.use_pallas:
            from jointpose_torch.ops.mrf_fft_fused import mrf_message_pass_fft_fused

            return mrf_message_pass_fft_fused
        from jointpose_torch.ops.mrf_fft import mrf_message_pass_fft

        return mrf_message_pass_fft
    if impl == "pallas":
        from jointpose_torch.ops.mrf_epilogue import mrf_message_pass_pallas

        return mrf_message_pass_pallas
    return mrf_message_pass_xla


class SpatialModel(nn.Module):
    """Learned MRF over joint heatmaps.

    Input:  (B, Hm, Wm, K) normalized unary heatmaps.
    Output: (B, Hm, Wm, K) unnormalized log p̄ in fp32.
    """

    def __init__(self, config: MRFConfig, num_joints: int, dtype: torch.dtype = torch.float32,
                 mesh=None):
        super().__init__()
        if config.precision not in ("high", "default"):
            raise ValueError(f"unknown MRF precision {config.precision!r}")
        self.config = config
        self.dtype = dtype
        self.pass_fn = message_pass_fn(config)
        # Source-joint tensor parallelism over 'model' (parallel/mrf_tp.py):
        # the coarse pass wraps the sliced pass, not the reverse.
        self.tp = mesh is not None and mesh.shape["model"] > 1
        if self.tp:
            self.pass_fn = functools.partial(mrf_message_pass_tp, mesh=mesh, base_pass=self.pass_fn)
        wh, ww = config.window
        k = num_joints
        self.raw_kernels = nn.Parameter(uniform_kernel_init((wh, ww), k))
        self.raw_bias = nn.Parameter(
            torch.full((k, k), float(inverse_softplus(1e-4)), dtype=torch.float32)
        )

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        # Softplus in fp32, then kernels cast to the compute dtype; biases
        # stay fp32 (the reference's casts).
        kernels = F.softplus(self.raw_kernels.float()).to(self.dtype)
        biases = F.softplus(self.raw_bias.float())
        p = p.to(self.dtype)
        # The reference's mapping: 'high' passes None (each pass's own
        # default, HIGH on the Fourier paths), 'default' one reduced-precision
        # pass where a pass has one (the Fourier paths on the card).
        prec = {"high": None, "default": "default"}[self.config.precision]
        if self.config.stride > 1:
            return mrf_message_pass_coarse(
                p, kernels, biases, eps=self.config.eps,
                stride=self.config.stride, message_pass=self.pass_fn, precision=prec,
            )
        return self.pass_fn(p, kernels, biases, eps=self.config.eps, precision=prec)
