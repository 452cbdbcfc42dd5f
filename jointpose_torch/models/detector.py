"""Fully-convolutional part detector (counterpart of ``jointpose/models/detector.py``).

- a trunk of (conv k×k -> ReLU -> optional 2×2 pool) stages, or stride-2
  convs in place of the pools (``pool_mode='stride'``);
- optionally a half-resolution branch on the 2×2 average pyramid, whose
  features are nearest-upsampled and summed with the full-res ones;
- the wide head conv, direct or in Fourier space (``head_conv_impl``),
  then 1×1 convs down to K heatmap logits.

Internally NCHW; the public ``Detector.forward`` takes NHWC images and
returns (B, H/stride, W/stride, K) fp32 logits, as the reference does.
Parameters are fp32 and cast to the compute dtype at each conv.

Spatial parallelism (``spatial=True`` with a mesh whose 'model' axis is
larger than 1): the trunk runs on this rank's image rows, each conv's rows
padded by a halo exchange (``parallel/spatial.py``) and its columns by
SAME; the fused features are gathered by rows before the head.
``spatial_features`` runs the same trunk over the devices of one process.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jointpose_torch.configs import DetectorConfig
from jointpose_torch.ops.fft_conv import FFTConv
from jointpose_torch.ops.mrf_xla import same_pad
from jointpose_torch.ops.wide_conv import takes_wide_route, wide_conv
from jointpose_torch.parallel.mesh import param_shardings
from jointpose_torch.parallel.mrf_tp import enter_model_region, leave_model_region, model_slice
from jointpose_torch.parallel.spatial import ProcessRows, halo_rows


def resolve_head_conv_impl(cfg: DetectorConfig) -> str:
    """Resolve ``head_conv_impl`` for the port.

    'auto' resolves to 'direct': the reference's rule is a roofline
    calibrated for the TPU, and on the H100 the Fourier head's first
    kernels are slower than cuDNN's direct conv (PERF.md).  'fft' is the
    Fourier head conv of ``ops/fft_conv.py``.
    """
    if cfg.head_conv_impl in ("auto", "direct"):
        return "direct"
    if cfg.head_conv_impl == "fft":
        return "fft"
    raise ValueError(f"unknown head_conv_impl {cfg.head_conv_impl!r}")


class Conv(nn.Module):
    """k×k SAME conv with fp32 parameters, run in the input's dtype.

    The parameters are left uninitialized: a model gets its weights from
    ``load_state_dict`` (``predict.init_state_dict`` or
    ``convert.params_from_flax``).  A stride-1 kernel of 7 or wider takes
    its weight gradient on the card from ``ops/wide_conv.py``.
    """

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))
        self.kernel = kernel
        self.stride = stride

    def forward(self, x: torch.Tensor, rows_padded: bool = False) -> torch.Tensor:
        return self.conv(x, self.weight, self.bias, rows_padded)

    def conv(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
             rows_padded: bool = False) -> torch.Tensor:
        """The conv with given parameters (a channel slice of the module's,
        under tensor parallelism); no bias for ``bias=None``.  With
        ``rows_padded`` the rows of ``x`` already hold their halos and only
        the columns are padded."""
        h, w = x.shape[-2:]
        ht, hb = (0, 0) if rows_padded else same_pad(h, self.kernel, self.stride)
        wl, wr = same_pad(w, self.kernel, self.stride)
        w_ = weight.to(x.dtype)
        b_ = None if bias is None else bias.to(x.dtype)
        padding = (ht, wl)
        if ht != hb or wl != wr:
            # Asymmetric SAME padding, e.g. (1, 2) for a stride-2 5×5 conv on
            # an even input: F.conv2d's symmetric padding would shift the grid.
            x, padding = F.pad(x, (wl, wr, ht, hb)), (0, 0)
        if takes_wide_route(x, w_, self.stride):
            return wide_conv(x, w_, b_, padding)
        return F.conv2d(x, w_, b_, stride=self.stride, padding=padding)


def _pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 max pool with SAME padding (an odd edge keeps its last row/col)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _avg_pyramid(x: torch.Tensor) -> torch.Tensor:
    """Half-resolution pyramid level: 2×2 mean of an NCHW map with even H, W."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× spatial upsample of an NCHW map."""
    b, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2)
    return x.reshape(b, c, h * 2, w * 2)


class Trunk(nn.Module):
    """Conv/pool feature trunk, reused across pyramid levels."""

    def __init__(self, cfg: DetectorConfig, cin: int = 3):
        super().__init__()
        if cfg.pool_mode not in ("max", "stride"):
            raise ValueError(f"unknown pool_mode {cfg.pool_mode!r}")
        self.stride_conv = cfg.pool_mode == "stride"
        self.pooled = tuple(cfg.trunk_pool)
        for i, feats in enumerate(cfg.trunk_features):
            stride = 2 if (self.pooled[i] and self.stride_conv) else 1
            self.add_module(f"conv{i}", Conv(cin, feats, cfg.trunk_kernel, stride))
            cin = feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, pooled in enumerate(self.pooled):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if pooled and not self.stride_conv:
                x = _pool2x2(x)
        return x

    @staticmethod
    def forward_rows(trunks: list["Trunk"], shards: list[torch.Tensor], rows,
                     height: int) -> list[torch.Tensor]:
        """The trunk on row shards of a map ``height`` rows tall: shard j
        through ``trunks[j]`` (the same weights, on its device), each conv's
        halos exchanged by ``rows`` (``parallel/spatial.py``)."""
        first = trunks[0]
        for i, pooled in enumerate(first.pooled):
            conv = getattr(first, f"conv{i}")
            shards = rows.halo(shards, *halo_rows(height, conv.kernel, conv.stride))
            shards = [F.relu(getattr(t, f"conv{i}")(s, rows_padded=True))
                      for t, s in zip(trunks, shards)]
            height = -(-height // conv.stride)
            if pooled and not first.stride_conv:
                shards = [_pool2x2(s) for s in shards]
                height = -(-height // 2)
        return shards


class Detector(nn.Module):
    """Multi-resolution fully-convolutional part detector.

    Input:  (B, H, W, 3) images in [0, 1], cast to the compute dtype here.
    Output: (B, H/stride, W/stride, K) float32 heatmap logits.
    """

    def __init__(self, cfg: DetectorConfig, num_joints: int, dtype: torch.dtype = torch.float32,
                 mesh=None, spatial: bool = False):
        super().__init__()
        if spatial and mesh is None:
            raise ValueError("spatial parallelism needs a mesh whose 'model' axis takes the rows")
        head_conv = FFTConv if resolve_head_conv_impl(cfg) == "fft" else Conv
        self.config = cfg
        self.dtype = dtype
        self.mesh = mesh
        self.spatial = spatial
        if cfg.share_trunk:
            self.trunk = Trunk(cfg)
        else:
            self.trunk_full = Trunk(cfg)
            if cfg.multires:
                self.trunk_half = Trunk(cfg)
        c = cfg.trunk_features[-1]
        self.head_wide = head_conv(c, cfg.head_features[0], cfg.head_kernel)
        c = cfg.head_features[0]
        self.n_1x1 = len(cfg.head_features) - 1
        for i, feats in enumerate(cfg.head_features[1:]):
            self.add_module(f"head_1x1_{i}", Conv(c, feats, 1))
            c = feats
        self.head_out = Conv(c, num_joints, 1)
        # Head-channel tensor parallelism over 'model': head_wide computes
        # the output-channel slice and head_1x1_0 the input-channel slice
        # that param_shardings names.
        rules = {} if mesh is None else param_shardings(self, mesh)
        self.head_tp = rules.get("head_wide.weight") is not None
        if self.head_tp and self.n_1x1 == 0:
            raise NotImplementedError(
                "head-channel tensor parallelism of a head without a 1x1 conv after its wide "
                "conv: not ported (every preset has one)")

    @staticmethod
    def stride(cfg: DetectorConfig) -> int:
        return 2 ** sum(cfg.trunk_pool)

    @staticmethod
    def alignment(cfg: DetectorConfig) -> int:
        """What the image's height and width must divide by: the heatmap
        stride, twice that with the half-resolution branch."""
        stride = Detector.stride(cfg)
        return stride * 2 if cfg.multires else stride

    def trunks(self) -> tuple[str, str | None]:
        """Names of the full-resolution and half-resolution trunks (None
        without multires)."""
        cfg = self.config
        if cfg.share_trunk:
            return "trunk", "trunk" if cfg.multires else None
        return "trunk_full", "trunk_half" if cfg.multires else None

    def normalized(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images in [0, 1] -> NCHW in [-1, 1], compute dtype."""
        cfg = self.config
        need = Detector.alignment(cfg)
        h, w = images.shape[1], images.shape[2]
        if h % need or w % need:
            raise ValueError(
                f"input {h}x{w} must be divisible by {need} "
                f"(heatmap stride {Detector.stride(cfg)}{', multires' if cfg.multires else ''})"
            )
        x = (images.to(self.dtype) - 0.5) * 2.0
        return x.permute(0, 3, 1, 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.normalized(images)
        if self.spatial:
            full = spatial_features([self], x, ProcessRows(self.mesh))
        else:
            name_full, name_half = self.trunks()
            full = getattr(self, name_full)(x)
            if name_half is not None:
                full = full + _upsample2x(getattr(self, name_half)(_avg_pyramid(x)))
        return self.head(full)

    def head(self, full: torch.Tensor) -> torch.Tensor:
        """The fused NCHW trunk features -> (B, Hm, Wm, K) fp32 logits."""
        if self.head_tp:
            y, first = self._head_tp(full), 1
        else:
            y, first = F.relu(self.head_wide(full)), 0
        for i in range(first, self.n_1x1):
            y = F.relu(getattr(self, f"head_1x1_{i}")(y))
        logits = self.head_out(y)
        return logits.float().permute(0, 2, 3, 1)

    def _head_tp(self, full: torch.Tensor) -> torch.Tensor:
        """relu(head_1x1_0(relu(head_wide(full)))) with this rank's channel
        slice: the wide conv's output channels, the 1x1 conv's input
        channels, summed in fp32 over 'model' before the bias, which is
        added once."""
        sl = model_slice(self.config.head_features[0], self.mesh)
        wide, proj = self.head_wide, self.head_1x1_0
        x = enter_model_region(full, self.mesh)
        y = F.relu(wide.conv(x, wide.weight[sl], wide.bias[sl]))
        # The products of compute-dtype values summed in fp32, as the
        # unsliced conv accumulates them.
        part = F.conv2d(y.float(), proj.weight[:, sl].to(y.dtype).float())
        z = leave_model_region(part, self.mesh) + proj.bias.to(y.dtype).float()[:, None, None]
        return F.relu(z.to(y.dtype))


def spatial_features(detectors: list[Detector], x: torch.Tensor, rows) -> torch.Tensor:
    """The fused trunk features of the normalized NCHW images ``x`` with
    their rows split over ``rows``' shards (``parallel/spatial.py``: one
    per process, or one per device through ``detectors[j]``, the same
    weights on shard j's device), gathered by rows: the full-height map.
    The rows must divide by the stride alignment times the shards."""
    need = Detector.alignment(detectors[0].config)
    h = x.shape[2]
    if h % (need * rows.n):
        raise ValueError(
            f"spatial sharding needs rows {h} divisible by "
            f"{need * rows.n} (stride alignment x {rows.n} shards)"
        )
    shards = rows.split(x)
    name_full, name_half = detectors[0].trunks()
    full = Trunk.forward_rows([getattr(d, name_full) for d in detectors], shards, rows, h)
    if name_half is not None:
        half = Trunk.forward_rows([getattr(d, name_half) for d in detectors],
                                  [_avg_pyramid(s) for s in shards], rows, h // 2)
        full = [f + _upsample2x(g) for f, g in zip(full, half)]
    return rows.gather(full)
