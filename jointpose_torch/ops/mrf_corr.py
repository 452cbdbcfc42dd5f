"""The MRF's pairwise correlation with an fp32 result, on the card
(``csrc/mrf_grouped_corr.cu``): the forward of ``ops/mrf_xla.grouped_conv_f32``.

    out[b, y, x, v*Ka + a] = Σ_{dy,dx} p[b, y+dy-ht, x+dx-wl, v] · k[dy, dx, 0, v*Ka + a]

the reference's SAME grouped cross-correlation (``groups=Kv``, one input
channel a group), padded (k-1)//2 before and k//2 after on each axis, on
p (B, H, W, Kv) and HWIO kernels (wh, ww, 1, Kv*Ka) of one type, bf16 or
fp16, into (B, H, W, Kv*Ka) fp32.  It replaces no TPU kernel: the
reference leaves this conv to XLA (``jointpose/ops/mrf_xla.py``).

``mrf_grouped_corr`` launches the kernel for CUDA tensors, or raises; for
CPU tensors it runs the plain version ``mrf_grouped_corr_plain``, the fp32
grouped conv of ``ops/mrf_xla.grouped_conv``.  The kernel's tiles follow
``tiling``, a rule on the shape; ``mrf_grouped_corr_tiles`` repeats its
Toeplitz arithmetic in plain PyTorch: per tile of 8 output columns, the
16·KC input columns from x0 - wl times T[dy, k, x] = k[dy, k - x], zero
outside the window.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from jointpose_torch import _build, perf
from jointpose_torch.ops import mrf_xla

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mrf_grouped_corr": ([_P, _P, _P] + [_I] * 11 + [_P], _I),
}
TX = 8  # output columns a block: one n8 tile a target joint
NA = 9  # target joints a warp
MAX_WARPS = 9  # (source, chunk of targets) items a block, one a warp
MAX_CHUNKS = 4  # 16-column input chunks staged at once
# What a block stages at once (input tile and kernel rows): two blocks of
# nine warps share an SM's 228 KB.
STAGE_BUDGET = 113 * 1024


def chunks(ww: int) -> int:
    """16-column input chunks an 8-column output tile needs at window width ``ww``."""
    return -(-(ww + TX - 1) // 16)


def tiling(h: int, kv: int, ka: int, wh: int, ww: int) -> tuple[int, int, int]:
    """(mt, kcc, dyc) of the kernel at a shape: m16 tiles of output rows a
    warp (two where the image is taller than 16 rows, else one), and the
    input chunks and kernel rows staged at once: all of them where they fit
    ``STAGE_BUDGET``, else the kernel rows split evenly, then fewer chunks.
    Raises where Kv and Ka need more warps than a block has, or the
    smallest stage does not fit."""
    if kv * -(-ka // NA) > MAX_WARPS:
        raise ValueError(f"mrf_grouped_corr: Kv {kv} x ceil(Ka {ka} / {NA}) exceeds the "
                         f"{MAX_WARPS} warps of a block")
    mt = 2 if h > 16 else 1
    for kcc in range(min(chunks(ww), MAX_CHUNKS), 0, -1):
        for n in range(1, wh + 1):
            dyc = -(-wh // n)
            stage = 2 * (kv * (16 * mt + dyc - 1) * (16 * kcc + 8) + dyc * ww * kv * ka)
            if stage <= STAGE_BUDGET:
                return mt, kcc, dyc
    raise ValueError(f"mrf_grouped_corr: a {wh}x{ww} window over Kv {kv}, Ka {ka} does not fit "
                     f"{STAGE_BUDGET} B of shared memory one kernel row at a time")


def mrf_grouped_corr_plain(p: torch.Tensor, kern: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version: the fp32 grouped conv of these values, (B, H, W, Kv*Ka)."""
    return mrf_xla.grouped_conv(p, kern, groups, torch.float32)


def mrf_grouped_corr_tiles(p: torch.Tensor, kern: torch.Tensor, groups: int) -> torch.Tensor:
    """The kernel's Toeplitz form in plain fp32 PyTorch (module docstring)."""
    b, h, w, kv = p.shape
    wh, ww, _, kk = kern.shape
    ka, cols, tiles = kk // groups, 16 * chunks(ww), -(-w // TX)
    ht, wl = (wh - 1) // 2, (ww - 1) // 2
    dx = torch.arange(cols)[:, None] - torch.arange(TX)[None, :]  # (k, x)
    k4 = kern.float().reshape(wh, ww, kv, ka)
    toeplitz = torch.where(((dx >= 0) & (dx < ww))[None, :, :, None, None],
                           k4[:, dx.clamp(0, ww - 1)], 0.0)  # (dy, k, x, v, a)
    padded = F.pad(p.float(), (0, 0, wl, (tiles - 1) * TX + cols - w - wl, ht, wh - 1 - ht))
    out = 0.0
    for dy in range(wh):
        seg = padded[:, dy:dy + h].unfold(2, cols, TX)  # (b, h, tile, v, k)
        out = out + torch.einsum("bhtvk,kxva->bhtxva", seg, toeplitz[dy])
    return out.reshape(b, h, tiles * TX, kk)[:, :, :w]


def corr_cost(p: torch.Tensor, kern: torch.Tensor, groups: int) -> tuple[int, int]:
    """(bytes, operations) of the function: p and the kernels read once, the
    fp32 responses written once; two operations a tap of each response."""
    b, h, w, _ = p.shape
    wh, ww, _, kk = kern.shape
    responses = b * h * w * kk
    return perf.nbytes(p, kern) + 4 * responses, 2 * responses * wh * ww


def _check(p: torch.Tensor, kern: torch.Tensor, groups: int) -> None:
    if p.device.type != "cuda" or kern.device != p.device:
        raise ValueError("mrf_grouped_corr: p and the kernels must lie on one CUDA device")
    if p.dtype not in (torch.bfloat16, torch.float16) or kern.dtype != p.dtype:
        raise TypeError(f"mrf_grouped_corr: p and the kernels must both be bf16 or both fp16, "
                        f"got {p.dtype} and {kern.dtype}")
    if not (p.is_contiguous() and kern.is_contiguous()):
        raise ValueError("mrf_grouped_corr: p and the kernels must be contiguous")
    if (p.dim() != 4 or kern.dim() != 4 or kern.shape[2] != 1 or p.shape[3] != groups
            or kern.shape[3] % groups):
        raise ValueError(f"mrf_grouped_corr: p {tuple(p.shape)} and kernels "
                         f"{tuple(kern.shape)} are not (B, H, W, {groups}) and (wh, ww, 1, "
                         f"{groups}*Ka)")


def mrf_grouped_corr(p: torch.Tensor, kern: torch.Tensor, groups: int) -> torch.Tensor:
    """SAME grouped correlation of (B, H, W, Kv) ``p`` with HWIO ``kern``
    (wh, ww, 1, Kv*Ka), ``groups`` = Kv: (B, H, W, Kv*Ka) fp32, contiguous."""
    if p.device.type == "cpu":
        return mrf_grouped_corr_plain(p, kern, groups)
    _check(p, kern, groups)
    b, h, w, kv = p.shape
    wh, ww, _, kk = kern.shape
    mt, kcc, dyc = tiling(h, kv, kk // kv, wh, ww)
    out = torch.empty((b, h, w, kk), dtype=torch.float32, device=p.device)
    lib = _build.load("mrf_grouped_corr", _SIGNATURES)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_grouped_corr(p.data_ptr(), kern.data_ptr(), out.data_ptr(), b, h, w, kv,
                                   kk // kv, wh, ww, int(p.dtype == torch.float16), mt, kcc, dyc,
                                   stream)
    _build.check(err, "mrf_grouped_corr")
    mrf_grouped_corr.launches += 1
    perf.count_kernel("mrf_grouped_corr", corr_cost, p, kern, groups)
    return out


mrf_grouped_corr.launches = 0
