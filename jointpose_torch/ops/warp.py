"""Two-pass (shear) affine image warp (counterpart of ``jointpose/ops/warp_pallas.py``).

Any inverse affine ``src = A dst + b`` with a11 != 0 factors into

  1. an x-resample at fixed source row y:   u(xo; y) = α1·xo + s1·y + o1
       α1 = det(A)/a11,  s1 = a01/a11,  o1 = b0 − a01·b1/a11
  2. a y-resample at fixed output column:   v(yo; xo) = a11·yo + a10·xo + b1

and each pass is a 1-D linear resample with hat weights
``max(0, 1 − |i − pos|)``, zero outside the frame.  This is the classic
two-pass resampling of the affine: equal to single-pass bilinear for
axis-aligned maps, close to it under rotation.

``shear_warp`` (the reference's production orientation) and
``shear_warp_rowmajor`` (its cross-orientation oracle) both take and
return NHWC.  On CUDA tensors they launch the fused kernel of
``csrc/shear_warp.cu`` or raise; on CPU tensors they run the plain
version ``shear_warp_reference``, the dense-hat fp32 oracle.  Each is one
launch: a block per (image, strip of output columns) keeps the strip's
pass-1 intermediate in shared memory, (H, TW, C) for ``shear_warp`` and
(TW, H, C), the row-major orientation's own, for ``shear_warp_rowmajor``
(``strip_width`` is the shape rule of both).  ``shear_warp_strips``
repeats the kernel's arithmetic per strip in plain PyTorch, and the
kernel is bit-equal to it.  The kernel computes the two nonzero taps of
each hat in fp32; the TPU kernel applies the dense hat as a bf16 matmul.
"""

from __future__ import annotations

import ctypes

import torch

from jointpose_torch import _build, perf

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "shear_warp_fused": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "shear_warp_fused_rowmajor": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
# The fused kernel's strips: the widest of these whose (H, TW, C) fp32
# intermediate fits an eighth of that, so that eight blocks of 256 threads
# share an SM.  At the training shape (240 x 360 x 3, batch 32) widths 4, 8,
# 16, 32 and 64 took 0.0659, 0.0542, 0.0625, 0.0779 and 0.1142 ms on an
# H100 80GB HBM3 at 700 W (chip_smoke.py's sweep).
_STRIP_WIDTHS = (32, 16, 8, 4, 2, 1)
_STRIP_BUDGET = _SMEM_LIMIT // 8


def _pass_params(a_inv: torch.Tensor, b_inv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 3) (α, shear, offset) of the two passes, fp32 and elementwise."""
    a_inv, b_inv = a_inv.float(), b_inv.float()
    a00, a01 = a_inv[:, 0, 0], a_inv[:, 0, 1]
    a10, a11 = a_inv[:, 1, 0], a_inv[:, 1, 1]
    b0, b1 = b_inv[:, 0], b_inv[:, 1]
    det = a00 * a11 - a01 * a10
    p1 = torch.stack([det / a11, a01 / a11, b0 - a01 * b1 / a11], -1)
    p2 = torch.stack([a11, a10, b1], -1)
    return p1, p2


def _resample(src: torch.Tensor, par: torch.Tensor, s_out: int) -> torch.Tensor:
    """Plain pass over one image: (N, S_in, C) -> (N, S_out, C), dense hats."""
    n, s_in, _ = src.shape
    rows = torch.arange(n, dtype=torch.float32, device=src.device)
    outs = torch.arange(s_out, dtype=torch.float32, device=src.device)
    ins = torch.arange(s_in, dtype=torch.float32, device=src.device)
    pos = par[0] * outs[None, :] + par[1] * rows[:, None] + par[2]
    wmat = (1.0 - (ins[None, None, :] - pos[..., None]).abs()).clamp_min(0.0)
    return torch.einsum("noi,nic->noc", wmat, src)


def shear_warp_reference(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor) -> torch.Tensor:
    """Plain version: warp (B, H, W, C) images by src = A_inv dst + b_inv,
    both passes as dense (S_out, S_in) hat matmuls in fp32, one image at a
    time.  On the card the caller keeps TF32 matmuls off."""
    h, w = images.shape[1], images.shape[2]
    p1, p2 = _pass_params(a_inv, b_inv)
    out = []
    for img, q1, q2 in zip(images.float(), p1, p2):
        t1 = _resample(img, q1, w)  # rows y -> (Y, Xo, C)
        out.append(_resample(t1.transpose(0, 1), q2, h).transpose(0, 1))  # (Yo, Xo, C)
    return torch.stack(out)


def strip_width(h: int, c: int) -> int:
    """Columns per strip of the fused warp for (H, C) images: a rule on the
    shape.  The widest of ``_STRIP_WIDTHS`` whose intermediate H·TW·C·4
    bytes fits ``_STRIP_BUDGET``, else one column if it fits a block's
    shared memory at all; a taller image raises, naming the limit."""
    per_column = h * c * 4
    for tw in _STRIP_WIDTHS:
        if tw * per_column <= _STRIP_BUDGET:
            return tw
    if per_column <= _SMEM_LIMIT:
        return 1
    raise ValueError(
        f"shear_warp: a column of {h} rows x {c} channels needs {per_column} B of shared "
        f"memory, above the {_SMEM_LIMIT} B a block may use (at most "
        f"{_SMEM_LIMIT // (4 * c)} rows)")


def shear_warp_strips(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor,
                      tw: int | None = None, rowmajor: bool = False) -> torch.Tensor:
    """The fused kernel's arithmetic in plain PyTorch: each strip of ``tw``
    output columns (``strip_width`` by default) from its own pass-1
    intermediate over all rows, with the two taps of each hat gathered
    and weighted in fp32 as the kernel does.  ``rowmajor`` holds the
    intermediate as the row-major orientation does, a line over the rows
    per column, and runs pass 2 along those lines."""
    b, h, w, c = images.shape
    tw = strip_width(h, c) if tw is None else tw
    p1, p2 = _pass_params(a_inv, b_inv)
    images = images.float()
    out = torch.empty_like(images)
    rows = torch.arange(h, dtype=torch.float32, device=images.device)
    for x0 in range(0, w, tw):
        cols = torch.arange(x0, min(x0 + tw, w), dtype=torch.float32, device=images.device)
        # Pass 1: lines are source rows y, positions the strip's columns.
        t1 = _two_taps(images, p1, cols[None, :], rows[:, None], w, along=2)  # (B, H, nx, C)
        # Pass 2: lines are the strip's columns, positions the output rows.
        if rowmajor:
            lines = t1.transpose(1, 2).contiguous()  # (B, nx, H, C)
            t2 = _two_taps(lines, p2, rows[None, :], cols[:, None], h, along=2).transpose(1, 2)
        else:
            t2 = _two_taps(t1, p2, rows[:, None], cols[None, :], h, along=1)
        out[:, :, x0:x0 + len(cols)] = t2
    return out


def _two_taps(src, par, o, n, s_in: int, along: int) -> torch.Tensor:
    """Resample ``src`` along axis ``along`` (1: rows, 2: columns) at
    positions α·o + shear·n + off of each image, the grids ``o`` and ``n``
    broadcast to the output's (rows, columns); two fp32 hat taps each."""
    alpha, shear, off = (par[:, i, None, None] for i in range(3))
    pos = (alpha * o + shear * n) + off  # (B, rows, cols)
    inside = (pos > -1) & (pos < s_in)
    f0 = torch.where(inside, pos.floor(), torch.zeros_like(pos))
    i0 = f0.long()
    w0 = 1 - (pos - f0)
    w1 = 1 - ((f0 + 1) - pos).abs()

    def tap(i, ok, weight):
        idx = i.clamp(0, s_in - 1)
        bidx = torch.arange(src.shape[0], device=src.device)[:, None, None]
        if along == 2:
            v = src[bidx, torch.arange(src.shape[1], device=src.device)[None, :, None], idx]
        else:
            v = src[bidx, idx, torch.arange(idx.shape[2], device=src.device)[None, None, :]]
        return torch.where(ok[..., None], weight[..., None] * v, torch.zeros_like(v))

    acc = tap(i0, inside & (i0 >= 0), w0)
    return torch.where((inside & (i0 + 1 < s_in))[..., None], acc + tap(i0 + 1, inside, w1), acc)


def warp_cost(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor) -> tuple[int, int]:
    """(bytes, operations) of the warp's function: the images and the
    (B, 2, 2) and (B, 2) maps read once, the images written once; per
    output value and pass the position (4), the two tap weights (4) and
    the two products and their sum (3)."""
    return 2 * perf.nbytes(images) + perf.nbytes(a_inv, b_inv), 2 * images.numel() * 11


def _check(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor, what: str) -> None:
    if images.dim() != 4:
        raise ValueError(f"{what}: images must be (B, H, W, C), got {tuple(images.shape)}")
    if images.device.type != "cuda" or a_inv.device != images.device or b_inv.device != images.device:
        raise ValueError(f"{what}: images, a_inv and b_inv must lie on one CUDA device")
    if images.dtype != torch.float32:
        raise TypeError(f"{what}: images must be f32, got {images.dtype}")
    if not images.is_contiguous():
        raise ValueError(f"{what}: images must be contiguous")
    b = images.shape[0]
    if tuple(a_inv.shape) != (b, 2, 2) or tuple(b_inv.shape) != (b, 2):
        raise ValueError(f"{what}: a_inv must be ({b}, 2, 2) and b_inv ({b}, 2)")


def shear_warp(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) f32 images by src = A_inv dst + b_inv -> (B, H, W, C) f32.

    The reference's production orientation (x pass at fixed source row,
    then y pass at fixed output column), both passes in one launch of the
    fused kernel, strips of ``strip_width(H, C)`` columns.  The warp's
    parameters stay on the device.
    """
    if images.device.type == "cpu":
        return shear_warp_reference(images, a_inv, b_inv)
    _check(images, a_inv, b_inv, "shear_warp")
    out = _fused(images, a_inv, b_inv, strip_width(images.shape[1], images.shape[3]))
    shear_warp.launches += 1
    perf.count_kernel("shear_warp", warp_cost, images, a_inv, b_inv)
    return out


def _fused(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor, tw: int,
           entry: str = "shear_warp_fused") -> torch.Tensor:
    """One launch of a fused kernel (``entry``: ``shear_warp_fused`` or
    ``shear_warp_fused_rowmajor``) with strips of ``tw`` columns."""
    b, h, w, c = images.shape
    # The kernel derives the passes' parameters itself: one launch a call.
    a_inv, b_inv = a_inv.float().contiguous(), b_inv.float().contiguous()
    out = torch.empty_like(images)
    lib = _build.load("shear_warp", _SIGNATURES)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(images.data_ptr(), out.data_ptr(), a_inv.data_ptr(),
                                  b_inv.data_ptr(), b, h, w, c, tw, stream)
    _build.check(err, entry)
    return out


shear_warp.launches = 0


def shear_warp_rowmajor(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor) -> torch.Tensor:
    """The same warp in the reference's row-major orientation, in one
    launch of the fused kernel: each strip's pass-1 intermediate kept in
    shared memory as that orientation lays it out, (TW, H, C), a line per
    output column, and pass 2 run along those lines."""
    if images.device.type == "cpu":
        return shear_warp_reference(images, a_inv, b_inv)
    _check(images, a_inv, b_inv, "shear_warp_rowmajor")
    out = _fused(images, a_inv, b_inv, strip_width(images.shape[1], images.shape[3]),
                 "shear_warp_fused_rowmajor")
    shear_warp_rowmajor.launches += 1
    perf.count_kernel("shear_warp_rowmajor", warp_cost, images, a_inv, b_inv)
    return out


shear_warp_rowmajor.launches = 0
