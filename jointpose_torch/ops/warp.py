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
return NHWC.  On CUDA tensors they launch the kernel of
``csrc/shear_warp.cu`` twice, once per pass, or raise; on CPU tensors
they run the plain version ``shear_warp_reference``, the dense-hat fp32
oracle.  The kernel computes the two nonzero taps of each hat in fp32;
the TPU kernel applies the dense hat as a bf16 matmul.
"""

from __future__ import annotations

import ctypes

import torch

from jointpose_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {"shear_pass": ([_P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _STRIDES, _I, _P], _I)}
# Which axis neighbouring threads of the kernel walk, matched to the
# output's memory order: the lines n for an output whose n sits next to
# the channels, the positions o for a (B, N, C, S_out) output.
_LINES_FASTEST = 0
_POSITIONS_FASTEST = 1


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


def _pass(src, dst, pars, geometry, src_strides, dst_strides, order) -> None:
    """Launch one pass.  ``geometry`` is (B, lines, S_in, S_out, C); the
    strides are (b, n, x, c) in elements."""
    lib = _build.load("shear_warp", _SIGNATURES)
    ss = (ctypes.c_longlong * 4)(*src_strides)
    ds = (ctypes.c_longlong * 4)(*dst_strides)
    pars = pars.contiguous()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.shear_pass(
            src.data_ptr(), dst.data_ptr(), pars.data_ptr(), *geometry, ss, ds, order, stream,
        )
    _build.check(err, "shear_pass")


def shear_warp(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) f32 images by src = A_inv dst + b_inv -> (B, H, W, C) f32.

    The reference's production orientation: the intermediate is
    channel-major per source row, (B, H, C, Xo).  Pass 1 reads the NHWC
    input directly; pass 2 reads the intermediate along y and writes NHWC.
    """
    if images.device.type == "cpu":
        return shear_warp_reference(images, a_inv, b_inv)
    _check(images, a_inv, b_inv, "shear_warp")
    b, h, w, c = images.shape
    p1, p2 = _pass_params(a_inv, b_inv)
    t1 = torch.empty((b, h, c, w), dtype=torch.float32, device=images.device)
    _pass(images, t1, p1, (b, h, w, w, c), (h * w * c, w * c, c, 1), (h * c * w, c * w, 1, w),
          _POSITIONS_FASTEST)
    out = torch.empty_like(images)
    _pass(t1, out, p2, (b, w, h, h, c), (h * c * w, 1, c * w, w), (h * w * c, c, w * c, 1),
          _LINES_FASTEST)
    shear_warp.launches += 2
    return out


shear_warp.launches = 0


def shear_warp_rowmajor(images: torch.Tensor, a_inv: torch.Tensor, b_inv: torch.Tensor) -> torch.Tensor:
    """The same warp in the reference's row-major orientation: pass 1 maps
    (B, H, W, C) to (B, Xo, H, C), pass 2 maps that to (B, Yo, Xo, C)."""
    if images.device.type == "cpu":
        return shear_warp_reference(images, a_inv, b_inv)
    _check(images, a_inv, b_inv, "shear_warp_rowmajor")
    b, h, w, c = images.shape
    p1, p2 = _pass_params(a_inv, b_inv)
    t1 = torch.empty((b, w, h, c), dtype=torch.float32, device=images.device)
    _pass(images, t1, p1, (b, h, w, w, c), (h * w * c, w * c, c, 1), (w * h * c, c, h * c, 1),
          _LINES_FASTEST)
    out = torch.empty_like(images)
    _pass(t1, out, p2, (b, w, h, h, c), (w * h * c, h * c, c, 1), (h * w * c, c, w * c, 1),
          _LINES_FASTEST)
    shear_warp_rowmajor.launches += 2
    return out


shear_warp_rowmajor.launches = 0
