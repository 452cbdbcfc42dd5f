"""MRF pairwise correlation in Fourier space via DFT matmuls
(counterpart of ``jointpose/ops/mrf_fft.py``).

Linear correlation of H×W unaries with wh×ww kernels uses circular
transforms of size Ph = H+wh-1 by Pw = W+ww-1, keeping only the
G = Pw//2+1 independent column bins of the real inputs.  The forward
transforms contract over the unpadded rows/cols only; the inverse
operators evaluate exactly the SAME-crop output positions.

Every matmul runs at the precision its caller asks for, whatever the
process-wide TF32 flags say: ``precision`` None or ``'high'`` is fp32,
``'default'`` on a CUDA device one TF32 pass with fp32 accumulation
(the reference's ``Precision.DEFAULT``, one reduced-precision pass), in
the forward and in the backward alike.  On the CPU both are fp32, as JAX
computes ``DEFAULT`` there.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _dft_consts(
    hm: tuple[int, int], window: tuple[int, int], row_pad_to: int = 1
) -> dict[str, np.ndarray]:
    """Real/imag DFT operator tables for one (heatmap, window) geometry,
    half column spectrum (the reference's ``real_cols=True``).

    The inverse column operator carries the conjugate-pair weights (2 for
    interior bins, 1 for DC and, when Pw is even, Nyquist), so the half
    sum equals the full sum's real part exactly.  ``row_pad_to`` rounds
    the row transform size up to a multiple; a larger circular size keeps
    the linear correlation exact.
    """
    (h, w), (wh, ww) = hm, window
    ph, pw = h + wh - 1, w + ww - 1
    ph = -(-ph // row_pad_to) * row_pad_to
    ch, cw = (wh - 1) // 2, (ww - 1) // 2
    ncols = pw // 2 + 1

    def fwd(p: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        f = np.arange(p)[:, None] * np.arange(n)[None, :]
        ang = -2.0 * np.pi * f / p
        return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)

    def inv(n_out: int, p: int, shift: int) -> tuple[np.ndarray, np.ndarray]:
        f = (np.arange(n_out)[:, None] - shift) * np.arange(p)[None, :]
        ang = 2.0 * np.pi * f / p
        return (np.cos(ang) / p).astype(np.float32), (np.sin(ang) / p).astype(np.float32)

    fr, fc, gr, gc = fwd(ph, h), fwd(pw, w), fwd(ph, wh), fwd(pw, ww)
    ir, ic = inv(h, ph, ch), inv(w, pw, cw)
    alpha = np.full((ncols,), 2.0, np.float32)
    alpha[0] = 1.0
    if pw % 2 == 0:
        alpha[-1] = 1.0
    fc = (fc[0][:ncols], fc[1][:ncols])
    gc = (gc[0][:ncols], gc[1][:ncols])
    ic = (ic[0][:, :ncols] * alpha, ic[1][:, :ncols] * alpha)
    return {
        "fr_re": fr[0], "fr_im": fr[1],
        "fc_re": fc[0], "fc_im": fc[1],
        "gr_re": gr[0], "gr_im": gr[1],
        "gc_re": gc[0], "gc_im": gc[1],
        "ir_re": ir[0], "ir_im": ir[1],
        "ic_re": ic[0], "ic_im": ic[1],
    }


@functools.lru_cache(maxsize=16)
def dft_tables(
    hm: tuple[int, int],
    window: tuple[int, int],
    device: torch.device,
    row_pad_to: int = 1,
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """The DFT tables of one geometry as ``dtype`` tensors on ``device``
    (computed in fp32, then cast), copied there once per geometry, padding
    and dtype.  Callers must not write to them.

    Beside the reference's tables it holds the fused tail's operands:
    ``ir`` (H, Ph, 2) with (re, im) interleaved and ``ict_re``/``ict_im``
    (G, W), the inverse column operator transposed; and both inverse
    operators as real block matrices, the form in which the tail's two
    transforms are plain matrix products: ``ir_stack`` (2H, 2Ph) =
    [[ir_re, -ir_im], [ir_im, ir_re]], so that ir_stack @ [R_re; R_im] =
    [T_re; T_im] for T = Ir @ R, and ``ic_stack`` (2G, W) =
    [ict_re; -ict_im], so that [T_re, T_im] @ ic_stack = Re{T @ Ic^T}.

    In fp32 it also holds ``ir_img`` and ``ic_img``, those two rounded to
    TF32 and laid out as the single-pass tail's tensor cores read them
    (``tail_table_images``), and the forward column operators with their G
    bins zero-padded to a multiple of 8 (``fc_re8`` ... ``gc_im8``), from
    which ``forward_ffts(padded_bins=True)`` makes spectra whose rows start
    on 32-byte boundaries.

    Built outside inference mode whatever the caller's mode: a table first
    made while serving is then still usable by a training step's autograd.
    """
    c = _dft_consts(hm, window, row_pad_to)
    with torch.inference_mode(False):
        t = {n: torch.from_numpy(v).to(device, dtype) for n, v in c.items()}
        t["ir"] = torch.stack([t["ir_re"], t["ir_im"]], dim=-1).contiguous()
        t["ict_re"] = t["ic_re"].T.contiguous()
        t["ict_im"] = t["ic_im"].T.contiguous()
        t["ir_stack"] = torch.cat([
            torch.cat([t["ir_re"], -t["ir_im"]], dim=1),
            torch.cat([t["ir_im"], t["ir_re"]], dim=1)], dim=0).contiguous()
        t["ic_stack"] = torch.cat([t["ict_re"], -t["ict_im"]], dim=0).contiguous()
        if dtype == torch.float32:
            t["ir_img"], t["ic_img"] = tail_table_images(t["ir_stack"], t["ic_stack"])
            for name in ("fc_re", "fc_im", "gc_re", "gc_im"):
                t[name + "8"] = torch.nn.functional.pad(t[name], (0, 0, 0, -t[name].shape[0] % 8))
    return t


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds finite fp32 values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


# Output tile of the single-pass tail kernel (csrc/mrf_fft_tail_wgmma.cu):
# rows (one wgmma M) and columns (its column transform's N).
TAIL_ROWS, TAIL_COLS = 64, 96
# Depth order of the column transform inside each 8 bins: the row
# transform's accumulator holds bins (2t, 2t + 1) where an A fragment wants
# depths (t, t + 4).
TAIL_BIN_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _core_matrices(m: torch.Tensor) -> torch.Tensor:
    """(tiles, rows, depth) -> (tiles, rows * depth) in the tensor cores'
    no-swizzle K-major layout: core matrices of 8 rows x 4 depths (16
    bytes a row), depth-major over them: (depth / 4, row / 8, row % 8,
    depth % 4)."""
    n, rows, depth = m.shape
    m = m.reshape(n, rows // 8, 8, depth // 4, 4).permute(0, 3, 1, 2, 4)
    return m.reshape(n, rows * depth).contiguous()


def tail_table_images(ir_stack: torch.Tensor, ic_stack: torch.Tensor):
    """The single-pass tail's resident operands, rounded to TF32
    (``tf32_round``), one image per output tile, each one bulk copy.

    ``ir_img`` (row tiles, 64 * 2Php): the A operand of the row transform,
    64 output rows of ir_stack's lower half [ir_im | ir_re], each half
    zero-padded from Ph to Php (Ph to a multiple of 8).  ``ic_img``
    (column tiles, 96 * 2Gp): the B operand of the column transform, 96
    output columns (N) over the depth [re bins; im bins] of ic_stack, each
    half zero-padded from G to Gp, the bins of each 8 in
    ``TAIL_BIN_ORDER``.  Rows and columns past H and W are zero."""
    h, ph = ir_stack.shape[0] // 2, ir_stack.shape[1] // 2
    g, w = ic_stack.shape[0] // 2, ic_stack.shape[1]
    php, gp = -(-ph // 8) * 8, -(-g // 8) * 8
    nyt, nxt = -(-h // TAIL_ROWS), -(-w // TAIL_COLS)
    a = ir_stack.new_zeros(nyt * TAIL_ROWS, 2, php)
    a[:h, 0, :ph], a[:h, 1, :ph] = ir_stack[h:, :ph], ir_stack[h:, ph:]
    ir_img = _core_matrices(a.reshape(nyt, TAIL_ROWS, 2 * php))
    c = ic_stack.new_zeros(2, gp, nxt * TAIL_COLS)
    c[0, :g, :w], c[1, :g, :w] = ic_stack[:g], ic_stack[g:]
    c = c.reshape(2, gp // 8, 8, -1)[:, :, list(TAIL_BIN_ORDER)]
    c = c.reshape(2 * gp, nxt, TAIL_COLS).permute(1, 2, 0)
    return tf32_round(ir_img), tf32_round(_core_matrices(c))


PRECISIONS = (None, "high", "default")


def single_pass(precision: str | None) -> bool:
    """Whether ``precision`` asks for one reduced-precision pass."""
    if precision not in PRECISIONS:
        raise ValueError(f"MRF precision must be one of {PRECISIONS}, got {precision!r}")
    return precision == "default"


@contextlib.contextmanager
def matmul_precision(precision: str | None, device: torch.device):
    """Run the enclosed CUDA fp32 matmuls at ``precision``: TF32 for
    ``'default'``, full fp32 for None and ``'high'``; the flag is put back
    on exit.  The flag is process-global, so a matmul another thread
    issues meanwhile sees it too: serving is safe, because one dispatcher
    thread owns the model.  CPU matmuls are fp32 either way."""
    tf32 = single_pass(precision)
    if device.type != "cuda":
        yield
        return
    flags = torch.backends.cuda.matmul
    # The newer per-backend setting where this PyTorch has it: mixing it
    # with the legacy allow_tf32 makes the legacy getter raise.
    attr, value = (("fp32_precision", "tf32" if tf32 else "ieee")
                   if hasattr(flags, "fp32_precision") else ("allow_tf32", tf32))
    prev = getattr(flags, attr)
    setattr(flags, attr, value)
    try:
        yield
    finally:
        setattr(flags, attr, prev)


def _transform2d(x, row_re, row_im, col_re, col_im):
    """Complex 2-D DFT of real planes x (..., n_rows, n_cols) -> (re, im)."""
    a_re = torch.matmul(row_re, x)
    a_im = torch.matmul(row_im, x)
    re = torch.matmul(a_re, col_re.T) - torch.matmul(a_im, col_im.T)
    im = torch.matmul(a_re, col_im.T) + torch.matmul(a_im, col_re.T)
    return re, im


def _transform2d_adjoint(g_re, g_im, row_re, row_im, col_re, col_im):
    """The adjoint of ``_transform2d`` (a linear map of x): dL/dx."""
    a_re = torch.matmul(g_re, col_re) + torch.matmul(g_im, col_im)
    a_im = torch.matmul(g_im, col_re) - torch.matmul(g_re, col_im)
    return torch.matmul(row_re.T, a_re) + torch.matmul(row_im.T, a_im)


def _inverse2d(r_re, r_im, ir_re, ir_im, ic_re, ic_im):
    """Real part of the inverse 2-D DFT of R (..., Ph, G) with the SAME
    crop: Re{Ir @ R @ Ic^T} -> (..., H, W)."""
    t_re = torch.matmul(ir_re, r_re) - torch.matmul(ir_im, r_im)
    t_im = torch.matmul(ir_re, r_im) + torch.matmul(ir_im, r_re)
    return torch.matmul(t_re, ic_re.T) - torch.matmul(t_im, ic_im.T)


def _inverse2d_adjoint(g, ir_re, ir_im, ic_re, ic_im):
    """The adjoint of ``_inverse2d`` (linear in R): (dL/dR_re, dL/dR_im)."""
    g_re = torch.matmul(g, ic_re)
    g_im = -torch.matmul(g, ic_im)
    return (torch.matmul(ir_re.T, g_re) + torch.matmul(ir_im.T, g_im),
            torch.matmul(ir_re.T, g_im) - torch.matmul(ir_im.T, g_re))


class _AtPrecision(torch.autograd.Function):
    """One of the pass's linear DFT maps, forward and backward at the
    call's precision.  Autograd would run the backward of the forward's
    matmuls later, in the caller's ``.backward()``, under whatever TF32
    flag the process holds then; here the adjoint's matmuls enter
    ``matmul_precision`` again.  The tables are constants."""

    @staticmethod
    def forward(ctx, fn, adjoint, tables, precision, *inputs):
        ctx.adjoint, ctx.tables, ctx.precision = adjoint, tables, precision
        with matmul_precision(precision, inputs[0].device):
            return fn(*inputs, *tables)

    @staticmethod
    def backward(ctx, *grads):
        with matmul_precision(ctx.precision, grads[0].device):
            dx = ctx.adjoint(*grads, *ctx.tables)
        return (None, None, None, None, *(dx if isinstance(dx, tuple) else (dx,)))


def forward_ffts(p: torch.Tensor, kernels: torch.Tensor, precision: str | None = None,
                 padded_bins: bool = False):
    """Forward DFTs of unaries and kernels, at ``precision``.

    Returns ((pf_re, pf_im) (B, K, Ph, G), (kf_re, kf_im) (Kv, Ka, Ph, G),
    tables dict).  With ``padded_bins`` (fp32) each spectrum is the view
    ``[..., :G]`` of a contiguous buffer whose rows hold G rounded up to a
    multiple of 8 bins, the extra bins zero: the single-pass tail kernel
    reads those rows as aligned 16-byte vectors.
    """
    b, h, w, k = p.shape
    wh, ww, kv, ka = kernels.shape
    if kv != k:
        raise ValueError(f"p {tuple(p.shape)} does not match kernels {tuple(kernels.shape)}")
    t = dft_tables((h, w), (wh, ww), p.device)
    planes = p.float().permute(0, 3, 1, 2)  # (B, K, H, W)
    kplanes = kernels.float().permute(2, 3, 0, 1)  # (Kv, Ka, wh, ww)
    cols = "8" if padded_bins else ""
    pf = _AtPrecision.apply(_transform2d, _transform2d_adjoint,
                            (t["fr_re"], t["fr_im"], t["fc_re" + cols], t["fc_im" + cols]),
                            precision, planes)
    kf = _AtPrecision.apply(_transform2d, _transform2d_adjoint,
                            (t["gr_re"], t["gr_im"], t["gc_re" + cols], t["gc_im" + cols]),
                            precision, kplanes)
    if padded_bins:
        g = t["fc_re"].shape[0]
        pf, kf = tuple(x[..., :g] for x in pf), tuple(x[..., :g] for x in kf)
    return pf, kf, t


def fft_pairwise_conv(
    p: torch.Tensor, kernels: torch.Tensor, precision: str | None = None
) -> torch.Tensor:
    """All K^2 SAME pairwise correlations via Fourier-space matmuls.

    Drop-in for ``pairwise_conv``: (B, H, W, K), (wh, ww, K, K) ->
    (B, H, W, Kv, Ka) fp32.
    """
    (pf_re, pf_im), (kf_re, kf_im), t = forward_ffts(p, kernels, precision)
    # R = conj(K_f) ⊙ P_f: P_f[b, v] against K_f[v, a] -> (B, Kv, Ka, Ph, G).
    r_re = kf_re[None] * pf_re[:, :, None] + kf_im[None] * pf_im[:, :, None]
    r_im = kf_re[None] * pf_im[:, :, None] - kf_im[None] * pf_re[:, :, None]
    resp = _AtPrecision.apply(_inverse2d, _inverse2d_adjoint,
                              (t["ir_re"], t["ir_im"], t["ic_re"], t["ic_im"]), precision,
                              r_re, r_im)
    return resp.permute(0, 3, 4, 1, 2)  # (B, H, W, Kv, Ka)


def mrf_message_pass_fft(
    p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6,
    precision: str | None = None,
) -> torch.Tensor:
    """Log-space message pass with the Fourier-space pairwise conv and the
    plain bias+log+Σ_v tail: the reference's ``use_pallas_epilogue=False``."""
    resp = fft_pairwise_conv(p, kernels, precision)
    resp = resp + biases.float()
    return torch.log(resp.clamp_min(eps)).sum(dim=-2)
