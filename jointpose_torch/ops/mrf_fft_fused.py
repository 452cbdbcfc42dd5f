"""Fused Fourier MRF tail (counterpart of ``jointpose/ops/mrf_fft_pallas.py``).

    for each image b, source v, target a:
      R       = conj(K_f[v,a]) ⊙ P_f[b,v]
      o       = Re{ Ir @ (R @ Ic) }          (inverse DFTs with the SAME crop)
      out[b,a] += log(max(o + bias[v,a], eps))

``fused_tail`` is the wrapper: on CUDA tensors it launches a kernel (or
raises), on CPU tensors it runs the plain version ``fused_tail_plain``.
At precision None or ``'high'`` every product is 3xTF32 (near fp32), the
kernel of ``csrc/mrf_fft_tail.cu`` on ``mma.sync``; at ``'default'`` one
TF32 pass (the reference's ``Precision.DEFAULT``), the kernel of
``csrc/mrf_fft_tail_wgmma.cu`` on ``wgmma``.  Their launches are counted
apart, in ``fused_tail.launches`` and ``fused_tail.launches_1pass``.
Only the forward DFTs' outputs cross device memory; the (B, Kv,
Ka, H, W) responses never exist (where a kernel splits an output tile's
source joints over blocks or warpgroups, partial log-sums of that tile
do, in a scratch of output-sized planes).  ``fused_tail_emulated``
repeats the kernels' arithmetic (rows first, 3xTF32 or one TF32 pass) in
plain PyTorch, to size its error on the CPU.
``mrf_message_pass_fft_fused`` wraps it in a ``torch.autograd.Function``
whose backward recomputes the plain Fourier pass at the same precision,
inside the span ``jointpose/mrf.vjp``, and counts each recompute in
``_FusedPass.recomputes``.
"""

from __future__ import annotations

import ctypes

import torch

from jointpose_torch import _build, perf
from jointpose_torch.metrics import span
from jointpose_torch.ops.mrf_fft import (
    TAIL_COLS, TAIL_ROWS, forward_ffts, matmul_precision, mrf_message_pass_fft, single_pass,
    tf32_round,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mrf_fft_tail": ([_P] * 10 + [_I] * 7 + [ctypes.c_float, _P], _I),
    "mrf_fft_tail_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "mrf_fft_tail_scratch_parts": ([], _I),
}
_WGMMA_SIGNATURES = {
    "mrf_tail_wgmma": ([_P] * 9 + [_I] * 8 + [ctypes.c_float, _P], _I),
    "mrf_tail_wgmma_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "mrf_tail_wgmma_scratch_parts": ([_I] * 5, _I),
}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90


def fused_tail_plain(pf, kf, tables, biases, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: ((B,Kv,Ph,G) re/im, (Kv,Ka,Ph,G) re/im) -> (B, Ka, H, W) fp32."""
    pf_re, pf_im = pf
    kf_re, kf_im = kf
    r_re = kf_re[None] * pf_re[:, :, None] + kf_im[None] * pf_im[:, :, None]
    r_im = kf_re[None] * pf_im[:, :, None] - kf_im[None] * pf_re[:, :, None]
    u_re = torch.matmul(r_re, tables["ict_re"]) - torch.matmul(r_im, tables["ict_im"])
    u_im = torch.matmul(r_re, tables["ict_im"]) + torch.matmul(r_im, tables["ict_re"])
    o = torch.matmul(tables["ir_re"], u_re) - torch.matmul(tables["ir_im"], u_im)
    o = o + biases.float()[None, :, :, None, None]  # (B, Kv, Ka, H, W)
    return torch.log(o.clamp_min(eps)).sum(dim=1)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo exactly, hi a TF32 value: x rounded to 10 explicit
    mantissa bits, to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds (finite fp32 input)."""
    hi = tf32_round(x)
    return hi, x - hi


def _tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 register: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it: three TF32 products with fp32 sums,
    the two small ones (lo·hi, hi·lo) added before the large one (hi·hi);
    lo·lo, about 2^-22 of the product, is dropped."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    a_lo, b_lo = _tf32_truncate(a_lo), _tf32_truncate(b_lo)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + torch.matmul(a_hi, b_hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the single-pass kernel forms it: both operands rounded to
    TF32 (``tf32_split``'s hi), their products exact, the sums in fp32."""
    return torch.matmul(tf32_split(a)[0], tf32_split(b)[0])


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad the last two dimensions up to multiples of (rows, cols)."""
    r, c = x.shape[-2:]
    return torch.nn.functional.pad(x, (0, -c % cols, 0, -r % rows))


def fused_tail_emulated(pf, kf, tables, biases, eps: float = 1e-6,
                        passes: int = 3, chunk: int | None = None) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch, for sizing their error on
    the CPU: rows first, both inverse transforms as real block-matrix
    products on operands zero-padded to the tensor cores' tiles (16 rows,
    depth 8, 8 columns), every product 3xTF32 (``matmul_3xtf32``) or, with
    ``passes=1``, one TF32 pass (``matmul_tf32``).  The summation order
    inside a product is PyTorch's, not the kernel's.

    ``chunk`` (bins) takes the single-pass ``wgmma`` kernel's grouping of
    the sums instead: T_re and T_im each as two products over the Ph rows
    of the DFT (T_re = Ir_re R_re - Ir_im R_im), and o summed over chunks
    of ``chunk`` column bins in order, in each the real bins before the
    imaginary ones."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if chunk is not None:
        return _emulated_chunked(pf, kf, tables, biases, eps,
                                 matmul_tf32 if passes == 1 else matmul_3xtf32, chunk)
    product = matmul_tf32 if passes == 1 else matmul_3xtf32
    pf_re, pf_im = pf
    kf_re, kf_im = kf
    h, w = tables["ir_re"].shape[0], tables["ict_re"].shape[1]
    g = tables["ict_re"].shape[0]
    r_re = kf_re[None] * pf_re[:, :, None] + kf_im[None] * pf_im[:, :, None]
    r_im = kf_re[None] * pf_im[:, :, None] - kf_im[None] * pf_re[:, :, None]
    ir = tables["ir_stack"]  # (2H, 2Ph): the re rows, then the im rows
    ir = torch.cat([_pad_to(ir[:h], 16, 8), _pad_to(ir[h:], 16, 8)], dim=0)
    hp = ir.shape[0] // 2
    r = _pad_to(torch.cat([r_re, r_im], dim=-2), 8, 8)  # (B, Kv, Ka, 2Ph, Gp)
    t = product(ir, r)  # (..., 2Hp, Gp): T_re over T_im
    ic = tables["ic_stack"]  # (2G, W)
    ic = torch.cat([_pad_to(ic[:g], 8, 8), _pad_to(ic[g:], 8, 8)], dim=0)
    o = product(torch.cat([t[..., :hp, :], t[..., hp:, :]], dim=-1), ic)
    o = o[..., :h, :w] + biases.float()[None, :, :, None, None]  # (B, Kv, Ka, H, W)
    return torch.log(o.clamp_min(eps)).sum(dim=1)


def _emulated_chunked(pf, kf, tables, biases, eps, product, chunk: int) -> torch.Tensor:
    pf_re, pf_im = pf
    kf_re, kf_im = kf
    h, w = tables["ir_re"].shape[0], tables["ict_re"].shape[1]
    ph, g = tables["ir_re"].shape[1], tables["ict_re"].shape[0]
    r_re = kf_re[None] * pf_re[:, :, None] + kf_im[None] * pf_im[:, :, None]
    r_im = kf_re[None] * pf_im[:, :, None] - kf_im[None] * pf_re[:, :, None]
    lower = tables["ir_stack"][h:]  # [Ir_im | Ir_re]
    ir_im, ir_re = lower[:, :ph], lower[:, ph:]
    t_re = product(ir_re, r_re) - product(ir_im, r_im)
    t_im = product(ir_im, r_re) + product(ir_re, r_im)
    ic_re, ic_im = tables["ic_stack"][:g], tables["ic_stack"][g:]
    o = torch.zeros((*t_re.shape[:-1], w), dtype=torch.float32, device=t_re.device)
    for c0 in range(0, g, chunk):
        c1 = min(c0 + chunk, g)
        o = o + product(t_re[..., c0:c1], ic_re[c0:c1])
        o = o + product(t_im[..., c0:c1], ic_im[c0:c1])
    o = o + biases.float()[None, :, :, None, None]  # (B, Kv, Ka, H, W)
    return torch.log(o.clamp_min(eps)).sum(dim=1)


def tail_cost(pf, kf, tables, biases) -> tuple[int, int]:
    """(bytes, operations) of the tail's function: the spectra, the
    inverse-transform tables and the biases read once, the fp32 (B, Ka, H,
    W) output written once; per (b, v, a) the cheaper order of the two
    transforms, rows first: R, T = Ir @ R, Re{T @ Ic}, then the bias add,
    the log and its add into the sum."""
    b, kv, ph, g = pf[0].shape
    ka = kf[0].shape[1]
    h, w = tables["ir_re"].shape[0], tables["ict_re"].shape[1]
    per_pair = 6 * ph * g + 8 * h * ph * g + 4 * h * g * w + 4 * h * w
    n_bytes = perf.nbytes(*pf, *kf, tables["ir"], tables["ict_re"], tables["ict_im"], biases)
    return n_bytes + b * ka * h * w * 4, b * kv * ka * per_pair


def _operands(pf, kf, tables, biases, what: str, images: bool) -> tuple:
    """Check a kernel's operands; (B, Kv, Ka, Ph, G, H, W, spectra), the
    spectra (pf_re, pf_im, kf_re, kf_im) as the kernel reads them."""
    pf_re, pf_im = pf
    kf_re, kf_im = kf
    b, kv, ph, g = pf_re.shape
    ka = kf_re.shape[1]
    h, w = tables["ir_re"].shape[0], tables["ict_re"].shape[1]
    operands = {
        "pf_re": (pf_re, (b, kv, ph, g)), "pf_im": (pf_im, (b, kv, ph, g)),
        "kf_re": (kf_re, (kv, ka, ph, g)), "kf_im": (kf_im, (kv, ka, ph, g)),
        "biases": (biases, (kv, ka)),
    }
    if images:
        php, gp = -(-ph // 8) * 8, -(-g // 8) * 8
        operands["ir_img"] = (tables["ir_img"], (-(-h // TAIL_ROWS), TAIL_ROWS * 2 * php))
        operands["ic_img"] = (tables["ic_img"], (-(-w // TAIL_COLS), TAIL_COLS * 2 * gp))
        for name in ("pf_re", "pf_im", "kf_re", "kf_im"):  # rows of whole 32-byte vectors
            t, shape = operands[name]
            operands[name] = (_padded_bins(t), shape)
    else:
        operands["ir"] = (tables["ir"], (h, ph, 2))
        operands["ict_re"] = (tables["ict_re"], (g, w))
        operands["ict_im"] = (tables["ict_im"], (g, w))
    for name, (t, shape) in operands.items():
        if t.device != pf_re.device or pf_re.device.type != "cuda":
            raise ValueError(f"{what}: {name} must lie on the CUDA device of pf_re")
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not _rows_contiguous(t):
            raise ValueError(
                f"{what}: {name} must be contiguous f32 {shape}, got {t.dtype} {tuple(t.shape)}")
    return b, kv, ka, ph, g, h, w, tuple(operands[n][0] for n in ("pf_re", "pf_im", "kf_re",
                                                                  "kf_im"))


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Contiguous, or the view [..., :G] of a contiguous buffer whose rows
    hold a multiple of 8 values (``forward_ffts(padded_bins=True)``)."""
    if t.is_contiguous():
        return True
    if t.dim() < 2 or t.stride(-1) != 1 or t.stride(-2) % 8 or t.stride(-2) < t.shape[-1]:
        return False
    want = t.stride(-2)  # each outer stride the extent of the dimensions inside it
    for i in range(t.dim() - 3, -1, -1):
        want *= t.shape[i + 1]
        if t.shape[i] > 1 and t.stride(i) != want:
            return False
    return True


def _padded_bins(t: torch.Tensor) -> torch.Tensor:
    """``t`` (…, G) as rows of a multiple of 8 values: itself where it is
    already laid out so (or G is such a multiple), else a zero-padded copy
    (one more kernel, off the served path, whose spectra come padded)."""
    g = t.shape[-1]
    if t.stride(-2) % 8 == 0 and (g % 8 == 0 or not t.is_contiguous()):
        return t
    return torch.nn.functional.pad(t, (0, -g % 8))[..., :g]


def _mma_sync(pf, kf, tables, biases, eps: float) -> torch.Tensor:
    """One launch of ``csrc/mrf_fft_tail.cu`` (3xTF32)."""
    b, kv, ka, ph, g, h, w, spectra = _operands(pf, kf, tables, biases, "fused_tail",
                                                images=False)
    lib = _build.load("mrf_fft_tail", _SIGNATURES)
    smem = lib.mrf_fft_tail_smem_bytes(ph, g)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"fused_tail: geometry Ph={ph}, G={g} needs {smem} B of shared memory "
            f"per block, above {_SMEM_LIMIT}"
        )
    out = torch.empty((b, ka, h, w), dtype=torch.float32, device=pf[0].device)
    # Partial log-sums of output tiles whose source joints are split over blocks.
    scratch = torch.empty((lib.mrf_fft_tail_scratch_parts(), *out.shape), dtype=torch.float32,
                          device=out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_fft_tail(
            *(t.data_ptr() for t in spectra), tables["ir"].data_ptr(),
            tables["ict_re"].data_ptr(), tables["ict_im"].data_ptr(), biases.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, kv, ka, ph, g, h, w, eps, stream,
        )
    _build.check(err, "mrf_fft_tail")
    return out


def _wgmma(pf, kf, tables, biases, eps: float) -> torch.Tensor:
    """One launch of ``csrc/mrf_fft_tail_wgmma.cu`` (one TF32 pass)."""
    b, kv, ka, ph, g, h, w, spectra = _operands(pf, kf, tables, biases, "fused_tail",
                                                images=True)
    lib = _build.load("mrf_fft_tail_wgmma", _WGMMA_SIGNATURES)
    if lib.mrf_tail_wgmma_smem_bytes(ph, g) < 0:
        raise ValueError(
            f"fused_tail: geometry Ph={ph}, G={g} does not fit the single-pass kernel: its "
            f"tables and an R stage of 8 bins for each of its two warpgroups need more than "
            f"the {_SMEM_LIMIT} B of shared memory of a block"
        )
    out = torch.empty((b, ka, h, w), dtype=torch.float32, device=pf[0].device)
    # Partial log-sums of output tiles whose source joints are split over workers.
    scratch = torch.empty((lib.mrf_tail_wgmma_scratch_parts(b, kv, ka, h, w), *out.shape),
                          dtype=torch.float32, device=out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_tail_wgmma(
            *(t.data_ptr() for t in spectra), tables["ir_img"].data_ptr(),
            tables["ic_img"].data_ptr(), biases.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b, kv, ka, ph, g, spectra[0].stride(-2), h, w, eps, stream,
        )
    _build.check(err, "mrf_tail_wgmma")
    return out


def fused_tail(pf, kf, tables, biases, eps: float = 1e-6,
               precision: str | None = None) -> torch.Tensor:
    """The fused tail: (B, Ka, H, W) fp32 log-messages summed over v; on
    CUDA tensors 3xTF32 at precision None or ``'high'`` (``mma.sync``), one
    TF32 pass at ``'default'`` (``wgmma``), on CPU tensors fp32 at every
    precision.  The one pass reads spectra in rows of a multiple of 8 bins
    as ``forward_ffts(padded_bins=True)`` gives them; others it pads in a
    copy first."""
    one_pass = single_pass(precision)
    if pf[0].device.type == "cpu":
        return fused_tail_plain(pf, kf, tables, biases, eps)
    if one_pass:
        out = _wgmma(pf, kf, tables, biases, eps)
        fused_tail.launches_1pass += 1
    else:
        out = _mma_sync(pf, kf, tables, biases, eps)
        fused_tail.launches += 1
    perf.count_kernel("mrf_fft_tail_1pass" if one_pass else "mrf_fft_tail", tail_cost,
                      pf, kf, tables, biases)
    return out


fused_tail.launches = 0  # 3xTF32 launches
fused_tail.launches_1pass = 0  # single-pass TF32 launches


class _FusedPass(torch.autograd.Function):
    """Forward through the fused tail; backward by recomputing the plain
    Fourier pass under autograd and taking its VJP, as the reference's
    custom VJP does (``mrf_fft_pallas.py:184-203``): the fused kernel and
    the plain tail compute the same function, and only the three inputs
    are kept for the backward."""

    @staticmethod
    def forward(ctx, p, kernels, biases, eps, precision):
        ctx.eps, ctx.precision = eps, precision
        ctx.save_for_backward(p, kernels, biases)
        # The single pass's kernel reads spectra with padded rows as they come.
        one_pass = single_pass(precision) and p.device.type == "cuda"
        pf, kf, tables = forward_ffts(p, kernels, precision, padded_bins=one_pass)
        if not one_pass:
            pf = tuple(t.contiguous() for t in pf)
            kf = tuple(t.contiguous() for t in kf)
        out = fused_tail(pf, kf, tables, biases.float().contiguous(), eps, precision)
        return out.permute(0, 2, 3, 1)

    recomputes = 0  # backward passes run, each one recompute and its VJP

    @staticmethod
    def backward(ctx, g):
        with span("mrf.vjp"):
            _FusedPass.recomputes += 1
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
            with torch.enable_grad():
                out = mrf_message_pass_fft(*inputs, eps=ctx.eps, precision=ctx.precision)
            wanted = [t for t in inputs if t.requires_grad]
            # The recompute's own backward matmuls run at the pass's precision too.
            with matmul_precision(ctx.precision, g.device):
                grads = iter(torch.autograd.grad(out, wanted, g) if wanted else ())
            return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


def mrf_message_pass_fft_fused(
    p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6,
    precision: str | None = None,
) -> torch.Tensor:
    """Full log-space message pass: torch forward DFTs + the fused tail.

    Same signature and semantics as ``mrf_message_pass_xla``; returns
    (B, H, W, Ka) fp32, differentiable in all three inputs.
    """
    return _FusedPass.apply(p, kernels, biases, eps, precision)
