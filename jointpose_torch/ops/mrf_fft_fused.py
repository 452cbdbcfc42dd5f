"""Fused Fourier MRF tail (counterpart of ``jointpose/ops/mrf_fft_pallas.py``).

    for each image b, source v, target a:
      R       = conj(K_f[v,a]) ⊙ P_f[b,v]
      o       = Re{ Ir @ (R @ Ic) }          (inverse DFTs with the SAME crop)
      out[b,a] += log(max(o + bias[v,a], eps))

``fused_tail`` is the wrapper: on CUDA tensors it launches the kernel of
``csrc/mrf_fft_tail.cu`` (or raises), on CPU tensors it runs the plain
version ``fused_tail_plain``.  The kernel has two forms: at precision
None or ``'high'`` every product is 3xTF32 (near fp32), at ``'default'``
one TF32 pass (the reference's ``Precision.DEFAULT``); their launches are
counted apart, in ``fused_tail.launches`` and
``fused_tail.launches_1pass``.  Only the forward DFTs' outputs cross
device memory; the (B, Kv, Ka, H, W) responses never exist (where the
kernel splits an output tile's source joints over blocks, up to three
partial log-sums of that tile do, in a scratch of two output-sized
planes).  ``fused_tail_emulated`` repeats the kernel's arithmetic (rows
first, 3xTF32 or one TF32 pass) in plain PyTorch, to size its error on
the CPU.  ``mrf_message_pass_fft_fused`` wraps it in a
``torch.autograd.Function`` whose backward recomputes the plain Fourier
pass at the same precision.
"""

from __future__ import annotations

import ctypes

import torch

from jointpose_torch import _build, perf
from jointpose_torch.ops.mrf_fft import (
    forward_ffts, matmul_precision, mrf_message_pass_fft, single_pass,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mrf_fft_tail": ([_P] * 10 + [_I] * 7 + [ctypes.c_float, _I, _P], _I),
    "mrf_fft_tail_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "mrf_fft_tail_scratch_parts": ([], _I),
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
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
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
                        passes: int = 3) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for sizing its error on
    the CPU: rows first, both inverse transforms as real block-matrix
    products on operands zero-padded to the tensor cores' tiles (16 rows,
    depth 8, 8 columns), every product 3xTF32 (``matmul_3xtf32``) or, with
    ``passes=1``, one TF32 pass (``matmul_tf32``).  The summation order
    inside a product is PyTorch's, not the kernel's."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
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


def fused_tail(pf, kf, tables, biases, eps: float = 1e-6,
               precision: str | None = None) -> torch.Tensor:
    """The fused tail: (B, Ka, H, W) fp32 log-messages summed over v; on
    CUDA tensors 3xTF32 at precision None or ``'high'``, one TF32 pass at
    ``'default'``, on CPU tensors fp32 at every precision."""
    pf_re, pf_im = pf
    kf_re, kf_im = kf
    passes = 1 if single_pass(precision) else 3
    if pf_re.device.type == "cpu":
        return fused_tail_plain(pf, kf, tables, biases, eps)
    b, kv, ph, g = pf_re.shape
    ka = kf_re.shape[1]
    h, w = tables["ir_re"].shape[0], tables["ict_re"].shape[1]
    operands = {
        "pf_re": (pf_re, (b, kv, ph, g)), "pf_im": (pf_im, (b, kv, ph, g)),
        "kf_re": (kf_re, (kv, ka, ph, g)), "kf_im": (kf_im, (kv, ka, ph, g)),
        "ir": (tables["ir"], (h, ph, 2)),
        "ict_re": (tables["ict_re"], (g, w)), "ict_im": (tables["ict_im"], (g, w)),
        "biases": (biases, (kv, ka)),
    }
    for name, (t, shape) in operands.items():
        if t.device != pf_re.device or pf_re.device.type != "cuda":
            raise ValueError(f"fused_tail: {name} must lie on the CUDA device of pf_re")
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused_tail: {name} must be contiguous f32 {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    lib = _build.load("mrf_fft_tail", _SIGNATURES)
    smem = lib.mrf_fft_tail_smem_bytes(ph, g)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"fused_tail: geometry Ph={ph}, G={g} needs {smem} B of shared memory "
            f"per block, above {_SMEM_LIMIT}"
        )
    out = torch.empty((b, ka, h, w), dtype=torch.float32, device=pf_re.device)
    # Partial log-sums of output tiles whose source joints are split over blocks.
    scratch = torch.empty((lib.mrf_fft_tail_scratch_parts(), *out.shape), dtype=torch.float32,
                          device=pf_re.device)
    with torch.cuda.device(pf_re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_fft_tail(
            pf_re.data_ptr(), pf_im.data_ptr(), kf_re.data_ptr(), kf_im.data_ptr(),
            tables["ir"].data_ptr(), tables["ict_re"].data_ptr(),
            tables["ict_im"].data_ptr(), biases.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, kv, ka, ph, g, h, w, eps, passes, stream,
        )
    _build.check(err, "mrf_fft_tail")
    if passes == 1:
        fused_tail.launches_1pass += 1
    else:
        fused_tail.launches += 1
    perf.count_kernel("mrf_fft_tail_1pass" if passes == 1 else "mrf_fft_tail", tail_cost,
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
        pf, kf, tables = forward_ffts(p, kernels, precision)
        pf = tuple(t.contiguous() for t in pf)
        kf = tuple(t.contiguous() for t in kf)
        out = fused_tail(pf, kf, tables, biases.float().contiguous(), eps, precision)
        return out.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
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
