"""Fused MRF epilogue with its backward (counterpart of ``jointpose/ops/mrf_pallas.py``).

    out[..., a] = Σ_v log( max(resp[..., v, a] + bias[v, a], eps) )

``mrf_epilogue`` is a ``torch.autograd.Function``: on CUDA tensors its
forward launches the forward kernel of ``csrc/mrf_epilogue.cu`` (the sum
of Kv logs taken as one log of a product of mantissas) and its
backward the backward kernel (or raise); on CPU tensors both directions
run the plain versions ``mrf_epilogue_plain`` and
``mrf_epilogue_bwd_plain``.  The forward kernel reads the (B·H·W, Kv·Ka)
response rows once and writes (B·H·W, Ka) floats, so the K^2 log terms
never reach device memory; the backward reads the rows once more and
writes their gradient, with the bias gradient summed in a fixed order.
"""

from __future__ import annotations

import ctypes

import torch

from jointpose_torch import _build, perf
from jointpose_torch.ops.mrf_xla import pairwise_conv

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "mrf_epilogue_fwd": ([_P, _I, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float, _P], _I),
    "mrf_epilogue_fwd_pervalue": (
        [_P, _I, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float, _P], _I
    ),
    "mrf_epilogue_fwd_tiled": (
        [_P, _I, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float, _P], _I
    ),
    "mrf_epilogue_fwd_empty": ([ctypes.c_longlong, _I, _I, _P], _I),
    "mrf_epilogue_bwd_partials": ([ctypes.c_longlong, _I, _I], _I),
    "mrf_epilogue_bwd": (
        [_P, _I, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, ctypes.c_float, _P], _I
    ),
}


def mrf_epilogue_plain(resp: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: (B, H, W, Kv, Ka) responses -> (B, H, W, Ka) fp32."""
    x = resp.float() + biases.float()
    return torch.log(x.clamp_min(eps)).sum(dim=-2)


def mrf_epilogue_bwd_plain(
    resp: torch.Tensor, biases: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward, as the reference's kernel computes it:
    dresp = g·(x > eps)/x in resp's dtype, dbias = Σ_rows dresp in fp32
    (summed from the fp32 values, before any rounding)."""
    x = resp.float() + biases.float()
    inv = torch.where(x > eps, 1.0 / x.clamp_min(eps), torch.zeros_like(x))
    d = g.float().unsqueeze(-2) * inv  # (B, H, W, Kv, Ka)
    return d.to(resp.dtype), d.sum(dim=(0, 1, 2))


def dbias_by_vector_lanes(d: torch.Tensor, vec: int) -> torch.Tensor:
    """The backward kernel's column map in plain PyTorch: (rows, kk) fp32
    gradients -> dbias (kk,).  The kernel walks the flat array in 16-byte
    vectors of ``vec`` values; ``vec`` rows are exactly kk vectors, so lane
    (t, i) of every such group holds flat element e = vec*t + i of the
    group, column e mod kk, and sums it over the groups; rows past the
    last whole group land in the same lanes.  Each column then collects
    its ``vec`` lanes."""
    rows, kk = d.shape
    whole = rows // vec
    lanes = d[: whole * vec].reshape(whole, kk * vec).sum(dim=0)
    tail = d[whole * vec:].reshape(-1)
    lanes[: tail.numel()] += tail
    cols = torch.arange(kk * vec, device=d.device) % kk
    return torch.zeros(kk, dtype=d.dtype, device=d.device).index_add_(0, cols, lanes)


def fwd_cost(resp: torch.Tensor, biases: torch.Tensor) -> tuple[int, int]:
    """(bytes, operations) of the forward's function: the responses and
    biases read once and the fp32 (rows, Ka) output written once; per
    response the bias add, the clamp, the log and its add into the sum."""
    rows, kv, ka = resp.shape[0] * resp.shape[1] * resp.shape[2], resp.shape[3], resp.shape[4]
    return perf.nbytes(resp, biases) + rows * ka * 4, rows * kv * ka * 4


def bwd_cost(resp: torch.Tensor, biases: torch.Tensor, g: torch.Tensor) -> tuple[int, int]:
    """(bytes, operations) of the backward's function: the responses,
    biases and output gradient read once, dresp (the responses' type) and
    the fp32 dbias written once; per response the bias add, the compare,
    the reciprocal, the product and its add into dbias."""
    rows, kv, ka = resp.shape[0] * resp.shape[1] * resp.shape[2], resp.shape[3], resp.shape[4]
    return 2 * perf.nbytes(resp) + perf.nbytes(biases, g) + kv * ka * 4, rows * kv * ka * 5


def _check(resp: torch.Tensor, biases: torch.Tensor, what: str) -> tuple[int, int, int]:
    if resp.dim() != 5:
        raise ValueError(f"{what}: resp must be (B, H, W, Kv, Ka), got {tuple(resp.shape)}")
    b, h, w, kv, ka = resp.shape
    if resp.device.type != "cuda" or biases.device != resp.device:
        raise ValueError(f"{what}: resp and biases must lie on one CUDA device")
    if resp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: resp must be bf16 or f32, got {resp.dtype}")
    if biases.dtype != torch.float32 or tuple(biases.shape) != (kv, ka):
        raise ValueError(f"{what}: biases must be f32 ({kv}, {ka})")
    if not resp.is_contiguous() or not biases.is_contiguous():
        raise ValueError(f"{what}: resp and biases must be contiguous")
    return b * h * w, kv, ka


def _launch_fwd(entry: str, resp: torch.Tensor, biases: torch.Tensor, eps: float) -> torch.Tensor:
    rows, kv, ka = _check(resp, biases, entry)
    lib = _build.load("mrf_epilogue", _SIGNATURES)
    out = torch.empty((*resp.shape[:3], ka), dtype=torch.float32, device=resp.device)
    with torch.cuda.device(resp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            resp.data_ptr(), int(resp.dtype == torch.bfloat16), biases.data_ptr(),
            out.data_ptr(), rows, kv, ka, eps, stream,
        )
    _build.check(err, entry)
    return out


def mrf_epilogue_fwd(resp: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The forward alone: the kernel on CUDA tensors, the plain version on CPU ones."""
    if resp.device.type == "cpu":
        return mrf_epilogue_plain(resp, biases, eps)
    out = _launch_fwd("mrf_epilogue_fwd", resp, biases, eps)
    mrf_epilogue.launches += 1
    perf.count_kernel("mrf_epilogue", fwd_cost, resp, biases)
    return out


def mrf_epilogue_fwd_pervalue(
    resp: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """The forward kernel's first design (the Kv logs added one by one):
    CUDA tensors only.  No path of the package calls it; the kernel is held
    and timed against it."""
    return _launch_fwd("mrf_epilogue_fwd_pervalue", resp, biases, eps)


def mrf_epilogue_fwd_tiled(
    resp: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """The first design's sums in the backward's layout (16-byte vectors
    through shared memory): CUDA tensors only, bit-identical to
    ``mrf_epilogue_fwd_pervalue`` and slower, kept for timing."""
    return _launch_fwd("mrf_epilogue_fwd_tiled", resp, biases, eps)


def mrf_epilogue_fwd_empty(resp: torch.Tensor, biases: torch.Tensor) -> None:
    """Launch a kernel of the forward's grid, block and shared memory that
    reads and writes nothing: the floor under the forward's time."""
    rows, kv, ka = _check(resp, biases, "mrf_epilogue_fwd_empty")
    lib = _build.load("mrf_epilogue", _SIGNATURES)
    with torch.cuda.device(resp.device):
        err = lib.mrf_epilogue_fwd_empty(rows, kv, ka, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "mrf_epilogue_fwd_empty")


def mrf_epilogue_bwd(
    resp: torch.Tensor, biases: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward: (dresp in resp's dtype, dbias fp32); the kernel on CUDA
    tensors, the plain version on CPU ones."""
    if resp.device.type == "cpu":
        return mrf_epilogue_bwd_plain(resp, biases, g, eps)
    rows, kv, ka = _check(resp, biases, "mrf_epilogue_bwd")
    if g.device != resp.device or g.dtype != torch.float32 or tuple(g.shape) != (*resp.shape[:3], ka):
        raise ValueError(f"mrf_epilogue_bwd: g must be f32 {(*resp.shape[:3], ka)} on resp's device")
    g = g.contiguous()
    lib = _build.load("mrf_epilogue", _SIGNATURES)
    dresp = torch.empty_like(resp)
    dbias = torch.empty((kv, ka), dtype=torch.float32, device=resp.device)
    is_bf16 = int(resp.dtype == torch.bfloat16)
    parts = torch.empty(
        (lib.mrf_epilogue_bwd_partials(rows, kv * ka, is_bf16), kv * ka), dtype=torch.float32,
        device=resp.device,
    )
    with torch.cuda.device(resp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_epilogue_bwd(
            resp.data_ptr(), is_bf16, biases.data_ptr(),
            g.data_ptr(), dresp.data_ptr(), dbias.data_ptr(), parts.data_ptr(),
            rows, kv, ka, eps, stream,
        )
    _build.check(err, "mrf_epilogue_bwd")
    mrf_epilogue_bwd.launches += 1
    perf.count_kernel("mrf_epilogue_bwd", bwd_cost, resp, biases, g)
    return dresp, dbias


mrf_epilogue_bwd.launches = 0


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, resp, biases, eps):
        ctx.eps = eps
        ctx.save_for_backward(resp, biases)
        return mrf_epilogue_fwd(resp, biases, eps)

    @staticmethod
    def backward(ctx, g):
        resp, biases = ctx.saved_tensors
        dresp, dbias = mrf_epilogue_bwd(resp, biases, g.float(), ctx.eps)
        return dresp, dbias, None


def mrf_epilogue(resp: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Fused Σ_v log(resp + bias) over (B, H, W, Kv, Ka) -> (B, H, W, Ka) fp32,
    differentiable in ``resp`` and ``biases``."""
    return _Epilogue.apply(resp, biases, eps)


mrf_epilogue.launches = 0


def mrf_message_pass_pallas(
    p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6,
    precision: str | None = None,
) -> torch.Tensor:
    """Pairwise conv in the compute dtype, then the fused epilogue.

    Same signature and semantics as ``mrf_message_pass_xla`` (``precision``
    changes nothing on the direct conv, as there).
    """
    resp = pairwise_conv(p, kernels, precision=precision)  # (B, H, W, Kv, Ka) in p's dtype
    return mrf_epilogue(resp, biases.float().contiguous(), eps)
