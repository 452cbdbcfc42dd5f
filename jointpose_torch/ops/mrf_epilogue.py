"""Fused MRF epilogue, forward (counterpart of ``jointpose/ops/mrf_pallas.py``).

    out[..., a] = Σ_v log( max(resp[..., v, a] + bias[v, a], eps) )

``mrf_epilogue`` is the wrapper: on a CUDA tensor it launches the kernel
of ``csrc/mrf_epilogue.cu`` (or raises), on a CPU tensor it runs the
plain version ``mrf_epilogue_plain``.  The kernel reads the
(B·H·W, Kv·Ka) response rows once and writes (B·H·W, Ka) floats, so the
K^2 log terms never reach device memory.
"""

from __future__ import annotations

import ctypes

import torch

from jointpose_torch import _build
from jointpose_torch.ops.mrf_xla import pairwise_conv

_SIGNATURES = {
    "mrf_epilogue_fwd": ([
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ], ctypes.c_int),
}


def mrf_epilogue_plain(resp: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: (B, H, W, Kv, Ka) responses -> (B, H, W, Ka) fp32."""
    x = resp.float() + biases.float()
    return torch.log(x.clamp_min(eps)).sum(dim=-2)


def mrf_epilogue(resp: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Fused Σ_v log(resp + bias) over (B, H, W, Kv, Ka) -> (B, H, W, Ka) fp32."""
    if resp.device.type == "cpu":
        return mrf_epilogue_plain(resp, biases, eps)
    if resp.dim() != 5:
        raise ValueError(f"resp must be (B, H, W, Kv, Ka), got {tuple(resp.shape)}")
    b, h, w, kv, ka = resp.shape
    if resp.device.type != "cuda" or biases.device != resp.device:
        raise ValueError("mrf_epilogue: resp and biases must lie on one CUDA device")
    if resp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mrf_epilogue: resp must be bf16 or f32, got {resp.dtype}")
    if biases.dtype != torch.float32 or tuple(biases.shape) != (kv, ka):
        raise ValueError(f"mrf_epilogue: biases must be f32 ({kv}, {ka})")
    if not resp.is_contiguous() or not biases.is_contiguous():
        raise ValueError("mrf_epilogue: resp and biases must be contiguous")
    lib = _build.load("mrf_epilogue", _SIGNATURES)
    out = torch.empty((b, h, w, ka), dtype=torch.float32, device=resp.device)
    with torch.cuda.device(resp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mrf_epilogue_fwd(
            resp.data_ptr(), int(resp.dtype == torch.bfloat16), biases.data_ptr(),
            out.data_ptr(), b * h * w, kv, ka, eps, stream,
        )
    _build.check(err, "mrf_epilogue_fwd")
    mrf_epilogue.launches += 1
    return out


mrf_epilogue.launches = 0


def mrf_message_pass_pallas(
    p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Pairwise conv in the compute dtype, then the fused epilogue.

    Same signature and semantics as ``mrf_message_pass_xla``.
    """
    resp = pairwise_conv(p, kernels)  # (B, H, W, Kv, Ka) in p's dtype
    return mrf_epilogue(resp, biases.float().contiguous(), eps)
