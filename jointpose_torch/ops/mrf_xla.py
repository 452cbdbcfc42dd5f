"""MRF log-space message pass, direct-conv forward and backward
(``jointpose/ops/mrf_xla.py``).

    log p̄_A = Σ_v log( k_{A|v} ⊛ p_v + b_{v→A} )

All K^2 pairwise correlations run as one grouped ``F.conv2d``
(``groups=Kv``); output channel v*Ka + a is k_{a|v} ⊛ p_v.  The
correlation is the reference's SAME cross-correlation: a window of
extent k is padded (k-1)//2 before and k//2 after.

The message pass asks for fp32 responses.  Where p is in a narrower type
(bf16 on the card), the conv goes through ``grouped_conv_f32``, an
autograd function whose forward on the card is the hand-written
correlation of ``ops/mrf_corr.py`` (on the CPU, its plain version: the
fp32 grouped conv) and whose backward is the reference's hand-written
one: no grouped dgrad or wgrad, only dense convolutions.

- dL/dk is the v == v' diagonal of the weight gradient of the
  zero-embedded dense conv (``dense_embed``);
- dL/dp is one dense VALID conv with the width packed 8x into channels
  (``dp_s2d``) for odd windows and at most 32 groups, else the dense
  transposed conv.

Both take the cotangent rounded to p's type, accumulate in fp32 and
return p's and the kernels' type, as the reference does.  One deliberate
difference: the reference's dense transpose pads the flipped kernel
SAME, wrong for even windows; the port pads it as a transpose must (k//2
before, (k-1)//2 after).

``precision`` is taken and passed down as the reference does, and
changes nothing here: the reference's None and ``Precision.DEFAULT``
both leave its direct conv at the backend's default
(``jointpose/ops/mrf_xla.py:196-197``), and the port's conv runs at
PyTorch's (cuDNN's TF32 flag) for either value; the card's correlation of
narrow operands has exact products and fp32 sums whatever the flag.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jointpose_torch.ops import mrf_corr
from jointpose_torch.ops.mrf_fft import single_pass
from jointpose_torch.ops.mrf_upsample import mrf_upsample_log

# Width positions packed into channels by ``dp_s2d``, and the most groups
# it takes (beyond, the dense transpose has lanes enough).
S2D_WIDTH = 8
S2D_MAX_GROUPS = 32


def same_pad(n: int, k: int, s: int = 1) -> tuple[int, int]:
    """(before, after) padding of a SAME window: the reference's convention."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    # An NHWC tensor viewed as NCHW is channels_last in memory, so a conv
    # writes channels_last too and the permute back is free.
    return x.permute(0, 3, 1, 2)


def grouped_conv(p: torch.Tensor, kern: torch.Tensor, groups: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """SAME grouped correlation of NHWC ``p`` (B, H, W, Kv) with HWIO ``kern``
    (wh, ww, 1, Kv*Ka) in ``dtype``: (B, H, W, Kv*Ka), a channels_last view."""
    x = _nchw(p.to(dtype))
    weight = kern.to(dtype).permute(3, 2, 0, 1)  # (o = v*Ka + a, 1, wh, ww)
    (ht, hb), (wl, wr) = same_pad(p.shape[1], kern.shape[0]), same_pad(p.shape[2], kern.shape[1])
    if ht == hb and wl == wr:
        resp = F.conv2d(x, weight, padding=(ht, wl), groups=groups)
    else:
        resp = F.conv2d(F.pad(x, (wl, wr, ht, hb)), weight, groups=groups)
    return resp.permute(0, 2, 3, 1)


def dense_embed(kern: torch.Tensor, groups: int) -> torch.Tensor:
    """HWIO (wh, ww, 1, Kv*Ka) grouped kernel -> (wh, ww, Kv, Kv*Ka) dense
    kernel, zero off the v == v' diagonal: the same conv with zeros added."""
    wh, ww, _, vo = kern.shape
    k4 = kern.reshape(wh, ww, groups, vo // groups)
    eye = torch.eye(groups, dtype=kern.dtype, device=kern.device)
    # (wh, ww, v, v', a): k4[..., v, a] on the v == v' diagonal.
    kd = k4[:, :, :, None, :] * eye[None, None, :, :, None]
    return kd.reshape(wh, ww, groups, vo)


def _flipped_transpose(kern: torch.Tensor, groups: int) -> torch.Tensor:
    """The dense kernel of dL/dp: flipped in space, in and out swapped,
    (wh, ww, Kv*Ka, Kv)."""
    return dense_embed(kern, groups).flip(0, 1).transpose(2, 3)


def dk_dense(g: torch.Tensor, p: torch.Tensor, kern: torch.Tensor, groups: int) -> torch.Tensor:
    """dL/dk (wh, ww, 1, Kv*Ka) in the kernels' type: the v == v' diagonal of
    the dense-embedded conv's weight gradient, the cotangent ``g`` (B, H, W,
    Kv*Ka) rounded to p's type.  The off-diagonal entries are gradients of
    the structural zeros."""
    wh, ww, _, vo = kern.shape
    ka = vo // groups
    dt = p.dtype
    x = _nchw(p)
    (ht, hb), (wl, wr) = same_pad(p.shape[1], wh), same_pad(p.shape[2], ww)
    if ht != hb or wl != wr:
        x, (ht, wl) = F.pad(x, (wl, wr, ht, hb)), (0, 0)
    weight = dense_embed(kern.to(dt), groups).permute(3, 2, 0, 1)  # (v'*Ka + a, v, wh, ww)
    _, dkd, _ = torch.ops.aten.convolution_backward(
        _nchw(g.to(dt)), x, weight, None, [1, 1], [ht, wl], [1, 1], False, [0, 0], 1,
        [False, True, False])
    # (v', a, v, wh, ww) -> the diagonal, appended last: (a, wh, ww, v).
    dk = torch.diagonal(dkd.reshape(groups, ka, groups, wh, ww), dim1=0, dim2=2)
    return dk.permute(1, 2, 3, 0).reshape(wh, ww, 1, vo).to(kern.dtype)


def dp_s2d(g: torch.Tensor, kern: torch.Tensor, groups: int,
           p_dtype: torch.dtype) -> torch.Tensor:
    """dL/dp (B, H, W, Kv) in ``p_dtype`` as a width space-to-depth-x8 dense
    VALID conv, for odd windows.

    The dense transpose conv for dL/dp has only Kv output channels.
    Packing S = 8 width-shifted outputs into channels gives S*Kv of them
    at a tap overcharge of S*ceil((ww-1)/S + 1)/ww.  With x = S*Xo + ro
    and dx = S*q + r - ro,

        dp[b, y, x, v] = Σ_{dy,dx,c} kd_t[dy, dx, c, v] · g_pad[b, y+dy, x+dx, c]
                       = conv_VALID(g2, k2)[b, y, Xo, ro*Kv + v]

    where g2 packs width into channels ([X, r*Cin + c]) and
    k2[dy, q, r*Cin + c, ro*Kv + v] = kd_t[dy, S*q + r - ro, c, v], zero
    outside [0, ww).  The gather's indices are made on the kernels'
    device, so a CUDA graph captures the whole backward."""
    wh, ww, _, vo = kern.shape
    kv, s = groups, S2D_WIDTH
    b, h, w, cin = g.shape
    kd_t = _flipped_transpose(kern, groups)  # (wh, ww, cin, kv)
    nq = (ww - 1 + s - 1) // s + 1
    ar = torch.arange(max(nq, s), device=kern.device)
    dx = s * ar[:nq, None, None] + ar[None, :s, None] - ar[None, None, :s]  # (nq, r, ro)
    valid = (dx >= 0) & (dx < ww)
    kd_g = kd_t[:, dx.clamp(0, ww - 1)]  # (wh, nq, r, ro, cin, kv)
    kd_g = torch.where(valid[None, ..., None, None], kd_g, 0)
    k2 = kd_g.permute(0, 1, 2, 4, 3, 5).reshape(wh, nq, s * cin, s * kv)
    wblocks = -(-w // s)
    wpad = s * (wblocks + nq - 1)
    ph, pw = wh // 2, ww // 2
    gp = F.pad(g.to(p_dtype), (0, 0, pw, wpad - w - pw, ph, ph))
    g2 = gp.reshape(b, h + wh - 1, wpad // s, s * cin)
    out = F.conv2d(_nchw(g2), k2.to(p_dtype).permute(3, 2, 0, 1))  # (b, s*kv, h, wblocks)
    return out.permute(0, 2, 3, 1).reshape(b, h, wblocks * s, kv)[:, :, :w]


def dp_dense(g: torch.Tensor, kern: torch.Tensor, groups: int,
             p_dtype: torch.dtype) -> torch.Tensor:
    """dL/dp (B, H, W, Kv) in ``p_dtype`` as the dense transposed conv: the
    flipped kernel, padded k//2 before and (k-1)//2 after on each axis."""
    wh, ww = kern.shape[:2]
    # (kv, cin, wh, ww): the flipped kernel with in and out swapped.
    weight = _flipped_transpose(kern, groups).to(p_dtype).permute(3, 2, 0, 1)
    x = F.pad(_nchw(g.to(p_dtype)), (ww // 2, (ww - 1) // 2, wh // 2, (wh - 1) // 2))
    return F.conv2d(x, weight).permute(0, 2, 3, 1)


def grouped_conv_f32_bwd(g: torch.Tensor, p: torch.Tensor, kern: torch.Tensor, groups: int,
                         need: tuple[bool, bool] = (True, True)):
    """(dL/dp, dL/dk) of ``grouped_conv_f32`` for the cotangent ``g``; a
    gradient not ``need``-ed is None."""
    wh, ww = kern.shape[:2]
    dp = dk = None
    if need[0]:
        s2d = wh % 2 == 1 and ww % 2 == 1 and groups <= S2D_MAX_GROUPS
        dp = (dp_s2d if s2d else dp_dense)(g, kern, groups, p.dtype)
    if need[1]:
        dk = dk_dense(g, p, kern, groups)
    return dp, dk


class _GroupedConvF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, kern, groups):
        ctx.groups = groups
        ctx.save_for_backward(p, kern)
        # p and the kernels in a type fp32 holds exactly: the fp32 conv is
        # the narrow-operand conv with an fp32 result, on the card the
        # hand-written correlation of ``ops/mrf_corr.py``.
        return mrf_corr.mrf_grouped_corr(p.contiguous(), kern.contiguous(), groups)

    @staticmethod
    def backward(ctx, g):
        p, kern = ctx.saved_tensors
        dp, dk = grouped_conv_f32_bwd(g, p, kern, ctx.groups, ctx.needs_input_grad[:2])
        return dp, dk, None


def grouped_conv_f32(p: torch.Tensor, kern: torch.Tensor, groups: int) -> torch.Tensor:
    """The grouped conv of ``grouped_conv`` with an fp32 result, whatever the
    type of p and ``kern`` (both of one type), differentiated by the
    reference's dense backward (module docstring)."""
    return _GroupedConvF32.apply(p, kern, groups)


def pairwise_conv(
    p: torch.Tensor, kernels: torch.Tensor, out_dtype: torch.dtype | None = None,
    precision: str | None = None,
) -> torch.Tensor:
    """All Kv*Ka pairwise correlations as one grouped conv.

    Args:
      p: (B, H, W, Kv) unary heatmaps.
      kernels: (wh, ww, Kv, Ka); kernels[:, :, v, a] is k_{a|v}.
      out_dtype: float32 computes in fp32 whatever p's dtype (the
        reference's fp32-accumulator output; a narrower p takes
        ``grouped_conv_f32``, with the kernels cast to p's dtype, as the
        reference takes its custom VJP); None keeps p's dtype.
      precision: None, 'high' or 'default', all the backend's default.
    Returns:
      (B, H, W, Kv, Ka) responses, contiguous (one row of Kv*Ka per pixel).
    """
    wh, ww, kv, ka = kernels.shape
    b, h, w, _ = p.shape
    single_pass(precision)  # validates the value
    if p.shape[-1] != kv:
        raise ValueError(f"p {tuple(p.shape)} does not match kernels {tuple(kernels.shape)}")
    # HWIO (wh, ww, 1, v*Ka + a): group v holds the Ka kernels of source v.
    kern = kernels.reshape(wh, ww, 1, kv * ka)
    if out_dtype == torch.float32 and p.dtype != torch.float32:
        resp = grouped_conv_f32(p, kern.to(p.dtype), kv)
    else:
        resp = grouped_conv(p, kern, kv, torch.float32 if out_dtype == torch.float32 else p.dtype)
    return resp.contiguous().reshape(b, h, w, kv, ka)


def mrf_message_pass_xla(
    p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6,
    precision: str | None = None,
) -> torch.Tensor:
    """Log-space message pass; returns unnormalized log p̄ (B, H, W, K) fp32."""
    resp = pairwise_conv(p, kernels, out_dtype=torch.float32, precision=precision)
    resp = resp + biases.float()
    return torch.log(resp.clamp_min(eps)).sum(dim=-2)


def mrf_message_pass_coarse(
    p: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    eps: float = 1e-6,
    stride: int = 2,
    message_pass=None,
    precision: str | None = None,
) -> torch.Tensor:
    """Coarse message pass (MRFConfig.stride > 1):

        log p̄_A = log p_A  +  up( Σ_v log( k_{A|v} ⊛ pool(p)_v + b ) )

    with a sum-pool to the coarse grid and a bilinear (half-pixel) upsample
    back, the log and the upsample as one step (``ops/mrf_upsample.py``: the
    kernel on the card).  Returns (B, H, W, K) fp32.
    """
    b, h, w, k = p.shape
    if h % stride or w % stride:
        raise ValueError(f"p {tuple(p.shape)} is not divisible by stride {stride}")
    pc = p.reshape(b, h // stride, stride, w // stride, stride, k).sum(dim=(2, 4))
    pass_fn = message_pass or mrf_message_pass_xla
    coarse = pass_fn(pc, kernels, biases, eps=eps, precision=precision)
    return mrf_upsample_log(coarse.contiguous(), p.contiguous(), eps)


def mrf_message_pass_direct(
    p: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor, eps: float = 1e-6,
    precision: str | None = None,
) -> torch.Tensor:
    """Direct-space oracle: log Π_v max(k⊛p_v + b, eps), for tests.

    Mathematically the log-space pass of ``mrf_message_pass_xla``; the
    product underflows for large K, which is why the model sums logs.
    """
    resp = pairwise_conv(p, kernels, precision=precision).float()
    return torch.log((resp + biases.float()).clamp_min(eps).prod(dim=-2))
