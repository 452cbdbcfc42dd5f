"""The coarse MRF pass's upsample and unary log (``ops/mrf_upsample.py``) on
the CPU: the wrapper's plain version is the composition the coarse pass
ran before the kernel, the backward kernel's gather (emulated in plain
PyTorch) is autograd's adjoint of ``F.interpolate``, its dp formula is
autograd's, and the wrapper refuses what the kernels cannot take.  The
kernels themselves are held on the card (``tests/test_torch_kernels_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from jointpose_torch import ops
from jointpose_torch.ops import mrf_upsample as mu
from jointpose_torch.ops.mrf_xla import mrf_message_pass_coarse, mrf_message_pass_xla

EPS = 1e-6
K = 9


def _composition(coarse, p, eps=EPS):
    """The coarse pass's last lines as they stood before the kernel."""
    h, w = p.shape[1], p.shape[2]
    up = F.interpolate(
        coarse.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=False
    ).permute(0, 2, 3, 1)
    unary = torch.log(p.float().clamp_min(eps))
    return unary + up


def _operands(b, hc, wc, s, dtype, seed=0, k=K):
    g = torch.Generator().manual_seed(seed)
    coarse = torch.randn(b, hc, wc, k, generator=g) * 3
    p = torch.rand(b, hc * s, wc * s, k, generator=g) * 1e-3
    p[..., 0] = 0.0  # exact zeros
    p[..., 1] *= 1e-3  # below eps
    return coarse, p.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,hc,wc,s", [(2, 30, 45, 2), (1, 5, 7, 3), (3, 3, 4, 4)])
def test_plain_version_is_the_composition(b, hc, wc, s, dtype):
    coarse, p = _operands(b, hc, wc, s, dtype)
    before = mu.mrf_upsample_log.launches
    got = mu.mrf_upsample_log(coarse, p, EPS)
    assert mu.mrf_upsample_log.launches == before  # CPU tensors never launch
    assert got.dtype == torch.float32 and torch.equal(got, _composition(coarse, p))


@pytest.mark.parametrize("stride", [2, 3])
def test_coarse_pass_ends_with_the_composition(stride):
    """``mrf_message_pass_coarse`` on the CPU, bit for bit, as it was: the
    message pass on the sum-pooled unaries, then the composition."""
    coarse, p = _operands(2, 4, 6, stride, torch.float32, seed=1)
    g = torch.Generator().manual_seed(2)
    kernels = torch.rand(5, 7, K, K, generator=g) * 0.1
    biases = torch.rand(K, K, generator=g) * 1e-3
    b, h, w, k = p.shape
    pc = p.reshape(b, h // stride, stride, w // stride, stride, k).sum(dim=(2, 4))
    want = _composition(mrf_message_pass_xla(pc, kernels, biases, eps=EPS), p)
    got = mrf_message_pass_coarse(p, kernels, biases, eps=EPS, stride=stride)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stride", [2, 3, 4])
@pytest.mark.parametrize("hc,wc", [(5, 5), (3, 7), (1, 4), (6, 1)])
def test_taps_cover_every_fine_index_once(hc, wc, stride):
    """Each fine index's two tap weights sum to 1 over the coarse indices
    the backward kernel tries for it: its tried range misses no tap."""
    for n in (hc, wc):
        weights = mu._gather_weights(n, stride)
        assert weights.shape == (n, n * stride, 2)
        torch.testing.assert_close(weights.sum(dim=(0, 2)), torch.ones(n * stride),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride", [2, 3, 4])
@pytest.mark.parametrize("hc,wc", [(5, 5), (3, 7), (1, 4), (6, 1)])
def test_forward_taps_are_the_upsample(hc, wc, stride):
    """The kernels' source indices and weights (``source_taps``), combined
    in the forward kernel's order, give ``F.interpolate``'s upsample."""
    coarse, _ = _operands(2, hc, wc, stride, torch.float32, seed=3)
    iy0, iy1, ly0, ly1 = mu.source_taps(hc * stride, hc)
    ix0, ix1, lx0, lx1 = mu.source_taps(wc * stride, wc)
    r0, r1 = coarse[:, iy0], coarse[:, iy1]
    lx0, lx1 = lx0[:, None], lx1[:, None]
    up = (ly0[:, None, None] * (lx0 * r0[:, :, ix0] + lx1 * r0[:, :, ix1])
          + ly1[:, None, None] * (lx0 * r1[:, :, ix0] + lx1 * r1[:, :, ix1]))
    want = F.interpolate(coarse.permute(0, 3, 1, 2), scale_factor=None,
                         size=(hc * stride, wc * stride), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(up, want, rtol=0, atol=2e-6 * want.abs().max().item())


@pytest.mark.parametrize("stride", [2, 3, 4])
@pytest.mark.parametrize("hc,wc", [(5, 5), (3, 7), (1, 4), (6, 1)])
def test_backward_gather_is_the_upsample_adjoint(hc, wc, stride):
    """The backward kernel's gather, emulated (its tried fine rows and
    columns, taps and fp32 weights), against autograd of ``F.interpolate``
    on the CPU, square and non-square maps, one-row and one-column maps
    whose every row is an edge row."""
    coarse, _ = _operands(2, hc, wc, stride, torch.float32, seed=4)
    coarse.requires_grad_(True)
    up = F.interpolate(coarse.permute(0, 3, 1, 2), size=(hc * stride, wc * stride),
                       mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    g = torch.randn(up.shape, generator=torch.Generator().manual_seed(5))
    (want,) = torch.autograd.grad(up, coarse, g)
    got = mu.dcoarse_emulated(g, stride)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want.double(), rtol=0,
                               atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_dp_formula_is_autograds(dtype):
    """The backward kernel's dp, g / p where p >= eps and else 0 in fp32,
    rounded to p's type, is autograd's gradient of the plain version, bit
    for bit, with exact zeros and values below eps among the unaries."""
    coarse, p = _operands(2, 4, 5, 2, dtype, seed=6)
    p.requires_grad_(True)
    out = mu.mrf_upsample_log_plain(coarse, p, EPS)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    (want,) = torch.autograd.grad(out, p, g)
    q = p.detach().float()
    got = torch.where(q >= EPS, g / q, torch.zeros(())).to(dtype)
    assert (q < EPS).any() and (q == 0).any()
    assert want.dtype == dtype and torch.equal(got, want)


def test_wrapper_raises_on_what_the_kernels_cannot_take():
    """A non-integer stride is refused on every device; a wrong type and a
    non-contiguous operand on the kernels' path (tensors off the CPU: meta
    tensors here, which then fail the device check)."""
    coarse, p = _operands(1, 4, 6, 2, torch.bfloat16)
    for bad in (p[:, :7], p[:, :, :11], p[:, :, :, :5], torch.cat([p, p])):
        with pytest.raises(ValueError, match="integer stride"):
            mu.mrf_upsample_log(coarse, bad.contiguous())
    meta = {"device": "meta"}
    c_m, p_m = coarse.to(**meta), p.to(**meta)
    with pytest.raises(TypeError):
        mu.mrf_upsample_log(c_m.double(), p_m)
    with pytest.raises(TypeError):
        mu.mrf_upsample_log(c_m, p_m.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        mu.mrf_upsample_log(c_m, p_m.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        mu.mrf_upsample_log(c_m.transpose(1, 2).contiguous().transpose(1, 2), p_m)
    with pytest.raises(ValueError, match="CUDA device"):
        mu.mrf_upsample_log(c_m, p_m)


def test_counters_are_launch_counters():
    counters = ops.launch_counters()
    assert (mu.mrf_upsample_log, "launches") in counters
    assert (mu.mrf_upsample_log_bwd, "launches") in counters


def test_costs_count_each_byte_once():
    coarse, p = _operands(128, 30, 45, 2, torch.bfloat16)
    n_bytes, n_ops = mu.fwd_cost(coarse, p)
    assert n_bytes == 4 * coarse.numel() + 2 * p.numel() + 4 * p.numel() == 43_545_600
    assert n_ops == 12 * p.numel()
    g = torch.zeros(p.shape)
    n_bytes, _ = mu.bwd_cost(g, p, coarse.numel())
    assert n_bytes == 4 * p.numel() + 2 * 2 * p.numel() + 4 * coarse.numel()
