"""``ops/wide_conv.py``: the weight gradient of a wide stride-1 conv as
matrix products over shifted row slices, against autograd's gradients of
``F.conv2d`` on the CPU (fp32); on the card (marked ``cuda``) in bf16
against the fp32 conv of the same values."""

import pytest
import torch
import torch.nn.functional as F

from jointpose_torch.models.detector import Conv
from jointpose_torch.ops.wide_conv import takes_wide_route, weight_grad, wide_conv


def _operands(b, c, h, w, o, k, seed=0, dtype=torch.float32, device="cpu", channels_last=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g).to(device, dtype)
    x = x.permute(0, 3, 1, 2) if channels_last else x.permute(0, 3, 1, 2).contiguous()
    weight = (torch.randn(o, c, k, k, generator=g) / (c * k * k) ** 0.5).to(device, dtype)
    bias = torch.randn(o, generator=g).to(device, dtype)
    return x, weight, bias


@pytest.mark.parametrize("k, padding, hw, channels_last", [
    (9, (4, 4), (12, 17), True), (7, (3, 3), (9, 6), False), (9, (0, 4), (16, 11), True),
    (7, (0, 0), (13, 15), True),
])
def test_the_weight_gradient_is_autograd_s(k, padding, hw, channels_last):
    x, weight, _ = _operands(2, 5, *hw, 6, k, channels_last=channels_last)
    w = weight.clone().requires_grad_(True)
    y = F.conv2d(x, w, padding=padding)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    (want,) = torch.autograd.grad(y, [w], g)
    torch.testing.assert_close(weight_grad(x, g, k, padding), want, rtol=1e-5, atol=1e-5)


def test_the_wide_conv_and_its_gradients_are_conv2d_s():
    x, weight, bias = _operands(3, 4, 10, 14, 8, 9, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    got = wide_conv(*leaves, (4, 4))
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    grads = torch.autograd.grad(got, leaves, g)
    ref = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    want = F.conv2d(*ref, padding=(4, 4))
    torch.testing.assert_close(got, want)
    for a, b in zip(grads, torch.autograd.grad(want, ref, g)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_only_wide_stride_1_convs_on_the_card_take_the_route():
    x, weight, _ = _operands(1, 3, 8, 8, 4, 9)
    assert not takes_wide_route(x.bfloat16(), weight.bfloat16().requires_grad_(True), 1)
    conv = Conv(3, 4, 9)
    conv.weight.data.copy_(weight)
    conv.bias.data.zero_()
    torch.testing.assert_close(conv(x), F.conv2d(x, weight, conv.bias.detach(), padding=4))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [7, 9])
def test_the_bf16_route_on_the_card_matches_the_fp32_conv(k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the route is taken on CUDA alone")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, weight, bias = _operands(4, 64, 30, 45, 128, k, seed=k, dtype=torch.bfloat16, device="cuda")
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    assert takes_wide_route(leaves[0], leaves[1], 1)
    conv = Conv(64, 128, k).cuda()
    with torch.no_grad():
        conv.weight.copy_(weight.float())
        conv.bias.copy_(bias.float())
    got = conv(leaves[0])
    g = torch.randn(got.shape, device="cuda").bfloat16()
    got_grads = torch.autograd.grad(got, [leaves[0], conv.weight, conv.bias], g)
    ref = [t.float().clone().requires_grad_(True) for t in (x, weight, bias)]
    want = F.conv2d(*ref, padding=k // 2)
    for a, b in zip(got_grads, torch.autograd.grad(want, ref, g.float())):
        assert float((a.float() - b).abs().max() / b.abs().max()) < 1e-2
