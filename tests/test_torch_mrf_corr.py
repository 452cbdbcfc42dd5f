"""The grouped correlation's wrapper on the CPU (``ops/mrf_corr.py``): its
plain route is the fp32 grouped conv of ``ops/mrf_xla.grouped_conv`` and
launches nothing; its Toeplitz form (the kernel's arithmetic) equals it; its
tiling rule and cost; and ``grouped_conv_f32``, whose forward it is, keeps
its forward and gradients on the CPU."""

import pytest
import torch

from jointpose_torch.ops import mrf_corr as mc
from jointpose_torch.ops import mrf_xla as mx

# fp32 sums of the same exact products in another order.
SUM_RTOL = 1e-5


def _operands(b, h, w, kv, ka, wh, ww, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(b, h, w, kv, generator=g).to(dtype)
    kern = torch.nn.functional.softplus(torch.randn(wh, ww, 1, kv * ka, generator=g) - 3).to(dtype)
    return p, kern


def _rel(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


# (B, H, W, Kv, Ka, wh, ww): flagship's grid and window, a tensor-parallel
# source slice, odd and even windows, ragged sizes under a tile, a window
# taller and wider than the image, and one wider than four input chunks.
SHAPES = [(2, 30, 45, 9, 9, 17, 25), (2, 30, 45, 5, 9, 17, 25), (1, 12, 20, 9, 9, 11, 15),
          (2, 9, 13, 9, 9, 6, 8), (1, 7, 5, 5, 9, 4, 4), (1, 5, 3, 3, 9, 17, 25),
          (1, 9, 11, 2, 12, 45, 67)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_cpu_route_is_the_plain_grouped_conv_and_launches_nothing(shape):
    b, h, w, kv, ka, wh, ww = shape
    p, kern = _operands(*shape)
    before = mc.mrf_grouped_corr.launches
    got = mc.mrf_grouped_corr(p, kern, kv)
    assert mc.mrf_grouped_corr.launches == before
    want = mx.grouped_conv(p, kern, kv, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (b, h, w, kv * ka)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_toeplitz_form_equals_the_plain_version(shape):
    p, kern = _operands(*shape, seed=sum(shape))
    got = mc.mrf_grouped_corr_tiles(p, kern, shape[3])
    assert _rel(got, mc.mrf_grouped_corr_plain(p, kern, shape[3])) <= SUM_RTOL


def test_the_toeplitz_form_on_signed_values():
    g = torch.Generator().manual_seed(4)
    p = torch.randn(2, 10, 19, 9, generator=g).bfloat16()
    kern = torch.randn(6, 9, 1, 81, generator=g).bfloat16()
    assert _rel(mc.mrf_grouped_corr_tiles(p, kern, 9), mc.mrf_grouped_corr_plain(p, kern, 9)) \
        <= SUM_RTOL


@pytest.mark.parametrize("ww,chunks", [(1, 1), (9, 1), (10, 2), (25, 2), (26, 3), (67, 5)])
def test_an_output_tile_reads_the_input_chunks_its_window_spans(ww, chunks):
    # 8 output columns and a window ww wide span 8 + ww - 1 input columns.
    assert mc.chunks(ww) == chunks and 16 * chunks >= mc.TX + ww - 1 > 16 * (chunks - 1)


def test_the_tiling_rule_at_the_shapes_the_route_meets():
    assert mc.tiling(30, 9, 9, 17, 25) == (2, 2, 17)  # flagship: the window in one stage
    assert mc.tiling(30, 5, 9, 17, 25) == (2, 2, 17)  # a tensor-parallel slice
    assert mc.tiling(15, 9, 9, 17, 25) == (1, 2, 17)  # a spatial shard's rows
    assert mc.tiling(60, 9, 9, 11, 15) == (2, 2, 11)  # stride 1, an 11x15 window
    mt, kcc, dyc = mc.tiling(23, 9, 9, 45, 67)  # joint's window at stride 2
    n = -(-45 // dyc)
    assert (mt, kcc) == (2, 4) and n > 1 and dyc == -(-45 // n)  # kernel rows split evenly
    stage = 2 * (9 * (32 + dyc - 1) * (16 * kcc + 8) + dyc * 67 * 81)
    assert stage <= mc.STAGE_BUDGET


def test_the_tiling_rule_raises_where_a_block_cannot_hold_the_shape():
    with pytest.raises(ValueError, match="warps"):
        mc.tiling(30, 10, 9, 17, 25)
    with pytest.raises(ValueError, match="warps"):
        mc.tiling(30, 5, 10, 17, 25)  # two chunks of targets a source
    with pytest.raises(ValueError, match="shared memory"):
        mc.tiling(30, 9, 9, 3, 1000)


def test_the_cost_at_flagships_serving_batch():
    p, kern = _operands(128, 30, 45, 9, 9, 17, 25)
    n_bytes, n_ops = mc.corr_cost(p, kern, 9)
    assert n_ops == 2 * 128 * 30 * 45 * 81 * 425 == 11_897_280_000
    assert n_bytes == 2 * 128 * 30 * 45 * 9 + 2 * 425 * 81 + 4 * 128 * 30 * 45 * 81 == 59_166_450


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [(17, 25), (6, 8)])
def test_grouped_conv_f32_keeps_its_forward_and_gradients_on_the_cpu(dtype, window):
    p, kern = _operands(2, 10, 14, 9, 9, *window, dtype=dtype, seed=5)
    g = torch.randn(2, 10, 14, 81, generator=torch.Generator().manual_seed(6))
    a, b = p.clone().requires_grad_(True), kern.clone().requires_grad_(True)
    resp = mx.grouped_conv_f32(a, b, 9)
    assert torch.equal(resp.detach(), mx.grouped_conv(p, kern, 9, torch.float32))
    dp, dk = torch.autograd.grad(resp, (a, b), g)
    want_dp, want_dk = mx.grouped_conv_f32_bwd(g, p, kern, 9)
    assert dp.dtype == dk.dtype == dtype
    assert torch.equal(dp, want_dp) and torch.equal(dk, want_dk)


def test_the_launch_counter_is_replayed_with_the_dispatch_graphs():
    from jointpose_torch import ops

    assert (mc.mrf_grouped_corr, "launches") in ops.launch_counters()
