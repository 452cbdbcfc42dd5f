"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with sm_90a and ``nvcc``, and
skip elsewhere.  On the card, where JAX (which ``tests/conftest.py``
imports) need not be installed:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` runs the same comparisons at the full main-path shapes.
"""

import pytest
import torch

from jointpose_torch.configs import AugmentConfig, MRFConfig
from jointpose_torch.data.augment import inverse_affine, random_augment_params
from jointpose_torch.models.mrf import SpatialModel
from jointpose_torch.ops import fft_conv as tfc
from jointpose_torch.ops import mrf_corr as tmc
from jointpose_torch.ops import mrf_epilogue as tme
from jointpose_torch.ops import mrf_fft_fused as tmff
from jointpose_torch.ops import mrf_upsample as tmu
from jointpose_torch.ops import warp as tw
from jointpose_torch.ops.mrf_fft import forward_ffts
from jointpose_torch.ops.mrf_xla import pairwise_conv

pytestmark = pytest.mark.cuda

# max|kernel - plain| / max|plain|: the reference's parity tolerance for
# every MRF message-pass path (BENCH_r05.json parity_tolerances).
KERNEL_RTOL = 1e-3
# The reference's tolerance for its shear kernel against its oracle
# (tests/test_warp_pallas.py), on pixels in [0, 1].
WARP_ATOL = 2e-5
# Fourier head-conv tails, max|kernel - plain| / max|plain|: in f32 the
# reference's bound for its fused tail against its XLA tail
# (tests/test_fft_conv.py); in bf16 K_f, R and the output round, so another
# summation order flips roundings by one bf16 step (2^-8 of the largest
# value); two steps are allowed.
TAIL_RTOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}
# The grouped correlation against the fp32 conv of the same bf16 (fp16)
# values: both products are exact, the fp32 sums of wh*ww of them run in
# another order, some units in the last place of the largest response.
CORR_RTOL = 1e-5
K = 9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(hw, win, batch, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(batch, hw[0] * hw[1], K, generator=g).softmax(dim=1)
    p = p.reshape(batch, *hw, K).to(device, dtype)
    kernels = torch.nn.functional.softplus(torch.randn(*win, K, K, generator=g) - 3).to(device)
    biases = torch.nn.functional.softplus(torch.randn(K, K, generator=g) - 6).to(device)
    return p, kernels, biases


def _rel(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,win", [((30, 45), (17, 25)), ((7, 5), (3, 3))])
def test_epilogue_kernel_matches_plain(cuda, dtype, hw, win):
    p, kernels, biases = _inputs(hw, win, 3, dtype, cuda)
    resp = pairwise_conv(p, kernels.to(dtype))
    before = tme.mrf_epilogue.launches
    got = tme.mrf_epilogue(resp, biases)
    assert tme.mrf_epilogue.launches == before + 1
    assert _rel(got, tme.mrf_epilogue_plain(resp, biases)) <= KERNEL_RTOL


# (B, H, W, Kv, Ka) with B*H*W no multiple of 8 or 4, Kv*Ka other than 81,
# Kv above one chunk of the product (16), and a single row.
EPILOGUE_FWD_SHAPES = [(1, 7, 11, 9, 9), (3, 5, 7, 9, 9), (2, 13, 3, 4, 5), (1, 1, 1, 9, 9),
                       (2, 9, 10, 14, 14), (1, 3, 3, 40, 7)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EPILOGUE_FWD_SHAPES)
def test_epilogue_fwd_kernel_on_ragged_rows(cuda, dtype, shape):
    g = torch.Generator().manual_seed(sum(shape))
    resp = (torch.rand(shape, generator=g) * 0.02).to(cuda, dtype)
    biases = (torch.rand(shape[-2:], generator=g) * 1e-3).to(cuda)
    resp.view(-1)[::7] = -1.0  # clamped at eps
    got = tme.mrf_epilogue_fwd(resp, biases)
    assert got.shape == shape[:3] + shape[-1:] and got.dtype == torch.float32
    # One log of a product per chunk against the plain version's logs added
    # one by one: a rounding apart (1e-6 of the result), and the same on a
    # second run.
    assert _rel(got, tme.mrf_epilogue_plain(resp, biases)) <= 1e-6
    assert torch.equal(tme.mrf_epilogue_fwd(resp, biases), got)


def test_epilogue_fwd_kernel_passes_on_non_finite_responses(cuda):
    resp = torch.rand(1, 4, 8, K, K, device=cuda) * 0.02
    resp[0, 0, 0, 0, 0], resp[0, 0, 1, 2, 3], resp[0, 2, 2, 4, 4] = float("inf"), float("nan"), 3e38
    biases = torch.zeros(K, K, device=cuda)
    got = tme.mrf_epilogue_fwd(resp, biases)
    # The kernel's clamp (fmaxf) reads a NaN response as eps, where the plain
    # version's clamp_min passes it on: the plain version of a zero there.
    want = tme.mrf_epilogue_plain(torch.where(resp.isnan(), 0.0, resp), biases)
    assert torch.isinf(got[0, 0, 0, 0]) and torch.equal(torch.isfinite(got), torch.isfinite(want))
    finite = torch.isfinite(want)
    assert _rel(got[finite], want[finite]) <= 1e-6


def test_fit_tiny_on_the_card(cuda, tmp_path):
    import dataclasses

    from jointpose_torch import get_config
    from jointpose_torch.predict import build_predictor, restore_params
    from jointpose_torch.train import fit

    cfg = get_config("tiny")
    cfg = cfg.replace(
        mrf=dataclasses.replace(cfg.mrf, impl="pallas", stride=2),
        augment=dataclasses.replace(cfg.augment, warp_impl="shear"),
        train=dataclasses.replace(cfg.train, detector_steps=3, joint_steps=3, eval_every=3,
                                  log_every=3),
    )
    counters = (tw.shear_warp, tme.mrf_epilogue, tme.mrf_epilogue_bwd)
    before = [fn.launches for fn in counters]
    result = fit(cfg, str(tmp_path), eval_max_batches=1)
    # 1 warp launch a step; the epilogue in 3 joint steps and the joint-stage eval; its backward in 3.
    assert [fn.launches - b for fn, b in zip(counters, before)] == [6, 4, 3]
    assert result.state.step == 6 and result.metrics["eval_stage"] == "joint"
    assert all(p.device.type == "cuda" for p in result.state.model.parameters())
    state_dict, step = restore_params(cfg, str(tmp_path / "checkpoints"))
    images = torch.randint(0, 256, (2, 48, 64, 3), dtype=torch.uint8)
    want = build_predictor(cfg, result.state.model.state_dict())(images)
    got = build_predictor(cfg, state_dict)(images)
    assert step == 6 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# max|kernel - plain| / max|plain| of the fused Fourier tail: its 3xTF32
# products must stay near fp32 where the log amplifies small responses
# (the reference's on-chip MRF parity is 1.4e-5, BENCH_r05.json).
FFT_TAIL_RTOL = 2e-5
# (hw, window, batch, Kv, Ka, peaked): the paper geometry; an even Pw (a
# Nyquist bin) with 9 joints; two row tiles; two column tiles with Kv != Ka
# and batch 3; unaries concentrated on a few pixels, so that most responses
# lie below the biases and many below eps; one image with a tall transform
# (Ph=136: two R stages fit, not three); and 32 images, where a block's run
# of (tile, v) units covers several whole tiles.
FFT_TAIL_CASES = [((60, 90), (45, 67), 2, K, K, False), ((12, 16), (11, 15), 2, K, K, False),
                  ((70, 33), (9, 7), 2, K, K, False), ((13, 100), (6, 8), 3, 5, 7, False),
                  ((60, 90), (45, 67), 3, 4, K, True), ((12, 16), (11, 15), 3, K, K, True),
                  ((100, 40), (37, 21), 1, K, K, False), ((12, 16), (11, 15), 32, K, K, False)]


def _fft_tail_operands(cuda, hw, win, batch, kv, ka, peaked):
    g = torch.Generator().manual_seed(0)
    logits = (40.0 if peaked else 1.0) * torch.randn(batch, hw[0] * hw[1], kv, generator=g)
    p = logits.softmax(dim=1).reshape(batch, *hw, kv).to(cuda)
    kernels = torch.nn.functional.softplus(torch.randn(*win, kv, ka, generator=g) - 3).to(cuda)
    biases = torch.nn.functional.softplus(torch.randn(kv, ka, generator=g) - 6).to(cuda)
    if peaked:
        # Kernels of the spatial model's own scale (near 1 / window area), half
        # of their taps zero, and biases near 1e-4: fp32's own noise in a
        # response stays well below eps, so the comparison is about the kernel.
        kernels = kernels / (0.05 * win[0] * win[1])
        kernels = kernels * (torch.rand(kernels.shape, generator=g) < 0.5).to(cuda)
        biases = torch.nn.functional.softplus(torch.randn(kv, ka, generator=g) - 9).to(cuda)
    pf, kf, tables = forward_ffts(p, kernels)
    return tuple(t.contiguous() for t in pf), tuple(t.contiguous() for t in kf), tables, biases


@pytest.mark.parametrize("hw,win,batch,kv,ka,peaked", FFT_TAIL_CASES)
def test_fft_tail_kernel_matches_plain(cuda, hw, win, batch, kv, ka, peaked):
    pf, kf, tables, biases = _fft_tail_operands(cuda, hw, win, batch, kv, ka, peaked)
    before = tmff.fused_tail.launches
    got = tmff.fused_tail(pf, kf, tables, biases)
    assert tmff.fused_tail.launches == before + 1
    want = tmff.fused_tail_plain(pf, kf, tables, biases)
    assert got.shape == want.shape == (batch, ka, *hw)
    assert _rel(got, want) <= FFT_TAIL_RTOL
    assert torch.equal(tmff.fused_tail(pf, kf, tables, biases), got)  # parts add in a fixed order


def test_wrappers_raise_on_tensors_they_cannot_take(cuda):
    p, kernels, biases = _inputs((6, 8), (3, 3), 1, torch.float32, cuda)
    resp = pairwise_conv(p, kernels)
    with pytest.raises(ValueError, match="contiguous"):
        tme.mrf_epilogue(resp.transpose(1, 2), biases)
    with pytest.raises(TypeError):
        tme.mrf_epilogue(resp.half(), biases)
    pf, kf, tables = forward_ffts(p, kernels)
    with pytest.raises(ValueError):
        tmff.fused_tail(pf, kf, tables, biases.double())


# (B, H, W, Kv, Ka): the training shape; rows that are no multiple of a
# vector's 8 (bf16) or 4 (f32) rows; Kv*Ka other than 81, below a vector's
# width, and above one block's 256 threads.
EPILOGUE_BWD_SHAPES = [(32, 30, 45, K, K), (3, 7, 5, K, K), (1, 13, 1, 2, 3), (1, 1, 5, 3, 3),
                       (2, 9, 11, 20, 20)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", EPILOGUE_BWD_SHAPES)
def test_epilogue_bwd_kernel_matches_plain_and_repeats(cuda, dtype, shape):
    b, h, w, kv, ka = shape
    gen = torch.Generator().manual_seed(1)
    resp = (torch.rand(b, h, w, kv, ka, generator=gen) * 0.01 - 0.001).to(cuda, dtype)
    biases = (torch.rand(kv, ka, generator=gen) * 1e-3).to(cuda)
    g = torch.randn(b, h, w, ka, generator=gen).to(cuda)
    before = tme.mrf_epilogue_bwd.launches
    dresp, dbias = tme.mrf_epilogue_bwd(resp, biases, g)
    assert tme.mrf_epilogue_bwd.launches == before + 1
    assert dresp.dtype == dtype and dbias.dtype == torch.float32
    want_dresp, want_dbias = tme.mrf_epilogue_bwd_plain(resp, biases, g)
    assert torch.equal(dresp, want_dresp)  # the same fp32 operations per value
    assert _rel(dbias, want_dbias) <= KERNEL_RTOL
    again = tme.mrf_epilogue_bwd(resp, biases, g)
    assert torch.equal(again[0], dresp) and torch.equal(again[1], dbias)  # fixed summation order


@pytest.mark.parametrize("entry", ["shear_warp", "shear_warp_rowmajor"])
@pytest.mark.parametrize("shape", [(32, 240, 360, 3), (3, 17, 29, 2)])
def test_shear_warp_kernels_match_plain(cuda, entry, shape):
    b, h, w, _ = shape
    images = torch.rand(shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    draw = random_augment_params(torch.Generator().manual_seed(3), b,
                                 AugmentConfig(crop_frac_range=(0.8, 1.0)), (h, w))
    a_inv, b_inv = (t.to(cuda) for t in inverse_affine(draw, (h, w)))
    fn = getattr(tw, entry)
    before = fn.launches
    got = fn(images, a_inv, b_inv)
    # Each orientation's fused kernel, once.
    assert fn.launches == before + 1
    want = tw.shear_warp_reference(images, a_inv, b_inv)
    assert (got - want).abs().max().item() <= WARP_ATOL


def _extreme_affines(batch, h, w):
    """Rotations of ±60°, scales 0.5 and 2, flips and a small a11."""
    import math

    maps = []
    for angle, scale, flip in ((60.0, 0.5, 1.0), (-60.0, 2.0, -1.0), (45.0, 2.0, 1.0)):
        t = math.radians(angle)
        rot = torch.tensor([[math.cos(t), -math.sin(t)], [math.sin(t), math.cos(t)]])
        maps.append(rot @ torch.diag(torch.tensor([flip, 1.0])) / scale)
    maps.append(torch.tensor([[0.3, 1.1], [-0.9, 1e-3]]))
    a_inv = torch.stack([maps[i % len(maps)] for i in range(batch)])
    centre = torch.tensor([(w - 1) / 2, (h - 1) / 2])
    return a_inv, centre - torch.einsum("bij,j->bi", a_inv, centre) + 1.5


# (B, H, W, C): the training shape (strips of 8 columns); a ragged last
# strip and two channels; an image too tall for wide strips (1 column).
FUSED_WARP_SHAPES = [(32, 240, 360, 3), (3, 17, 29, 2), (2, 3000, 7, 3)]


@pytest.mark.parametrize("extreme", [False, True], ids=["full_draw", "extreme"])
@pytest.mark.parametrize("shape", FUSED_WARP_SHAPES)
def test_fused_shear_warp_is_bit_equal_to_its_strips(cuda, shape, extreme):
    b, h, w, _ = shape
    images = torch.rand(shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    if extreme:
        a_inv, b_inv = _extreme_affines(b, h, w)
    else:
        a_inv, b_inv = inverse_affine(random_augment_params(
            torch.Generator().manual_seed(5), b, AugmentConfig(crop_frac_range=(0.8, 1.0)), (h, w)),
            (h, w))
    a_inv, b_inv = a_inv.to(cuda), b_inv.to(cuda)
    before = tw.shear_warp.launches
    got = tw.shear_warp(images, a_inv, b_inv)
    assert tw.shear_warp.launches == before + 1
    assert (got - tw.shear_warp_reference(images, a_inv, b_inv)).abs().max().item() <= WARP_ATOL
    assert torch.equal(got, tw.shear_warp_strips(images.cpu(), a_inv.cpu(), b_inv.cpu()).to(cuda))


@pytest.mark.parametrize("extreme", [False, True], ids=["full_draw", "extreme"])
@pytest.mark.parametrize("shape", FUSED_WARP_SHAPES)
def test_fused_rowmajor_warp_is_bit_equal_to_its_strips(cuda, shape, extreme):
    """The row-major orientation in one launch, its strip's intermediate as
    (TW, H, C): its strips' operations in their order, and the production
    orientation's values."""
    b, h, w, _ = shape
    images = torch.rand(shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    if extreme:
        a_inv, b_inv = _extreme_affines(b, h, w)
    else:
        a_inv, b_inv = inverse_affine(random_augment_params(
            torch.Generator().manual_seed(5), b, AugmentConfig(crop_frac_range=(0.8, 1.0)), (h, w)),
            (h, w))
    a_inv, b_inv = a_inv.to(cuda), b_inv.to(cuda)
    before = tw.shear_warp_rowmajor.launches
    got = tw.shear_warp_rowmajor(images, a_inv, b_inv)
    assert tw.shear_warp_rowmajor.launches == before + 1
    assert torch.equal(got, tw.shear_warp(images, a_inv, b_inv))
    assert (got - tw.shear_warp_reference(images, a_inv, b_inv)).abs().max().item() <= WARP_ATOL
    strips = tw.shear_warp_strips(images.cpu(), a_inv.cpu(), b_inv.cpu(), rowmajor=True)
    assert torch.equal(got, strips.to(cuda))


@pytest.mark.parametrize("mrf", [MRFConfig(window=(5, 7), impl="pallas", stride=2),
                                 MRFConfig(window=(5, 7), impl="fft", use_pallas=True)],
                         ids=["epilogue", "fft_fused"])
def test_spatial_model_gradients_on_card_match_cpu(cuda, mrf):
    """Gradients of the spatial model's parameters through each kernel
    wrapper: an output that autograd cannot trace back would give zeros
    (or None) on the card and the right values on the CPU."""
    p, _, _ = _inputs((12, 16), (5, 7), 2, torch.float32, "cpu", seed=4)
    cot = torch.randn(p.shape, generator=torch.Generator().manual_seed(5))
    grads = {}
    for device in ("cpu", cuda):
        model = SpatialModel(mrf, K).to(device)
        with torch.no_grad():
            model.raw_kernels += 0.5 * torch.randn(
                model.raw_kernels.shape, generator=torch.Generator().manual_seed(6)).to(device)
        (model(p.to(device)) * cot.to(device)).sum().backward()
        grads[torch.device(device).type] = (model.raw_kernels.grad, model.raw_bias.grad)
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got is not None and got.abs().max() > 0
        assert _rel(got.cpu(), want) <= KERNEL_RTOL


def _tail_operands(geom, dtype, device, seed=7):
    b, h, w, kh, ci, co = geom
    t = tfc._conv_tables((h, w), (kh, kh), device, 8, dtype)
    ph, g = t["gr_re"].shape[0], t["gc_re"].shape[0]
    gen = torch.Generator().manual_seed(seed)
    xr, xi = (torch.randn(g, ph, b, ci, generator=gen).to(device, dtype) for _ in range(2))
    ar, ai = ((torch.randn(g, kh, ci, co, generator=gen) / 30).to(device, dtype) for _ in range(2))
    return t, xr, xi, ar, ai


# (B, H, W, kh, Ci, Co): the paper head at batch 2; ragged sizes in every
# tiled dimension of the CUDA-core version (Co % 32, Ci % 8, Ph % 16,
# H % 10, batch 11 > 8); and channel counts the bf16 tensor-core version
# takes, with ragged row bins, output rows and batch tiles.
TAIL_GEOMETRIES = [(2, 60, 90, 9, 128, 512), (3, 13, 10, 5, 11, 37), (11, 21, 10, 3, 20, 40),
                   (5, 21, 12, 5, 32, 64), (11, 21, 12, 5, 32, 64)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geom", TAIL_GEOMETRIES)
@pytest.mark.parametrize("entry", ["tail_kdft_resident", "tail_kdft", "tail_kf"])
def test_fft_conv_tail_kernels_match_plain(cuda, entry, geom, dtype):
    t, xr, xi, ar, ai = _tail_operands(geom, dtype, cuda)
    want = tfc.tail_kdft_plain(xr, xi, ar, ai, t)
    fn = getattr(tfc, entry)
    if entry == "tail_kf":
        ar, ai = (v.contiguous() for v in tfc._kf_from_a(ar, ai, t))
    before = fn.launches
    got = fn(xr, xi, ar, ai, t)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= TAIL_RTOL[dtype]


def test_fft_conv2d_on_card_matches_cudnn_and_steers(cuda, monkeypatch):
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(2, 20, 24, 16, generator=gen).to(cuda)
    k = torch.randn(9, 9, 16, 32, generator=gen).to(cuda)
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=4).permute(0, 2, 3, 1)
    for name in tfc.TAIL_PREFERENCE:
        monkeypatch.setattr(tfc, "TAIL_PREFERENCE", (name,))
        fn = getattr(tfc, f"tail_{name}")
        before = fn.launches
        assert _rel(tfc.fft_conv2d(x, k), want) <= 1e-4
        assert fn.launches == before + 1
    # Gradients on the card recompute the plain route.
    monkeypatch.undo()
    x.requires_grad_(True)
    tfc.fft_conv2d(x, k).square().sum().backward()
    assert x.grad is not None and x.grad.abs().max() > 0


def test_fft_conv_tail_wrappers_raise(cuda):
    t, xr, xi, ar, ai = _tail_operands((3, 13, 10, 5, 11, 37), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.tail_kdft(xr, xi.transpose(2, 3), ar, ai, t)
    with pytest.raises(TypeError):
        tfc.tail_kdft(xr.half(), xi.half(), ar.half(), ai.half(), t)
    big = _tail_operands((17, 13, 10, 5, 8, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="tail_fits"):
        tfc.tail_kdft_resident(*big[1:], big[0])  # more than 16 images in one block


# The single-pass form (MRF precision 'default'): against fp32 the
# reference's bar for single-pass precision, 0.4% max relative output
# error (jointpose/evaluate.py --mrf-precision); against its own arithmetic
# in plain PyTorch the summation order alone differs, which can move a
# TF32 rounding of T by one step.
SINGLE_PASS_RTOL = 4e-3


@pytest.mark.parametrize("hw,win,batch,kv,ka,peaked", FFT_TAIL_CASES)
def test_fft_tail_single_pass_kernel_matches_plain(cuda, hw, win, batch, kv, ka, peaked):
    pf, kf, tables, biases = _fft_tail_operands(cuda, hw, win, batch, kv, ka, peaked)
    before = (tmff.fused_tail.launches, tmff.fused_tail.launches_1pass)
    got = tmff.fused_tail(pf, kf, tables, biases, precision="default")
    assert (tmff.fused_tail.launches, tmff.fused_tail.launches_1pass) == (before[0], before[1] + 1)
    emulated = tmff.fused_tail_emulated(pf, kf, tables, biases, passes=1)
    assert got.shape == emulated.shape == (batch, ka, *hw)
    assert _rel(got, emulated) <= KERNEL_RTOL
    if not peaked:  # responses far below the biases are where one pass errs most
        assert _rel(got, tmff.fused_tail_plain(pf, kf, tables, biases)) <= SINGLE_PASS_RTOL
    assert torch.equal(tmff.fused_tail(pf, kf, tables, biases, precision="default"), got)


# (hw, window, batch): the paper geometry at the batches the server and
# the trainer give the single-pass tail.
JOINT_BATCHES = [((60, 90), (45, 67), b) for b in (1, 8, 16, 32)]


@pytest.mark.parametrize("hw,win,batch", JOINT_BATCHES)
def test_wgmma_tail_matches_its_emulation_and_repeats(cuda, hw, win, batch):
    """The wgmma kernel against one TF32 pass emulated, its own grouping of
    the sums emulated, and fp32; then a rerun, bit-identical."""
    pf, kf, tables, biases = _fft_tail_operands(cuda, hw, win, batch, K, K, False)
    before = tmff.fused_tail.launches_1pass
    got = tmff.fused_tail(pf, kf, tables, biases, precision="default")
    assert tmff.fused_tail.launches_1pass == before + 1
    assert _rel(got, tmff.fused_tail_emulated(pf, kf, tables, biases, passes=1)) <= KERNEL_RTOL
    chunked = tmff.fused_tail_emulated(pf, kf, tables, biases, passes=1, chunk=32)
    assert _rel(got, chunked) <= KERNEL_RTOL
    assert _rel(got, tmff.fused_tail_plain(pf, kf, tables, biases)) <= SINGLE_PASS_RTOL
    assert torch.equal(tmff.fused_tail(pf, kf, tables, biases, precision="default"), got)


def test_wgmma_tail_refuses_a_geometry_it_cannot_hold(cuda):
    """Ph = 449 rows of the DFT: the resident tables alone pass the
    block's shared memory; the wrapper raises, naming the limit."""
    pf, kf, tables, biases = _fft_tail_operands(cuda, (300, 8), (150, 3), 1, 2, 2, False)
    with pytest.raises(ValueError, match="232448"):
        tmff.fused_tail(pf, kf, tables, biases, precision="default")


def test_spatial_model_gradients_at_default_precision_on_card_match_cpu(cuda):
    """The autograd guard of the single-pass form: its forward and the
    backward's recompute at one TF32 pass, against fp32 on the CPU."""
    mrf = MRFConfig(window=(5, 7), impl="fft", use_pallas=True, precision="default")
    p, _, _ = _inputs((12, 16), (5, 7), 2, torch.float32, "cpu", seed=4)
    cot = torch.randn(p.shape, generator=torch.Generator().manual_seed(5))
    before = tmff.fused_tail.launches_1pass
    grads = {}
    for device in ("cpu", cuda):
        model = SpatialModel(mrf, K).to(device)
        with torch.no_grad():
            model.raw_kernels += 0.5 * torch.randn(
                model.raw_kernels.shape, generator=torch.Generator().manual_seed(6)).to(device)
        (model(p.to(device)) * cot.to(device)).sum().backward()
        grads[torch.device(device).type] = (model.raw_kernels.grad, model.raw_bias.grad)
    assert tmff.fused_tail.launches_1pass == before + 1
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got is not None and got.abs().max() > 0
        assert _rel(got.cpu(), want) <= SINGLE_PASS_RTOL


def test_high_precision_ignores_the_global_tf32_flag(cuda):
    """'high' is fp32 whatever the process-wide flag says, and the flag is
    put back; 'default' is one TF32 pass whatever it says."""
    from jointpose_torch.ops.mrf_fft import mrf_message_pass_fft

    p, kernels, biases = _inputs((30, 40), (21, 31), 2, torch.float32, cuda, seed=7)
    fns = (mrf_message_pass_fft, tmff.mrf_message_pass_fft_fused)
    want = {(fn, prec): fn(p, kernels, biases, precision=prec)
            for fn in fns for prec in ("high", "default")}
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        for (fn, prec), out in want.items():
            assert torch.equal(fn(p, kernels, biases, precision=prec), out)
            assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for fn in fns:
        one, fp32 = want[fn, "default"], want[fn, "high"]
        assert not torch.equal(one, fp32) and _rel(one, fp32) <= SINGLE_PASS_RTOL


# (B, H, W, kh, Ci, Co) for the build form's ring version: the paper head
# at serving batch 8 and training batch 32; Ph not a multiple of 16 (H 13:
# Ph 17 -> 24, and 21 -> 24), batch 1, 3 and 16, kernel heights 5 and 9.
RING_GEOMETRIES = [(8, 60, 90, 9, 128, 512), (32, 60, 90, 9, 128, 512), (1, 13, 10, 5, 32, 64),
                   (3, 13, 10, 9, 32, 64), (16, 13, 10, 9, 32, 64), (32, 21, 12, 5, 32, 64)]


# The resident entry takes at most 16 images.
RING_CASES = [(entry, geom) for entry in ("kdft_resident", "kdft") for geom in RING_GEOMETRIES
              if entry == "kdft" or geom[0] <= 16]


@pytest.mark.parametrize("entry,geom", RING_CASES)
def test_ring_tail_matches_plain_and_repeats(cuda, entry, geom):
    b, h, w, kh, ci, co = geom
    t, xr, xi, ar, ai = _tail_operands(geom, torch.bfloat16, cuda)
    ph = xr.shape[1]
    body = tfc.tail_body(entry, ph, b, ci, co, kh, h, 2)
    assert body == "ring"
    fn = getattr(tfc, f"tail_{entry}")
    before = fn.launches
    got = fn(xr, xi, ar, ai, t)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert _rel(got, tfc.tail_kdft_plain(xr, xi, ar, ai, t)) <= TAIL_RTOL[torch.bfloat16]
    assert torch.equal(fn(xr, xi, ar, ai, t), got)


def test_fourier_head_gradients_on_card_match_cpu(cuda):
    """The autograd guard of the build form: bf16 features through the
    ring version in the forward, the plain route recomputed in the
    backward, against the same on the CPU."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 13, 10, 32, generator=gen).bfloat16()
    k = torch.randn(9, 9, 32, 64, generator=gen) / 50
    cot = torch.randn(2, 13, 10, 64, generator=gen)
    assert tfc.tail_body("kdft_resident", 24, 2, 32, 64, 9, 13, 2) == "ring"
    grads = {}
    for device in ("cpu", cuda):
        xd = x.to(device).detach().requires_grad_(True)
        kd = k.to(device).detach().requires_grad_(True)
        (tfc.fft_conv2d(xd, kd).float() * cot.to(device)).sum().backward()
        grads[torch.device(device).type] = (xd.grad.float().cpu(), kd.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got.abs().max() > 0
        assert _rel(got, want) <= 2e-2  # bf16 intermediates, rounded in another order


def test_plain_pass_gradients_ignore_the_global_tf32_flag(cuda):
    """The plain Fourier pass's backward runs at the call's precision: with
    TF32 switched on for the process, its gradients at 'high' are bit-equal
    to those with it off, at 'default' they differ, and the flag is put back."""
    from jointpose_torch.ops.mrf_fft import mrf_message_pass_fft

    p, kernels, biases = _inputs((30, 40), (21, 31), 2, torch.float32, cuda, seed=8)
    cot = torch.randn(2, 30, 40, K, generator=torch.Generator().manual_seed(9)).to(cuda)

    def grads(precision):
        inputs = [t.detach().clone().requires_grad_(True) for t in (p, kernels, biases)]
        out = mrf_message_pass_fft(*inputs, precision=precision)
        return torch.autograd.grad((out * cot).sum(), inputs)

    fp32 = grads("high")
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        flagged = grads("high")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert all(torch.equal(a, b) for a, b in zip(flagged, fp32))
    one = grads("default")
    assert not all(torch.equal(a, b) for a, b in zip(one, fp32))
    assert max(_rel(a, b) for a, b in zip(one, fp32)) <= SINGLE_PASS_RTOL


# The int8 convs of `joint` at 240×360 (the trunk at both pyramid levels, the
# wide head, the 1×1s: K = 75 and N = 9 among them) and the flagship's
# stride-2 5×5 convs (asymmetric SAME padding), batch 1:
# (C_in, C_out, kernel, stride, H, W).
INT8_CONVS = [(3, 64, 5, 1, 240, 360), (3, 64, 5, 1, 120, 180), (64, 128, 5, 1, 120, 180),
              (64, 128, 5, 1, 60, 90), (128, 128, 5, 1, 60, 90), (128, 128, 5, 1, 30, 45),
              (128, 512, 9, 1, 60, 90), (512, 256, 1, 1, 60, 90), (256, 9, 1, 1, 60, 90),
              (3, 24, 5, 2, 240, 360), (24, 48, 5, 2, 120, 180), (48, 96, 5, 1, 60, 90)]


@pytest.mark.parametrize("case", INT8_CONVS, ids=lambda c: "x".join(map(str, c)))
def test_int8_conv_on_the_card_equals_the_cpu(cuda, case):
    """im2col + ``torch._int_mm`` on the card against the CPU's int32 conv:
    both exact, so bit-equal; on the extreme int8 values too."""
    from jointpose_torch.ops import quant as tq

    cin, cout, k, s, h, w = case
    g = torch.Generator().manual_seed(sum(case))
    x = torch.randint(-127, 128, (1, cin, h, w), generator=g, dtype=torch.int8)
    x[..., :4, :] = 127
    x[..., -4:, :] = -127
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=g, dtype=torch.int8)
    wq[: cout // 2] = 127
    got = tq.int_conv(x.to(cuda), wq.to(cuda), s)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), tq.int_conv_plain(x, wq, s))


@pytest.mark.parametrize("hw", [(45, 67), (60, 90), (31, 1)])
def test_int8_pool_on_the_card_equals_the_cpu(cuda, hw):
    """The int8 max pool, odd sizes included, on a map in the channels-last
    memory that ``_int_mm``'s output leaves."""
    from jointpose_torch.ops import quant as tq

    x = torch.randint(-128, 128, (2, *hw, 16), generator=torch.Generator().manual_seed(1),
                      dtype=torch.int8)
    got = tq._pool_int(x.to(cuda).permute(0, 3, 1, 2))
    assert torch.equal(got.cpu(), tq._pool_int(x.permute(0, 3, 1, 2)))


def test_int8_detector_on_the_card_equals_the_cpu(cuda):
    """Quantizing on the card and the CPU gives the same int8 weights and
    weight scales; the whole int8 forward of a small multires detector from
    one set of qparams: every int8 input and int32 sum bit-equal card vs
    CPU, uint8 and float images."""
    import dataclasses

    from jointpose_torch.configs import get_config
    from jointpose_torch.ops import quant as tq
    from jointpose_torch.predict import init_state_dict

    cfg = get_config("tiny")
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector, pool_mode="stride"))
    state = init_state_dict(cfg, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    calib = torch.rand(8, *cfg.data.image_hw, 3, generator=g)
    qparams = tq.quantize_detector(cfg, state, calib, device="cpu")
    on_card = tq.quantize_detector(cfg, state, calib.to(cuda))
    for name, node in qparams.items():
        for field in ("w_q", "w_scale", "bias"):
            assert torch.equal(on_card[name][field].cpu(), node[field]), (name, field)
        assert _rel(on_card[name]["in_scale"].cpu(), node["in_scale"]) <= 1e-5
    for images in (calib[:2], (calib[2:4] * 255).round().to(torch.uint8)):
        sums = {}, {}
        on_card = tq.quant_detector_logits(cfg, qparams, images.to(cuda), sums[0])
        on_cpu = tq.quant_detector_logits(cfg, qparams, images, sums[1])
        assert sums[0].keys() == sums[1].keys()
        for name in sums[1]:
            for a, b in zip(sums[0][name], sums[1][name]):
                assert torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1]), name
        assert _rel(on_card.cpu(), on_cpu) <= 1e-6


def test_calibration_runs_without_tf32_and_puts_the_flag_back(cuda):
    """cuDNN's TF32 switched on for the process: the calibration's convs
    still run in fp32 (the same scales as with it off, and within fp32
    rounding of the CPU's), and the flag is on again afterwards."""
    import dataclasses

    from jointpose_torch.configs import get_config
    from jointpose_torch.ops import quant as tq
    from jointpose_torch.predict import init_state_dict

    cfg = get_config("tiny")
    cfg = cfg.replace(detector=dataclasses.replace(cfg.detector, trunk_features=(64, 128),
                                                   head_features=(256, 64)))
    state = init_state_dict(cfg, torch.Generator().manual_seed(4))
    calib = torch.rand(8, *cfg.data.image_hw, 3, generator=torch.Generator().manual_seed(5))
    try:
        torch.backends.cudnn.allow_tf32 = True
        flagged = tq.calibrate_detector(cfg, state, calib.to(cuda))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert flagged == tq.calibrate_detector(cfg, state, calib.to(cuda))
    on_cpu = tq.calibrate_detector(cfg, state, calib, device="cpu")
    assert all(abs(flagged[n] - on_cpu[n]) <= 1e-5 * on_cpu[n] for n in on_cpu)


# --- the shard-local shapes of the tensor-parallel paths (parallel/) ---------
# A 'model' rank runs the MRF pass on Kv = ceil(9 / n) of the padded source
# joints (5 of 10 at n = 2, 3 of 12 at n = 4) and the joint head's wide conv
# on cout 512 / n; the data axis halves flagship's training batch of 32.

# (B, H, W, Kv, Ka): flagship's coarse grid at 16 rows a data rank; a row
# of 45 (or 27) values is no multiple of a 16-byte vector.
SHARD_EPILOGUE_SHAPES = [(16, 30, 45, 5, K), (16, 30, 45, 3, K)]


@pytest.mark.parametrize("shape", SHARD_EPILOGUE_SHAPES)
def test_epilogue_kernels_at_shard_local_shapes(cuda, shape):
    b, h, w, kv, ka = shape
    gen = torch.Generator().manual_seed(2)
    resp = (torch.rand(b, h, w, kv, ka, generator=gen) * 0.01).to(cuda)
    biases = torch.cat([torch.rand(kv - 1, ka, generator=gen) * 1e-3,
                        torch.ones(1, ka)]).to(cuda)  # the last source a neutral pad slot
    g = torch.randn(b, h, w, ka, generator=gen).to(cuda)
    before = (tme.mrf_epilogue.launches, tme.mrf_epilogue_bwd.launches)
    out = tme.mrf_epilogue_fwd(resp, biases)
    dresp, dbias = tme.mrf_epilogue_bwd(resp, biases, g)
    assert (tme.mrf_epilogue.launches, tme.mrf_epilogue_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert _rel(out, tme.mrf_epilogue_plain(resp, biases)) <= KERNEL_RTOL
    want_dresp, want_dbias = tme.mrf_epilogue_bwd_plain(resp, biases, g)
    assert torch.equal(dresp, want_dresp)
    assert _rel(dbias, want_dbias) <= KERNEL_RTOL


# (hw, window, batch, Kv, Ka, peaked): joint's Fourier MRF at batch 8.
SHARD_FFT_TAIL_CASES = [((60, 90), (45, 67), 8, 5, K, False), ((60, 90), (45, 67), 8, 3, K, False)]


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("hw,win,batch,kv,ka,peaked", SHARD_FFT_TAIL_CASES)
def test_fft_tail_kernels_at_shard_local_shapes(cuda, hw, win, batch, kv, ka, peaked, precision):
    pf, kf, tables, biases = _fft_tail_operands(cuda, hw, win, batch, kv, ka, peaked)
    got = tmff.fused_tail(pf, kf, tables, biases, precision=precision)
    assert got.shape == (batch, ka, *hw)
    if precision == "high":
        assert _rel(got, tmff.fused_tail_plain(pf, kf, tables, biases)) <= FFT_TAIL_RTOL
    else:
        emulated = tmff.fused_tail_emulated(pf, kf, tables, biases, passes=1)
        assert _rel(got, emulated) <= KERNEL_RTOL
        assert _rel(got, tmff.fused_tail_plain(pf, kf, tables, biases)) <= SINGLE_PASS_RTOL


# (B, H, W, kh, Ci, Co): joint's head at batch 8 on cout 512 / 2 and / 4.
SHARD_TAIL_GEOMETRIES = [(8, 60, 90, 9, 128, 256), (8, 60, 90, 9, 128, 128)]


@pytest.mark.parametrize("entry", ["kdft_resident", "kdft"])
@pytest.mark.parametrize("geom", SHARD_TAIL_GEOMETRIES)
def test_head_conv_tails_at_shard_local_shapes(cuda, entry, geom):
    b, h, w, kh, ci, co = geom
    t, xr, xi, ar, ai = _tail_operands(geom, torch.bfloat16, cuda)
    assert tfc.tail_body(entry, xr.shape[1], b, ci, co, kh, h, 2) == "ring"
    fn = getattr(tfc, f"tail_{entry}")
    before = fn.launches
    got = fn(xr, xi, ar, ai, t)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert _rel(got, tfc.tail_kdft_plain(xr, xi, ar, ai, t)) <= TAIL_RTOL[torch.bfloat16]


# (B, H, W, Kv, Ka, wh, ww): flagship's coarse grid and window at batches 1,
# 8 and 32; a tensor-parallel source slice (Kv 5); a stride-1 11x15 window on
# the 60x90 heatmap; an even window; a ragged H and W under one tile; a window
# taller than the image; joint's 45x67 window at stride 2, staged in several
# kernel-row and input-chunk stages; targets in two chunks of a warp (Ka 12).
CORR_SHAPES = [(1, 30, 45, 9, K, 17, 25), (8, 30, 45, 9, K, 17, 25), (32, 30, 45, 9, K, 17, 25),
               (4, 30, 45, 5, K, 17, 25), (2, 60, 90, 9, K, 11, 15), (3, 30, 45, 9, K, 6, 8),
               (2, 13, 21, 9, K, 5, 7), (2, 7, 5, 9, K, 17, 25), (2, 23, 34, 9, K, 45, 67),
               (2, 12, 20, 2, 12, 11, 15)]


def _corr_operands(shape, dtype, device, seed=0, signed=False):
    b, h, w, kv, ka, wh, ww = shape
    g = torch.Generator().manual_seed(seed)
    if signed:
        p, kern = torch.randn(b, h, w, kv, generator=g), torch.randn(wh, ww, 1, kv * ka, generator=g)
    else:
        p = torch.rand(b, h, w, kv, generator=g)
        kern = torch.nn.functional.softplus(torch.randn(wh, ww, 1, kv * ka, generator=g) - 3)
    return p.to(device, dtype), kern.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", CORR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grouped_corr_kernel_matches_plain(cuda, shape, dtype):
    p, kern = _corr_operands(shape, dtype, cuda, seed=sum(shape))
    before = tmc.mrf_grouped_corr.launches
    got = tmc.mrf_grouped_corr(p, kern, shape[3])
    torch.cuda.synchronize()
    assert tmc.mrf_grouped_corr.launches == before + 1
    assert got.dtype == torch.float32 and got.is_contiguous()
    want = tmc.mrf_grouped_corr_plain(p, kern, shape[3])
    assert got.shape == want.shape
    assert _rel(got, want) <= CORR_RTOL
    assert torch.equal(tmc.mrf_grouped_corr(p, kern, shape[3]), got)  # bit for bit


def test_grouped_corr_kernel_on_signed_values(cuda):
    p, kern = _corr_operands((4, 30, 45, K, K, 17, 25), torch.bfloat16, cuda, seed=3, signed=True)
    got = tmc.mrf_grouped_corr(p, kern, K)
    assert _rel(got, tmc.mrf_grouped_corr_plain(p, kern, K)) <= CORR_RTOL


def test_grouped_corr_kernel_in_a_graph_and_batch_alone(cuda):
    """Captured and replayed it gives the eager call's bits, and an image's
    responses do not depend on the batch around it (the tiling does)."""
    p, kern = _corr_operands((128, 30, 45, K, K, 17, 25), torch.bfloat16, cuda, seed=8)
    eager = tmc.mrf_grouped_corr(p, kern, K)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmc.mrf_grouped_corr(p, kern, K)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tmc.mrf_grouped_corr.launches
    with torch.cuda.graph(graph):
        captured = tmc.mrf_grouped_corr(p, kern, K)
    assert tmc.mrf_grouped_corr.launches == before + 1
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    assert torch.equal(tmc.mrf_grouped_corr(p[5:6].contiguous(), kern, K), eager[5:6])


def test_grouped_conv_f32_forward_on_the_card_is_the_kernel(cuda):
    from jointpose_torch.ops.mrf_xla import grouped_conv_f32

    p, kern = _corr_operands((2, 30, 45, K, K, 17, 25), torch.bfloat16, cuda, seed=9)
    p.requires_grad_(True)
    before = tmc.mrf_grouped_corr.launches
    resp = grouped_conv_f32(p, kern, K)
    assert tmc.mrf_grouped_corr.launches == before + 1
    assert torch.equal(resp.detach(), tmc.mrf_grouped_corr(p.detach(), kern, K))
    (dp,) = torch.autograd.grad(resp.sum(), p)
    assert dp.dtype == torch.bfloat16 and bool(torch.isfinite(dp).all())


def test_grouped_corr_wrapper_raises_on_what_it_cannot_take(cuda):
    p, kern = _corr_operands((1, 12, 16, K, K, 5, 7), torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="bf16"):
        tmc.mrf_grouped_corr(p.float(), kern.float(), K)
    with pytest.raises(TypeError):
        tmc.mrf_grouped_corr(p, kern.half(), K)
    with pytest.raises(ValueError, match="contiguous"):
        tmc.mrf_grouped_corr(p.transpose(1, 2), kern, K)
    with pytest.raises(ValueError, match="contiguous"):
        tmc.mrf_grouped_corr(p, kern.transpose(0, 1), K)
    with pytest.raises(ValueError):
        tmc.mrf_grouped_corr(p, kern, 3)


# The predictor's paths held by graph against eager: flagship's own ('auto'
# -> 'xla' at stride 2, row 9 once a pass), the same with the flip TTA, and
# joint's served paths (the fused Fourier tail at 'default', row 3', and
# with the Fourier head conv, rows 6-8).
PREDICTOR_PATHS = {
    "xla": ({"impl": "auto", "stride": 2}, "direct", False),
    "xla_flip_tta": ({"impl": "auto", "stride": 2}, "direct", True),
    "fft_default": ({"impl": "fft", "use_pallas": True, "precision": "default"}, "direct", False),
    "fft_head": ({"impl": "fft", "use_pallas": True, "precision": "default"}, "fft", False),
}


def _graph_predictor(device, path="xla"):
    """``tiny`` in bf16 with the refined decode on one of PREDICTOR_PATHS,
    its MRF kernels off their uniform init; returns (config, weights,
    ``build_predictor``'s function)."""
    import dataclasses

    from jointpose_torch import get_config
    from jointpose_torch.predict import build_predictor, init_state_dict

    mrf, head, tta = PREDICTOR_PATHS[path]
    cfg = get_config("tiny")
    cfg = cfg.replace(compute_dtype="bfloat16", decode_refine=True, eval_flip_tta=tta,
                      detector=dataclasses.replace(cfg.detector, head_conv_impl=head),
                      mrf=dataclasses.replace(cfg.mrf, **mrf))
    g = torch.Generator().manual_seed(4)
    state = init_state_dict(cfg, g)
    state["spatial_model.raw_kernels"] += 0.5 * torch.randn(
        state["spatial_model.raw_kernels"].shape, generator=g)
    return cfg, state, build_predictor(cfg, state, device)


def _pose_images(cfg, batch, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (batch, *cfg.data.image_hw, 3), generator=g, dtype=torch.uint8)
    return x if dtype == torch.uint8 else x.float() / 255.0


def _eager_pose_call(cfg, state, images):
    """An eager ``PoseModel`` call on the card and the decode, as the
    predictor's eager form runs them."""
    from jointpose_torch.evaluate import flip_images, unflip_heatmaps
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.ops.heatmaps import decode_probs, model_probs

    model = PoseModel(cfg)
    model.load_state_dict(state)
    model = model.cuda().eval()
    with torch.inference_mode():
        images = images.cuda()
        probs = model_probs(model(images))
        if cfg.eval_flip_tta:
            probs = 0.5 * (probs + unflip_heatmaps(model_probs(model(flip_images(images)))))
        return decode_probs(probs, cfg.data.heatmap_stride, refine=True), probs


@pytest.mark.parametrize("path", sorted(PREDICTOR_PATHS))
def test_the_predictor_replays_a_graph_per_key_bit_equal_to_eager(cuda, path):
    """Two batch shapes, each with uint8 and float32 images, from the host
    and from the card: one capture a key, a replay for every call after a
    key's first two, every kernel's launches counted as eagerly (row 9's
    once a forward on flagship's path), and each call's answers bit-equal
    to an eager call.  Every call sees other images, so answers read after
    all the calls show that a later call overwrote none of an earlier
    one's."""
    from jointpose_torch.ops import launch_counters

    def launches():
        return [getattr(holder, name) for holder, name in launch_counters()]

    cfg, state, predict = _graph_predictor(cuda, path)
    keys = [(b, dtype) for b in (2, 5) for dtype in (torch.uint8, torch.float32)]
    calls = 4
    kept = []
    for i, (b, dtype) in enumerate(keys):
        per_call = None
        for n in range(calls):
            images = _pose_images(cfg, b, dtype, seed=10 * i + n)
            before, corr = launches(), tmc.mrf_grouped_corr.launches
            coords, probs = predict(images if n % 2 else images.cuda())
            grew = [a - c for a, c in zip(launches(), before)]
            assert grew == (per_call or grew) and any(grew)
            per_call = grew
            if path.startswith("xla"):
                assert tmc.mrf_grouped_corr.launches == corr + (2 if cfg.eval_flip_tta else 1)
            kept.append((images, coords, probs))
    assert predict.graphs.captures == len(keys)
    assert predict.graphs.replays == len(keys) * (calls - 2)
    for images, coords, probs in kept:
        want_coords, want_probs = _eager_pose_call(cfg, state, images)
        assert torch.equal(coords, want_coords) and torch.equal(probs, want_probs)


def test_the_predictor_stays_eager_inside_a_capture_and_a_cost_count(cuda):
    from jointpose_torch.perf import step_cost

    cfg, state, predict = _graph_predictor(cuda)
    images = _pose_images(cfg, 2, torch.uint8, seed=1).cuda()
    want = _eager_pose_call(cfg, state, images)
    predict(images)  # the key's eager first call
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        coords, probs = predict(images)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(coords, want[0]) and torch.equal(probs, want[1])
    cost = step_cost(predict, images)
    assert cost["flops"] > 0
    assert predict.graphs.captures == predict.graphs.replays == 0
    coords, probs = predict(images)  # the key's second call of its own captures
    assert predict.graphs.captures == 1
    assert torch.equal(coords, want[0]) and torch.equal(probs, want[1])


def test_the_predictor_recaptures_when_the_weights_move(cuda):
    """A parameter on new storage drops the graphs: the key starts again
    from an eager call, and the answers follow the new weights."""
    cfg, state, predict = _graph_predictor(cuda)
    images = _pose_images(cfg, 2, torch.uint8, seed=2)
    for _ in range(3):
        predict(images)
    assert (predict.graphs.captures, predict.graphs.replays) == (1, 1)
    model = predict.graphs.model
    moved = model.spatial_model.raw_kernels.detach() + 0.25
    model.spatial_model.raw_kernels = torch.nn.Parameter(moved)
    state = {**state, "spatial_model.raw_kernels": moved.cpu()}
    for _ in range(3):
        coords, probs = predict(images)
    assert (predict.graphs.captures, predict.graphs.replays) == (2, 2)
    want = _eager_pose_call(cfg, state, images)
    assert torch.equal(coords, want[0]) and torch.equal(probs, want[1])


def test_a_key_warmed_on_one_thread_captures_on_another(cuda):
    """As ``PoseService`` calls it: its start-up warms a key on one thread,
    its dispatcher thread captures.  The dispatcher's first call of the key
    runs eagerly (a capture cannot create that thread's cuDNN and cuBLAS
    handles), its second captures, its third replays."""
    import threading

    cfg, state, predict = _graph_predictor(cuda)
    images = _pose_images(cfg, 2, torch.uint8, seed=3)
    predict(images)
    got, errors = [], []

    def dispatcher():
        try:
            for _ in range(3):
                got.append(predict(images))
            torch.cuda.synchronize()
        except Exception as e:  # raised again below, on the test's thread
            errors.append(e)

    thread = threading.Thread(target=dispatcher)
    thread.start()
    thread.join(timeout=300)
    assert not thread.is_alive() and not errors, errors
    assert (predict.graphs.captures, predict.graphs.replays) == (1, 1)
    want = _eager_pose_call(cfg, state, images)
    for coords, probs in got:
        assert torch.equal(coords, want[0]) and torch.equal(probs, want[1])


# The coarse pass's upsample and unary log (csrc/mrf_upsample.cu) against
# the composition it replaced (the plain version, PyTorch's own kernels on
# the card).  The forward takes the same taps, weights and order of
# operations, and nvcc contracts its products into fused multiply-adds as
# PyTorch's build does: bit-equal.  The coarse gradient sums the same terms
# as PyTorch's atomics in another order: UPSAMPLE_GRAD_RTOL of the largest.
UPSAMPLE_GRAD_RTOL = 1e-5
UPSAMPLE_EPS = 1e-6


def _upsample_operands(batch, hc, wc, s, dtype, device, seed=0):
    """Coarse log-messages and softmaxed unaries, with exact zeros and
    values below eps among the unaries."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.randn(batch, hc, wc, K, generator=g) * 4 - 30
    p = torch.randn(batch, hc * s * wc * s, K, generator=g).mul(3).softmax(dim=1)
    p = p.reshape(batch, hc * s, wc * s, K)
    p[:, : max(1, hc * s // 4), :, 0] = 0.0
    p[:, :, : max(1, wc * s // 4), 1] = 1e-8
    return coarse.to(device), p.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [1, 32, 128])
def test_upsample_log_kernel_matches_the_composition(cuda, batch, dtype):
    """flagship's coarse pass: 30x45 coarse log-messages to 60x90."""
    coarse, p = _upsample_operands(batch, 30, 45, 2, dtype, cuda)
    before = tmu.mrf_upsample_log.launches
    got = tmu.mrf_upsample_log(coarse, p, UPSAMPLE_EPS)
    assert tmu.mrf_upsample_log.launches == before + 1
    want = tmu.mrf_upsample_log_plain(coarse, p, UPSAMPLE_EPS)
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(tmu.mrf_upsample_log(coarse, p, UPSAMPLE_EPS), got)  # bit for bit


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("hc,wc,s", [(7, 9, 2), (5, 11, 3), (3, 3, 4), (1, 5, 3)])
def test_upsample_log_kernel_at_other_strides(cuda, hc, wc, s, dtype):
    """Odd coarse sizes, strides 2 to 4 (scale 1/3 is inexact in fp32)."""
    coarse, p = _upsample_operands(3, hc, wc, s, dtype, cuda, seed=1)
    got = tmu.mrf_upsample_log(coarse, p, UPSAMPLE_EPS)
    assert torch.equal(got, tmu.mrf_upsample_log_plain(coarse, p, UPSAMPLE_EPS))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hc,wc,s", [(4, 30, 45, 2), (3, 5, 11, 3), (2, 3, 4, 4)])
def test_upsample_log_backward_matches_autograd(cuda, batch, hc, wc, s, dtype):
    """The backward kernel against autograd of the plain version, on the
    card and on the CPU: dp bit for bit (the same division and compare,
    rounded to p's type), dcoarse within a rounding of its sums; two
    backward calls agree bit for bit."""
    coarse, p = _upsample_operands(batch, hc, wc, s, dtype, cuda, seed=2)
    g = torch.randn(p.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    grads = {}
    for name, device, fn in (("kernel", cuda, tmu.mrf_upsample_log),
                             ("card", cuda, tmu.mrf_upsample_log_plain),
                             ("cpu", "cpu", tmu.mrf_upsample_log_plain)):
        c = coarse.to(device).requires_grad_(True)
        q = p.to(device).requires_grad_(True)
        grads[name] = torch.autograd.grad(fn(c, q, UPSAMPLE_EPS), (c, q), g.to(device))
    before = tmu.mrf_upsample_log_bwd.launches
    again = tmu.mrf_upsample_log_bwd(g, p, tuple(coarse.shape), UPSAMPLE_EPS)
    assert tmu.mrf_upsample_log_bwd.launches == before + 1
    dcoarse, dp = grads["kernel"]
    assert torch.equal(again[0], dcoarse) and torch.equal(again[1], dp)
    assert dp.dtype == dtype
    for ref in ("card", "cpu"):
        want_c, want_p = (t.to(cuda) for t in grads[ref])
        assert _rel(dcoarse, want_c) <= UPSAMPLE_GRAD_RTOL, ref
        assert torch.equal(dp, want_p), ref


def test_upsample_log_in_a_graph_repeats_and_counts(cuda):
    """Forward and backward captured once (``graphs.Graph``): each replay
    writes the eager answers again, bit for bit, and adds one launch to
    each counter."""
    from jointpose_torch import graphs

    coarse, p = _upsample_operands(32, 30, 45, 2, torch.bfloat16, cuda, seed=4)
    g = torch.randn(p.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    coarse.requires_grad_(True)

    def step():
        out = tmu.mrf_upsample_log(coarse, p, UPSAMPLE_EPS)
        return (out, *torch.autograd.grad(out, coarse, g))

    pool = graphs.GraphPool()
    eager = pool.warm(step)
    fwd, bwd = tmu.mrf_upsample_log.launches, tmu.mrf_upsample_log_bwd.launches
    graph = graphs.Graph(pool, step)
    assert (tmu.mrf_upsample_log.launches, tmu.mrf_upsample_log_bwd.launches) == (fwd, bwd)
    for n in range(1, 4):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(graph.out, eager))
        assert tmu.mrf_upsample_log.launches == fwd + n
        assert tmu.mrf_upsample_log_bwd.launches == bwd + n


def test_the_predictor_at_batch_128_launches_the_upsample_once_a_call(cuda):
    """The predictor's graph (flagship's 'xla' path at stride 2, ``tiny``'s
    widths) at batch 128: eager call, capture, replays; one forward launch
    a call, none backward, answers bit-equal to an eager call."""
    cfg, state, predict = _graph_predictor(cuda)
    images = _pose_images(cfg, 128, torch.uint8, seed=6)
    want = _eager_pose_call(cfg, state, images)
    for _ in range(4):
        fwd, bwd = tmu.mrf_upsample_log.launches, tmu.mrf_upsample_log_bwd.launches
        coords, probs = predict(images)
        assert tmu.mrf_upsample_log.launches == fwd + 1
        assert tmu.mrf_upsample_log_bwd.launches == bwd
        assert torch.equal(coords, want[0]) and torch.equal(probs, want[1])
    assert (predict.graphs.captures, predict.graphs.replays) == (1, 2)


def test_upsample_log_wrapper_raises_on_what_it_cannot_take(cuda):
    coarse, p = _upsample_operands(2, 6, 8, 2, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="integer stride"):
        tmu.mrf_upsample_log(coarse, p[:, :11].contiguous())
    with pytest.raises(TypeError):
        tmu.mrf_upsample_log(coarse.bfloat16(), p)
    with pytest.raises(TypeError):
        tmu.mrf_upsample_log(coarse, p.to(torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tmu.mrf_upsample_log(coarse, p.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        tmu.mrf_upsample_log(coarse.transpose(1, 2).contiguous().transpose(1, 2), p)
    with pytest.raises(ValueError, match="CUDA device"):
        tmu.mrf_upsample_log(coarse.cpu(), p)
    with pytest.raises(ValueError, match="g must be"):
        tmu.mrf_upsample_log_bwd(torch.zeros(p.shape, device=cuda).bfloat16(), p,
                                 tuple(coarse.shape))
