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
from jointpose_torch.ops import mrf_epilogue as tme
from jointpose_torch.ops import mrf_fft_fused as tmff
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


@pytest.mark.parametrize("hw,win", [((60, 90), (45, 67)), ((12, 16), (11, 15)), ((70, 33), (9, 7))])
def test_fft_tail_kernel_matches_plain(cuda, hw, win):
    p, kernels, biases = _inputs(hw, win, 2, torch.float32, cuda)
    pf, kf, tables = forward_ffts(p, kernels)
    pf = tuple(t.contiguous() for t in pf)
    kf = tuple(t.contiguous() for t in kf)
    before = tmff.fused_tail.launches
    got = tmff.fused_tail(pf, kf, tables, biases)
    assert tmff.fused_tail.launches == before + 1
    assert _rel(got, tmff.fused_tail_plain(pf, kf, tables, biases)) <= KERNEL_RTOL


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,win,batch", [((30, 45), (17, 25), 32), ((7, 5), (3, 3), 3)])
def test_epilogue_bwd_kernel_matches_plain_and_repeats(cuda, dtype, hw, win, batch):
    p, kernels, biases = _inputs(hw, win, batch, dtype, cuda)
    resp = pairwise_conv(p, kernels.to(dtype))
    g = torch.randn(*resp.shape[:3], K, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = tme.mrf_epilogue_bwd.launches
    dresp, dbias = tme.mrf_epilogue_bwd(resp, biases, g)
    assert tme.mrf_epilogue_bwd.launches == before + 1
    assert dresp.dtype == dtype and dbias.dtype == torch.float32
    want_dresp, want_dbias = tme.mrf_epilogue_bwd_plain(resp, biases, g)
    assert _rel(dresp, want_dresp) <= KERNEL_RTOL
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
    assert fn.launches == before + 2  # one launch per pass
    want = tw.shear_warp_reference(images, a_inv, b_inv)
    assert (got - want).abs().max().item() <= WARP_ATOL


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
