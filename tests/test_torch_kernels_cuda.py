"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with sm_90a and ``nvcc``, and
skip elsewhere.  On the card: ``python -m pytest tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` runs the same comparisons at the full main-path shapes.
"""

import pytest
import torch

from jointpose_torch.ops import mrf_epilogue as tme
from jointpose_torch.ops import mrf_fft_fused as tmff
from jointpose_torch.ops.mrf_fft import forward_ffts
from jointpose_torch.ops.mrf_xla import pairwise_conv

pytestmark = pytest.mark.cuda

# max|kernel - plain| / max|plain|: the reference's parity tolerance for
# every MRF message-pass path (BENCH_r05.json parity_tolerances).
KERNEL_RTOL = 1e-3
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
