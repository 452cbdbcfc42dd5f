"""Parity of the port's Fourier MRF pass and the fused tail's plain version
(jointpose_torch.ops.mrf_fft / mrf_fft_fused) against the JAX reference,
in fp32 on the CPU: the reference's fused Pallas tail in interpret mode
(as tests/test_mrf_fft.py runs it), and its direct XLA pass at HIGHEST
precision at odd windows."""

import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.ops import mrf_fft as jmf
from jointpose.ops import mrf_fft_pallas as jmfp
from jointpose.ops import mrf_xla as jmx
from jointpose_torch.ops import mrf_fft as tmf
from jointpose_torch.ops import mrf_fft_fused as tmff

K = 9
HI = lax.Precision.HIGHEST
# Pairwise responses: fp32 DFT matmuls in another order; 2e-5 of the
# largest response (the reference's own fft-vs-direct test uses atol 2e-6
# on responses of order 0.1).
CONV_RTOL = 2e-5
# MRF log-heatmaps: the reference's parity tolerance for every
# message-pass path (BENCH_r05.json parity_tolerances), max|Δ| / max|ref|.
MRF_RTOL = 1e-3


def _inputs(hw, win, batch=2, seed=0):
    rs = np.random.RandomState(seed)
    logits = rs.randn(batch, hw[0] * hw[1], K)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    p = p.reshape(batch, *hw, K).astype(np.float32)
    kernels = np.log1p(np.exp(rs.randn(*win, K, K))).astype(np.float32)
    biases = np.log1p(np.exp(rs.randn(K, K) - 4.0)).astype(np.float32)
    return p, kernels, biases


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("hw,win", [((12, 18), (7, 11)), ((12, 18), (25, 13)), ((9, 10), (6, 8))])
def test_dft_tables_match_reference(hw, win):
    want = jmf._dft_consts(hw, win, real_cols=True)
    got = tmf._dft_consts(hw, win)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("hw,win", [((12, 18), (7, 11)), ((12, 18), (25, 13)), ((15, 22), (29, 43))])
def test_fft_pairwise_conv_matches_reference(hw, win):
    p, kernels, _ = _inputs(hw, win)
    want = jmx.pairwise_conv(jnp.asarray(p), jnp.asarray(kernels), precision=HI)
    want_fft = jmf.fft_pairwise_conv(jnp.asarray(p), jnp.asarray(kernels), precision=HI)
    got = tmf.fft_pairwise_conv(torch.from_numpy(p), torch.from_numpy(kernels))
    assert got.shape == want.shape
    assert _rel(got, want) <= CONV_RTOL
    assert _rel(got, want_fft) <= CONV_RTOL


@pytest.mark.parametrize("hw,win", [((12, 18), (7, 11)), ((10, 14), (11, 15))])
def test_fused_tail_plain_matches_pallas_interpret(hw, win):
    p, kernels, biases = _inputs(hw, win, seed=1)
    want = jmfp.mrf_message_pass_fft_fused(*map(jnp.asarray, (p, kernels, biases)))
    before = tmff.fused_tail.launches
    got = tmff.mrf_message_pass_fft_fused(*map(torch.from_numpy, (p, kernels, biases)))
    assert tmff.fused_tail.launches == before  # CPU tensors never launch
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= MRF_RTOL


@pytest.mark.parametrize("hw,win", [((12, 18), (7, 11)), ((15, 22), (29, 43)), ((8, 12), (15, 23))])
def test_fused_tail_plain_matches_direct_pass(hw, win):
    # Odd windows only: the direct pass is the oracle there.
    p, kernels, biases = _inputs(hw, win, seed=2)
    want = jmx.mrf_message_pass_xla(*map(jnp.asarray, (p, kernels, biases)), precision=HI)
    got = tmff.mrf_message_pass_fft_fused(*map(torch.from_numpy, (p, kernels, biases)))
    assert _rel(got, want) <= MRF_RTOL


def test_fft_pass_plain_tail_matches_reference():
    p, kernels, biases = _inputs((12, 18), (7, 11), seed=3)
    want = jmf.mrf_message_pass_fft(
        *map(jnp.asarray, (p, kernels, biases)), precision=HI, use_pallas_epilogue=False
    )
    got = tmf.mrf_message_pass_fft(*map(torch.from_numpy, (p, kernels, biases)))
    assert _rel(got, want) <= MRF_RTOL


@pytest.mark.parametrize("fn", [tmf.mrf_message_pass_fft, tmff.mrf_message_pass_fft_fused],
                             ids=["plain", "fused"])
def test_tables_built_while_serving_serve_training(fn):
    """The DFT tables are cached per geometry: a table first built under
    inference mode must still take part in a later backward."""
    p, kernels, biases = map(torch.from_numpy, _inputs((9, 13), (5, 7), seed=4))
    tmf.dft_tables.cache_clear()
    with torch.inference_mode():
        served = fn(p, kernels, biases)
    kernels.requires_grad_()
    trained = fn(p, kernels, biases)
    trained.sum().backward()
    assert torch.equal(trained.detach(), served)
    assert kernels.grad.abs().max() > 0
