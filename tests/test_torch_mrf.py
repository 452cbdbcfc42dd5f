"""Parity of the port's direct MRF passes and fused-epilogue plain version
(jointpose_torch.ops.mrf_xla / mrf_epilogue) against the JAX reference,
in fp32 on the CPU.  The reference's Pallas epilogue runs in interpret
mode, as tests/test_mrf_pallas.py runs it."""

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.ops import mrf_pallas as jmp
from jointpose.ops import mrf_xla as jmx
from jointpose_torch.ops import mrf_epilogue as tme
from jointpose_torch.ops import mrf_xla as tmx

K = 9
HI = lax.Precision.HIGHEST
# Conv stacks: fp32 sums of a few hundred taps in another order; 1e-4 of
# the largest response covers the reordering with margin.
CONV_RTOL = 1e-4
# MRF log-heatmaps: the reference's own parity tolerance for every
# message-pass path (BENCH_r05.json parity_tolerances), max|Δ| / max|ref|.
MRF_RTOL = 1e-3


def _inputs(hw=(12, 16), win=(7, 9), batch=2, seed=0):
    rs = np.random.RandomState(seed)
    p = rs.rand(batch, *hw, K).astype(np.float32)
    p /= p.sum(axis=(1, 2), keepdims=True)
    kernels = (rs.rand(*win, K, K) * 0.1).astype(np.float32)
    biases = (rs.rand(K, K) * 0.01 + 1e-4).astype(np.float32)
    return p, kernels, biases


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("win", [(7, 9), (5, 5), (4, 6), (13, 17)])
def test_pairwise_conv_matches_reference(win):
    # (4, 6) is an even window: SAME pads (k-1)//2 before, k//2 after.
    p, kernels, _ = _inputs(win=win)
    want = jmx.pairwise_conv(jnp.asarray(p), jnp.asarray(kernels), precision=HI)
    got = tmx.pairwise_conv(torch.from_numpy(p), torch.from_numpy(kernels))
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel(got, want) <= CONV_RTOL


def test_message_pass_xla_matches_reference():
    p, kernels, biases = _inputs(seed=1)
    want = jmx.mrf_message_pass_xla(*map(jnp.asarray, (p, kernels, biases)), precision=HI)
    got = tmx.mrf_message_pass_xla(*map(torch.from_numpy, (p, kernels, biases)))
    assert _rel(got, want) <= MRF_RTOL


@pytest.mark.parametrize("stride", [2, 3])
def test_coarse_pass_matches_reference(stride):
    p, kernels, biases = _inputs(hw=(12, 18), win=(5, 7), seed=2)
    want = jmx.mrf_message_pass_coarse(
        *map(jnp.asarray, (p, kernels, biases)), stride=stride, precision=HI
    )
    got = tmx.mrf_message_pass_coarse(*map(torch.from_numpy, (p, kernels, biases)), stride=stride)
    assert _rel(got, want) <= MRF_RTOL


def test_epilogue_plain_matches_pallas_interpret():
    p, kernels, biases = _inputs(seed=3)
    resp = np.asarray(jmx.pairwise_conv(jnp.asarray(p), jnp.asarray(kernels), precision=HI))
    want = jmp.mrf_epilogue_pallas(jnp.asarray(resp), jnp.asarray(biases))
    before = tme.mrf_epilogue.launches
    got = tme.mrf_epilogue(torch.from_numpy(resp.copy()), torch.from_numpy(biases))
    assert tme.mrf_epilogue.launches == before  # CPU tensors never launch
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= MRF_RTOL


def test_epilogue_plain_reads_bf16_as_f32():
    p, kernels, biases = _inputs(seed=4)
    resp = jmx.pairwise_conv(jnp.asarray(p), jnp.asarray(kernels)).astype(jnp.bfloat16)
    want = jmp.mrf_epilogue_pallas(resp, jnp.asarray(biases))
    resp_t = torch.from_numpy(np.array(resp.astype(jnp.float32))).to(torch.bfloat16)
    got = tme.mrf_epilogue(resp_t, torch.from_numpy(biases))
    assert _rel(got, want) <= MRF_RTOL


def test_message_pass_pallas_matches_reference():
    p, kernels, biases = _inputs(hw=(13, 11), win=(5, 7), seed=5)
    want = jmp.mrf_message_pass_pallas(*map(jnp.asarray, (p, kernels, biases)), precision=HI)
    got = tme.mrf_message_pass_pallas(*map(torch.from_numpy, (p, kernels, biases)))
    assert _rel(got, want) <= MRF_RTOL


def test_spatial_model_helpers_match_reference():
    from jointpose.configs import MRFConfig as JaxMRFConfig
    from jointpose.models import mrf as jmrf
    from jointpose_torch.configs import MRFConfig
    from jointpose_torch.models import mrf as tmrf

    y = np.array([1e-9, 1e-4, 0.3, 2.0, 14.9, 15.0, 40.0], np.float32)
    np.testing.assert_allclose(
        tmrf.inverse_softplus(y).numpy(), np.asarray(jmrf.inverse_softplus(y)), rtol=1e-6
    )
    np.testing.assert_allclose(
        tmrf.uniform_kernel_init((5, 7), K).numpy(),
        np.asarray(jmrf.uniform_kernel_init((5, 7), K)), rtol=1e-6,
    )
    priors = np.random.RandomState(6).rand(5, 7, K, K).astype(np.float32)
    priors /= priors.sum(axis=(0, 1), keepdims=True)
    np.testing.assert_allclose(
        tmrf.priors_to_raw_kernels(priors, blend=0.3).numpy(),
        np.asarray(jmrf.priors_to_raw_kernels(jnp.asarray(priors), blend=0.3)), rtol=1e-5,
    )
    for kw in ({}, {"stride": 2}, {"window": (11, 15)}, {"impl": "pallas"}, {"impl": "xla"},
               {"window": (23, 23)}, {"window": (21, 25), "stride": 2}):
        assert tmrf.select_impl(MRFConfig(**kw)) == jmrf.select_impl(JaxMRFConfig(**kw)), kw


@pytest.mark.parametrize("vec", [8, 4], ids=["bf16_vectors", "f32_vectors"])
@pytest.mark.parametrize("kv,ka", [(9, 9), (3, 3), (2, 3)], ids=["kk81", "kk9", "kk6"])
@pytest.mark.parametrize("rows", [8, 13, 43200])
def test_epilogue_bwd_vector_lane_map_sums_to_plain_dbias(rows, kv, ka, vec):
    """The backward kernel's column map (16-byte vectors over the flat
    array, lane (t, i) of every group of ``vec`` rows holding column
    (vec*t + i) mod Kv*Ka, ragged last group included) gives the plain
    version's dbias; fp32 sums in another order, hence 1e-5."""
    rs = np.random.RandomState(rows + 100 * kv + vec)
    resp = torch.from_numpy((rs.rand(1, rows, 1, kv, ka) * 0.02 - 0.002).astype(np.float32))
    biases = torch.from_numpy((rs.rand(kv, ka) * 1e-3).astype(np.float32))
    g = torch.from_numpy(rs.randn(1, rows, 1, ka).astype(np.float32))
    dresp, want = tme.mrf_epilogue_bwd_plain(resp, biases, g)
    got = tme.dbias_by_vector_lanes(dresp.reshape(rows, kv * ka), vec)
    assert got.shape == (kv * ka,)
    assert _rel(got, want.reshape(-1)) <= 1e-5
