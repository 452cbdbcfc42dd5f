"""Parity of the port's detector (jointpose_torch.models.detector) against
the JAX reference in fp32 on the CPU, in both trunk pool modes: the
'stride' mode runs stride-2 5×5 SAME convs on even inputs, which pad
(1, 2), not (2, 2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.configs import get_config as jax_get_config
from jointpose.models.detector import Detector as JaxDetector
from jointpose_torch import get_config
from jointpose_torch.convert import params_from_flax
from jointpose_torch.models.detector import Detector, resolve_head_conv_impl
from jointpose_torch.ops.mrf_xla import same_pad

# Conv stacks in fp32: sums over a few thousand products in another
# order; 1e-4 of the largest logit covers the reordering with margin.
CONV_RTOL = 1e-4


def _detector_cfg(pool_mode: str, multires: bool, share_trunk: bool, head: str = "direct"):
    base = jax_get_config("tiny").detector
    return dataclasses.replace(
        base, pool_mode=pool_mode, multires=multires, share_trunk=share_trunk,
        head_conv_impl=head,
    )


@pytest.mark.parametrize("pool_mode", ["max", "stride"])
@pytest.mark.parametrize("multires,share_trunk", [(True, True), (False, True), (True, False)])
def test_detector_matches_reference(pool_mode, multires, share_trunk):
    cfg = _detector_cfg(pool_mode, multires, share_trunk)
    rs = np.random.RandomState(0)
    images = rs.rand(2, 48, 64, 3).astype(np.float32)
    jdet = JaxDetector(cfg, 9)
    variables = jdet.init(jax.random.PRNGKey(1), jnp.asarray(images))
    # Non-zero biases, so their layout is checked too.
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32), variables
    )
    want = np.asarray(jdet.apply(variables, jnp.asarray(images)))

    tdet = Detector(cfg, 9)
    tdet.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    with torch.no_grad():
        got = tdet(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 12, 16, 9)
    assert np.abs(got - want).max() / np.abs(want).max() <= CONV_RTOL


@pytest.mark.parametrize(
    "n,k,s,want",
    [(48, 5, 2, (1, 2)), (47, 5, 2, (2, 2)), (12, 5, 1, (2, 2)), (12, 4, 1, (1, 2)), (7, 1, 1, (0, 0))],
)
def test_same_pad_matches_lax(n, k, s, want):
    assert same_pad(n, k, s) == want
    pads = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")
    assert tuple(pads[0]) == want


def test_head_conv_impl_resolution():
    det = get_config("joint").detector
    assert det.head_conv_impl == "auto"
    assert resolve_head_conv_impl(det) == "direct"
    assert resolve_head_conv_impl(dataclasses.replace(det, head_conv_impl="fft")) == "fft"
    with pytest.raises(ValueError, match="unknown head_conv_impl"):
        resolve_head_conv_impl(dataclasses.replace(det, head_conv_impl="winograd"))
    # One state_dict serves both heads; the Fourier head is an FFTConv.
    tiny = get_config("tiny").detector
    direct = Detector(dataclasses.replace(tiny, head_conv_impl="direct"), 9)
    fourier = Detector(dataclasses.replace(tiny, head_conv_impl="fft"), 9)
    assert type(fourier.head_wide).__name__ == "FFTConv"
    assert {k: v.shape for k, v in direct.state_dict().items()} == {
        k: v.shape for k, v in fourier.state_dict().items()}


@pytest.mark.parametrize("pool_mode", ["max", "stride"])
def test_fft_head_matches_direct_head_and_reference(pool_mode):
    """The same weights through the 'direct' and 'fft' heads give the same
    logits, on both sides: 1e-4 of scale, the reference's own bound
    (tests/test_fft_conv.py, test_detector_head_impls_agree)."""
    rs = np.random.RandomState(1)
    images = rs.rand(2, 48, 64, 3).astype(np.float32)
    jdet = JaxDetector(_detector_cfg(pool_mode, True, True, "fft"), 9)
    variables = jdet.init(jax.random.PRNGKey(2), jnp.asarray(images))
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rs.randn(*a.shape).astype(np.float32), variables
    )
    want = np.asarray(jdet.apply(variables, jnp.asarray(images)))
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    got = {}
    for head in ("direct", "fft"):
        tdet = Detector(_detector_cfg(pool_mode, True, True, head), 9)
        tdet.load_state_dict(state)
        with torch.no_grad():
            got[head] = tdet(torch.from_numpy(images)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got["fft"] - got["direct"]).max() / scale <= CONV_RTOL
    assert np.abs(got["fft"] - want).max() / scale <= CONV_RTOL
