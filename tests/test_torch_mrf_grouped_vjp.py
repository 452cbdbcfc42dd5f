"""Parity of the port's hand-written backward of the fp32-output grouped
conv (``jointpose_torch.ops.mrf_xla.grouped_conv_f32``: dense-embedded
dL/dk, space-to-depth dL/dp) against the reference's custom VJP
(``jointpose.ops.mrf_xla._grouped_conv_f32``) on the CPU, in fp32 at
``Precision.HIGHEST`` and in bf16; even windows, where the reference's
dense transpose is off, against autograd of the plain grouped conv."""

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.ops import mrf_xla as jmx
from jointpose_torch.ops import mrf_xla as tmx

HI = lax.Precision.HIGHEST
# fp32: sums of a few thousand products in another order; the reference's
# own bar for its backward against autodiff (tests/test_mrf.py).
GRAD_RTOL = 1e-4
# bf16 gradients: both sides round the cotangent to bf16, accumulate in
# fp32 in their own order and round the result to bf16; two ulps of bf16
# (2^-7) of the largest covers one rounding landing on either side.
BF16_RTOL = 2.0 ** -7


def _rel(got, want) -> float:
    got, want = (np.asarray(x.detach().float() if torch.is_tensor(x) else x, np.float64)
                 for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _operands(kv, ka, wh, ww, hw, seed, batch=2):
    """p (B, H, W, Kv), HWIO kernels (wh, ww, 1, Kv*Ka) and a cotangent of the
    response, as numpy fp32."""
    rs = np.random.RandomState(seed)
    p = rs.rand(batch, *hw, kv).astype(np.float32)
    kern = (rs.rand(wh, ww, 1, kv * ka) * 0.1).astype(np.float32)
    g = rs.randn(batch, *hw, kv * ka).astype(np.float32)
    return p, kern, g


def _port_vjp(p, kern, g, kv, dtype=torch.float32):
    pt = torch.from_numpy(p).to(dtype).requires_grad_(True)
    kt = torch.from_numpy(kern).to(dtype).requires_grad_(True)
    out = tmx.grouped_conv_f32(pt, kt, kv)
    dp, dk = torch.autograd.grad(out, (pt, kt), torch.from_numpy(g))
    return out, dp, dk


def _ref_vjp(p, kern, g, kv, dtype=jnp.float32):
    out, vjp = jax.vjp(lambda a, b: jmx._grouped_conv_f32(a, b, kv, HI),
                       jnp.asarray(p, dtype), jnp.asarray(kern, dtype))
    return (out, *vjp(jnp.asarray(g)))


@pytest.mark.parametrize("kv,ka,wh,ww,hw", [
    (3, 5, 7, 5, (10, 14)),
    (4, 4, 5, 5, (10, 14)),
    (6, 6, 11, 15, (10, 14)),
    (9, 9, 17, 25, (6, 13)),   # flagship's window on a width that is no multiple of 8
    (33, 2, 5, 5, (10, 14)),   # more than 32 groups: the dense transpose
], ids=["kv3_ka5", "kv4_ka4", "kv6_11x15", "flagship", "dense_branch"])
def test_grouped_vjp_matches_reference_fp32(kv, ka, wh, ww, hw):
    p, kern, g = _operands(kv, ka, wh, ww, hw, seed=kv + wh)
    out, dp, dk = _port_vjp(p, kern, g, kv)
    want_out, want_dp, want_dk = _ref_vjp(p, kern, g, kv)
    assert out.dtype == torch.float32 and dp.dtype == dk.dtype == torch.float32
    assert dp.shape == want_dp.shape and dk.shape == want_dk.shape
    assert _rel(out, want_out) <= GRAD_RTOL
    assert _rel(dp, want_dp) <= GRAD_RTOL
    assert _rel(dk, want_dk) <= GRAD_RTOL


def test_grouped_vjp_matches_reference_bf16():
    p, kern, g = _operands(9, 9, 17, 25, (6, 13), seed=11)
    out, dp, dk = _port_vjp(p, kern, g, 9, torch.bfloat16)
    want_out, want_dp, want_dk = _ref_vjp(p, kern, g, 9, jnp.bfloat16)
    # The reference's types: forward fp32, gradients in the operands' type.
    assert out.dtype == torch.float32 and want_out.dtype == jnp.float32
    assert dp.dtype == dk.dtype == torch.bfloat16 and want_dp.dtype == want_dk.dtype == jnp.bfloat16
    assert _rel(out, want_out) <= GRAD_RTOL  # bf16 operands are exact in fp32
    assert _rel(dp, want_dp.astype(jnp.float32)) <= BF16_RTOL
    assert _rel(dk, want_dk.astype(jnp.float32)) <= BF16_RTOL


def test_dense_embed_matches_reference():
    _, kern, _ = _operands(4, 3, 5, 7, (4, 4), seed=1)
    got = tmx.dense_embed(torch.from_numpy(kern), 4)
    want = jmx._dense_embed(jnp.asarray(kern), 4)
    assert got.shape == want.shape == (5, 7, 4, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv,ka,wh,ww,hw", [(9, 9, 17, 25, (6, 13)), (3, 5, 7, 5, (10, 14))],
                         ids=["flagship", "kv3_ka5"])
def test_dp_s2d_matches_reference(kv, ka, wh, ww, hw):
    _, kern, g = _operands(kv, ka, wh, ww, hw, seed=2)
    got = tmx.dp_s2d(torch.from_numpy(g), torch.from_numpy(kern), kv, torch.float32)
    want = jmx._dp_s2d(jnp.asarray(g), jnp.asarray(kern), kv, HI, jnp.float32)
    assert got.shape == want.shape == (2, *hw, kv)
    assert _rel(got, want) <= GRAD_RTOL


@pytest.mark.parametrize("kv,ka,wh,ww", [(3, 3, 4, 6), (4, 2, 3, 4)], ids=["4x6", "3x4"])
def test_even_windows_match_autograd(kv, ka, wh, ww):
    """The reference pads its dense transpose SAME, off for even windows;
    the port pads it as the transpose of the forward's SAME padding."""
    p, kern, g = _operands(kv, ka, wh, ww, (9, 11), seed=3)
    _, dp, dk = _port_vjp(p, kern, g, kv)
    pt = torch.from_numpy(p).requires_grad_(True)
    kt = torch.from_numpy(kern).requires_grad_(True)
    want = torch.autograd.grad(tmx.grouped_conv(pt, kt, kv, torch.float32), (pt, kt),
                               torch.from_numpy(g))
    assert _rel(dp, want[0]) <= GRAD_RTOL
    assert _rel(dk, want[1]) <= GRAD_RTOL


def _reaches_function(out: torch.Tensor) -> bool:
    """Whether ``out``'s autograd graph holds the hand-written backward."""
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "_GroupedConvF32Backward":
            return True
        stack.extend(f for f, _ in fn.next_functions)
    return False


@pytest.mark.parametrize("dtype,out_dtype,reaches", [
    (torch.bfloat16, torch.float32, True),
    (torch.float32, torch.float32, False),
    (torch.bfloat16, None, False),
], ids=["bf16_to_f32", "f32", "bf16_pallas_path"])
def test_pairwise_conv_route(dtype, out_dtype, reaches):
    """The reference's rule: the custom VJP exactly where an fp32 result is
    asked of a narrower p (the pallas path asks for p's type)."""
    p, kern, _ = _operands(3, 3, 5, 5, (6, 8), seed=4)
    pt = torch.from_numpy(p).to(dtype).requires_grad_(True)
    kernels = torch.from_numpy(kern).reshape(5, 5, 3, 3).to(dtype).requires_grad_(True)
    out = tmx.pairwise_conv(pt, kernels, out_dtype=out_dtype)
    assert out.dtype == (out_dtype or dtype) and out.shape == (2, 6, 8, 3, 3)
    assert _reaches_function(out) == reaches
    assert _reaches_function(tmx.mrf_message_pass_xla(pt, kernels, torch.ones(3, 3))) == (
        dtype != torch.float32)


def test_spatial_model_bf16_gradients_match_reference():
    """One SpatialModel of a small 'auto' stride-2 config ('xla': the coarse
    pass through the custom VJP) in bf16: parameter and input gradients
    against the reference's, within the bf16 bar (the gradients pass
    through the backward's bf16 results)."""
    from jointpose.configs import MRFConfig as JaxMRFConfig
    from jointpose.models import mrf as jmrf
    from jointpose_torch.configs import MRFConfig
    from jointpose_torch.models import mrf as tmrf

    k, window, hw = 9, (7, 9), (12, 16)
    rs = np.random.RandomState(5)
    p = rs.rand(2, *hw, k).astype(np.float32)
    p /= p.sum(axis=(1, 2), keepdims=True)
    raw_k = (rs.randn(*window, k, k) * 0.5 - 4.0).astype(np.float32)
    raw_b = (rs.randn(k, k) - 6.0).astype(np.float32)
    cot = rs.randn(2, *hw, k).astype(np.float32)
    assert tmrf.select_impl(MRFConfig(window=window, stride=2)) == "xla"

    jm = jmrf.SpatialModel(JaxMRFConfig(window=window, stride=2), k, dtype=jnp.bfloat16)
    params = {"params": {"raw_kernels": jnp.asarray(raw_k), "raw_bias": jnp.asarray(raw_b)}}

    def loss(params, p):
        return jnp.sum(jm.apply(params, p) * cot)

    want_params, want_p = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(p, jnp.bfloat16))

    tm = tmrf.SpatialModel(MRFConfig(window=window, stride=2), k, dtype=torch.bfloat16)
    with torch.no_grad():
        tm.raw_kernels.copy_(torch.from_numpy(raw_k))
        tm.raw_bias.copy_(torch.from_numpy(raw_b))
    pt = torch.from_numpy(p).bfloat16().requires_grad_(True)
    out = tm(pt)
    assert _reaches_function(out)
    (out * torch.from_numpy(cot)).sum().backward()
    assert pt.grad.dtype == torch.bfloat16
    assert _rel(tm.raw_kernels.grad, want_params["params"]["raw_kernels"]) <= BF16_RTOL
    assert _rel(tm.raw_bias.grad, want_params["params"]["raw_bias"]) <= BF16_RTOL
    assert _rel(pt.grad, want_p.astype(jnp.float32)) <= BF16_RTOL
