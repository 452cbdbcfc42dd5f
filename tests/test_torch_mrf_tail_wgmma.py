"""The host side of the single-pass Fourier MRF tail on ``wgmma``
(``csrc/mrf_fft_tail_wgmma.cu``) and of the row-major warp in one launch,
on the CPU: the TF32 rounding of the tables against a numpy reference
built from the value (not the bits), the table images against the stacked
inverse operators they lay out, the kernel's grouping of the sums
(``fused_tail_emulated(chunk=...)``) against the reference's fused pass at
``Precision.DEFAULT``, and the row-major strip arithmetic against the
production one, the dense-hat oracle and the reference's Pallas kernel in
interpret mode.  The kernels themselves run in
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` on the card."""

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointpose.configs import AugmentConfig as JaxAugmentConfig
from jointpose.data import augment as ja
from jointpose.ops import mrf_fft_pallas as jmfp
from jointpose.ops import warp_pallas as jw
from jointpose_torch import ops
from jointpose_torch.ops import mrf_fft as tmf
from jointpose_torch.ops import mrf_fft_fused as tmff
from jointpose_torch.ops import warp as tw

K = 9
# One TF32 pass against fp32: the reference's bar for its single-pass
# precision, 0.4% max relative output error (jointpose/evaluate.py
# --mrf-precision); JAX computes DEFAULT in fp32 on the CPU.
SINGLE_PASS_RTOL = 4e-3
# Two groupings of the same TF32 products: the reference's parity
# tolerance for every message-pass path (BENCH_r05.json).
KERNEL_RTOL = 1e-3
# The reference's tolerance for its shear kernel against its oracle
# (tests/test_warp_pallas.py), on pixels in [0, 1].
WARP_ATOL = 2e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _tf32_by_value(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 by arithmetic on its value in float64: the nearest
    multiple of the TF32 quantum (2^(e - 11) for |x| in [2^(e-1), 2^e),
    2^-136 below the normal range), halves away from zero."""
    x = x.astype(np.float64)
    _, e = np.frexp(x)
    quantum = np.exp2(np.maximum(e - 11, -136).astype(np.float64))
    return np.copysign(np.floor(np.abs(x) / quantum + 0.5) * quantum, x).astype(np.float32)


def test_tf32_round_matches_a_reference_on_the_value():
    rs = np.random.RandomState(3)
    one = np.float32(1.0)
    ties = [1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 3.0 * (1.0 + 2.0 ** -11), 2.0 ** -140 * 1.5]
    x = np.concatenate([
        rs.randn(4096) * 10.0 ** rs.randint(-37, 37, 4096),
        ties, [-t for t in ties],
        [0.0, -0.0, 1.0, -1.0, 2.0 - 2.0 ** -23, np.nextafter(one, np.float32(2.0)) - 1.0],
        # Subnormals: below 2^-126, TF32 keeps the top 10 of the 23 bits.
        [1e-45, -1e-45, 3e-39, -3e-39, 2.0 ** -136, 1.5 * 2.0 ** -136, -1.5 * 2.0 ** -136,
         2.0 ** -126 - 2.0 ** -149, 5e-39],
    ]).astype(np.float32)
    got = tmf.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _tf32_by_value(x).view(np.uint32))
    # Ties go away from zero, as cvt.rna does.
    assert got[4096] == np.float32(1.0 + 2.0 ** -10) and got[4100] == -got[4096]


def _unlay(img: torch.Tensor, rows: int) -> np.ndarray:
    """(tiles, rows * depth) in the core-matrix layout -> (tiles, rows, depth)."""
    n, size = img.shape
    depth = size // rows
    m = img.numpy().reshape(n, depth // 4, rows // 8, 8, 4).transpose(0, 2, 3, 1, 4)
    return m.reshape(n, rows, depth)


# (hw, window): the paper geometry; two row tiles and a ragged Ph; two
# column tiles with G no multiple of 8.
IMAGE_GEOMETRIES = [((60, 90), (45, 67)), ((70, 33), (9, 7)), ((13, 100), (6, 8))]


@pytest.mark.parametrize("hw,win", IMAGE_GEOMETRIES)
def test_table_images_unlay_to_the_stacked_tables(hw, win):
    t = tmf.dft_tables(hw, win, torch.device("cpu"))
    h, w = hw
    ph, g = t["ir_re"].shape[1], t["ict_re"].shape[0]
    php, gp = -(-ph // 8) * 8, -(-g // 8) * 8
    ir = _unlay(t["ir_img"], tmf.TAIL_ROWS).reshape(-1, 2, php)  # (rows, half, depth)
    lower = tmf.tf32_round(t["ir_stack"][h:]).numpy()  # [ir_im | ir_re]
    assert ir.shape[0] == -(-h // 64) * 64
    np.testing.assert_array_equal(ir[:h, 0, :ph], lower[:, :ph])
    np.testing.assert_array_equal(ir[:h, 1, :ph], lower[:, ph:])
    assert not ir[h:].any() and not ir[:, :, ph:].any()
    ic = _unlay(t["ic_img"], tmf.TAIL_COLS)  # (column tiles, 96, 2Gp)
    ic = ic.transpose(2, 0, 1).reshape(2, gp // 8, 8, -1)  # (half, group, depth, column)
    order = np.argsort(tmf.TAIL_BIN_ORDER)  # depth of each bin
    ic = ic[:, :, order].reshape(2, gp, -1)  # (half, bin, column)
    stack = tmf.tf32_round(t["ic_stack"]).numpy()
    np.testing.assert_array_equal(ic[0, :g, :w], stack[:g])
    np.testing.assert_array_equal(ic[1, :g, :w], stack[g:])
    assert not ic[:, g:].any() and not ic[:, :, w:].any()
    # Rounded once: the images hold TF32 values.
    for img in (t["ir_img"], t["ic_img"]):
        assert not (img.view(torch.int32) & 0x1FFF).any()


def _inputs(hw, win, batch, seed, peaked=False):
    rs = np.random.RandomState(seed)
    logits = (40.0 if peaked else 1.0) * rs.randn(batch, hw[0] * hw[1], K)
    logits -= logits.max(axis=1, keepdims=True)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    p = p.reshape(batch, *hw, K).astype(np.float32)
    kernels = np.log1p(np.exp(rs.randn(*win, K, K) - (6.0 if peaked else 0.0)))
    if peaked:
        kernels[rs.rand(*win, K, K) < 0.5] = 0.0
    biases = np.log1p(np.exp(rs.randn(K, K) - (9.0 if peaked else 4.0)))
    return p, kernels.astype(np.float32), biases.astype(np.float32)


# (hw, window, batch, chunk, peaked): chunks of 32 and 8 bins; one with
# unaries concentrated on a few pixels (most responses below the biases).
CHUNKED_CASES = [((12, 18), (7, 11), 2, 32, False), ((15, 22), (29, 43), 2, 8, False),
                 ((10, 14), (11, 15), 1, 8, False), ((12, 18), (7, 11), 2, 8, True)]


@pytest.mark.parametrize("hw,win,batch,chunk,peaked", CHUNKED_CASES)
def test_chunked_emulation_matches_the_reference_at_default_precision(hw, win, batch, chunk,
                                                                      peaked):
    p, kernels, biases = _inputs(hw, win, batch, seed=11, peaked=peaked)
    pf, kf, tables = tmf.forward_ffts(torch.from_numpy(p), torch.from_numpy(kernels))
    b = torch.from_numpy(biases)
    got = tmff.fused_tail_emulated(pf, kf, tables, b, passes=1, chunk=chunk)
    stacked = tmff.fused_tail_emulated(pf, kf, tables, b, passes=1)
    want_jax = jmfp.mrf_message_pass_fft_fused(*map(jnp.asarray, (p, kernels, biases)),
                                               precision=lax.Precision.DEFAULT)
    got = got.permute(0, 2, 3, 1)
    assert got.shape == want_jax.shape
    assert _rel(got, want_jax) <= SINGLE_PASS_RTOL
    assert _rel(got, stacked.permute(0, 2, 3, 1)) <= KERNEL_RTOL
    # One pass is not fp32: the rounding shows.
    assert not torch.equal(got, tmff.fused_tail_plain(pf, kf, tables, b).permute(0, 2, 3, 1))


def test_cpu_wrappers_run_the_plain_tail_without_launching():
    p, kernels, biases = _inputs((9, 10), (6, 8), 1, seed=2)
    pf, kf, tables = tmf.forward_ffts(torch.from_numpy(p), torch.from_numpy(kernels))
    b = torch.from_numpy(biases)
    before = (tmff.fused_tail.launches_1pass, tmff.fused_tail.launches)
    want = tmff.fused_tail_plain(pf, kf, tables, b)
    assert torch.equal(tmff.fused_tail(pf, kf, tables, b, precision="default"), want)
    assert torch.equal(tmff.fused_tail(pf, kf, tables, b, precision="high"), want)
    assert (tmff.fused_tail.launches_1pass, tmff.fused_tail.launches) == before
    counters = ops.launch_counters()
    for counter in ((tmff.fused_tail, "launches"), (tmff.fused_tail, "launches_1pass"),
                    (tw.shear_warp_rowmajor, "launches")):
        assert counter in counters


def _draw(seed, batch, hw):
    p = ja.random_augment_params(jax.random.PRNGKey(seed), batch, JaxAugmentConfig(), hw)
    a, b = ja._forward_affine(p, hw)
    a_inv = np.linalg.inv(np.asarray(a, np.float64)).astype(np.float32)
    b_inv = -np.einsum("bij,bj->bi", a_inv, np.asarray(b)).astype(np.float32)
    images = np.random.RandomState(seed).rand(batch, *hw, 3).astype(np.float32)
    return images, a_inv, b_inv


@pytest.mark.parametrize("hw,width", [((24, 36), None), ((17, 29), 5), ((24, 36), 1)])
def test_rowmajor_strips_are_bit_equal_to_the_production_strips(hw, width):
    """Holding a strip's intermediate as lines per column changes where the
    values lie, not one operation: bit-equal to the production orientation's
    strips, within the oracle's tolerance of the dense-hat reference, and of
    the reference's row-major Pallas kernel in interpret mode."""
    images, a_inv, b_inv = _draw(4, 2, hw)
    args = tuple(map(torch.from_numpy, (images, a_inv, b_inv)))
    got = tw.shear_warp_strips(*args, tw=width, rowmajor=True)
    assert torch.equal(got, tw.shear_warp_strips(*args, tw=width))
    assert (got - tw.shear_warp_reference(*args)).abs().max().item() <= WARP_ATOL
    want_jax = jw.shear_warp_rowmajor(*map(jnp.asarray, (images, a_inv, b_inv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=0, atol=WARP_ATOL)
