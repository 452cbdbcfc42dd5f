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


@pytest.mark.parametrize("precision", [None, "high", "default"])
def test_plain_pass_backward_runs_at_the_calls_precision(monkeypatch, precision):
    """The backward's products run inside ``matmul_precision`` with the
    call's precision, however late the caller's ``.backward()`` comes; the
    gradients equal the reference's (fp32 on the CPU at every precision)."""
    import contextlib

    import jax

    active, seen = [], []
    enter, matmul = tmf.matmul_precision, torch.matmul

    @contextlib.contextmanager
    def recording(prec, device):
        active.append(prec)
        try:
            with enter(prec, device):
                yield
        finally:
            active.pop()

    def recorded_matmul(a, b):
        seen.append(tuple(active))
        return matmul(a, b)

    monkeypatch.setattr(tmf, "matmul_precision", recording)
    p, kernels, biases = _inputs((12, 18), (7, 11), seed=3)
    cot = np.random.RandomState(4).randn(2, 12, 18, K).astype(np.float32)
    inputs = [torch.from_numpy(v).requires_grad_(True) for v in (p, kernels, biases)]
    out = tmf.mrf_message_pass_fft(*inputs, precision=precision)
    monkeypatch.setattr(torch, "matmul", recorded_matmul)
    (out * torch.from_numpy(cot)).sum().backward()
    monkeypatch.setattr(torch, "matmul", matmul)
    assert len(seen) >= 10 and all(s == (precision,) for s in seen)

    def loss(*args):
        out = jmf.mrf_message_pass_fft(*args, precision=HI, use_pallas_epilogue=False)
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (p, kernels, biases)))
    for got, ref in zip(inputs, want):
        assert _rel(got.grad, ref) <= MRF_RTOL


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


# The kernel's arithmetic (rows first, 3xTF32) against fp32 products: the
# risk of 3xTF32 is the log of small responses, so the bound is the
# reference's measured on-chip MRF parity (BENCH_r05.json: 1.4e-5) rounded up.
EMULATED_RTOL = 2e-5


def _small_response_inputs(hw, win, batch=2, seed=5):
    """Unaries concentrated on a few pixels: most responses lie below the
    biases and many below eps."""
    rs = np.random.RandomState(seed)
    logits = 40.0 * rs.randn(batch, hw[0] * hw[1], K)
    logits -= logits.max(axis=1, keepdims=True)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    p = p.reshape(batch, *hw, K).astype(np.float32)
    kernels = np.log1p(np.exp(rs.randn(*win, K, K) - 6.0)).astype(np.float32)
    kernels[rs.rand(*win, K, K) < 0.5] = 0.0
    biases = np.log1p(np.exp(rs.randn(K, K) - 9.0)).astype(np.float32)
    biases[rs.rand(K, K) < 0.5] = 1e-8  # with these the clamp at eps takes part
    return p, kernels, biases


EMULATED_CASES = {
    "12x18_7x11": lambda: _inputs((12, 18), (7, 11), seed=1),
    "10x14_11x15": lambda: _inputs((10, 14), (11, 15), seed=1),
    "15x22_29x43": lambda: _inputs((15, 22), (29, 43), seed=2),
    "8x12_15x23": lambda: _inputs((8, 12), (15, 23), seed=2),
    "small_responses": lambda: _small_response_inputs((12, 18), (7, 11)),
}


@pytest.mark.parametrize("case", list(EMULATED_CASES))
def test_fused_tail_emulated_matches_plain_and_pallas_interpret(case):
    p, kernels, biases = EMULATED_CASES[case]()
    if case == "small_responses":
        resp = tmf.fft_pairwise_conv(torch.from_numpy(p), torch.from_numpy(kernels))
        below_bias = (resp < torch.from_numpy(biases)).float().mean().item()
        below_eps = (resp + torch.from_numpy(biases) < 1e-6).float().mean().item()
        assert below_bias > 0.4 and below_eps > 0.1
    pf, kf, tables = tmf.forward_ffts(torch.from_numpy(p), torch.from_numpy(kernels))
    b = torch.from_numpy(biases)
    got = tmff.fused_tail_emulated(pf, kf, tables, b).permute(0, 2, 3, 1)
    want = tmff.fused_tail_plain(pf, kf, tables, b).permute(0, 2, 3, 1)
    want_jax = jmfp.mrf_message_pass_fft_fused(*map(jnp.asarray, (p, kernels, biases)))
    assert got.shape == want.shape == want_jax.shape
    assert _rel(got, want) <= EMULATED_RTOL
    assert _rel(got, want_jax) <= EMULATED_RTOL


def test_fused_tail_emulated_takes_kv_other_than_ka():
    rs = np.random.RandomState(6)
    kv, ka, hw, win = 5, 7, (9, 13), (6, 8)
    logits = rs.randn(3, hw[0] * hw[1], kv)
    p = (np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)).reshape(3, *hw, kv)
    kernels = np.log1p(np.exp(rs.randn(*win, kv, ka))).astype(np.float32)
    biases = torch.from_numpy(np.log1p(np.exp(rs.randn(kv, ka) - 4.0)).astype(np.float32))
    pf, kf, tables = tmf.forward_ffts(torch.from_numpy(p.astype(np.float32)),
                                      torch.from_numpy(kernels))
    got = tmff.fused_tail_emulated(pf, kf, tables, biases)
    want = tmff.fused_tail_plain(pf, kf, tables, biases)
    assert got.shape == want.shape == (3, ka, *hw)
    assert _rel(got, want) <= EMULATED_RTOL


def test_tf32_split_is_exact_and_rounds_to_nearest():
    rs = np.random.RandomState(7)
    x = np.concatenate([
        rs.randn(4096) * 10.0 ** rs.randint(-30, 30, 4096),
        [0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -10,
         1.0 + 3 * 2.0 ** -11, 2.0 - 2.0 ** -23, 1e-38, -3e-39],
    ]).astype(np.float32)
    hi, lo = tmff.tf32_split(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    assert np.array_equal(hi.astype(np.float64) + lo.astype(np.float64), x.astype(np.float64))
    assert not (hi.view(np.int32) & 0x1FFF).any()  # a TF32 value: 10 explicit mantissa bits
    ulp = np.abs(np.nextafter(np.abs(hi), np.inf) - np.abs(hi)) * 2.0 ** 13  # TF32 spacing at hi
    assert (np.abs(lo) <= ulp / 2).all()
    # Ties go away from zero, as cvt.rna does: 1 + 2^-11 lies halfway to 1 + 2^-10.
    tie = tmff.tf32_split(torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)]))[0]
    assert tie.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    # And the three-term product is then exact on operands whose lo parts vanish.
    a = torch.from_numpy(hi[:64].reshape(8, 8).copy()).clamp(-1e3, 1e3)
    a = tmff.tf32_split(a)[0]
    assert torch.equal(tmff.matmul_3xtf32(a, torch.eye(8)), a)


@pytest.mark.parametrize("hw,win", [((12, 18), (7, 11)), ((12, 18), (25, 13)), ((9, 10), (6, 8))])
def test_stacked_inverse_tables_match_reference(hw, win):
    """``ir_stack`` and ``ic_stack`` are the reference's inverse operators
    laid out as real block matrices."""
    want = jmf._dft_consts(hw, win, real_cols=True)
    t = tmf.dft_tables(hw, win, torch.device("cpu"))
    h, g = hw[0], want["ic_re"].shape[1]
    ir, ic = t["ir_stack"].numpy(), t["ic_stack"].numpy()
    assert ir.shape == (2 * h, 2 * want["ir_re"].shape[1]) and ic.shape == (2 * g, hw[1])
    ph = want["ir_re"].shape[1]
    np.testing.assert_array_equal(ir[:h, :ph], want["ir_re"])
    np.testing.assert_array_equal(ir[:h, ph:], -want["ir_im"])
    np.testing.assert_array_equal(ir[h:, :ph], want["ir_im"])
    np.testing.assert_array_equal(ir[h:, ph:], want["ir_re"])
    np.testing.assert_array_equal(ic[:g], want["ic_re"].T)
    np.testing.assert_array_equal(ic[g:], -want["ic_im"].T)


# One TF32 pass (the kernel at precision 'default') against fp32 products:
# the reference's bar for its single-pass precision, 0.4% max relative
# output error (jointpose/evaluate.py --mrf-precision).
SINGLE_PASS_RTOL = 4e-3


def _sparse_kernel_inputs(hw, win, batch=2, seed=10):
    """chip_smoke.py's small-response operands: unaries concentrated on a
    few pixels, kernels near the spatial model's uniform init with half of
    their taps zero, half of the biases 1e-8."""
    rs = np.random.RandomState(seed)
    logits = 40.0 * rs.randn(batch, hw[0] * hw[1], K)
    logits -= logits.max(axis=1, keepdims=True)
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    p = p.reshape(batch, *hw, K).astype(np.float32)
    raw = np.log(np.expm1(1.0 / (win[0] * win[1]))) + 0.5 * rs.randn(*win, K, K)
    kernels = np.log1p(np.exp(raw)) * (rs.rand(*win, K, K) < 0.5)
    biases = np.log1p(np.exp(np.log(np.expm1(1e-4)) + rs.randn(K, K)))
    biases[rs.rand(K, K) < 0.5] = 1e-8
    return p, kernels.astype(np.float32), biases.astype(np.float32)


SINGLE_PASS_CASES = {
    "12x18_7x11": EMULATED_CASES["12x18_7x11"],
    "15x22_29x43": EMULATED_CASES["15x22_29x43"],
    "sparse_kernels": lambda: _sparse_kernel_inputs((15, 22), (29, 43)),
}


@pytest.mark.parametrize("case", list(SINGLE_PASS_CASES))
def test_fused_tail_emulated_single_pass_stays_within_the_reference_bar(case):
    p, kernels, biases = SINGLE_PASS_CASES[case]()
    pf, kf, tables = tmf.forward_ffts(torch.from_numpy(p), torch.from_numpy(kernels))
    b = torch.from_numpy(biases)
    one = tmff.fused_tail_emulated(pf, kf, tables, b, passes=1)
    three = tmff.fused_tail_emulated(pf, kf, tables, b, passes=3)
    want = tmff.fused_tail_plain(pf, kf, tables, b)
    assert _rel(one, want) <= SINGLE_PASS_RTOL
    # One pass really is coarser than three: it is not the 3xTF32 arithmetic.
    assert _rel(one, want) > _rel(three, want)
    with pytest.raises(ValueError, match="passes"):
        tmff.fused_tail_emulated(pf, kf, tables, b, passes=2)


def test_matmul_tf32_is_the_product_of_rounded_operands():
    rs = np.random.RandomState(8)
    a = torch.from_numpy(rs.randn(3, 16, 24).astype(np.float32))
    b = torch.from_numpy(rs.randn(24, 8).astype(np.float32))
    a_hi, b_hi = tmff.tf32_split(a)[0], tmff.tf32_split(b)[0]
    assert torch.equal(tmff.matmul_tf32(a, b), torch.matmul(a_hi, b_hi))
    # Each product of two TF32 values is exact in fp64, so the fp32 sums
    # are the only rounding: within a few fp32 steps of the fp64 product.
    exact = torch.matmul(a_hi.double(), b_hi.double())
    assert (tmff.matmul_tf32(a, b).double() - exact).abs().max() <= 1e-5
    # And the rounding is visible against the fp32 product.
    assert not torch.equal(tmff.matmul_tf32(a, b), torch.matmul(a, b))


def _mrf_functions():
    from jointpose_torch.ops.mrf_epilogue import mrf_message_pass_pallas
    from jointpose_torch.ops.mrf_xla import mrf_message_pass_coarse, mrf_message_pass_xla

    return {
        "xla": mrf_message_pass_xla,
        "coarse": lambda *a, **kw: mrf_message_pass_coarse(*a, stride=2, **kw),
        "pallas": mrf_message_pass_pallas,
        "fft": tmf.mrf_message_pass_fft,
        "fft_fused": tmff.mrf_message_pass_fft_fused,
    }


@pytest.mark.parametrize("name", ["xla", "coarse", "pallas", "fft", "fft_fused"])
def test_default_precision_equals_high_on_the_cpu(name):
    fn = _mrf_functions()[name]
    p, kernels, biases = map(torch.from_numpy, _inputs((12, 18), (7, 11), seed=9))
    high = fn(p, kernels, biases, eps=1e-6, precision="high")
    assert torch.equal(fn(p, kernels, biases, eps=1e-6, precision="default"), high)
    assert torch.equal(fn(p, kernels, biases, eps=1e-6), high)
    with pytest.raises(ValueError, match="precision"):
        fn(p, kernels, biases, eps=1e-6, precision="bf16")


def test_matmul_precision_leaves_the_flags_as_it_found_them():
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    for precision in (None, "high", "default"):
        # On the CPU the helper changes nothing.
        with tmf.matmul_precision(precision, torch.device("cpu")):
            assert flags.allow_tf32 == before
    def tf32_now():
        # Inside the helper only the newer per-backend setting may be read,
        # where this PyTorch has it (it and the legacy flag do not mix).
        if hasattr(flags, "fp32_precision"):
            return flags.fp32_precision == "tf32"
        return flags.allow_tf32

    try:
        for outer in (False, True):
            flags.allow_tf32 = outer
            for precision, tf32 in ((None, False), ("high", False), ("default", True)):
                with tmf.matmul_precision(precision, torch.device("cuda")):
                    assert tf32_now() == tf32
                assert flags.allow_tf32 == outer
    finally:
        flags.allow_tf32 = before
