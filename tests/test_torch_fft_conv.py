"""Parity of the port's Fourier head conv (jointpose_torch.ops.fft_conv)
against the JAX reference (jointpose.ops.fft_conv) in fp32 on the CPU.

The reference's Pallas tails run in interpret mode here, as its own tests
run them; the port's wrappers run their plain versions on CPU tensors.
Inputs come from a numpy seed and go through both sides."""

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jointpose.ops import fft_conv as jfc
from jointpose.ops.mrf_fft import _dft_consts as jax_dft_consts
from jointpose_torch.models.detector import Conv
from jointpose_torch.ops import fft_conv as tfc
from jointpose_torch.ops.mrf_fft import dft_tables

# max|Δ| / max|ref| in fp32: the reference's own bound for its fused tail
# against its XLA tail and for the conv against lax (tests/test_fft_conv.py).
CONV_RTOL = 2e-5
# Gradients of the fused route against the reference's custom VJP.
GRAD_RTOL = 1e-4

SHAPES = {
    "9x9": ((4, 20, 24, 16), (9, 9, 16, 32)),
    "5x5": ((2, 12, 16, 4), (5, 5, 4, 8)),
    "7x9": ((2, 9, 13, 3), (7, 9, 3, 5)),
}


def _inputs(name, seed=0):
    xs, ks = SHAPES[name]
    rs = np.random.RandomState(seed)
    return rs.randn(*xs).astype(np.float32), rs.randn(*ks).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("pallas_tail", [True, False])
@pytest.mark.parametrize("name", ["9x9", "5x5"])
def test_fft_conv2d_matches_reference(name, pallas_tail):
    x, k = _inputs(name)
    want = jfc.fft_conv2d(jnp.asarray(x), jnp.asarray(k), precision=lax.Precision.HIGHEST,
                          pallas_tail=pallas_tail)
    got = tfc.fft_conv2d(torch.from_numpy(x), torch.from_numpy(k), pallas_tail=pallas_tail)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= CONV_RTOL


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fft_conv2d_matches_direct_conv(name):
    x, k = map(torch.from_numpy, _inputs(name, seed=1))
    kh, kw = k.shape[:2]
    want = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=(kh // 2, kw // 2))
    got = tfc.fft_conv2d(x, k)
    assert _rel(got, want.permute(0, 2, 3, 1)) <= CONV_RTOL


def _tail_operands(seed=2):
    """Spectra and tables of a small geometry for both sides: G=5, Ph=16
    (12+5-1, already a multiple of 8), B=4, Ci=8, Co=16, Kh=5, H=12."""
    hw, kernel = (12, 5), (5, 5)
    rs = np.random.RandomState(seed)
    consts = jax_dft_consts(hw, kernel, real_cols=True, row_pad_to=8)
    g, ph = consts["gc_re"].shape[0], consts["gr_re"].shape[0]
    ops = {
        "xr": rs.randn(g, ph, 4, 8), "xi": rs.randn(g, ph, 4, 8),
        "ar": rs.randn(g, 5, 8, 16), "ai": rs.randn(g, 5, 8, 16),
    }
    ops = {n: v.astype(np.float32) for n, v in ops.items()}
    tables = tfc._conv_tables(hw, kernel, torch.device("cpu"), 8, torch.float32)
    return ops, consts, tables, hw[0]


@pytest.mark.parametrize("entry", ["kdft_resident", "kdft", "kf"])
def test_plain_tails_match_reference_kernels(entry):
    ops, c, tables, h = _tail_operands()
    j = {n: jnp.asarray(v) for n, v in ops.items()}
    t = {n: torch.from_numpy(v) for n, v in ops.items()}
    jt = {n: jnp.asarray(v) for n, v in c.items()}
    prec = lax.Precision.HIGHEST
    if entry == "kdft_resident":
        want = jfc._tail_call_kdft_resident(
            j["xr"], j["xi"], j["ar"], j["ai"], jt["gr_re"], jt["gr_im"],
            jt["ir_re"].T, jt["ir_im"].T, h=h, tb=4, cot=16, prec=prec)
        got = tfc.tail_kdft_resident(t["xr"], t["xi"], t["ar"], t["ai"], tables)
    elif entry == "kdft":
        want = jfc._tail_call_kdft(
            j["xr"], j["xi"], j["ar"], j["ai"], jt["gr_re"], jt["gr_im"],
            jt["ir_re"].T, jt["ir_im"].T, h=h, tb=2, cot=16, fb=8, prec=prec)
        got = tfc.tail_kdft(t["xr"], t["xi"], t["ar"], t["ai"], tables)
    else:
        # K_f as the reference's fallback builds it, handed to both sides.
        em = lambda s, a, b: jnp.einsum(s, a, b, precision=prec)  # noqa: E731
        kr = em("fy,gyio->gfio", jt["gr_re"], j["ar"]) - em("fy,gyio->gfio", jt["gr_im"], j["ai"])
        ki = em("fy,gyio->gfio", jt["gr_re"], j["ai"]) + em("fy,gyio->gfio", jt["gr_im"], j["ar"])
        want = jfc._tail_call(j["xr"], j["xi"], kr, ki, jt["ir_re"].T, jt["ir_im"].T,
                              h=h, tb=2, cot=16, fb=8, prec=prec)
        got = tfc.tail_kf(t["xr"], t["xi"], torch.from_numpy(np.array(kr)),
                          torch.from_numpy(np.array(ki)), tables)
    assert tuple(got.shape) == tuple(want.shape) == (h, 2, 5, 4, 16)
    assert _rel(got, want) <= CONV_RTOL
    # On CPU tensors no kernel launches.
    assert tfc.tail_kdft_resident.launches == tfc.tail_kdft.launches == tfc.tail_kf.launches == 0


@pytest.mark.parametrize("preference", [("kdft_resident",), ("kdft",), ("kf",)])
def test_every_tail_route_gives_the_same_conv(monkeypatch, preference):
    x, k = map(torch.from_numpy, _inputs("9x9", seed=3))
    want = tfc.fft_conv2d(x, k, pallas_tail=False)
    monkeypatch.setattr(tfc, "TAIL_PREFERENCE", preference)
    assert tfc.select_tail(32, 4, 9, 4) == preference[0]
    assert _rel(tfc.fft_conv2d(x, k), want) <= CONV_RTOL


def test_select_tail_is_a_rule_on_shapes():
    # The paper head at serving batch 8 (Ph = 68 padded to 72), both dtypes:
    # the whole batch in one block.
    assert tfc.select_tail(72, 8, 9, 2) == "kdft_resident"
    assert tfc.select_tail(72, 8, 9, 4) == "kdft_resident"
    assert tfc.select_tail(72, 16, 9, 2) == "kdft_resident"
    # More than 16 images, or an R tile too large for one block: batch tiles.
    assert tfc.select_tail(72, 128, 9, 2) == "kdft"
    assert tfc.select_tail(72, 16, 9, 4) == "kdft"
    # A kernel taller than the compiled builds: K_f from memory.
    assert tfc.select_tail(72, 8, 11, 2) == "kf"
    # A tile no block can hold raises; nothing falls back silently.
    assert not tfc.tail_fits("kf", 4000, 1, 9, 4)
    with pytest.raises(ValueError, match="pallas_tail=False"):
        tfc.select_tail(4000, 1, 9, 4)
    with pytest.raises(ValueError, match="unknown tail"):
        tfc.tail_fits("nope", 72, 8, 9, 2)
    # The shared-memory sum the C source repeats, at the paper head in bf16.
    assert tfc._tail_smem_bytes(72, 8, 9, 2) == 8192 + 18432 + 5760 + 73728


def test_fftconv_and_conv_share_one_state_dict():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 6, 10, 14).astype(np.float32))  # NCHW
    direct = Conv(6, 8, 5)
    with torch.no_grad():
        direct.weight.copy_(torch.from_numpy(rs.randn(8, 6, 5, 5).astype(np.float32)))
        direct.bias.copy_(torch.from_numpy(rs.randn(8).astype(np.float32)))
    fourier = tfc.FFTConv(6, 8, 5)
    fourier.load_state_dict(direct.state_dict())
    with torch.no_grad():
        want, got = direct(x), fourier(x)
    assert got.shape == want.shape
    assert _rel(got, want) <= 5e-5  # the reference's bound for FFTConv against nn.Conv


def test_fused_route_gradients_match_reference_vjp():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 12, 16, 8).astype(np.float32)
    k = rs.randn(5, 5, 8, 8).astype(np.float32)
    cot = rs.randn(2, 12, 16, 8).astype(np.float32)

    def loss(x_, k_):
        y = jfc.fft_conv2d(x_, k_, precision=lax.Precision.HIGHEST, pallas_tail=True)
        return jnp.sum(y * cot)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    grads = {}
    for fused in (True, False):
        tx = torch.from_numpy(x).requires_grad_(True)
        tk = torch.from_numpy(k).requires_grad_(True)
        (tfc.fft_conv2d(tx, tk, pallas_tail=fused) * torch.from_numpy(cot)).sum().backward()
        grads[fused] = (tx.grad, tk.grad)
    for got, plain, ref in zip(grads[True], grads[False], want):
        assert _rel(got, ref) <= GRAD_RTOL
        assert _rel(got, plain) <= GRAD_RTOL
    # Only the kernel asks for a gradient (a frozen input): x gets none.
    tk = torch.from_numpy(k).requires_grad_(True)
    tfc.fft_conv2d(torch.from_numpy(x), tk).sum().backward()
    assert tk.grad is not None and bool(torch.isfinite(tk.grad).all())


@pytest.mark.parametrize("pallas_tail", [True, False])
def test_bf16_drift_within_direct_bf16_budget(pallas_tail):
    # As the reference's test: the bf16 Fourier conv drifts from the fp32
    # conv by no more than 3x the direct bf16 conv's own drift, or 5e-2.
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(2, 20, 24, 16).astype(np.float32))
    k = torch.from_numpy((rs.randn(9, 9, 16, 24) / 9.0).astype(np.float32))
    nchw, oihw = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
    want = F.conv2d(nchw, oihw, padding=4).permute(0, 2, 3, 1)
    direct = F.conv2d(nchw.bfloat16(), oihw.bfloat16(), padding=4).permute(0, 2, 3, 1)
    got = tfc.fft_conv2d(x.bfloat16(), k, pallas_tail=pallas_tail)
    assert got.dtype == torch.bfloat16
    drift_direct = _rel(direct.float(), want)
    drift_fft = _rel(got.float(), want)
    assert drift_fft < max(3.0 * drift_direct, 5e-2), (drift_fft, drift_direct)


@pytest.mark.parametrize("row_pad_to", [1, 8])
def test_dft_tables_match_reference(row_pad_to):
    hw, kernel = (60, 90), (9, 9)
    want = jax_dft_consts(hw, kernel, real_cols=True, row_pad_to=row_pad_to)
    got = dft_tables(hw, kernel, torch.device("cpu"), row_pad_to=row_pad_to)
    assert got["gr_re"].shape[0] == (68 if row_pad_to == 1 else 72)
    for name, v in want.items():
        assert torch.equal(got[name], torch.from_numpy(v)), name
    # The cache keys hold the padding and the dtype.
    bf16 = dft_tables(hw, kernel, torch.device("cpu"), row_pad_to=row_pad_to, dtype=torch.bfloat16)
    assert bf16["ir_re"].dtype == torch.bfloat16 and got["ir_re"].dtype == torch.float32
    assert torch.equal(bf16["ir_re"], got["ir_re"].bfloat16())
    # The MRF pass's call (no padding, fp32) keeps its tables.
    plain = dft_tables(hw, kernel, torch.device("cpu"))
    unpadded = jax_dft_consts(hw, kernel, real_cols=True)
    assert all(torch.equal(plain[n], torch.from_numpy(v)) for n, v in unpadded.items())


def test_flops_model_and_argument_checks():
    assert tfc.fourier_conv_flops((60, 90), (9, 9), 128, 512) == jfc.fourier_conv_flops(
        (60, 90), (9, 9), 128, 512)
    x = torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError, match="odd"):
        tfc.fft_conv2d(x, torch.zeros(4, 4, 2, 3))
    with pytest.raises(ValueError, match="does not match"):
        tfc.fft_conv2d(x, torch.zeros(3, 3, 5, 3))
    with pytest.raises(NotImplementedError, match="precision"):
        tfc.fft_conv2d(x, torch.zeros(3, 3, 2, 3), precision="default")


def test_tail_body_is_a_rule_on_shapes():
    # The paper head (Ph 72, 60 output rows, 128 -> 512): the ring version
    # at serving batch 8 and, batch-tiled, at training batch 32.
    head = dict(ph=72, ci=128, co=512, kh=9, h=60)
    assert tfc.tail_body("kdft_resident", b=8, itemsize=2, **head) == "ring"
    assert tfc.tail_body("kdft", b=32, itemsize=2, **head) == "ring"
    assert tfc.tail_body("kdft", b=3, itemsize=2, **{**head, "kh": 5}) == "ring"
    # The ring's shared memory at the paper head: three stages, K_f, R, Gpack.
    assert tfc._ring_smem_bytes(72, 60) == (3 * (24 * 1040 + 8192) + 2 * 20736 + 144 * 528
                                            + 80 * 128)
    # A transform too tall for the ring keeps the register-staged version.
    assert tfc.tail_body("kdft_resident", b=8, itemsize=2, **{**head, "ph": 100}) == "regstaged"
    # The K_f-from-memory entry builds nothing: never the ring.
    assert tfc.tail_body("kf", b=8, itemsize=2, **head) == "regstaged"
    # f32, ragged channels and more than 8 images a block: the CUDA cores.
    assert tfc.tail_body("kdft_resident", b=8, itemsize=4, **head) == "cuda_cores"
    assert tfc.tail_body("kdft", b=8, itemsize=2, **{**head, "ci": 20}) == "cuda_cores"
    # The resident entry hands 9 to 16 images to the ring as two batch tiles.
    assert tfc.tail_body("kdft_resident", b=16, itemsize=2, **head) == "ring"
    assert tfc.tail_body("kdft_resident", b=16, itemsize=2, **{**head, "ph": 100}) == "cuda_cores"


def test_spectra_come_in_the_layouts_the_tails_read():
    x, k = map(torch.from_numpy, _inputs("9x9", seed=7))
    (xr, xi), (a_re, a_im), t = tfc.forward_spectra(x, k)
    for v in (xr, xi, a_re, a_im):
        assert v.is_contiguous()
    assert tuple(xr.shape) == (t["gc_re"].shape[0], t["gr_re"].shape[0], 4, 16)
    assert tuple(a_re.shape) == (t["gc_re"].shape[0], 9, 16, 32)
    # The same spectra as the reference's einsums (fp32).
    em = torch.einsum
    ar = em("fy,byxi->fbxi", t["fr_re"], x)
    ai = em("fy,byxi->fbxi", t["fr_im"], x)
    want = em("gx,fbxi->gfbi", t["fc_re"], ar) - em("gx,fbxi->gfbi", t["fc_im"], ai)
    assert _rel(xr, want) <= CONV_RTOL
    assert _rel(a_im, em("gx,yxio->gyio", t["gc_im"], k)) <= CONV_RTOL


@pytest.mark.parametrize("entry", ["kdft_resident", "kdft", "kf"])
def test_cpu_tails_are_the_plain_version_and_launch_nothing(entry):
    ops, _, tables, h = _tail_operands()
    t = {n: torch.from_numpy(v) for n, v in ops.items()}
    if entry == "kf":
        operands = (t["xr"], t["xi"], *tfc._kf_from_a(t["ar"], t["ai"], tables), tables)
        want = tfc.tail_kf_plain(*operands)
    else:
        operands = (t["xr"], t["xi"], t["ar"], t["ai"], tables)
        want = tfc.tail_kdft_plain(*operands)
    fn = getattr(tfc, f"tail_{entry}")
    before = fn.launches
    assert torch.equal(fn(*operands), want)
    assert fn.launches == before
