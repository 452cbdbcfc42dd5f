"""SAME conv2d as Fourier-space matmuls: the paper's wide detector head
(counterpart of ``jointpose/ops/fft_conv.py``).

    X_f = F x                       forward 2-D DFT per input channel
    a   = column DFT of the kernel  (G, Kh, Ci, Co) complex
    K_f = gr · a                    row DFT of ``a``, Kh taps
    R   = Σ_ci conj(K_f) · X_f      complex matmul over Ci at every bin
    T   = ir · R                    inverse row DFT, SAME crop folded in
    y   = [ic_re; −ic_im] · T       inverse column DFT, real part

Transforms are DFTs as matmuls over the half column spectrum (G = Pw//2+1
bins).  The forward transforms, the kernel's column DFT and the last
inverse-column product are plain ``torch`` products.  The tail, from
``a`` (or ``K_f``) and ``X_f`` to ``T``, has three entries, one per TPU
kernel of the reference, each a wrapper that launches its kernel of
``csrc/fft_conv_tail.cu`` on CUDA tensors (or raises) and runs the plain
version beside it on CPU tensors:

- ``tail_kdft_resident``: K_f built in the kernel once per (g, Co tile)
  and reused over the whole batch, which sits in one block;
- ``tail_kdft``: the batch tiled over the grid, K_f rebuilt per tile;
- ``tail_kf``: K_f read from device memory.

``select_tail`` picks among them by a rule on the shapes alone.  K_f and
R never reach device memory on the first two.  Inside an entry the kernel
body is a rule on the shapes too (``tail_body``): the build form runs the
ring version where it fits, the register-staged tensor-core version or
the CUDA-core version elsewhere; ``tail_kdft_regstaged`` runs the
register-staged version on its own, as a timed entry.

Numerics: every contraction accumulates fp32; intermediates round to the
input's compute dtype (bf16 for bf16 inputs, else fp32).  The kernels and
their plain versions round K_f after its build, R before the inverse row
DFT and the output once.  On the card the caller keeps TF32 matmuls off
for fp32 parity.

Convention: cross-correlation (no kernel flip), SAME padding, NHWC input
and HWIO kernel at ``fft_conv2d``, as the reference; ``FFTConv`` takes
NCHW like the detector's ``Conv`` and shares its parameter layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

from jointpose_torch import _build, perf
from jointpose_torch.ops.mrf_fft import dft_tables

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fft_conv_tail_kdft_resident": ([_P] * 9 + [_I] * 8 + [_P], _I),
    "fft_conv_tail_kdft": ([_P] * 9 + [_I] * 9 + [_P], _I),
    "fft_conv_tail_kf": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "fft_conv_tail_kdft_regstaged": ([_P] * 9 + [_I] * 9 + [_P], _I),
}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
# Tile constants of csrc/fft_conv_tail.cu.
_CO_TILE = 32
_BATCH_TILE = 8
_CI_CHUNK = 8
_WARPS = 8
_ROWS_PER_PASS = 10
_KH_UNROLLS = (5, 9)  # kernel heights the in-kernel K_f build is compiled for
# Byte sizes of the tensor-core versions' shared memory (csrc/fft_conv_tail.cu).
_A_ROW = 16 * 32 * 2 + 16      # one tap row of the a' chunk
_K_PART = 16 * (16 * 80 + 16)  # K_re (or K_im) of one step: 16 row bins x 16 ci x 32 co
_RING_STAGE = 24 * _A_ROW + 16 * 16 * 32  # one stage of the ring: a' chunk and 16 X tiles
_RING_STAGES = 3

# Order in which ``select_tail`` tries the tails: the reference's
# (``_pallas_tail_kdft`` then ``_pallas_tail``).
TAIL_PREFERENCE = ("kdft_resident", "kdft", "kf")


def fourier_conv_flops(
    hw: tuple[int, int], kernel: tuple[int, int], cin: int, cout: int
) -> tuple[float, float]:
    """(direct, fourier) per-image FLOP counts for one SAME conv2d, the
    Fourier terms over the half column spectrum the implementation uses."""
    (h, w), (kh, kw) = hw, kernel
    ph, pw = h + kh - 1, w + kw - 1
    g = pw // 2 + 1
    direct = 2.0 * h * w * kh * kw * cin * cout
    fourier = (
        cin * (4.0 * ph * h * w + 8.0 * ph * w * g)
        + 8.0 * ph * g * cin * cout
        + cout * (8.0 * h * ph * g + 4.0 * h * g * w)
    )
    return direct, fourier


@functools.lru_cache(maxsize=16)
def _conv_tables(
    hw: tuple[int, int], kernel: tuple[int, int], device: torch.device, row_pad_to: int,
    dtype: torch.dtype,
) -> dict[str, torch.Tensor]:
    """``dft_tables`` in the compute dtype plus what this module adds:
    ``wcat`` (W, 2G) = [ic_re; −ic_im] for the single inverse-column product,
    and the kernels' operands, fp32 copies of the rounded tables: ``gr``
    (Ph, Kh, 2) and ``ir_t`` (Ph, H, 2), (re, im) interleaved.  In bf16 also
    the tensor-core version's tables, the complex transforms as real block
    matrices, zero-padded to its tile sizes: ``gpack`` (Ph↑16, 2, 32) with
    rows [gr_re, −gr_im] and [gr_im, gr_re] over the taps stacked (re at
    0..8, im at 9..17), and ``irpack`` (2H↑32, 2Ph↑16) = [[ir_re, −ir_im],
    [ir_im, ir_re]]; None in fp32."""
    t = dict(dft_tables(hw, kernel, device, row_pad_to, dtype))
    with torch.inference_mode(False):
        t["wcat"] = torch.cat([t["ic_re"], -t["ic_im"]], dim=1).contiguous()
        t["gr"] = torch.stack([t["gr_re"], t["gr_im"]], dim=-1).float().contiguous()
        t["ir_t"] = torch.stack([t["ir_re"].T, t["ir_im"].T], dim=-1).float().contiguous()
        t["gpack"] = t["irpack"] = None
        (h, ph), kh = t["ir_re"].shape, t["gr_re"].shape[1]
        if dtype == torch.bfloat16 and kh <= 9:
            gpack = torch.zeros(-(-ph // 16) * 16, 2, 32, dtype=dtype, device=device)
            gpack[:ph, 0, :kh], gpack[:ph, 0, 9:9 + kh] = t["gr_re"], -t["gr_im"]
            gpack[:ph, 1, :kh], gpack[:ph, 1, 9:9 + kh] = t["gr_im"], t["gr_re"]
            t["gpack"] = gpack
        if dtype == torch.bfloat16:
            irpack = torch.zeros(-(-2 * h // 32) * 32, -(-2 * ph // 16) * 16, dtype=dtype,
                                 device=device)
            irpack[:h, :ph], irpack[:h, ph:2 * ph] = t["ir_re"], -t["ir_im"]
            irpack[h:2 * h, :ph], irpack[h:2 * h, ph:2 * ph] = t["ir_im"], t["ir_re"]
            t["irpack"] = irpack
    return t


# --- the tails: plain versions ---------------------------------------------


def tail_kf_plain(xr, xi, kr, ki, t) -> torch.Tensor:
    """Plain version of the K_f-from-memory tail: pointwise complex product
    over Ci, then the complex inverse row DFT.  fp32 sums; R rounds to the
    compute dtype before the inverse, the output once at the end.

    xr, xi (G, Ph, B, Ci); kr, ki (G, Ph, Ci, Co) -> (H, 2, G, B, Co).
    """
    dt = xr.dtype
    xr, xi, kr, ki = xr.float(), xi.float(), kr.float(), ki.float()
    # R = conj(K_f) · X_f, bins as batch dimensions of both operands.
    rre = (torch.matmul(xr, kr) + torch.matmul(xi, ki)).to(dt).float()
    rim = (torch.matmul(xi, kr) - torch.matmul(xr, ki)).to(dt).float()
    irr, iri = t["ir_re"].float(), t["ir_im"].float()  # (H, Ph)
    tre = torch.einsum("yf,gfbo->ygbo", irr, rre) - torch.einsum("yf,gfbo->ygbo", iri, rim)
    tim = torch.einsum("yf,gfbo->ygbo", irr, rim) + torch.einsum("yf,gfbo->ygbo", iri, rre)
    return torch.stack([tre, tim], dim=1).to(dt)


def _kf_from_a(a_re, a_im, t) -> tuple[torch.Tensor, torch.Tensor]:
    """K_f = gr · a (complex row DFT), fp32 sums, rounded to the compute dtype."""
    dt = a_re.dtype
    grr, gri = t["gr_re"].float(), t["gr_im"].float()  # (Ph, Kh)
    a_re, a_im = a_re.float(), a_im.float()
    kr = torch.einsum("fy,gyio->gfio", grr, a_re) - torch.einsum("fy,gyio->gfio", gri, a_im)
    ki = torch.einsum("fy,gyio->gfio", grr, a_im) + torch.einsum("fy,gyio->gfio", gri, a_re)
    return kr.to(dt), ki.to(dt)


def tail_kdft_plain(xr, xi, a_re, a_im, t) -> torch.Tensor:
    """Plain version of both kdft tails: K_f from the column-DFT'd kernel
    ``a`` (G, Kh, Ci, Co), rounded to the compute dtype, then ``tail_kf_plain``."""
    kr, ki = _kf_from_a(a_re, a_im, t)
    return tail_kf_plain(xr, xi, kr, ki, t)


# --- the tails: shape rules -------------------------------------------------


def _tail_smem_bytes(ph: int, images: int, khp: int, itemsize: int) -> int:
    """Shared memory of one block of ``csrc/fft_conv_tail.cu``: the staged
    X chunk, the staged ``a`` chunk (``khp`` taps, 0 without a build), one
    slice of the inverse row table and the (Ph, images, 32) R tile."""
    return (
        2 * _WARPS * _CI_CHUNK * _BATCH_TILE * 8
        + 2 * khp * _CI_CHUNK * _CO_TILE * 4
        + ph * _ROWS_PER_PASS * 8
        + ph * images * _CO_TILE * 2 * itemsize
    )


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _ring_smem_bytes(ph: int, h: int) -> int:
    """Shared memory of one block of the ring version: the ring (after the
    walk, the inverse row table), the K_f of one step, the bf16 R tile and
    the build's Gpack table."""
    kp = _round_up(2 * ph, 16)
    region = max(_RING_STAGES * _RING_STAGE, _round_up(2 * h, 32) * (2 * kp + 16))
    return (region + 2 * _K_PART + kp * (_BATCH_TILE * _CO_TILE * 2 + 16)
            + _round_up(ph, 16) * 2 * 32 * 2)


def _mma_smem_bytes(ph: int, build: bool) -> int:
    """Shared memory of one block of the register-staged tensor-core version."""
    return (32 * _A_ROW if build else 0) + 2 * _K_PART + _round_up(2 * ph, 16) * (
        _BATCH_TILE * (_CO_TILE + 8) * 2 + 16)


def _entry_tile(name: str, ph: int, b: int, kh: int, itemsize: int) -> int:
    """Images per block the wrapper of tail ``name`` passes to its entry."""
    if name == "kdft_resident":
        return b
    return _batch_tile(ph, b, _kh_unroll(kh) if name == "kdft" else 0, itemsize)


def _ring_takes(name: str, ph: int, tb: int, ci: int, co: int, kh: int, h: int,
                itemsize: int) -> bool:
    """The ring version: the build form in bf16, at most 8 images a block."""
    return (name != "kf" and itemsize == 2 and ci % 16 == 0 and co % _CO_TILE == 0
            and tb <= _BATCH_TILE and kh <= 9 and _ring_smem_bytes(ph, h) <= _SMEM_LIMIT)


def _regstaged_takes(name: str, ph: int, tb: int, ci: int, co: int, kh: int,
                     itemsize: int) -> bool:
    """The register-staged tensor-core version (either form)."""
    build = name != "kf"
    return (itemsize == 2 and ci % 16 == 0 and co % _CO_TILE == 0 and tb <= _BATCH_TILE
            and (not build or kh <= 9) and _mma_smem_bytes(ph, build) <= _SMEM_LIMIT)


def tail_body(name: str, ph: int, b: int, ci: int, co: int, kh: int, h: int,
              itemsize: int) -> str:
    """Which kernel body the C entry of tail ``name`` runs on a geometry that
    ``tail_fits``: a rule on the shapes, the one the entry applies.

    - ``'ring'``: the build form (``kdft_resident``, ``kdft``) in bf16 with
      Ci % 16 == 0, Co % 32 == 0, kh <= 9, at most 8 images a block and a
      ring, K_f step and R tile that fit one block; the resident entry
      hands it 9 to 16 images as two batch tiles;
    - ``'regstaged'``: the register-staged tensor-core version, on bf16
      shapes the ring does not take (taller transforms) and in ``kf``;
    - ``'cuda_cores'``: f32, and bf16 shapes neither takes.
    """
    tb = _entry_tile(name, ph, b, kh, itemsize)
    ring_tb = min(tb, _BATCH_TILE) if name == "kdft_resident" else tb
    if _ring_takes(name, ph, ring_tb, ci, co, kh, h, itemsize):
        return "ring"
    if _regstaged_takes(name, ph, tb, ci, co, kh, itemsize):
        return "regstaged"
    return "cuda_cores"


def _kh_unroll(kh: int) -> int | None:
    return next((u for u in _KH_UNROLLS if kh <= u), None)


def _batch_tile(ph: int, b: int, khp: int, itemsize: int) -> int | None:
    """Largest batch tile of at most 8 images whose R tile fits a block."""
    for tb in (8, 4, 2, 1):
        if _tail_smem_bytes(ph, min(tb, b), khp, itemsize) <= _SMEM_LIMIT:
            return min(tb, b)
    return None


def tail_fits(name: str, ph: int, b: int, kh: int, itemsize: int) -> bool:
    """Whether tail ``name`` takes this geometry: a rule on the shapes.

    - ``kdft_resident``: the kernel height has a compiled build (kh <= 9),
      the whole batch fits one block's accumulators (b <= 16) and its
      (Ph, b, 32) R tile fits shared memory;
    - ``kdft``: kh <= 9 and some batch tile of 8, 4, 2 or 1 images fits;
    - ``kf``: some batch tile fits (any kernel height: K_f comes from memory).
    """
    khp = _kh_unroll(kh)
    if name == "kdft_resident":
        return (khp is not None and b <= 2 * _BATCH_TILE
                and _tail_smem_bytes(ph, b, khp, itemsize) <= _SMEM_LIMIT)
    if name == "kdft":
        return khp is not None and _batch_tile(ph, b, khp, itemsize) is not None
    if name == "kf":
        return _batch_tile(ph, b, 0, itemsize) is not None
    raise ValueError(f"unknown tail {name!r}")


def select_tail(ph: int, b: int, kh: int, itemsize: int) -> str:
    """First tail of ``TAIL_PREFERENCE`` that takes the geometry."""
    for name in TAIL_PREFERENCE:
        if tail_fits(name, ph, b, kh, itemsize):
            return name
    raise ValueError(
        f"fft_conv2d: no fused tail of {TAIL_PREFERENCE} takes Ph={ph}, batch={b}, "
        f"kernel height {kh}, itemsize {itemsize} (the (Ph, images, 32) tile exceeds "
        f"{_SMEM_LIMIT} B of shared memory); use pallas_tail=False"
    )


# --- the tails: wrappers ----------------------------------------------------


def tail_cost(xr, xi, kr, ki, t, built: bool) -> tuple[int, int]:
    """(bytes, operations) of a tail's function: x, the kernel operand (a
    where the tail builds K_f, K_f for the kf entry), the tables it reads
    and the (H, 2, G, B, Co) output once each; the K_f build where
    ``built``, the pointwise product over Ci and the inverse row DFT."""
    g, ph, b, ci = xr.shape
    kh, co = kr.shape[1], kr.shape[-1]
    h = t["ir_t"].shape[1]
    tables = (t["gr"], t["ir_t"]) if built else (t["ir_t"],)
    ops = 8 * ph * ci * co * g * b + 8 * h * ph * co * g * b
    if built:
        ops += 8 * ph * kh * ci * co * g
    return perf.nbytes(xr, xi, kr, ki, *tables) + h * 2 * g * b * co * xr.element_size(), ops


def _check_tail(what: str, xr, xi, kr, ki, k_rows: int, t) -> tuple[int, ...]:
    """Validate a tail's CUDA operands; return (G, Ph, B, Ci, Co, H)."""
    if xr.dim() != 4 or kr.dim() != 4:
        raise ValueError(f"{what}: x must be (G, Ph, B, Ci) and the kernel operand 4-D")
    g, ph, b, ci = xr.shape
    co = kr.shape[-1]
    h = t["ir_t"].shape[1]
    if xr.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: operands must be bf16 or f32, got {xr.dtype}")
    operands = {"xr": (xr, (g, ph, b, ci)), "xi": (xi, (g, ph, b, ci)),
                "kr": (kr, (g, k_rows, ci, co)), "ki": (ki, (g, k_rows, ci, co))}
    for name, (v, shape) in operands.items():
        if v.device != xr.device or v.device.type != "cuda":
            raise ValueError(f"{what}: {name} must lie on the CUDA device of xr")
        if v.dtype != xr.dtype or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be contiguous {xr.dtype} {shape}, got "
                f"{v.dtype} {tuple(v.shape)}"
            )
    if t["ir_t"].device != xr.device or tuple(t["ir_t"].shape) != (ph, h, 2):
        raise ValueError(f"{what}: the tables do not match Ph={ph} on {xr.device}")
    return g, ph, b, ci, co, h


def _run(entry: str, pointers: tuple, out: torch.Tensor, ints: tuple) -> torch.Tensor:
    """Call one C entry: tensor pointers, the output, the ints, the stream."""
    lib = _build.load("fft_conv_tail", _SIGNATURES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            *(None if v is None else v.data_ptr() for v in pointers), out.data_ptr(), *ints, stream)
    _build.check(err, entry)
    return out


def tail_kdft_resident(xr, xi, a_re, a_im, t) -> torch.Tensor:
    """Resident tail: K_f built in the kernel once per (g, Co tile), the
    whole batch in one block.  -> (H, 2, G, B, Co) in the operands' dtype."""
    if xr.device.type == "cpu":
        return tail_kdft_plain(xr, xi, a_re, a_im, t)
    kh = a_re.shape[1] if a_re.dim() == 4 else 0
    g, ph, b, ci, co, h = _check_tail("tail_kdft_resident", xr, xi, a_re, a_im, kh, t)
    if not tail_fits("kdft_resident", ph, b, kh, xr.element_size()):
        raise ValueError(
            f"tail_kdft_resident does not take Ph={ph}, batch={b}, kernel height {kh}, "
            f"{xr.dtype}: see tail_fits")
    out = torch.empty((h, 2, g, b, co), dtype=xr.dtype, device=xr.device)
    _run("fft_conv_tail_kdft_resident",
         (xr, xi, a_re, a_im, t["gr"], t["ir_t"], t["gpack"], t["irpack"]), out,
         (g, ph, b, ci, co, kh, h, xr.element_size()))
    tail_kdft_resident.launches += 1
    perf.count_kernel("fft_conv_tail_kdft_resident", tail_cost, xr, xi, a_re, a_im, t, True)
    return out


def tail_kdft(xr, xi, a_re, a_im, t) -> torch.Tensor:
    """Batch-tiled tail: K_f built in the kernel by every (g, Co tile,
    batch tile) block.  -> (H, 2, G, B, Co) in the operands' dtype."""
    if xr.device.type == "cpu":
        return tail_kdft_plain(xr, xi, a_re, a_im, t)
    kh = a_re.shape[1] if a_re.dim() == 4 else 0
    g, ph, b, ci, co, h = _check_tail("tail_kdft", xr, xi, a_re, a_im, kh, t)
    if not tail_fits("kdft", ph, b, kh, xr.element_size()):
        raise ValueError(
            f"tail_kdft does not take Ph={ph}, batch={b}, kernel height {kh}, "
            f"{xr.dtype}: see tail_fits")
    tb = _batch_tile(ph, b, _kh_unroll(kh), xr.element_size())
    out = torch.empty((h, 2, g, b, co), dtype=xr.dtype, device=xr.device)
    _run("fft_conv_tail_kdft", (xr, xi, a_re, a_im, t["gr"], t["ir_t"], t["gpack"], t["irpack"]), out,
         (g, ph, b, ci, co, kh, h, tb, xr.element_size()))
    tail_kdft.launches += 1
    perf.count_kernel("fft_conv_tail_kdft", tail_cost, xr, xi, a_re, a_im, t, True)
    return out


def tail_kf(xr, xi, kr, ki, t) -> torch.Tensor:
    """K_f-from-memory tail: kr, ki (G, Ph, Ci, Co) are read, not built.
    -> (H, 2, G, B, Co) in the operands' dtype."""
    if xr.device.type == "cpu":
        return tail_kf_plain(xr, xi, kr, ki, t)
    g, ph, b, ci, co, h = _check_tail("tail_kf", xr, xi, kr, ki, xr.shape[1], t)
    if not tail_fits("kf", ph, b, 0, xr.element_size()):
        raise ValueError(f"tail_kf does not take Ph={ph}, batch={b}, {xr.dtype}: see tail_fits")
    tb = _batch_tile(ph, b, 0, xr.element_size())
    out = torch.empty((h, 2, g, b, co), dtype=xr.dtype, device=xr.device)
    _run("fft_conv_tail_kf", (xr, xi, kr, ki, t["ir_t"], t["irpack"]), out,
         (g, ph, b, ci, co, h, tb, xr.element_size()))
    tail_kf.launches += 1
    perf.count_kernel("fft_conv_tail_kf", tail_cost, xr, xi, kr, ki, t, False)
    return out


def tail_kdft_regstaged(xr, xi, a_re, a_im, t) -> torch.Tensor:
    """The build form's register-staged tensor-core version, which the ring
    version replaced on the rows 6 and 7 path, kept as a timed entry: the
    ``kdft`` entry's batch tiles, bf16 shapes that version takes only."""
    if xr.device.type == "cpu":
        return tail_kdft_plain(xr, xi, a_re, a_im, t)
    kh = a_re.shape[1] if a_re.dim() == 4 else 0
    g, ph, b, ci, co, h = _check_tail("tail_kdft_regstaged", xr, xi, a_re, a_im, kh, t)
    itemsize = xr.element_size()
    if not (tail_fits("kdft", ph, b, kh, itemsize) and _regstaged_takes(
            "kdft", ph, _entry_tile("kdft", ph, b, kh, itemsize), ci, co, kh, itemsize)):
        raise ValueError(f"tail_kdft_regstaged does not take Ph={ph}, batch={b}, Ci={ci}, "
                         f"Co={co}, kernel height {kh}, {xr.dtype}")
    tb = _entry_tile("kdft", ph, b, kh, itemsize)
    out = torch.empty((h, 2, g, b, co), dtype=xr.dtype, device=xr.device)
    _run("fft_conv_tail_kdft_regstaged",
         (xr, xi, a_re, a_im, t["gr"], t["ir_t"], t["gpack"], t["irpack"]), out,
         (g, ph, b, ci, co, kh, h, tb, xr.element_size()))
    tail_kdft_regstaged.launches += 1
    return out


tail_kdft_resident.launches = 0
tail_kdft.launches = 0
tail_kf.launches = 0
tail_kdft_regstaged.launches = 0


# --- the conv ---------------------------------------------------------------


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def forward_spectra(x: torch.Tensor, kernel: torch.Tensor, pallas_tail: bool = True):
    """The front half: the input's 2-D DFT and the kernel's column DFT.

    Returns ((xr, xi) (G, Ph, B, Ci), (a_re, a_im) (G, Kh, Ci, Co), tables),
    all in the compute dtype.  Each product's output is in that dtype (fp32
    sums inside a product, one rounding after it), as the reference's
    einsums are.
    """
    b, h, w, cin = x.shape
    kh, kw, cin2, cout = kernel.shape
    if cin2 != cin:
        raise ValueError(f"x {tuple(x.shape)} does not match kernel {tuple(kernel.shape)}")
    # The SAME-crop operators assume the centering of an odd kernel.
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"fft_conv2d takes odd kernels only, got {kh}x{kw}")
    dt = _compute_dtype(x)
    # The fused tails' row transform is padded to a multiple of 8 like the
    # reference's (still exact), so both sides use the same tables.
    t = _conv_tables((h, w), (kh, kw), x.device, 8 if pallas_tail else 1, dt)
    return input_spectrum(x.to(dt), t), kernel_column_dft(kernel.to(dt), t), t


def input_spectrum(xc: torch.Tensor, t) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward DFT of the input (b, y, x, i), bins leading: rows, then
    columns -> (xr, xi) (G, Ph, B, Ci), contiguous, the layout the tails
    read.  The input is laid out once as (x, y, b·i), so that the row
    transform gives (x, f, b·i) and the column transform, one product over
    x, gives (g, f·b·i) with no copy after it."""
    b, _, w, ci = xc.shape
    rows = xc.permute(2, 1, 0, 3).reshape(w, -1, b * ci)
    ar = torch.matmul(t["fr_re"], rows).reshape(w, -1)  # (x, f·b·i)
    ai = torch.matmul(t["fr_im"], rows).reshape(w, -1)
    xr = torch.matmul(t["fc_re"], ar) - torch.matmul(t["fc_im"], ai)
    xi = torch.matmul(t["fc_im"], ar) + torch.matmul(t["fc_re"], ai)
    shape = (xr.shape[0], t["fr_re"].shape[0], b, ci)
    return xr.view(shape), xi.view(shape)


def kernel_column_dft(kc: torch.Tensor, t) -> tuple[torch.Tensor, torch.Tensor]:
    """Column DFT of the kernel (y, x, i, o): ``a`` is (G, Kh, Ci, Co)
    complex, contiguous, Kh/Ph the size of the full spectrum K_f.  The
    kernel is laid out once as (x, y·i·o), so that one product over x gives
    (g, y·i·o) with no copy after it."""
    kh, kw, ci, co = kc.shape
    cols = kc.permute(1, 0, 2, 3).reshape(kw, -1)
    shape = (t["gc_re"].shape[0], kh, ci, co)
    return (torch.matmul(t["gc_re"], cols).view(shape),
            torch.matmul(t["gc_im"], cols).view(shape))


def inverse_columns(tcat: torch.Tensor, t) -> torch.Tensor:
    """Inverse column DFT of (y, 2g, b, o), real part only: Re(T)·ic_re −
    Im(T)·ic_im as one product against [ic_re; −ic_im] -> (b, y, x, o)."""
    return torch.einsum("xG,yGbo->xybo", t["wcat"], tcat).permute(2, 1, 0, 3)


def fused_tail(xr, xi, a_re, a_im, t) -> torch.Tensor:
    """The tail through the first entry of ``TAIL_PREFERENCE`` that takes
    the geometry -> (H, 2, G, B, Co)."""
    ph, b, kh = xr.shape[1], xr.shape[2], a_re.shape[1]
    name = select_tail(ph, b, kh, xr.element_size())
    # input_spectrum and kernel_column_dft emit the layouts the kernels read.
    if name == "kdft_resident":
        return tail_kdft_resident(xr, xi, a_re, a_im, t)
    if name == "kdft":
        return tail_kdft(xr, xi, a_re, a_im, t)
    # K_f finished outside the kernel, as the reference's fallback does.
    kr, ki = _kf_from_a(a_re, a_im, t)
    return tail_kf(xr, xi, kr.contiguous(), ki.contiguous(), t)


def _fft_conv2d_impl(x: torch.Tensor, kernel: torch.Tensor, pallas_tail: bool) -> torch.Tensor:
    """Shared body; see ``fft_conv2d`` for the contract."""
    (xr, xi), (a_re, a_im), t = forward_spectra(x, kernel, pallas_tail)
    em = torch.einsum
    if pallas_tail:
        tail = fused_tail(xr, xi, a_re, a_im, t)
        # (y, 2, g, b, o) -> (y, 2g, b, o): a view.
        tcat = tail.reshape(tail.shape[0], -1, *tail.shape[3:])
    else:
        kr = em("fy,gyio->gfio", t["gr_re"], a_re) - em("fy,gyio->gfio", t["gr_im"], a_im)
        ki = em("fy,gyio->gfio", t["gr_re"], a_im) + em("fy,gyio->gfio", t["gr_im"], a_re)
        # R = conj(K_f) · X_f, summed over Ci at every (g, f) bin.
        rr = em("gfbi,gfio->gfbo", xr, kr) + em("gfbi,gfio->gfbo", xi, ki)
        ri = em("gfbi,gfio->gfbo", xi, kr) - em("gfbi,gfio->gfbo", xr, ki)
        # Inverse row DFT (complex; the SAME crop folded into the operator).
        tr = em("yf,gfbo->ygbo", t["ir_re"], rr) - em("yf,gfbo->ygbo", t["ir_im"], ri)
        ti = em("yf,gfbo->ygbo", t["ir_re"], ri) + em("yf,gfbo->ygbo", t["ir_im"], rr)
        tcat = torch.cat([tr, ti], dim=1)  # (y, 2g, b, o)
    return inverse_columns(tcat, t)  # (b, y, x, o) in the compute dtype


class _FusedConv(torch.autograd.Function):
    """Forward through a fused tail; backward by recomputing the plain path
    under autograd and taking its VJP, as the reference's custom VJP does:
    both compute the same function, and only x and the kernel are kept."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return _fft_conv2d_impl(x, kernel, pallas_tail=True)

    @staticmethod
    def backward(ctx, g):
        inputs = [v.detach().requires_grad_(need)
                  for v, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = _fft_conv2d_impl(*inputs, pallas_tail=False)
        wanted = [v for v in inputs if v.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)) if wanted else ())
        return tuple(next(grads) if v.requires_grad else None for v in inputs)


def fft_conv2d(
    x: torch.Tensor, kernel: torch.Tensor, precision=None, pallas_tail: bool = True
) -> torch.Tensor:
    """SAME cross-correlation conv via DFT matmuls.

    Args:
      x: (B, H, W, Ci), bf16 or fp32: intermediates round to that dtype,
        with fp32 sums inside every contraction.
      kernel: (kh, kw, Ci, Co), odd kh and kw, any float dtype.
      precision: kept for the reference's signature; ``None`` or
        ``"highest"``.  fp32 products run in full fp32 (keep TF32 off).
      pallas_tail: run the tail (K_f build, pointwise product, inverse row
        DFT) through a fused kernel chosen by ``select_tail``, so K_f and
        the R spectrum never reach device memory; ``False`` is the plain
        route.  Gradients of the fused route recompute the plain one.
    Returns:
      (B, H, W, Co) in the compute dtype.
    """
    if precision not in (None, "highest"):
        raise NotImplementedError(f"fft_conv2d: precision {precision!r} is not ported")
    if pallas_tail:
        return _FusedConv.apply(x, kernel)
    return _fft_conv2d_impl(x, kernel, pallas_tail=False)


class FFTConv(nn.Module):
    """Drop-in for the detector's k×k SAME ``Conv``: the same ``weight``
    (Co, Ci, kh, kw) and ``bias`` (Co,), fp32, so one ``state_dict`` serves
    both; NCHW in and out, run in the input's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fft_conv2d(x.permute(0, 2, 3, 1), self.weight.permute(2, 3, 1, 0))
        y = y + self.bias.to(y.dtype)
        return y.permute(0, 3, 1, 2).to(x.dtype)
