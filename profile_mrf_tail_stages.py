#!/usr/bin/env python3
"""What each stage of the fused Fourier MRF tail costs on the card.

    python3 profile_mrf_tail_stages.py [--source PATH] [--batch 8]
    python3 profile_mrf_tail_stages.py --wgmma [--batch 8]

Builds ``jointpose_torch/csrc/mrf_fft_tail.cu`` (or ``--source``: any
version of that file with the same C entry) as it is and copies with one
stage of the kernel cut out each (forming R and its loads, the row
transform, the column transform, the log epilogue), and times each at the
``joint`` geometry (60×90 heatmaps, 45×67 window: Ph=104, G=79; Kv=Ka=9;
seeded operands): the difference from the whole kernel is what that stage
costs where it sits.  The cut copies compute wrong results; only their
times are read.  Each cut is one or more textual replacements that must
each match the source exactly once, so an edit of the kernel that moves an anchor fails
here loudly.  Three anchor sets: the ``mma.sync`` tensor-core kernel, the
earlier CUDA-core kernel, so that a checkout of an older commit's source
can be profiled by the same script, and the single pass's ``wgmma``
kernel (``--wgmma``: ``csrc/mrf_fft_tail_wgmma.cu``, or a ``--source``
holding ``wgmma.mma_async``), whose set also has variants that change a
knob instead of cutting a stage.  An ``mma.sync`` source whose entry
takes the number of passes (an older commit's) is timed at 3xTF32.  Each
build's registers and spills (``ptxas -v``) are printed beside its time.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

TENSOR_CORE_ANCHORS = {
    "whole kernel": None,
    "without forming R and its loads": (
        "const int nbatch = (n_el + kLoads * kProducers - 1) / (kLoads * kProducers);",
        "const int nbatch = p.ph < 0;"),
    "without the row transform": (
        "for (int ks = 0; ks < nks; ++ks) {",
        "for (int ks = 0; ks < (p.ph < 0 ? nks : 0); ++ks) {"),
    "without the column transform": (
        "      for (int j = 0; j < kNJ; ++j) {\n        BFrag",
        "      for (int j = 0; j < (p.ph < 0 ? kNJ : 0); ++j) {\n        BFrag"),
    "without the log epilogue": (
        "ls[m][e] += logf(fmaxf(o[m][e] + bv, p.eps));",
        "ls[m][e] += o[m][e] + bv;"),
    # Plain TF32: a third of the mma, all of the loads and splits.  The
    # difference from the whole kernel is what two thirds of the mma cost.
    "with the hi*hi term only": [
        ("  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);\n", ""),
        ("  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);\n", "")],
}
CUDA_CORE_ANCHORS = {
    "whole kernel": None,
    "without forming R and its loads": (
        "for (int i = tid; i < plane; i += kThreads) {\n      const float p_r",
        "for (int i = tid; i < (ph < 0 ? plane : 0); i += kThreads) {\n      const float p_r"),
    "without the column transform (its stage 2)": (
        "for (int i0 = 0; i0 < nfi; i0 += kRB) {",
        "for (int i0 = 0; i0 < (ph < 0 ? nfi : 0); i0 += kRB) {"),
    "without the row transform (its stage 3)": (
        "for (int f = 0; f < ph; ++f) {\n      const float2 u",
        "for (int f = 0; f < (w < 0 ? ph : 0); ++f) {\n      const float2 u"),
    "without the log epilogue": (
        "acc[j] += logf(fmaxf(o[j] + bv, eps));", "acc[j] += o[j] + bv;"),
}


WGMMA_ANCHORS = {
    "whole kernel": None,
    "without forming R and its loads": (
        "const int nbatch = (items + kFeeders - 1) / kFeeders;",
        "const int nbatch = p.ph < 0;"),
    "without the row products": (
        "for (int ks = 0; ks < p.php / 8; ++ks) {",
        "for (int ks = 0; ks < (p.ph < 0 ? p.php / 8 : 0); ++ks) {"),
    "without the column products": (
        "  const int jj0 = c * p.gc / 8;\n",
        "  const int jj0 = c * p.gc / 8;\n  if (p.ph >= 0) {\n    wgmma_commit();\n"
        "    return;\n  }\n"),
    "without the log epilogue": (
        "ls[i] += __logf(fmaxf(o[i] + bv, p.eps));", "ls[i] += o[i] + bv;"),
    "with empty runs: launch, tables, hand-over (knob)": (
        "const int u1 = worker < p.workers ? run_start(worker + 1, p.units, p.workers) : u0;",
        "const int u1 = u0;"),
    "with logf in place of __logf (knob)": (
        "ls[i] += __logf(fmaxf(o[i] + bv, p.eps));", "ls[i] += logf(fmaxf(o[i] + bv, p.eps));"),
    "without the register hand-over (knob)": [
        ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));\n', ""),
        ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n', "")],
}


def _ptxas_summary(log: str) -> str:
    """The main kernel's registers and spills from ``ptxas -v``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "combine" not in line:
            props = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "registers" in x]
            return "; ".join(props)
    return "no ptxas summary"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", type=Path, default=None,
                        help="a version of mrf_fft_tail.cu (default: the package's)")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--wgmma", action="store_true",
                        help="the single pass's wgmma kernel (csrc/mrf_fft_tail_wgmma.cu)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_mrf_tail_stages: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import time_ms
    from jointpose_torch import _build
    from jointpose_torch.ops.mrf_fft import dft_tables

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kernel_file = "mrf_fft_tail_wgmma.cu" if args.wgmma else "mrf_fft_tail.cu"
    path = args.source or _build.CSRC / kernel_file
    src = path.read_text()
    wgmma = "wgmma.mma_async" in src
    anchors = (WGMMA_ANCHORS if wgmma else TENSOR_CORE_ANCHORS if "mma.sync" in src
               else CUDA_CORE_ANCHORS)
    takes_passes = "int passes" in src  # an older entry's argument: 3 for 3xTF32
    b, k, (h, w), window = args.batch, 9, (60, 90), (45, 67)
    t = dft_tables((h, w), window, torch.device("cuda"))
    ph, g = t["ir_re"].shape[1], t["ict_re"].shape[0]
    gen = torch.Generator().manual_seed(0)
    pf_re, pf_im = (torch.randn(b, k, ph, g, generator=gen).cuda() for _ in range(2))
    kf_re, kf_im = (torch.randn(k, k, ph, g, generator=gen).cuda() for _ in range(2))
    bias = torch.rand(k, k, generator=gen).cuda()
    out = torch.empty(b, k, h, w, device="cuda")
    if wgmma:  # spectra in rows of 8 bins, the table images, a scratch of as many planes
        # as any dealing needs
        stride = -(-g // 8) * 8
        pf_re, pf_im, kf_re, kf_im = (torch.nn.functional.pad(x, (0, stride - g))
                                      for x in (pf_re, pf_im, kf_re, kf_im))
        operands = [pf_re, pf_im, kf_re, kf_im, t["ir_img"], t["ic_img"], bias, out,
                    torch.empty(k - 1, *out.shape, device="cuda")]
        entry, kind = "mrf_tail_wgmma", "wgmma"
    else:
        operands = [pf_re, pf_im, kf_re, kf_im, t["ir"], t["ict_re"], t["ict_im"], bias, out]
        if anchors is TENSOR_CORE_ANCHORS:  # its entry takes a scratch for partial log-sums
            operands.append(torch.empty(2, *out.shape, device="cuda"))
        entry = "mrf_fft_tail"
        kind = "mma.sync" if anchors is TENSOR_CORE_ANCHORS else "CUDA-core"
    pointers = [v.data_ptr() for v in operands]
    passes = 1 if wgmma else 3
    print(f"{path}: {kind} kernel, {passes} pass(es), B={b}, Kv=Ka={k}, H={h}, W={w}, Ph={ph}, "
          f"G={g}")
    extra = [3] if takes_passes else []
    geometry = [b, k, k, ph, g, stride, h, w] if wgmma else [b, k, k, ph, g, h, w]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, cut) in enumerate(anchors.items()):
            text = src
            for old, new in ([] if cut is None else cut if isinstance(cut, list) else [cut]):
                if src.count(old) != 1:
                    raise SystemExit(f"anchor of '{name}' matches {src.count(old)} times")
                text = text.replace(old, new)
            cu = Path(tmp) / f"v{i}.cu"
            cu.write_text(text)
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        base = None
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for '{name}':\n{log}")
            fn = getattr(ctypes.CDLL(proc.args[proc.args.index("-o") + 1]), entry)
            fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(geometry)
                           + [ctypes.c_float] + [ctypes.c_int] * len(extra) + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def run():
                stream = torch.cuda.current_stream().cuda_stream
                _build.check(fn(*pointers, *geometry, 1e-6, *extra, stream), name)

            ms = time_ms(run, runs=30)  # median of 30 CUDA-graph replays of 10 calls
            base = ms if base is None else base
            print(f"{name}: {ms:.4f} ms ({base - ms:+.4f} ms saved; {_ptxas_summary(log)}), "
                  f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
