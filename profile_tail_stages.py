#!/usr/bin/env python3
"""What each stage of the bf16 tensor-core head-conv tail costs on the card.

    python3 profile_tail_stages.py

Builds ``jointpose_torch/csrc/fft_conv_tail.cu`` as it is and five copies
with one stage of ``tail_mma_kernel`` cut out each (the inverse row DFT, the
K_f build, the pointwise product, the stores of the staged operands, their
loads from device memory), and times the resident entry of each at the
paper head (60×90, 9×9, 128→512, batch 8, bf16, seeded operands): the
difference from the whole kernel is what that stage costs where it sits.
The cut copies compute wrong results; only their times are read.  Each cut
is a textual replacement that must match the source exactly once, so an
edit of the kernel that moves an anchor fails here loudly.  Needs a CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ANCHORS = {
    "whole kernel": None,
    "without the inverse row DFT": (
        "const int m_tiles = round_up(2 * h, 32) / 16;",
        "const int m_tiles = (h < 0) ? 2 : 0;"),
    "without the K_f build": (
        "    if constexpr (BUILD) {\n      // Build: this warp's two input channels",
        "    if (BUILD && ph < 0) {\n      // Build: this warp's two input channels"),
    "without the pointwise product": (
        "#pragma unroll\n    for (int j = 0; j < 2; ++j) {\n      const int fl = warp + kWarps * j;\n"
        "      // lane -> matrix",
        "#pragma unroll\n    for (int j = 0; j < (ph < 0 ? 2 : 0); ++j) {\n"
        "      const int fl = warp + kWarps * j;\n      // lane -> matrix"),
    "without the stores of staged operands": ("    commit();\n", "    if (ph < 0) commit();\n"),
    "without the loads of the next step's operands": (
        "    if (step + 1 < nsteps) fetch(step + 1);",
        "    if (step + 1 < nsteps && ph < 0) fetch(step + 1);"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_tail_stages: no CUDA device", file=sys.stderr)
        return 2
    from jointpose_torch import _build
    from jointpose_torch.ops import fft_conv as fc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    src = (_build.CSRC / "fft_conv_tail.cu").read_text()
    g, ph, b, ci, co, kh, h = 50, 72, 8, 128, 512, 9, 60
    gen = torch.Generator().manual_seed(0)
    dt = torch.bfloat16
    t = fc._conv_tables((h, 90), (kh, kh), torch.device("cuda"), 8, dt)
    xr, xi = (torch.randn(g, ph, b, ci, generator=gen).cuda().to(dt) for _ in range(2))
    ar, ai = ((torch.randn(g, kh, ci, co, generator=gen) / 30).cuda().to(dt) for _ in range(2))
    out = torch.empty(h, 2, g, b, co, dtype=dt, device="cuda")
    pointers = [v.data_ptr() for v in (xr, xi, ar, ai, t["gr"], t["ir_t"], t["gpack"], t["irpack"], out)]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, cut) in enumerate(ANCHORS.items()):
            text = src
            if cut is not None:
                if src.count(cut[0]) != 1:
                    raise SystemExit(f"anchor of '{name}' matches {src.count(cut[0])} times")
                text = src.replace(*cut)
            path = Path(tmp) / f"v{i}.cu"
            path.write_text(text)
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        base = None
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for '{name}':\n{log}")
            fn = ctypes.CDLL(proc.args[proc.args.index("-o") + 1]).fft_conv_tail_kdft_resident
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                _build.check(fn(*pointers, g, ph, b, ci, co, kh, h, 2, stream), name)

            for _ in range(3):
                run()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(20):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 20
            base = ms if base is None else base
            print(f"{name}: {ms:.4f} ms ({base - ms:+.4f} ms saved), on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
