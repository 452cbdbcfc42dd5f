#!/usr/bin/env python3
"""What each stage of the bf16 tensor-core head-conv tail costs on the card.

    python3 profile_tail_stages.py

Builds ``jointpose_torch/csrc/fft_conv_tail.cu`` as it is and copies with
one stage of ``tail_ring_kernel`` cut out each, and times them through the
resident entry (the served path) at the paper head (60×90, 9×9, 128→512,
batch 8, bf16, seeded operands): the difference from the whole kernel is
what that stage costs where it sits.  The cut copies compute wrong
results; only their times are read.  Each cut is a textual
replacement that must match the source exactly once, so an edit of the
kernel that moves an anchor fails here loudly; a variant may make
several cuts at once.  Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ANCHORS = {
    "whole kernel": None,
    "without the inverse row DFT": (
        "for (int pair = mh; pair < ir_rows / 32; pair += 2) {",
        "for (int pair = mh; pair < (h < 0 ? ir_rows / 32 : 0); pair += 2) {"),
    "without staging the inverse table": (
        "  for (int u = tid; u < ir_rows * chunks; u += kRingThreads) {",
        "  for (int u = tid; u < (h < 0 ? ir_rows * chunks : 0); u += kRingThreads) {"),
    "without the K_f build": (
        "    for (int n = 0; n < 4; ++n) {\n      uint32_t bf[4];\n      ldsm_x4_trans(bf, a_st",
        "    for (int n = 0; n < (ph < 0 ? 4 : 0); ++n) {\n      uint32_t bf[4];\n"
        "      ldsm_x4_trans(bf, a_st"),
    "without the pointwise product": (
        "      for (int np = 0; np < 2; ++np) {\n        uint32_t bf[4];\n"
        "        ldsm_x4_trans(bf, kf_base + np * 32);",
        "      for (int np = 0; np < (ph < 0 ? 2 : 0); ++np) {\n        uint32_t bf[4];\n"
        "        ldsm_x4_trans(bf, kf_base + np * 32);"),
    "without the barrier between build and pointwise": (
        "    __syncthreads();  // K_f of the step is complete",
        "    if (ph < 0) __syncthreads();"),
    "without the copies of later steps' operands": (
        "    if (step + kRingStages - 1 < nsteps) issue(step + kRingStages - 1);",
        "    if (step + kRingStages - 1 < nsteps && ph < 0) issue(step + kRingStages - 1);"),
    "without the copies of a'": (
        "      if (a_dst[k] >= 0) cp_async16(", "      if (a_dst[k] >= 0 && ph < 0) cp_async16("),
    "without the copies of X": (
        "    cp_async16(st + x_dst, valid", "    if (ph < 0) cp_async16(st + x_dst, valid"),
    "without the copies, the build, the pointwise product and the inverse (the walk's skeleton)": [
        ("      if (a_dst[k] >= 0) cp_async16(", "      if (a_dst[k] >= 0 && ph < 0) cp_async16("),
        ("    cp_async16(st + x_dst, valid", "    if (ph < 0) cp_async16(st + x_dst, valid"),
        ("    for (int n = 0; n < 4; ++n) {\n      uint32_t bf[4];\n      ldsm_x4_trans(bf, a_st",
         "    for (int n = 0; n < (ph < 0 ? 4 : 0); ++n) {\n      uint32_t bf[4];\n"
         "      ldsm_x4_trans(bf, a_st"),
        ("      for (int np = 0; np < 2; ++np) {\n        uint32_t bf[4];\n"
         "        ldsm_x4_trans(bf, kf_base + np * 32);",
         "      for (int np = 0; np < (ph < 0 ? 2 : 0); ++np) {\n        uint32_t bf[4];\n"
         "        ldsm_x4_trans(bf, kf_base + np * 32);"),
        ("for (int pair = mh; pair < ir_rows / 32; pair += 2) {",
         "for (int pair = mh; pair < (h < 0 ? ir_rows / 32 : 0); pair += 2) {"),
    ],
    "without the stores of R and of the output": (
        "    if (last) {\n      // R = conj(K_f) . X, rounded to bf16: rows f (re) and Ph + f (im).\n"
        "      const int f = f0 + warp;",
        "    if (last && ph < 0) {\n      const int f = f0 + warp;"),
}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
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
    entry, ints = "fft_conv_tail_kdft_resident", (g, ph, b, ci, co, kh, h, 2)
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, (name, cut) in enumerate(ANCHORS.items()):
            text = src
            for old, new in [] if cut is None else cut if isinstance(cut, list) else [cut]:
                if text.count(old) != 1:
                    raise SystemExit(f"anchor of '{name}' matches {text.count(old)} times")
                text = text.replace(old, new)
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
            fn = getattr(ctypes.CDLL(proc.args[proc.args.index("-o") + 1]), entry)
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                _build.check(fn(*pointers, *ints, stream), name)

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
            print(f"ring {name}: {ms:.4f} ms ({base - ms:+.4f} ms saved), on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
