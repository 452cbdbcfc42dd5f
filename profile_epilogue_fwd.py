#!/usr/bin/env python3
"""The MRF epilogue forward on the card: the kernel (one log of a product
per output) against its first design (the logs added one by one), the
first design's sums in a tiled layout, and an empty launch of its grid.

    python3 profile_epilogue_fwd.py

Builds ``jointpose_torch/csrc/mrf_epilogue.cu`` alone, then for the
``flagship`` coarse grid (30x45, K = 9) at the serving batch (8) and the
training batch (32), in bf16 and f32: the kernel's error against the
plain version, its distance from the first design, both their distances
from the float64 sum, whether the tiled layout is bit-identical to the
first design, and the device time of each (median over CUDA-graph
replays, in turns: first design, kernel, tiled, tiled, kernel, first
design) with the byte bound beside them.  Ragged row counts, other
Kv x Ka, responses off a 16-byte boundary and non-finite responses
follow, checked only.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from chip_smoke import rel_err, time_ms
from jointpose_torch.perf import bound_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_epilogue_fwd: no CUDA device", file=sys.stderr)
        return 2
    from jointpose_torch.ops.mrf_epilogue import (
        fwd_cost, mrf_epilogue_fwd, mrf_epilogue_fwd_empty, mrf_epilogue_fwd_pervalue,
        mrf_epilogue_fwd_tiled, mrf_epilogue_plain,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    gen = torch.Generator().manual_seed(0)
    ok = True

    def operands(shape, dtype):
        resp = (torch.rand(shape, generator=gen) * 0.02).to("cuda", dtype)
        bias = (torch.rand(shape[-2:], generator=gen) * 1e-3).cuda()
        return resp, bias

    def plain64(resp, bias):
        return torch.log((resp.double() + bias.double()).clamp_min(1e-6)).sum(dim=-2)

    for batch in (8, 32):
        for dtype in (torch.bfloat16, torch.float32):
            resp, bias = operands((batch, 30, 45, 9, 9), dtype)
            got = mrf_epilogue_fwd(resp, bias)
            first = mrf_epilogue_fwd_pervalue(resp, bias)
            tiled = mrf_epilogue_fwd_tiled(resp, bias)
            want = mrf_epilogue_plain(resp, bias)
            torch.cuda.synchronize()
            err, same = rel_err(got, want), torch.equal(tiled, first)
            ok &= same and err[0] <= 1e-3
            bound = bound_ms(*fwd_cost(resp, bias))[0]
            t = [time_ms(lambda f=f: f(resp, bias)) for f in
                 (mrf_epilogue_fwd_pervalue, mrf_epilogue_fwd, mrf_epilogue_fwd_tiled,
                  mrf_epilogue_fwd_tiled, mrf_epilogue_fwd, mrf_epilogue_fwd_pervalue)]
            empty = time_ms(lambda: mrf_epilogue_fwd_empty(resp, bias))
            ref = plain64(resp, bias)
            print(f"batch {batch} {dtype}: rel err {err[0]:.3e} vs plain, max abs "
                  f"{rel_err(got, first)[1]:.3e} from the first design; from float64: kernel "
                  f"{rel_err(got, ref)[0]:.3e}, first design {rel_err(first, ref)[0]:.3e}, plain "
                  f"{rel_err(want, ref)[0]:.3e}; tiled is "
                  f"{'bit-identical to' if same else 'DIFFERENT from'} the first design; "
                  f"first design {t[0]:.6f} / {t[5]:.6f} ms, kernel {t[1]:.6f} / {t[4]:.6f} ms, "
                  f"tiled {t[2]:.6f} / {t[3]:.6f} ms, empty launch {empty:.6f} ms, byte bound "
                  f"{bound:.6f} ms, on {smi}")
    for shape in ((1, 7, 11, 9, 9), (3, 5, 7, 9, 9), (2, 13, 3, 4, 5), (1, 1, 3, 9, 9),
                  (2, 9, 10, 14, 14), (1, 3, 3, 40, 40)):
        for dtype in (torch.bfloat16, torch.float32):
            resp, bias = operands(shape, dtype)
            flat = torch.empty(resp.numel() + 1, dtype=dtype, device="cuda")
            off = flat[1:].view(shape).copy_(resp)  # starts off a 16-byte boundary
            got, first = mrf_epilogue_fwd(resp, bias), mrf_epilogue_fwd_pervalue(resp, bias)
            torch.cuda.synchronize()
            err = rel_err(got, mrf_epilogue_plain(resp, bias))
            same = all(torch.equal(mrf_epilogue_fwd_tiled(x, bias), first) for x in (resp, off))
            ok &= same and err[0] <= 1e-3 and torch.equal(mrf_epilogue_fwd(off, bias), got)
            print(f"shape {shape} {dtype}: rel err {err[0]:.3e} vs plain; tiled "
                  f"{'bit-identical to' if same else 'DIFFERENT from'} the first design "
                  f"(also off a 16-byte boundary)")
    # Non-finite and clamped responses come out as the first design gives them.
    resp, bias = operands((1, 4, 8, 9, 9), torch.float32)
    resp[0, 0, 0, 0, 0], resp[0, 0, 1, 2, 3] = float("inf"), float("nan")
    resp[0, 1, 1], resp[0, 2, 2, 4, 4] = -1.0, 3e38
    got, first = mrf_epilogue_fwd(resp, bias), mrf_epilogue_fwd_pervalue(resp, bias)
    special = torch.equal(torch.isfinite(got), torch.isfinite(first)) and bool(
        torch.isinf(got[0, 0, 0, 0])) and rel_err(
            torch.nan_to_num(got, posinf=0.0), torch.nan_to_num(first, posinf=0.0))[0] <= 1e-6
    ok &= special
    print(f"inf, NaN, negative and 3e38 responses: {'as' if special else 'NOT as'} the first design")
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
