#!/usr/bin/env python3
"""Where a served request's time goes on the card, by kernel.

    python3 profile_serve.py [--preset joint|flagship_pallas] [--batch 8] [--requests 4]

Serves ``--requests`` requests of ``--batch`` uint8 images through the
port's predictor (seeded random weights, as ``chip_smoke.py`` does) under
``torch.profiler`` and prints, per preset: the wall time per request,
the device's busy time (the sum of kernel times) and its idle share, and
the kernels by total device time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

PRESETS = ("joint", "flagship_pallas")


def _config(preset: str):
    from jointpose_torch import get_config

    if preset == "joint":
        cfg = get_config("joint")
        return cfg.replace(detector=dataclasses.replace(cfg.detector, head_conv_impl="direct"))
    cfg = get_config("flagship")
    return cfg.replace(mrf=dataclasses.replace(cfg.mrf, impl="pallas"))


def profile(preset: str, batch: int, requests: int, top: int = 12) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from jointpose_torch.predict import build_predictor, init_state_dict

    cfg = _config(preset)
    predict = build_predictor(cfg, init_state_dict(cfg, torch.Generator().manual_seed(0)))
    h, w = cfg.data.image_hw
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (requests, batch, h, w, 3), dtype=np.uint8))
    images = images.cuda()
    for r in range(2):
        predict(images[r % requests])
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(requests):
            predict(images[r])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / requests
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(evt.name, [0.0, 0])
            kernels[evt.name][0] += evt.time_range.elapsed_us() / 1e3 / requests
            kernels[evt.name][1] += 1
    busy_ms = sum(t for t, _ in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "preset": preset, "batch": batch, "requests": requests,
        "wall_ms_per_request": wall_ms, "device_busy_ms_per_request": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top_kernels": [
            {"name": n[:90], "ms_per_request": t, "launches_per_request": c / requests}
            for n, (t, c) in ranked
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, action="append")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from jointpose_torch import _build

    _build.build(_build.kernel_names())
    for preset in args.preset or PRESETS:
        res = profile(preset, args.batch, args.requests)
        print(f"{preset}: {res['wall_ms_per_request']:.3f} ms/request wall, device busy "
              f"{res['device_busy_ms_per_request']:.3f} ms, idle share "
              f"{res['device_idle_share']:.3f}")
        for k in res["top_kernels"]:
            print(f"  {k['ms_per_request']:8.4f} ms  x{k['launches_per_request']:g}  {k['name']}")
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
