#!/usr/bin/env python3
"""Where a served request's or a training step's time goes on the card, by kernel.

    python3 profile_serve.py [--preset joint|joint_default|joint_fft|flagship|flagship_pallas]
                             [--batch 8] [--requests 4]
    python3 profile_serve.py --train [--preset flagship|flagship_pallas] [--batch 32] [--requests 4]
    python3 profile_serve.py --head-stages [--batch 8]

Serves ``--requests`` requests of ``--batch`` uint8 images through the
port's predictor (seeded random weights, as ``chip_smoke.py`` does) under
``torch.profiler``; with ``--train`` it takes ``--requests`` joint-stage
training steps instead (of ``flagship_pallas`` unless ``--preset`` names
another), after two warm-up steps.  Prints, per preset: the wall time per request or
step, the device's busy time (the sum of kernel times) and its idle
share, the kernels by total device time, and the PyTorch ops that
launched them by their input shapes (which convolution a kernel belongs
to).  ``joint_fft`` is ``joint``
with ``head_conv_impl='fft'``, ``joint_default`` is ``joint`` at MRF
precision 'default' (the serving default: the single-pass Fourier tail),
``flagship`` is the preset as it stands at 'default' (MRF 'auto' -> 'xla',
the direct grouped conv; bf16), ``flagship_pallas`` the preset with
``mrf.impl='pallas'`` (the fused epilogue).  With ``--head-stages`` it times the stages
of the Fourier head conv at the paper head instead (bf16): the input's
forward transforms, the kernel's column DFT, the fused tail and the
inverse column product, beside cuDNN's direct conv.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import numpy as np
import torch

PRESETS = ("joint", "joint_default", "joint_fft", "flagship", "flagship_pallas")
# The port's own kernels (jointpose_torch/csrc/), listed whatever their rank.
PORT_KERNELS = ("mrf_epilogue_fwd_kernel", "mrf_epilogue_bwd_kernel",
                "mrf_epilogue_bias_reduce_kernel", "mrf_fft_tail_kernel",
                "mrf_fft_tail_combine_kernel", "mrf_tail_wgmma_kernel",
                "mrf_tail_wgmma_combine_kernel", "shear_warp_fused_kernel",
                "tail_kernel", "tail_mma_kernel", "tail_ring_kernel")


def _config(preset: str):
    from jointpose_torch import get_config
    from jointpose_torch.configs import with_mrf_precision

    if preset in ("joint", "joint_default", "joint_fft"):
        cfg = get_config("joint")
        head = "fft" if preset == "joint_fft" else "direct"
        cfg = cfg.replace(detector=dataclasses.replace(cfg.detector, head_conv_impl=head))
        return with_mrf_precision(cfg, "default" if preset == "joint_default" else "high")
    cfg = get_config("flagship")
    if preset == "flagship":
        return with_mrf_precision(cfg, "default")
    return cfg.replace(mrf=dataclasses.replace(cfg.mrf, impl="pallas"))


def _serve_unit(preset: str, batch: int, n: int):
    """One request per call: ``batch`` seeded uint8 images."""
    from jointpose_torch.predict import build_predictor, init_state_dict

    cfg = _config(preset)
    predict = build_predictor(cfg, init_state_dict(cfg, torch.Generator().manual_seed(0)))
    h, w = cfg.data.image_hw
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (n, batch, h, w, 3), dtype=np.uint8)).cuda()
    return lambda r: predict(images[r % n])


def _train_unit(preset: str, batch: int, n: int):
    """One joint-stage training step per call on seeded uint8 batches."""
    from jointpose_torch.train import create_state, make_train_step

    cfg = _config(preset)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch))
    state = create_state(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, "joint")
    h, w = cfg.data.image_hw
    k = cfg.num_joints
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (n, batch, h, w, 3), dtype=np.uint8)).cuda()
    joints = torch.from_numpy(
        rng.uniform([1.0, 1.0], [w - 2.0, h - 2.0], (n, batch, k, 2)).astype(np.float32)).cuda()
    visible = torch.ones(batch, k, device="cuda")
    return lambda r: step(state, {"image": images[r % n], "joints": joints[r % n],
                                  "visible": visible})


def profile(run, units: int, top: int = 12) -> dict:
    """Profile ``units`` calls of ``run`` after two warm-up calls; the
    kernels, copies and memsets by name from ``devtime.parse_trace``, and
    the ops by the device time they launched, with their input shapes."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    from jointpose_torch import devtime

    for r in range(2):
        run(r)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        t0 = time.perf_counter()
        for r in range(units):
            with record_function(f"unit#{r}"):
                run(r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / units
    with tempfile.TemporaryDirectory() as trace_dir:
        prof.export_chrome_trace(devtime.trace_path(trace_dir))
        timing = devtime.parse_trace(trace_dir, "unit")
    if timing is None:
        raise SystemExit("profile_serve: the trace holds no device op")
    kernels = {op.name: (op.duration_s * 1e3 / units, op.count) for op in timing.ops}
    busy_ms = sum(t for t, _ in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])

    def rows(items):
        return [{"name": n[:90], "ms_per_unit": t, "launches_per_unit": c / units}
                for n, (t, c) in items]

    res = {
        "units": units, "wall_ms_per_unit": wall_ms, "device_busy_ms_per_unit": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top_kernels": rows(ranked[:top]),
        "port_kernels": rows(kv for kv in ranked if any(f"::{k}" in kv[0] for k in PORT_KERNELS)),
    }
    ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                  if e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    res["ops_by_shape"] = [
        {"name": f"{e.key} {e.input_shapes}"[:160], "launches_per_unit": e.count / units,
         "ms_per_unit": e.self_device_time_total / 1e3 / units}
        for e in ops[:top]]
    return res


def head_stages(batch: int, runs: int = 30) -> dict:
    """Median device time (CUDA events around one eager call) of each stage
    of ``fft_conv2d`` at the paper head in bf16, on seeded features."""
    import math

    from jointpose_torch import get_config
    from jointpose_torch.ops import fft_conv as fc

    cfg = get_config("joint")
    (h, w), det = cfg.heatmap_hw, cfg.detector
    ci, co, k = det.trunk_features[-1], det.head_features[0], det.head_kernel
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(batch, h, w, ci, generator=gen).relu().cuda().bfloat16()
    kernel = (torch.randn(k, k, ci, co, generator=gen) / math.sqrt(k * k * ci)).cuda()

    def timed(fn):
        for _ in range(3):
            out = fn()
        times = []
        for _ in range(runs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times)), out

    res = {"batch": batch, "head": f"{k}x{k}x{ci}->{co} at {h}x{w}, bf16"}
    with torch.no_grad():
        (_, _), (_, _), t = fc.forward_spectra(x, kernel)
        res["input_transforms_ms"], (xr, xi) = timed(lambda: fc.input_spectrum(x, t))
        res["kernel_cast_and_column_dft_ms"], (a_re, a_im) = timed(
            lambda: fc.kernel_column_dft(kernel.bfloat16(), t))
        res["fused_tail_ms"], tail = timed(
            lambda: fc.fused_tail(xr, xi, a_re, a_im, t))
        tcat = tail.reshape(tail.shape[0], -1, *tail.shape[3:])
        res["inverse_column_product_ms"], _ = timed(lambda: fc.inverse_columns(tcat, t).contiguous())
        res["fft_conv2d_ms"], _ = timed(lambda: fc.fft_conv2d(x, kernel))
        nchw = x.permute(0, 3, 1, 2).contiguous()
        oihw = kernel.permute(3, 2, 0, 1).bfloat16().contiguous()
        res["cudnn_direct_conv_ms"], _ = timed(
            lambda: torch.nn.functional.conv2d(nchw, oihw, padding=k // 2))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, action="append")
    ap.add_argument("--train", action="store_true",
                    help="profile training steps (of flagship_pallas unless --preset says) instead "
                         "of requests")
    ap.add_argument("--head-stages", action="store_true",
                    help="time the stages of the Fourier head conv instead")
    ap.add_argument("--batch", type=int, default=None, help="default 8 served, 32 trained")
    ap.add_argument("--requests", type=int, default=4, help="requests, or training steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from jointpose_torch import _build

    _build.build(_build.kernel_names())
    if args.head_stages:
        res = head_stages(args.batch or 8)
        for name, v in res.items():
            print(f" {name}: {v:.4f}" if isinstance(v, float) else f" {name}: {v}")
        print(json.dumps(res))
        return 0
    if args.train:
        presets = args.preset or ["flagship_pallas"]
        unit, make, batch = "step", _train_unit, args.batch or 32
    else:
        unit, make, presets, batch = "request", _serve_unit, args.preset or PRESETS, args.batch or 8
    for preset in presets:
        res = profile(make(preset, batch, args.requests), args.requests)
        res.update(preset=preset, batch=batch, unit=unit)
        print(f"{preset}: {res['wall_ms_per_unit']:.3f} ms/{unit} wall, device busy "
              f"{res['device_busy_ms_per_unit']:.3f} ms, idle share "
              f"{res['device_idle_share']:.3f}")
        for title in ("top_kernels", "port_kernels", "ops_by_shape"):
            print(f" {title}:")
            for k in res[title]:
                print(f"  {k['ms_per_unit']:8.4f} ms  x{k['launches_per_unit']:g}  {k['name']}")
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
