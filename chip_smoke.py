#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``jointpose_torch``).

    python3 chip_smoke.py [--save-joint FILE] [--joint-reference FILE]

``--save-joint`` writes the served ``joint`` coordinates and heatmaps
(phase 3) to an ``.npz``; ``--joint-reference`` compares them with such a
file from another version of the port (same seeds, so same weights and
images) and prints the differences.

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when
the package is missing.  Phases, each fatal on failure:

1. print the card's name and power limit; build every kernel under
   ``jointpose_torch/csrc/`` (one ``nvcc`` per source, all at once);
2. with TF32 off, hold each kernel against its plain PyTorch version on
   the card at its main-path shape: the epilogue forward (serving and
   training batch, bf16 and f32; also against its first design, which
   adds the logs one by one, and that design's tiled layout, which must
   be bit-identical to it) and backward (twice, bit-identical), the
   fused Fourier MRF tail in both forms, 3xTF32 and one TF32 pass (on
   dense unaries and on unaries concentrated on a few pixels), both
   shear-warp entries on a random full augmentation draw and the fused
   one on extreme maps (bit-equal to its two-pass form, which stays as a
   timed entry), and the three Fourier head-conv tails at the paper head
   (bf16 and f32, and against each other; the build form's ring version
   also against its register-staged version, and at training batch 32);
   then ``fft_conv2d`` against cuDNN's direct conv in f32; and the
   Fourier MRF pass at 'high' with TF32 switched on globally against the
   same with it off, forward and gradients (bit-equal: precision is the
   call's);
3. serve the paper ``joint`` preset at full width (bf16, direct head
   conv, seeded random weights): 4 requests of 8 uint8 240×360 images,
   through the fused Fourier MRF tail kernel;
4. serve ``joint`` with ``head_conv_impl='fft'`` the same way, through
   the head-conv tail the dispatcher picks and the fused MRF tail; then
   one request through each of the other two head-conv tails;
5. serve ``flagship`` with ``mrf.impl='pallas'`` the same way, through
   the fused epilogue kernel;
6. train ``flagship`` with ``mrf.impl='pallas'``: one warm-up and 4 timed
   joint-stage steps at batch 32, through the shear warp and the
   epilogue forward and backward;
7. ``fit`` the same config end to end through ``train.fit``: synthetic
   source generated on the card, 6 detector + 6 joint steps at batch 32,
   priors, evals of both stages, checkpoints; then serve the restored
   checkpoint (bit-equal to the fitted model), run ``python -m
   jointpose_torch.quantize`` on it and ``predict.main`` as a process
   without and with ``--quantize-artifact`` (records equal to the
   in-process predictors', through the epilogue kernel), and resume for 2
   more steps;
8. observability and operations (``observe_phase``): ``fit`` of the same
   config, 4 + 6 steps, with a profiler window of steps 5-7 (its trace,
   read by ``devtime.parse_trace``, holds the path's three kernels as often
   as their launch counters say) and each stage's cost record (its
   roofline bound finite and at least the stage's measured images/s); one
   joint step under ``perf.count_cost`` (the kernels' own reports) and the
   step time without and with the profiler in turns; ``devtime.
   measure_device_time`` of served ``joint`` at MRF precision 'default'
   (the single-pass tail once a run) beside ``time_ms`` of the same call;
   ``python -m jointpose_torch.resilience`` over ``flagship``'s CLI with a
   fault injected at step 5 (one restart, resumed from step 4 with the
   priors applied there, ended at step 8, parameters within FIT_RTOL of an
   unbroken run, both under cuDNN's deterministic algorithms; a third run
   with the defaults shows their spread); ``debug.checked_apply`` on the
   ``joint`` model, clean and with a NaN in one image (it names the first
   module);
9. serve through ``jointpose_torch.serve`` at the serving default, MRF
   precision 'default': a full-width ``joint`` checkpoint written from
   seeded weights behind ``PoseService(batch_size=16, batch_buckets=[1,
   8])`` and its HTTP handler, 64 npy requests of 1-8 uint8 images from 8
   client threads and one JSON request, through the single-pass tail;
   one batch at 'high' against 'default'; ``flagship`` at 'default'
   (bit-equal to 'high': its direct conv ignores the flag); then ``python
   -m jointpose_torch.serve`` as a process: /healthz, /predict, SIGTERM;
   then the int8 deployment of ``joint`` at full width: calibrate on 64
   images of the synthetic source generated on the card, quantize, write
   and read the artifact (w_q, w_scale and bias bit-equal to the CPU's,
   in_scale within 1e-5; from one set of qparams every int8 input and
   int32 sum bit-equal card vs CPU; int8 within 0.08 of the fp32 logits'
   range), serve the quantized predictor (one single-pass MRF tail launch
   per request; a second predictor from the read artifact bit-equal) and
   ``PoseService(quantize_artifact=)``;
10. check the MRF paths and the Fourier head on the card against the CPU
   at the ``tiny`` preset (fp32): the forward, one training step's
   gradients (the fused Fourier path also at precision 'default'), a
   whole ``fit`` of 4 + 4 steps, and the synthetic source;
11. time each kernel and its plain version at the main-path shape, the
   epilogue forward also against its first design and an empty launch,
   in turns: the two forms of the Fourier MRF tail, the fused shear warp
   and its two-pass form (and the fused kernel's strip widths), the
   head-conv tail's ring and register-staged versions at batch 8 and 32;
   then the Fourier head against cuDNN and served ``joint`` with either
   head at batch 1, 8, 16 and 32.  The int8 detector is timed in phase 9,
   against the bf16 cuDNN detector in turns, with each conv's im2col and
   ``torch._int_mm``.

The last lines are the card's ``nvidia-smi`` line, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import torch

# The card's peaks and the bound on them: one copy, in the package.
from jointpose_torch.perf import (
    BF16_FLOPS_PER_S, FP32_FLOPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S, TF32_FLOPS_PER_S,
    nbytes, tf32_ops_ms,
)
from jointpose_torch.perf import bound_ms as bound

# max|kernel - plain| / max|plain|: the reference's parity tolerance for
# every MRF message-pass path (BENCH_r05.json parity_tolerances).
KERNEL_RTOL = 1e-3
# The fused Fourier MRF tail besides: its 3xTF32 products must stay near
# fp32 where the log amplifies small responses (the reference's on-chip MRF
# parity is 1.4e-5, BENCH_r05.json).
MRF_TAIL_RTOL = 2e-5
# Its single-pass form (MRF precision 'default') against fp32: the
# reference's bar for single-pass precision, 0.4% max relative output
# error (jointpose/evaluate.py --mrf-precision).  Against its own
# arithmetic in plain PyTorch (fused_tail_emulated(passes=1)) it differs by
# summation order only, which can move a TF32 rounding of T by one step:
# KERNEL_RTOL (2.2e-4 measured on the CPU between two summation orders of
# the emulation, on small responses).
SINGLE_PASS_RTOL = 4e-3
# max|kernel - plain| on pixels in [0, 1]: the reference's tolerance for
# its shear-warp kernel against its oracle (tests/test_warp_pallas.py).
WARP_ATOL = 2e-5
# Fourier head-conv tails, max|kernel - plain| / max|plain|.  f32: the
# reference's bound for its fused tail against its XLA tail
# (tests/test_fft_conv.py).  bf16: K_f, R and the output round to bf16, so
# another summation order flips some roundings by one bf16 step, 2^-8 =
# 3.9e-3 of the largest value (measured: 3.9e-3); two steps are allowed.
TAIL_RTOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}
# fft_conv2d against the direct conv in f32 (the reference's head parity bound).
CONV_RTOL = 1e-4
# The epilogue forward sums one log of a product of mantissas per output
# where its first design adds nine rounded logs: a rounding of the result
# apart (measured 2.1e-7), max|kernel - first design| / max|first design|.
EPILOGUE_PRODUCT_RTOL = 1e-6
# The kernel may not be slower than its first design, timed in turns in one
# process; 5% covers the spread between two timings of one kernel.
EPILOGUE_SLOWER_LIMIT = 1.05
# `fit` of `tiny` on the card against the CPU after 4 + 4 steps, per tensor
# max|Δ| / max|CPU|: the MRF paths' parity tolerance, for parameters and for
# the restored models' heatmaps.
FIT_RTOL = 1e-3
# The synthetic source on the card against the CPU, images in [0, 1]: the
# draws are bit-equal, exp/log/sin/cos round differently.  The joints come
# out one fp32 step apart (7.6e-6 px at coordinates up to 360), and a limb
# mask changes by up to 0.1 per px, under up to three overlapping limbs.
SYNTHETIC_ATOL = 5e-6
# The int8 detector against its fp32 graph, max|Δ| / max|fp32|: the
# reference's post-training-quantization bar (tests/test_quant.py).
INT8_FP_BAR = 0.08
# The int8 logits on the card against the CPU's from the same qparams: the
# int32 sums are exact on both, the fp32 epilogue is the same operations.
INT8_LOGITS_RTOL = 1e-6
# Calibration amax on the card against the CPU: two devices' fp32 convs.
CALIB_RTOL = 1e-5
DEPLOY_CALIB = 64
BATCH = 8
REQUESTS = 4
TRAIN_STEPS = 4
TIMED_RUNS = 50


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|got - want| / max|want|, max|got - want|); the relative error
    of an all-zero ``want`` is the absolute one."""
    diff = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    return (diff / scale if scale > 0 else diff), diff


def time_ms(fn, runs: int = TIMED_RUNS, per_graph: int = 10) -> float:
    """Median device time of one call of ``fn``, CUDA events around
    replays of a CUDA graph of ``per_graph`` calls: the host's launch
    overhead (Python, ctypes) stays out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(per_graph):
            fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return float(np.median(times))


def call_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median time of one eager call of ``fn``, CUDA events around it:
    device time plus whatever launch overhead the card waits for."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def extreme_affines(batch: int, h: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(a_inv, b_inv) on the card for ``batch`` images, cycling through maps
    beyond the augmentation preset's ranges: rotations of ±60° and ±45°,
    scales 0.5 and 2, flips, shifts about the centre, and a map whose a11
    is small but nonzero."""
    maps = []
    for angle, scale, flip in ((60.0, 0.5, 1.0), (-60.0, 2.0, -1.0), (45.0, 2.0, 1.0),
                               (-45.0, 0.5, -1.0)):
        t = math.radians(angle)
        rot = torch.tensor([[math.cos(t), -math.sin(t)], [math.sin(t), math.cos(t)]])
        maps.append(rot @ torch.diag(torch.tensor([flip, 1.0])) / scale)
    maps.append(torch.tensor([[0.3, 1.1], [-0.9, 1e-3]]))
    a_inv = torch.stack([maps[i % len(maps)] for i in range(batch)]).float()
    centre = torch.tensor([(w - 1) / 2, (h - 1) / 2])
    shift = torch.tensor([[3.0 * (i % 3) - 3.0, 2.0 - i % 5] for i in range(batch)])
    b_inv = centre - torch.einsum("bij,j->bi", a_inv, centre) + shift
    return a_inv.cuda(), b_inv.float().cuda()


def unaries(gen: torch.Generator, b: int, h: int, w: int, k: int, dtype,
            sharpness: float = 1.0) -> torch.Tensor:
    """Spatially softmaxed random heatmaps (B, H, W, K) on the card; a large
    ``sharpness`` concentrates each on a few pixels."""
    x = (sharpness * torch.randn(b, h * w, k, generator=gen)).softmax(dim=1)
    return x.reshape(b, h, w, k).to("cuda", dtype)


def mrf_params(gen: torch.Generator, window, k: int):
    """Positive kernels near the uniform init and small positive biases."""
    from jointpose_torch.models.mrf import inverse_softplus

    wh, ww = window
    raw = inverse_softplus(1.0 / (wh * ww)) + 0.5 * torch.randn(wh, ww, k, k, generator=gen)
    kernels = torch.nn.functional.softplus(raw)
    biases = torch.nn.functional.softplus(inverse_softplus(1e-4) + torch.randn(k, k, generator=gen))
    return kernels.cuda(), biases.cuda()


class Count:
    """A launch counter kept on another attribute of a wrapper, read and
    reset as ``launches`` like the others."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)


def reset(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def serve(config, seed: int, counters: dict, requests: int = REQUESTS, batch: int = BATCH,
          predict=None) -> dict:
    """Serve ``requests`` requests of ``batch`` uint8 images through
    ``predict`` (default: ``build_predictor`` of seeded weights); return
    timings, launch counts, the decoded coordinates and the heatmaps."""
    from jointpose_torch.predict import build_predictor, init_state_dict

    if predict is None:
        predict = build_predictor(config, init_state_dict(config, torch.Generator().manual_seed(seed)))
    h, w = config.data.image_hw
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (requests, batch, h, w, 3), dtype=np.uint8))
    images = images.cuda()
    predict(images[0])  # warm-up: cuDNN algorithm choice, DFT tables
    torch.cuda.synchronize()
    reset(counters)
    latencies, all_coords, all_probs = [], [], []
    for r in range(requests):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        coords, probs = predict(images[r])
        end.record()
        end.synchronize()
        latencies.append(start.elapsed_time(end))
        all_coords.append(coords.cpu())
        all_probs.append(probs.cpu())
        hm = config.heatmap_hw
        check(tuple(coords.shape) == (batch, config.num_joints, 2), f"coords shape {tuple(coords.shape)}")
        check(tuple(probs.shape) == (batch, *hm, config.num_joints), f"probs shape {tuple(probs.shape)}")
        check(bool(torch.isfinite(coords).all()) and bool(torch.isfinite(probs).all()),
              "non-finite output")
        check(bool(((coords[..., 0] >= 0) & (coords[..., 0] <= w - 1)).all()
                   and ((coords[..., 1] >= 0) & (coords[..., 1] <= h - 1)).all()),
              "coordinates outside the frame")
        mass = probs.sum(dim=(1, 2))
        check(bool(((mass - 1).abs() < 1e-3).all()), "heatmaps do not sum to 1")
    launches = {name: fn.launches for name, fn in counters.items()}
    return {"p50_ms": float(np.median(latencies)), "latencies_ms": latencies, "launches": launches,
            "coords": torch.stack(all_coords), "probs": torch.stack(all_probs)}


def train_batches(config, seed: int, n: int, device: str) -> list[dict]:
    """``n`` batches of seeded uint8 images, joints drawn inside the frame."""
    rng = np.random.default_rng(seed)
    b, (h, w), k = config.train.batch_size, config.data.image_hw, config.num_joints
    return [{
        "image": torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(device),
        "joints": torch.from_numpy(
            rng.uniform([1.0, 1.0], [w - 2.0, h - 2.0], (b, k, 2)).astype(np.float32)).to(device),
        "visible": torch.ones(b, k, device=device),
    } for _ in range(n)]


def train(config, seed: int, counters: dict) -> dict:
    """One warm-up and ``TRAIN_STEPS`` timed joint-stage steps of ``config``
    from seeded random weights; checks losses, updates and gradients."""
    from jointpose_torch.train import create_state, make_train_step

    state = create_state(config, torch.Generator().manual_seed(seed))
    step = make_train_step(config, "joint")
    batches = train_batches(config, seed, 1 + TRAIN_STEPS, "cuda")
    state, _ = step(state, batches[0])  # warm-up: cuDNN algorithm choice
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    reset(counters)
    step_ms, metrics = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({key: float(v) for key, v in m.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    check(all(np.isfinite(v) for m in metrics for v in m.values()), f"non-finite metrics {metrics}")
    unchanged = [n for n, p in state.model.named_parameters() if torch.equal(p, before[n])]
    check(not unchanged, f"parameters unchanged by {TRAIN_STEPS} steps: {unchanged}")
    sm = state.model.spatial_model
    for name, p in (("raw_kernels", sm.raw_kernels), ("raw_bias", sm.raw_bias)):
        check(p.grad is not None and p.grad.abs().max().item() > 0, f"zero gradient of {name}")
    return {"p50_ms": float(np.median(step_ms)), "step_ms": step_ms, "metrics": metrics,
            "launches": launches}


def tiny_config(mrf_overrides: dict, head: str):
    from jointpose_torch import get_config

    cfg = get_config("tiny")
    return cfg.replace(mrf=dataclasses.replace(cfg.mrf, **mrf_overrides),
                       detector=dataclasses.replace(cfg.detector, head_conv_impl=head))


def tiny_cpu_vs_card(mrf_overrides: dict, head: str) -> float:
    """Max relative error of the card's MRF log-heatmaps against the CPU's
    plain path on the fp32 ``tiny`` preset with random spatial kernels."""
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.predict import init_state_dict

    cfg = tiny_config(mrf_overrides, head)
    gen = torch.Generator().manual_seed(3)
    state = init_state_dict(cfg, gen)
    state["spatial_model.raw_kernels"] += 0.5 * torch.randn(
        state["spatial_model.raw_kernels"].shape, generator=gen)
    images = torch.rand(2, *cfg.data.image_hw, 3, generator=gen)
    outs = {}
    for device in ("cpu", "cuda"):
        model = PoseModel(cfg)
        model.load_state_dict(state)
        model = model.to(device).eval()
        with torch.inference_mode():
            outs[device] = model(images.to(device))["mrf_log_heatmaps"].cpu()
    return rel_err(outs["cuda"], outs["cpu"])[0]


def tiny_grads_cpu_vs_card(mrf_overrides: dict, head: str) -> tuple[float, str]:
    """One joint-stage training step of the fp32 ``tiny`` preset (stride-2
    trunk, shear warp) on the CPU and on the card, from the same weights,
    batch and augmentation draw.  Returns the worst gradient tensor's
    max|Δ| / max|CPU gradient| and its name; fails if the spatial model's
    gradients are zero on either device."""
    from jointpose_torch.data.augment import random_augment_params
    from jointpose_torch.train import create_state, make_train_step

    cfg = tiny_config(mrf_overrides, head)
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, pool_mode="stride"),
        augment=dataclasses.replace(cfg.augment, enabled=True, warp_impl="shear",
                                    crop_frac_range=(0.8, 1.0)),
    )
    gen = torch.Generator().manual_seed(5)
    aug = random_augment_params(gen, cfg.train.batch_size, cfg.augment, cfg.data.image_hw)
    noise = 0.5 * torch.randn(cfg.mrf.window + (cfg.num_joints,) * 2, generator=gen)
    batch = train_batches(cfg, 5, 1, "cpu")[0]
    grads = {}
    for device in ("cpu", "cuda"):
        state = create_state(cfg, torch.Generator().manual_seed(5), device=device)
        with torch.no_grad():
            state.model.spatial_model.raw_kernels += noise.to(device)
        make_train_step(cfg, "joint")(state, batch, aug=aug)
        grads[device] = {n: p.grad.cpu() for n, p in state.model.named_parameters()}
        for name in ("spatial_model.raw_kernels", "spatial_model.raw_bias"):
            check(grads[device][name].abs().max().item() > 0, f"{device}: zero gradient of {name}")
    errs = {n: rel_err(grads["cuda"][n], g)[0] for n, g in grads["cpu"].items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def read_records(workdir: str) -> list[dict]:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def timed_ms(fn) -> float:
    """Wall time of one call of ``fn``, the device's work included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def fit_phase(config, counters: dict, smi: str) -> None:
    """``train.fit`` at full width on the card, then what a user does with
    its workdir: restore, serve, resume.  Fails on a wrong launch count, a
    non-finite loss, a missing eval or checkpoint, a restored predictor
    that differs from the fitted model, or a resume that does not take
    exactly the steps that are left."""
    from jointpose_torch.checkpoint import Checkpointer, reconcile_config
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.evaluate import evaluate
    from jointpose_torch.predict import build_predictor, restore_params
    from jointpose_torch.train import create_state, fit

    det, joint, evals = 6, 6, 2
    config = config.replace(train=dataclasses.replace(
        config.train, detector_steps=det, joint_steps=joint, eval_every=6, log_every=3))
    check(config.data.source == "synthetic" and config.data.image_hw == (240, 360)
          and config.train.batch_size == 32, "the fit phase is not the full-width synthetic run")
    tb = config.train.batch_size
    with tempfile.TemporaryDirectory() as workdir:
        reset(counters)
        t0 = time.perf_counter()
        result = fit(config, workdir, eval_max_batches=evals)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        want = {"shear_warp": det + joint, "mrf_epilogue_bwd": joint,
                "mrf_epilogue": joint + evals}
        for name, n in want.items():
            check(launches[name] == n, f"fit: {name} launched {launches[name]} times, not {n}")
        check(result.state.step == det + joint, f"fit ended at step {result.state.step}")
        check(all(p.device.type == "cuda" for p in result.state.model.parameters()),
              "fit: the model is not on the card")
        records = read_records(workdir)
        logs = [r for r in records if "loss" in r]
        check([(r["step"], r["stage"]) for r in logs]
              == [(3, "detector"), (6, "detector"), (9, "joint"), (12, "joint")],
              f"fit logged {[(r['step'], r['stage']) for r in logs]}")
        check(all(np.isfinite(r[k]) for r in logs for k in r if k != "stage"),
              f"fit: non-finite logged metrics {logs}")
        check([(r["step"], r["eval_stage"]) for r in records if "eval_stage" in r]
              == [(6, "detector"), (12, "joint")], "fit: metrics.jsonl lacks a stage's eval")
        check(result.metrics["num_examples"] == evals * tb, "fit: the eval saw another split size")
        ckpt_dir = os.path.join(workdir, config.train.checkpoint_dir)
        check(sorted(os.listdir(os.path.join(ckpt_dir, "latest"))) == ["12", "6"],
              "fit: latest/ does not hold steps 6 and 12")
        check(os.listdir(os.path.join(ckpt_dir, "best")) == ["12"],
              "fit: best/ does not hold the one full-model eval's step")
        check(os.path.exists(os.path.join(ckpt_dir, "run_config.json")), "fit: no run_config.json")

        # What was saved serves, bit for bit.
        _, test_ds = make_dataset(config.data)
        images = test_ds.get_batch(np.arange(8))["image"]
        state_dict, step = restore_params(config, ckpt_dir, best=True)
        served_cfg = reconcile_config(config, ckpt_dir)
        got = build_predictor(served_cfg, state_dict)(images)
        ref = build_predictor(served_cfg, result.state.model.state_dict())(images)
        check(step == det + joint and torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              "fit: the restored predictor differs from the fitted model")
        check(bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all()),
              "fit: the restored predictor's output is not finite")
        deploy_cli_phase(config, ckpt_dir, smi)

        eval_ms = timed_ms(lambda: evaluate(result.state.model, test_ds, config, max_batches=4))
        idx = np.arange(tb)
        get_batch_ms = call_ms(lambda: test_ds.get_batch(idx), runs=10)
        ckpt = Checkpointer(os.path.join(workdir, "timing"), keep=1)
        save_ms = timed_ms(lambda: ckpt.save(1, result.state))
        fresh = create_state(config, torch.Generator().manual_seed(1))
        restore_ms = timed_ms(lambda: ckpt.restore(fresh))
        check(all(torch.equal(p, q) for p, q in zip(fresh.model.parameters(),
                                                    result.state.model.parameters())),
              "a restored state's parameters differ from the saved ones")
        kernels_before = result.state.model.spatial_model.raw_kernels.detach().clone()

        # Resume: exactly the 2 steps that are left, the priors not applied again.
        longer = config.replace(train=dataclasses.replace(config.train, joint_steps=joint + 2))
        reset(counters)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            resumed = fit(longer, workdir, eval_max_batches=evals, resume=True)
        print(out.getvalue(), end="")
        check(f"resumed from step {det + joint}" in out.getvalue()
              and "estimating pairwise priors" not in out.getvalue(),
              "fit(resume=True) did not resume after the prior init")
        check(resumed.state.step == det + joint + 2
              and counters["mrf_epilogue_bwd"].launches == 2
              and counters["shear_warp"].launches == 2,
              f"fit(resume=True) did not take exactly 2 steps: step {resumed.state.step}, "
              f"{counters['mrf_epilogue_bwd'].launches} backward launches")
        moved = (resumed.state.model.spatial_model.raw_kernels - kernels_before).abs().max().item()
        check(0 < moved < 0.1, f"the resumed steps moved the spatial kernels by {moved}")
    rate = {stage: [r["images_per_sec"] for r in logs if r["stage"] == stage]
            for stage in ("detector", "joint")}
    print(f"fit flagship (bf16, mrf.impl='pallas', synthetic source on the card, batch {tb}): "
          f"{det} + {joint} steps, 2 evals of {evals} batches and 2 checkpoints in {fit_s:.2f} s; "
          f"images/s per log interval of 3 steps: detector {rate['detector']}, joint "
          f"{rate['joint']} (each stage's first interval holds cuDNN's algorithm choice, the "
          f"joint stage's also the prior estimation); launches {launches}; final eval "
          f"PDJ@0.05 wrist/elbow {result.metrics['pdj_at_05_wrist_elbow']:.4f}; on {smi}")
    print(f"fit flagship: eval of 4 batches {eval_ms:.1f} ms = {4 * tb / eval_ms * 1e3:.1f} "
          f"images/s; synthetic get_batch at batch {tb} {get_batch_ms:.3f} ms; checkpoint save "
          f"{save_ms:.1f} ms, restore {restore_ms:.1f} ms; restored predictor bit-equal on 8 test "
          f"images; resume took 2 steps and kept the kernels' prior init; on {smi}")


# A sitecustomize for the children of the supervised-fit check: the
# interpreter's own sitecustomize first, then cuDNN's and PyTorch's
# deterministic algorithms for the whole process.
DETERMINISTIC_SITE = """
import importlib.machinery, importlib.util, os, sys
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)
"""


# Kernel function names in a CUDA trace of each launch counter of the
# training path (csrc/shear_warp.cu, csrc/mrf_epilogue.cu).
PATH_KERNELS = {"shear_warp": "shear_warp_fused_kernel", "mrf_epilogue": "mrf_epilogue_fwd_kernel",
                "mrf_epilogue_bwd": "mrf_epilogue_bwd_kernel"}


def observe_phase(config, joint, counters: dict, smi: str) -> None:
    """Observability and operations on the card: ``fit`` of ``config`` with
    a profiler window and its stage-cost records, ``devtime.
    measure_device_time`` of served ``joint``, a supervised ``fit`` killed
    by an injected fault and resumed, and ``debug.checked_apply``."""
    from jointpose_torch import devtime, metrics, perf
    from jointpose_torch.checkpoint import Checkpointer
    from jointpose_torch.configs import with_mrf_precision
    from jointpose_torch.debug import checked_apply
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.ops.mrf_fft_fused import fused_tail
    from jointpose_torch.predict import build_predictor, init_state_dict
    from jointpose_torch.train import fit, make_train_step

    # 1. The profiler window (steps 5-7, all joint steps) and the stage costs.
    det, joint_steps, window = 4, 6, 3
    cfg = config.replace(train=dataclasses.replace(
        config.train, detector_steps=det, joint_steps=joint_steps, eval_every=5, log_every=1))
    tb = cfg.train.batch_size
    marks: dict[str, dict] = {}

    class CountingHook(metrics.ProfilerHook):
        """The launch counters where the window opens and where it closes."""

        def on_step(self, step: int) -> None:
            edge = ("start" if step == self.start_step else
                    "stop" if step >= self.stop_step and "stop" not in marks else None)
            if edge:
                marks[edge] = {name: fn.launches for name, fn in counters.items()}
            super().on_step(step)

    hook_class, metrics.ProfilerHook = metrics.ProfilerHook, CountingHook
    try:
        with tempfile.TemporaryDirectory() as workdir:
            reset(counters)
            fit(cfg, workdir, eval_max_batches=1, profile_steps=window)
            records = read_records(workdir)
            timing = devtime.parse_trace(os.path.join(workdir, "profile"), "train")
    finally:
        metrics.ProfilerHook = hook_class
    check(timing is not None and timing.num_runs == window,
          f"profile: {0 if timing is None else timing.num_runs} annotated steps with device ops "
          f"in the window, not {window}")
    in_window = {name: marks["stop"][name] - marks["start"][name] for name in PATH_KERNELS}
    traced = {name: sum(o.count for o in timing.ops if kname in o.name)
              for name, kname in PATH_KERNELS.items()}
    print(f"profile window of fit (steps 5-{4 + window}, flagship, batch {tb}): per-step device "
          f"time {[round(t * 1e3, 3) for t in timing.run_durations_s]} ms, median "
          f"{timing.median_run_s * 1e3:.3f} ms, busy {sum(o.duration_s for o in timing.ops) * 1e3 / window:.3f} "
          f"ms a step; the path's kernels in the trace {traced}, launched in the window {in_window}; "
          f"on {smi}")
    for op in timing.top_ops(10):
        print(f"  window top op: {op.duration_s * 1e3 / window:8.4f} ms/step x{op.count / window:g} "
              f"{op.name[:100]}")
    check(traced == in_window == {name: window for name in PATH_KERNELS},
          f"profile: kernels in the trace {traced}, launched in the window {in_window}")
    costs = [r for r in records if "roofline_images_per_sec" in r]
    check([(r["step"], r["stage"]) for r in costs] == [(0, "detector"), (det, "joint")],
          f"fit logged stage costs {[(r['step'], r.get('stage')) for r in costs]}")
    for r in costs:
        rates = [q["images_per_sec"] for q in records if q.get("stage") == r["stage"]
                 and "images_per_sec" in q]
        roof = r["roofline_images_per_sec"]
        print(f"stage cost {r['stage']}: {r['train_step_gflops_per_image']:.4f} GFLOP and "
              f"{r['train_step_mb_per_image']:.3f} MB per image counted, roofline bound "
              f"{roof:.1f} images/s; measured images/s per step {[round(x, 1) for x in rates]} "
              f"(best {max(rates) / roof:.2%} of the bound); on {smi}")
        check(roof is not None and math.isfinite(roof) and roof >= max(rates),
              f"stage {r['stage']}: the roofline {roof} is below the measured {max(rates)} images/s")

    # The cost of one joint step by hand, with the port's kernels' own
    # reports, and the profiler's cost on the step time in turns.
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.train import create_state

    state = create_state(cfg, torch.Generator().manual_seed(3))
    train_ds, _ = make_dataset(cfg.data)
    step_fn = make_train_step(cfg, "joint")
    batches = [np.arange(i * tb, (i + 1) * tb) for i in range(8)]

    def steps(profiled: bool) -> float:
        hook = metrics.ProfilerHook(os.path.join(trace_root, "window"), 0, len(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, idx in enumerate(batches):
            if profiled:
                hook.on_step(i)
                with hook.annotation(i):
                    step_fn(state, train_ds.get_batch(idx))
            else:
                step_fn(state, train_ds.get_batch(idx))
        torch.cuda.synchronize()
        t = (time.perf_counter() - t0) * 1e3 / len(batches)
        hook.close()  # the trace is written after the timed steps
        return t

    with tempfile.TemporaryDirectory() as trace_root:
        step_fn(state, train_ds.get_batch(batches[0]))  # warm-up
        with perf.count_cost() as cost:
            step_fn(state, train_ds.get_batch(batches[1]))
        turns = [steps(p) for p in (False, True, True, False)]
    plain_ms, profiled_ms = min(turns[0], turns[3]), min(turns[1], turns[2])
    kernels = {name: dict(k) for name, k in cost.kernels.items()}
    print(f"one joint step counted by perf.count_cost: {cost.flops / tb / 1e9:.4f} GFLOP and "
          f"{cost.bytes / tb / 1e6:.3f} MB per image; the port's kernels reported {kernels}; "
          f"step time in turns without / with the profiler / with / without: "
          f"{' / '.join(f'{t:.3f}' for t in turns)} ms: the profiler adds "
          f"{profiled_ms / plain_ms - 1:.1%}; on {smi}")
    check({name: k["launches"] for name, k in kernels.items()}
          == {"shear_warp": 1, "mrf_epilogue": 1, "mrf_epilogue_bwd": 1},
          f"count_cost: the path's kernels reported {kernels}")
    del state, train_ds

    # 2. measure_device_time of served joint at 'default' (one TF32 pass).
    jcfg = with_mrf_precision(joint, "default")
    predict = build_predictor(jcfg, init_state_dict(jcfg, torch.Generator().manual_seed(1)))
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (BATCH, *jcfg.data.image_hw, 3), dtype=np.uint8)).cuda()
    iters, warmup = 10, 2
    before = fused_tail.launches_1pass
    dev = devtime.measure_device_time(predict, images, iters=iters, warmup=warmup,
                                      program_name="serve_joint")
    check(dev is not None and dev.num_runs == iters, "measure_device_time: no runs on the card")
    tail_ops = sum(o.count for o in dev.ops if "mrf_fft_tail_kernel" in o.name)
    check(tail_ops == iters and fused_tail.launches_1pass - before == iters + warmup,
          f"measure_device_time: row 3' appears {tail_ops} times in {iters} runs")
    graph_ms = time_ms(lambda: predict(images))
    busy_ms = sum(o.duration_s for o in dev.ops) * 1e3 / iters
    print(f"measure_device_time, served joint (bf16, MRF 'default', batch {BATCH}): median run "
          f"{dev.median_run_s * 1e3:.4f} ms on the device (first kernel's start to last kernel's "
          f"end of an eager call, launch gaps included), busy {busy_ms:.4f} ms a run (the sum of "
          f"its kernels), row 3' once a run ({tail_ops} in {iters}); time_ms of the same call "
          f"{graph_ms:.4f} ms (CUDA-graph replays: the kernels back to back, no host launches); "
          f"on {smi}")
    for op in dev.top_ops(8):
        print(f"  serve_joint top op: {op.duration_s * 1e3 / iters:8.4f} ms/run "
              f"x{op.count / iters:g} {op.name[:100]}")
    del predict

    # 3. A supervised fit killed by an injected fault, against an unbroken
    # one.  cuDNN's default algorithms are not deterministic on the card:
    # two unbroken runs of this command end more than FIT_RTOL apart (Adam
    # turns last-bit gradient differences into whole updates of small
    # parameters), so the two runs compared take the deterministic ones
    # (DETERMINISTIC_SITE); a third, unbroken with the defaults, shows the
    # spread they remove.
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        site = os.path.join(tmp, "site")
        os.makedirs(site)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(DETERMINISTIC_SITE)
        deterministic = {"PYTHONPATH": os.pathsep.join(filter(None, [site, os.environ.get(
            "PYTHONPATH")])), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        walls, outs = {}, {}
        for tag, pre, env in (
                ("supervised", ["-m", "jointpose_torch.resilience", "--max-restarts", "1", "--"],
                 {"JOINTPOSE_FAULT_AT_STEP": "5", **deterministic}),
                ("unbroken", ["-m", "jointpose_torch.train"], deterministic),
                ("default", ["-m", "jointpose_torch.train"], {})):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, *pre, "--config", config.name, "--workdir", os.path.join(tmp, tag),
                 "--detector-steps", "4", "--joint-steps", "4", "--eval-every", "2",
                 "--eval-max-batches", "1"],
                capture_output=True, text=True, timeout=600, env={**os.environ, **env}, cwd=root)
            walls[tag], outs[tag] = time.perf_counter() - t0, proc.stdout
            check(proc.returncode == 0, f"{tag} fit exited {proc.returncode}: "
                  f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        with open(os.path.join(tmp, "supervised", "supervisor.jsonl")) as f:
            events = [(e["event"], e.get("rc")) for e in map(json.loads, f)]
        check(events == [("launch", None), ("failure", 41), ("launch", None), ("done", None)],
              f"supervisor.jsonl reads {events}")
        resumed = outs["supervised"].split("resumed from step 4", 1)
        check(len(resumed) == 2 and "estimating pairwise priors" in resumed[1],
              "the restarted child did not resume from step 4 and apply the priors there")
        final = {tag: Checkpointer(os.path.join(tmp, tag, "checkpoints")) for tag in walls}
        check(all(c.latest_step() == 8 for c in final.values()), "a run did not end at step 8")
        params = {tag: c.restore_subtree()["model"] for tag, c in final.items()}

    def apart(tag: str) -> tuple[str, float, bool]:
        errs = {n: rel_err(params[tag][n], w)[0] for n, w in params["unbroken"].items()}
        worst = max(errs, key=errs.get)
        return worst, errs[worst], all(torch.equal(params[tag][n], w)
                                       for n, w in params["unbroken"].items())

    (worst, err, same), spread = apart("supervised"), apart("default")
    print(f"supervised fit (the {config.name} preset through its CLI: the direct grouped MRF and "
          f"the shear warp; python -m jointpose_torch.resilience, JOINTPOSE_FAULT_AT_STEP=5, "
          f"cuDNN's deterministic algorithms): events {events}; the restart resumed from step 4, "
          f"applied the priors there and ended at step 8; final parameters against an unbroken "
          f"run: {'bit-equal' if same else 'not bit-equal'}, worst tensor {worst} rel err {err:.3e} "
          f"(limit {FIT_RTOL:g}); an unbroken run with cuDNN's default algorithms ends "
          f"{spread[1]:.3e} from it ({spread[0]}); wall {walls['supervised']:.1f} s supervised "
          f"(two processes) against {walls['unbroken']:.1f} s unbroken and {walls['default']:.1f} s "
          f"unbroken with the defaults; on {smi}")
    check(err <= FIT_RTOL, f"the supervised run's {worst} strays from the unbroken run's")

    # 4. checked_apply on the joint model: clean, then one image with a NaN.
    model = PoseModel(joint)
    model.load_state_dict(init_state_dict(joint, torch.Generator().manual_seed(2)))
    model = model.cuda().eval()
    x = images.float() / 255.0
    order = []
    hooks = [m.register_forward_hook(lambda m, i, o, n=n: order.append(n))
             for n, m in model.named_modules() if n and not list(m.children())]
    with torch.inference_mode():
        err, out = checked_apply(model, x)
        for h in hooks:
            h.remove()
        check(err.get() is None, f"checked_apply flags clean images: {err.get()}")
        x[BATCH // 2, x.shape[1] // 2, x.shape[2] // 2, 1] = float("nan")
        bad, _ = checked_apply(model, x)
    try:
        bad.throw()
        check(False, "checked_apply did not flag a NaN image")
    except FloatingPointError as e:
        message = str(e)
    check(f"'{order[0]}'" in message, f"checked_apply named {message}, not the first module {order[0]}")
    print(f"checked_apply on joint (bf16, batch {BATCH}): clean images pass; with a NaN in image "
          f"{BATCH // 2}: {message}")


def tiny_fit_cpu_vs_card() -> tuple[float, str, float, float]:
    """``fit`` of ``tiny`` (coarse MRF through the epilogue kernels, stride
    trunk, augmentation off: the two devices' generators draw differently)
    for 4 + 4 steps on the CPU and on the card.  Returns the worst
    parameter tensor's max|Δ| / max|CPU| and its name, the same for the two
    fitted models' heatmaps on 8 test images, and the share of decoded
    coordinates that agree to 1e-3 px."""
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.predict import build_predictor
    from jointpose_torch.train import fit

    cfg = tiny_config({"impl": "pallas", "stride": 2}, "direct")
    cfg = cfg.replace(
        detector=dataclasses.replace(cfg.detector, pool_mode="stride"),
        augment=dataclasses.replace(cfg.augment, enabled=False),
        train=dataclasses.replace(cfg.train, detector_steps=4, joint_steps=4, eval_every=4,
                                  log_every=4),
    )
    fitted = {}
    for device in ("cpu", "cuda"):
        with tempfile.TemporaryDirectory() as workdir:
            fitted[device] = fit(cfg, workdir, eval_max_batches=1, device=device)
    cpu = dict(fitted["cpu"].state.model.named_parameters())
    errs = {n: rel_err(p.detach().cpu(), cpu[n].detach())[0]
            for n, p in fitted["cuda"].state.model.named_parameters()}
    worst = max(errs, key=errs.get)
    images = make_dataset(cfg.data, "cpu")[1].get_batch(np.arange(8))["image"]
    outs = {d: build_predictor(cfg, r.state.model.state_dict(), device=d)(images)
            for d, r in fitted.items()}
    same = ((outs["cuda"][0].cpu() - outs["cpu"][0]).abs() <= 1e-3).float().mean().item()
    return errs[worst], worst, rel_err(outs["cuda"][1].cpu(), outs["cpu"][1])[0], same


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(port: int, path: str, body: bytes | None = None, ctype: str = "application/json"):
    """(status, JSON reply) of one request to the server on ``port``."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npy(images: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, images)
    return buf.getvalue()


def _pred_coords(preds: list[dict]) -> np.ndarray:
    return np.array([[p["joints"][name] for name in p["joints"]] for p in preds], np.float32)


def serve_phase(joint, flag_cfg, counters: dict, smi: str) -> dict:
    """``jointpose_torch.serve`` at the serving default, MRF precision
    'default', on full-width checkpoints written from seeded weights.
    Returns the HTTP run's launch counts and batcher metrics."""
    from jointpose_torch.checkpoint import reconcile_config
    from jointpose_torch.configs import with_mrf_precision
    from jointpose_torch.convert import write_initial_checkpoint
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.ops.heatmaps import decode_probs, model_probs
    from jointpose_torch.predict import build_predictor, init_state_dict
    from jointpose_torch.serve import PoseService, make_handler

    h, w = joint.data.image_hw
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as tmp:
        joint_dir = os.path.join(tmp, "joint")
        state = init_state_dict(joint, torch.Generator().manual_seed(6))
        write_initial_checkpoint(joint, joint_dir, state)
        cfg = with_mrf_precision(reconcile_config(joint, joint_dir), "default")
        check(cfg.mrf.precision == "default" and cfg.mrf.use_pallas, "serve: not the fused tail")
        t0 = time.perf_counter()
        service = PoseService(cfg, joint_dir, batch_size=16, step=0, batch_buckets=[1, 8])
        start_s = time.perf_counter() - t0
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        sizes = [int(n) for n in rng.integers(1, 9, 64)]
        bodies = [_npy(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)) for n in sizes]
        replies: list = [None] * len(sizes)

        def client(first: int) -> None:
            for i in range(first, len(sizes), 8):
                replies[i] = _http(port, "/predict", bodies[i], "application/x-npy")

        try:
            reset(counters)
            base = dict(service.stats)
            t0 = time.perf_counter()
            clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
            for t in clients:
                t.start()
            for t in clients:
                t.join(timeout=600)
            wall_s = time.perf_counter() - t0
            check(not any(t.is_alive() for t in clients), "serve: a client thread hangs")
            json_image = rng.random((1, h, w, 3), dtype=np.float32)
            json_reply = _http(port, "/predict", json.dumps({"images": json_image.tolist()}).encode())
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            health = _http(port, "/healthz")
        finally:
            server.shutdown()
            server.server_close()
            service.close()
        dispatches = service.stats["dispatches"] - base["dispatches"]
        for (status, body), n in zip(replies, sizes):
            check(status == 200 and len(body["predictions"]) == n, f"serve: a reply {status}")
            xy = _pred_coords(body["predictions"])
            check(bool(np.isfinite(xy).all() and (xy[..., 0] >= 0).all() and (xy[..., 0] <= w - 1).all()
                       and (xy[..., 1] >= 0).all() and (xy[..., 1] <= h - 1).all()),
                  "serve: coordinates outside the frame")
        check(json_reply[0] == 200 and len(json_reply[1]["predictions"]) == 1, "serve: the JSON request")
        check(health[0] == 200 and health[1]["step"] == 0, "serve: /healthz")
        m = health[1]["batcher"]
        check(launches["mrf_fft_tail_1pass"] == dispatches and launches["mrf_fft_tail"] == 0,
              f"serve 'default': the single-pass tail launched {launches['mrf_fft_tail_1pass']} "
              f"times and the 3xTF32 tail {launches['mrf_fft_tail']} times in {dispatches} dispatches")
        check(m["shed_requests"] == 0, "serve: requests were shed")
        print(f"serve joint through jointpose_torch.serve (bf16, MRF precision 'default', "
              f"PoseService(batch_size=16, batch_buckets=[1, 8]), ThreadingHTTPServer, started in "
              f"{start_s:.1f} s): {len(sizes)} npy requests of 1-8 uint8 240x360 images "
              f"({sum(sizes)} images) from 8 client threads plus one JSON request in {wall_s:.2f} s; "
              f"request latency p50 {m['request_latency_ms']['p50']} ms, p95 "
              f"{m['request_latency_ms']['p95']} ms, max {m['request_latency_ms']['max']} ms; "
              f"mean batch fill {m['mean_batch_fill']}; {dispatches} dispatches, "
              f"{m['coalesced_batches']} coalesced batches, {m['shed_requests']} shed; launches "
              f"{launches}; on {smi}")

        # One batch at 'high' against 'default', same weights and images.
        images = torch.from_numpy(rng.integers(0, 256, (8, h, w, 3), dtype=np.uint8)).cuda()
        outs = {}
        for prec in ("high", "default"):
            model = PoseModel(with_mrf_precision(cfg, prec))
            model.load_state_dict(state)
            model = model.cuda().eval()
            reset(counters)
            with torch.inference_mode():
                out = model(images)
                coords = decode_probs(model_probs(out), cfg.data.heatmap_stride,
                                      refine=cfg.decode_refine)
            torch.cuda.synchronize()
            outs[prec] = (out["mrf_log_heatmaps"].float(), coords.float())
            want = {"high": ("mrf_fft_tail", "mrf_fft_tail_1pass"),
                    "default": ("mrf_fft_tail_1pass", "mrf_fft_tail")}[prec]
            check(counters[want[0]].launches == 1 and counters[want[1]].launches == 0,
                  f"joint at {prec!r} did not go through its form of the tail")
        lh_err = rel_err(outs["default"][0], outs["high"][0])
        d = (outs["default"][1] - outs["high"][1]).abs()
        print(f"serve joint, one batch of 8 at 'default' against 'high': MRF log-heatmaps rel err "
              f"{lh_err[0]:.3e} (limit {SINGLE_PASS_RTOL:g}), max abs {lh_err[1]:.3e}; decoded "
              f"coordinates differ by max {d.max().item():.4f} px, median {d.median().item():.4f} px")
        check(lh_err[0] <= SINGLE_PASS_RTOL, "joint at 'default' strays from 'high'")

        # flagship at 'default': its direct conv ignores the flag.
        flag_dir = os.path.join(tmp, "flagship")
        flag_state = init_state_dict(flag_cfg, torch.Generator().manual_seed(8))
        write_initial_checkpoint(flag_cfg, flag_dir, flag_state)
        fcfg = with_mrf_precision(reconcile_config(flag_cfg, flag_dir), "default")
        fservice = PoseService(fcfg, flag_dir, batch_size=8, step=0)
        fh, fw = fcfg.data.image_hw
        batches = [rng.integers(0, 256, (8, fh, fw, 3), dtype=np.uint8) for _ in range(3)]
        try:
            reset(counters)
            base = fservice.stats["dispatches"]
            served = [_pred_coords(fservice.predict(b)) for b in batches]
            torch.cuda.synchronize()
            epi = counters["mrf_epilogue"].launches
            fdispatches = fservice.stats["dispatches"] - base
        finally:
            fservice.close()
        high = build_predictor(with_mrf_precision(fcfg, "high"), flag_state)
        same = all(np.array_equal(got, high(torch.from_numpy(b))[0].cpu().numpy())
                   for got, b in zip(served, batches))
        print(f"serve flagship (mrf.impl='pallas') at 'default': {len(batches)} requests of 8, "
              f"{fdispatches} dispatches, epilogue launches {epi}; coordinates "
              f"{'bit-equal to' if same else 'DIFFERENT from'} 'high'")
        check(epi == fdispatches == len(batches), "flagship: the epilogue did not launch once per dispatch")
        check(same, "flagship at 'default' differs from 'high'")

        # The entry point as a process: up, one request, SIGTERM drains.
        port = _free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "jointpose_torch.serve", "--config", joint.name, "--checkpoint",
             joint_dir, "--port", str(port), "--step", "0", "--batch-size", "8"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        try:
            t0 = time.perf_counter()
            up = False
            while not up and time.perf_counter() - t0 < 300 and proc.poll() is None:
                try:
                    up = _http(port, "/healthz")[0] == 200
                except OSError:
                    time.sleep(0.5)
            up_s = time.perf_counter() - t0
            check(up, f"python -m jointpose_torch.serve did not come up: "
                      f"{proc.communicate(timeout=60)[0][-2000:] if proc.poll() is not None else ''}")
            two = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
            status, body = _http(port, "/predict", _npy(two), "application/x-npy")
            check(status == 200 and len(body["predictions"]) == 2, f"the server process answered {status}")
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        check(proc.returncode == 0 and "shut down cleanly" in out,
              f"the server process did not drain on SIGTERM (exit {proc.returncode}): {out[-2000:]}")
        print(f"python -m jointpose_torch.serve --config {joint.name} (MRF precision 'default'): up in "
              f"{up_s:.1f} s, answered /healthz and /predict, drained on SIGTERM and exited 0")
    return {"launches": launches, "metrics": m, "dispatches": dispatches}


# ``predict.main`` in a child process with the preset's MRF impl set to the
# one the checkpoint was trained with (argv[1]): the CLIs take their config
# from the preset by name, as the reference's do.  Prints the epilogue's
# launch count at exit.
PREDICT_CHILD = """
import dataclasses, json, sys
import jointpose_torch.configs as configs
from jointpose_torch import predict
from jointpose_torch.ops.mrf_epilogue import mrf_epilogue
preset = configs.get_config
configs.get_config = lambda name: preset(name).replace(
    mrf=dataclasses.replace(preset(name).mrf, impl=sys.argv[1]))
predict.main(sys.argv[2:])
print("launches " + json.dumps({"mrf_epilogue": mrf_epilogue.launches}))
"""


def _child(args: list[str], what: str) -> tuple[str, float]:
    """Run ``python <args>`` from the repository root; its output and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0,
          f"{what} exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return proc.stdout, time.perf_counter() - t0


def deploy_cli_phase(config, ckpt_dir: str, smi: str) -> None:
    """The deployment CLIs on ``fit``'s checkpoint: ``python -m
    jointpose_torch.quantize``, then ``predict.main`` as a process without
    and with ``--quantize-artifact``; each writes ``num`` records equal to
    the in-process predictors' coordinates on the same images, through the
    epilogue kernel."""
    from jointpose_torch.checkpoint import reconcile_config
    from jointpose_torch.configs import with_mrf_precision
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.ops.quant import build_quantized_predictor, load_quantized
    from jointpose_torch.predict import build_predictor, restore_params

    served = with_mrf_precision(reconcile_config(config, ckpt_dir), "default")
    state, step = restore_params(served, ckpt_dir, best=True)
    _, test_ds = make_dataset(served.data)
    num, bs = min(20, test_ds.size), BATCH
    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, "int8.npz")
        out, quant_s = _child(["-m", "jointpose_torch.quantize", "--config", config.name,
                               "--checkpoint", ckpt_dir, "--best", "--calib", str(DEPLOY_CALIB),
                               "--out", artifact], "python -m jointpose_torch.quantize")
        summary = [line for line in out.splitlines() if line.startswith("quantized ")]
        check(len(summary) == 1 and f"step {step}, calibrated on {DEPLOY_CALIB} images" in summary[0],
              f"quantize printed {out[-1000:]}")
        predictors = {"float": build_predictor(served, state),
                      "int8": build_quantized_predictor(served, state,
                                                        qparams=load_quantized(artifact))}
        report = []
        for tag, extra in (("float", []), ("int8", ["--quantize-artifact", artifact])):
            workdir = os.path.join(tmp, tag)
            out, child_s = _child(["-c", PREDICT_CHILD, config.mrf.impl, "--config", config.name,
                                   "--checkpoint", ckpt_dir, "--best", "--workdir", workdir,
                                   "--num", str(num), "--batch-size", str(bs), *extra],
                                  f"predict.main {tag}")
            launches = json.loads(out.split("launches ", 1)[1].splitlines()[0])
            with open(os.path.join(workdir, "predictions.jsonl")) as f:
                records = [json.loads(line) for line in f]
            check([r["example"] for r in records] == list(range(num)),
                  f"predict {tag}: records {[r['example'] for r in records]}")
            got = np.array([list(r["joints"].values()) for r in records], np.float32)
            want = []
            for start in range(0, num, bs):
                idx = np.arange(start, min(start + bs, num))
                images = test_ds.get_batch(np.pad(idx, (0, bs - len(idx)), mode="edge"))["image"]
                want.append(predictors[tag](images)[0][: len(idx)].cpu().numpy())
            diff = float(np.abs(got - np.concatenate(want)).max())
            check(diff <= 1e-3, f"predict {tag}: records differ from the predictor by {diff} px")
            check(launches["mrf_epilogue"] == -(-num // bs),
                  f"predict {tag}: mrf_epilogue launched {launches['mrf_epilogue']} times")
            report.append(f"{tag}: {num} records in {child_s:.1f} s, max {diff:.2e} px from the "
                          f"in-process predictor, epilogue launches {launches['mrf_epilogue']}")
    print(f"deploy CLIs on fit's checkpoint ({config.name}, mrf.impl={config.mrf.impl!r}, step {step}): python -m "
          f"jointpose_torch.quantize --calib {DEPLOY_CALIB} in {quant_s:.1f} s ({summary[0]}); "
          f"predict.main as a process, batch {bs}, last batch padded by edge: "
          f"{'; '.join(report)}; on {smi}")


def deploy_phase(joint, counters: dict, smi: str) -> dict:
    """The int8 deployment path on ``joint`` at full width (seeded weights,
    MRF precision 'default'): calibrate on the synthetic source generated on
    the card, quantize, write and read the artifact, build the quantized
    predictor and serve it, through the single-pass Fourier MRF tail.
    Checks the card against the CPU (weights, scales, every int32 sum),
    int8 against fp32, the artifact round trip and quantized serving; times
    the int8 detector against the bf16 one in turns, and each conv's im2col
    and ``_int_mm``."""
    from jointpose_torch.configs import with_mrf_precision
    from jointpose_torch.convert import write_initial_checkpoint
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.models.detector import Detector
    from jointpose_torch.ops import quant
    from jointpose_torch.predict import init_state_dict
    from jointpose_torch.serve import PoseService

    cfg = with_mrf_precision(joint, "default")
    h, w = cfg.data.image_hw
    state = init_state_dict(cfg, torch.Generator().manual_seed(11))
    train_ds, test_ds = make_dataset(cfg.data)
    calib = train_ds.get_batch(np.arange(DEPLOY_CALIB))["image"]
    check(calib.device.type == "cuda" and tuple(calib.shape) == (DEPLOY_CALIB, h, w, 3),
          "deploy: the calibration images are not on the card at full width")
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quant.quantize_detector(cfg, state, calib)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    check(torch.backends.cudnn.allow_tf32 == tf32_before, "calibration did not put the TF32 flag back")

    # The card against the CPU on the first 8 calibration images.
    card8 = quant.quantize_detector(cfg, state, calib[:8])
    cpu8 = quant.quantize_detector(cfg, state, calib[:8].cpu(), device="cpu")
    scale_err = 0.0
    for name, node in cpu8.items():
        for field in ("w_q", "w_scale", "bias"):
            check(torch.equal(card8[name][field].cpu(), node[field])
                  and torch.equal(qparams[name][field].cpu(), node[field]),
                  f"deploy: {name} {field} differs between the card and the CPU")
        scale_err = max(scale_err, rel_err(card8[name]["in_scale"].cpu(), node["in_scale"])[0])
    check(scale_err <= CALIB_RTOL, f"deploy: in_scale card vs CPU rel err {scale_err}")

    # Test images of the calibration images' source, as uint8 (the serving input).
    images = (test_ds.get_batch(np.arange(BATCH))["image"] * 255.0).round().to(torch.uint8).cpu()
    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, "int8.npz")
        quant.save_quantized(artifact, qparams)
        loaded = quant.load_quantized(artifact)
        check(list(loaded) == list(qparams) and all(
            torch.equal(loaded[n][f], qparams[n][f].cpu()) and loaded[n][f].dtype == qparams[n][f].dtype
            for n in qparams for f in quant.FIELDS), "deploy: the artifact does not read back equal")

        # The same qparams on both sides: every int32 sum bit-equal.
        sums_card, sums_cpu = {}, {}
        with torch.inference_mode():
            logits_card = quant.quant_detector_logits(cfg, loaded, images[:2].cuda(), sums_card)
            logits_cpu = quant.quant_detector_logits(cfg, loaded, images[:2], sums_cpu)
        n_sums = sum(y.numel() for pairs in sums_cpu.values() for _, y in pairs)
        check(sums_card.keys() == sums_cpu.keys(), "deploy: the card and the CPU ran other convs")
        differ = [f"{name}[{i}] {what}: {int((a.cpu() != b).sum())} of {b.numel()}"
                  for name in sums_cpu for i, (pa, pb) in enumerate(zip(sums_card[name], sums_cpu[name]))
                  for what, a, b in (("int8 input", pa[0], pb[0]), ("int32 sums", pa[1], pb[1]))
                  if not torch.equal(a.cpu(), b)]
        logit_err = rel_err(logits_card.cpu(), logits_cpu)
        check(not differ, f"deploy: the card differs from the CPU in {differ}")
        check(logit_err[0] <= INT8_LOGITS_RTOL, f"deploy: logits card vs CPU rel err {logit_err[0]}")
        with torch.inference_mode():
            sums8 = {}
            int8_logits = quant.quant_detector_logits(cfg, qparams, images.cuda(), sums8)
            fp_logits = quant.fp_reference_logits(cfg, state, images.cuda())
        fp_err = rel_err(int8_logits, fp_logits)
        check(fp_err[0] <= INT8_FP_BAR, f"deploy: int8 logits {fp_err[0]:.4f} of the fp32 range away")
        print(f"deploy joint int8 (240x360, seeded weights): quantize_detector on {DEPLOY_CALIB} "
              f"synthetic images generated on the card in {quantize_s:.2f} s; card vs CPU on 8 of "
              f"them: w_q, w_scale and bias bit-equal, in_scale rel err {scale_err:.3e} (limit "
              f"{CALIB_RTOL:g}); the artifact reads back equal; from the same qparams on 2 uint8 "
              f"test images every int8 input and all {n_sums} int32 sums bit-equal card vs CPU, "
              f"logits rel err {logit_err[0]:.3e} (limit {INT8_LOGITS_RTOL:g}); int8 vs fp32 logits "
              f"on {BATCH} test images {fp_err[0]:.4f} of the fp32 range (limit {INT8_FP_BAR:g})")

        # The quantized predictor, served, through the single-pass MRF tail.
        predict = quant.build_quantized_predictor(cfg, state, qparams=loaded)
        served = serve(cfg, seed=13, counters=counters, predict=predict)
        check(served["launches"]["mrf_fft_tail_1pass"] == REQUESTS
              and served["launches"]["mrf_fft_tail"] == 0,
              f"deploy: launches {served['launches']}, not one single-pass tail per request")
        again = quant.build_quantized_predictor(cfg, state, qparams=quant.load_quantized(artifact))
        req = torch.from_numpy(np.random.default_rng(13).integers(
            0, 256, (REQUESTS, BATCH, h, w, 3), dtype=np.uint8)).cuda()
        same_again = all(torch.equal(again(req[r])[0].cpu(), served["coords"][r])
                         for r in range(REQUESTS))
        check(same_again, "deploy: a predictor from the loaded artifact gives other coordinates")

        ckpt_dir = os.path.join(tmp, "joint")
        write_initial_checkpoint(cfg, ckpt_dir, state)
        service = PoseService(cfg, ckpt_dir, batch_size=BATCH, step=0, quantize_artifact=artifact)
        try:
            replies = [_pred_coords(service.predict(req[r].cpu().numpy())) for r in range(3)]
        finally:
            service.close()
        same_service = all(np.array_equal(replies[r], served["coords"][r].numpy()) for r in range(3))
        check(same_service, "deploy: PoseService(quantize_artifact=) answers other coordinates")
        print(f"deploy joint int8 served: {REQUESTS} requests x {BATCH} uint8 images, p50 "
              f"{served['p50_ms']:.3f} ms/request, latencies {served['latencies_ms']}, launches "
              f"{served['launches']}; a second predictor from the read artifact bit-equal; "
              f"PoseService(quantize_artifact=) answered 3 requests with the same coordinates")

    # Times: the int8 detector and the bf16 cuDNN one in turns, batch 8.
    det = Detector(cfg.detector, cfg.num_joints, dtype=torch.bfloat16)
    det.load_state_dict({k[len("detector."):]: v for k, v in state.items() if k.startswith("detector.")})
    det = det.cuda().eval()
    images = images.cuda()
    x16 = images.to(torch.bfloat16) * (1.0 / 255.0)
    with torch.inference_mode():
        turns = [time_ms(fn) for fn in (
            lambda: quant.quant_detector_logits(cfg, qparams, images), lambda: det(x16),
            lambda: det(x16), lambda: quant.quant_detector_logits(cfg, qparams, images))]
        int8_ms, bf16_ms = min(turns[0], turns[3]), min(turns[1], turns[2])
        print(f"time joint detector at batch {BATCH}, in turns int8 / bf16 cuDNN / bf16 cuDNN / "
              f"int8: {' / '.join(f'{t:.4f}' for t in turns)} ms; int8 {int8_ms:.4f} ms against "
              f"bf16 {bf16_ms:.4f} ({int8_ms / bf16_ms:.2f}x); on {smi}")
        convs, total = [], 0.0
        for name, pairs in sums8.items():
            w_q = qparams[name]["w_q"]
            k = w_q.shape[-1]
            wm = quant.weight_matrix(w_q)
            for xq, y in pairs:
                stride = xq.shape[-2] // y.shape[-2]
                cols = quant.im2col_int8(xq, k, stride)
                # A 1x1 conv's im2col of a channels-last map is a view: no copy, no time.
                view = cols.untyped_storage().data_ptr() == xq.untyped_storage().data_ptr()
                col_ms = 0.0 if view else time_ms(
                    lambda xq=xq, k=k, s=stride: quant.im2col_int8(xq, k, s))
                mm_ms = time_ms(lambda cols=cols, wm=wm: torch._int_mm(cols, wm.t()))
                m_rows, kp = cols.shape
                col_bound = 0.0 if view else (nbytes(xq) + nbytes(cols)) / HBM_BYTES_PER_S * 1e3
                mm_bound = max((nbytes(cols, wm) + m_rows * wm.shape[0] * 4) / HBM_BYTES_PER_S,
                               2 * m_rows * wm.shape[0] * kp / INT8_OPS_PER_S) * 1e3
                total += col_ms + mm_ms
                convs.append({"conv": name, "input": list(xq.shape), "M": m_rows, "K": kp, "view": view,
                              "N": wm.shape[0], "im2col_ms": col_ms, "im2col_bound_ms": col_bound,
                              "int_mm_ms": mm_ms, "int_mm_bound_ms": mm_bound})
                col = ("a view of the input, no copy" if view else
                       f"({m_rows} x {kp} int8, {nbytes(cols) / 1e6:.1f} MB) {col_ms:.4f} ms "
                       f"(byte bound {col_bound:.4f})")
                print(f"time int8 conv {name} input {tuple(xq.shape)} stride {stride}: im2col "
                      f"{col}, _int_mm ({m_rows} x {kp} x {wm.shape[0]}) {mm_ms:.4f} ms (bound "
                      f"{mm_bound:.4f}); on {smi}")
                del cols
    cols_ms = sum(c["im2col_ms"] for c in convs)
    print(f"time int8 convs: im2col {cols_ms:.4f} ms + _int_mm {total - cols_ms:.4f} ms summed over "
          f"the {len(convs)} convs, {total:.4f} ms of the int8 detector's {int8_ms:.4f} (the rest, "
          f"by difference: the fp32 epilogues, requantizes, pools and the multires sum); bounds: "
          f"HBM {HBM_BYTES_PER_S / 1e12} TB/s, int8 tensor cores {INT8_OPS_PER_S / 1e12} TOP/s "
          f"(H100 SXM data sheet)")
    print(f"deploy {json.dumps({'int8_ms': int8_ms, 'bf16_ms': bf16_ms, 'turns': turns, 'convs': convs})}")
    return {"launches": served["launches"], "int8_ms": int8_ms, "bf16_ms": bf16_ms}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-joint", default=None,
                        help="write the served joint coordinates and heatmaps to this .npz")
    parser.add_argument("--joint-reference", default=None,
                        help="compare them with an .npz written by --save-joint")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from jointpose_torch import _build, get_config
    from jointpose_torch.data.augment import inverse_affine, random_augment_params
    from jointpose_torch.ops import fft_conv as fc
    from jointpose_torch.ops.mrf_epilogue import bwd_cost as epilogue_bwd_cost
    from jointpose_torch.ops.mrf_epilogue import fwd_cost as epilogue_fwd_cost
    from jointpose_torch.ops.mrf_epilogue import (
        mrf_epilogue, mrf_epilogue_bwd, mrf_epilogue_bwd_plain, mrf_epilogue_fwd_empty,
        mrf_epilogue_fwd_pervalue, mrf_epilogue_fwd_tiled, mrf_epilogue_plain,
    )
    from jointpose_torch.ops.mrf_fft import (
        fft_pairwise_conv, forward_ffts, matmul_precision, mrf_message_pass_fft,
    )
    from jointpose_torch.ops.mrf_fft_fused import fused_tail, fused_tail_emulated, fused_tail_plain
    from jointpose_torch.ops.mrf_fft_fused import tail_cost as mrf_tail_cost
    from jointpose_torch.ops.mrf_xla import pairwise_conv
    from jointpose_torch.ops import warp as warp_ops
    from jointpose_torch.ops.warp import (
        shear_warp, shear_warp_reference, shear_warp_rowmajor, shear_warp_two_pass, warp_cost,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    t0 = time.perf_counter()
    _build.build(_build.kernel_names())
    print(f"build: {time.perf_counter() - t0:.2f} s for {_build.kernel_names()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    k = 9

    # --- kernel 1: fused epilogue at the flagship's coarse grid (30x45),
    # forward at the serving batch, backward at the training batch.
    flag = get_config("flagship")
    eps = flag.mrf.eps
    ch, cw = flag.heatmap_hw[0] // flag.mrf.stride, flag.heatmap_hw[1] // flag.mrf.stride
    kern1, bias1 = mrf_params(gen, flag.mrf.window, k)
    tb = flag.train.batch_size
    epi_err, resps = {}, {}
    for batch in (BATCH, tb):
        for dtype in (torch.bfloat16, torch.float32):
            resp = resps[batch, dtype] = pairwise_conv(
                unaries(gen, batch, ch, cw, k, dtype), kern1.to(dtype))
            got = mrf_epilogue(resp, bias1, eps)
            want = mrf_epilogue_plain(resp, bias1, eps)
            first = mrf_epilogue_fwd_pervalue(resp, bias1, eps)
            tiled = mrf_epilogue_fwd_tiled(resp, bias1, eps)
            torch.cuda.synchronize()
            epi_err[batch, dtype] = rel_err(got, want)
            from_first = rel_err(got, first)
            print(f"kernel mrf_epilogue {dtype} {tuple(resp.shape)}: rel err "
                  f"{epi_err[batch, dtype][0]:.3e} (limit {KERNEL_RTOL:g}), max abs err "
                  f"{epi_err[batch, dtype][1]:.3e}; from its first design (the logs added one by "
                  f"one) rel {from_first[0]:.3e} (limit {EPILOGUE_PRODUCT_RTOL:g}), max abs "
                  f"{from_first[1]:.3e}; the first design's tiled layout is "
                  f"{'bit-identical to it' if torch.equal(tiled, first) else 'DIFFERENT'}")
            check(epi_err[batch, dtype][0] <= KERNEL_RTOL,
                  f"mrf_epilogue {dtype} batch {batch} disagrees with its plain version")
            check(from_first[0] <= EPILOGUE_PRODUCT_RTOL,
                  f"mrf_epilogue {dtype} batch {batch} strays from its first design")
            check(torch.equal(tiled, first), "the tiled epilogue forward is not bit-identical "
                  "to the first design, whose summation order it keeps")
            check(torch.equal(mrf_epilogue(resp, bias1, eps), got),
                  "mrf_epilogue: a second run is not bit-identical")
    resp1 = resps[BATCH, torch.bfloat16]  # the flagship path's responses are bf16
    resp1_train = resps[tb, torch.bfloat16]

    bwd_err, bwd_in = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        resp = pairwise_conv(unaries(gen, tb, ch, cw, k, dtype), kern1.to(dtype))
        g = torch.randn(*resp.shape[:3], k, generator=gen).cuda()
        bwd_in[dtype] = (resp, g)
        dresp, dbias = mrf_epilogue_bwd(resp, bias1, g, eps)
        want_dresp, want_dbias = mrf_epilogue_bwd_plain(resp, bias1, g, eps)
        torch.cuda.synchronize()
        check(dresp.dtype == resp.dtype and dbias.dtype == torch.float32, "mrf_epilogue_bwd dtypes")
        e_resp, e_bias = rel_err(dresp, want_dresp), rel_err(dbias, want_dbias)
        bwd_err[dtype] = max(e_resp[1], e_bias[1])
        print(f"kernel mrf_epilogue_bwd {dtype} {tuple(resp.shape)}: dresp rel err {e_resp[0]:.3e} "
              f"(max abs {e_resp[1]:.3e}), dbias rel err {e_bias[0]:.3e} (max abs {e_bias[1]:.3e})")
        check(max(e_resp[0], e_bias[0]) <= KERNEL_RTOL,
              f"mrf_epilogue_bwd {dtype} disagrees with its plain version")
        again = mrf_epilogue_bwd(resp, bias1, g, eps)
        torch.cuda.synchronize()
        check(torch.equal(again[0], dresp) and torch.equal(again[1], dbias),
              f"mrf_epilogue_bwd {dtype}: a second run is not bit-identical")
    print("kernel mrf_epilogue_bwd: a second run gave bit-identical dresp and dbias (both dtypes)")
    resp3, g3 = bwd_in[torch.bfloat16]

    # --- kernel 2: fused Fourier tail at the joint geometry (60x90, 45x67).
    joint = get_config("joint")
    jh, jw = joint.heatmap_hw
    kern2, bias2 = mrf_params(gen, joint.mrf.window, k)
    p2 = unaries(gen, BATCH, jh, jw, k, torch.float32)
    pf, kf, tables = forward_ffts(p2, kern2)
    pf = tuple(t.contiguous() for t in pf)
    kf = tuple(t.contiguous() for t in kf)
    got = fused_tail(pf, kf, tables, bias2, joint.mrf.eps)
    want = fused_tail_plain(pf, kf, tables, bias2, joint.mrf.eps)
    torch.cuda.synchronize()
    tail_err = rel_err(got, want)
    print(f"kernel mrf_fft_tail {tuple(got.shape)}: rel err {tail_err[0]:.3e} "
          f"(limit {MRF_TAIL_RTOL:g}), max abs err {tail_err[1]:.3e}")
    check(tail_err[0] <= KERNEL_RTOL, "mrf_fft_tail disagrees with its plain version")
    check(tail_err[0] <= MRF_TAIL_RTOL, "mrf_fft_tail: 3xTF32 strays from the fp32 plain version")

    def single_pass_parity(pf_, kf_, bias_, what: str) -> tuple[float, float]:
        """The single-pass form against its own arithmetic and against fp32;
        returns (rel, max abs) against fp32."""
        before = fused_tail.launches_1pass
        got1 = fused_tail(pf_, kf_, tables, bias_, joint.mrf.eps, precision="default")
        torch.cuda.synchronize()
        check(fused_tail.launches_1pass == before + 1, "the single-pass tail did not count its launch")
        emu = rel_err(got1, fused_tail_emulated(pf_, kf_, tables, bias_, joint.mrf.eps, passes=1))
        fp32 = rel_err(got1, fused_tail_plain(pf_, kf_, tables, bias_, joint.mrf.eps))
        again1 = fused_tail(pf_, kf_, tables, bias_, joint.mrf.eps, precision="default")
        print(f"kernel mrf_fft_tail_1pass{what} {tuple(got1.shape)}: against its arithmetic in plain "
              f"PyTorch (one TF32 pass) rel err {emu[0]:.3e} (limit {KERNEL_RTOL:g}), max abs "
              f"{emu[1]:.3e}; against fp32 rel err {fp32[0]:.3e} (limit {SINGLE_PASS_RTOL:g}), max "
              f"abs {fp32[1]:.3e}; a second run is "
              f"{'bit-identical' if torch.equal(again1, got1) else 'DIFFERENT'}")
        check(emu[0] <= KERNEL_RTOL, f"mrf_fft_tail_1pass{what} disagrees with its plain version")
        check(fp32[0] <= SINGLE_PASS_RTOL, f"mrf_fft_tail_1pass{what} strays from fp32")
        check(torch.equal(again1, got1), "mrf_fft_tail_1pass: a second run is not bit-identical")
        return fp32

    tail1_err = single_pass_parity(pf, kf, bias2, "")
    # Small responses: unaries concentrated on a few pixels, half of the
    # kernels' taps zero and half of the biases below eps, so that most
    # responses lie below the biases and many below eps.
    p_small = unaries(gen, BATCH, jh, jw, k, torch.float32, sharpness=40.0)
    kern_small = kern2 * (torch.rand(kern2.shape, generator=gen) < 0.5).cuda()
    bias_small = torch.where(torch.rand(k, k, generator=gen).cuda() < 0.5, 1e-8, bias2)
    pf_s, kf_s, _ = forward_ffts(p_small, kern_small)
    pf_s = tuple(t.contiguous() for t in pf_s)
    kf_s = tuple(t.contiguous() for t in kf_s)
    got = fused_tail(pf_s, kf_s, tables, bias_small, joint.mrf.eps)
    want = fused_tail_plain(pf_s, kf_s, tables, bias_small, joint.mrf.eps)
    resp_small = fft_pairwise_conv(p_small, kern_small)
    below_bias = (resp_small < bias_small).float().mean().item()
    below_eps = (resp_small + bias_small < joint.mrf.eps).float().mean().item()
    del resp_small
    torch.cuda.synchronize()
    small_err = rel_err(got, want)
    again = fused_tail(pf_s, kf_s, tables, bias_small, joint.mrf.eps)
    print(f"kernel mrf_fft_tail, small responses {tuple(got.shape)}: rel err {small_err[0]:.3e} "
          f"(limit {MRF_TAIL_RTOL:g}), max abs err {small_err[1]:.3e}; a second run is "
          f"{'bit-identical' if torch.equal(again, got) else 'DIFFERENT'}; {below_bias:.3f} of the "
          f"responses lie below their bias, {below_eps:.3f} of resp + bias below eps")
    check(below_bias > 0.4 and below_eps > 0.1, "the small-response operands are not small")
    check(small_err[0] <= MRF_TAIL_RTOL, "mrf_fft_tail strays on small responses")
    check(torch.equal(again, got), "mrf_fft_tail: a second run is not bit-identical")
    single_pass_parity(pf_s, kf_s, bias_small, ", small responses")
    del pf_s, kf_s, p_small, kern_small, got, want, again

    # --- kernel 3: the shear warp, both entries, on a random full draw
    # (scale, rotation, translation, flip and crop) at the training shape.
    h, w = flag.data.image_hw
    images = torch.rand(tb, h, w, 3, generator=gen).cuda()
    draw_cfg = dataclasses.replace(flag.augment, crop_frac_range=(0.8, 1.0))
    draw = random_augment_params(torch.Generator().manual_seed(1), tb, draw_cfg, (h, w))
    a_inv, b_inv = (t.cuda() for t in inverse_affine(draw, (h, w)))
    want = shear_warp_reference(images, a_inv, b_inv)
    warp_err = {}
    for fn in (shear_warp, shear_warp_rowmajor):
        got = fn(images, a_inv, b_inv)
        torch.cuda.synchronize()
        check(got.shape == images.shape and got.dtype == torch.float32, f"{fn.__name__} output")
        warp_err[fn.__name__] = rel_err(got, want)[1]
        print(f"kernel {fn.__name__} {tuple(images.shape)}: max abs err "
              f"{warp_err[fn.__name__]:.3e} (limit {WARP_ATOL:g})")
        check(warp_err[fn.__name__] <= WARP_ATOL, f"{fn.__name__} disagrees with its plain version")
    # The fused kernel goes through the two-pass kernel's fp32 operations in
    # the same order: bit-equal to it, on the draw and on extreme maps.
    for what, (ai_, bi_) in (("the random full draw", (a_inv, b_inv)),
                             ("extreme maps", extreme_affines(tb, h, w))):
        fused = shear_warp(images, ai_, bi_)
        two = shear_warp_two_pass(images, ai_, bi_)
        err = (fused - shear_warp_reference(images, ai_, bi_)).abs().max().item()
        torch.cuda.synchronize()
        same = torch.equal(fused, two)
        print(f"kernel shear_warp (fused, strips of {warp_ops.strip_width(h, 3)} columns) on {what}: "
              f"{'bit-equal to' if same else 'DIFFERENT from'} its two-pass form; max abs err "
              f"{err:.3e} from the plain version (limit {WARP_ATOL:g})")
        check(same, f"the fused shear warp differs from its two-pass form on {what}")
        check(err <= WARP_ATOL, f"the fused shear warp disagrees with its plain version on {what}")
    del fused, two

    # --- kernels 4-6: the three Fourier head-conv tails at the paper head
    # (60x90, 9x9, 128 -> 512, serving batch), on the spectra the conv's own
    # front half makes of seeded features and a LeCun-normal kernel.
    jd = joint.detector
    ci, co, kk = jd.trunk_features[-1], jd.head_features[0], jd.head_kernel
    check((ci, co, kk) == (128, 512, 9), f"joint head is {kk}x{kk}x{ci}->{co}, not the paper's")
    feats = torch.randn(BATCH, jh, jw, ci, generator=gen).relu().cuda()
    hkernel = (torch.randn(kk, kk, ci, co, generator=gen) / math.sqrt(kk * kk * ci)).cuda()
    tails = {"fft_conv_tail_kdft_resident": fc.tail_kdft_resident,
             "fft_conv_tail_kdft": fc.tail_kdft, "fft_conv_tail_kf": fc.tail_kf}
    tail_args, conv_tail_err = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        (xr, xi), (a_re, a_im), ct = fc.forward_spectra(feats.to(dtype), hkernel)
        ops = [v.contiguous() for v in (xr, xi, a_re, a_im)]
        kf_ops = [v.contiguous() for v in fc._kf_from_a(ops[2], ops[3], ct)]
        want = fc.tail_kdft_plain(*ops, ct)
        outs = {}
        for name, fn in tails.items():
            args = (ops[0], ops[1], *kf_ops, ct) if fn is fc.tail_kf else (*ops, ct)
            tail_args[name, dtype] = args
            outs[name] = fn(*args)
            torch.cuda.synchronize()
            check(outs[name].shape == want.shape and outs[name].dtype == dtype, f"{name} output")
            conv_tail_err[name, dtype] = rel_err(outs[name], want)
            print(f"kernel {name} {dtype} x {tuple(ops[0].shape)} -> {tuple(want.shape)}: rel err "
                  f"{conv_tail_err[name, dtype][0]:.3e} (limit {TAIL_RTOL[dtype]:g}), max abs err "
                  f"{conv_tail_err[name, dtype][1]:.3e}")
            check(conv_tail_err[name, dtype][0] <= TAIL_RTOL[dtype],
                  f"{name} {dtype} disagrees with its plain version")
        if dtype == torch.bfloat16:
            # The build form's path runs the ring version; its register-staged
            # version, the timed entry it replaced, against both.
            nph = ops[0].shape[1]
            bodies = {name: fc.tail_body(name.removeprefix("fft_conv_tail_"), nph, BATCH, ci, co,
                                         kk, jh, 2) for name in tails}
            check(bodies == {"fft_conv_tail_kdft_resident": "ring", "fft_conv_tail_kdft": "ring",
                             "fft_conv_tail_kf": "regstaged"}, f"head-conv tail bodies {bodies}")
            reg = fc.tail_kdft_regstaged(*ops, ct)
            torch.cuda.synchronize()
            reg_err = rel_err(reg, want)
            ring_reg = rel_err(outs["fft_conv_tail_kdft_resident"], reg)
            print(f"kernel bodies {bodies}; the register-staged version against the plain version: "
                  f"rel err {reg_err[0]:.3e}; the ring version against it: rel err {ring_reg[0]:.3e}, "
                  f"max abs {ring_reg[1]:.3e} (limit {TAIL_RTOL[dtype]:g})")
            check(reg_err[0] <= TAIL_RTOL[dtype] and ring_reg[0] <= TAIL_RTOL[dtype],
                  "the ring and register-staged head-conv tails disagree")
            del reg
        if dtype == torch.float32:
            names = list(tails)
            for i, a in enumerate(names):
                for b in names[i + 1:]:
                    err = rel_err(outs[a], outs[b])[0]
                    print(f"kernels {a} vs {b} (f32): rel err {err:.3e}")
                    check(err <= TAIL_RTOL[dtype], f"{a} and {b} disagree in f32")
        del want, outs
    # The batch-tiled entry at training batch 32: four batch tiles, the ring.
    feats32 = torch.randn(tb, jh, jw, ci, generator=gen).relu().cuda().bfloat16()
    (xr, xi), (a_re, a_im), ct = fc.forward_spectra(feats32, hkernel)
    tail32_args = (xr, xi, a_re, a_im, ct)
    check(fc.select_tail(xr.shape[1], tb, kk, 2) == "kdft"
          and fc.tail_body("kdft", xr.shape[1], tb, ci, co, kk, jh, 2) == "ring",
          "batch 32 does not take the batch-tiled ring version")
    got32, reg32 = fc.tail_kdft(*tail32_args), fc.tail_kdft_regstaged(*tail32_args)
    want32 = fc.tail_kdft_plain(*tail32_args)
    torch.cuda.synchronize()
    err32, reg_err32 = rel_err(got32, want32), rel_err(got32, reg32)
    print(f"kernel fft_conv_tail_kdft bf16 at batch {tb} (ring): rel err {err32[0]:.3e} (limit "
          f"{TAIL_RTOL[torch.bfloat16]:g}), max abs {err32[1]:.3e}; against the register-staged "
          f"version rel {reg_err32[0]:.3e}")
    check(err32[0] <= TAIL_RTOL[torch.bfloat16] and reg_err32[0] <= TAIL_RTOL[torch.bfloat16],
          "fft_conv_tail_kdft at batch 32 disagrees")
    del got32, reg32, want32, feats32
    # The whole function in f32 against cuDNN's direct conv (TF32 off).
    with torch.no_grad():
        got = fc.fft_conv2d(feats[:2], hkernel)
        want = torch.nn.functional.conv2d(
            feats[:2].permute(0, 3, 1, 2), hkernel.permute(3, 2, 0, 1), padding=kk // 2
        ).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    conv_err = rel_err(got, want)[0]
    print(f"fft_conv2d f32 {tuple(feats[:2].shape)} vs F.conv2d: rel err {conv_err:.3e} "
          f"(limit {CONV_RTOL:g})")
    check(conv_err <= CONV_RTOL, "fft_conv2d disagrees with the direct conv in f32")
    del got, want

    # Precision is the call's: TF32 switched on for the whole process leaves
    # 'high' bit-equal to fp32, and the flag as it was.
    torch.backends.cuda.matmul.allow_tf32 = True
    flagged = mrf_message_pass_fft(p2, kern2, bias2, precision="high")
    pf_flagged = forward_ffts(p2, kern2, precision="high")[0][0]
    check(torch.backends.cuda.matmul.allow_tf32, "the Fourier MRF pass did not put the TF32 flag back")
    torch.backends.cuda.matmul.allow_tf32 = False
    fp32_pass = mrf_message_pass_fft(p2, kern2, bias2, precision="high")
    one_pass = mrf_message_pass_fft(p2, kern2, bias2, precision="default")
    torch.cuda.synchronize()
    flag_same = torch.equal(flagged, fp32_pass) and torch.equal(pf_flagged, pf[0])
    one_err = rel_err(one_pass, fp32_pass)
    print(f"precision is the call's: the plain Fourier MRF pass at 'high' with TF32 on globally is "
          f"{'bit-equal to' if flag_same else 'DIFFERENT from'} the pass with it off (forward DFTs "
          f"too); at 'default' (TF32) it differs by rel {one_err[0]:.3e} (limit {SINGLE_PASS_RTOL:g})")
    check(flag_same, "'high' follows the global TF32 flag")
    check(0 < one_err[0] <= SINGLE_PASS_RTOL, "'default' is not one TF32 pass within the bar")
    # The gradients too: the backward's products run at the call's precision,
    # whatever the flag says when the caller's backward runs.
    cot = torch.randn(flagged.shape, generator=gen).cuda()

    def plain_pass_grads(precision: str) -> tuple[torch.Tensor, ...]:
        inputs = [t.detach().clone().requires_grad_(True) for t in (p2, kern2, bias2)]
        out = mrf_message_pass_fft(*inputs, precision=precision)
        return torch.autograd.grad((out * cot).sum(), inputs)

    torch.backends.cuda.matmul.allow_tf32 = True
    grads_flagged = plain_pass_grads("high")
    check(torch.backends.cuda.matmul.allow_tf32, "the Fourier MRF backward did not put the TF32 flag back")
    torch.backends.cuda.matmul.allow_tf32 = False
    grads_fp32, grads_one = plain_pass_grads("high"), plain_pass_grads("default")
    torch.cuda.synchronize()
    grads_same = all(torch.equal(a, b) for a, b in zip(grads_flagged, grads_fp32))
    grads_err = max(rel_err(a, b)[0] for a, b in zip(grads_one, grads_fp32))
    print(f"precision is the call's in the backward: the plain Fourier MRF pass's gradients at 'high' "
          f"with TF32 on globally are {'bit-equal to' if grads_same else 'DIFFERENT from'} those with it "
          f"off; at 'default' they differ by rel {grads_err:.3e} (worst of p, kernels, biases)")
    check(grads_same, "the plain pass's gradients at 'high' follow the global TF32 flag")
    check(grads_err > 0, "the plain pass's gradients at 'default' are not one TF32 pass")
    del flagged, fp32_pass, one_pass, grads_flagged, grads_fp32, grads_one

    # --- the main paths.
    counters = {"mrf_epilogue": mrf_epilogue, "mrf_epilogue_bwd": mrf_epilogue_bwd,
                "mrf_fft_tail": fused_tail,
                "mrf_fft_tail_1pass": Count(fused_tail, "launches_1pass"), "shear_warp": shear_warp,
                "shear_warp_rowmajor": shear_warp_rowmajor, **tails}
    torch.backends.cudnn.allow_tf32 = True  # serving and training run with PyTorch's defaults
    joint_cfg = joint.replace(
        detector=dataclasses.replace(joint.detector, head_conv_impl="direct"))
    served_joint = serve(joint_cfg, seed=1, counters=counters)
    print(f"serve joint (bf16, direct head, fused Fourier MRF tail): {REQUESTS} requests x "
          f"{BATCH} images, p50 {served_joint['p50_ms']:.3f} ms/request, "
          f"latencies {served_joint['latencies_ms']}, launches {served_joint['launches']}")
    check(served_joint["launches"]["mrf_fft_tail"] == REQUESTS
          and served_joint["launches"]["mrf_fft_tail_1pass"] == 0,
          "joint at 'high': the 3xTF32 Fourier tail did not launch once per request")
    check(not any(served_joint["launches"][n] for n in tails),
          "joint with the direct head launched a head-conv tail")
    if opts.save_joint:
        np.savez(opts.save_joint, coords=served_joint["coords"].numpy(),
                 probs=served_joint["probs"].float().numpy())
    if opts.joint_reference:
        ref = np.load(opts.joint_reference)
        d_coords = np.abs(served_joint["coords"].numpy() - ref["coords"]).max()
        d_probs = rel_err(served_joint["probs"].float(), torch.from_numpy(ref["probs"]))
        print(f"serve joint against {opts.joint_reference}: decoded coordinates differ by max "
              f"{d_coords:.3f} px, heatmaps by max {d_probs[1]:.3e} ({d_probs[0]:.3e} of the "
              f"largest probability)")

    # The same weights and images through the Fourier head: the dispatcher's
    # own choice, then one request through each of the other two tails.
    fft_cfg = joint.replace(detector=dataclasses.replace(joint.detector, head_conv_impl="fft"))
    served_fft = serve(fft_cfg, seed=1, counters=counters)
    chosen = "fft_conv_tail_" + fc.select_tail(
        tail_args["fft_conv_tail_kdft", torch.bfloat16][0].shape[1], BATCH, kk, 2)
    print(f"serve joint (bf16, head_conv_impl='fft' through {chosen}, fused Fourier MRF tail): "
          f"{REQUESTS} requests x {BATCH} images, p50 {served_fft['p50_ms']:.3f} ms/request "
          f"(direct head {served_joint['p50_ms']:.3f}), latencies {served_fft['latencies_ms']}, "
          f"launches {served_fft['launches']}, on {smi}")
    check(chosen == "fft_conv_tail_kdft_resident", f"the dispatcher chose {chosen}")
    for name in (*tails, "mrf_fft_tail"):
        want_n = REQUESTS if name in (chosen, "mrf_fft_tail") else 0
        check(served_fft["launches"][name] == want_n,
              f"joint 'fft': {name} launched {served_fft['launches'][name]} times, not {want_n}")
    tail_launches = {chosen: served_fft["launches"][chosen]}
    for route in ("kdft", "kf"):
        name, preference = f"fft_conv_tail_{route}", fc.TAIL_PREFERENCE
        fc.TAIL_PREFERENCE = (route,)
        try:
            steered = serve(fft_cfg, seed=1, counters=counters, requests=1)
        finally:
            fc.TAIL_PREFERENCE = preference
        for other in (*tails, "mrf_fft_tail"):
            want_n = 1 if other in (name, "mrf_fft_tail") else 0
            check(steered["launches"][other] == want_n,
                  f"joint 'fft' steered to {route}: {other} launched "
                  f"{steered['launches'][other]} times, not {want_n}")
        tail_launches[name] = steered["launches"][name]
        drift = (steered["coords"][0] - served_fft["coords"][0]).abs().max().item()
        print(f"serve joint 'fft' steered to {name}: 1 request, {steered['latencies_ms'][0]:.3f} ms, "
              f"launches {steered['launches']}, max coordinate difference from {chosen} "
              f"{drift:.3f} px")
    head_drift = (served_fft["coords"] - served_joint["coords"]).abs()
    prob_drift = rel_err(served_fft["probs"], served_joint["probs"])
    print(f"joint 'fft' vs 'direct' head, same state_dict and images (bf16): decoded coordinates "
          f"differ by max {head_drift.max().item():.3f} px, median {head_drift.median().item():.4f} px, "
          f"{(head_drift > 1).float().mean().item():.4f} of values by more than 1 px; heatmaps "
          f"differ by max {prob_drift[1]:.3e} ({prob_drift[0]:.3e} of the largest probability)")
    flag_cfg = flag.replace(mrf=dataclasses.replace(flag.mrf, impl="pallas"))
    served_flag = serve(flag_cfg, seed=2, counters=counters)
    print(f"serve flagship (bf16, mrf.impl='pallas', fused epilogue): {REQUESTS} requests x "
          f"{BATCH} images, p50 {served_flag['p50_ms']:.3f} ms/request, "
          f"latencies {served_flag['latencies_ms']}, launches {served_flag['launches']}")
    check(served_flag["launches"]["mrf_epilogue"] == REQUESTS,
          "flagship: the fused epilogue did not launch once per request")
    trained = train(flag_cfg, seed=4, counters=counters)
    print(f"train flagship (bf16, mrf.impl='pallas', shear warp, joint stage): {TRAIN_STEPS} "
          f"steps x {tb} images, p50 {trained['p50_ms']:.3f} ms/step, "
          f"{tb / trained['p50_ms'] * 1e3:.1f} images/s, step times {trained['step_ms']}, "
          f"launches {trained['launches']}, on {smi}")
    print(f"train flagship metrics per step: {trained['metrics']}")
    want_launches = {"shear_warp": TRAIN_STEPS, "mrf_epilogue": TRAIN_STEPS,
                     "mrf_epilogue_bwd": TRAIN_STEPS}
    for name, n in want_launches.items():
        check(trained["launches"][name] == n,
              f"flagship training: {name} launched {trained['launches'][name]} times, not {n}")
    fit_phase(flag_cfg, counters, smi)
    observe_phase(flag_cfg, joint, counters, smi)
    served_default = serve_phase(joint, flag_cfg, counters, smi)
    deploy_phase(joint, counters, smi)
    torch.backends.cudnn.allow_tf32 = False

    # --- the card against the CPU on a small input.
    tiny_paths = (("fft fused", {"impl": "fft", "use_pallas": True}, "direct"),
                  ("coarse + epilogue", {"impl": "pallas", "stride": 2}, "direct"),
                  ("fft fused, Fourier head", {"impl": "fft", "use_pallas": True}, "fft"))
    default_path = ("fft fused at precision 'default'",
                    {"impl": "fft", "use_pallas": True, "precision": "default"}, "direct")
    reset(counters)
    for name, overrides, head in tiny_paths:
        err = tiny_cpu_vs_card(overrides, head)
        print(f"tiny {name}: card vs CPU MRF log-heatmaps rel err {err:.3e}")
        check(err <= KERNEL_RTOL, f"tiny {name}: card disagrees with the CPU")
    for name, overrides, head in tiny_paths:
        err, worst = tiny_grads_cpu_vs_card(overrides, head)
        print(f"tiny {name}, one training step (stride trunk, shear warp): card vs CPU gradients, "
              f"worst tensor {worst} rel err {err:.3e}")
        check(err <= KERNEL_RTOL, f"tiny {name}: the card's gradient of {worst} disagrees with the CPU")
    check(fc.tail_kdft_resident.launches >= 2,
          "tiny Fourier head: the card's forward and training step did not launch the resident tail")
    # The autograd guard of the single-pass form: one TF32 pass in the
    # forward and in the backward's recompute, against fp32 on the CPU.
    name, overrides, head = default_path
    before = fused_tail.launches_1pass
    err, worst = tiny_grads_cpu_vs_card(overrides, head)
    print(f"tiny {name}, one training step (stride trunk, shear warp): card vs CPU gradients, "
          f"worst tensor {worst} rel err {err:.3e} (limit {SINGLE_PASS_RTOL:g})")
    check(fused_tail.launches_1pass > before, "tiny at 'default' did not launch the single-pass tail")
    check(err <= SINGLE_PASS_RTOL, f"tiny {name}: the card's gradient of {worst} disagrees with the CPU")
    err, worst, prob_err, same = tiny_fit_cpu_vs_card()
    print(f"tiny coarse + epilogue, fit of 4 + 4 steps (synthetic source, augmentation off): card "
          f"vs CPU parameters, worst tensor {worst} rel err {err:.3e}; the fitted models' heatmaps "
          f"on 8 test images rel err {prob_err:.3e} (limits {FIT_RTOL:g}); {same:.4f} of the "
          f"decoded coordinates agree to 1e-3 px")
    check(err <= FIT_RTOL, f"tiny fit: the card's {worst} disagrees with the CPU's")
    check(prob_err <= FIT_RTOL and same >= 0.9, "tiny fit: the fitted models disagree")
    from jointpose_torch.data.pipeline import make_dataset
    synth = {d: make_dataset(flag.data, d)[0].get_batch(np.arange(4)) for d in ("cpu", "cuda")}
    synth_err = {key: rel_err(synth["cuda"][key].cpu(), synth["cpu"][key])[1] for key in synth["cpu"]}
    print(f"synthetic source, examples 0-3 at {flag.data.image_hw}: card vs CPU max abs "
          f"difference {synth_err} (limit {SYNTHETIC_ATOL:g} on the images; joints in pixels, "
          f"one fp32 step of 360 is 3e-5)")
    check(synth_err["image"] <= SYNTHETIC_ATOL and synth_err["joints"] <= 1e-4
          and synth_err["visible"] == 0, "the synthetic source on the card strays from the CPU's")

    # --- timings at the main-path shapes.
    # Each function's bytes and operations come from the cost formulas
    # beside its wrapper, which perf.step_cost reads too.
    b1, by1 = bound(*epilogue_fwd_cost(resp1, bias1))
    b3, by3 = bound(*epilogue_bwd_cost(resp3, bias1, g3))
    # The tail's products are admissible on the tensor cores only as 3xTF32
    # (checked above against MRF_TAIL_RTOL), three operations for one: the
    # operations' time is the lesser of fp32 on the CUDA cores and three
    # times the work at the TF32 peak.
    tail_bytes, flops2 = mrf_tail_cost(pf, kf, tables, bias2)
    t_ops2 = tf32_ops_ms(flops2, 3)
    t_bytes2 = tail_bytes / HBM_BYTES_PER_S * 1e3
    b2, by2 = (t_bytes2, "bytes") if t_bytes2 >= t_ops2 else (t_ops2, "operations")
    # The single-pass form: the same work, one pass at the TF32 peak.
    t_ops2_1 = tf32_ops_ms(flops2, 1)
    b2_1, by2_1 = (t_bytes2, "bytes") if t_bytes2 >= t_ops2_1 else (t_ops2_1, "operations")
    # The two forms in turns in this one process: 3xTF32, one pass, one pass, 3xTF32.
    tail_turns = [time_ms(lambda prec=prec: fused_tail(pf, kf, tables, bias2, precision=prec))
                  for prec in ("high", "default", "default", "high")]
    with matmul_precision("default", pf[0].device):
        plain_tf32_ms = time_ms(lambda: fused_tail_plain(pf, kf, tables, bias2))
    b4, by4 = bound(*warp_cost(images, a_inv, b_inv))
    # Row 1 at both shapes, in turns with its first design and its tiled
    # layout in this one process, and the floor: an empty launch of its grid.
    epi_ms = {}
    for batch, resp in ((BATCH, resp1), (tb, resp1_train)):
        n_rows = resp.shape[0] * resp.shape[1] * resp.shape[2]
        turns = [time_ms(lambda f=f, r=resp: f(r, bias1)) for f in
                 (mrf_epilogue_fwd_pervalue, mrf_epilogue, mrf_epilogue_fwd_tiled,
                  mrf_epilogue_fwd_tiled, mrf_epilogue, mrf_epilogue_fwd_pervalue)]
        epi_ms[batch] = {
            "kernel": min(turns[1], turns[4]), "first": min(turns[0], turns[5]),
            "tiled": min(turns[2], turns[3]),
            "empty": time_ms(lambda r=resp: mrf_epilogue_fwd_empty(r, bias1)),
            "plain": time_ms(lambda r=resp: mrf_epilogue_plain(r, bias1)),
            "bound": bound(*epilogue_fwd_cost(resp, bias1))[0],
        }
        e = epi_ms[batch]
        print(f"time mrf_epilogue forward at batch {batch} ({n_rows} rows x {k * k} bf16): kernel "
              f"{turns[1]:.6f} / {turns[4]:.6f} ms, its first design {turns[0]:.6f} / "
              f"{turns[5]:.6f} ms, the first design tiled {turns[2]:.6f} / {turns[3]:.6f} ms, an "
              f"empty launch of the kernel's grid {e['empty']:.6f} ms, plain {e['plain']:.6f} ms, "
              f"byte bound {e['bound']:.6f} ms ({e['bound'] / e['kernel']:.1%} of the kernel's "
              f"time), on {smi}")
        check(e["kernel"] <= EPILOGUE_SLOWER_LIMIT * e["first"],
              f"mrf_epilogue at batch {batch} is slower than its first design")
    kernels = [
        {
            "name": "mrf_epilogue", "route": "cuda",
            "source": "jointpose_torch/csrc/mrf_epilogue.cu",
            "replaces": "jointpose/ops/mrf_pallas.py:39",
            "launches": trained["launches"]["mrf_epilogue"],
            "max_abs_err": epi_err[BATCH, torch.bfloat16][1],
            "ms": epi_ms[BATCH]["kernel"], "plain_ms": epi_ms[BATCH]["plain"],
            "bound_ms": b1, "bound_by": by1, "library_ms": None,
        },
        {
            "name": "mrf_epilogue_bwd", "route": "cuda",
            "source": "jointpose_torch/csrc/mrf_epilogue.cu",
            "replaces": "jointpose/ops/mrf_pallas.py:50",
            "launches": trained["launches"]["mrf_epilogue_bwd"],
            "max_abs_err": bwd_err[torch.bfloat16],
            "ms": time_ms(lambda: mrf_epilogue_bwd(resp3, bias1, g3)),
            "plain_ms": time_ms(lambda: mrf_epilogue_bwd_plain(resp3, bias1, g3)),
            "bound_ms": b3, "bound_by": by3, "library_ms": None,
        },
        {
            "name": "mrf_fft_tail", "route": "cuda",
            "source": "jointpose_torch/csrc/mrf_fft_tail.cu",
            "replaces": "jointpose/ops/mrf_fft_pallas.py:50",
            "launches": served_joint["launches"]["mrf_fft_tail"],
            "max_abs_err": tail_err[1],
            "ms": min(tail_turns[0], tail_turns[3]),
            "plain_ms": time_ms(lambda: fused_tail_plain(pf, kf, tables, bias2)),
            "bound_ms": b2, "bound_by": by2, "library_ms": None,
        },
        {
            # The same TPU kernel compiled at Precision.DEFAULT; its plain
            # version here is the plain tail with TF32 products (cuBLAS).
            "name": "mrf_fft_tail_1pass", "route": "cuda",
            "source": "jointpose_torch/csrc/mrf_fft_tail.cu",
            "replaces": "jointpose/ops/mrf_fft_pallas.py:50",
            "launches": served_default["launches"]["mrf_fft_tail_1pass"],
            "max_abs_err": tail1_err[1],
            "ms": min(tail_turns[1], tail_turns[2]),
            "plain_ms": plain_tf32_ms,
            "bound_ms": b2_1, "bound_by": by2_1, "library_ms": None,
        },
    ]
    plain_warp_ms = time_ms(lambda: shear_warp_reference(images, a_inv, b_inv), runs=5, per_graph=1)
    # The fused warp and its two-pass form in turns: two-pass, fused, fused, two-pass.
    warp_turns = [time_ms(lambda fn=fn: fn(images, a_inv, b_inv))
                  for fn in (shear_warp_two_pass, shear_warp, shear_warp, shear_warp_two_pass)]
    strips = {tw: time_ms(lambda tw=tw: warp_ops._fused(images, a_inv, b_inv, tw))
              for tw in (4, 8, 16, 32, 64)}
    warp_ms = {"shear_warp": min(warp_turns[1], warp_turns[2]),
               "shear_warp_rowmajor": time_ms(lambda: shear_warp_rowmajor(images, a_inv, b_inv))}
    print(f"time shear_warp in turns, two-pass / fused / fused / two-pass: "
          f"{' / '.join(f'{t:.6f}' for t in warp_turns)} ms; the fused kernel by strip width "
          f"{ {tw: round(t, 6) for tw, t in strips.items()} } ms (the shape rule picks "
          f"{warp_ops.strip_width(h, 3)}); byte bound {b4:.6f} ms, {b4 / warp_ms['shear_warp']:.1%} of "
          f"the fused kernel's time; on {smi}")
    for fn, line in ((shear_warp, 155), (shear_warp_rowmajor, 52)):
        kernels.append({
            "name": fn.__name__, "route": "cuda",
            "source": "jointpose_torch/csrc/shear_warp.cu",
            "replaces": f"jointpose/ops/warp_pallas.py:{line}",
            "launches": trained["launches"][fn.__name__],
            "max_abs_err": warp_err[fn.__name__],
            "ms": warp_ms[fn.__name__],
            "plain_ms": plain_warp_ms,
            "bound_ms": b4, "bound_by": by4, "library_ms": None,
        })
    # The head-conv tails in bf16, the served path's type, over the
    # tensor-core peak of the input type (fc.tail_cost).
    x_ops = tail_args["fft_conv_tail_kdft", torch.bfloat16]
    plain_tail_ms = {
        fn: time_ms(lambda fn=fn, a=a: fn(*a), runs=5, per_graph=1)
        for fn, a in ((fc.tail_kdft_plain, x_ops),
                      (fc.tail_kf_plain, tail_args["fft_conv_tail_kf", torch.bfloat16]))
    }
    # The build form's ring version and its register-staged version in turns
    # (register-staged, ring, ring, register-staged) at serving batch 8
    # through the resident entry and at training batch 32 through the
    # batch-tiled one; the K_f-from-memory entry, whose kernel this change
    # leaves as it was, beside them.
    x8 = tail_args["fft_conv_tail_kdft_resident", torch.bfloat16]
    ring_turns = {
        8: [time_ms(lambda f=f: f(*x8)) for f in (fc.tail_kdft_regstaged, fc.tail_kdft_resident,
                                                  fc.tail_kdft_resident, fc.tail_kdft_regstaged)],
        tb: [time_ms(lambda f=f: f(*tail32_args)) for f in (fc.tail_kdft_regstaged, fc.tail_kdft,
                                                             fc.tail_kdft, fc.tail_kdft_regstaged)],
    }
    kf_ms = time_ms(lambda: fc.tail_kf(*tail_args["fft_conv_tail_kf", torch.bfloat16]))
    bound32 = bound(*fc.tail_cost(*tail32_args, True), BF16_FLOPS_PER_S)
    for batch, turns in ring_turns.items():
        ring_ms, reg_ms = min(turns[1], turns[2]), min(turns[0], turns[3])
        bt = bound32[0] if batch == tb else None
        print(f"time the build form at batch {batch} in turns, register-staged / ring / ring / "
              f"register-staged: {' / '.join(f'{t:.6f}' for t in turns)} ms; ring {ring_ms:.6f} ms "
              f"against {reg_ms:.6f} ({ring_ms / reg_ms:.3f} of it)"
              + (f"; byte bound at batch {tb} {bt:.6f} ms ({bt / ring_ms:.1%})" if bt else "")
              + f"; fft_conv_tail_kf {kf_ms:.6f} ms; on {smi}")
    for (name, fn), line in zip(tails.items(), (478, 307, 284)):
        args = tail_args[name, torch.bfloat16]
        built = fn is not fc.tail_kf
        bt, bby = bound(*fc.tail_cost(*args, built), BF16_FLOPS_PER_S)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "jointpose_torch/csrc/fft_conv_tail.cu",
            "replaces": f"jointpose/ops/fft_conv.py:{line}",
            "launches": tail_launches[name],
            "max_abs_err": conv_tail_err[name, torch.bfloat16][1],
            "ms": (min(ring_turns[8][1], ring_turns[8][2]) if fn is fc.tail_kdft_resident
                   else kf_ms if fn is fc.tail_kf else time_ms(lambda fn=fn, args=args: fn(*args))),
            "plain_ms": plain_tail_ms[fc.tail_kdft_plain if built else fc.tail_kf_plain],
            "bound_ms": bt, "bound_by": bby, "library_ms": None,
        })
        f32_ms = time_ms(lambda fn=fn, a=tail_args[name, torch.float32]: fn(*a), runs=10, per_graph=2)
        print(f"time {name} in f32 (not the served type): {f32_ms:.4f} ms on the device, on {smi}")
    # The path's yardstick: the whole Fourier conv beside cuDNN's direct one
    # for the same head (one PyTorch call), bf16 (TF32 plays no part), and
    # served joint with either head, at batch 1, 8, 16 and 32.
    oihw16 = hkernel.permute(3, 2, 0, 1).bfloat16().contiguous()
    flops_direct, flops_fourier = fc.fourier_conv_flops((jh, jw), (kk, kk), ci, co)
    nph = tail_args["fft_conv_tail_kdft", torch.bfloat16][0].shape[1]
    yardstick = {}
    for batch in (1, BATCH, 16, tb):
        fb = torch.randn(batch, jh, jw, ci, generator=gen).relu().cuda().bfloat16()
        nchw = fb.permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            fft_ms = time_ms(lambda fb=fb: fc.fft_conv2d(fb, hkernel))
            direct_ms = time_ms(lambda nchw=nchw: torch.nn.functional.conv2d(nchw, oihw16,
                                                                             padding=kk // 2))
        route = fc.select_tail(nph, batch, kk, 2)
        body = fc.tail_body(route, nph, batch, ci, co, kk, jh, 2)
        p50 = {head: serve(joint.replace(detector=dataclasses.replace(joint.detector,
                                                                      head_conv_impl=head)),
                           seed=1, counters=counters, batch=batch)["p50_ms"]
               for head in ("fft", "direct")}
        yardstick[batch] = {"fft_conv2d_ms": fft_ms, "cudnn_ms": direct_ms, "tail": route,
                            "body": body, "served_p50_ms": p50}
        print(f"yardstick, paper head {kk}x{kk}x{ci}->{co} at {jh}x{jw}, bf16, batch {batch}: "
              f"fft_conv2d {fft_ms:.4f} ms (tail {route}, {body}), F.conv2d (cuDNN) "
              f"{direct_ms:.4f} ms, ratio {fft_ms / direct_ms:.3f}; per image "
              f"{flops_fourier / 1e9:.2f} GFLOP Fourier against {flops_direct / 1e9:.2f} direct; "
              f"served joint p50 {p50['fft']:.3f} ms/request with 'fft' against "
              f"{p50['direct']:.3f} with 'direct', on {smi}")
        del fb, nchw
    print(f"yardstick {json.dumps(yardstick)}")
    eager = {
        **{name: call_ms(lambda fn=fn, a=tail_args[name, torch.bfloat16]: fn(*a))
           for name, fn in tails.items()},
        "mrf_epilogue": call_ms(lambda: mrf_epilogue(resp1, bias1)),
        "mrf_epilogue_bwd": call_ms(lambda: mrf_epilogue_bwd(resp3, bias1, g3)),
        "mrf_fft_tail": call_ms(lambda: fused_tail(pf, kf, tables, bias2)),
        "mrf_fft_tail_1pass": call_ms(lambda: fused_tail(pf, kf, tables, bias2, precision="default")),
        "shear_warp": call_ms(lambda: shear_warp(images, a_inv, b_inv)),
        "shear_warp_rowmajor": call_ms(lambda: shear_warp_rowmajor(images, a_inv, b_inv)),
    }
    per = {"mrf_fft_tail": (REQUESTS, "request (joint serving)"),
           "mrf_fft_tail_1pass": (served_default["dispatches"],
                                  "dispatch (joint serving at 'default')"),
           "fft_conv_tail_kdft_resident": (REQUESTS, "request (joint serving, 'fft' head)"),
           "fft_conv_tail_kdft": (1, "request (joint serving, 'fft' head, steered)"),
           "fft_conv_tail_kf": (1, "request (joint serving, 'fft' head, steered)")}
    for kn in kernels:
        n, unit = per.get(kn["name"], (TRAIN_STEPS, "step (flagship training)"))
        print(f"time {kn['name']}: {kn['ms']:.4f} ms on the device, {eager[kn['name']]:.4f} ms "
              f"per eager call (plain {kn['plain_ms']:.4f} ms, "
              f"bound {kn['bound_ms']:.4f} ms by {kn['bound_by']}, launches per {unit} "
              f"{kn['launches'] / n:g}); no single PyTorch call computes it, "
              f"so library_ms is null")
    tail_row = next(kn for kn in kernels if kn["name"] == "mrf_fft_tail")
    print(f"mrf_fft_tail runs at {tail_row['bound_ms'] / tail_row['ms']:.1%} of its bound "
          f"({flops2 / 1e9:.3f} GFLOP rows first; bytes {t_bytes2:.4f} ms, fp32 CUDA cores "
          f"{flops2 / FP32_FLOPS_PER_S * 1e3:.4f} ms, 3xTF32 {3 * flops2 / TF32_FLOPS_PER_S * 1e3:.4f} "
          f"ms), mrf_epilogue_bwd at {b3 / kernels[1]['ms']:.1%} of its")
    check(tail_row["bound_ms"] <= tail_row["ms"], "mrf_fft_tail beats its bound: the bound is wrong")
    one_row = next(kn for kn in kernels if kn["name"] == "mrf_fft_tail_1pass")
    print(f"mrf_fft_tail in turns, 3xTF32 / one pass / one pass / 3xTF32: "
          f"{' / '.join(f'{t:.6f}' for t in tail_turns)} ms; the single pass runs at "
          f"{one_row['bound_ms'] / one_row['ms']:.1%} of its bound (TF32 "
          f"{flops2 / TF32_FLOPS_PER_S * 1e3:.4f} ms, bytes {t_bytes2:.4f} ms); its plain version "
          f"with TF32 products {plain_tf32_ms:.4f} ms; on {smi}")
    check(one_row["bound_ms"] <= one_row["ms"], "mrf_fft_tail_1pass beats its bound: the bound is wrong")
    print("shear_warp_rowmajor is the reference's cross-orientation oracle: no preset's path "
          "launches it, so its main-path count is 0; it ran in its parity phase above")
    print("the plain head-conv tails were timed over 5 replays of 1 call (f32 products on the "
          "widened operands, with K_f and R in device memory)")
    print(f"bounds: HBM {HBM_BYTES_PER_S / 1e12} TB/s, fp32 CUDA-core peak "
          f"{FP32_FLOPS_PER_S / 1e12} TFLOP/s, bf16 tensor-core peak {BF16_FLOPS_PER_S / 1e12} "
          f"TFLOP/s for the bf16 head-conv tails, TF32 tensor-core peak "
          f"{TF32_FLOPS_PER_S / 1e12} TFLOP/s at a third for the 3xTF32 MRF tail and in full for "
          f"its single pass (H100 SXM data sheet)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
