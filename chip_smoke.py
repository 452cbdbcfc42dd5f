#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``jointpose_torch``).

    python3 chip_smoke.py [--save-joint FILE] [--joint-reference FILE] [--grouped-corr]
                          [--upsample-log]

``--save-joint`` writes the served ``joint`` coordinates and heatmaps
(phase 3) to an ``.npz``; ``--joint-reference`` compares them with such a
file from another version of the port (same seeds, so same weights and
images) and prints the differences.  ``--grouped-corr`` builds and runs
the MRF grouped correlation's entry of phase 12 alone, ``--upsample-log``
the coarse pass's upsample and unary log's (the two together with both).

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when
the package is missing.  Phases, each fatal on failure:

1. print the card's name and power limit; build every kernel under
   ``jointpose_torch/csrc/`` (one ``nvcc`` per source, all at once);
2. with TF32 off, hold each kernel against its plain PyTorch version on
   the card at its main-path shape: the epilogue forward (serving and
   training batch, bf16 and f32, within a rounding of the plain version,
   which adds the logs one by one; a rerun bit-identical) and backward
   (twice, bit-identical), the fused Fourier MRF tail in both forms,
   3xTF32 and one TF32 pass (on dense unaries and on unaries concentrated
   on a few pixels; the one pass on ``wgmma`` also at batch 32, against
   its arithmetic emulated, also in its own grouping of the sums, a rerun
   bit-identical), both shear-warp entries on a random full augmentation
   draw and on extreme maps (each orientation bit-equal to its strips in
   plain PyTorch, ``ops.warp.shear_warp_strips``), and the three Fourier
   head-conv tails at the paper head (bf16 and f32, and against each
   other; the build form's ring version also at training batch 32);
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
   more steps (``fit`` takes its steps in dispatches of up to 3 there,
   cut at the logs: one CUDA graph each once a stage is warm); then the
   K-step dispatch (``kstep_phase``, two processes of this script with
   ``--kstep-child``): 2 dispatches of 4 joint steps by graph against 8
   eager single steps from one state, bit-equal under deterministic
   algorithms (AdamW; momentum SGD with dispatches of 2), the launches of
   the epilogue forward and backward and the warp 1 a step at replay, a
   CPU-written step-0 checkpoint resumed into the graph form, the step
   time eager and by graph in turns, and ``fit``'s images/s and cost
   records at steps_per_dispatch 1 and 10, with and without
   deterministic algorithms; then ``flagship``'s own MRF path ('auto' ->
   'xla', bf16; ``grouped_vjp_phase``): the grouped conv's hand-written
   backward (``ops.mrf_xla.grouped_conv_f32``) against autograd of the
   fp32-upcast grouped conv at batch 8 and 32, forward and both
   gradients, both backwards timed in turns by graph with the kernels
   each launches, and ``fit`` of ``flagship`` as the preset stands against
   ``mrf.impl='pallas'`` in turns at steps_per_dispatch 10 (the
   Function's backward captured and replayed, the dense forms' FLOPs in
   the joint stage's cost record);
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
   (bit-equal to 'high': its direct conv ignores the flag), and as its
   preset stands ('xla'), with the predictor's call at batch 128 eagerly
   and by its CUDA graph in turns; then ``python
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
11. the parallel phase (``parallel_phase``): worlds of 1, 2 and 4 ranks on
   ``cuda:0`` through ``python -m torch.distributed.run`` (gloo: the ranks
   share the card; each rank is this script with ``--parallel-child``),
   under deterministic algorithms: one joint step of ``flagship`` with
   ``mrf.impl='pallas'`` in fp32 at global batch 32 on one device, over
   data 2 and over data 2 x model 2, held against each other (loss,
   gradients, parameters with PyTorch's convolutions; loss and gradients
   with cuDNN's); a data-2 ``fit`` (3 + 3 steps, evals) whose rank-0
   checkpoint a one-device predictor restores; ``joint`` under tensor
   parallelism (model 2 and 4: the MRF at 'high' and 'default' and its
   gradients against the unsharded pass, the Fourier head against the
   unsliced one; each sharded forward counted alone on every rank, one
   launch of its kernel at the shard-local operands); spatial parallelism
   in the 4-rank world (the trunk's rows over model 2): the 2x2 spatial
   step against the one-device step at the same bars, every trunk
   parameter summed over 'model', ``joint``'s spatial forward in fp32 at
   'high' and 'default' against the unsharded model, a spatial ``fit`` (2 +
   2 steps) whose rank-0 checkpoint a one-device predictor restores, and
   the step time a rank and the trunk's device time with and without
   spatial; on several cards the ranks take a card each (nccl); then in
   this process the inference meshes (``inference_mesh_phase``: the
   device-mesh predictor of ``joint`` over 2x2 against one device,
   ``PoseService(mesh=)``, ``predict.main --mesh-data 2 --mesh-model 2`` as
   a process and ``evaluate.main --mesh-model 2`` under
   ``torch.distributed.run``), the pipelined
   predictor of ``joint`` on ``[cuda:0, cuda:0]`` (on several cards split
   over them; n_micro 2 and 4, with and without TTA) against
   ``build_predictor``, with its p50, and rows 1, 2, 3, 3',
   4, 6 and 7 at the shard-local shapes against their plain versions,
   timed (``shard_kernel_checks``); each world's launch counts are read
   from its ranks; then the K-step dispatch over an nccl mesh, a card a
   rank (``nccl_kstep_phase``, worlds of this script with
   ``--nccl-kstep-child`` under ``python -m torch.distributed.run``; on
   one card it prints one line and runs nothing): on every rank of data 4,
   2x2 and 2x2 spatial, 2 dispatches of 4 by graph, their collectives
   captured, bit-equal to 8 eager single steps under deterministic
   algorithms, the launches 1 a step, every process group of the capture
   warmed by an eager collective; a rank's step time eager and by graph
   in turns and ``fit``'s images/s at steps_per_dispatch 1 and 10 over
   data 1, 2 and 4 and 2x2, over data 4 also for ``flagship`` as the
   preset stands ('xla'); then the operations entry points over an nccl
   mesh of four cards (``nccl_ops_phase``; on fewer it prints one line and
   runs nothing): ``train.main`` as its CLI over data 4, 2x2 and 2x2
   spatial, resumed with a profiled window read rank by rank, and the
   supervised group (``python -m jointpose_torch.resilience
   --nproc-per-node 4``) through a fault, a SIGTERM and a hang of a rank,
   bit-equal to an unbroken run, with its time to recover;
12. time each kernel and its plain version at the main-path shape: the
   two forms of the Fourier MRF tail in turns, the one pass on ``wgmma``
   at batch 8 and 32 (and at the shard-local Kv 5 and 3 in the parallel
   phase), each orientation's shear warp (and the kernel's strip widths),
   the head-conv tail's ring version at batch 8 and 32;
   then the Fourier head against cuDNN and served ``joint`` with either
   head at batch 1, 8, 16 and 32; then ``flagship``'s MRF grouped
   correlation (``grouped_corr_phase``) at batch 32 and 128 against its
   plain version, bit-repeatable, in turns with cuDNN's grouped fprop, and
   its launches in a served ``flagship`` batch; then the coarse pass's
   upsample and unary log (``upsample_log_phase``): forward at batch 128
   and 32, backward at 32, against the composition it replaced and in
   turns with it, and its launches in served ``flagship`` batches.  The
   int8 detector is timed in phase 9, against the bf16 cuDNN detector in
   turns, with each conv's im2col and ``torch._int_mm``.

The last lines are the card's ``nvidia-smi`` line, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
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
# where the plain version adds nine rounded logs: a rounding of the result
# apart (measured 2.1e-7 against a kernel that added them one by one),
# max|kernel - plain| / max|plain|.
EPILOGUE_PRODUCT_RTOL = 1e-6
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


# The K-step dispatch's size in the bit-equality check, and in its timing
# (the default steps_per_dispatch).
KSTEP_K = 4
KSTEP_TIMED_K = 10
# A stage's cost record in fit's metrics.
COST_KEYS = ("train_step_gflops_per_image", "train_step_mb_per_image", "roofline_images_per_sec")


def _opt_tensors(state) -> list[torch.Tensor]:
    return [v for p in state.model.parameters() for v in state.optimizer.state[p].values()
            if torch.is_tensor(v)]


def _same_state(a, b) -> bool:
    """Bit-equal parameters, optimizer state, step and generator state."""
    return (a.step == b.step
            and all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
            and all(torch.equal(u, v) for u, v in zip(_opt_tensors(a), _opt_tensors(b)))
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


def _step_turns(cfg, train_ds, indices, eager, graphed, first: int, mesh=None) -> dict:
    """A joint step's time with its batch generated, in turns: KSTEP_TIMED_K
    single eager steps of ``eager`` against one dispatch of KSTEP_TIMED_K by
    graph of ``graphed`` (whose joint stage is warm), eager / graph / graph
    / eager, each turn in ms a step; the dispatch that captures (and
    replays once) is timed apart, before the turns.  Steps from ``first``;
    over ``mesh`` the ranks start each turn together."""
    from jointpose_torch.train import make_train_multistep, make_train_step

    step = make_train_step(cfg, "joint", mesh)
    multi = make_train_multistep(cfg, "joint", train_ds.get_batch, KSTEP_TIMED_K, mesh)

    def together(fn) -> float:
        torch.cuda.synchronize()
        if mesh is not None:
            mesh.any(False)
        return timed_ms(fn)

    t_capture = together(lambda: multi(graphed, indices(first, KSTEP_TIMED_K)))
    first += KSTEP_TIMED_K

    def eager_steps() -> None:
        for s in range(first, first + KSTEP_TIMED_K):
            step(eager, train_ds.get_batch(indices(s, 1)[0]))

    def graph_dispatch() -> None:
        multi(graphed, indices(first, KSTEP_TIMED_K))

    turns = [together(fn) / KSTEP_TIMED_K
             for fn in (eager_steps, graph_dispatch, graph_dispatch, eager_steps)]
    return {"eager": min(turns[0], turns[3]), "graph": min(turns[1], turns[2]), "turns": turns,
            "capture_and_first_replay_ms": t_capture}


def _fit_rates(cfg, root: str, counters: dict, device=None, lead: bool = True,
               sizes=(1, KSTEP_TIMED_K)) -> dict:
    """``fit`` of ``cfg`` (30 + 30 steps, logs every 10) at each
    steps_per_dispatch of ``sizes``, under ``root``: for each size this
    process's launches and captures, and on the ``lead`` rank (the one
    that writes the metrics) the logged images/s of each stage and the
    per-stage cost records.  The launches (the epilogue's only where the
    config's MRF takes it) and the cost records are held."""
    import jointpose_torch.train as train_mod
    from jointpose_torch.models.mrf import select_impl

    captures = []
    capture = train_mod.DispatchGraphs._capture

    def counted(self, *args):
        entry = capture(self, *args)
        captures.append(1)
        return entry

    det = joint = 30
    epilogue = select_impl(cfg.mrf) == "pallas"
    out: dict = {}
    train_mod.DispatchGraphs._capture = counted
    try:
        for k in sizes:
            c = cfg.replace(train=dataclasses.replace(cfg.train, detector_steps=det,
                                                      joint_steps=joint, log_every=10,
                                                      eval_every=det + joint,
                                                      steps_per_dispatch=k))
            workdir = os.path.join(root, f"fit_{k}")
            reset(counters)
            captures.clear()
            result = train_mod.fit(c, workdir, eval_max_batches=1, device=device)
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            want = {"shear_warp": det + joint, "mrf_epilogue_bwd": joint * epilogue,
                    "mrf_epilogue": (joint + 1) * epilogue}
            check(result.state.step == det + joint
                  and all(launches[n] == v for n, v in want.items()),
                  f"fit at steps_per_dispatch {k} ended at step {result.state.step} with "
                  f"launches {launches}, not {want}")
            res = {"launches": launches, "captured": len(captures)}
            if lead:
                records = read_records(workdir)
                res["costs"] = [(r["step"], r["stage"], r["steps_per_dispatch"]) for r in records
                                if "roofline_images_per_sec" in r]
                check(res["costs"] == [(0, "detector", k), (det, "joint", k)],
                      f"fit at steps_per_dispatch {k} logged stage costs {res['costs']}")
                res["cost_records"] = {
                    r["stage"]: {key: r[key] for key in COST_KEYS}
                    for r in records if "roofline_images_per_sec" in r}
                res["rates"] = {stage: [r["images_per_sec"] for r in records
                                        if r.get("stage") == stage and "images_per_sec" in r]
                                for stage in ("detector", "joint")}
            out[k] = res
            del result
            torch.cuda.empty_cache()
    finally:
        train_mod.DispatchGraphs._capture = capture
    return out


def kstep_child(mode: str) -> None:
    """One process of the kstep phase (``kstep_phase``): the K-step dispatch
    of ``flagship`` with ``mrf.impl='pallas'`` at full width (batch 32,
    240x360, the synthetic source on the card, augmentation on), ``mode``
    'deterministic' (PyTorch's deterministic algorithms, set before any
    work on the card; the parent sets CUBLAS_WORKSPACE_CONFIG) or 'default'.

    From two states made alike: one warm-up dispatch of KSTEP_K steps (the
    stage's first, eager by rule) against KSTEP_K single steps, then 2
    dispatches by graph against 2 x KSTEP_K eager single steps, the launch
    counts of the graph dispatches read; under 'deterministic' the two
    ends must be bit-equal (parameters, AdamW's state, the generator, the
    last metrics), and the same for momentum SGD (fused, tensor lr) with
    dispatches of 2.  Then the step time in turns (``_step_turns``) and
    ``fit`` at steps_per_dispatch 1 and KSTEP_TIMED_K (``_fit_rates``).
    Prints one line ``kstep {json}``."""
    deterministic = mode == "deterministic"
    if deterministic:
        torch.use_deterministic_algorithms(True)
    from jointpose_torch import get_config
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.train import create_state, fit, make_train_multistep, make_train_step

    flag = get_config("flagship")
    cfg = flag.replace(mrf=dataclasses.replace(flag.mrf, impl="pallas"))
    tb = cfg.train.batch_size
    check(cfg.augment.enabled and cfg.augment.warp_impl == "shear" and tb == 32
          and cfg.data.image_hw == (240, 360) and cfg.data.source == "synthetic"
          and cfg.train.optimizer == "adamw", "the kstep phase is not flagship at full width")
    counters = kernel_counters()
    train_ds, _ = make_dataset(cfg.data)

    def indices(first: int, n: int) -> np.ndarray:
        return np.stack([np.arange(s * tb, (s + 1) * tb) % train_ds.size
                         for s in range(first, first + n)])

    result: dict = {"mode": mode}
    for optimizer, k in (("adamw", KSTEP_K), ("momentum", 2)):
        c = cfg.replace(train=dataclasses.replace(cfg.train, optimizer=optimizer))
        step = make_train_step(c, "joint")
        multi = make_train_multistep(c, "joint", train_ds.get_batch, k)
        eager = create_state(c, torch.Generator().manual_seed(7))
        graphed = create_state(c, torch.Generator().manual_seed(7))
        graphed, _ = multi(graphed, indices(0, k))  # the stage's first dispatch: eager
        for s in range(k):
            eager, _ = step(eager, train_ds.get_batch(indices(s, 1)[0]))
        torch.cuda.synchronize()
        check(not graphed.graphs.graphs, "the stage's first dispatch was captured")
        reset(counters)
        for first in (k, 2 * k):
            graphed, got = multi(graphed, indices(first, k))
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        for s in range(k, 3 * k):
            eager, want = step(eager, train_ds.get_batch(indices(s, 1)[0]))
        torch.cuda.synchronize()
        check(len(graphed.graphs.graphs) == 1, f"{optimizer}: no graph was captured")
        per_step = {"shear_warp": 1, "mrf_epilogue": 1, "mrf_epilogue_bwd": 1}
        want_launches = {name: 2 * k * per_step.get(name, 0) for name in counters}
        check(launches == want_launches,
              f"{optimizer}: the graph dispatches launched {launches}, not {want_launches}")
        same = _same_state(graphed, eager) and all(torch.equal(got[n], want[n]) for n in want)
        worst = max(rel_err(p, q)[0] for p, q in zip(graphed.model.parameters(),
                                                     eager.model.parameters()))
        print(f"kstep {optimizer} ({mode} algorithms): 2 dispatches of {k} steps by graph against "
              f"{2 * k} eager single steps from one state: "
              f"{'bit-equal' if same else 'NOT bit-equal'} (parameters, optimizer state, generator, "
              f"step, last metrics; worst parameter rel err {worst:.3e}); launches of the graph "
              f"dispatches {launches}")
        if deterministic:
            check(same, f"{optimizer}: the graph form is not bit-equal to eager single steps")
        result[optimizer] = {"bit_equal": same, "worst_rel_err": worst, "launches": launches}
        if optimizer == "adamw":
            timed_eager, timed_graph = eager, graphed
        del eager, graphed

    # The step time, single eager steps against dispatches by graph, in turns.
    turns = result["step_ms"] = _step_turns(cfg, train_ds, indices, timed_eager, timed_graph,
                                            3 * KSTEP_K)
    print(f"kstep step time ({mode} algorithms), flagship batch {tb} with its batch generated, in "
          f"turns eager / graph / graph / eager: "
          f"{' / '.join(f'{t:.3f}' for t in turns['turns'])} ms a step (dispatches of "
          f"{KSTEP_TIMED_K}); capture and first replay {turns['capture_and_first_replay_ms']:.1f} ms")
    del timed_eager, timed_graph
    torch.cuda.empty_cache()

    if deterministic:
        # A step-0 checkpoint written on the CPU, as tools/orbax_to_torch.py
        # writes it, resumes on the card: the CPU's optimizer state dict
        # (float rates, not capturable) loaded into the card's, then graphs.
        from jointpose_torch.convert import write_initial_checkpoint
        from jointpose_torch.predict import init_state_dict

        c = cfg.replace(train=dataclasses.replace(cfg.train, detector_steps=12, joint_steps=0,
                                                  log_every=4, eval_every=12, steps_per_dispatch=4))
        with tempfile.TemporaryDirectory() as workdir:
            write_initial_checkpoint(c, os.path.join(workdir, c.train.checkpoint_dir),
                                     init_state_dict(c, torch.Generator().manual_seed(9)))
            resumed = fit(c, workdir, eval_max_batches=1, resume=True)
        groups = resumed.state.optimizer.param_groups
        check(resumed.state.step == 12 and len(resumed.state.graphs.graphs) == 1
              and all(torch.is_tensor(g["lr"]) and g["capturable"] for g in groups)
              and all(bool(torch.isfinite(p).all()) for p in resumed.state.model.parameters()),
              "a CPU-written step-0 checkpoint did not resume into the graph form on the card")
        print("kstep: a step-0 checkpoint written on the CPU resumed on the card, 12 steps in "
              "dispatches of 4 (the last two by graph), the optimizer's rates tensors again")
        del resumed

    # fit at steps_per_dispatch 1 and KSTEP_TIMED_K: the logged images/s.
    with tempfile.TemporaryDirectory() as root:
        result["fit"] = _fit_rates(cfg, root, counters)
    for k, f in result["fit"].items():
        print(f"kstep fit ({mode} algorithms) at steps_per_dispatch {k}: images/s per log interval "
              f"of 10 steps, detector {[round(x, 1) for x in f['rates']['detector']]}, joint "
              f"{[round(x, 1) for x in f['rates']['joint']]} (each stage's first interval holds its "
              f"warm-up, the second its capture); stage cost records {f['costs']}; launches "
              f"{f['launches']}")
    print("kstep " + json.dumps(result))


def kstep_phase(smi: str) -> dict:
    """The K-step dispatch on the card (``kstep_child``), once under
    deterministic algorithms and once with PyTorch's defaults, each in a
    process of its own."""
    results = {}
    for mode, env in (("deterministic", {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}), ("default", {})):
        out, secs = _child([os.path.abspath(__file__), "--kstep-child", mode],
                           f"the kstep child ({mode})", env=env)
        print(out, end="")
        line = next(x for x in out.splitlines() if x.startswith("kstep {"))
        results[mode] = json.loads(line[len("kstep "):])
        print(f"kstep child ({mode} algorithms) took {secs:.1f} s; on {smi}")
    d, f = ({k: v["rates"] for k, v in results[mode]["fit"].items()}
            for mode in ("deterministic", "default"))
    print(f"kstep: fit's last logged interval of each stage, images/s, deterministic / default "
          f"algorithms: steps_per_dispatch 1 detector {d['1']['detector'][-1]:.1f} / "
          f"{f['1']['detector'][-1]:.1f}, joint {d['1']['joint'][-1]:.1f} / "
          f"{f['1']['joint'][-1]:.1f}; steps_per_dispatch {KSTEP_TIMED_K} detector "
          f"{d[str(KSTEP_TIMED_K)]['detector'][-1]:.1f} / {f[str(KSTEP_TIMED_K)]['detector'][-1]:.1f}, "
          f"joint {d[str(KSTEP_TIMED_K)]['joint'][-1]:.1f} / {f[str(KSTEP_TIMED_K)]['joint'][-1]:.1f}; "
          f"on {smi}")
    return results


# The MRF's grouped correlation (csrc/mrf_grouped_corr.cu) against the fp32
# conv of the same bf16 values with TF32 off: both products exact, the fp32
# sums of 425 of them in another order.
GROUPED_CORR_RTOL = 1e-5


def grouped_corr_phase(smi: str) -> dict:
    """The forward of ``flagship``'s MRF conv on the card: the hand-written
    grouped correlation (``ops.mrf_corr.mrf_grouped_corr``) at the coarse
    grid (30x45, Kv = Ka = 9, 17x25, bf16 operands, fp32 out), batch 32 and
    128: against its plain version (fp32 conv, TF32 off), twice bit for bit,
    then timed by CUDA-graph replays in turns with cuDNN's grouped fprop as
    the path called it before (``grouped_conv`` with fp32 out, TF32 on: the
    library's time), beside its bound and the plain version's time; and its
    launches in a served ``flagship`` batch.  Returns the kernels line's
    entry, with the batch-32 numbers under ``batch32``."""
    import jointpose_torch.ops.mrf_xla as mx
    from jointpose_torch import get_config
    from jointpose_torch.ops import mrf_corr as mc

    flag = get_config("flagship")
    k, (wh, ww) = flag.num_joints, flag.mrf.window
    ch, cw = (n // flag.mrf.stride for n in flag.heatmap_hw)
    gen = torch.Generator().manual_seed(21)
    kernels, _ = mrf_params(gen, flag.mrf.window, k)
    kern = kernels.reshape(wh, ww, 1, k * k).bfloat16()
    rows = {}
    for batch in (flag.train.batch_size, 128):
        # The coarse pass's input: sums of 2x2 probabilities, in bf16.
        p = (4 * unaries(gen, batch, ch, cw, k, torch.float32)).bfloat16()
        got = mc.mrf_grouped_corr(p, kern, k)
        again = mc.mrf_grouped_corr(p, kern, k)
        want = mc.mrf_grouped_corr_plain(p, kern, k)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        check(torch.equal(got, again), f"mrf_grouped_corr at batch {batch}: two calls differ")
        check(err[0] <= GROUPED_CORR_RTOL,
              f"mrf_grouped_corr at batch {batch} disagrees with its plain version: {err}")

        def library():
            mx.grouped_conv(p, kern, k, torch.float32)

        torch.backends.cudnn.allow_tf32 = True
        try:
            turns = [time_ms(fn, runs=10, per_graph=2) if fn is library else time_ms(fn)
                     for fn in (library, lambda: mc.mrf_grouped_corr(p, kern, k),
                                lambda: mc.mrf_grouped_corr(p, kern, k), library)]
        finally:
            torch.backends.cudnn.allow_tf32 = False
        plain_ms = time_ms(lambda: mc.mrf_grouped_corr_plain(p, kern, k), runs=10, per_graph=2)
        n_bytes, n_ops = mc.corr_cost(p, kern, k)
        b_ms, by = bound(n_bytes, n_ops, BF16_FLOPS_PER_S)
        ms, library_ms = min(turns[1], turns[2]), min(turns[0], turns[3])
        rows[batch] = {"ms": ms, "library_ms": library_ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": by, "max_rel_err": err[0],
                       "max_abs_err": err[1], "turns_ms": turns,
                       "tiling": mc.tiling(ch, k, k, wh, ww)}
        print(f"mrf_grouped_corr at batch {batch} (p {tuple(p.shape)} bf16, kernels "
              f"{tuple(kern.shape)} bf16, fp32 out; tiling (mt, kcc, dyc) {rows[batch]['tiling']}): "
              f"against the fp32 conv of the same values, TF32 off, rel err / max abs "
              f"{err[0]:.3e} / {err[1]:.3e} (limit {GROUPED_CORR_RTOL:g}); two calls bit-identical; "
              f"CUDA-graph replays in turns, cuDNN's grouped fprop (TF32) / kernel / kernel / cuDNN: "
              f"{' / '.join(f'{t:.6f}' for t in turns)} ms; kernel {ms:.6f} ms, "
              f"{library_ms / ms:.1f}x faster than cuDNN, bound {b_ms:.6f} ms by {by} "
              f"({b_ms / ms:.1%} of it; {n_ops / 1e9:.3f} GFLOP at {n_ops / ms / 1e9:.1f} TFLOP/s); "
              f"plain {plain_ms:.6f} ms; on {smi}")
        check(b_ms <= ms, "mrf_grouped_corr beats its bound: the bound is wrong")
        del p, got, again, want
    served = serve(flag, seed=3, counters={"mrf_grouped_corr": mc.mrf_grouped_corr}, requests=2,
                   batch=BATCH)
    launches = served["launches"]["mrf_grouped_corr"]
    print(f"mrf_grouped_corr launches in 2 served batches of {BATCH} of flagship as the preset "
          f"stands: {launches}")
    check(launches == 2, f"served flagship launched mrf_grouped_corr {launches} times in 2 batches")
    top = rows[128]
    return {"name": "mrf_grouped_corr", "route": "cuda",
            "source": "jointpose_torch/csrc/mrf_grouped_corr.cu",
            "replaces": None, "launches": launches,
            "max_abs_err": top["max_abs_err"], "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "batch32": rows[flag.train.batch_size]}


# The coarse pass's upsample and unary log (csrc/mrf_upsample.cu) against
# the composition it replaced, PyTorch's kernels on the card: the same taps,
# weights and order of operations, and nvcc contracts the products into
# fused multiply-adds as PyTorch's build does: bit-equal.  Its coarse
# gradient sums the terms of PyTorch's atomics in another order.
UPSAMPLE_GRAD_RTOL = 1e-5


def fp32_ulps(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int]:
    """(largest distance in fp32 units in the last place, values that differ)."""
    def ordered(t):
        i = t.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (ordered(got) - ordered(want)).abs()
    return int(d.max().item()), int((d > 0).sum().item())


def upsample_log_phase(smi: str) -> dict:
    """The last step of ``flagship``'s coarse MRF pass on the card
    (``ops.mrf_upsample.mrf_upsample_log``): coarse log-messages (B, 30, 45,
    9) fp32 upsampled to the bf16 unaries' 60x90 and added to their log.
    The forward at batch 128 and 32 and the backward at 32 against the plain
    version, the composition the path ran before (``F.interpolate``, clamp,
    log and add, and autograd's backward of it: the library's time, so the
    plain and library times are one number), each twice bit for bit; then
    timed by CUDA-graph replays in turns with it, beside the byte bound; and
    its launches in 2 served ``flagship`` batches.  Returns the kernels
    line's entry, the batch-32 numbers under ``batch32`` and the backward's
    under ``backward32``."""
    from jointpose_torch import get_config
    from jointpose_torch.ops import mrf_upsample as mu

    flag = get_config("flagship")
    k, s, eps = flag.num_joints, flag.mrf.stride, flag.mrf.eps
    ch, cw = (n // s for n in flag.heatmap_hw)
    gen = torch.Generator().manual_seed(23)
    rows = {}
    for batch in (128, flag.train.batch_size):
        coarse = (4 * torch.randn(batch, ch, cw, k, generator=gen) - 30).cuda()
        p = unaries(gen, batch, ch * s, cw * s, k, torch.bfloat16)
        got = mu.mrf_upsample_log(coarse, p, eps)
        again = mu.mrf_upsample_log(coarse, p, eps)
        want = mu.mrf_upsample_log_plain(coarse, p, eps)
        torch.cuda.synchronize()
        ulps, differ = fp32_ulps(got, want)
        check(torch.equal(got, again), f"mrf_upsample_log at batch {batch}: two calls differ")
        check(ulps == 0, f"mrf_upsample_log at batch {batch} is {ulps} ulps from the composition")

        def kernel():
            mu.mrf_upsample_log(coarse, p, eps)

        def library():
            mu.mrf_upsample_log_plain(coarse, p, eps)

        turns = [time_ms(fn) for fn in (library, kernel, kernel, library)]
        n_bytes, n_ops = mu.fwd_cost(coarse, p)
        b_ms, by = bound(n_bytes, n_ops)
        ms, library_ms = min(turns[1], turns[2]), min(turns[0], turns[3])
        rows[batch] = {"ms": ms, "library_ms": library_ms, "plain_ms": library_ms,
                       "bound_ms": b_ms, "bound_by": by, "max_ulps": ulps, "values_differing": differ,
                       "bit_equal": ulps == 0, "turns_ms": turns}
        print(f"mrf_upsample_log at batch {batch} (coarse {tuple(coarse.shape)} fp32, p "
              f"{tuple(p.shape)} bf16, fp32 out): against the composition, {ulps} ulps at most, "
              f"{differ} of {got.numel()} values differ; two calls bit-identical; CUDA-graph "
              f"replays in turns, composition / kernel / kernel / composition: "
              f"{' / '.join(f'{t:.6f}' for t in turns)} ms; kernel {ms:.6f} ms, "
              f"{library_ms / ms:.1f}x faster, bound {b_ms:.6f} ms by {by} ({b_ms / ms:.1%} of it, "
              f"{n_bytes / ms / 1e6:.0f} GB/s); on {smi}")
        check(b_ms <= ms, "mrf_upsample_log beats its bound: the bound is wrong")
        if batch != flag.train.batch_size:
            continue
        g = torch.randn(p.shape, generator=gen).cuda()
        c_ref, p_ref = coarse.clone().requires_grad_(True), p.clone().requires_grad_(True)

        def library_fb():
            out_ref = mu.mrf_upsample_log_plain(c_ref, p_ref, eps)
            return torch.autograd.grad(out_ref, (c_ref, p_ref), g)

        want_c, want_p = library_fb()
        got_c, got_p = mu.mrf_upsample_log_bwd(g, p, tuple(coarse.shape), eps)
        again = mu.mrf_upsample_log_bwd(g, p, tuple(coarse.shape), eps)
        torch.cuda.synchronize()
        err = rel_err(got_c, want_c)
        check(torch.equal(got_c, again[0]) and torch.equal(got_p, again[1]),
              "mrf_upsample_log_bwd: two calls differ")
        check(err[0] <= UPSAMPLE_GRAD_RTOL and torch.equal(got_p, want_p),
              f"mrf_upsample_log_bwd disagrees with autograd of the composition: dcoarse {err}, "
              f"dp equal {torch.equal(got_p, want_p)}")

        def kernel_bwd():
            mu.mrf_upsample_log_bwd(g, p, tuple(coarse.shape), eps)

        # The composition's backward alone: its forward and backward, by
        # autograd on the capture's stream, less its forward's time above.
        turns = [time_ms(fn) for fn in (library_fb, kernel_bwd, kernel_bwd, library_fb)]
        n_bytes, n_ops = mu.bwd_cost(g, p, coarse.numel())
        b_ms, by = bound(n_bytes, n_ops)
        ms = min(turns[1], turns[2])
        library_ms = min(turns[0], turns[3]) - rows[batch]["library_ms"]
        rows["backward32"] = {"ms": ms, "library_ms": library_ms, "plain_ms": library_ms,
                              "bound_ms": b_ms, "bound_by": by, "dcoarse_rel_err": err[0],
                              "dp_bit_equal": True, "turns_ms": turns}
        print(f"mrf_upsample_log_bwd at batch {batch}: against autograd of the composition, "
              f"dcoarse rel err / max abs {err[0]:.3e} / {err[1]:.3e} (limit "
              f"{UPSAMPLE_GRAD_RTOL:g}), dp bit-equal; two calls bit-identical; CUDA-graph "
              f"replays in turns, the composition's forward and backward / kernel / kernel / "
              f"the same: "
              f"{' / '.join(f'{t:.6f}' for t in turns)} ms; kernel {ms:.6f} ms, "
              f"{library_ms / ms:.1f}x faster than the composition's backward ({library_ms:.6f} "
              f"ms), bound {b_ms:.6f} ms by {by} ({b_ms / ms:.1%} of it); on {smi}")
        check(b_ms <= ms, "mrf_upsample_log_bwd beats its bound: the bound is wrong")
    served = serve(flag, seed=3, counters={"mrf_upsample_log": mu.mrf_upsample_log}, requests=2,
                   batch=BATCH)
    launches = served["launches"]["mrf_upsample_log"]
    print(f"mrf_upsample_log launches in 2 served batches of {BATCH} of flagship as the preset "
          f"stands: {launches}")
    check(launches == 2, f"served flagship launched mrf_upsample_log {launches} times in 2 batches")
    top = rows[128]
    return {"name": "mrf_upsample_log", "route": "cuda",
            "source": "jointpose_torch/csrc/mrf_upsample.cu", "replaces": None,
            "launches": launches, "max_ulps": top["max_ulps"], "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "batch32": rows[flag.train.batch_size],
            "backward32": rows["backward32"]}


# The fp32-output grouped conv's hand-written backward (the reference's
# custom VJP) against autograd of the fp32-upcast grouped conv: the
# former rounds the cotangent to bf16, as the reference does, the latter
# keeps it in fp32 (TF32 in cuDNN's products), and both round their
# gradients to bf16; within a hundredth of the largest gradient.
GROUPED_VJP_RTOL = 1e-2
# fit's joint-stage FLOPs a image, 'xla' against 'pallas': the dense forms'
# extra work as counted, within this share.
GROUPED_VJP_FLOPS_RTOL = 0.05


def grouped_vjp_flops(b: int, h: int, w: int, kv: int, ka: int, wh: int, ww: int) -> dict:
    """FLOPs (2 a multiply-add) of the hand-written backward's convolutions
    at a shape: the space-to-depth dL/dp conv (output width padded to S
    columns a block, nq taps of S columns), the dense-embedded dL/dk, and
    the true grouped work of either gradient."""
    from jointpose_torch.ops.mrf_xla import S2D_WIDTH as s

    nq, wblocks = (ww - 1 + s - 1) // s + 1, -(-w // s)
    grouped = 2 * b * h * w * kv * ka * wh * ww
    return {"dp_s2d": 2 * b * h * wblocks * s * kv * wh * nq * s * kv * ka,
            "dk_dense": grouped * kv, "grouped": grouped}


def grouped_vjp_phase(counters: dict, smi: str) -> dict:
    """``flagship``'s own MRF path ('auto' -> 'xla', bf16): the coarse
    pass's grouped conv through ``ops.mrf_xla.grouped_conv_f32``, whose
    backward is the reference's dense-embedded dL/dk and space-to-depth
    dL/dp.

    At ``flagship``'s shape (30x45 coarse grid, 9 joints, 17x25), batch 8
    and 32, bf16 p and kernels: the forward and both gradients against
    autograd of the fp32-upcast grouped conv (the plain version); the
    backward alone (the Function's against the ``convolution_backward``
    that autograd of the plain version calls) and forward plus backward
    through autograd, each by CUDA-graph replay in turns, with the kernels
    each launches (``devtime``).  Then ``fit`` of ``flagship`` as the
    preset stands against ``mrf.impl='pallas'``, in turns, at
    steps_per_dispatch KSTEP_TIMED_K (one CUDA graph a dispatch): the
    shear warp once a step, the Function's backward captured and replayed,
    each stage's images/s and cost record, the dense forms' FLOPs in the
    count."""
    import jointpose_torch.ops.mrf_xla as mx
    from jointpose_torch import devtime, get_config
    from jointpose_torch.models.mrf import select_impl

    flag = get_config("flagship")
    check(flag.mrf.impl == "auto" and select_impl(flag.mrf) == "xla" and flag.mrf.stride == 2
          and flag.compute_dtype == "bfloat16" and flag.train.batch_size == 32,
          "flagship's MRF is not the bf16 'xla' coarse pass")
    k, (wh, ww) = flag.num_joints, flag.mrf.window
    ch, cw = flag.heatmap_hw[0] // flag.mrf.stride, flag.heatmap_hw[1] // flag.mrf.stride
    gen = torch.Generator().manual_seed(15)
    kernels, _ = mrf_params(gen, flag.mrf.window, k)
    kern = kernels.reshape(wh, ww, 1, k * k).bfloat16()
    result: dict = {"parity": {}, "time": {}, "fit": []}

    def function_conv(a, b):
        return mx.grouped_conv_f32(a, b, k)

    def plain_conv(a, b):
        return mx.grouped_conv(a, b, k, torch.float32)

    for batch in (BATCH, flag.train.batch_size):
        p = unaries(gen, batch, ch, cw, k, torch.bfloat16)
        g = torch.randn(batch, ch, cw, k * k, generator=gen).cuda()

        def vjp(conv):
            a, b = p.clone().requires_grad_(True), kern.clone().requires_grad_(True)
            resp = conv(a, b)
            return (resp, *torch.autograd.grad(resp, (a, b), g))

        got, want = vjp(function_conv), vjp(plain_conv)
        torch.cuda.synchronize()
        check(got[0].dtype == torch.float32 and got[1].dtype == got[2].dtype == torch.bfloat16
              and all(bool(torch.isfinite(t).all()) for t in got),
              f"grouped_conv_f32 at batch {batch}: types or values")
        errs = {name: rel_err(x.float(), y.float())
                for name, x, y in zip(("forward", "dp", "dk"), got, want)}
        result["parity"][batch] = errs
        print(f"grouped_conv_f32 at batch {batch} (p {tuple(p.shape)} bf16, kernels "
              f"{tuple(kern.shape)} bf16, fp32 out): against autograd of the fp32-upcast grouped "
              f"conv, rel err / max abs: "
              + ", ".join(f"{n} {e[0]:.3e} / {e[1]:.3e}" for n, e in errs.items())
              + f" (limit {GROUPED_VJP_RTOL:g} of the largest); on {smi}")
        check(max(e[0] for e in errs.values()) <= GROUPED_VJP_RTOL,
              f"grouped_conv_f32 at batch {batch} disagrees with its plain version")

        # The backward alone: the Function's, and what autograd of the plain
        # version calls (cuDNN's grouped dgrad and wgrad on fp32 operands).
        x32, w32, g4 = mx._nchw(p.float()), kern.float().permute(3, 2, 0, 1), mx._nchw(g)

        def plain_bwd():
            torch.ops.aten.convolution_backward(g4, x32, w32, None, [1, 1], [wh // 2, ww // 2],
                                                [1, 1], False, [0, 0], k, [True, True, False])

        def function_bwd():
            mx.grouped_conv_f32_bwd(g, p, kern, k)

        a, b = p.clone().requires_grad_(True), kern.clone().requires_grad_(True)

        def through_autograd(conv):
            return lambda: torch.autograd.grad(conv(a, b), (a, b), g)

        bwd = [time_ms(fn, runs=20, per_graph=2)
               for fn in (plain_bwd, function_bwd, function_bwd, plain_bwd)]
        both = [time_ms(through_autograd(c), runs=20, per_graph=2)
                for c in (plain_conv, function_conv, function_conv, plain_conv)]
        fwd = time_ms(lambda: plain_conv(p, kern), runs=20, per_graph=2)
        flops = grouped_vjp_flops(batch, ch, cw, k, k, wh, ww)
        ops = {}
        for what, fn in (("plain", plain_bwd), ("function", function_bwd)):
            timing = devtime.measure_device_time(fn, iters=2, warmup=1, program_name=f"bwd_{what}")
            check(timing is not None, f"no device ops in the trace of the {what} backward")
            ops[what] = [[o.name[:100], o.count // 2, round(o.duration_s * 1e3 / 2, 4)]
                         for o in timing.ops]
        t_fn, t_plain = min(bwd[1], bwd[2]), min(bwd[0], bwd[3])
        result["time"][batch] = {"backward_turns_ms": bwd, "fwd_bwd_turns_ms": both,
                                 "forward_ms": fwd, "flops": flops, "kernels": ops,
                                 "dgrad_engine": {w: any("dgrad_engine" in o[0] for o in ops[w])
                                                  for w in ops}}
        dense = flops["dp_s2d"] + flops["dk_dense"]
        print(f"time the MRF conv's backward at batch {batch}, CUDA-graph replays in turns, plain "
              f"(autograd of the fp32-upcast grouped conv: convolution_backward, groups {k}) / "
              f"Function / Function / plain: {' / '.join(f'{t:.4f}' for t in bwd)} ms; forward "
              f"plus backward through autograd in the same order "
              f"{' / '.join(f'{t:.4f}' for t in both)} ms; the forward alone {fwd:.4f} ms; the "
              f"Function's {dense / 1e9:.3f} GFLOP (s2d dp {flops['dp_s2d'] / 1e9:.3f}, dense dk "
              f"{flops['dk_dense'] / 1e9:.3f}) at {dense / t_fn / 1e9:.1f} TFLOP/s, the grouped "
              f"work {2 * flops['grouped'] / 1e9:.3f} GFLOP both ways at "
              f"{2 * flops['grouped'] / t_plain / 1e9:.2f} TFLOP/s by the plain version; on {smi}")
        for what in ops:
            seen = result["time"][batch]["dgrad_engine"][what]
            print(f"kernels of the {what} backward at batch {batch} (name, launches a call, ms a "
                  f"call): {ops[what]}; cuDNN's dgrad_engine "
                  f"{'appears' if seen else 'does not appear'}")
        del p, g, got, want, x32, w32, g4, a, b
    torch.cuda.empty_cache()

    # fit of flagship as the preset stands against mrf.impl='pallas', in
    # turns; the Function's backward calls counted eagerly and under capture.
    pallas = flag.replace(mrf=dataclasses.replace(flag.mrf, impl="pallas"))
    calls = {"eager": 0, "captured": 0}
    plain_fn = mx.grouped_conv_f32_bwd

    def counted(*args, **kwargs):
        calls["captured" if torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return plain_fn(*args, **kwargs)

    mx.grouped_conv_f32_bwd = counted
    try:
        with tempfile.TemporaryDirectory() as root:
            for i, (name, cfg) in enumerate((("pallas", pallas), ("xla", flag), ("xla", flag),
                                             ("pallas", pallas))):
                before = dict(calls)
                res = _fit_rates(cfg, os.path.join(root, str(i)), counters,
                                 sizes=(KSTEP_TIMED_K,))[KSTEP_TIMED_K]
                res["backward_calls"] = {n: calls[n] - before[n] for n in calls}
                res["mrf"] = name
                result["fit"].append(res)
    finally:
        mx.grouped_conv_f32_bwd = plain_fn
    joint_steps = 30
    for res in result["fit"]:
        n = res["backward_calls"]
        if res["mrf"] == "xla":
            check(res["captured"] == 2 and n["captured"] == KSTEP_TIMED_K
                  and n["eager"] + n["captured"] < joint_steps,
                  f"fit of flagship ('xla'): {res['captured']} graphs, the Function's backward "
                  f"called {n}: not captured once and replayed")
        else:
            check(n == {"eager": 0, "captured": 0}, f"fit with mrf.impl='pallas' reached the "
                  f"Function's backward {n}")
        print(f"fit flagship (mrf {res['mrf']}, bf16, batch 32, 30 + 30 steps, steps_per_dispatch "
              f"{KSTEP_TIMED_K} by graph): images/s per log interval of 10 steps, detector "
              f"{[round(x, 1) for x in res['rates']['detector']]}, joint "
              f"{[round(x, 1) for x in res['rates']['joint']]} (each stage's first interval holds "
              f"its warm-up, the second its capture); graphs {res['captured']}; launches "
              f"{ {n: v for n, v in res['launches'].items() if v} }; the Function's backward "
              f"called {n['eager']} times eagerly and {n['captured']} under capture (the other "
              f"joint steps replayed it); cost records {res['cost_records']}; on {smi}")
    turns = [res["rates"]["joint"][-1] for res in result["fit"]]
    rec = {name: next(r["cost_records"]["joint"] for r in result["fit"] if r["mrf"] == name)
           for name in ("pallas", "xla")}
    f1 = grouped_vjp_flops(1, ch, cw, k, k, wh, ww)
    # torch's FLOP counter charges a grouped wgrad as the dense one (it
    # leaves out the groups), so the count adds the s2d conv less the
    # grouped dgrad it replaces.
    extra = (f1["dp_s2d"] - f1["grouped"]) / 1e9
    counted_extra = (rec["xla"]["train_step_gflops_per_image"]
                     - rec["pallas"]["train_step_gflops_per_image"])
    result["joint_turns"] = turns
    print(f"fit flagship, the joint stage's last logged interval in turns pallas / xla / xla / "
          f"pallas: {' / '.join(f'{t:.1f}' for t in turns)} images/s (xla "
          f"{max(turns[1], turns[2]):.1f} against pallas {max(turns[0], turns[3]):.1f}); the joint "
          f"step's count {rec['xla']['train_step_gflops_per_image']:.4f} GFLOP a image on 'xla' "
          f"against {rec['pallas']['train_step_gflops_per_image']:.4f} on 'pallas', "
          f"{counted_extra:.4f} more ({extra:.4f} expected: the s2d dp conv less the grouped "
          f"dgrad); bounds {rec['xla']['roofline_images_per_sec']:.1f} and "
          f"{rec['pallas']['roofline_images_per_sec']:.1f} images/s; on {smi}")
    check(abs(counted_extra - extra) <= GROUPED_VJP_FLOPS_RTOL * extra,
          f"the joint step's FLOP count does not show the dense forms: {counted_extra:.4f} "
          f"GFLOP a image more, {extra:.4f} expected")
    return result


# The nccl_kstep phase's meshes, (data, model, spatial): the bit-equality
# meshes need four cards (with two or three the phase takes data 2), the
# timed ones as many as their size.
NCCL_EQUAL_MESHES = ((4, 1, False), (2, 2, False), (2, 2, True))
NCCL_TIMED_MESHES = ((1, 1, False), (2, 1, False), (4, 1, False), (2, 2, False))


def _mesh_name(data: int, model: int, spatial: bool) -> str:
    return f"{data}x{model}" + ("s" if spatial else "")


def _parse_meshes(names: str) -> list[tuple[int, int, bool]]:
    return [(*(int(x) for x in n.rstrip("s").split("x")), n.endswith("s"))
            for n in names.split(",")]


def nccl_kstep_child(task: str, out: str) -> None:
    """One rank of a world that ``nccl_kstep_phase`` launches through
    ``python -m torch.distributed.run``, a card a rank (nccl): the K-step
    dispatch of ``flagship(mrf.impl='pallas')`` at full width (global batch
    32, 240x360, the synthetic source on the card, augmentation on) over
    each mesh of ``task`` = '<kind>:<mesh>,...', a mesh '<data>x<model>'
    with 's' for spatial, each covering the world.

    'equal' (PyTorch's deterministic algorithms, set before any work on
    the card; the parent sets CUBLAS_WORKSPACE_CONFIG): from two states
    made alike, one warm-up dispatch of KSTEP_K steps (the stage's first,
    eager by rule) against KSTEP_K single steps, then 2 dispatches by graph
    against 2 x KSTEP_K eager single steps, the launch counts of the graph
    dispatches read, and which process groups ran a collective eagerly and
    under the capture; then the same for the preset as it stands ('xla',
    under ``"xla"``).  'time' (PyTorch's defaults): the step time in
    turns (``_step_turns``; over data 4 also for the preset's own MRF,
    'xla'), then ``fit`` at steps_per_dispatch 1 and
    KSTEP_TIMED_K (``_fit_rates``).  Writes
    ``<out>/<kind>_<mesh>_rank<r>.json``."""
    kind, names = task.split(":")
    if kind == "equal":
        torch.use_deterministic_algorithms(True, warn_only=True)
    import torch.distributed as dist

    from jointpose_torch import get_config
    from jointpose_torch.configs import MeshConfig
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.parallel.mesh import (
        init_distributed, make_mesh, shard_state, shutdown_distributed,
    )
    from jointpose_torch.train import (
        create_state, graph_dispatch, make_train_multistep, make_train_step,
    )

    device = init_distributed()
    counters = kernel_counters()
    preset = get_config("flagship")
    flag = preset.replace(mrf=dataclasses.replace(preset.mrf, impl="pallas"))
    tb = flag.train.batch_size
    check(flag.augment.enabled and tb == 32 and flag.data.image_hw == (240, 360)
          and flag.data.source == "synthetic", "the nccl_kstep phase is not flagship at full width")
    train_ds, _ = make_dataset(flag.data, device)
    for data, model, spatial in _parse_meshes(names):
        name = _mesh_name(data, model, spatial)
        cfg = flag.replace(mesh=MeshConfig(data=data, model=model, spatial=spatial))
        mesh = make_mesh(cfg.mesh)
        rows, d = tb // data, mesh.coords["data"]

        def indices(first: int, n: int) -> np.ndarray:
            """This rank's rows of steps ``first`` to ``first + n - 1``."""
            return np.stack([(np.arange(s * tb, (s + 1) * tb) % train_ds.size)[d * rows:(d + 1) * rows]
                             for s in range(first, first + n)])

        def state(c=cfg):
            return shard_state(create_state(c, torch.Generator().manual_seed(7), device=device,
                                            mesh=mesh), mesh)

        res = {"rank": dist.get_rank(), "device": str(device), "backend": mesh.backend,
               "graph_dispatch": graph_dispatch(device, mesh), "rows": rows,
               "spatial": cfg.mesh.spatial}
        step = make_train_step(cfg, "joint", mesh)
        eager, graphed = state(), state()
        if kind == "equal":
            def equal_run(c, step, eager, graphed) -> dict:
                """2 graph dispatches against eager single steps of config ``c``."""
                # Which process groups run a collective, eagerly and under a capture.
                seen: dict = {"eager": set(), "captured": set()}
                all_reduce = dist.all_reduce

                def recorded(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
                    where = "captured" if torch.cuda.is_current_stream_capturing() else "eager"
                    seen[where].add(str(dist.get_process_group_ranks(group or dist.group.WORLD)))
                    return all_reduce(tensor, op=op, group=group, async_op=async_op)

                dist.all_reduce = recorded
                multi = make_train_multistep(c, "joint", train_ds.get_batch, KSTEP_K, mesh)
                graphed, _ = multi(graphed, indices(0, KSTEP_K))  # the stage's first dispatch: eager
                for s in range(KSTEP_K):
                    eager, _ = step(eager, train_ds.get_batch(indices(s, 1)[0]))
                torch.cuda.synchronize()
                check(not graphed.graphs.graphs, "the stage's first dispatch was captured")
                reset(counters)
                for first in (KSTEP_K, 2 * KSTEP_K):
                    graphed, got = multi(graphed, indices(first, KSTEP_K))
                torch.cuda.synchronize()
                launches = {n: fn.launches for n, fn in counters.items()}
                for s in range(KSTEP_K, 3 * KSTEP_K):
                    eager, want = step(eager, train_ds.get_batch(indices(s, 1)[0]))
                torch.cuda.synchronize()
                dist.all_reduce = all_reduce
                result = dict(
                    captured=len(graphed.graphs.graphs), launches=launches,
                    bit_equal=_same_state(graphed, eager) and all(torch.equal(got[n], want[n])
                                                                  for n in want),
                    worst_rel_err=max(rel_err(p, q)[0] for p, q in zip(
                        graphed.model.parameters(), eager.model.parameters())),
                    groups_eager=sorted(seen["eager"]), groups_captured=sorted(seen["captured"]),
                    loss=float(got["loss"]))
                graphed.graphs.release()
                return result

            res.update(equal_run(cfg, step, eager, graphed))
            # flagship as its preset stands ('auto' -> 'xla', bf16), held alike.
            xcfg = cfg.replace(mrf=preset.mrf)
            res["xla"] = equal_run(xcfg, make_train_step(xcfg, "joint", mesh), state(xcfg),
                                   state(xcfg))
        else:
            multi = make_train_multistep(cfg, "joint", train_ds.get_batch, KSTEP_TIMED_K, mesh)
            graphed, _ = multi(graphed, indices(0, KSTEP_TIMED_K))  # warm: eager
            eager, _ = step(eager, train_ds.get_batch(indices(0, 1)[0]))
            res["step_ms"] = _step_turns(cfg, train_ds, indices, eager, graphed, KSTEP_TIMED_K,
                                         mesh)
            res["step_ms"]["captured"] = len(graphed.graphs.graphs)
            if (data, model, spatial) == (4, 1, False):
                # The preset's own MRF ('auto' -> 'xla': the grouped conv's
                # dense backward) at 8 rows a rank, beside the pallas path's.
                xcfg = cfg.replace(mrf=preset.mrf)
                xe, xg = state(xcfg), state(xcfg)
                xmulti = make_train_multistep(xcfg, "joint", train_ds.get_batch, KSTEP_TIMED_K,
                                              mesh)
                xg, _ = xmulti(xg, indices(0, KSTEP_TIMED_K))  # warm: eager
                xstep = make_train_step(xcfg, "joint", mesh)
                xe, _ = xstep(xe, train_ds.get_batch(indices(0, 1)[0]))
                res["xla_step_ms"] = _step_turns(xcfg, train_ds, indices, xe, xg, KSTEP_TIMED_K,
                                                 mesh)
                res["xla_step_ms"]["captured"] = len(xg.graphs.graphs)
                xg.graphs.release()
                del xe, xg
        graphed.graphs.release()  # before the process groups go (shutdown_distributed)
        del eager, graphed
        torch.cuda.empty_cache()
        if kind == "time":
            res["fit"] = _fit_rates(cfg, os.path.join(out, f"fit_{name}"), counters, device,
                                    lead=mesh.rank == 0)
        with open(os.path.join(out, f"{kind}_{name}_rank{dist.get_rank()}.json"), "w") as f:
            json.dump(res, f)
    shutdown_distributed()


def _nccl_world(kind: str, meshes: list, tmp: str, env: dict | None = None) -> tuple[dict, float]:
    """Launch ``nccl_kstep_child`` over ``meshes``, all of one size, a card a
    rank; each mesh's ranks' results and the world's wall seconds."""
    n = meshes[0][0] * meshes[0][1]
    names = [_mesh_name(*m) for m in meshes]
    _, secs = _child(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(n),
                      os.path.abspath(__file__), "--nccl-kstep-child",
                      f"{kind}:{','.join(names)}", tmp],
                     f"the nccl_kstep {kind} world of {n}", env, timeout=900)
    ranks = {}
    for name in names:
        ranks[name] = []
        for r in range(n):
            with open(os.path.join(tmp, f"{kind}_{name}_rank{r}.json")) as f:
                ranks[name].append(json.load(f))
    return ranks, secs


def xla_determinism_probe(smi: str) -> dict:
    """Whether cuDNN has deterministic algorithms for the convolutions of
    ``flagship``'s own MRF path at the nccl_kstep equal world's shard-local
    shapes: the grouped fprop of ``grouped_conv_f32`` (fp32 on bf16 values)
    and its backward's dense convolutions (dk's weight gradient, dp's
    space-to-depth conv), bf16, at 8 rows and Kv 9 (data 4) and 16 rows and
    Kv 5 (2x2, 2x2 spatial).  Under ``torch.use_deterministic_algorithms``
    (which raises where an op has none) each runs twice and must repeat bit
    for bit; a missing algorithm fails the run."""
    from jointpose_torch import get_config
    from jointpose_torch.ops.mrf_xla import grouped_conv_f32

    t0 = time.perf_counter()
    flag = get_config("flagship")
    ch, cw = (n // flag.mrf.stride for n in flag.heatmap_hw)
    wh, ww = flag.mrf.window
    k = flag.num_joints
    gen = torch.Generator().manual_seed(12)
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
            for name, (rows, kv) in {"4x1": (8, k), "2x2": (16, -(-k // 2))}.items():
                p = unaries(gen, rows, ch, cw, kv, torch.bfloat16).requires_grad_()
                kern = torch.nn.functional.softplus(torch.randn(wh, ww, 1, kv * k, generator=gen))
                kern = kern.to("cuda", torch.bfloat16).requires_grad_()
                g = torch.randn(rows, ch, cw, kv * k, generator=gen).cuda()
                runs = []
                for _ in range(2):
                    resp = grouped_conv_f32(p, kern, kv)
                    runs.append((resp, *torch.autograd.grad(resp, (p, kern), g)))
                torch.cuda.synchronize()
                out[name] = all(torch.equal(a, b) for a, b in zip(*runs))
                check(out[name], f"the 'xla' path's convolutions at {rows} rows, Kv {kv} do not "
                      "repeat bit for bit under deterministic algorithms")
    except RuntimeError as e:
        check(False, f"cuDNN has no deterministic algorithm for a convolution of the 'xla' path: {e}")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"nccl_kstep: cuDNN's deterministic algorithms for the 'xla' path's grouped fprop (fp32 "
          f"on bf16 values) and the dense dk and dp convolutions of its backward (bf16), "
          f"{wh}x{ww} window on the {ch}x{cw} coarse grid: present at 8 rows, Kv {k} (data 4) and "
          f"16 rows, Kv {-(-k // 2)} (2x2), each run twice bit-identical "
          f"({time.perf_counter() - t0:.2f} s); on {smi}")
    return out


def nccl_equal_world(equal: list, tmp: str, smi: str) -> dict:
    """The bit-equality world of ``nccl_kstep_phase`` over the meshes
    ``equal`` (deterministic algorithms), its checks and lines: for
    ``flagship(mrf.impl='pallas')`` and for the preset as it stands
    ('xla').  Returns the ranks' results by mesh."""
    per_step = {"shear_warp": 1, "mrf_epilogue": 1, "mrf_epilogue_bwd": 1}
    worlds, secs = _nccl_world("equal", equal, tmp, {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    print(f"nccl_kstep: the bit-equality world of {equal[0][0] * equal[0][1]} ranks took "
          f"{secs:.1f} s wall (processes included)")
    for name, ranks in worlds.items():
        want = {n: 2 * KSTEP_K * per_step.get(n, 0) for n in ranks[0]["launches"]}
        for res in ranks:
            r = res["rank"]
            check(res["backend"] == "nccl" and res["graph_dispatch"] and res["captured"] == 1,
                  f"nccl_kstep {name}: rank {r} on {res['backend']} captured "
                  f"{res['captured']} graph(s)")
            check(res["bit_equal"], f"nccl_kstep {name}: the graph form is not bit-equal to "
                  f"eager single steps on rank {r} (worst parameter rel err "
                  f"{res['worst_rel_err']:.3e})")
            check(res["launches"] == want, f"nccl_kstep {name}: the graph dispatches launched "
                  f"{res['launches']} on rank {r}, not {want}")
            check(set(res["groups_captured"]) <= set(res["groups_eager"])
                  and res["groups_captured"], f"nccl_kstep {name}: rank {r} captured "
                  f"collectives on {res['groups_captured']}, eagerly warmed "
                  f"{res['groups_eager']}")
        print(f"nccl_kstep {name} (flagship, mrf.impl='pallas', bf16, global batch 32, "
              f"{ranks[0]['rows']} rows a rank, spatial {ranks[0]['spatial']}, deterministic "
              f"algorithms, ranks on {[res['device'] for res in ranks]}, backend nccl): 2 "
              f"dispatches of {KSTEP_K} by graph against {2 * KSTEP_K} eager single steps from "
              f"one state: bit-equal on every rank (parameters, AdamW's state, generator, "
              f"step, last metrics; loss {ranks[0]['loss']:.6f}); launches of the graph "
              f"dispatches a rank {ranks[0]['launches']}; process groups with a collective "
              f"under the capture {ranks[0]['groups_captured']}, each run eagerly before it; "
              f"on {smi}")
        # flagship as its preset stands ('xla'): the warp once a step, no
        # MRF kernel.
        want = {n: 2 * KSTEP_K * (n == "shear_warp") for n in ranks[0]["xla"]["launches"]}
        for res in ranks:
            x, r = res["xla"], res["rank"]
            check(x["captured"] == 1, f"nccl_kstep {name}, flagship as the preset stands: "
                  f"rank {r} captured {x['captured']} graph(s)")
            check(x["bit_equal"], f"nccl_kstep {name}, flagship as the preset stands: the "
                  f"graph form is not bit-equal to eager single steps on rank {r} (worst "
                  f"parameter rel err {x['worst_rel_err']:.3e})")
            check(x["launches"] == want, f"nccl_kstep {name}, flagship as the preset stands: "
                  f"the graph dispatches launched {x['launches']} on rank {r}, not {want}")
            check(set(x["groups_captured"]) <= set(x["groups_eager"]) and x["groups_captured"],
                  f"nccl_kstep {name}, flagship as the preset stands: rank {r} captured "
                  f"collectives on {x['groups_captured']}, eagerly warmed {x['groups_eager']}")
        print(f"nccl_kstep {name}, flagship as the preset stands (mrf 'auto' -> 'xla', bf16, "
              f"{ranks[0]['rows']} rows a rank, deterministic algorithms, backend nccl): 2 "
              f"dispatches of {KSTEP_K} by graph against {2 * KSTEP_K} eager single steps: "
              f"bit-equal on every rank (loss {ranks[0]['xla']['loss']:.6f}); launches of the "
              f"graph dispatches a rank {ranks[0]['xla']['launches']}; process groups with a "
              f"collective under the capture {ranks[0]['xla']['groups_captured']}; on {smi}")
    return worlds


def nccl_kstep_phase(smi: str) -> dict | None:
    """The K-step dispatch over an nccl mesh, one CUDA graph per dispatch
    with the collectives captured, a card a rank (``nccl_kstep_child``).

    First, on this card, whether cuDNN has deterministic algorithms for the
    'xla' path's convolutions (``xla_determinism_probe``; fails if not).
    Under deterministic algorithms, in one world over data 4, 2x2 and 2x2
    spatial (data 2 on two or three cards; ``nccl_equal_world``): on every
    rank 2 dispatches of KSTEP_K by graph bit-equal to 2 x KSTEP_K eager
    single steps from one state (parameters, AdamW's state, the generator,
    the last metrics), the launches of the epilogue forward and backward
    and the warp 1 a step, and every process group that ran a collective
    under the capture ran one eagerly before it; the same for ``flagship``
    as the preset stands ('xla': the warp 1 a step, no MRF kernel).  With PyTorch's defaults, in worlds of 1, 2
    and 4 as the cards allow, over data 1, 2, 4 and 2x2: a rank's step
    time eager and by graph in turns (over data 4 also for ``flagship`` as
    the preset stands, 'xla'), and ``fit``'s logged images/s at
    steps_per_dispatch 1 and KSTEP_TIMED_K, its graphs captured.  On one
    card it prints why it did not run and returns None."""
    summary: dict = {"determinism": xla_determinism_probe(smi)}
    cards = torch.cuda.device_count()
    if cards < 2:
        print("nccl_kstep: the K-step dispatch captured with its nccl collectives needs a card per "
              f"rank, and this machine has {cards}: not run; the parallel phase's gloo worlds "
              "(ranks sharing the card) ran their dispatches eager, by rule "
              "(train.graph_dispatch)")
        return None
    equal = [m for m in NCCL_EQUAL_MESHES if m[0] * m[1] <= cards] or [(2, 1, False)]
    timed: dict = {}
    for m in NCCL_TIMED_MESHES:
        if m[0] * m[1] <= cards:
            timed.setdefault(m[0] * m[1], []).append(m)
    summary["time"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        summary["equal"] = nccl_equal_world(equal, tmp, smi)
        for size, meshes in timed.items():
            worlds, secs = _nccl_world("time", meshes, tmp)
            for name, ranks in worlds.items():
                for res in ranks:
                    r = res["rank"]
                    check(res["graph_dispatch"] and res["step_ms"]["captured"] == 1,
                          f"nccl_kstep time {name}: rank {r} did not take the graph form")
                    for k, f in res["fit"].items():
                        check(f["captured"] == (0 if k == "1" else 2), f"nccl_kstep fit {name} at "
                              f"steps_per_dispatch {k}: rank {r} captured {f['captured']} graphs")
                lead = ranks[0]["fit"]
                steps = "; ".join(
                    f"rank {res['rank']} " + " / ".join(f"{t:.3f}" for t in res["step_ms"]["turns"])
                    for res in ranks)
                if "xla_step_ms" in ranks[0]:
                    check(all(res["xla_step_ms"]["captured"] == 1 for res in ranks),
                          f"nccl_kstep time {name}: the 'xla' path did not take the graph form")
                    xla = "; ".join(f"rank {res['rank']} " + " / ".join(
                        f"{t:.3f}" for t in res["xla_step_ms"]["turns"]) for res in ranks)
                    print(f"nccl_kstep time {name}, flagship as the preset stands (mrf 'auto' -> "
                          f"'xla': the grouped conv's dense backward), {ranks[0]['rows']} rows a "
                          f"rank: a joint step with its batch generated, in turns eager / graph / "
                          f"graph / eager, ms: {xla}; the pallas path's: {steps}; on {smi}")
                print(f"nccl_kstep time {name} (flagship, mrf.impl='pallas', bf16, global batch "
                      f"32, {ranks[0]['rows']} rows a rank, PyTorch's default algorithms, backend "
                      f"{ranks[0]['backend'] or 'none (one process)'}): a step with its batch "
                      f"generated, in turns eager / graph / graph / eager (dispatches of "
                      f"{KSTEP_TIMED_K}), ms: {steps}; fit's images/s per log interval of 10 "
                      f"steps at steps_per_dispatch 1: detector "
                      f"{[round(x, 1) for x in lead['1']['rates']['detector']]}, joint "
                      f"{[round(x, 1) for x in lead['1']['rates']['joint']]}; at {KSTEP_TIMED_K}: "
                      f"detector {[round(x, 1) for x in lead[str(KSTEP_TIMED_K)]['rates']['detector']]}, "
                      f"joint {[round(x, 1) for x in lead[str(KSTEP_TIMED_K)]['rates']['joint']]} "
                      f"(each stage's first interval holds its warm-up, the second its capture); "
                      f"on {smi}")
            print(f"nccl_kstep: the timed world of {size} rank(s) took {secs:.1f} s wall "
                  f"(processes included)")
            summary["time"].update(worlds)
    rates = {name: {k: (f["rates"]["detector"][-1], f["rates"]["joint"][-1])
                    for k, f in ranks[0]["fit"].items()} for name, ranks in summary["time"].items()}
    print("nccl_kstep: fit's last logged interval of each stage, images/s detector / joint, at "
          "steps_per_dispatch 1 and " + str(KSTEP_TIMED_K) + ": "
          + "; ".join(f"{name} " + ", ".join(f"{k}: {d:.1f} / {j:.1f}" for k, (d, j) in r.items())
                      for name, r in rates.items()) + f"; on {smi}")
    return summary


# The nccl_ops phase: the operations entry points over an nccl mesh of four
# cards, through their CLIs.  Each rank of those groups starts with this
# sitecustomize (on PYTHONPATH ahead of the repository): the interpreter's
# own sitecustomize first; then, in a rank (RANK set), ``flagship`` with
# ``mrf.impl='pallas'`` (the preset's 'auto' takes the direct grouped MRF,
# which launches no epilogue kernel) unless JOINTPOSE_SMOKE_PRESET_AS_IS is
# set (then the preset as it stands), PyTorch's deterministic algorithms
# where JOINTPOSE_SMOKE_DETERMINISTIC is set, the rank's graph captures and
# the launches of rows 1, 2 and 4 written at exit to
# ``<JOINTPOSE_SMOKE_COUNTS>.<RANK>.json``, and, where JOINTPOSE_SMOKE_DRILL
# names one, the drill of ``tests/test_torch_multihost.py``'s rank script:
# rank 1 at the dispatch boundary of step JOINTPOSE_SMOKE_DRILL_STEP, once
# per workdir, sends itself a SIGTERM ('preempt') or sleeps ('hang').
OPS_SITE = """
import importlib.machinery, importlib.util, os, sys
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
if "RANK" in os.environ:
    import atexit, dataclasses, json, signal, time
    import torch
    import jointpose_torch.configs as configs
    import jointpose_torch.resilience as resilience

    if os.environ.get("JOINTPOSE_SMOKE_DETERMINISTIC"):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    _flagship = configs.PRESETS["flagship"]

    def _pallas():
        cfg = _flagship()
        return cfg.replace(mrf=dataclasses.replace(cfg.mrf, impl="pallas"))

    if not os.environ.get("JOINTPOSE_SMOKE_PRESET_AS_IS"):
        configs.PRESETS["flagship"] = _pallas
    _captures = [0]
    _graph_exit = torch.cuda.graph.__exit__

    def _counted_exit(self, *exc):
        out = _graph_exit(self, *exc)
        _captures[0] += exc[0] is None
        return out

    torch.cuda.graph.__exit__ = _counted_exit

    def _dump():
        from jointpose_torch.ops.mrf_epilogue import mrf_epilogue, mrf_epilogue_bwd
        from jointpose_torch.ops.warp import shear_warp

        launches = {"shear_warp": shear_warp.launches, "mrf_epilogue": mrf_epilogue.launches,
                    "mrf_epilogue_bwd": mrf_epilogue_bwd.launches}
        with open(f"{os.environ['JOINTPOSE_SMOKE_COUNTS']}.{os.environ['RANK']}.json", "w") as f:
            json.dump({"captured": _captures[0], "launches": launches}, f)

    if "JOINTPOSE_SMOKE_COUNTS" in os.environ:
        atexit.register(_dump)
    _drill = os.environ.get("JOINTPOSE_SMOKE_DRILL")
    if _drill:
        _inject = resilience.maybe_inject_fault

        def _drilled(workdir, step):
            _inject(workdir, step)
            marker = os.path.join(workdir, ".drill")
            if (os.environ["RANK"] == "1" and step == int(os.environ["JOINTPOSE_SMOKE_DRILL_STEP"])
                    and not os.path.exists(marker)):
                with open(marker, "w") as f:
                    f.write(str(step))
                if _drill == "preempt":
                    os.kill(os.getpid(), signal.SIGTERM)
                else:
                    time.sleep(3600)  # its peers wait in the boundary's collective

        resilience.maybe_inject_fault = _drilled
"""
# train.main's meshes in the phase, and its schedules: 20 + 20 steps at the
# default 10 a dispatch (each stage warm, then captured; an eval at the
# stage boundary and at the end), then a resume of 20 more joint steps with
# a profiled window of 3 (steps 45-47).  The drills run 10 + 30 steps over
# 2x2, evals every 20 (the joint stage captured from step 20) and act at
# the dispatch boundary of step 30.
OPS_MESHES = {"4x1": ["--mesh-data", "4"], "2x2": ["--mesh-data", "2", "--mesh-model", "2"],
              "2x2s": ["--mesh-data", "2", "--mesh-model", "2", "--mesh-spatial"]}
OPS_TRAIN = ["--config", "flagship", "--eval-max-batches", "1", "--log-every", "10"]
OPS_STEPS, OPS_RESUMED, OPS_WINDOW = (20, 20), 40, 3
# The preset's run over 2x2 resumes to 80 joint steps: its intervals 70-80
# and 90-100 hold replays alone (evals every 20 steps).
PRESET_RESUMED = 80
DRILL_STEPS, DRILL_EVERY, DRILL_STEP = (10, 30), 20, 30
# The supervisor's heartbeat timeout: above the launcher's 30 s between its
# SIGTERM and SIGKILL to the peers of a failed rank; for the hang drill
# above a capture and its first replay of 10 steps (569.7 ms on one "NVIDIA
# H100 80GB HBM3, 700.00 W" card).
DRILL_HEARTBEAT_S = {"fault": 120, "preempt": 120, "hang": 20}
DRILL_EVENTS = {"fault": ["launch", "failure", "launch", "done"],
                "preempt": ["launch", "preempted", "launch", "done"],
                "hang": ["launch", "heartbeat_stale", "failure", "launch", "done"]}


def _ops_group(args: list[str], what: str, env: dict, log: str, workdir: str,
               timeout: float = 300) -> dict:
    """Run ``python <args>`` from the repository root, its output to
    ``log``, polling every 50 ms the heartbeat of ``workdir`` (each beat's
    step and time) and the processes below it; on ``timeout`` SIGKILL them
    all and fail.  Returns the exit code, the beats, every (pid, start)
    seen below it and the wall seconds."""
    from jointpose_torch import resilience

    hb_path = os.path.join(workdir, resilience.HEARTBEAT_FILE)
    beats, seen, last = [], set(), None
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, *args], stdout=out, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                env={**os.environ, **env})
        polls = 0
        while proc.poll() is None:
            if time.perf_counter() - t0 > timeout:
                tree = resilience._process_tree(proc.pid)
                proc.kill()
                proc.wait()
                resilience._kill_survivors(tree)
                break
            try:
                with open(hb_path) as f:
                    beat = json.load(f)
            except (OSError, ValueError):
                beat = None
            if beat is not None and beat != last:
                beats.append((beat["step"], beat["time"]))
                last = beat
            if polls % 10 == 0:
                seen.update(resilience._process_tree(proc.pid))
            polls += 1
            time.sleep(0.05)
    wall = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    check(proc.returncode == 0, f"{what} exited {proc.returncode} after {wall:.1f} s "
          f"(timeout {timeout} s): {text[-4000:]}")
    return {"beats": beats, "seen": seen, "wall_s": wall, "log": text}


def _ops_counts(prefix: str, n: int) -> list[dict]:
    """Each rank's graph captures and launches of rows 1, 2 and 4
    (OPS_SITE), read and removed."""
    out = []
    for r in range(n):
        path = f"{prefix}.{r}.json"
        with open(path) as f:
            out.append(json.load(f))
        os.remove(path)
    return out


def _survivors(seen: set) -> list[int]:
    """The processes of ``seen`` that still run (not gone, not a later
    process of the same pid, not a zombie)."""
    from jointpose_torch import resilience

    alive = []
    for pid, started in seen:
        stat = resilience._stat(pid)
        if stat is not None and stat[19] == started and stat[0] != "Z":
            alive.append(pid)
    return alive


def _nccl_share(timing) -> tuple[float, float]:
    """(ms a step in NCCL kernels, their share of the busy time)."""
    busy = sum(o.duration_s for o in timing.ops)
    nccl = sum(o.duration_s for o in timing.ops if "nccl" in o.name.lower())
    return nccl * 1e3 / timing.num_runs, nccl / busy if busy else float("nan")


def _resumed_from(log: str) -> int:
    for line in log.splitlines():
        if "resumed from step " in line:
            return int(line.split("resumed from step ")[1].split()[0])
    raise SystemExit(f"chip_smoke: FAILED: no resume in {log[-2000:]}")


def _params(workdir: str, step: int) -> dict:
    path = os.path.join(workdir, "checkpoints", "latest", str(step), "state.pt")
    return torch.load(path, weights_only=True, map_location="cpu")["model"]


def ops_preset_run(launcher: list, base_env: dict, tmp: str, counts: str, probe: torch.Tensor,
                   smi: str) -> dict:
    """``train.main --config flagship`` with the preset as it stands ('auto'
    -> 'xla', bf16; OPS_SITE told so by JOINTPOSE_SMOKE_PRESET_AS_IS) over
    2x2 by graph: 20 + 20 steps, then ``--resume`` for PRESET_RESUMED - 20
    more joint steps; each rank's graphs (2, then 1: a resumed stage warms
    again) and its launches (the warp once a step, no epilogue) held, rank
    0's checkpoint restored into a one-device predictor; a rank's step
    time from ``fit``'s logged images/s (the global batch over the ranks'
    common step), by graph where an interval holds no warm-up, capture or
    eval."""
    from jointpose_torch import get_config
    from jointpose_torch.predict import build_predictor, restore_params

    cfg = get_config("flagship")
    det, joint = OPS_STEPS
    wd = os.path.join(tmp, "train_preset_2x2")
    env = {**base_env, "JOINTPOSE_SMOKE_PRESET_AS_IS": "1"}
    runs = {}
    for run, extra, steps, graphs in (
            ("first", ["--joint-steps", str(joint)], det + joint, 2),
            ("resumed", ["--joint-steps", str(PRESET_RESUMED), "--resume"], PRESET_RESUMED - joint,
             1)):
        res = _ops_group([*launcher, "-m", "jointpose_torch.train", *OPS_TRAIN, *OPS_MESHES["2x2"],
                          "--workdir", wd, "--detector-steps", str(det), "--eval-every", str(det),
                          *extra],
                         f"train.main of flagship as the preset stands over 2x2 ({run})", env,
                         os.path.join(tmp, f"train_preset_2x2_{run}.log"), wd)
        ranks = _ops_counts(counts, 4)
        want = {"shear_warp": steps, "mrf_epilogue": 0, "mrf_epilogue_bwd": 0}
        for r, c in enumerate(ranks):
            check(c["captured"] == graphs and c["launches"] == want,
                  f"train.main of flagship as the preset stands over 2x2 ({run}): rank {r} "
                  f"captured {c['captured']} graph(s) and launched {c['launches']}, not {graphs} "
                  f"and {want}")
        check("backend nccl" in res["log"] and "final:" in res["log"],
              f"train.main of flagship as the preset stands over 2x2 ({run}) did not run over "
              f"nccl to its end")
        runs[run] = {"wall_s": res["wall_s"], "ranks": ranks, "log": res["log"]}
    resumed = _resumed_from(runs["resumed"]["log"])
    check(resumed == det + joint, f"train.main of flagship as the preset stands resumed from step "
          f"{resumed}, not {det + joint}")
    records = read_records(wd)
    step_ms = [(r["step"], cfg.train.batch_size / r["images_per_sec"] * 1e3) for r in records
               if "images_per_sec" in r and r.get("stage") == "joint"]
    # The resumed stage's intervals of 10 after its warm-up and its capture
    # whose start is no eval step: the graph's replays alone.
    replays = [ms for step, ms in step_ms if step > resumed + 20 and (step - 10) % det]
    check(bool(replays), f"train.main of flagship as the preset stands logged no interval of "
          f"replays alone: {step_ms}")
    pdj = [r["pdj_at_05_wrist_elbow"] for r in records if "pdj_at_05_wrist_elbow" in r]
    state_dict, step = restore_params(cfg, os.path.join(wd, "checkpoints"))
    coords, probs = build_predictor(cfg, state_dict)(probe)
    torch.cuda.synchronize()
    check(step == det + PRESET_RESUMED and bool(torch.isfinite(coords).all())
          and bool(torch.isfinite(probs).all()) and bool(pdj) and all(math.isfinite(x) for x in pdj),
          f"train.main of flagship as the preset stands: rank 0's checkpoint at step {step} does "
          f"not restore into a one-device predictor with finite output")
    print(f"nccl_ops train.main --config flagship as the preset stands (mrf 'auto' -> 'xla', bf16, "
          f"global batch {cfg.train.batch_size}, 2x2: Kv 5 a rank through grouped_conv_f32, 10 "
          f"steps a dispatch, backend nccl): {det} + {joint} steps in "
          f"{runs['first']['wall_s']:.1f} s wall, resumed from step {resumed} to step "
          f"{det + PRESET_RESUMED} in {runs['resumed']['wall_s']:.1f} s; each rank captured "
          f"{runs['first']['ranks'][0]['captured']} and {runs['resumed']['ranks'][0]['captured']} "
          f"graph(s) and launched {runs['first']['ranks'][0]['launches']} and "
          f"{runs['resumed']['ranks'][0]['launches']}; a joint step a rank by graph "
          f"{float(np.median(replays)):.3f} ms (median of the intervals of replays alone, "
          f"{[round(t, 3) for t in replays]}); fit's logged ms a step per interval of 10 ending "
          f"at each step {[(n, round(t, 3)) for n, t in step_ms]} (a stage's first interval "
          f"holds its warm-up, the second its capture, one after an eval step the eval); PDJ@0.05 "
          f"(wrist, elbow) {pdj}; "
          f"rank 0's step-{step} checkpoint restored into a one-device predictor (finite); "
          f"on {smi}")
    return {"wall_s": {k: v["wall_s"] for k, v in runs.items()}, "resumed_from": resumed,
            "joint_step_ms": float(np.median(replays)),
            "launches": {k: v["ranks"][0]["launches"] for k, v in runs.items()}}


def nccl_ops_phase(smi: str) -> dict | None:
    """The operations entry points over an nccl mesh of four cards, a card a
    rank, each K-step dispatch one CUDA graph with its collectives
    (``flagship`` with ``mrf.impl='pallas'``, global batch 32, 10 steps a
    dispatch; each rank under OPS_SITE).

    1. ``python -m torch.distributed.run --nproc-per-node 4 -m
       jointpose_torch.train`` over data 4, 2x2 and 2x2 spatial: 20 + 20
       steps (a stage boundary, evals), then ``--resume`` for 20 more joint
       steps with ``--profile-steps 3``; each rank's graphs captured (2 a
       run) and launches of rows 1, 2 and 4 (1 a step; the epilogue forward
       also once a joint eval) held; rank 0's last checkpoint restored into
       a one-device predictor, its output finite.
    2. Every rank's trace of the window through ``devtime.parse_trace``:
       a step's device span and busy time, the NCCL kernels' time and share
       and the top ops, each path kernel once a step.
    3. ``python -m jointpose_torch.resilience --nproc-per-node 4`` over
       2x2 under deterministic algorithms with a fault
       (JOINTPOSE_FAULT_AT_STEP), a SIGTERM to rank 1 and a hang of rank 1
       at the dispatch boundary of step 30: the supervisor's events, no
       process of the killed group left, the final parameters bit-equal to
       an unbroken run's, and the time to recover (from the supervisor's
       event to the relaunched group's first heartbeat past the step it
       resumed from).
    On fewer than four cards it prints why and runs nothing."""
    from jointpose_torch import devtime, get_config
    from jointpose_torch.predict import build_predictor, restore_params

    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"nccl_ops: train.main over data 4, 2x2 and 2x2 spatial and the supervised drills "
              f"need four cards, a card a rank (nccl), and this machine has {cards}: not run")
        return None
    root = os.path.dirname(os.path.abspath(__file__))
    launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4"]
    flag = get_config("flagship")
    cfg = flag.replace(mrf=dataclasses.replace(flag.mrf, impl="pallas"))
    summary: dict = {"meshes": {}, "drills": {}}
    with tempfile.TemporaryDirectory() as tmp:
        site = os.path.join(tmp, "site")
        os.makedirs(site)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(OPS_SITE)
        counts = os.path.join(tmp, "counts")
        base_env = {"PYTHONPATH": os.pathsep.join(filter(None, [site, root, os.environ.get(
            "PYTHONPATH")])), "JOINTPOSE_SMOKE_COUNTS": counts}

        # 1-2. train.main over each mesh, resumed with a profiled window.
        det, joint = OPS_STEPS
        probe = torch.randint(0, 256, (BATCH, *cfg.data.image_hw, 3), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(9)).cuda()
        finals = {}
        for name, mesh_args in OPS_MESHES.items():
            wd = os.path.join(tmp, f"train_{name}")
            runs = {}
            for run, extra, want in (
                    ("first", ["--joint-steps", str(joint)],
                     {"shear_warp": det + joint, "mrf_epilogue": joint + 1,
                      "mrf_epilogue_bwd": joint}),
                    ("resumed", ["--joint-steps", str(OPS_RESUMED), "--resume",
                                 "--profile-steps", str(OPS_WINDOW)],
                     {"shear_warp": OPS_RESUMED - joint, "mrf_epilogue": OPS_RESUMED - joint + 1,
                      "mrf_epilogue_bwd": OPS_RESUMED - joint})):
                res = _ops_group([*launcher, "-m", "jointpose_torch.train", *OPS_TRAIN, *mesh_args,
                                  "--workdir", wd, "--detector-steps", str(det),
                                  "--eval-every", str(det), *extra],
                                 f"train.main over {name} ({run})", base_env,
                                 os.path.join(tmp, f"train_{name}_{run}.log"), wd)
                ranks = _ops_counts(counts, 4)
                pdj = [r["pdj_at_05_wrist_elbow"] for r in read_records(wd)
                       if "pdj_at_05_wrist_elbow" in r]
                for r, c in enumerate(ranks):
                    check(c["captured"] == 2 and c["launches"] == want,
                          f"train.main over {name} ({run}): rank {r} captured {c['captured']} "
                          f"graph(s) and launched {c['launches']}, not 2 and {want}")
                check("backend nccl" in res["log"] and "final:" in res["log"] and pdj
                      and all(math.isfinite(x) for x in pdj),
                      f"train.main over {name} ({run}) did not run over nccl to its end")
                runs[run] = {"wall_s": res["wall_s"], "ranks": ranks, "pdj": pdj}
            check("resumed from step 40" in res["log"], f"train.main over {name} did not resume")
            state_dict, step = restore_params(cfg, os.path.join(wd, "checkpoints"))
            coords, probs = build_predictor(cfg, state_dict)(probe)
            torch.cuda.synchronize()
            check(step == det + OPS_RESUMED and coords.shape == (BATCH, 9, 2)
                  and bool(torch.isfinite(coords).all()) and bool(torch.isfinite(probs).all()),
                  f"train.main over {name}: rank 0's checkpoint at step {step} does not restore "
                  f"into a one-device predictor with finite output")
            finals[name] = state_dict
            print(f"nccl_ops train.main over {name} (flagship, mrf.impl='pallas', bf16, global "
                  f"batch 32, 10 steps a dispatch, backend nccl): {det} + {joint} steps in "
                  f"{runs['first']['wall_s']:.1f} s wall, then --resume to step "
                  f"{det + OPS_RESUMED} with a profiled window of {OPS_WINDOW} in "
                  f"{runs['resumed']['wall_s']:.1f} s; each rank captured 2 graphs a run and "
                  f"launched {runs['first']['ranks'][0]['launches']} and "
                  f"{runs['resumed']['ranks'][0]['launches']}; rank 0's step-{step} checkpoint "
                  f"restored into a one-device predictor (finite coordinates); PDJ@0.05 "
                  f"(wrist, elbow) at the evals of both runs {runs['resumed']['pdj']}; "
                  f"on {smi}")
            # The window, rank by rank.
            prof = []
            for r in range(4):
                timing = devtime.parse_trace(os.path.join(wd, "profile", f"rank{r}"), "train")
                check(timing is not None and timing.num_runs == OPS_WINDOW,
                      f"train.main over {name}: rank {r}'s trace holds "
                      f"{0 if timing is None else timing.num_runs} steps, not {OPS_WINDOW}")
                traced = {n: sum(o.count for o in timing.ops if k in o.name)
                          for n, k in PATH_KERNELS.items()}
                check(traced == {n: OPS_WINDOW for n in PATH_KERNELS},
                      f"train.main over {name}: rank {r}'s window traced the path's kernels "
                      f"{traced} times")
                busy = sum(o.duration_s for o in timing.ops) * 1e3 / OPS_WINDOW
                nccl_ms, share = _nccl_share(timing)
                prof.append({"span_ms": [t * 1e3 for t in timing.run_durations_s],
                             "busy_ms": busy, "nccl_ms": nccl_ms, "nccl_share": share,
                             "top": [(o.name[:90], o.duration_s * 1e3 / OPS_WINDOW,
                                      o.count / OPS_WINDOW) for o in timing.top_ops(8)]})
                spans = [round(t, 3) for t in prof[-1]["span_ms"]]
                print(f"nccl_ops window over {name}, rank {r} (steps 45-47, eager, one step a "
                      f"dispatch): a step's device span {spans} ms, busy {busy:.3f} ms a step, "
                      f"NCCL kernels {nccl_ms:.3f} ms a step "
                      f"({share:.1%} of busy); on {smi}")
                for op, ms, n in prof[-1]["top"]:
                    print(f"  {name} rank {r} top op: {ms:8.4f} ms/step x{n:g} {op}")
            summary["meshes"][name] = {"runs": runs, "profile": prof}
        first, ref = next(iter(finals.items()))
        print(f"nccl_ops: final parameters at step {det + OPS_RESUMED} against {first}'s, worst "
              f"rel err: " + ", ".join(f"{name} {max(rel_err(p[n], ref[n])[0] for n in ref):.3e}"
                                       for name, p in finals.items() if name != first))

        # 2b. flagship as its preset stands over 2x2 ('xla': TP's Kv 5
        # through the grouped conv's autograd function), resumed.
        summary["preset"] = ops_preset_run(launcher, base_env, tmp, counts, probe, smi)

        # 3. The supervised drills over 2x2, against an unbroken run.
        det, joint = DRILL_STEPS
        drill_env = {**base_env, "JOINTPOSE_SMOKE_DETERMINISTIC": "1",
                     "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        args = [*OPS_TRAIN, *OPS_MESHES["2x2"], "--detector-steps", str(det), "--joint-steps",
                str(joint), "--eval-every", str(DRILL_EVERY)]
        wd = os.path.join(tmp, "unbroken")
        res = _ops_group([*launcher, "-m", "jointpose_torch.train", *args, "--workdir", wd],
                         "the unbroken 2x2 run", drill_env, os.path.join(tmp, "unbroken.log"), wd)
        _ops_counts(counts, 4)
        want = _params(wd, det + joint)
        print(f"nccl_ops unbroken run over 2x2 ({det} + {joint} steps, deterministic "
              f"algorithms): {res['wall_s']:.1f} s wall")
        for kind in ("fault", "preempt", "hang"):
            wd = os.path.join(tmp, f"drill_{kind}")
            env = dict(drill_env)
            if kind == "fault":
                env["JOINTPOSE_FAULT_AT_STEP"] = str(DRILL_STEP)
            else:
                env.update(JOINTPOSE_SMOKE_DRILL=kind, JOINTPOSE_SMOKE_DRILL_STEP=str(DRILL_STEP))
            res = _ops_group(["-m", "jointpose_torch.resilience", "--nproc-per-node", "4",
                              "--max-restarts", "1", "--heartbeat-timeout",
                              str(DRILL_HEARTBEAT_S[kind]), "--start-timeout", "600", "--",
                              *args, "--workdir", wd],
                             f"the supervised {kind} drill", env,
                             os.path.join(tmp, f"drill_{kind}.log"), wd, timeout=480)
            for path in glob.glob(f"{counts}.*.json"):
                os.remove(path)
            with open(os.path.join(wd, "supervisor.jsonl")) as f:
                events = [json.loads(line) for line in f]
            names = [e["event"] for e in events]
            check(names == DRILL_EVENTS[kind], f"the {kind} drill's supervisor logged {names}")
            preempted = os.path.exists(os.path.join(wd, "preempted.json"))
            check(preempted == (kind == "preempt"), f"the {kind} drill "
                  f"{'wrote' if preempted else 'did not write'} preempted.json")
            check(events[-2]["restarts"] == (0 if kind == "preempt" else 1),
                  f"the {kind} drill relaunched with {events[-2]['restarts']} restarts charged")
            acted = os.path.getmtime(os.path.join(
                wd, ".fault_injected" if kind == "fault" else ".drill"))
            alive = _survivors(res["seen"])
            check(not alive, f"the {kind} drill left processes {alive} running")
            got = _params(wd, det + joint)
            worst = max(rel_err(got[n], w)[0] for n, w in want.items())
            check(all(torch.equal(got[n], w) for n, w in want.items()),
                  f"the {kind} drill's final parameters are not bit-equal to the unbroken run's "
                  f"(worst rel err {worst:.3e})")
            resumed = _resumed_from(res["log"])
            event = next(e for e in events if e["event"] in ("failure", "preempted"))
            relaunch = events[-2]["time"]
            back = [t for step, t in res["beats"] if t > relaunch and step > resumed]
            check(bool(back), f"the {kind} drill's relaunched group beat no step past {resumed}")
            ttr = back[0] - event["time"]
            stale = next((e["time"] for e in events if e["event"] == "heartbeat_stale"), None)
            faulted = res["log"].count("injecting fault at step")
            summary["drills"][kind] = {
                "events": names, "ranks_faulted": faulted, "time_to_recover_s": ttr,
                "act_to_event_s": event["time"] - acted,
                "event_to_relaunch_s": relaunch - event["time"], "resumed_from": resumed,
                "processes_seen": len(res["seen"]), "wall_s": res["wall_s"],
                **({"act_to_stale_s": stale - acted} if stale else {})}
            d = summary["drills"][kind]
            print(f"nccl_ops supervised {kind} drill over 2x2 (python -m "
                  f"jointpose_torch.resilience --nproc-per-node 4, deterministic algorithms, the "
                  f"drill at the dispatch boundary of step {DRILL_STEP}, heartbeat timeout "
                  f"{DRILL_HEARTBEAT_S[kind]} s): events {names}; "
                  f"{'preempted.json written' if preempted else 'no preempted.json'}; "
                  + (f"{faulted} rank(s) faulted; " if kind == "fault" else "") + f"resumed "
                  f"from step {resumed}; final parameters bit-equal to the unbroken run's; none of "
                  f"the {len(res['seen'])} processes seen below the supervisor left running; the "
                  f"drill to the supervisor's {event['event']} event {d['act_to_event_s']:.2f} s"
                  + (f" (to heartbeat_stale {d['act_to_stale_s']:.2f} s)" if stale else "")
                  + f", that event to the relaunch {d['event_to_relaunch_s']:.2f} s; time to "
                  f"recover (the event to the relaunched group's first heartbeat past step "
                  f"{resumed}) {ttr:.2f} s; wall {res['wall_s']:.1f} s; on {smi}")
    return summary


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

        def on_step(self, step: int, steps: int = 1, ready: bool = True) -> None:
            tracing = self._prof is not None
            super().on_step(step, steps, ready)
            if (self._prof is not None) != tracing:
                marks["stop" if tracing else "start"] = {name: fn.launches
                                                         for name, fn in counters.items()}

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
          == {"shear_warp": 1, "mrf_epilogue": 1, "mrf_epilogue_bwd": 1, "mrf_upsample_log": 1,
              "mrf_upsample_log_bwd": 1},
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
    tail_ops = sum(o.count for o in dev.ops if "mrf_tail_wgmma_kernel" in o.name)
    high_ops = sum(o.count for o in dev.ops if "mrf_fft_tail_kernel" in o.name)
    check(tail_ops == iters and high_ops == 0
          and fused_tail.launches_1pass - before == iters + warmup,
          f"measure_device_time: row 3' (wgmma) appears {tail_ops} times in {iters} runs, the "
          f"3xTF32 kernel {high_ops} times")
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


# flagship served as its preset stands ('auto' -> 'xla', bf16) on the card
# against the port's CPU path on the same weights and images: the detector
# logits and the MRF log-heatmaps by max|Δ| / max|ref|.  cuDNN's bf16 convs
# and the CPU's round the same stacks in other orders, a few roundings of
# 2^-8 each: the bar of the CPU tests' bf16 served slice
# (tests/test_torch_predict.py BF16_RTOL).
SERVE_BF16_RTOL = 2e-2
# The batches of the served device time: 128 is bench.py's headline batch.
SERVE_TIMED_BATCHES = (8, 32, 128)
# The MRF kernels of rows 1, 2, 3 and 3′, none of which this path launches.
MRF_KERNELS = ("mrf_epilogue", "mrf_epilogue_bwd", "mrf_fft_tail", "mrf_fft_tail_1pass")


def serve_preset_checks(tmp: str, batches: list, counters: dict, smi: str) -> dict:
    """``flagship`` served as its preset stands (MRF 'auto' -> 'xla': the
    direct grouped conv, bf16, uint8 images) at 'default' from a full-width
    checkpoint of seeded weights: ``batches`` through ``PoseService``, then
    the first of them once more through ``make_handler`` over HTTP, no MRF
    kernel launched and the coordinates bit-equal to 'high'; the card's
    logits and MRF log-heatmaps against the port's CPU path; the
    predictor's device time by CUDA-graph replays at SERVE_TIMED_BATCHES
    beside ``perf.step_cost``'s count and its bound, with the MRF's grouped
    conv forward's share; the predictor's whole call at batch 128, host
    copy and ``coords.cpu()`` included, eagerly and by its CUDA graph in
    turns, with the graphs' captures and replays.  Returns the numbers it
    printed."""
    from jointpose_torch import get_config
    from jointpose_torch.checkpoint import reconcile_config
    from jointpose_torch.configs import with_mrf_precision
    from jointpose_torch.convert import write_initial_checkpoint
    from jointpose_torch.models.mrf import select_impl
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.ops.heatmaps import decode_probs, model_probs
    from jointpose_torch.ops.mrf_xla import pairwise_conv
    from jointpose_torch.perf import roofline_images_per_sec, step_cost
    from jointpose_torch.predict import build_predictor, init_state_dict
    from jointpose_torch.serve import PoseService, make_handler

    t0 = time.perf_counter()
    preset = get_config("flagship")
    ckpt = os.path.join(tmp, "flagship_preset")
    state = init_state_dict(preset, torch.Generator().manual_seed(10))
    write_initial_checkpoint(preset, ckpt, state)
    cfg = with_mrf_precision(reconcile_config(preset, ckpt), "default")
    check(select_impl(cfg.mrf) == "xla" and cfg.mrf.stride == 2 and cfg.compute_dtype == "bfloat16",
          f"serve: flagship's preset resolves to {select_impl(cfg.mrf)!r} at stride "
          f"{cfg.mrf.stride} in {cfg.compute_dtype}, not the coarse 'xla' pass in bf16")
    service = PoseService(cfg, ckpt, batch_size=8, step=0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        reset(counters)
        base = dict(service.stats)
        served = [_pred_coords(service.predict(b)) for b in batches]
        status, body = _http(port, "/predict", _npy(batches[0]), "application/x-npy")
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        health = _http(port, "/healthz")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    dispatches = service.stats["dispatches"] - base["dispatches"]
    check(status == 200 and len(body["predictions"]) == len(batches[0]),
          f"serve flagship as its preset stands: the HTTP request answered {status}")
    check(np.array_equal(_pred_coords(body["predictions"]), served[0]),
          "serve flagship as its preset stands: the HTTP reply differs from the same request's "
          "in-process reply")
    check(all(launches[n] == 0 for n in MRF_KERNELS),
          f"serve flagship as its preset stands launched MRF kernels: {launches}")
    high = build_predictor(with_mrf_precision(cfg, "high"), state)
    same = all(np.array_equal(got, high(torch.from_numpy(b))[0].cpu().numpy())
               for got, b in zip(served, batches))
    check(same, "flagship as its preset stands at 'default' differs from 'high'")
    m = health[1]["batcher"]
    lat = m["request_latency_ms"]
    print(f"serve flagship as the preset stands (mrf 'auto' -> 'xla', stride 2, bf16, precision "
          f"'default', PoseService(batch_size=8)): {len(batches)} requests of 8 uint8 "
          f"{cfg.data.image_hw[0]}x{cfg.data.image_hw[1]} "
          f"images in process plus one through make_handler over HTTP, {dispatches} dispatches; "
          f"request latency p50 {lat['p50']} ms, p95 {lat['p95']} ms; mean batch fill "
          f"{m['mean_batch_fill']}; launches of rows 1, 2, 3 and 3' "
          f"{ {n: launches[n] for n in MRF_KERNELS} }, row 4 {launches['shear_warp']}; "
          f"coordinates bit-equal to 'high'; the HTTP reply equals the in-process one; on {smi}")

    # The card against the port's CPU path: same weights, same uint8 batch.
    images = torch.from_numpy(batches[0])
    outs = {}
    for device in ("cuda", "cpu"):
        model = PoseModel(cfg)
        model.load_state_dict(state)
        model = model.to(device).eval()
        with torch.inference_mode():
            out = model(images.to(device))
            coords = decode_probs(model_probs(out), cfg.data.heatmap_stride, refine=cfg.decode_refine)
        outs[device] = {**{k: v.float().cpu() for k, v in out.items()}, "coords": coords.cpu()}
    errs = {k: rel_err(outs["cuda"][k], outs["cpu"][k])
            for k in ("detector_logits", "mrf_log_heatmaps")}
    equal = ((outs["cuda"]["coords"] - outs["cpu"]["coords"]).abs() <= 1e-3).float().mean().item()
    print(f"serve flagship as the preset stands, card against the port's CPU path (bf16, batch "
          f"{images.shape[0]}): detector logits rel err {errs['detector_logits'][0]:.3e}, MRF "
          f"log-heatmaps rel err {errs['mrf_log_heatmaps'][0]:.3e} (limit {SERVE_BF16_RTOL:g}); "
          f"{equal:.4f} of the decoded coordinates within 1e-3 px (not held)")
    check(all(e[0] <= SERVE_BF16_RTOL for e in errs.values()),
          "flagship as its preset stands: the card strays from the CPU")

    # The predictor's device time by graph replays, beside its count.
    predict = build_predictor(cfg, state)
    kernels = torch.nn.functional.softplus(state["spatial_model.raw_kernels"]).to(torch.bfloat16).cuda()
    h, w = cfg.data.image_hw
    ch, cw = cfg.heatmap_hw[0] // cfg.mrf.stride, cfg.heatmap_hw[1] // cfg.mrf.stride
    gen = torch.Generator().manual_seed(11)
    timed = {}
    for b in SERVE_TIMED_BATCHES:
        x = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8).cuda()
        with torch.inference_mode():
            ms = time_ms(lambda: predict(x), runs=20, per_graph=5)
            cost = step_cost(predict, x)
            pc = unaries(gen, b, ch, cw, cfg.num_joints, torch.bfloat16)
            conv_ms = time_ms(lambda: pairwise_conv(pc, kernels, out_dtype=torch.float32),
                              runs=20, per_graph=5)
        flops, mbytes = cost["flops"] / b, cost["bytes"] / b
        bound = roofline_images_per_sec(flops, mbytes)
        timed[b] = {"ms": ms, "images_per_s": b / ms * 1e3, "gflop_per_image": flops / 1e9,
                    "mb_per_image": mbytes / 1e6, "bound_images_per_s": bound,
                    "mrf_conv_ms": conv_ms, "mrf_conv_share": conv_ms / ms}
        t = timed[b]
        print(f"serve flagship as the preset stands, build_predictor at batch {b}: {ms:.4f} ms a "
              f"call by CUDA-graph replays, {t['images_per_s']:.1f} images/s; perf.step_cost "
              f"{t['gflop_per_image']:.4f} GFLOP and {t['mb_per_image']:.3f} MB an image, bound "
              f"{bound:.1f} images/s ({t['images_per_s'] / bound:.1%} of it); the MRF's grouped "
              f"conv forward {conv_ms:.4f} ms ({t['mrf_conv_share']:.1%} of a call); on {smi}")
        check(t["images_per_s"] <= bound, f"batch {b}: a measured rate above its bound")

    # The predictor's own call at batch 128 as a batch scorer makes it (a
    # pinned uint8 batch in, the coordinates back on the host), eagerly
    # (``graphs.forward``) and by its CUDA graph, in turns.  time_ms above
    # warmed and captured this key (the input's device is not in the key);
    # its own capture and step_cost's count ran the call eagerly.
    graphs = predict.graphs
    check(graphs.captures == len(SERVE_TIMED_BATCHES) and graphs.replays > 0,
          f"serve: the predictor captured {graphs.captures} graphs for "
          f"{len(SERVE_TIMED_BATCHES)} keys, replayed {graphs.replays}")
    host = torch.randint(0, 256, (128, h, w, 3), generator=gen, dtype=torch.uint8).pin_memory()

    def eager():
        with torch.inference_mode():
            return graphs.forward(host)[0].cpu()

    def by_graph():
        return predict(host)[0].cpu()

    check(torch.equal(eager(), by_graph()), "serve: the replayed call differs from the eager one")
    replays = graphs.replays
    call_ms = {"eager": [], "graph": []}
    for order in ((eager, by_graph), (by_graph, eager)) * 3:
        for fn in order:
            start = time.perf_counter()
            for _ in range(10):
                fn()
            call_ms["eager" if fn is eager else "graph"].append((time.perf_counter() - start) * 100)
    check(graphs.replays == replays + 60 and graphs.captures == len(SERVE_TIMED_BATCHES),
          f"serve: 60 calls by graph replayed {graphs.replays - replays} times")
    call = {k: float(np.median(v)) for k, v in call_ms.items()}
    print(f"serve flagship as the preset stands, the predictor's call at batch 128 from a pinned "
          f"uint8 batch to coords.cpu(), host clock, median of 6 blocks of 10 in turns: eagerly "
          f"{call['eager']:.4f} ms ({128e3 / call['eager']:.1f} images/s), by its CUDA graph "
          f"{call['graph']:.4f} ms ({128e3 / call['graph']:.1f} images/s), "
          f"{call['eager'] / call['graph']:.3f}x; graphs captured {graphs.captures}, replayed "
          f"{graphs.replays}; on {smi}")
    secs = time.perf_counter() - t0
    print(f"serve flagship as the preset stands: the block took {secs:.1f} s")
    return {"launches": launches, "metrics": m, "errors": {k: e[0] for k, e in errs.items()},
            "coords_equal": equal, "timed": timed, "call_ms": call, "seconds": secs}


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
              f"times and the 3xTF32 tail {launches['mrf_fft_tail']} times in {dispatches} "
              f"dispatches")
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
        # flagship as its preset stands ('xla'), on the same three requests.
        preset = serve_preset_checks(tmp, batches, counters, smi)

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
    return {"launches": launches, "metrics": m, "dispatches": dispatches, "preset": preset}


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


def _child(args: list[str], what: str, env: dict | None = None,
           timeout: int = 600) -> tuple[str, float]:
    """Run ``python <args>`` from the repository root, ``env`` added to the
    environment; its output and seconds.  A world of ranks is
    ``["-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
    N, script, ...]``: it fails unless every rank ended well."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          env={**os.environ, **(env or {})})
    check(proc.returncode == 0,
          f"{what} exited {proc.returncode}: {proc.stdout[-3000:]} {proc.stderr[-3000:]}")
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


# --- the parallel phase: the mesh over processes and the pipelined predictor.

# tests/test_parallel.py:87-91: a sharded training step against one device
# (np.testing.assert_allclose's |got - want| <= atol + rtol |want|).
STEP_LOSS_RTOL, STEP_PARAM_RTOL, STEP_PARAM_ATOL = 2e-4, 2e-3, 2e-5
# Gradients through fp32 conv stacks summed in another order (the sharded
# step adds per-rank partial sums), max|Δ| / max|ref| per tensor: the
# training parity tests' bar (tests/test_torch_train.py GRAD_RTOL).  This is
# what catches a gradient summed too often or too rarely: Adam's first
# update g / (|g| + eps) does not see the gradient's scale.
STEP_GRAD_RTOL = 1e-4
# Adam's first update is ill-conditioned where |g| is within the gradient's
# summation-order deviation of zero: there a deviation of 1e-7 of the
# largest gradient flips the update's sign (the parameter then moves
# lr the other way).  The parameters are held at the reference's
# tolerance where the one-device gradient is at least this share of its
# tensor's largest (5x the largest deviation measured, PERF.md), and within
# one such flip (2 lr) elsewhere.  This departs from tests/test_parallel.py,
# which holds every element (PERF.md PR 10 gives the share exempted).
ADAM_CONDITIONED = 1e-4
# Of the elements below that bar, at most this share of all parameters may
# end beyond the reference's tolerance (flipped updates: 1 of 501,059
# measured with PyTorch's convolutions, 22 with cuDNN's, PERF.md): a step
# that dropped or mis-summed the small gradients would move thousands.
FLIP_SHARE = 1e-4
# tests/test_pipeline.py:54-57: the pipelined predictor against the single program.
PIPE_PROB_RTOL, PIPE_PROB_ATOL, PIPE_COORD_ATOL = 1e-5, 1e-6, 1e-3
# The joint head under tensor parallelism in bf16: the rank's slice of the
# wide conv and the 1x1 conv's fp32 partial sums against the unsliced convs
# move a bf16 rounding here and there, as the head-conv tails' bar allows.
TP_HEAD_RTOL = TAIL_RTOL[torch.bfloat16]
PARALLEL_SEED = 6
PIPE_RUNS = 20
# flagship as its preset stands ('auto' -> 'xla', bf16) sharded against one
# device: tests/test_torch_parallel.py's bars for the bf16 step.  The loss
# by |Δ| / |ref| and the gradients by max|Δ| / max|ref| per tensor: a rank's
# rows, a slice of the sources and rows of the trunk round the same bf16
# stacks in other orders.  The parameters are held at the reference's
# tolerance where the one-device gradient is at least the gradient bar of
# its tensor's largest (a deviation within the bar keeps the sign of Adam's
# first update), elsewhere within one flipped update, and at most
# PRESET_FLIP_SHARE of all parameters may end beyond the tolerance.
PRESET_LOSS_RTOL, PRESET_GRAD_RTOL, PRESET_FLIP_SHARE = 1e-3, 1e-2, 1e-2
PRESET_TIMED_STEPS = 3


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by the kernels line's names."""
    from jointpose_torch.ops import fft_conv as fc
    from jointpose_torch.ops.mrf_epilogue import mrf_epilogue, mrf_epilogue_bwd
    from jointpose_torch.ops.mrf_fft_fused import fused_tail
    from jointpose_torch.ops.warp import shear_warp, shear_warp_rowmajor

    return {"mrf_epilogue": mrf_epilogue, "mrf_epilogue_bwd": mrf_epilogue_bwd,
            "mrf_fft_tail": fused_tail, "mrf_fft_tail_1pass": Count(fused_tail, "launches_1pass"),
            "shear_warp": shear_warp, "shear_warp_rowmajor": shear_warp_rowmajor,
            "fft_conv_tail_kdft_resident": fc.tail_kdft_resident,
            "fft_conv_tail_kdft": fc.tail_kdft, "fft_conv_tail_kf": fc.tail_kf}


def step_config():
    """``flagship`` with ``mrf.impl='pallas'`` in fp32: the sharded step's
    parity config (the epilogue kernel, the shear warp, TF32 off)."""
    from jointpose_torch import get_config

    flag = get_config("flagship")
    return flag.replace(mrf=dataclasses.replace(flag.mrf, impl="pallas"), compute_dtype="float32")


def parallel_step(mesh, device, counters: dict, cudnn: bool, spatial: bool = False) -> dict:
    """One joint-stage step of ``step_config()`` from seeded weights on this
    rank's rows of the synthetic source's first global batch; with
    ``cudnn=False`` every convolution is PyTorch's own (im2col and a GEMM
    per image), whose arithmetic per image does not depend on the batch.
    ``spatial``: the trunk's image rows split over 'model' too."""
    from jointpose_torch.configs import MeshConfig
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.parallel.mesh import shard_batch, shard_state
    from jointpose_torch.train import create_state, make_train_step

    cfg = step_config().replace(mesh=MeshConfig(data=mesh.shape["data"], model=mesh.shape["model"],
                                                spatial=spatial))
    state = create_state(cfg, torch.Generator().manual_seed(PARALLEL_SEED), device=device, mesh=mesh)
    state = shard_state(state, mesh)
    batch = make_dataset(cfg.data, device)[0].get_batch(np.arange(cfg.train.batch_size))
    local = shard_batch(batch, mesh)
    step = make_train_step(cfg, "joint", mesh)
    reset(counters)
    with torch.backends.cudnn.flags(enabled=cudnn, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        state, metrics = step(state, local)
    torch.cuda.synchronize(device)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {n: p.detach().cpu() for n, p in state.model.named_parameters()},
            "grads": {n: p.grad.cpu() for n, p in state.model.named_parameters()},
            "launches": {n: fn.launches for n, fn in counters.items()},
            "rows": int(local["image"].shape[0]),
            "sliced": sorted(state.model.model_sliced_parameters()),
            "spatial": state.model.spatial}


def parallel_preset_step(mesh, device, counters: dict, spatial: bool = False) -> dict:
    """One joint-stage step of ``flagship`` as its preset stands ('auto' ->
    'xla': the grouped conv's autograd function; bf16; augmentation with the
    shear warp, the global draw sliced) from seeded weights on this rank's
    rows of the synthetic source's first global batch, under cuDNN's
    deterministic algorithms, then PRESET_TIMED_STEPS more for a rank's
    step time (host clock around synchronized steps).  The uniform spatial
    kernels are perturbed alike on every rank: uniform kernels make the
    biases' gradient nearly a constant over the map, which the spatial
    softmax cancels to rounding noise.  Records the groups of each call of
    ``grouped_conv_f32``."""
    from jointpose_torch import get_config
    from jointpose_torch.configs import MeshConfig
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.ops import mrf_xla
    from jointpose_torch.parallel.mesh import shard_batch, shard_state
    from jointpose_torch.train import create_state, make_train_step

    cfg = get_config("flagship").replace(mesh=MeshConfig(
        data=mesh.shape["data"], model=mesh.shape["model"], spatial=spatial))
    state = create_state(cfg, torch.Generator().manual_seed(PARALLEL_SEED), device=device, mesh=mesh)
    raw = state.model.spatial_model.raw_kernels
    with torch.no_grad():
        raw += 0.5 * torch.randn(raw.shape, generator=torch.Generator().manual_seed(PARALLEL_SEED)).to(
            raw.device)
    state = shard_state(state, mesh)
    batch = make_dataset(cfg.data, device)[0].get_batch(np.arange(cfg.train.batch_size))
    local = shard_batch(batch, mesh)
    step = make_train_step(cfg, "joint", mesh)
    function, groups = mrf_xla.grouped_conv_f32, []

    def recording(p, kern, n):
        groups.append(n)
        return function(p, kern, n)

    reset(counters)
    mrf_xla.grouped_conv_f32 = recording
    try:
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False):
            state, metrics = step(state, local)
            torch.cuda.synchronize(device)
            res = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "params": {n: p.detach().to("cpu", copy=True)
                              for n, p in state.model.named_parameters()},
                   "grads": {n: p.grad.to("cpu", copy=True) for n, p in state.model.named_parameters()},
                   "launches": {n: fn.launches for n, fn in counters.items()},
                   "groups": list(groups), "rows": int(local["image"].shape[0]),
                   "sliced": sorted(state.model.model_sliced_parameters()),
                   "spatial": state.model.spatial}
            times = []
            for _ in range(PRESET_TIMED_STEPS):
                t0 = time.perf_counter()
                state, _ = step(state, local)
                torch.cuda.synchronize(device)
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        mrf_xla.grouped_conv_f32 = function
    res["step_ms"] = float(np.median(times))
    return res


class _Spy:
    """Stands in for a kernel wrapper in its module: records the shapes of
    each call's operands, then calls the wrapper.  Its attributes are the
    wrapper's, so the wrapper's body, which counts on the module's name,
    still counts on itself."""

    def __init__(self, fn, shape_of, seen: list):
        object.__setattr__(self, "_call", (fn, shape_of, seen))

    def __call__(self, *args, **kwargs):
        fn, shape_of, seen = self._call
        seen.append(shape_of(*args, **kwargs))
        return fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._call[0], name)

    def __setattr__(self, name, value):
        setattr(self._call[0], name, value)


@contextlib.contextmanager
def tail_shapes():
    """Record the operands' shapes of every launch of the Fourier MRF tail
    (``pf_re`` (B, Kv, Ph, G), biases (Kv, Ka)) and of the head-conv tails
    (``xr`` (G, Ph, B, Ci), ``a_re`` (G, Kh, Ci, Co)): yields
    {wrapper name: [shapes, ...]} of the wrappers called."""
    from jointpose_torch.ops import fft_conv as fc
    from jointpose_torch.ops import mrf_fft_fused as mf

    seen: dict = {}
    spied = [(mf, "fused_tail", lambda pf, kf, tables, biases, *a, **k: (
                 tuple(pf[0].shape), tuple(biases.shape))),
             (fc, "tail_kdft_resident", lambda xr, xi, a_re, a_im, t: (
                 tuple(xr.shape), tuple(a_re.shape))),
             (fc, "tail_kdft", lambda xr, xi, a_re, a_im, t: (tuple(xr.shape), tuple(a_re.shape)))]
    originals = [getattr(module, attr) for module, attr, _ in spied]
    for (module, attr, shape_of), fn in zip(spied, originals):
        setattr(module, attr, _Spy(fn, shape_of, seen.setdefault(attr, [])))
    try:
        yield seen
    finally:
        for (module, attr, _), fn in zip(spied, originals):
            setattr(module, attr, fn)
        for attr in [attr for attr, shapes in seen.items() if not shapes]:
            del seen[attr]


def joint_tp_checks(device, counters: dict) -> dict:
    """``joint`` at full width under tensor parallelism on meshes of model 2
    (2x2) and 4 (1x4): the MRF's log-heatmaps at 'high' (3xTF32 tail) and
    'default' (one TF32 pass) and its parameters' gradients against the
    unsharded spatial model, and the Fourier head's logits against the
    unsliced detector (the dispatcher's tail, then steered to the
    batch-tiled one).  Every forward runs with the counts at 0 and its
    tails' operand shapes recorded (``tail_shapes``): the sharded ones and
    the unsharded references apart."""
    from jointpose_torch import get_config
    from jointpose_torch.configs import MeshConfig, with_mrf_precision
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.ops import fft_conv as fc
    from jointpose_torch.parallel.mesh import make_mesh
    from jointpose_torch.predict import init_state_dict

    joint = get_config("joint")
    gen = torch.Generator().manual_seed(PARALLEL_SEED)
    weights = init_state_dict(joint, gen)
    weights["spatial_model.raw_kernels"] += 0.5 * torch.randn(
        weights["spatial_model.raw_kernels"].shape, generator=gen)
    h, w = joint.heatmap_hw
    u = unaries(gen, BATCH, h, w, joint.num_joints, torch.float32)
    cot = torch.randn(u.shape, generator=gen).to(device)
    images = torch.randint(0, 256, (BATCH, *joint.data.image_hw, 3), generator=gen,
                           dtype=torch.uint8).to(device)

    def build(cfg, mesh=None):
        model = PoseModel(cfg, mesh=mesh)
        model.load_state_dict(weights)
        return model.to(device)

    def counted(fn) -> tuple:
        """fn() with every count at 0 -> (its result, {kernel: launches}
        of the kernels it launched, {wrapper: [operand shapes]})."""
        reset(counters)
        with tail_shapes() as shapes:
            out = fn()
            torch.cuda.synchronize(device)
        return out, {name: c.launches for name, c in counters.items() if c.launches}, shapes

    def mrf_run(model, mesh=None):
        sm = model.spatial_model
        out, launched, shapes = counted(lambda: sm(u))
        (out * cot).sum().backward()
        grads = [p.grad.clone() for p in (sm.raw_kernels, sm.raw_bias)]
        if mesh is not None:  # used in this rank's source slice only
            grads = [mesh.all_reduce(g, "model") for g in grads]
        return out.detach(), grads, {"launches": launched, "shapes": shapes}

    res = {}
    for n in (2, 4):
        mesh = make_mesh(MeshConfig(data=4 // n, model=n))
        for precision in ("high", "default"):
            cfg = with_mrf_precision(joint, precision)
            want, want_g, ref = mrf_run(build(cfg))
            got, got_g, tp = mrf_run(build(cfg, mesh), mesh)
            res["mrf", n, precision] = (rel_err(got, want), *(rel_err(a, b)[0]
                                                             for a, b in zip(got_g, want_g)))
            res["mrf launches", n, precision] = {"tp": tp, "unsharded": ref}
        fft = joint.replace(detector=dataclasses.replace(joint.detector, head_conv_impl="fft"))
        with torch.inference_mode():
            want, *ref = counted(lambda: build(fft).detector(images))
            tp_model = build(fft, mesh)
            got, *tp = counted(lambda: tp_model.detector(images))
            preference = fc.TAIL_PREFERENCE
            fc.TAIL_PREFERENCE = ("kdft",)
            try:
                steered, *tp_steered = counted(lambda: tp_model.detector(images))
            finally:
                fc.TAIL_PREFERENCE = preference
        res["head", n] = (rel_err(got, want), rel_err(steered, want))
        res["head launches", n] = {
            what: {"launches": launched, "shapes": shapes}
            for what, (launched, shapes) in (("tp", tp), ("tp steered", tp_steered),
                                             ("unsliced", ref))}
    return res


def joint_spatial_checks(device, counters: dict, mesh) -> dict:
    """``joint`` at full width in fp32 over the 2x2 mesh with spatial
    parallelism (the trunk's rows over model 2, halo exchanges, then the
    head's channels and the MRF's sources over 'model') against the
    unsharded model on the same images, at 'high' and 'default': the
    detector logits and the MRF's log-heatmaps, each forward counted alone."""
    from jointpose_torch import get_config
    from jointpose_torch.configs import with_mrf_precision
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.predict import init_state_dict

    joint = get_config("joint").replace(compute_dtype="float32")
    gen = torch.Generator().manual_seed(PARALLEL_SEED)
    weights = init_state_dict(joint, gen)
    weights["spatial_model.raw_kernels"] += 0.5 * torch.randn(
        weights["spatial_model.raw_kernels"].shape, generator=gen)
    images = torch.randint(0, 256, (BATCH, *joint.data.image_hw, 3), generator=gen,
                           dtype=torch.uint8).to(device)
    res = {}
    for precision in ("high", "default"):
        cfg = with_mrf_precision(joint, precision)
        outs = {}
        for what, sp_mesh in (("unsharded", None), ("spatial", mesh)):
            model = PoseModel(cfg, mesh=sp_mesh, spatial=sp_mesh is not None)
            model.load_state_dict(weights)
            model = model.to(device).eval()
            check(model.spatial == (sp_mesh is not None), f"the {what} joint model's spatial flag")
            with torch.inference_mode():
                model(images)  # warm-up: cuDNN's choice, DFT tables
                torch.cuda.synchronize(device)
                reset(counters)
                out = model(images)
                torch.cuda.synchronize(device)
            outs[what] = ({k: v.cpu() for k, v in out.items()},
                          {n: c.launches for n, c in counters.items() if c.launches})
        (got, launched), (want, ref) = outs["spatial"], outs["unsharded"]
        res[precision] = {"logits": rel_err(got["detector_logits"], want["detector_logits"]),
                          "mrf": rel_err(got["mrf_log_heatmaps"], want["mrf_log_heatmaps"]),
                          "launches": launched, "unsharded_launches": ref}
    return res


def spatial_timing(mesh, device, steps: int = 5) -> dict:
    """Per rank: the joint step of ``flagship(mrf.impl='pallas')`` (bf16,
    global batch 32) over the 2x2 mesh with and without spatial
    parallelism, wall per step (median of ``steps`` after two warm-ups),
    and the trunk's time on the device (CUDA events around the fused
    features of this rank's rows of batch 16, exchanges and gather
    included; median of 10), in turns."""
    from jointpose_torch.configs import MeshConfig
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.models.detector import _avg_pyramid, _upsample2x, spatial_features
    from jointpose_torch.models.pose import unit_images
    from jointpose_torch.parallel.mesh import shard_batch, shard_state
    from jointpose_torch.parallel.spatial import ProcessRows
    from jointpose_torch.train import create_state, make_train_step

    flag = step_config().replace(compute_dtype="bfloat16")
    batch = make_dataset(flag.data, device)[0].get_batch(np.arange(flag.train.batch_size))
    local = shard_batch(batch, mesh)
    out = {}
    for spatial in (False, True, True, False):
        what = "spatial" if spatial else "tensor-parallel"
        cfg = flag.replace(mesh=MeshConfig(data=2, model=2, spatial=spatial))
        state = shard_state(create_state(cfg, torch.Generator().manual_seed(PARALLEL_SEED),
                                         device=device, mesh=mesh), mesh)
        step = make_train_step(cfg, "joint", mesh)
        walls = []
        for i in range(steps + 2):
            torch.cuda.synchronize(device)
            mesh.any(False)  # the ranks start the step together
            t0 = time.perf_counter()
            state, _ = step(state, local)
            torch.cuda.synchronize(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        det = state.model.detector
        x = det.normalized(unit_images(local["image"].to(device), torch.bfloat16))

        def trunk():
            if spatial:
                return spatial_features([det], x, ProcessRows(mesh))
            return det.trunk(x) + _upsample2x(det.trunk(_avg_pyramid(x)))

        trunk_ms = []
        with torch.inference_mode():
            for i in range(12):
                mesh.any(False)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                trunk()
                end.record()
                end.synchronize()
                trunk_ms.append(start.elapsed_time(end))
        out.setdefault(what, []).append({"step_ms": float(np.median(walls[2:])),
                                         "trunk_ms": float(np.median(trunk_ms[2:]))})
    return {what: {k: min(r[k] for r in runs) for k in runs[0]} for what, runs in out.items()}


def parallel_child(task: str, out: str) -> None:
    """One rank of a world that ``parallel_phase`` launches through
    ``python -m torch.distributed.run``: 'reference' (a world of 1: the
    one-device step), 'data' (2: the data-2 step, then a data-2 ``fit``),
    'model' (4: the 2x2 step, ``joint_tp_checks``, the 2x2 spatial step,
    ``joint_spatial_checks``, ``spatial_timing``, then a spatial ``fit``).  Writes
    ``<out>/<task>_rank<r>.pt``."""
    import torch.distributed as dist

    from jointpose_torch.configs import MeshConfig
    from jointpose_torch.parallel.mesh import init_distributed, make_mesh, shutdown_distributed

    device = init_distributed()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    rank = dist.get_rank()
    mesh = make_mesh(MeshConfig(data=-1, model=2 if task == "model" else 1))
    res = {"mesh": dict(mesh.shape), "device": str(device), "backend": dist.get_backend()}
    t0 = time.perf_counter()
    res["step"] = parallel_step(mesh, device, counters, cudnn=False)
    res["step_s"] = time.perf_counter() - t0
    res["step_cudnn"] = parallel_step(mesh, device, counters, cudnn=True)
    t0 = time.perf_counter()
    res["step_preset"] = parallel_preset_step(mesh, device, counters)
    if task == "model":
        res["step_preset_spatial"] = parallel_preset_step(mesh, device, counters, spatial=True)
    res["preset_s"] = time.perf_counter() - t0
    if task == "data":
        from jointpose_torch.train import fit

        flag = step_config()
        cfg = flag.replace(compute_dtype="bfloat16", train=dataclasses.replace(
            flag.train, detector_steps=3, joint_steps=3, eval_every=3, log_every=3))
        reset(counters)
        t0 = time.perf_counter()
        result = fit(cfg, os.path.join(out, "fit"), eval_max_batches=1, device=device)
        res["fit"] = {"wall_s": time.perf_counter() - t0, "step": result.state.step,
                      "pdj": result.metrics["pdj_at_05_wrist_elbow"],
                      "launches": {n: fn.launches for n, fn in counters.items()}}
    if task == "model":
        from jointpose_torch.train import fit

        t0 = time.perf_counter()
        res["joint_tp"] = joint_tp_checks(device, counters)
        res["joint_tp_s"] = time.perf_counter() - t0
        # Spatial parallelism: the trunk's rows over model 2 as well.
        res["step_spatial"] = parallel_step(mesh, device, counters, cudnn=False, spatial=True)
        res["step_spatial_cudnn"] = parallel_step(mesh, device, counters, cudnn=True, spatial=True)
        res["joint_spatial"] = joint_spatial_checks(device, counters, mesh)
        res["timing"] = spatial_timing(mesh, device)
        flag = step_config()
        cfg = flag.replace(compute_dtype="bfloat16", mesh=MeshConfig(data=2, model=2, spatial=True),
                           train=dataclasses.replace(flag.train, detector_steps=2, joint_steps=2,
                                                     eval_every=2, log_every=2))
        reset(counters)
        t0 = time.perf_counter()
        result = fit(cfg, os.path.join(out, "fit_spatial"), eval_max_batches=1, device=device)
        res["fit"] = {"wall_s": time.perf_counter() - t0, "step": result.state.step,
                      "spatial": result.state.model.spatial,
                      "pdj": result.metrics["pdj_at_05_wrist_elbow"],
                      "launches": {n: fn.launches for n, fn in counters.items()}}
    torch.save(res, os.path.join(out, f"{task}_rank{rank}.pt"))
    shutdown_distributed()


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max(|got - want| / (atol + rtol |want|)): at most 1 within the tolerance."""
    got, want = got.double(), want.double()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


# ``evaluate.main`` in each rank of a ``torch.distributed.run`` group, with the
# preset's MRF impl set to the one the checkpoint was trained with (argv[1]),
# as PREDICT_CHILD does.  Writes the rank's epilogue launches at exit to
# ``<argv[2]>.<RANK>.json``: the ranks share one stdout, where their lines
# can interleave.
EVALUATE_CHILD = """
import dataclasses, json, os, sys
import jointpose_torch.configs as configs
from jointpose_torch import evaluate
from jointpose_torch.ops.mrf_epilogue import mrf_epilogue
preset = configs.get_config
configs.get_config = lambda name: preset(name).replace(
    mrf=dataclasses.replace(preset(name).mrf, impl=sys.argv[1]))
evaluate.main(sys.argv[3:])
with open(f"{sys.argv[2]}.{os.environ['RANK']}.json", "w") as f:
    json.dump({"mrf_epilogue": mrf_epilogue.launches}, f)
"""


def inference_mesh_phase(joint, fit_cfg, ckpt_dir: str, tmp: str, counters: dict, smi: str) -> dict:
    """Inference over a 2x2 device mesh in one process (``make_device_mesh``:
    ``[cuda:0] * 4`` on one card, a card each on four), the trunk's rows
    over 'model': ``build_predictor(mesh=)`` of ``joint`` at 'default',
    batch 8, against the one-device predictor (in fp32 the heatmaps held,
    in bf16 as served the coordinates' agreement and both p50s printed);
    ``PoseService(mesh=)``; ``predict.main --mesh-data 2 --mesh-model 2`` as
    a process and ``evaluate.main --mesh-model 2`` under ``python -m
    torch.distributed.run --nproc-per-node 2``, both on the spatial ``fit``'s
    checkpoint ``ckpt_dir`` of ``fit_cfg``."""
    from jointpose_torch.checkpoint import reconcile_config
    from jointpose_torch.configs import with_mrf_precision
    from jointpose_torch.convert import write_initial_checkpoint
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.evaluate import evaluate
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.parallel.mesh import make_device_mesh
    from jointpose_torch.predict import build_predictor, init_state_dict, restore_params
    from jointpose_torch.serve import PoseService

    out: dict = {}
    mesh = make_device_mesh(2, 2, "cuda")
    gen = torch.Generator().manual_seed(PARALLEL_SEED)
    weights = init_state_dict(joint, gen)
    weights["spatial_model.raw_kernels"] += 0.5 * torch.randn(
        weights["spatial_model.raw_kernels"].shape, generator=gen)
    h, w = joint.data.image_hw
    images = torch.randint(0, 256, (BATCH, h, w, 3), generator=gen, dtype=torch.uint8).cuda()

    def p50_ms(fn) -> float:
        walls = []
        for _ in range(PIPE_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(images)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    # 1. The device-mesh predictor against one device.
    served = with_mrf_precision(joint, "default")
    for dtype in ("float32", "bfloat16"):
        cfg = served.replace(compute_dtype=dtype)
        one = build_predictor(cfg, weights)
        on_mesh = build_predictor(cfg, weights, mesh=mesh, spatial=True)
        (c1, p1), (c2, p2) = one(images), on_mesh(images)
        reset(counters)
        c2, p2 = on_mesh(images)
        torch.cuda.synchronize()
        launched = {n: c.launches for n, c in counters.items() if c.launches}
        res = {"prob_rel": rel_err(p2.float(), p1.float())[0],
               "coords_equal": ((c2 - c1).abs() <= PIPE_COORD_ATOL).float().mean().item(),
               "p50_ms": p50_ms(on_mesh), "one_device_p50_ms": p50_ms(one), "launches": launched}
        out[f"predictor {dtype}"] = res
        held = dtype == "float32"
        print(f"inference mesh: build_predictor of joint at 'default' ({dtype}), batch {BATCH}, over "
              f"{mesh} (the trunk's rows over model 2, spatial): heatmaps rel err {res['prob_rel']:.3e} "
              f"against the one-device predictor ({'limit %g' % SINGLE_PASS_RTOL if held else 'not held'}), "
              f"{res['coords_equal']:.4f} of the coordinates within {PIPE_COORD_ATOL:g} px; launches "
              f"{launched}; p50 {res['p50_ms']:.3f} ms against one device's "
              f"{res['one_device_p50_ms']:.3f} ms (no claim); on {smi}")
        if held:
            check(res["prob_rel"] <= SINGLE_PASS_RTOL, "the device-mesh predictor strays in fp32")
        check(launched.get("mrf_fft_tail_1pass") == mesh.shape["data"],
              f"the device-mesh predictor launched {launched}, not the single-pass tail once a data row")

    # 2. PoseService over the mesh: requests padded to buckets of 2 and 8.
    joint_dir = os.path.join(tmp, "joint_mesh")
    write_initial_checkpoint(joint, joint_dir, weights)
    cfg = with_mrf_precision(reconcile_config(joint, joint_dir), "default")
    service = PoseService(cfg, joint_dir, batch_size=BATCH, step=0, mesh=mesh, batch_buckets=[2])
    direct = build_predictor(cfg, weights, mesh=mesh, spatial=True)
    sizes, worst, dispatches = (1, 3, 8, 5), 0.0, service.stats["dispatches"]
    try:
        reset(counters)
        for n in sizes:
            batch = images[:n].cpu().numpy()
            got = _pred_coords(service.predict(batch))
            bucket = 2 if n <= 2 else BATCH
            padded = np.concatenate([batch, np.zeros((bucket - n, h, w, 3), np.uint8)])
            want = direct(torch.from_numpy(padded))[0][:n].cpu().numpy()
            worst = max(worst, float(np.abs(got - want).max()))
        torch.cuda.synchronize()
        launched = counters["mrf_fft_tail_1pass"].launches
    finally:
        service.close()
    dispatches = service.stats["dispatches"] - dispatches
    print(f"inference mesh: PoseService(mesh={mesh}, batch_size={BATCH}, batch_buckets=[2]) at "
          f"'default': {len(sizes)} requests of {list(sizes)} uint8 images in {dispatches} dispatches, "
          f"coordinates max {worst:.2e} px from build_predictor(mesh=) on the padded batches; "
          f"single-pass tail launches {launched} with those of build_predictor (a data row each)")
    check(worst <= PIPE_COORD_ATOL, "PoseService(mesh=) answers unlike build_predictor(mesh=)")
    check(dispatches == len(sizes) and launched == 2 * mesh.shape["data"] * len(sizes),
          f"PoseService(mesh=): {dispatches} dispatches, {launched} single-pass tail launches")
    out["service"] = {"max_px": worst, "dispatches": dispatches}

    # 3. The CLIs on the spatial fit's checkpoint.
    fit_served = with_mrf_precision(reconcile_config(fit_cfg, ckpt_dir), "default")
    state, step = restore_params(fit_served, ckpt_dir)
    _, test_ds = make_dataset(fit_served.data)
    num = 2 * BATCH
    workdir = os.path.join(tmp, "predict_mesh")
    text, child_s = _child(["-c", PREDICT_CHILD, fit_cfg.mrf.impl, "--config", fit_cfg.name,
                            "--checkpoint", ckpt_dir, "--workdir", workdir, "--num", str(num),
                            "--batch-size", str(BATCH), "--mesh-data", "2", "--mesh-model", "2"],
                           "predict.main --mesh-data 2 --mesh-model 2")
    launches = json.loads(text.split("launches ", 1)[1].splitlines()[0])
    with open(os.path.join(workdir, "predictions.jsonl")) as f:
        got = np.array([list(json.loads(line)["joints"].values()) for line in f], np.float32)
    batch = test_ds.get_batch(np.arange(num))["image"]
    on_mesh = build_predictor(fit_served, state, mesh=mesh, spatial=True)
    want = np.concatenate([on_mesh(batch[i:i + BATCH])[0].cpu().numpy() for i in range(0, num, BATCH)])
    one = np.concatenate([build_predictor(fit_served, state)(batch[i:i + BATCH])[0].cpu().numpy()
                          for i in range(0, num, BATCH)])
    diff = float(np.abs(got - want).max())
    same = float((np.abs(got - one) <= PIPE_COORD_ATOL).mean())
    print(f"inference mesh: predict.main --mesh-data 2 --mesh-model 2 on the spatial fit's checkpoint "
          f"({fit_cfg.name}, mrf.impl={fit_cfg.mrf.impl!r}, step {step}) as a process: {len(got)} "
          f"records in {child_s:.1f} s, max {diff:.2e} px from build_predictor(mesh=) in this process "
          f"(limit 1e-3), {same:.4f} of the coordinates within {PIPE_COORD_ATOL:g} px of the one-device "
          f"predictor's (not held: bf16 convs on row shards), epilogue launches {launches['mrf_epilogue']}")
    check(len(got) == num and diff <= 1e-3, f"predict.main over the mesh: records {len(got)}, {diff} px")
    check(launches["mrf_epilogue"] == 2 * (num // BATCH),
          f"predict.main over the mesh launched the epilogue {launches['mrf_epilogue']} times")
    out["predict_main"] = {"max_px": diff, "one_device_equal": same, "s": child_s}

    script = os.path.join(tmp, "evaluate_child.py")
    with open(script, "w") as f:
        f.write(EVALUATE_CHILD)
    metrics_path = os.path.join(tmp, "evaluate_mesh.json")
    launches_path = os.path.join(tmp, "evaluate_launches")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {"PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    _, eval_s = _child(
        ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         script, fit_cfg.mrf.impl, launches_path, "--config", fit_cfg.name, "--checkpoint", ckpt_dir,
         "--mesh-model", "2", "--max-batches", "2", "--json-out", metrics_path],
        "evaluate.main under torch.distributed.run", env)
    rank_launches = []
    for rank in range(2):
        with open(f"{launches_path}.{rank}.json") as f:
            rank_launches.append(json.load(f)["mrf_epilogue"])
    with open(metrics_path) as f:
        ev = json.load(f)
    model = PoseModel(fit_cfg)
    model.load_state_dict(state)
    one_ev = evaluate(model.cuda().eval(), test_ds, fit_cfg, max_batches=2)
    print(f"inference mesh: evaluate.main --mesh-model 2 --max-batches 2 under torch.distributed.run "
          f"--nproc-per-node 2 on the spatial fit's checkpoint: {ev['num_examples']:.0f} examples, "
          f"PDJ@0.05 wrist/elbow {ev['pdj_at_05_wrist_elbow']:.4f} against one device's "
          f"{one_ev['pdj_at_05_wrist_elbow']:.4f} (not held: bf16), epilogue launches per rank "
          f"{rank_launches}, {eval_s:.1f} s with start-up")
    check(ev["num_examples"] == one_ev["num_examples"] == 2 * fit_cfg.train.batch_size,
          f"evaluate.main over the mesh scored {ev['num_examples']} examples")
    check(0.0 <= ev["pdj_at_05_wrist_elbow"] <= 1.0, "evaluate.main over the mesh: PDJ")
    check(rank_launches == [2, 2], f"evaluate.main's ranks launched the epilogue {rank_launches} times")
    out["evaluate_main"] = {"pdj": ev["pdj_at_05_wrist_elbow"], "one_device_pdj":
                            one_ev["pdj_at_05_wrist_elbow"], "s": eval_s}
    return out


def preset_step_checks(ranks: dict, smi: str) -> dict:
    """``flagship`` as its preset stands ('auto' -> 'xla', bf16) sharded over
    data 2, 2x2 and 2x2 spatial (``parallel_preset_step`` in the worlds of
    ``parallel_phase``, by task) against its one-device step, at the CPU
    tests' bf16 bars (PRESET_*): the loss, every gradient, the parameters,
    grouped_conv_f32's groups (9, or 5 of the padded 10 sources at model
    2), the warp once and no MRF kernel.  Prints a rank's step time."""
    from jointpose_torch import get_config

    shared = torch.cuda.device_count() == 1
    train_cfg = get_config("flagship").train
    preset_flip = 2 * train_cfg.learning_rate * max(1.0, train_cfg.mrf_lr_mult) + STEP_PARAM_ATOL
    pref = ranks["reference"][0]["step_preset"]
    preset_params = sum(w.numel() for w in pref["params"].values())

    def compare_preset(got: dict) -> dict:
        out = {"loss_rel": abs(got["metrics"]["loss"] - pref["metrics"]["loss"])
               / abs(pref["metrics"]["loss"]),
               "grad": max((rel_err(got["grads"][n], g)[0], n) for n, g in pref["grads"].items()),
               "param": (0.0, ""), "exempt": 0, "beyond": 0, "flip_share": 0.0}
        for n, w in pref["params"].items():
            g = pref["grads"][n].double().abs()
            held = g >= PRESET_GRAD_RTOL * g.max()
            diff = (got["params"][n].double() - w.double()).abs()
            share = diff / (STEP_PARAM_ATOL + STEP_PARAM_RTOL * w.double().abs())
            if held.any():
                out["param"] = max(out["param"], (share[held].max().item(), n))
            if not held.all():
                out["exempt"] += int((~held).sum())
                out["beyond"] += int((share[~held] > 1).sum())
                out["flip_share"] = max(out["flip_share"], diff[~held].max().item() / preset_flip)
        return out

    check(pref["groups"] == [9] and pref["launches"]["shear_warp"] == 1
          and all(pref["launches"][n] == 0 for n in MRF_KERNELS),
          f"the one-device step of flagship as its preset stands ran grouped_conv_f32 with "
          f"groups {pref['groups']} and launched {pref['launches']}")
    flips_p = int(PRESET_FLIP_SHARE * preset_params)
    print(f"parallel step, flagship as the preset stands (mrf 'auto' -> 'xla', bf16, augmentation "
          f"with the shear warp, global batch {train_cfg.batch_size}, cuDNN's deterministic "
          f"algorithms), one device: loss {pref['metrics']['loss']:.7f}, grouped_conv_f32 with "
          f"{pref['groups']} groups, launches {pref['launches']}; a step {pref['step_ms']:.3f} ms "
          f"(median of {PRESET_TIMED_STEPS}, host clock); on {smi}")
    summary = {"reference_step_ms": pref["step_ms"], "warp_launches": pref["launches"]["shear_warp"]}
    for task, key, what, sources in (("data", "step_preset", "data 2", 9),
                                     ("model", "step_preset", "2x2", 5),
                                     ("model", "step_preset_spatial", "2x2 spatial", 5)):
        cs = []
        for r, res in enumerate(ranks[task]):
            got = res[key]
            c = compare_preset(got)
            cs.append(c)
            check(c["loss_rel"] <= PRESET_LOSS_RTOL, f"the preset's {what} step's loss strays on "
                  f"rank {r}: {c['loss_rel']:.3e}")
            check(c["grad"][0] <= PRESET_GRAD_RTOL, f"the preset's {what} step's {c['grad'][1]} "
                  f"gradient strays on rank {r}: {c['grad'][0]:.3e}")
            check(c["param"][0] <= 1.0, f"the preset's {what} step's {c['param'][1]} strays on "
                  f"rank {r}")
            check(c["flip_share"] <= 1.0, f"the preset's {what} step moved a parameter by more "
                  f"than a flipped update on rank {r}")
            check(c["beyond"] <= flips_p, f"the preset's {what} step left {c['beyond']} "
                  f"parameters beyond the tolerance on rank {r} (limit {flips_p})")
            check(got["groups"] == [sources] and got["launches"]["shear_warp"] == 1
                  and all(got["launches"][n] == 0 for n in MRF_KERNELS),
                  f"the preset's {what} step ran grouped_conv_f32 with groups {got['groups']} and "
                  f"launched {got['launches']} on rank {r}, not {sources} groups and the warp once")
            check(got["spatial"] == (key == "step_preset_spatial"),
                  f"the preset's {what} step's spatial flag")
        worst = max(cs, key=lambda c: c["grad"][0])
        ms = [res[key]["step_ms"] for res in ranks[task]]
        print(f"parallel step {what}, flagship as the preset stands (bf16, 'xla', "
              f"{ranks[task][0][key]['rows']} rows a rank): against one device, worst rank: loss rel "
              f"{max(c['loss_rel'] for c in cs):.3e} (limit {PRESET_LOSS_RTOL:g}); gradients rel "
              f"{worst['grad'][0]:.3e} (limit {PRESET_GRAD_RTOL:g}, worst {worst['grad'][1]}); "
              f"parameters whose gradient is at least {PRESET_GRAD_RTOL:g} of their tensor's "
              f"largest at {max(c['param'][0] for c in cs):.4f} of the tolerance; the other "
              f"{cs[0]['exempt']} of {preset_params} exempt, at most "
              f"{max(c['beyond'] for c in cs)} beyond the tolerance (limit {flips_p}), at most "
              f"{max(c['flip_share'] for c in cs):.3f} of a flipped update; grouped_conv_f32 with "
              f"{ranks[task][0][key]['groups']} groups a rank; launches "
              f"{ranks[task][0][key]['launches']}; a step a rank "
              f"{', '.join(f'{t:.3f}' for t in ms)} ms (median of {PRESET_TIMED_STEPS}, host "
              f"clock{'; the ranks share one card over gloo: no claim' if shared else ''}); "
              f"on {smi}")
        summary[f"{key}_{task}"] = {"worst": worst, "step_ms": ms}
    print("parallel: the preset's steps took " + ", ".join(
        f"{ranks[task][0]['preset_s']:.1f} s in the {task} world" for task in ranks))
    return summary



def parallel_phase(joint, counters: dict, smi: str) -> dict:
    """The mesh over processes and the pipelined predictor on the one card.

    Worlds of 1, 2 and 4 ranks on ``cuda:0`` (gloo: the ranks share the
    card) through ``python -m torch.distributed.run``, under cuDNN's and
    PyTorch's deterministic algorithms: the one-device step, the data-2
    step and the 2x2 step of ``step_config()`` at the global batch of 32,
    held against each other at the reference's tolerance; a data-2 ``fit``
    whose rank-0 checkpoint a one-device predictor restores; ``joint``
    under tensor parallelism (``joint_tp_checks``); in the 4-rank world
    the 2x2 step with spatial parallelism, ``joint``'s spatial forward
    (``joint_spatial_checks``), a spatial ``fit`` and the step and trunk
    times (``spatial_timing``).  The inference meshes on the spatial fit's
    checkpoint (``inference_mesh_phase``).  Then, in this process,
    the two-stage pipelined predictor of ``joint`` on ``[cuda:0, cuda:0]``
    against ``build_predictor``, and the kernels at the paths' shard-local
    shapes against their plain versions.  Returns the numbers it printed."""
    from jointpose_torch.configs import with_mrf_precision
    from jointpose_torch.parallel.pipeline import build_pipelined_predictor, split_stage_devices
    from jointpose_torch.predict import build_predictor, init_state_dict, restore_params

    summary: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        site = os.path.join(tmp, "site")
        os.makedirs(site)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(DETERMINISTIC_SITE)
        env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8", "PYTHONPATH": os.pathsep.join(
            filter(None, [site, os.environ.get("PYTHONPATH")]))}
        ranks, walls = {}, {}
        for task, n in (("reference", 1), ("data", 2), ("model", 4)):
            _, walls[task] = _child(
                ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(n),
                 os.path.abspath(__file__), "--parallel-child", task, tmp],
                f"the {task} world of {n}", env, timeout=900)
            ranks[task] = [torch.load(os.path.join(tmp, f"{task}_rank{r}.pt"), weights_only=False)
                           for r in range(n)]
            print(f"parallel: the {task} world of {n} rank(s) on "
                  f"{[res['device'] for res in ranks[task]]}, "
                  f"backend {ranks[task][0]['backend']}, mesh {ranks[task][0]['mesh']}: "
                  f"{walls[task]:.1f} s wall (processes included)")
        # The rank-0 checkpoint of the data-2 fit on one device.
        cfg_fit = step_config().replace(compute_dtype="bfloat16")
        state_dict, ckpt_step = restore_params(cfg_fit, os.path.join(tmp, "fit", "checkpoints"))
        h, w = cfg_fit.data.image_hw
        probe = torch.randint(0, 256, (BATCH, h, w, 3), generator=torch.Generator().manual_seed(9),
                              dtype=torch.uint8).cuda()
        coords, probs = build_predictor(cfg_fit, state_dict)(probe)
        # The rank-0 checkpoint of the spatial fit (the 'model' world) on one
        # device, then inference over a device mesh and the mesh CLIs on it.
        sp_dir = os.path.join(tmp, "fit_spatial", "checkpoints")
        sp_state, sp_step = restore_params(cfg_fit, sp_dir)
        sp_coords, sp_probs = build_predictor(cfg_fit, sp_state)(probe)
        torch.cuda.synchronize()
        summary["inference_mesh"] = inference_mesh_phase(joint, cfg_fit, sp_dir, tmp, counters, smi)

    # 1. The sharded steps against the one-device step, with PyTorch's own
    # convolutions on both sides (parallel_step), held in full.  With
    # cuDNN's, the path fit takes, the loss and the gradients are held:
    # cuDNN picks its algorithm by the batch (16 rows a rank against 32),
    # and 22 parameters' first Adam updates flip on gradients near 1e-8
    # (PERF.md); its parameters are printed.
    cfg = step_config()
    flip = 2 * cfg.train.learning_rate * max(1.0, cfg.train.mrf_lr_mult) + STEP_PARAM_ATOL

    def compare(got: dict, want: dict) -> dict:
        out = {"loss_rel": abs(got["metrics"]["loss"] - want["metrics"]["loss"])
               / abs(want["metrics"]["loss"]),
               "grad": max((rel_err(got["grads"][n], g)[0], n) for n, g in want["grads"].items()),
               "param": (0.0, ""), "ill": 0, "ill_beyond": 0, "ill_flip_share": 0.0}
        for n, w in want["params"].items():
            g = want["grads"][n].double().abs()
            held = g >= ADAM_CONDITIONED * g.max()
            diff = (got["params"][n].double() - w.double()).abs()
            share = diff / (STEP_PARAM_ATOL + STEP_PARAM_RTOL * w.double().abs())
            if held.any():
                out["param"] = max(out["param"], (share[held].max().item(), n))
            if not held.all():
                out["ill"] += int((~held).sum())
                out["ill_beyond"] += int((share[~held] > 1).sum())
                out["ill_flip_share"] = max(out["ill_flip_share"], diff[~held].max().item() / flip)
        return out

    def line(c: dict) -> str:
        return (f"loss rel {c['loss_rel']:.3e} (limit {STEP_LOSS_RTOL:g}); gradients rel "
                f"{c['grad'][0]:.3e} (limit {STEP_GRAD_RTOL:g}, worst {c['grad'][1]}); parameters "
                f"whose gradient is at least {ADAM_CONDITIONED:g} of their tensor's largest at "
                f"{c['param'][0]:.4f} of the tolerance (rtol {STEP_PARAM_RTOL:g}, atol "
                f"{STEP_PARAM_ATOL:g}; worst {c['param'][1]}); the other {c['ill']} of {n_params} "
                f"elements: {c['ill_beyond']} beyond the tolerance (limit {flips}), at "
                f"most {c['ill_flip_share']:.3f} of a flipped update ({flip:.2e})")

    ref, ref_cudnn = ranks["reference"][0]["step"], ranks["reference"][0]["step_cudnn"]
    n_params = sum(w.numel() for w in ref["params"].values())
    flips = int(FLIP_SHARE * n_params)
    for task, key, what in (("data", "step", "data 2"), ("model", "step", "2x2 (data 2 x model 2)"),
                            ("model", "step_spatial", "2x2 spatial (the trunk's rows over model 2)")):
        for r, res in enumerate(ranks[task]):
            got = res[key]
            c = compare(got, ref)
            if r == 0:
                c_cudnn = compare(res[f"{key}_cudnn"], ref_cudnn)
                print(f"parallel step {what} (flagship, mrf.impl='pallas', fp32, global batch "
                      f"{cfg.train.batch_size}, {got['rows']} rows a rank, PyTorch's convolutions): "
                      f"loss {got['metrics']['loss']:.7f} against one device's "
                      f"{ref['metrics']['loss']:.7f}; {line(c)}; sliced over 'model': "
                      f"{got['sliced']}; launches {got['launches']}; step {res['step_s']:.2f} s with "
                      f"start-up; on {smi}")
                print(f"parallel step {what} with cuDNN's convolutions (loss and gradients "
                      f"held, parameters printed): {line(c_cudnn)}")
                summary[f"{key}_{task}"] = {"held": c, "cudnn": c_cudnn, "launches": got["launches"]}
            check(got["spatial"] == (key == "step_spatial"), f"the {what} step's spatial flag")
            for variant, c_ in (("", c), (" (cuDNN)", compare(res[f"{key}_cudnn"], ref_cudnn))):
                check(c_["loss_rel"] <= STEP_LOSS_RTOL,
                      f"the {what} step's loss{variant} strays on rank {r}")
                check(c_["grad"][0] <= STEP_GRAD_RTOL, f"the {what} step's {c_['grad'][1]} "
                      f"gradient{variant} strays on rank {r}")
            check(c["param"][0] <= 1.0, f"the {what} step's {c['param'][1]} strays on rank {r}")
            check(c["ill_flip_share"] <= 1.0, f"the {what} step moved a parameter by more than "
                  f"a flipped update on rank {r}")
            check(c["ill_beyond"] <= flips, f"the {what} step left "
                  f"{c['ill_beyond']} parameters beyond the tolerance on rank {r}")
            for name in ("shear_warp", "mrf_epilogue", "mrf_epilogue_bwd"):
                for variant in (key, f"{key}_cudnn"):
                    check(res[variant]["launches"][name] == 1,
                          f"the {what} {variant} launched {name} "
                          f"{res[variant]['launches'][name]} times on rank {r}")
    tp_sliced = ["detector.head_wide.weight", "detector.head_wide.bias",
                 "detector.head_1x1_0.weight", "spatial_model.raw_kernels", "spatial_model.raw_bias"]
    check(ranks["model"][0]["step"]["sliced"] == sorted(tp_sliced),
          "the 2x2 step did not slice the head and the MRF")
    trunk = [n for n in ref["params"] if n.startswith("detector.trunk")]
    check(len(trunk) == 6 and ranks["model"][0]["step_spatial"]["sliced"] == sorted(tp_sliced + trunk),
          "the spatial step does not sum every trunk parameter over 'model'")

    summary["step_preset"] = preset_step_checks(ranks, smi)

    # 2. The data-2 fit and its checkpoint on one device.
    fits = [res["fit"] for res in ranks["data"]]
    check(all(f["step"] == 6 for f in fits) and len({f["pdj"] for f in fits}) == 1,
          f"the data-2 fit's ranks disagree: {fits}")
    check(ckpt_step == 6, f"the data-2 fit's checkpoint is at step {ckpt_step}")
    check(tuple(coords.shape) == (BATCH, 9, 2) and bool(torch.isfinite(coords).all())
          and bool(((probs.sum(dim=(1, 2)) - 1).abs() < 1e-3).all()),
          "the restored data-2 fit predicts no valid heatmaps")
    launches = fits[0]["launches"]
    print(f"parallel fit data 2 (flagship, mrf.impl='pallas', bf16, 3 + 3 steps at global batch "
          f"{cfg_fit.train.batch_size}, evals at steps 3 and 6): {fits[0]['wall_s']:.1f} s in the ranks, final PDJ@0.05 "
          f"wrist/elbow {fits[0]['pdj']:.4f} on both ranks; launches per rank {launches}; the "
          f"rank-0 checkpoint (step {ckpt_step}) restored by a one-device build_predictor: "
          f"coordinates of image 0 {coords[0].cpu().numpy().round(2).tolist()}")
    for name, n in (("shear_warp", 6), ("mrf_epilogue_bwd", 3)):
        check(launches[name] == n, f"the data-2 fit launched {name} {launches[name]} times, not {n}")
    check(launches["mrf_epilogue"] >= 3, "the data-2 fit's joint stage did not launch the epilogue")
    summary["fit_data2"] = {"wall_s": fits[0]["wall_s"], "launches": launches}

    # 3. joint under tensor parallelism.  Every forward ran with the
    # counts at 0: each sharded one must launch its one kernel once on
    # every rank, at the shard-local operands (Kv of the padded sources,
    # Co of the head's channels), and the unsharded references apart.
    tp = [res["joint_tp"] for res in ranks["model"]]
    co = joint.detector.head_features[0]
    for n in (2, 4):
        kv = -(-9 // n)
        for precision in ("high", "default"):
            (fwd, fwd_abs), gk, gb = tp[0]["mrf", n, precision]
            # At 'default' the backward's recompute runs its products as one
            # TF32 pass on either side, over 9 or Kv sources (other GEMM
            # shapes, other roundings): the single-pass gradients' bar of the
            # card-vs-CPU check (tiny_grads_cpu_vs_card).
            grad_limit = KERNEL_RTOL if precision == "high" else SINGLE_PASS_RTOL
            kernel = "mrf_fft_tail" if precision == "high" else "mrf_fft_tail_1pass"
            runs = tp[0]["mrf launches", n, precision]
            print(f"parallel joint MRF, model {n} (Kv {kv} of {kv * n} a rank), "
                  f"precision {precision!r}, batch {BATCH}: log-heatmaps rel err {fwd:.3e} (max abs "
                  f"{fwd_abs:.3e}; limit {KERNEL_RTOL:g}) against the unsharded pass, gradients of "
                  f"raw_kernels rel {gk:.3e}, raw_bias rel {gb:.3e} (limit {grad_limit:g}); the "
                  f"sharded forward launched {runs['tp']['launches']} with operands (pf_re, biases) "
                  f"{runs['tp']['shapes'].get('fused_tail')} on rank 0, the unsharded one "
                  f"{runs['unsharded']['launches']} with {runs['unsharded']['shapes'].get('fused_tail')}")
            for r, res in enumerate(tp):
                (f_err, _), k_err, b_err = res["mrf", n, precision]
                check(f_err <= KERNEL_RTOL and max(k_err, b_err) <= grad_limit,
                      f"joint TP model {n} at {precision!r} strays on rank {r}")
                for what, sources in (("tp", kv), ("unsharded", 9)):
                    run = res["mrf launches", n, precision][what]
                    shapes = run["shapes"].get("fused_tail", [])
                    check(run["launches"] == {kernel: 1} and len(shapes) == 1
                          and shapes[0][0][:2] == (BATCH, sources) and shapes[0][1] == (sources, 9),
                          f"the {what} joint MRF (model {n}, {precision!r}) launched "
                          f"{run['launches']} with operands {shapes} on rank {r}, not {kernel} once "
                          f"at batch {BATCH}, Kv {sources}")
        (head, head_abs), (steer, _) = tp[0]["head", n]
        runs = tp[0]["head launches", n]
        print(f"parallel joint Fourier head, model {n} (cout {co // n} a rank), bf16, batch "
              f"{BATCH}: detector logits rel err {head:.3e} (max abs {head_abs:.3e}) against the "
              f"unsliced head, steered to the batch-tiled tail {steer:.3e} (limit {TP_HEAD_RTOL:g}); "
              + "; ".join(f"{what} launched {run['launches']} with operands (xr, a_re) "
                          f"{list(run['shapes'].values())}" for what, run in runs.items())
              + " on rank 0")
        for r, res in enumerate(tp):
            check(max(res["head", n][0][0], res["head", n][1][0]) <= TP_HEAD_RTOL,
                  f"the joint head under model {n} strays on rank {r}")
            for what, kernel, wrapper, channels in (
                    ("tp", "fft_conv_tail_kdft_resident", "tail_kdft_resident", co // n),
                    ("tp steered", "fft_conv_tail_kdft", "tail_kdft", co // n),
                    ("unsliced", "fft_conv_tail_kdft_resident", "tail_kdft_resident", co)):
                run = res["head launches", n][what]
                shapes = run["shapes"].get(wrapper, [])
                check(run["launches"] == {kernel: 1} and len(run["shapes"]) == 1 and len(shapes) == 1
                      and shapes[0][0][2] == BATCH and shapes[0][1][-1] == channels,
                      f"the {what} joint head (model {n}) launched {run['launches']} with operands "
                      f"{run['shapes']} on rank {r}, not {kernel} once at batch {BATCH}, Co {channels}")
    summary["joint_tp"] = {str(key): v for key, v in tp[0].items()}

    # 3b. Spatial parallelism in the 'model' world: joint's forward, the
    # spatial fit and its checkpoint on one device, the step and trunk times.
    sp = [res["joint_spatial"] for res in ranks["model"]]
    for precision in ("high", "default"):
        run = sp[0][precision]
        limit = KERNEL_RTOL if precision == "high" else SINGLE_PASS_RTOL
        kernel = "mrf_fft_tail" if precision == "high" else "mrf_fft_tail_1pass"
        print(f"parallel joint spatial 2x2 (the trunk's rows over model 2, fp32, TF32 off), "
              f"precision {precision!r}, batch {BATCH}: detector logits rel err {run['logits'][0]:.3e} "
              f"(limit {CONV_RTOL:g}), MRF log-heatmaps rel err {run['mrf'][0]:.3e} (limit {limit:g}) "
              f"against the unsharded model; the spatial forward launched {run['launches']} on rank 0, "
              f"the unsharded one {run['unsharded_launches']}")
        for r, res in enumerate(sp):
            run = res[precision]
            check(run["logits"][0] <= CONV_RTOL and run["mrf"][0] <= limit,
                  f"joint spatial at {precision!r} strays on rank {r}")
            check(run["launches"] == {kernel: 1} and run["unsharded_launches"] == {kernel: 1},
                  f"joint spatial at {precision!r} launched {run['launches']} on rank {r}, not "
                  f"{kernel} once")
    summary["joint_spatial"] = sp[0]
    fits = [res["fit"] for res in ranks["model"]]
    check(all(f["step"] == 4 and f["spatial"] for f in fits) and len({f["pdj"] for f in fits}) == 1,
          f"the spatial fit's ranks disagree: {fits}")
    check(sp_step == 4, f"the spatial fit's checkpoint is at step {sp_step}")
    check(tuple(sp_coords.shape) == (BATCH, 9, 2) and bool(torch.isfinite(sp_coords).all())
          and bool(((sp_probs.sum(dim=(1, 2)) - 1).abs() < 1e-3).all()),
          "the restored spatial fit predicts no valid heatmaps")
    launches = fits[0]["launches"]
    print(f"parallel fit 2x2 spatial (flagship, mrf.impl='pallas', bf16, 2 + 2 steps at global "
          f"batch {cfg_fit.train.batch_size}, evals at steps 2 and 4): {fits[0]['wall_s']:.1f} s in the "
          f"ranks, final PDJ@0.05 wrist/elbow {fits[0]['pdj']:.4f} on every rank; launches per rank "
          f"{launches}; the rank-0 checkpoint (step {sp_step}) restored by a one-device "
          f"build_predictor: coordinates of image 0 {sp_coords[0].cpu().numpy().round(2).tolist()}")
    for name, n in (("shear_warp", 4), ("mrf_epilogue_bwd", 2)):
        check(launches[name] == n, f"the spatial fit launched {name} {launches[name]} times, not {n}")
    check(launches["mrf_epilogue"] >= 2, "the spatial fit's joint stage did not launch the epilogue")
    summary["fit_spatial"] = {"wall_s": fits[0]["wall_s"], "launches": launches}
    timing = [res["timing"] for res in ranks["model"]]
    shared = torch.cuda.device_count() == 1
    print(f"parallel 2x2 step time a rank (flagship, mrf.impl='pallas', bf16, global batch "
          f"{cfg_fit.train.batch_size}; the better of two turns, median of 5 steps) and the trunk's "
          f"device time (rows of batch 16, exchanges and gather included), spatial against "
          f"tensor-parallel, by rank: "
          + "; ".join(f"rank {r}: step {t['spatial']['step_ms']:.3f} ms against "
                      f"{t['tensor-parallel']['step_ms']:.3f}, trunk {t['spatial']['trunk_ms']:.3f} ms "
                      f"against {t['tensor-parallel']['trunk_ms']:.3f}" for r, t in enumerate(timing))
          + (" (the four ranks share one card over gloo: no claim)" if shared else "")
          + f"; on {smi}")
    summary["spatial_timing"] = timing

    # 4. The pipelined predictor on the one card, two streams, as served.
    # Held against build_predictor on the same microbatches (the same
    # arithmetic, another schedule), and its heatmaps against
    # build_predictor on the whole batch.  The whole batch's coordinates are
    # printed: stage 0 runs the detector at the microbatch, where cuDNN may
    # pick another algorithm, and an argmax between two probabilities closer
    # than that difference can move by pixels.
    cfg0 = with_mrf_precision(joint, "default")
    gen = torch.Generator().manual_seed(PARALLEL_SEED)
    weights = init_state_dict(cfg0, gen)
    weights["spatial_model.raw_kernels"] += 0.5 * torch.randn(
        weights["spatial_model.raw_kernels"].shape, generator=gen)
    h, w = cfg0.data.image_hw
    images = torch.randint(0, 256, (BATCH, h, w, 3), generator=gen, dtype=torch.uint8).cuda()

    def p50_ms(fn) -> float:
        walls_ = []
        for _ in range(PIPE_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(images)
            torch.cuda.synchronize()
            walls_.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls_))

    # One card: both stage groups on it, two streams; several: split over them.
    devices = ["cuda:0", "cuda:0"] if torch.cuda.device_count() == 1 else None
    g0, g1 = split_stage_devices(devices)
    check(len(g0) == len(g1), f"stage groups of {len(g0)} and {len(g1)} cards")
    pipe = {}
    for tta in (False, True):
        cfg = cfg0.replace(eval_flip_tta=tta)
        single = build_predictor(cfg, weights)
        whole_c, whole_p = (t.cpu() for t in single(images))
        single_ms = p50_ms(single)
        for n_micro in (2, 4):
            rows = BATCH // n_micro // len(g0)  # images a stage device takes at once

            def in_microbatches(x: torch.Tensor) -> list:
                return [single(x[i:i + rows]) for i in range(0, BATCH, rows)]

            parts = in_microbatches(images)
            want_c, want_p = (torch.cat([part[j] for part in parts]).cpu() for j in (0, 1))
            pp = build_pipelined_predictor(cfg, weights, devices=devices, n_micro=n_micro)
            reset(counters)
            got_c, got_p = (t.cpu() for t in pp(images))
            torch.cuda.synchronize()
            launched = {name: fn.launches for name, fn in counters.items() if fn.launches}
            res = {"prob_tol_share": _close(got_p, want_p, PIPE_PROB_RTOL, PIPE_PROB_ATOL),
                   "coord_err": (got_c - want_c).abs().max().item(),
                   "whole_prob_tol_share": _close(got_p, whole_p, PIPE_PROB_RTOL, PIPE_PROB_ATOL),
                   "whole_coords_equal": ((got_c - whole_c).abs() <= PIPE_COORD_ATOL).float().mean().item(),
                   "p50_ms": p50_ms(pp), "single_p50_ms": single_ms,
                   "single_microbatches_p50_ms": p50_ms(in_microbatches)}
            pipe[f"tta={tta},n_micro={n_micro}"] = res
            print(f"parallel pipelined predictor, joint at 'default' (bf16), batch {BATCH}, "
                  f"n_micro {n_micro}, TTA {tta}, stages on {[str(d) for d in g0]} | "
                  f"{[str(d) for d in g1]}: against build_predictor on the same "
                  f"{rows}-image chunks heatmaps at {res['prob_tol_share']:.3f} "
                  f"of the tolerance (rtol {PIPE_PROB_RTOL:g}, atol {PIPE_PROB_ATOL:g}), "
                  f"coordinates max abs err {res['coord_err']:.3e} px (limit {PIPE_COORD_ATOL:g}); "
                  f"against it on the whole batch heatmaps at {res['whole_prob_tol_share']:.3f} of "
                  f"the tolerance, {res['whole_coords_equal']:.4f} of the coordinates within "
                  f"{PIPE_COORD_ATOL:g} px (not held); launches {launched}; p50 {res['p50_ms']:.3f} "
                  f"ms against the single program's {single_ms:.3f} ms on the whole batch and "
                  f"{res['single_microbatches_p50_ms']:.3f} ms on the chunks in turn on one card "
                  f"(no claim); on {smi}")
            check(res["prob_tol_share"] <= 1.0 and res["coord_err"] <= PIPE_COORD_ATOL
                  and res["whole_prob_tol_share"] <= 1.0,
                  f"the pipelined predictor (n_micro {n_micro}, TTA {tta}) strays")
            want_n = n_micro * len(g1) * (2 if tta else 1)
            check(launched.get("mrf_fft_tail_1pass") == want_n,
                  f"stage 1 launched the single-pass tail {launched} times, not {want_n}")
    summary["pipeline"] = pipe
    summary["walls_s"] = walls
    return summary


def shard_kernel_checks(joint, flag, smi: str) -> dict:
    """Rows 1, 2, 3, 3', 4, 6 and 7 at the shapes the parallel paths give
    them, each against its plain version and timed beside it (and its
    bound): the epilogue in fp32 on a model-2 rank's sources (v 5..9 of the
    padded 10, the last a neutral slot) at 16 rows a data rank of
    flagship's training batch; the Fourier MRF tail at 'high' and 'default'
    on joint's grid at batch 8 with Kv 5 (model 2) and 3 (model 4); the
    shear warp at 16 images a data rank; the joint head's tails at cout 256
    (model 2) and 128 (model 4), batch 8, bf16."""
    from jointpose_torch.data.augment import inverse_affine, random_augment_params
    from jointpose_torch.ops import fft_conv as fc
    from jointpose_torch.ops.mrf_epilogue import (
        bwd_cost, fwd_cost, mrf_epilogue_bwd, mrf_epilogue_bwd_plain, mrf_epilogue_fwd,
        mrf_epilogue_plain,
    )
    from jointpose_torch.ops.mrf_fft import forward_ffts
    from jointpose_torch.ops.mrf_fft_fused import fused_tail, fused_tail_emulated, fused_tail_plain
    from jointpose_torch.ops.mrf_fft_fused import tail_cost as mrf_tail_cost
    from jointpose_torch.ops.mrf_xla import pairwise_conv
    from jointpose_torch.ops.warp import shear_warp, shear_warp_reference, warp_cost
    from jointpose_torch.parallel.mrf_tp import pad_source_axis

    gen = torch.Generator().manual_seed(PARALLEL_SEED + 1)
    k, rows, out = 9, flag.train.batch_size // 2, {}

    def report(name: str, shape, err: float, limit: float, kernel_ms: float, plain_ms: float,
               bound_ms: tuple[float, str]) -> None:
        print(f"parallel kernel {name} at {shape}: rel err {err:.3e} (limit {limit:g}); "
              f"{kernel_ms:.6f} ms on the device, plain {plain_ms:.6f} ms, bound "
              f"{bound_ms[0]:.6f} ms by {bound_ms[1]}; on {smi}")
        check(err <= limit, f"{name} at {shape} disagrees with its plain version")
        out[f"{name} {shape}"] = {"rel_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                                  "bound_ms": bound_ms[0], "bound_by": bound_ms[1]}

    # Rows 1-2.
    ch, cw = flag.heatmap_hw[0] // flag.mrf.stride, flag.heatmap_hw[1] // flag.mrf.stride
    kern, bias = mrf_params(gen, flag.mrf.window, k)
    p, kern, bias = pad_source_axis(unaries(gen, rows, ch, cw, k, torch.float32), kern, bias, 2)
    sl = slice(5, 10)
    resp = pairwise_conv(p[..., sl].contiguous(), kern[:, :, sl].contiguous())
    b1 = bias[sl].contiguous()
    g = torch.randn(*resp.shape[:3], k, generator=gen).cuda()
    shape = tuple(resp.shape)
    fwd_err = rel_err(mrf_epilogue_fwd(resp, b1), mrf_epilogue_plain(resp, b1))[0]
    report("mrf_epilogue", shape, fwd_err, KERNEL_RTOL, time_ms(lambda: mrf_epilogue_fwd(resp, b1)),
           time_ms(lambda: mrf_epilogue_plain(resp, b1)), bound(*fwd_cost(resp, b1)))
    (dresp, dbias), (want_dresp, want_dbias) = (mrf_epilogue_bwd(resp, b1, g),
                                                mrf_epilogue_bwd_plain(resp, b1, g))
    bwd_err = max(rel_err(dresp, want_dresp)[0], rel_err(dbias, want_dbias)[0])
    report("mrf_epilogue_bwd", shape, bwd_err, KERNEL_RTOL,
           time_ms(lambda: mrf_epilogue_bwd(resp, b1, g)),
           time_ms(lambda: mrf_epilogue_bwd_plain(resp, b1, g)), bound(*bwd_cost(resp, b1, g)))

    # Rows 3 and 3'.
    jh, jw = joint.heatmap_hw
    kern2, bias2 = mrf_params(gen, joint.mrf.window, k)
    p2 = unaries(gen, BATCH, jh, jw, k, torch.float32)
    for n, rank in ((2, 1), (4, 0)):
        pp, kp, bp = pad_source_axis(p2, kern2, bias2, n)
        kv = pp.shape[-1] // n
        sl = slice(rank * kv, (rank + 1) * kv)
        pf, kf, tables = forward_ffts(pp[..., sl].contiguous(), kp[:, :, sl].contiguous())
        pf, kf = tuple(t.contiguous() for t in pf), tuple(t.contiguous() for t in kf)
        # The single pass's spectra as its pass gives them: rows of 8 bins.
        padded = forward_ffts(pp[..., sl].contiguous(), kp[:, :, sl].contiguous(),
                              padded_bins=True)[:2]
        bs = bp[sl].contiguous()
        shape = (BATCH, jh, jw, kv, k)
        plain = fused_tail_plain(pf, kf, tables, bs)
        tail_bytes, flops = mrf_tail_cost(pf, kf, tables, bs)
        t_bytes = tail_bytes / HBM_BYTES_PER_S * 1e3
        for name, prec, passes in (("mrf_fft_tail", "high", 3), ("mrf_fft_tail_1pass", "default", 1)):
            got = fused_tail(pf, kf, tables, bs, precision=prec)
            if passes == 3:
                err, limit = rel_err(got, plain)[0], MRF_TAIL_RTOL
            else:
                err, limit = rel_err(got, fused_tail_emulated(pf, kf, tables, bs, passes=1))[0], KERNEL_RTOL
                fp32 = rel_err(got, plain)[0]
                again = torch.equal(fused_tail(pf, kf, tables, bs, precision=prec), got)
                print(f"parallel kernel {name} at {shape}: against fp32 rel err {fp32:.3e} "
                      f"(limit {SINGLE_PASS_RTOL:g}); a second run is "
                      f"{'bit-identical' if again else 'DIFFERENT'}")
                check(fp32 <= SINGLE_PASS_RTOL, f"{name} at {shape} strays from fp32")
                check(again, f"{name} at {shape}: a second run is not bit-identical")
            t_ops = tf32_ops_ms(flops, passes)
            spectra = (pf, kf) if passes == 3 else padded
            kernel_ms = time_ms(lambda prec=prec, a=spectra: fused_tail(*a, tables, bs,
                                                                        precision=prec))
            report(name, shape, err, limit, kernel_ms,
                   time_ms(lambda: fused_tail_plain(pf, kf, tables, bs)),
                   (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))

    # Row 4.
    h, w = flag.data.image_hw
    images = torch.rand(rows, h, w, 3, generator=gen).cuda()
    draw = random_augment_params(torch.Generator().manual_seed(2), rows, dataclasses.replace(
        flag.augment, crop_frac_range=(0.8, 1.0)), (h, w))
    a_inv, b_inv = (t.cuda() for t in inverse_affine(draw, (h, w)))
    err = rel_err(shear_warp(images, a_inv, b_inv), shear_warp_reference(images, a_inv, b_inv))[1]
    report("shear_warp", tuple(images.shape), err, WARP_ATOL,
           time_ms(lambda: shear_warp(images, a_inv, b_inv)),
           time_ms(lambda: shear_warp_reference(images, a_inv, b_inv), runs=5, per_graph=1),
           bound(*warp_cost(images, a_inv, b_inv)))

    # Rows 6 and 7.
    ci, kk = joint.detector.trunk_features[-1], joint.detector.head_kernel
    feats = torch.randn(BATCH, jh, jw, ci, generator=gen).relu().cuda().bfloat16()
    for n in (2, 4):
        co = joint.detector.head_features[0] // n
        hk = (torch.randn(kk, kk, ci, co, generator=gen) / math.sqrt(kk * kk * ci)).cuda()
        (xr, xi), (a_re, a_im), ct = fc.forward_spectra(feats, hk)
        args = (*(v.contiguous() for v in (xr, xi, a_re, a_im)), ct)
        want = fc.tail_kdft_plain(*args)
        plain_ms = time_ms(lambda: fc.tail_kdft_plain(*args), runs=5, per_graph=1)
        body = fc.tail_body("kdft_resident", xr.shape[1], BATCH, ci, co, kk, jh, 2)
        for fn in (fc.tail_kdft_resident, fc.tail_kdft):
            report(f"fft_conv_tail_{fn.__name__[5:]}", (BATCH, jh, jw, kk, ci, co),
                   rel_err(fn(*args), want)[0], TAIL_RTOL[torch.bfloat16],
                   time_ms(lambda fn=fn: fn(*args)), plain_ms,
                   bound(*fc.tail_cost(*args, True), BF16_FLOPS_PER_S))
        print(f"parallel kernel fft_conv_tail at cout {co}: body {body!r}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-joint", default=None,
                        help="write the served joint coordinates and heatmaps to this .npz")
    parser.add_argument("--joint-reference", default=None,
                        help="compare them with an .npz written by --save-joint")
    parser.add_argument("--parallel-child", nargs=2, metavar=("TASK", "DIR"),
                        help=argparse.SUPPRESS)  # a rank of the parallel phase's worlds
    parser.add_argument("--kstep-child", choices=["deterministic", "default"],
                        help=argparse.SUPPRESS)  # a process of the kstep phase
    parser.add_argument("--nccl-kstep-child", nargs=2, metavar=("TASK", "DIR"),
                        help=argparse.SUPPRESS)  # a rank of the nccl_kstep phase's worlds
    parser.add_argument("--grouped-corr", action="store_true",
                        help="run only the MRF grouped correlation's entry and exit")
    parser.add_argument("--upsample-log", action="store_true",
                        help="run only the coarse pass's upsample and unary log's entry and exit")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if opts.parallel_child:
        parallel_child(*opts.parallel_child)
        return 0
    if opts.kstep_child:
        kstep_child(opts.kstep_child)
        return 0
    if opts.nccl_kstep_child:
        nccl_kstep_child(*opts.nccl_kstep_child)
        return 0
    from jointpose_torch import _build, get_config
    from jointpose_torch.data.augment import inverse_affine, random_augment_params
    from jointpose_torch.ops import fft_conv as fc
    from jointpose_torch.ops.mrf_epilogue import bwd_cost as epilogue_bwd_cost
    from jointpose_torch.ops.mrf_epilogue import fwd_cost as epilogue_fwd_cost
    from jointpose_torch.ops.mrf_epilogue import (
        mrf_epilogue, mrf_epilogue_bwd, mrf_epilogue_bwd_plain, mrf_epilogue_plain,
    )
    from jointpose_torch.ops.mrf_fft import (
        fft_pairwise_conv, forward_ffts, matmul_precision, mrf_message_pass_fft,
    )
    from jointpose_torch.ops.mrf_fft_fused import fused_tail, fused_tail_emulated, fused_tail_plain
    from jointpose_torch.ops.mrf_fft_fused import tail_cost as mrf_tail_cost
    from jointpose_torch.ops.mrf_xla import pairwise_conv
    from jointpose_torch.ops import warp as warp_ops
    from jointpose_torch.ops.warp import (
        shear_warp, shear_warp_reference, shear_warp_rowmajor, shear_warp_strips, warp_cost,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    t0 = time.perf_counter()
    alone = {"mrf_grouped_corr": opts.grouped_corr, "mrf_upsample": opts.upsample_log}
    names = [n for n, on in alone.items() if on] or _build.kernel_names()
    _build.build(names)
    print(f"build: {time.perf_counter() - t0:.2f} s for {names}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts.grouped_corr or opts.upsample_log:
        phases = [(opts.grouped_corr, grouped_corr_phase), (opts.upsample_log, upsample_log_phase)]
        print(json.dumps({"kernels": [phase(smi) for on, phase in phases if on]}))
        return 0
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
            torch.cuda.synchronize()
            epi_err[batch, dtype] = rel_err(got, want)
            print(f"kernel mrf_epilogue {dtype} {tuple(resp.shape)}: rel err "
                  f"{epi_err[batch, dtype][0]:.3e} (limit {EPILOGUE_PRODUCT_RTOL:g}: the plain "
                  f"version adds the logs one by one), max abs err {epi_err[batch, dtype][1]:.3e}")
            check(epi_err[batch, dtype][0] <= EPILOGUE_PRODUCT_RTOL,
                  f"mrf_epilogue {dtype} batch {batch} disagrees with its plain version")
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
        """The single-pass form (the wgmma kernel) against its own arithmetic
        (stacked, and in its own grouping of the sums) and against fp32;
        returns (rel, max abs) of the kernel against fp32."""
        before = fused_tail.launches_1pass
        got1 = fused_tail(pf_, kf_, tables, bias_, joint.mrf.eps, precision="default")
        torch.cuda.synchronize()
        check(fused_tail.launches_1pass == before + 1,
              "the single-pass tail did not count its launch")
        emu = rel_err(got1, fused_tail_emulated(pf_, kf_, tables, bias_, joint.mrf.eps, passes=1))
        grouped = rel_err(got1, fused_tail_emulated(pf_, kf_, tables, bias_, joint.mrf.eps,
                                                    passes=1, chunk=32))
        fp32 = rel_err(got1, fused_tail_plain(pf_, kf_, tables, bias_, joint.mrf.eps))
        again1 = fused_tail(pf_, kf_, tables, bias_, joint.mrf.eps, precision="default")
        print(f"kernel mrf_fft_tail_1pass (wgmma){what} {tuple(got1.shape)}: against its arithmetic "
              f"in plain PyTorch (one TF32 pass) rel err {emu[0]:.3e} (limit {KERNEL_RTOL:g}), max "
              f"abs {emu[1]:.3e}, in its own grouping of the sums rel {grouped[0]:.3e}; against fp32 "
              f"rel err {fp32[0]:.3e} (limit {SINGLE_PASS_RTOL:g}), max abs {fp32[1]:.3e}; a second "
              f"run is {'bit-identical' if torch.equal(again1, got1) else 'DIFFERENT'}")
        check(emu[0] <= KERNEL_RTOL and grouped[0] <= KERNEL_RTOL,
              f"mrf_fft_tail_1pass{what} disagrees with its plain version")
        check(fp32[0] <= SINGLE_PASS_RTOL, f"mrf_fft_tail_1pass{what} strays from fp32")
        check(torch.equal(again1, got1), "mrf_fft_tail_1pass: a second run is not bit-identical")
        return fp32

    tail1_err = single_pass_parity(pf, kf, bias2, "")
    # Training batch 32: 2592 units, a run of about 10 a warpgroup.
    p32 = unaries(torch.Generator().manual_seed(16), tb, jh, jw, k, torch.float32)
    pf32, kf32, _ = forward_ffts(p32, kern2)
    pf32 = tuple(t.contiguous() for t in pf32)
    kf32 = tuple(t.contiguous() for t in kf32)
    single_pass_parity(pf32, kf32, bias2, f", batch {tb}")
    del pf32, kf32
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
    # Each orientation's kernel goes through its strips' fp32 operations in
    # the order ``shear_warp_strips`` takes them: bit-equal to it, on the
    # draw and on extreme maps.
    for what, (ai_, bi_) in (("the random full draw", (a_inv, b_inv)),
                             ("extreme maps", extreme_affines(tb, h, w))):
        want = shear_warp_reference(images, ai_, bi_)
        for fn in (shear_warp, shear_warp_rowmajor):
            got = fn(images, ai_, bi_)
            strips = shear_warp_strips(images.cpu(), ai_.cpu(), bi_.cpu(),
                                       rowmajor=fn is shear_warp_rowmajor).cuda()
            err = (got - want).abs().max().item()
            torch.cuda.synchronize()
            same = torch.equal(got, strips)
            print(f"kernel {fn.__name__} (fused, strips of {warp_ops.strip_width(h, 3)} columns) "
                  f"on {what}: {'bit-equal to' if same else 'DIFFERENT from'} its strips in plain "
                  f"PyTorch; max abs err {err:.3e} from the plain version (limit {WARP_ATOL:g})")
            check(same, f"{fn.__name__} differs from its strips in plain PyTorch on {what}")
            check(err <= WARP_ATOL, f"{fn.__name__} disagrees with its plain version on {what}")
    del got, strips, want

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
            # The build form's path runs the ring version, kf the register-staged one.
            nph = ops[0].shape[1]
            bodies = {name: fc.tail_body(name.removeprefix("fft_conv_tail_"), nph, BATCH, ci, co,
                                         kk, jh, 2) for name in tails}
            print(f"kernel bodies {bodies}")
            check(bodies == {"fft_conv_tail_kdft_resident": "ring", "fft_conv_tail_kdft": "ring",
                             "fft_conv_tail_kf": "regstaged"}, f"head-conv tail bodies {bodies}")
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
    got32 = fc.tail_kdft(*tail32_args)
    want32 = fc.tail_kdft_plain(*tail32_args)
    torch.cuda.synchronize()
    err32 = rel_err(got32, want32)
    print(f"kernel fft_conv_tail_kdft bf16 at batch {tb} (ring): rel err {err32[0]:.3e} (limit "
          f"{TAIL_RTOL[torch.bfloat16]:g}), max abs {err32[1]:.3e}")
    check(err32[0] <= TAIL_RTOL[torch.bfloat16], "fft_conv_tail_kdft at batch 32 disagrees")
    del got32, want32, feats32
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
    counters = kernel_counters()
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
    kstep_phase(smi)
    grouped_vjp_phase(counters, smi)
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

    parallel = parallel_phase(joint, counters, smi)
    parallel["kernels"] = shard_kernel_checks(joint, flag, smi)
    print(f"parallel {json.dumps(parallel)}")
    nccl_kstep_phase(smi)
    nccl_ops_phase(smi)

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
    # The two forms in turns in this one process: 3xTF32, one pass, one pass,
    # 3xTF32, each on the spectra its pass gives it (rows padded to 8 bins
    # for the single pass).
    padded8 = forward_ffts(p2, kern2, padded_bins=True)[:2]
    tail_turns = [time_ms(lambda prec=prec: fused_tail(
        *(padded8 if prec == "default" else (pf, kf)), tables, bias2, precision=prec))
        for prec in ("high", "default", "default", "high")]
    # The single pass at serving batch 8 and training batch 32, on the
    # spectra its path gives it: rows padded to 8 bins
    # (forward_ffts(padded_bins=True)).
    one_pass_ms = {}
    for batch, p_ in ((BATCH, p2), (tb, p32)):
        padded = forward_ffts(p_, kern2, padded_bins=True)[:2]
        one_pass_ms[batch] = time_ms(lambda a=padded: fused_tail(*a, tables, bias2,
                                                                 precision="default"))
    del p32
    with matmul_precision("default", pf[0].device):
        plain_tf32_ms = time_ms(lambda: fused_tail_plain(pf, kf, tables, bias2))
    b4, by4 = bound(*warp_cost(images, a_inv, b_inv))
    # Row 1 at both shapes.
    epi_ms = {}
    for batch, resp in ((BATCH, resp1), (tb, resp1_train)):
        n_rows = resp.shape[0] * resp.shape[1] * resp.shape[2]
        epi_ms[batch] = e = {
            "kernel": time_ms(lambda r=resp: mrf_epilogue(r, bias1)),
            "plain": time_ms(lambda r=resp: mrf_epilogue_plain(r, bias1)),
            "bound": bound(*epilogue_fwd_cost(resp, bias1))[0],
        }
        print(f"time mrf_epilogue forward at batch {batch} ({n_rows} rows x {k * k} bf16): kernel "
              f"{e['kernel']:.6f} ms, plain {e['plain']:.6f} ms, byte bound {e['bound']:.6f} ms "
              f"({e['bound'] / e['kernel']:.1%} of the kernel's time), on {smi}")
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
            # The same TPU kernel compiled at Precision.DEFAULT, on wgmma; its
            # plain version here is the plain tail with TF32 products (cuBLAS).
            "name": "mrf_fft_tail_1pass", "route": "cuda",
            "source": "jointpose_torch/csrc/mrf_fft_tail_wgmma.cu",
            "replaces": "jointpose/ops/mrf_fft_pallas.py:50",
            "launches": served_default["launches"]["mrf_fft_tail_1pass"],
            "max_abs_err": tail1_err[1],
            "ms": one_pass_ms[BATCH],
            "plain_ms": plain_tf32_ms,
            "bound_ms": b2_1, "bound_by": by2_1, "library_ms": None,
        },
    ]
    plain_warp_ms = time_ms(lambda: shear_warp_reference(images, a_inv, b_inv), runs=5, per_graph=1)
    warp_ms = {fn.__name__: time_ms(lambda fn=fn: fn(images, a_inv, b_inv))
               for fn in (shear_warp, shear_warp_rowmajor)}
    strips = {tw: time_ms(lambda tw=tw: warp_ops._fused(images, a_inv, b_inv, tw))
              for tw in (4, 8, 16, 32, 64)}
    print(f"time shear_warp {warp_ms['shear_warp']:.6f} ms, shear_warp_rowmajor "
          f"{warp_ms['shear_warp_rowmajor']:.6f} ms; the fused kernel by strip width "
          f"{ {tw: round(t, 6) for tw, t in strips.items()} } ms (the shape rule picks "
          f"{warp_ops.strip_width(h, 3)}); byte bound {b4:.6f} ms, {b4 / warp_ms['shear_warp']:.1%} "
          f"and {b4 / warp_ms['shear_warp_rowmajor']:.1%} of the two orientations' times; on {smi}")
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
            # Row 4 on flagship's own path ('xla'): its launches in the
            # one-device step of the parallel phase.
            **({"launches_flagship_preset": parallel["step_preset"]["warp_launches"]}
               if fn is shear_warp else {}),
        })
    # The head-conv tails in bf16, the served path's type, over the
    # tensor-core peak of the input type (fc.tail_cost).
    x_ops = tail_args["fft_conv_tail_kdft", torch.bfloat16]
    plain_tail_ms = {
        fn: time_ms(lambda fn=fn, a=a: fn(*a), runs=5, per_graph=1)
        for fn, a in ((fc.tail_kdft_plain, x_ops),
                      (fc.tail_kf_plain, tail_args["fft_conv_tail_kf", torch.bfloat16]))
    }
    # The build form's ring version at serving batch 8 through the resident
    # entry and at training batch 32 through the batch-tiled one; the
    # K_f-from-memory entry (the register-staged version) beside them.
    x8 = tail_args["fft_conv_tail_kdft_resident", torch.bfloat16]
    ring_ms = {8: time_ms(lambda: fc.tail_kdft_resident(*x8)),
               tb: time_ms(lambda: fc.tail_kdft(*tail32_args))}
    kf_ms = time_ms(lambda: fc.tail_kf(*tail_args["fft_conv_tail_kf", torch.bfloat16]))
    bound32 = bound(*fc.tail_cost(*tail32_args, True), BF16_FLOPS_PER_S)[0]
    print(f"time the build form's ring version: {ring_ms[8]:.6f} ms at batch 8, "
          f"{ring_ms[tb]:.6f} ms at batch {tb} (byte bound {bound32:.6f} ms, "
          f"{bound32 / ring_ms[tb]:.1%}); fft_conv_tail_kf {kf_ms:.6f} ms; on {smi}")
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
            "ms": (ring_ms[8] if fn is fc.tail_kdft_resident
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
        "mrf_fft_tail_1pass": call_ms(lambda: fused_tail(*padded8, tables, bias2,
                                                         precision="default")),
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
    for batch, ms in one_pass_ms.items():
        ops_ms = tf32_ops_ms(flops2 * batch // BATCH, 1)
        print(f"mrf_fft_tail_1pass (wgmma) at batch {batch}: {ms:.6f} ms, {ops_ms / ms:.1%} of the "
              f"TF32 bound {ops_ms:.6f} ms; on {smi}")
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
    kernels.append(grouped_corr_phase(smi))
    kernels.append(upsample_log_phase(smi))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
