"""Closed-loop batch scoring: one client sends a batch of uint8 images from a
host pool, waits until their coordinates are on the host, and sends the
next, through ``predict.build_predictor``'s function as ``predict.main``
calls it.

Traffic keys: ``batch`` (images a call), ``pool_batches`` (distinct
batches in the pinned host pool, made from the seed and sent in turn),
``warm_calls``, ``sample_calls`` (calls whose answers and heatmaps are
kept for the comparison, drawn from the seed among the first
``sample_from``), ``trace_slice`` ({'start': share of the window,
'seconds'}).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import inputs, judge, spec, stats
from benchmark.harness.trace import Profiler, warm_profiler
from benchmark.reference.precision import CONTROL


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", fault=None) -> dict:
    from jointpose_torch.predict import build_predictor

    tr, cfg = cell.traffic, cell.config["config"]
    on_card = torch.device(device).type == "cuda"
    hw = tuple(cfg["data"]["image_hw"])
    weights = inputs.make_weights(cfg, seed, device)
    pool = []
    for i in range(tr["pool_batches"]):
        batch = inputs.make_images(tr["batch"], hw, seed, 100 + i, device).cpu()
        pool.append(batch.pin_memory() if on_card else batch)
    predict = build_predictor(spec.port_config(cell.config), weights, device)
    if fault is not None:
        predict = fault(predict)
    for i in range(tr["warm_calls"]):
        predict(pool[i % len(pool)])[0].cpu()
    if trace:
        warm_profiler()
    rng = np.random.default_rng(seed)
    sample = set(rng.choice(tr["sample_from"], size=tr["sample_calls"], replace=False).tolist())
    kept: list[tuple[int, torch.Tensor, torch.Tensor]] = []
    prof = Profiler() if trace else None
    slice_at = (tr["trace_slice"]["start"] * seconds, tr["trace_slice"]["start"] * seconds
                + tr["trace_slice"]["seconds"])
    slice_t = [0.0, 0.0]
    before = [0.0, 0]  # the window's time and calls before the traced slice
    if on_card:
        torch.cuda.synchronize()
    window_start = time.time()
    t0 = time.perf_counter()
    n = 0
    while (now := time.perf_counter() - t0) < seconds:
        if prof is not None and slice_t[0] == 0.0 and now >= slice_at[0]:
            before[:] = [time.perf_counter() - t0, n]
            prof.start()
            slice_t[0] = time.perf_counter()
        elif prof is not None and slice_t[0] and not slice_t[1] and now >= slice_at[1]:
            prof.stop()
            slice_t[1] = time.perf_counter()
        coords, probs = predict(pool[n % len(pool)])
        coords = coords.cpu()  # on the host: the call is done
        if n in sample:
            kept.append((n % len(pool), coords, probs))
        n += 1
    elapsed = time.perf_counter() - t0
    if prof is not None and not slice_t[1]:
        prof.stop()
    memory = torch.cuda.max_memory_allocated() if on_card else 0
    del predict
    out = {
        "window_start": window_start,
        "attempted": n,
        "failed": 0,
        "e2e": {"images_per_s": stats.rate(n * tr["batch"], elapsed)},
        "counts": {"untraced_s": before[0], "untraced_images": before[1] * tr["batch"]},
        "traces": [prof.summarize()] if prof is not None else [],
        "memory_peak_bytes": memory,
    }
    if on_card:
        torch.cuda.empty_cache()
    items = [(pool[i].to(device), c, p) for i, c, p in kept]
    verdict = judge.judge_answers(cfg, weights, items)
    out["numbers"] = verdict["numbers"]
    out["notes"] = [f"compared {verdict['answers']} answers of {len(kept)} calls of {tr['batch']} "
                    f"images with the reference"]
    out["judged"] = (weights, [images for images, _, _ in items])
    return out


def readings(cell, seed: int, seconds: float, control: bool, device: str = "cuda"):
    """The program's numbers in a short window, and the lower-precision control's on the
    same images (``tools/readings.py``)."""
    out = run(cell, seed, seconds, False, device)
    yield "program", out["numbers"]
    if control:
        weights, images = out["judged"]
        cfg = cell.config["config"]
        items = judge.control_items(cfg, weights, images, CONTROL, with_probs=True)
        yield "control", judge.judge_answers(cfg, weights, items)["numbers"]
