"""Open-loop serving through ``serve.PoseService`` in process: requests
arrive on a schedule made from the seed, each sent by a client thread when
it is due, whether or not earlier ones have been answered, and each timed
from when it was due to its reply.

Traffic keys: ``rate`` (requests/s, fixed: 0.8 of the knee found by a
sweep, ``knee``), ``sizes`` ([least, most] images a request, uniform),
``batch_size``, ``batch_buckets``, ``batch_wait_ms`` (the service's),
``pool_images`` (distinct uint8 images in the host pool a request takes a
run of), ``clients`` (threads), ``warm_sizes`` (requests sent one by one
in set-up), ``sample_dispatches`` (dispatches whose images, coordinates and
heatmaps, as the service's predictor returned them, are kept for the
comparison, drawn from the seed among the window's first ``sample_from``),
``trace_slice`` ({'start': share of the window, 'seconds'}), ``wait_s``
(how long past the window's close replies are waited for).

Every seed gets the same set of request sizes and gaps between arrivals
(sizes cycled evenly over the range, gaps the quantiles of the exponential
distribution of the rate), in its own order.
"""

from __future__ import annotations

import concurrent.futures
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import inputs, judge, spec, stats
from benchmark.harness.trace import SPAN_PREFIX, Profiler, warm_profiler
from benchmark.reference.model import JOINTS
from benchmark.reference.precision import CONTROL


def schedule(tr: dict, rate: float, seconds: float, seed: int) -> dict:
    """Due times (s from the window's start), sizes and pool offsets."""
    n = max(int(round(rate * seconds)), 1)
    lo, hi = tr["sizes"]
    sizes = np.array([lo + i % (hi - lo + 1) for i in range(n)])
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = np.random.default_rng(seed)
    sizes, gaps = rng.permutation(sizes), rng.permutation(gaps)
    due = seconds * np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) / gaps.sum()
    offsets = rng.integers(0, tr["pool_images"] - sizes + 1)
    return {"due": due, "sizes": sizes, "offsets": offsets}


def _joints(reply: list[dict]) -> np.ndarray:
    return np.array([[p["joints"][name] for name in JOINTS] for p in reply], dtype=np.float32)


def open_loop(service, pool: np.ndarray, tr: dict, rate: float, seconds: float, seed: int,
              prof: Profiler | None = None) -> dict:
    """Drive ``service`` with the schedule for ``seconds``; wait for every
    reply until ``wait_s`` past the close."""
    sch = schedule(tr, rate, seconds, seed)
    n = len(sch["due"])
    sent: list[float | None] = [None] * n
    done: list[float | None] = [None] * n
    replies: list = [None] * n

    def call(i: int) -> None:
        sent[i] = time.perf_counter()
        off, size = int(sch["offsets"][i]), int(sch["sizes"][i])
        try:
            reply = service.predict(pool[off:off + size])
            done[i] = time.perf_counter()
            # Kept as one array: the benchmark holds no reply's objects.
            replies[i] = _joints(reply)
        except Exception as e:  # a shed or failed request: counted, never raised
            replies[i] = e

    recorder = service._predict
    slice_at = tr["trace_slice"]["start"] * seconds
    slice_t = [0.0, 0.0]
    before = dict(service.stats)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with concurrent.futures.ThreadPoolExecutor(tr["clients"]) as pool_threads:
        # Every client thread started before the window opens.
        concurrent.futures.wait([pool_threads.submit(time.sleep, 0.05) for _ in range(tr["clients"])])
        recorder.start()
        window_start = time.time()
        t0 = time.perf_counter()
        futures = []
        for i in range(n):
            due = t0 + sch["due"][i]
            if prof is not None:
                now = time.perf_counter() - t0
                if not slice_t[0] and now >= slice_at:
                    prof.start()
                    slice_t[0] = time.perf_counter()
                elif slice_t[0] and not slice_t[1] and now >= slice_at + tr["trace_slice"]["seconds"]:
                    prof.stop()
                    slice_t[1] = time.perf_counter()
            while (left := due - time.perf_counter()) > 0:
                time.sleep(min(left, 0.002))
            futures.append(pool_threads.submit(call, i))
        close = t0 + seconds
        while (left := close - time.perf_counter()) > 0:
            time.sleep(min(left, 0.01))
        if prof is not None and not slice_t[1]:
            prof.stop()
            slice_t[1] = time.perf_counter()
        concurrent.futures.wait(futures, timeout=max(close + tr["wait_s"] - time.perf_counter(), 0))
        gave_up = time.perf_counter()
        for f in futures:
            f.cancel()
        # Read while every profiled thread still runs.
        summary = prof.summarize() if prof is not None else None
    after = dict(service.stats)
    due_abs = [t0 + d for d in sch["due"]]
    lat = stats.latencies_ms(due_abs, done, gave_up)
    late = [(s - d) * 1e3 for s, d in zip(sent, due_abs) if s is not None]
    return {
        "window_start": window_start, "schedule": sch, "replies": replies, "latencies_ms": lat,
        "sent": sent, "done": done,
        "failed": sum(d is None for d in done), "attempted": n,
        "lateness_ms": {"p50": stats.percentile(late, 50), "p95": stats.percentile(late, 95),
                        "max": max(late)} if late else {},
        "stats": {k: after[k] - before[k] for k in after},
        "trace": summary,
    }


class Recorder:
    """Wraps the service's predictor: keeps what sampled dispatches of the
    window produced, and with ``span`` opens a range ``dispatch#<bucket>``
    around each dispatch for the trace."""

    def __init__(self, predict, sample: set[int], span: bool):
        self.predict, self.sample, self.span = predict, sample, span
        self.kept: list[tuple] = []
        self.n = -1  # dispatches of the window so far; -1 before it

    def start(self) -> None:
        self.n = 0

    def __call__(self, images):
        if self.span:
            with torch.profiler.record_function(f"{SPAN_PREFIX}dispatch#{images.shape[0]}"):
                coords, probs = self.predict(images)
        else:
            coords, probs = self.predict(images)
        if self.n in self.sample:
            self.kept.append((time.perf_counter(), images, coords, probs))
        if self.n >= 0:
            self.n += 1
        return coords, probs


def _setup(cell, seed: int, device: str, trace: bool):
    from jointpose_torch.convert import write_initial_checkpoint
    from jointpose_torch.serve import PoseService

    tr, cfg = cell.traffic, cell.config["config"]
    weights = inputs.make_weights(cfg, seed, device)
    pool = inputs.make_images(tr["pool_images"], tuple(cfg["data"]["image_hw"]), seed, 200, device)
    pool_np = pool.cpu().numpy()
    port_cfg = spec.port_config(cell.config)
    ckpt = tempfile.mkdtemp(prefix="bench_ckpt_")
    try:
        write_initial_checkpoint(port_cfg, ckpt, {k: v.cpu() for k, v in weights.items()})
        service = PoseService(port_cfg, ckpt, batch_size=tr["batch_size"], step=0,
                              batch_buckets=tr["batch_buckets"], batch_wait_ms=tr["batch_wait_ms"],
                              device=device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for size in tr["warm_sizes"]:
        service.predict(pool_np[:size])
    if trace:
        warm_profiler()
    rng = np.random.default_rng(seed + 1)
    sample = set(rng.choice(tr["sample_from"], size=tr["sample_dispatches"], replace=False).tolist())
    service._predict = Recorder(service._predict, sample, trace)
    return weights, pool, pool_np, service


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", fault=None) -> dict:
    tr, cfg = cell.traffic, cell.config["config"]
    on_card = torch.device(device).type == "cuda"
    weights, pool, pool_np, service = _setup(cell, seed, device, trace)
    if fault is not None:
        fault(service._predict)
    prof = Profiler() if trace else None
    res = open_loop(service, pool_np, tr, tr["rate"], seconds, seed, prof)
    memory = torch.cuda.max_memory_allocated() if on_card else 0
    kept = service._predict.kept
    service.close()
    del service
    if on_card:
        torch.cuda.empty_cache()
    lat = res["latencies_ms"]
    out = {
        "window_start": res["window_start"], "attempted": res["attempted"], "failed": res["failed"],
        "e2e": {"latency_p50_ms": stats.percentile(lat, 50),
                "latency_p95_ms": stats.percentile(lat, 95)},
        "counts": {"stats_images": res["stats"]["images"],
                   "stats_dispatches": res["stats"]["dispatches"]},
        "traces": [res["trace"]] if prof is not None else [],
        "memory_peak_bytes": memory,
    }
    sch = res["schedule"]
    requests = [(int(sch["offsets"][i]), int(sch["sizes"][i]), r, res["sent"][i], res["done"][i])
                for i, r in enumerate(res["replies"]) if isinstance(r, np.ndarray)]
    verdict = judge.judge_dispatches(cfg, weights, pool, kept, requests)
    out["numbers"] = verdict["numbers"]
    lt = res["lateness_ms"]
    out["notes"] = [
        f"generator lateness (sent - due) ms: p50 {lt.get('p50', float('nan')):.3f} "
        f"p95 {lt.get('p95', float('nan')):.3f} max {lt.get('max', float('nan')):.3f}; "
        f"{res['attempted']} requests at {tr['rate']} /s, {res['failed']} failed; service "
        f"{res['stats']}",
        f"compared the heatmaps of {verdict['rows']} images of {len(kept)} dispatches and the "
        f"answers of {verdict['requests']} requests served in them with the reference"]
    out["judged"] = (weights, pool, kept)
    return out


def readings(cell, seed: int, seconds: float, control: bool, device: str = "cuda"):
    """The program's numbers in a short window, and the lower-precision control's heatmaps
    on the same dispatches' images (``tools/readings.py``)."""
    out = run(cell, seed, seconds, False, device)
    yield "program", out["numbers"]
    if control:
        weights, pool, kept = out["judged"]
        cfg = cell.config["config"]
        ctrl = [(t, images, None, judge._probs(cfg, weights, images, CONTROL, 32))
                for t, images, _, _ in kept]
        got = judge.judge_dispatches(cfg, weights, pool, ctrl, [])["numbers"]
        yield "control", {k: got[k] for k in ("probs_err", "probs_rms")}
