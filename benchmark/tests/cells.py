"""Small cells for the CPU tests: the loops and comparisons of the
benchmark's cells, with their limits, at the ``tiny`` preset's sizes
(fp32).  ``flagship-like`` is ``tiny`` on the flagship's paths: stride-2
trunk convs, the coarse MRF at stride 2, the shear warp, refined decode."""

import dataclasses
import json

from jointpose_torch.configs import get_config

from benchmark.harness import spec


def config(kind: str = "flagship-like") -> dict:
    c = get_config("tiny")
    if kind == "flagship-like":
        c = c.replace(detector=dataclasses.replace(c.detector, pool_mode="stride"),
                      mrf=dataclasses.replace(c.mrf, stride=2, window=(5, 7)),
                      augment=dataclasses.replace(c.augment, warp_impl="shear"),
                      decode_refine=True, mesh=dataclasses.replace(c.mesh, data=-1))
    return {"preset": "tiny", "config": json.loads(json.dumps(dataclasses.asdict(c)))}


def _cell(name, cfg, traffic, limits_of) -> spec.Cell:
    limits = spec.load_json(spec.BENCH_DIR / "limits" / f"{limits_of}.json")
    return spec.Cell(name=name, chips=1, config=cfg, traffic=traffic, limits=limits,
                     end_to_end=[], per_layer=[])


def offline() -> spec.Cell:
    tr = {"loop": "closed_batch", "batch": 8, "pool_batches": 2, "warm_calls": 2,
          "sample_calls": 3, "sample_from": 4, "trace_slice": {"start": 0.3, "seconds": 1.0}}
    return _cell("tiny.offline", config(), tr, "flagship.offline_b128")


def serve() -> spec.Cell:
    tr = {"loop": "open_serve", "rate": 40, "sizes": [1, 4], "batch_size": 8,
          "batch_buckets": [2, 4], "batch_wait_ms": 2, "pool_images": 32, "clients": 8,
          "warm_sizes": [1, 4], "sample_dispatches": 12, "sample_from": 20,
          "trace_slice": {"start": 0.3, "seconds": 1.0}, "wait_s": 30}
    return _cell("tiny.serve", config("tiny"), tr, "joint.serve_open")


def train(ranks: int = 1) -> spec.Cell:
    tr = {"loop": "train_steps", "ranks": ranks, "rows_per_rank": 4 // ranks,
          "steps_per_dispatch": 2, "pool_dispatches": 2, "checked_dispatches": 2,
          "warm_dispatches": 1, "timed_dispatches": 1, "trace_slice": {"start": 0.3, "dispatches": 1}}
    return _cell(f"tiny.train{ranks}", config(), tr, "flagship.train_b32")
