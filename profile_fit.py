#!/usr/bin/env python3
"""Where a step of ``train.fit`` goes on the card, beside the bare step.

    python3 profile_fit.py [--steps 20]

For ``flagship`` with ``mrf.impl='pallas'`` at batch 32 and the synthetic
source at 240x360 on the card, per stage ('detector', 'joint'):

- the bare step on one fixed batch (what ``chip_smoke.py`` times), wall
  time per step over ``--steps`` steps with one synchronize at the end;
- the step as ``fit`` runs it, with the batch generated before each step
  from that step's indices, the same way;
- the batch's generation alone: wall time per call, device time per call
  (CUDA events) and the number of kernels it launches (``torch.profiler``);
- under the profiler, the device-busy share of the loop as ``fit`` runs it.

Then the one-off costs of a run: the prior estimation, an evaluation
batch, a checkpoint save and restore.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def wall_ms(fn, n: int) -> float:
    """Wall time of one of ``n`` calls, one synchronize after the last."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA device", file=sys.stderr)
        return 2
    from jointpose_torch import _build, get_config
    from jointpose_torch.checkpoint import Checkpointer
    from jointpose_torch.data.pipeline import epoch_order, make_dataset
    from jointpose_torch.evaluate import make_eval_step
    from jointpose_torch.priors import estimate_priors
    from jointpose_torch.train import create_state, init_mrf_from_priors, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    _build.build(["mrf_epilogue", "shear_warp"])
    cfg = get_config("flagship")
    cfg = cfg.replace(mrf=dataclasses.replace(cfg.mrf, impl="pallas"))
    tb, n = cfg.train.batch_size, opts.steps
    train_ds, test_ds = make_dataset(cfg.data)
    state = create_state(cfg, torch.Generator().manual_seed(0))
    order = epoch_order(train_ds.size, tb, np.random.default_rng(0))
    indices = [order[i * tb:(i + 1) * tb] for i in range(n)]
    fixed = train_ds.get_batch(indices[0])

    t0 = time.perf_counter()
    priors = estimate_priors(train_ds, cfg, max_examples=2048)
    torch.cuda.synchronize()
    print(f"estimate_priors over 2048 examples (images rendered and dropped): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, on {smi}")
    state = init_mrf_from_priors(state, priors)

    for stage in ("detector", "joint"):
        step = make_train_step(cfg, stage)
        for i in range(3):  # warm-up: cuDNN's algorithm choice
            step(state, fixed)
        bare = wall_ms(lambda i: step(state, fixed), n)
        as_fit = wall_ms(lambda i: step(state, train_ds.get_batch(indices[i])), n)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            profiled = wall_ms(lambda i: step(state, train_ds.get_batch(indices[i])), n)
        busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / n
        print(f"{stage} stage, batch {tb}: bare step {bare:.3f} ms ({tb / bare * 1e3:.1f} images/s), "
              f"with the batch generated per step {as_fit:.3f} ms ({tb / as_fit * 1e3:.1f} "
              f"images/s); under the profiler {profiled:.3f} ms/step of which the device is busy "
              f"{busy:.3f} ms ({1 - busy / profiled:.1%} idle), on {smi}")

    gen_wall = wall_ms(lambda i: train_ds.get_batch(indices[i]), n)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        train_ds.get_batch(indices[i])
    end.record()
    end.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_ds.get_batch(indices[0])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    gen_busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"synthetic get_batch at batch {tb}, 240x360: {gen_wall:.3f} ms wall per call, "
          f"{start.elapsed_time(end) / n:.3f} ms between CUDA events, {gen_busy:.3f} ms of kernels "
          f"in {sum(e.count for e in events)} launches; the longest: "
          f"{[(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count) for e in top]}, "
          f"on {smi}")

    eval_step = make_eval_step(cfg, state.model)
    batch = test_ds.get_batch(np.arange(tb))
    device = torch.device("cuda")
    eval_step(batch, device)
    ev = wall_ms(lambda i: eval_step(batch, device), n)
    print(f"eval step (forward, decode, counts) on one batch of {tb}: {ev:.3f} ms "
          f"({tb / ev * 1e3:.1f} images/s), on {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(tmp, keep=1, config=cfg)
        save = wall_ms(lambda i: ckpt.save(i, state), 3)
        restore = wall_ms(lambda i: ckpt.restore(state), 3)
    print(f"checkpoint of flagship (parameters, AdamW moments, step, generator): save {save:.1f} ms, "
          f"restore {restore:.1f} ms, on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
