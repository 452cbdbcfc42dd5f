"""Training through the K-step dispatch for a host-resident split
(``train.make_train_multistep_arrays``, the path ``fit`` takes for one):
the joint stage, K steps a dispatch (one CUDA graph each on the card),
batches of uint8 images, joints and visibilities from a pinned host pool
made from the seed.  Over several ranks (``ranks`` > 1) every rank runs
this on its rows of each global batch, its card's mesh made by the
program (``parallel/mesh.py``), the gradient sums inside each dispatch's
graph.

Set-up builds one training state from the seed's weights and starts the
stage as ``fit`` does on the card: its first step alone
(``train.make_train_step``, eager), on a batch of its own.  It then runs
the first ``checked_dispatches`` dispatches of the window's own K-step
function on the pool's first batches (rows that all differ): the first
runs eagerly and warms the stage, the second captures the graph that the
window replays, and replays it.  It keeps the first step's loss, its
gradients as the optimizer holds them (AdamW's first moment after one
step over 1 - beta1) and the parameters after it, and after each checked
dispatch its last step's loss and the parameters; the reference follows
those steps from the seed.  The same state and function then run the
window: a fixed number of dispatches, sized in set-up to last about
``--seconds``, with a synchronise at each end.

Traffic keys: ``ranks``, ``rows_per_rank``, ``steps_per_dispatch``,
``pool_dispatches`` (distinct dispatches of batches in the pool, at least
``checked_dispatches``), ``checked_dispatches``, ``warm_dispatches``,
``timed_dispatches`` (to size the window), ``trace_slice`` ({'start':
share of the window's dispatches, 'dispatches'}).
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import inputs, judge, spec, stats
from benchmark.harness.trace import Profiler, warm_profiler
from benchmark.reference import train as ref_train
from benchmark.reference.precision import CONTROL

BETA1 = 0.9


def aug_seed(seed: int) -> int:
    return (int(seed) * 7919 + 17) & inputs.SEED_MASK


def first_batch(cell, seed: int, device) -> dict:
    """The global batch of the stage's first step on ``device``."""
    tr, cfg = cell.traffic, cell.config["config"]
    hw = tuple(cfg["data"]["image_hw"])
    gb = tr["rows_per_rank"] * tr.get("ranks", 1)
    joints, visible = inputs.make_joints(gb, hw, seed, 301, device)
    return {"image": inputs.make_images(gb, hw, seed, 300, device), "joints": joints,
            "visible": visible}


def pool_batch(cell, seed: int, j: int, device) -> dict:
    """The pool's ``j``-th dispatch of global batches on ``device``: (K,
    global batch, ...) uint8 images, fp32 joints and visibilities."""
    tr, cfg = cell.traffic, cell.config["config"]
    hw = tuple(cfg["data"]["image_hw"])
    k, gb = tr["steps_per_dispatch"], tr["rows_per_rank"] * tr.get("ranks", 1)
    images = inputs.make_images(k * gb, hw, seed, 400 + j, device)
    joints, visible = inputs.make_joints(k * gb, hw, seed, 500 + j, device)
    return {"image": images.reshape(k, gb, *images.shape[1:]), "joints": joints.reshape(k, gb, 9, 2),
            "visible": visible.reshape(k, gb, 9)}


def _host(batch: dict, rows: slice, pin: bool, axis: int = 1) -> dict:
    out = {}
    for k, v in batch.items():
        t = v.narrow(axis, rows.start, rows.stop - rows.start).cpu().contiguous()
        out[k] = t.pin_memory() if pin else t
    return out


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", fault=None) -> dict:
    from jointpose_torch.parallel.mesh import init_distributed, make_mesh, shard_state
    from jointpose_torch.train import create_state, make_train_multistep_arrays, make_train_step

    tr, cfg = cell.traffic, cell.config["config"]
    world = int(tr.get("ranks", 1))
    device = torch.device(init_distributed(device) if world > 1 else device)
    on_card = device.type == "cuda"
    port_cfg = spec.port_config(cell.config)
    mesh = make_mesh(port_cfg.mesh)
    if mesh.size != world:
        raise RuntimeError(f"the program's mesh has {mesh.size} ranks, the traffic asks for {world}")
    rows, k = tr["rows_per_rank"], tr["steps_per_dispatch"]
    gb = rows * mesh.shape["data"]
    mine = slice(mesh.coords["data"] * rows, (mesh.coords["data"] + 1) * rows)

    weights = inputs.make_weights(cfg, seed, device)
    state = create_state(port_cfg, torch.Generator().manual_seed(0), device=device, mesh=mesh)
    state.model.load_state_dict(weights)
    state.generator.manual_seed(aug_seed(seed))
    state = shard_state(state, mesh)
    if tr["pool_dispatches"] < tr["checked_dispatches"]:
        raise ValueError("the checked dispatches take distinct batches of the pool")
    pool = [_host(pool_batch(cell, seed, j, device), mine, on_card)
            for j in range(tr["pool_dispatches"])]

    opening = _host(first_batch(cell, seed, device), mine, on_card, axis=0)
    multi = make_train_multistep_arrays(port_cfg, "joint", k, mesh)
    if fault is not None:
        multi = fault(multi)
    names = [n for n, _ in state.model.named_parameters()]
    state, metrics = make_train_step(port_cfg, "joint", mesh)(state, opening)
    readings = {"losses": [float(metrics["loss"])],
                "first_grads": {n: (state.optimizer.state[p]["exp_avg"] / (1.0 - BETA1)).cpu()
                                for n, p in zip(names, state.model.parameters())},
                "params": [{n: p.detach().to("cpu", copy=True)
                            for n, p in state.model.named_parameters()}]}
    for j in range(tr["checked_dispatches"]):
        state, metrics = multi(state, pool[j])
        readings["losses"].append(float(metrics["loss"]))
        readings["params"].append({n: p.detach().to("cpu", copy=True)
                                   for n, p in state.model.named_parameters()})

    for j in range(tr["warm_dispatches"]):
        state, _ = multi(state, pool[j % len(pool)])
    _sync(on_card)
    t = time.perf_counter()
    for j in range(tr["timed_dispatches"]):
        state, _ = multi(state, pool[j % len(pool)])
    _sync(on_card)
    per_dispatch = (time.perf_counter() - t) / tr["timed_dispatches"]
    n = torch.tensor([max(3, round(seconds / per_dispatch))], device=device)
    n = int(mesh.all_reduce(n, None, torch.distributed.ReduceOp.MAX) if mesh.size > 1 else n)
    if trace:
        warm_profiler()
    prof = Profiler() if trace else None
    first = int(tr["trace_slice"]["start"] * n)
    last = min(first + tr["trace_slice"]["dispatches"], n)
    before = [0.0, 0]  # the window's time and dispatches before the traced slice

    _sync(on_card)
    window_start = time.time()
    t0 = time.perf_counter()
    pending: list = []
    for i in range(n):
        if prof is not None and i == first:
            _sync(on_card)
            before[:] = [time.perf_counter() - t0, i]
            prof.start()
        if prof is not None and i == last:
            prof.stop()
        state, _ = multi(state, pool[i % len(pool)])
        if on_card:  # at most two dispatches ahead of the host
            pending.append(torch.cuda.Event())
            pending[-1].record()
            if len(pending) > 2:
                pending.pop(0).synchronize()
    _sync(on_card)
    elapsed = time.perf_counter() - t0
    if prof is not None and last == n:
        prof.stop()
    memory = torch.cuda.max_memory_allocated(device) if on_card else 0
    state.graphs.release()
    del state, multi
    images_done = n * k * gb
    out = {
        "window_start": window_start, "attempted": n, "failed": 0,
        "e2e": {"train_images_per_s": stats.rate(images_done, elapsed)},
        "counts": {"window_s": elapsed, "images": images_done,
                   "untraced_s": before[0], "untraced_images": before[1] * k * gb},
        "traces": [prof.summarize()] if prof is not None else [],
        "memory_peak_bytes": memory,
        "readings": readings,
        "notes": [f"rank {mesh.rank}: {n} dispatches of {k} steps of {gb} images in "
                  f"{elapsed:.3f} s; set-up's {per_dispatch * 1e3:.3f} ms a dispatch; losses of the "
                  f"first step and the checked dispatches {readings['losses']}"],
    }
    if world > 1:
        return out
    if on_card:
        torch.cuda.empty_cache()
    return combine(cell, seed, [out], device)


def _sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def reference(cell, seed: int, device, quant=None, rows: slice | None = None,
              still: bool = False) -> tuple[dict, dict]:
    """The reference's readings over the first step and the checked
    dispatches, as the program's are kept (on the CPU), and the weights
    (on the CPU)."""
    tr, cfg = cell.traffic, cell.config["config"]
    k = tr["steps_per_dispatch"]
    weights = inputs.make_weights(cfg, seed, device)
    batches = [first_batch(cell, seed, device)]
    batches += [{n: v[s] for n, v in pool_batch(cell, seed, j, device).items()}
                for j in range(tr["checked_dispatches"]) for s in range(k)]
    marks = [1 + k * j for j in range(tr["checked_dispatches"] + 1)]
    kw = {} if quant is None else {"quant": quant}
    got = ref_train.train(cfg, weights, batches, aug_seed(seed), rows=rows, marks=marks,
                          still=still, **kw)

    def cpu(tensors: dict) -> dict:
        return {n: v.cpu() for n, v in tensors.items()}

    refd = {"losses": [got["losses"][m - 1] for m in marks],
            "first_grads": cpu(got["first_grads"]),
            "params": [cpu(got["params"][m]) for m in marks]}
    return refd, cpu(weights)


def combine(cell, seed: int, results: list[dict], device) -> dict:
    """One result from every rank's: the window from the slowest rank, the
    traces of all, the fullest card's memory, and every rank's readings
    against the reference's (the worst of each number)."""
    refd, weights = reference(cell, seed, device)
    numbers: dict = {}
    for r in results:
        for key, value in judge.judge_training(r["readings"], refd, weights).items():
            if isinstance(value, float):
                numbers[key] = max(numbers.get(key, 0.0), value)
            else:
                numbers[key] = value
    elapsed = max(r["counts"]["window_s"] for r in results)
    lead = results[0]
    return {
        "window_start": lead["window_start"], "attempted": lead["attempted"], "failed": 0,
        "e2e": {"train_images_per_s": stats.rate(lead["counts"]["images"], elapsed)},
        "counts": dict(lead["counts"], window_s=elapsed),
        "traces": [t for r in results for t in r["traces"]],
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in results),
        "numbers": numbers,
        "notes": [note for r in results for note in r["notes"]]
        + [f"reference losses {refd['losses']}; left out of step_gap (reference gradient under "
           f"a thousandth of the median leaf's): {numbers.get('leaves_left_out')}"],
    }


def readings(cell, seed: int, seconds: float, control: bool, device: str = "cuda"):
    """The program's numbers, and the lower-precision control's and the planted faults'
    against the reference (``tools/readings.py``): half of each batch left
    out, the parameters left where they are, and over several ranks the
    gradient sums left out (each rank on its own rows)."""
    out = run(cell, seed, seconds, False, device)
    yield "program", {k: v for k, v in out["numbers"].items() if isinstance(v, float)}
    if control:
        yield from faults(cell, seed, device)


def faults(cell, seed: int, device):
    """The lower-precision control's readings and the planted faults', in the reference."""
    refd, weights = reference(cell, seed, device)
    tr = cell.traffic
    gb = tr["rows_per_rank"] * tr.get("ranks", 1)
    plants = {"control": {"quant": CONTROL}, "fault_half_batch": {"rows": slice(0, gb // 2)},
              "fault_state_unchanged": {"still": True}}
    if tr.get("ranks", 1) > 1:
        plants["fault_no_exchange"] = {"rows": slice(0, tr["rows_per_rank"])}
    for kind, kw in plants.items():
        got, _ = reference(cell, seed, device, **kw)
        nums = judge.judge_training(got, refd, weights)
        yield kind, {k: v for k, v in nums.items() if isinstance(v, float)}
