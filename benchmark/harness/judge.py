"""What decides ``correct``: the program's outputs against the plain
reference, each number beside its limit (``benchmark/limits/<cell>.json``).

Served coordinates (cells that score images).  With random weights two
cells of a heatmap can hold nearly the same score, and a rounding then
moves the argmax; so an answer is judged by what the reference makes of
it, as a served token is judged by the gap of its logit below the best:

- ``coord_px``: the distance (largest axis, image pixels) from the
  answer to the nearest coordinate the reference's own decode would give
  were the argmax at some cell (``reference.model.cell_coords``): the
  answer must be one the decode can give;
- ``score_gap``: the reference's log-probability at that cell below the
  reference's best cell of the map (of cells within 0.01 px of the
  nearest, the best one);
- ``probs_err`` (where the timed path hands its heatmaps back): the
  largest difference of a probability heatmap from the reference's,
  over the reference map's peak, and ``probs_rms``: the root-mean-square
  difference over the reference map's root-mean-square value (the worst
  map of each);
- ``coord_px_mean``, ``score_gap_mean``: the means over all answers, and
  ``flip_share``: the share of answers whose cell is not the reference's
  best.  Which of them a cell compares, its limits file says.

Training, over the stage's first step and the first dispatches of the
timed K-step function: ``first_loss_gap`` (the first step's loss against
the reference's, over it), ``dispatch_loss_gap`` (the same of each
checked dispatch's last step, the worst), ``grad_gap`` (the first step's
gradients as the optimizer holds them, leaf by leaf: the gap of the norms
over the larger of the reference leaf's norm and the median leaf's) and
``step_gap`` (the same of the parameters' change after the first step and
after each checked dispatch, the worst, over leaves whose reference
gradient at the first step is at least a thousandth of the median
leaf's).
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference import model as ref

TIE_PX = 0.01
NUMBERS = ("coord_px", "coord_px_mean", "score_gap", "score_gap_mean", "flip_share", "probs_err",
           "probs_rms")


def judge_answers(cfg: dict, weights: dict, items: list[tuple], quant=ref.FP32,
                  block: int = 32) -> dict:
    """``items``: (uint8 images (n, H, W, 3) on the card, the program's
    coordinates (n, K, 2), its probability heatmaps (n, Hm, Wm, K) or None).
    Returns each number over all of them (the worst, and the mean over
    answers for the ``_mean`` ones) and the count of answers."""
    stride = cfg["data"]["heatmap_stride"]
    refine = bool(cfg.get("decode_refine"))
    near_all, gap_all, probs_worst, rms_worst = [], [], 0.0, 0.0
    with torch.no_grad(), ref.fp32_mode():
        for images, coords, probs in items:
            for s in range(0, images.shape[0], block):
                sl = slice(s, s + block)
                logp = ref.log_probs(ref.forward(weights, cfg, images[sl], quant))
                p = torch.exp(logp)
                got = coords[sl].to(p.device, torch.float32)
                cand = ref.cell_coords(p, stride, refine)  # (B, H, W, K, 2)
                dist = (cand - got[:, None, None]).abs().amax(dim=-1)  # (B, H, W, K)
                b, h, w, k = dist.shape
                dist = dist.reshape(b, h * w, k)
                near = dist.amin(dim=1)
                flat = logp.reshape(b, h * w, k)
                gaps = flat.amax(dim=1, keepdim=True) - flat
                gap = torch.where(dist <= near[:, None] + TIE_PX, gaps, torch.inf).amin(dim=1)
                near_all.append(near.flatten())
                gap_all.append(gap.flatten())
                if probs is not None:
                    err, rms = _heatmap_errors(probs[sl].to(p.device).float(), p)
                    probs_worst = max(probs_worst, err)
                    rms_worst = max(rms_worst, rms)
    if not near_all:  # nothing compared is nothing shown correct
        inf = float("inf")
        return {"numbers": dict.fromkeys(NUMBERS, inf), "answers": 0}
    near, gap = torch.cat(near_all), torch.cat(gap_all)
    numbers = {"coord_px": float(near.max()), "coord_px_mean": float(near.mean()),
               "score_gap": float(gap.max()), "score_gap_mean": float(gap.mean()),
               "flip_share": float((gap > 0).float().mean())}
    if any(probs is not None for _, _, probs in items):
        numbers["probs_err"], numbers["probs_rms"] = probs_worst, rms_worst
    return {"numbers": numbers, "answers": int(near.numel())}


def _heatmap_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """Over (B, H, W, K) maps, the worst of each map's largest difference
    over its peak, and of each map's root-mean-square difference over its
    root-mean-square value."""
    diff = got - want
    err = diff.abs().amax(dim=(1, 2)) / want.amax(dim=(1, 2))
    rms = diff.square().mean(dim=(1, 2)).sqrt() / want.square().mean(dim=(1, 2)).sqrt()
    return float(err.max()), float(rms.max())


def _probs(cfg: dict, weights: dict, images: torch.Tensor, quant, block: int) -> torch.Tensor:
    with torch.no_grad(), ref.fp32_mode():
        return torch.cat([torch.exp(ref.log_probs(ref.forward(weights, cfg, images[s:s + block], quant)))
                          for s in range(0, images.shape[0], block)])


def pool_rows(pool: torch.Tensor, images: torch.Tensor) -> list[int]:
    """The pool index of each image of a dispatch (-1 for one not in the
    pool: a bucket's zero padding)."""
    flat = pool.reshape(pool.shape[0], -1)
    out = []
    for row in images.reshape(images.shape[0], -1):
        hit = (flat == row).all(dim=1).nonzero()
        out.append(int(hit[0]) if len(hit) else -1)
    return out


def judge_dispatches(cfg: dict, weights: dict, pool: torch.Tensor, kept: list[tuple],
                     requests: list[tuple], quant=ref.FP32, block: int = 32) -> dict:
    """Served dispatches against the reference.

    ``kept``: (time of the call, images, coordinates, probability heatmaps)
    of sampled dispatches as the timed path produced them; each image is
    found in the benchmark's ``pool`` and the reference runs on the pool's
    image.  ``requests``: (pool offset, size, answered coordinates (size, K,
    2), time sent, time answered) of every answered request.

    - ``probs_err``, ``probs_rms``: as ``judge_answers``, over every pooled
      image of the sampled dispatches;
    - ``answer_px``: for every request served in a sampled dispatch, the
      largest distance of its answered coordinates from the reference's
      decode of the heatmaps the dispatch made for its images: the decode
      and the service's slicing of coordinates back to each request, an
      exact comparison.  A request is taken as served in a dispatch when
      its run of pool images lies among the dispatch's, it was in flight
      at the dispatch's call, and no other request then in flight holds its
      run."""
    stride = cfg["data"]["heatmap_stride"]
    refine = bool(cfg.get("decode_refine"))
    probs_err, probs_rms, answer_px, rows, matched = 0.0, 0.0, 0.0, 0, 0
    for t, images, _, probs in kept:
        idx = pool_rows(pool, images)
        here = [i for i, j in enumerate(idx) if j >= 0]
        if not here:
            continue
        want = _probs(cfg, weights, pool[[idx[i] for i in here]], quant, block)
        err, rms = _heatmap_errors(probs[here].float(), want)
        probs_err, probs_rms = max(probs_err, err), max(probs_rms, rms)
        rows += len(here)
        with torch.no_grad():
            decoded = ref.decode(probs.float(), stride, refine)
        flight = [r for r in requests if r[3] <= t <= r[4]]
        for off, size, answer, _, _ in flight:
            held = sum(o <= off and o + n >= off + size for o, n, _, _, _ in flight)
            run = list(range(off, off + size))
            starts = [p for p in range(len(idx) - size + 1) if idx[p:p + size] == run]
            if held != 1 or len(starts) != 1:
                continue
            p = starts[0]
            gap = (torch.as_tensor(answer, device=decoded.device) - decoded[p:p + size]).abs()
            answer_px = max(answer_px, float(gap.max()))
            matched += 1
    inf = float("inf")
    return {"numbers": {"probs_err": probs_err if rows else inf,
                        "probs_rms": probs_rms if rows else inf,
                        "answer_px": answer_px if matched else inf},
            "rows": rows, "requests": matched}


def control_items(cfg: dict, weights: dict, images: list[torch.Tensor], quant,
                  with_probs: bool, block: int = 32) -> list[tuple]:
    """The reference put in the program's place: its answers (and heatmaps)
    computed with the roundings ``quant``."""
    stride = cfg["data"]["heatmap_stride"]
    refine = bool(cfg.get("decode_refine"))
    out = []
    with torch.no_grad(), ref.fp32_mode():
        for imgs in images:
            coords, probs = [], []
            for s in range(0, imgs.shape[0], block):
                p = torch.exp(ref.log_probs(ref.forward(weights, cfg, imgs[s:s + block], quant)))
                coords.append(ref.decode(p, stride, refine))
                probs.append(p)
            out.append((imgs, torch.cat(coords), torch.cat(probs) if with_probs else None))
    return out


def _leaf_gaps(prog: dict, refd: dict, keep=None, diff: bool = False) -> list[float]:
    """Leaf by leaf, the gap of the program's norm from the reference's (with
    ``diff``, the norm of their difference) over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {k: float(v.float().norm()) for k, v in refd.items()}
    median = statistics.median(norms.values())
    return [(float((v.float() - refd[k].float()).norm()) if diff
             else abs(float(v.float().norm()) - norms[k])) / max(norms[k], median)
            for k, v in prog.items() if keep is None or k in keep]


def judge_training(prog: dict, refd: dict, weights: dict) -> dict:
    """``prog``/``refd``: 'losses' and 'params' (by parameter name) after
    the first step and after each checked dispatch, and the first step's
    gradients ('first_grads'); ``weights`` the parameters both started
    from."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], refd["losses"], strict=True)]
    grad_norms = {k: float(v.norm()) for k, v in refd["first_grads"].items()}
    median = statistics.median(grad_norms.values())
    moved = {k for k, n in grad_norms.items() if n >= 1e-3 * median}
    step_gap = 0.0
    for got, want in zip(prog["params"], refd["params"], strict=True):
        change = {k: got[k].float() - weights[k].float() for k in got}
        ref_change = {k: want[k].float() - weights[k].float() for k in want}
        step_gap = max(step_gap, *_leaf_gaps(change, ref_change, keep=moved))
    return {
        "first_loss_gap": gaps[0],
        "dispatch_loss_gap": max(gaps[1:]),
        "grad_gap": max(_leaf_gaps(prog["first_grads"], refd["first_grads"])),
        "grad_diff": statistics.median(_leaf_gaps(prog["first_grads"], refd["first_grads"],
                                                  diff=True)),
        "step_gap": step_gap,
        "leaves_left_out": sorted(set(grad_norms) - moved),
    }


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is within its limit, and number -> [value, limit]."""
    shown = {k: [numbers[k], limits[k]] for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), shown
