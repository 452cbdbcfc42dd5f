"""PDJ evaluation with flip-averaged TTA (counterpart of
``jointpose/evaluate.py``).

PDJ@t (percentage of detected joints): a joint is detected if the decoded
peak of its heatmap lies within t × torso diameter of the ground truth,
the torso diameter being the left-shoulder to right-hip distance (FLIC
protocol, arXiv:1406.2984 §4).  The headline number is PDJ@0.05 averaged
over wrists and elbows.

Flip TTA mirrors the image, runs the model, mirrors the heatmaps back
while swapping left and right joint channels, and averages in
probability space.

    python -m jointpose_torch.evaluate --config tiny \\
        --checkpoint runs/tiny/checkpoints [--best] [--tta] [--device cpu] \\
        [--quantize-artifact int8.npz] [--curves pdj.png]

Over a mesh of processes, one per device, the model's 'model' axis split
(the trunk's image rows, the head's channels, the MRF's source joints) and
each batch over 'data'; rank 0 prints and writes:

    python -m torch.distributed.run --nproc-per-node 4 -m jointpose_torch.evaluate \\
        --config eval_tta --checkpoint runs/joint/checkpoints --mesh-data 2 --mesh-model 2
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from jointpose_torch import skeleton
from jointpose_torch.cli import add_device_flag, apply_device
from jointpose_torch.configs import Config
from jointpose_torch.data.pipeline import Dataset
from jointpose_torch.ops.heatmaps import decode_probs, model_probs

DEFAULT_THRESHOLDS: tuple[float, ...] = tuple(np.linspace(0.0, 0.2, 21).round(3).tolist())


def flip_images(images: torch.Tensor) -> torch.Tensor:
    """Mirror (B, H, W, C) images horizontally."""
    return images.flip(2)


def unflip_heatmaps(heatmaps: torch.Tensor) -> torch.Tensor:
    """Mirror (B, H, W, K) heatmaps computed on flipped images back and
    swap the left and right joint channels."""
    # Channels stacked, not indexed by a list: a list index crosses to the
    # device as a pageable copy, which a CUDA graph cannot capture.
    flipped = heatmaps.flip(2)
    return torch.stack([flipped[..., j] for j in skeleton.FLIP_PERM], dim=-1)


def torso_diameter(joints_xy: torch.Tensor) -> torch.Tensor:
    """Per-example torso diameter (..., K, 2) -> (...,)."""
    a = joints_xy[..., skeleton.JOINT_INDEX[skeleton.TORSO_PAIR[0]], :]
    b = joints_xy[..., skeleton.JOINT_INDEX[skeleton.TORSO_PAIR[1]], :]
    return torch.linalg.vector_norm(a - b, dim=-1)


def pdj_counts(
    pred_xy: torch.Tensor, gt_xy: torch.Tensor, visible: torch.Tensor, thresholds: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detection counts for a batch: ``pred_xy``, ``gt_xy`` (B, K, 2) image
    pixels, ``visible`` (B, K), ``thresholds`` (T,) fractions of the torso
    diameter -> (detected (T, K), visible (K,), torso-valid examples ()).

    Examples whose torso endpoints are not both annotated have no valid
    normalizer (a missing joint sits at (0, 0), which would make a huge
    torso that detects everything): they are excluded entirely, and
    counted per example, not inferred from the per-joint counts.
    """
    dist = torch.linalg.vector_norm(pred_xy - gt_xy, dim=-1)  # (B, K)
    torso = torso_diameter(gt_xy)[:, None]  # (B, 1)
    li = skeleton.JOINT_INDEX[skeleton.TORSO_PAIR[0]]
    ri = skeleton.JOINT_INDEX[skeleton.TORSO_PAIR[1]]
    torso_ok = (visible[:, li] * visible[:, ri]).float()[:, None]
    vis = visible.float() * torso_ok
    ok = dist[None] <= thresholds[:, None, None] * torso[None]  # (T, B, K)
    detected = (ok.float() * vis[None]).sum(dim=1)  # (T, K)
    return detected, vis.sum(dim=0), torso_ok.sum()


def make_eval_step(config: Config, apply_fn: Callable, thresholds=DEFAULT_THRESHOLDS) -> Callable:
    """The per-batch eval: forward (+ flip TTA) -> decode -> counts, under
    ``inference_mode``.  ``apply_fn(images) -> dict`` is a ``PoseModel`` or
    a detector-only view of one (``functools.partial(model,
    detector_only=True)``); the batch is moved to ``device`` (the model's)."""
    stride = config.data.heatmap_stride
    thr_on: dict[torch.device, torch.Tensor] = {}

    @torch.inference_mode()
    def eval_step(batch: dict, device: torch.device):
        images = batch["image"].to(device)
        probs = model_probs(apply_fn(images))
        if config.eval_flip_tta:
            flipped = model_probs(apply_fn(flip_images(images)))
            probs = 0.5 * (probs + unflip_heatmaps(flipped))
        pred = decode_probs(probs, stride, refine=config.decode_refine)
        if device not in thr_on:
            thr_on[device] = torch.tensor(thresholds, dtype=torch.float32, device=device)
        return pdj_counts(
            pred, batch["joints"].to(device), batch["visible"].to(device), thr_on[device]
        )

    # Recorded so evaluate() can reject a prebuilt step whose thresholds
    # disagree with the labels it would report them under.
    eval_step.thresholds = tuple(float(t) for t in thresholds)
    return eval_step


def evaluate(
    model: torch.nn.Module,
    dataset: Dataset,
    config: Config,
    thresholds=DEFAULT_THRESHOLDS,
    max_batches: int | None = None,
    eval_step: Callable | None = None,
    uint8_ingest: bool = False,
    mesh=None,
) -> dict:
    """Full-split evaluation of ``model`` (a ``PoseModel``, or the int8 model
    of ``ops/quant.py``) on its device; returns the PDJ curves and headline
    numbers.  ``eval_step`` (from ``make_eval_step``) replaces the default
    step over the whole model, e.g. to score the detector head alone.

    With ``mesh`` (``parallel.mesh.Mesh``) each rank scores its rows of
    every global batch (the ragged last one masked alike) and the counts
    are summed over 'data', so every rank returns the same PDJ; the data
    axis must divide the batch size.  Tensor parallelism comes with the
    model (``PoseModel(mesh=)``)."""
    n_data = 1 if mesh is None else mesh.shape["data"]
    d = 0 if mesh is None else mesh.coords["data"]
    if config.train.batch_size % n_data:
        raise ValueError(f"eval batch size {config.train.batch_size} must be divisible by the "
                         f"mesh data axis ({n_data})")
    if eval_step is not None and hasattr(eval_step, "thresholds"):
        assert eval_step.thresholds == tuple(float(t) for t in thresholds), (
            "prebuilt eval_step was built with different thresholds than "
            "the labels requested here"
        )
    eval_step = eval_step or make_eval_step(config, model, thresholds)
    # The int8 model of a config without an MRF holds buffers alone.
    device = next(itertools.chain(model.parameters(), model.buffers())).device
    batch = config.train.batch_size
    detected = torch.zeros(len(thresholds), skeleton.NUM_JOINTS, dtype=torch.float64, device=device)
    visible = torch.zeros(skeleton.NUM_JOINTS, dtype=torch.float64, device=device)
    torso_seen = torch.zeros((), dtype=torch.float64, device=device)
    # Exact-split coverage: the final ragged chunk is padded by wrapping and
    # the padded duplicates are masked out through `visible`, so every
    # example counts once.
    n = dataset.size
    rows = batch // n_data
    examples_seen = torch.zeros((), dtype=torch.float64, device=device)
    for i, start in enumerate(range(0, n, batch)):
        if max_batches is not None and i >= max_batches:
            break
        # This rank's rows of the global batch [start, start + batch).
        pos = np.arange(start + d * rows, start + (d + 1) * rows)
        got = dict(dataset.get_batch((pos % n).astype(np.int32)))
        if uint8_ingest and got["image"].dtype != torch.uint8:
            # Score the serving input contract: clients send raw uint8
            # RGB, which the model normalizes.  A dataset that already
            # hands back uint8 passes through untouched.
            got["image"] = torch.round(got["image"] * 255.0).to(torch.uint8)
        if start + batch > n:
            mask = torch.from_numpy((pos < n).astype(np.float32))
            got["visible"] = got["visible"] * mask.to(got["visible"].device)[:, None]
        examples_seen += int((pos < n).sum())
        det, v, t = eval_step(got, device)
        detected += det
        visible += v
        torso_seen += t
    if mesh is not None:
        counts = torch.cat([detected.reshape(-1), visible, torso_seen[None], examples_seen[None]])
        mesh.all_reduce(counts, "data")
        detected, visible = counts[:detected.numel()].view_as(detected), counts[detected.numel():-2]
        torso_seen, examples_seen = counts[-2], counts[-1]
    examples_seen = float(examples_seen)
    curves = (detected / visible[None].clamp_min(1.0)).cpu().numpy()  # (T, K)
    thresholds_np = np.asarray(thresholds)
    t05 = int(np.argmin(np.abs(thresholds_np - 0.05)))
    per_joint_05 = {name: float(curves[t05, j]) for j, name in enumerate(skeleton.JOINTS)}
    headline = float(np.mean([per_joint_05[n] for n in skeleton.HEADLINE_JOINTS]))
    return {
        "thresholds": thresholds_np.tolist(),
        "pdj_curves": curves.tolist(),  # (T, K)
        "pdj_at_05": per_joint_05,
        "pdj_at_05_wrist_elbow": headline,
        # Examples processed; torso-less examples are excluded from the
        # curves but still counted here (see num_torso_excluded).
        "num_examples": float(examples_seen),
        "num_torso_excluded": float(examples_seen - float(torso_seen)),
    }


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="jointpose_torch PDJ evaluation")
    parser.add_argument("--config", default="eval_tta")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--best", action="store_true")
    parser.add_argument("--split", choices=["train", "test"], default="test")
    parser.add_argument("--max-batches", type=int, default=None)
    parser.add_argument("--tta", action=argparse.BooleanOptionalAction, default=None,
                        help="override the preset's eval_flip_tta")
    parser.add_argument("--refine", action=argparse.BooleanOptionalAction, default=None,
                        help="override the preset's decode_refine")
    parser.add_argument("--pool-mode", choices=["max", "stride"], default=None,
                        help="override the trunk downsampling mode (normally adopted from the "
                             "checkpoint's run_config.json; contradicting it is an error)")
    parser.add_argument("--mrf-precision", choices=["high", "default"], default=None,
                        help="matmul precision inside the MRF message pass (the preset's "
                             "unless given; 'default' is one TF32 pass on the card)")
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="data-parallel processes (one per device; 0 or -1 = the world over "
                             "--mesh-model); launch them with python -m torch.distributed.run")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="model-axis processes: the detector trunk's image rows (halo "
                             "exchanges), the head's channels and the MRF's source joints")
    parser.add_argument("--quantize-artifact", default=None, metavar="NPZ",
                        help="evaluate a prebuilt int8 artifact (python -m "
                             "jointpose_torch.quantize) instead of calibrating: the exact "
                             "tensors a deployment serves")
    parser.add_argument("--quantize", type=int, default=0, metavar="N_CALIB",
                        help="evaluate the int8-quantized detector (ops/quant.py), calibrating "
                             "activation scales on N_CALIB training images")
    parser.add_argument("--uint8-ingest", action="store_true",
                        help="feed the split as raw uint8 RGB (the serving input contract)")
    parser.add_argument("--source", choices=["synthetic", "flic"], default=None)
    parser.add_argument("--flic-dir", default=None)
    parser.add_argument("--curves", default=None,
                        help="write the PDJ-curve figure to this PNG path")
    parser.add_argument("--json-out", default=None,
                        help="write the full metrics dict to this JSON path")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    from jointpose_torch.parallel.mesh import init_distributed, shutdown_distributed

    device = apply_device(args.device)
    # Joins the process group of a multi-process launch (a no-op alone).
    device = init_distributed(device) or device
    try:
        _main(args, device)
    finally:
        shutdown_distributed()


def _main(args, device: torch.device) -> None:
    import dataclasses
    import json
    import os

    from jointpose_torch.checkpoint import reconcile_config
    from jointpose_torch.configs import MeshConfig, get_config, with_mrf_precision
    from jointpose_torch.data.pipeline import device_cache, make_dataset
    from jointpose_torch.models.pose import PoseModel
    from jointpose_torch.parallel.mesh import make_mesh
    from jointpose_torch.predict import restore_params

    mesh = make_mesh(MeshConfig(data=args.mesh_data, model=args.mesh_model))
    quantized = args.quantize > 0 or bool(args.quantize_artifact)
    if quantized and mesh.size > 1:
        raise SystemExit("--quantize is exclusive with --mesh-data/--mesh-model")
    config = get_config(args.config)
    if args.tta is not None:
        config = config.replace(eval_flip_tta=args.tta)
    if args.refine is not None:
        config = config.replace(decode_refine=args.refine)
    if args.mrf_precision is not None:
        config = with_mrf_precision(config, args.mrf_precision)
    dd = {k: v for k, v in (("source", args.source), ("flic_dir", args.flic_dir)) if v is not None}
    if dd:
        config = config.replace(data=dataclasses.replace(config.data, **dd))
    config = reconcile_config(config, args.checkpoint, args.pool_mode)
    state_dict, step = restore_params(config, args.checkpoint, args.step, best=args.best)
    train_ds, test_ds = make_dataset(config.data, device)
    ds = train_ds if args.split == "train" else test_ds
    if config.data.device_cache_gb > 0:
        ds = device_cache(ds, config.data.device_cache_gb * 1e9, device)
    if quantized:
        from jointpose_torch.ops.quant import quantized_model_for

        model, line = quantized_model_for(config, state_dict, args.quantize,
                                          args.quantize_artifact, train_ds, device)
        print(line)
    else:
        model = PoseModel(config, mesh=mesh, spatial=True)
        model.load_state_dict(state_dict)
        model = model.to(device).eval()
    ev = evaluate(model, ds, config, max_batches=args.max_batches, uint8_ingest=args.uint8_ingest,
                  mesh=mesh)
    if mesh.rank != 0:
        return

    print(f"checkpoint step {step}, {args.split} split, {int(ev['num_examples'])} examples")
    for name, v in ev["pdj_at_05"].items():
        print(f"  PDJ@0.05 {name:>5}: {v:.4f}")
    print(f"  PDJ@0.05 wrist/elbow: {ev['pdj_at_05_wrist_elbow']:.4f}")
    if args.curves:
        from jointpose_torch.visualize import save_pdj_curves

        save_pdj_curves(ev, args.curves)
        print(f"curves -> {args.curves}")
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(ev, f, indent=1)
        print(f"metrics -> {args.json_out}")


if __name__ == "__main__":
    main()
