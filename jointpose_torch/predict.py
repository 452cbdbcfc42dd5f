"""Batch inference (counterpart of ``jointpose/predict.py``):
images -> joint coordinates and heatmaps, as a library call and a CLI.

    config = get_config("joint")
    state = init_state_dict(config, torch.Generator().manual_seed(0))
    predict = build_predictor(config, state)           # on the GPU
    coords, probs = predict(images_uint8_nhwc)

    state, step = restore_params(config, "runs/joint/checkpoints", best=True)
    predict = build_predictor(reconcile_config(config, "runs/joint/checkpoints"), state)

CLI: restore a checkpoint, predict a split, write ``predictions.jsonl``
(one record per example) and, with ``--figures``, heatmap overlays; with
``--quantize N`` / ``--quantize-artifact NPZ`` through the int8 detector
of ``ops/quant.py``; with ``--pipeline N_MICRO`` through the two-stage
pipelined predictor of ``parallel/pipeline.py``; with ``--mesh-data D
--mesh-model M`` over a D x M device mesh (``parallel/mesh.DeviceMesh``):
the batch split over 'data', the trunk's image rows over 'model'
(``parallel/spatial.py``):

    python -m jointpose_torch.predict --config flagship \\
        --checkpoint runs/flagship/checkpoints --workdir out/ \\
        [--split test] [--num 64] [--figures] [--quantize-artifact int8.npz] \\
        [--mesh-data 2 --mesh-model 2] [--device cpu]
"""

from __future__ import annotations

import math
import threading

import torch

from jointpose_torch.cli import add_device_flag, apply_device
from jointpose_torch.configs import Config
from jointpose_torch.graphs import Graph, GraphPool
from jointpose_torch.metrics import span
from jointpose_torch.models.detector import spatial_features
from jointpose_torch.models.pose import PoseModel, make_logits_tail_fn, unit_images
from jointpose_torch.ops.heatmaps import decode_probs, model_probs
from jointpose_torch.parallel.spatial import DeviceRows
from jointpose_torch.perf import counting


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jointpose_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions of its kernels"
        )
    return device


def build_predictor(config: Config, state_dict: dict, device: str | torch.device | None = None,
                    mesh=None, spatial: bool = False):
    """Return fn: images (B, H, W, 3) -> (coords (B, K, 2), probs (B, Hm, Wm, K)).

    ``images`` are uint8 RGB or float in [0, 1], on any device; they are
    moved to the predictor's device.  Coordinates are image pixels (x, y).
    With ``config.eval_flip_tta`` the heatmaps are averaged with those of
    the mirrored images.

    With ``mesh`` (a ``parallel.mesh.DeviceMesh``) the batch splits over
    its 'data' axis, which must divide it, and with ``spatial`` (and a
    'model' axis larger than 1) each data row's trunk splits the image rows
    over the row's devices (``DeviceMeshModel``); the results land on the
    mesh's first device.
    """
    if mesh is not None:
        return predictor_for(config, DeviceMeshModel(config, state_dict, mesh, spatial),
                             mesh.devices[0])
    device = resolve_device(device)
    model = PoseModel(config)
    model.load_state_dict(state_dict)
    return predictor_for(config, model.to(device).eval(), device)


class DeviceMeshModel:
    """``PoseModel``'s forward over a ``DeviceMesh`` in one process:
    images -> the output dict, on the mesh's first device.

    Data row d of the mesh takes rows [d B/D, (d+1) B/D) of the batch.  With
    ``spatial`` and a 'model' axis larger than 1 its trunk runs on the
    row's devices, each on a slice of the image rows with halos copied
    from its neighbours (``models.detector.spatial_features``); the head
    and the MRF run on the row's first device.  Without ``spatial`` the
    whole model runs on the row's first device.  Each distinct device
    holds one copy of the weights."""

    def __init__(self, config: Config, state_dict: dict, mesh, spatial: bool = False):
        for device in mesh.devices:
            resolve_device(device)
        self.mesh = mesh
        self.spatial = spatial and mesh.shape["model"] > 1
        self.models: dict[torch.device, PoseModel] = {}
        for device in dict.fromkeys(mesh.devices):
            model = PoseModel(config)
            model.load_state_dict(state_dict)
            self.models[device] = model.to(device).eval()
        self.tails = {d: make_logits_tail_fn(config, m) for d, m in self.models.items()}

    def __call__(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        n_data = self.mesh.shape["data"]
        if images.shape[0] % n_data:
            raise ValueError(f"batch {images.shape[0]} does not divide over the mesh data axis "
                             f"({n_data})")
        rows = images.shape[0] // n_data
        outs = []
        for d in range(n_data):
            row = self.mesh.row(d)
            chunk = images[d * rows:(d + 1) * rows].to(row[0])
            if self.spatial:
                det = [self.models[dev].detector for dev in row]
                x = det[0].normalized(unit_images(chunk, det[0].dtype))
                out = self.tails[row[0]](det[0].head(spatial_features(det, x, DeviceRows(row))))
            else:
                out = self.models[row[0]](chunk)
            outs.append(out)
        first = self.mesh.devices[0]
        return {k: torch.cat([o[k].to(first) for o in outs]) for k in outs[0]}


def predictor_for(config: Config, model: torch.nn.Module, device: torch.device):
    """``build_predictor``'s fn around a model already on ``device`` (a
    ``PoseModel``, or the int8 model of ``ops/quant.py``).

    Where ``graph_predictor`` holds, a call is a replay of a CUDA graph of
    the whole eager call (``PredictorGraphs``); the returned tensors are
    the caller's either way.  The function's ``graphs`` attribute is that
    ``PredictorGraphs``: its ``captures`` and ``replays`` count how often
    the graphs engaged (both 0 where the call stays eager)."""
    from jointpose_torch.evaluate import flip_images, unflip_heatmaps

    stride = config.data.heatmap_stride

    def forward(images: torch.Tensor):
        with span("input"):
            images = images.to(device)
        out = model(images)
        flipped = model(flip_images(images)) if config.eval_flip_tta else None
        with span("decode"):
            probs = model_probs(out)
            if flipped is not None:
                probs = 0.5 * (probs + unflip_heatmaps(model_probs(flipped)))
            coords = decode_probs(probs, stride, refine=config.decode_refine)
        return coords, probs

    graphs = PredictorGraphs(forward, model, device)

    @torch.inference_mode()
    def predict(images: torch.Tensor):
        return graphs(images)

    predict.graphs = graphs
    return predict


def graph_predictor(device: torch.device, model) -> bool:
    """Whether ``predictor_for``'s calls may replay CUDA graphs, by rule:
    on CUDA, for a ``PoseModel`` of one device (no mesh: its collectives
    run on the host).  ``DeviceMeshModel``'s forward crosses devices; the
    int8 model of ``ops/quant.py`` stays eager too.  A call also stays
    eager while a capture is underway on the caller's stream (the call is
    then part of the caller's graph) and while ``perf.count_cost`` counts
    (it counts the ops dispatched, which a replay hides)."""
    return device.type == "cuda" and isinstance(model, PoseModel) and model.mesh is None


def _graph_anchors(model: torch.nn.Module) -> list[int]:
    """Where the tensors live that a captured call reads in place: the
    model's parameters and buffers."""
    return [t.data_ptr() for t in (*model.parameters(), *model.buffers())]


class PredictorGraphs:
    """The graph form of the predictor's call: one CUDA graph
    (``graphs.Graph``) per input key (shape, dtype), each reading a static
    input buffer; all of a predictor's graphs share one
    ``graphs.GraphPool``.

    - A key's first call on a thread runs eagerly on the capture stream
      (``GraphPool.warm``): it builds the kernels, and creates the
      thread's cuDNN and cuBLAS handles and their workspaces for that
      stream (a capture cannot allocate them: a service warms its keys on
      one thread and captures on its dispatcher's).  The key's next call
      captures (``captures``) and replays the graph; later calls, on any
      thread, replay it (``replays``).  A capture that fails raises:
      nothing falls back to eager in silence.
    - A replay copies the caller's images into the key's static buffer
      (span ``input``; synchronous from host memory, as ``images.to``),
      then launches the graph and clones its coordinates and heatmaps on
      the same stream (span ``replay``), so that a caller keeps each
      call's answers while it makes the next.
    - The graphs read the model's parameters in place: when one of them,
      or a buffer, moves to other storage, the graphs are dropped and each
      key starts again from an eager call.
    - Where ``graph_predictor`` does not hold, or a capture is underway on
      the current stream, or a cost count is running, the call is the
      eager ``forward`` as it stands.
    """

    def __init__(self, forward, model: torch.nn.Module, device: torch.device):
        self.forward = forward  # images -> (coords, probs), eagerly
        self.model = model
        self.device = device
        self.enabled = graph_predictor(device, model)
        self.graphs: dict = {}  # key -> (graph, static images)
        self.warm: set = set()
        self.anchors: list[int] | None = None
        self.pool = GraphPool()
        self.captures = 0
        self.replays = 0

    def __call__(self, images: torch.Tensor):
        if not self.enabled or torch.cuda.is_current_stream_capturing() or counting():
            return self.forward(images)
        key = (tuple(images.shape), images.dtype)
        warm = (key, threading.get_ident())
        with torch.cuda.device(self.device):
            anchors = _graph_anchors(self.model)
            if anchors != self.anchors:
                self.release()
                self.anchors = anchors
            entry = self.graphs.get(key)
            if entry is None and warm not in self.warm:
                out = self.pool.warm(lambda: self.forward(images))
                self.warm.add(warm)
                return out
            if entry is None:
                static = torch.empty(images.shape, dtype=images.dtype, device=self.device)
                entry = self.graphs[key] = (Graph(self.pool, lambda: self.forward(static)),
                                            static)
                self.captures += 1
            else:
                self.replays += 1
            graph, static = entry
            with span("input"):
                static.copy_(images)
            with span("replay"):
                graph.replay()
                coords, probs = graph.out
                return coords.clone(), probs.clone()

    def release(self) -> None:
        """Drop the graphs, their pool and the warm keys of every thread."""
        self.graphs.clear()
        self.warm.clear()
        self.anchors = None
        self.pool.release()


def init_state_dict(config: Config, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Seeded random weights for ``config``, on the CPU.

    Conv kernels are N(0, 1/fan_in) (LeCun normal, the reference's conv
    default up to truncation), biases zero; the spatial model starts at
    its uniform-kernel init, as the reference's does.
    """
    out: dict[str, torch.Tensor] = {}
    for name, param in PoseModel(config).named_parameters():
        if name.startswith("spatial_model."):
            out[name] = param.detach().clone()
        elif name.endswith(".weight"):
            fan_in = math.prod(param.shape[1:])
            out[name] = torch.randn(param.shape, generator=generator) / math.sqrt(fan_in)
        else:
            out[name] = torch.zeros(param.shape)
    return out


def restore_params(
    config: Config, checkpoint_dir: str, step: int | None = None, best: bool = False
) -> tuple[dict[str, torch.Tensor], int]:
    """The model's ``state_dict`` (on the CPU) from a checkpoint directory
    that ``train.fit`` wrote, and its step.  ``best=True`` picks the
    checkpoint kept for the highest PDJ; otherwise the given ``step`` or
    the latest.  The weights alone are read, so inference does not depend
    on the saving run's optimizer; they are checked against the shapes of
    ``config`` as the checkpoint's recorded run config resolves it."""
    from jointpose_torch.checkpoint import Checkpointer, reconcile_config

    ckpt = Checkpointer(checkpoint_dir, keep=1)
    if best and step is None:
        step = ckpt.best_step()
        if step is None:
            raise FileNotFoundError(
                f"no best checkpoint recorded under {checkpoint_dir} (the run ended before "
                "its first full-model eval); pass an explicit step or best=False for the latest"
            )
    if step is None:
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    state_dict = ckpt.restore_subtree(("model",), step=step)["model"]
    template = PoseModel(reconcile_config(config, checkpoint_dir)).state_dict()
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    want = {k: tuple(v.shape) for k, v in template.items()}
    if got != want:
        raise ValueError(
            f"checkpoint {checkpoint_dir} step {step} does not fit config {config.name!r}: "
            f"{sorted(set(got.items()) ^ set(want.items()))}"
        )
    return state_dict, int(step)


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json
    import os

    import numpy as np

    parser = argparse.ArgumentParser(description="jointpose_torch batch inference")
    parser.add_argument("--config", default="flagship")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    parser.add_argument("--best", action="store_true", help="use the keep-best-by-PDJ checkpoint")
    parser.add_argument("--split", choices=["train", "test"], default="test")
    parser.add_argument("--num", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--figures", action="store_true",
                        help="write heatmap overlays of the first batch to predictions.png")
    parser.add_argument("--pool-mode", choices=["max", "stride"], default=None,
                        help="override the trunk downsampling mode (normally adopted from the "
                             "checkpoint's metadata)")
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="data-parallel inference over this many devices (0 = one device; "
                             "must divide the batch size)")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="model-axis devices: split the detector trunk's image rows over "
                             "them (halos copied between devices); composes with --mesh-data")
    parser.add_argument("--mrf-precision", choices=["high", "default"], default="default",
                        help="MRF message-pass matmul precision; inference defaults to "
                             "'default' (on the card one TF32 pass in the Fourier paths)")
    parser.add_argument("--pipeline", type=int, default=0, metavar="N_MICRO",
                        help="two-stage pipelined inference (detector | MRF + decode), "
                             "microbatched N_MICRO ways over the cards, or over the one card "
                             "on two streams (parallel/pipeline.py); composes with --quantize*")
    parser.add_argument("--quantize", type=int, default=0, metavar="N_CALIB",
                        help="run the int8-quantized detector (ops/quant.py), calibrating on "
                             "N_CALIB training images")
    parser.add_argument("--quantize-artifact", default=None, metavar="NPZ",
                        help="load a prebuilt int8 artifact (python -m jointpose_torch.quantize) "
                             "instead of calibrating")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    on_mesh = args.mesh_data > 1 or args.mesh_model > 1
    if on_mesh:
        if args.batch_size % max(args.mesh_data, 1):
            raise SystemExit(f"--mesh-data {args.mesh_data} must divide --batch-size "
                             f"{args.batch_size}")
        if args.pipeline > 0:
            raise SystemExit("--pipeline is exclusive with --mesh-data/--mesh-model")
        if args.quantize > 0 or args.quantize_artifact:
            raise SystemExit("--quantize is exclusive with --mesh-data/--mesh-model")
    if args.pipeline > 0 and args.batch_size % args.pipeline:
        raise SystemExit(f"--pipeline {args.pipeline} must divide --batch-size {args.batch_size}")

    from jointpose_torch import skeleton
    from jointpose_torch.checkpoint import reconcile_config
    from jointpose_torch.configs import get_config, with_mrf_precision
    from jointpose_torch.data.pipeline import make_dataset

    device = apply_device(args.device)
    config = reconcile_config(get_config(args.config), args.checkpoint, args.pool_mode)
    config = with_mrf_precision(config, args.mrf_precision)
    state_dict, step = restore_params(config, args.checkpoint, args.step, best=args.best)
    train_ds, test_ds = make_dataset(config.data, device)
    ds = train_ds if args.split == "train" else test_ds
    if args.pipeline > 0:
        from jointpose_torch.parallel.pipeline import build_pipelined_predictor

        # --quantize*: the int8 detector in stage 0.
        qparams = None
        if args.quantize > 0 or args.quantize_artifact:
            from jointpose_torch.ops.quant import quantized_model_for

            model, line = quantized_model_for(config, state_dict, args.quantize,
                                              args.quantize_artifact, train_ds, device)
            qparams = model.qparams()
            print(line)
        predict = build_pipelined_predictor(
            config, state_dict, devices=[device, device] if device.type == "cpu" else None,
            n_micro=args.pipeline, qparams=qparams)
    elif args.quantize > 0 or args.quantize_artifact:
        from jointpose_torch.ops.quant import quantized_model_for

        model, line = quantized_model_for(config, state_dict, args.quantize,
                                          args.quantize_artifact, train_ds, device)
        predict = predictor_for(config, model, device)
        print(line)
    elif on_mesh:
        from jointpose_torch.parallel.mesh import make_device_mesh

        mesh = make_device_mesh(max(args.mesh_data, 1), args.mesh_model, device)
        print(f"inference over {mesh}")
        predict = build_predictor(config, state_dict, mesh=mesh, spatial=args.mesh_model > 1)
    else:
        predict = build_predictor(config, state_dict, device)

    os.makedirs(args.workdir, exist_ok=True)
    out_path = os.path.join(args.workdir, "predictions.jsonl")
    n = min(args.num, ds.size)
    bs = args.batch_size
    with open(out_path, "w") as f:
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n), dtype=np.int32)
            # The last batch is padded by repeating its last example, so the
            # predictor only ever sees the one batch shape.
            batch = ds.get_batch(np.pad(idx, (0, bs - len(idx)), mode="edge"))
            coords, probs = predict(batch["image"])
            coords_np = coords.cpu().numpy()[: len(idx)]
            for row, ex in zip(coords_np, idx.tolist()):
                f.write(json.dumps({
                    "example": int(ex),
                    "split": args.split,
                    "joints": {name: [float(row[j, 0]), float(row[j, 1])]
                               for j, name in enumerate(skeleton.JOINTS)},
                }) + "\n")
            if args.figures and start == 0:
                from jointpose_torch.visualize import save_heatmap_overlays

                save_heatmap_overlays(
                    batch["image"].cpu().numpy()[: len(idx)], probs.cpu().numpy()[: len(idx)],
                    os.path.join(args.workdir, "predictions.png"), coords_np,
                )
    print(f"wrote {n} predictions (checkpoint step {step}) to {out_path}")


if __name__ == "__main__":
    main()
