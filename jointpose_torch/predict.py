"""Batch inference (counterpart of ``jointpose/predict.py``, one device):
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
of ``ops/quant.py``:

    python -m jointpose_torch.predict --config flagship \\
        --checkpoint runs/flagship/checkpoints --workdir out/ \\
        [--split test] [--num 64] [--figures] [--quantize-artifact int8.npz] [--device cpu]
"""

from __future__ import annotations

import math

import torch

from jointpose_torch.cli import add_device_flag, apply_device
from jointpose_torch.configs import Config
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.ops.heatmaps import decode_probs, model_probs


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


def build_predictor(config: Config, state_dict: dict, device: str | torch.device | None = None):
    """Return fn: images (B, H, W, 3) -> (coords (B, K, 2), probs (B, Hm, Wm, K)).

    ``images`` are uint8 RGB or float in [0, 1], on any device; they are
    moved to the predictor's device.  Coordinates are image pixels (x, y).
    With ``config.eval_flip_tta`` the heatmaps are averaged with those of
    the mirrored images.
    """
    device = resolve_device(device)
    model = PoseModel(config)
    model.load_state_dict(state_dict)
    return predictor_for(config, model.to(device).eval(), device)


def predictor_for(config: Config, model: torch.nn.Module, device: torch.device):
    """``build_predictor``'s fn around a model already on ``device`` (a
    ``PoseModel``, or the int8 model of ``ops/quant.py``)."""
    from jointpose_torch.evaluate import flip_images, unflip_heatmaps

    stride = config.data.heatmap_stride

    @torch.inference_mode()
    def predict(images: torch.Tensor):
        images = images.to(device)
        probs = model_probs(model(images))
        if config.eval_flip_tta:
            probs = 0.5 * (probs + unflip_heatmaps(model_probs(model(flip_images(images)))))
        coords = decode_probs(probs, stride, refine=config.decode_refine)
        return coords, probs

    return predict


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


def refuse_unported(flags: list[tuple[str, bool]]) -> None:
    """Raise ``NotImplementedError`` naming every flag that is set and not
    ported yet (meshes of more than one device, pipelines)."""
    unported = [flag for flag, on in flags if on]
    if unported:
        raise NotImplementedError(f"{', '.join(unported)}: not ported yet; see ROADMAP.md")


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
                        help="data-parallel devices; -1, 0 and 1 mean the one device, larger "
                             "meshes are not ported yet (ROADMAP.md)")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="model-axis devices; only 1 (ROADMAP.md)")
    parser.add_argument("--mrf-precision", choices=["high", "default"], default="default",
                        help="MRF message-pass matmul precision; inference defaults to "
                             "'default' (on the card one TF32 pass in the Fourier paths)")
    parser.add_argument("--pipeline", type=int, default=0, metavar="N_MICRO",
                        help="pipeline-parallel inference: not ported yet (ROADMAP.md)")
    parser.add_argument("--quantize", type=int, default=0, metavar="N_CALIB",
                        help="run the int8-quantized detector (ops/quant.py), calibrating on "
                             "N_CALIB training images")
    parser.add_argument("--quantize-artifact", default=None, metavar="NPZ",
                        help="load a prebuilt int8 artifact (python -m jointpose_torch.quantize) "
                             "instead of calibrating")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    refuse_unported([("--mesh-data", args.mesh_data > 1), ("--mesh-model", args.mesh_model > 1),
                     ("--pipeline", args.pipeline > 0)])

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
    if args.quantize > 0 or args.quantize_artifact:
        from jointpose_torch.ops.quant import quantized_model_for

        model, line = quantized_model_for(config, state_dict, args.quantize,
                                          args.quantize_artifact, train_ds, device)
        predict = predictor_for(config, model, device)
        print(line)
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
