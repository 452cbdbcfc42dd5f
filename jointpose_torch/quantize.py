"""Offline quantization (counterpart of ``jointpose/quantize.py``):
checkpoint -> int8 deployment artifact.

Runs the calibration of ``ops/quant.py`` against a trained checkpoint on
the train split's first ``--calib`` images and writes the int8 detector
(npz: int8 weights, per-channel weight scales, static activation scales,
fp32 biases), which ``predict``, ``evaluate`` and ``serve`` load with
``--quantize-artifact`` and the reference's ``load_quantized`` reads too.

    python -m jointpose_torch.quantize --config flagship \\
        --checkpoint runs/flagship/checkpoints --best --calib 256 \\
        --out runs/flagship/int8.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from jointpose_torch.cli import add_device_flag, apply_device


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="jointpose_torch int8 quantization")
    parser.add_argument("--config", default="flagship")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--best", action="store_true")
    parser.add_argument("--calib", type=int, default=256,
                        help="number of training images for activation-scale calibration")
    parser.add_argument("--out", required=True, help="artifact path (.npz)")
    parser.add_argument("--pool-mode", choices=["max", "stride"], default=None)
    add_device_flag(parser, help="'cpu' calibrates there; default: the CUDA device")
    args = parser.parse_args(argv)

    from jointpose_torch.checkpoint import reconcile_config
    from jointpose_torch.configs import get_config
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.ops.quant import quantize_detector, save_quantized
    from jointpose_torch.predict import restore_params

    device = apply_device(args.device)
    config = reconcile_config(get_config(args.config), args.checkpoint, args.pool_mode)
    state_dict, step = restore_params(config, args.checkpoint, args.step, best=args.best)
    train_ds, _ = make_dataset(config.data, device)
    calib = train_ds.get_batch(np.arange(min(args.calib, train_ds.size)))["image"]
    qparams = quantize_detector(config, state_dict, calib, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_quantized(args.out, qparams)

    n_int8 = sum(node["w_q"].numel() for node in qparams.values())
    size_mb = os.path.getsize(args.out) / 1e6
    print(
        f"quantized {len(qparams)} convs ({n_int8:,} int8 weights) from "
        f"checkpoint step {step}, calibrated on {calib.shape[0]} images "
        f"-> {args.out} ({size_mb:.2f} MB)"
    )


if __name__ == "__main__":
    main()
