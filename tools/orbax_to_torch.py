#!/usr/bin/env python3
"""Bring a checkpoint of the JAX package (orbax) into the PyTorch port.

    python tools/orbax_to_torch.py --src runs/flagship/checkpoints \\
        --out runs/flagship_torch/checkpoints [--config flagship] [--step N | --best] \\
        [--platform cpu]

Reads a directory that ``jointpose.checkpoint.Checkpointer`` wrote, in the
``latest/`` + ``best/`` layout or the legacy layout of step directories at
its root, through the reference's ``predict.restore_params`` (the latest
step, ``--step N`` or ``--best``); converts the parameters with
``jointpose_torch.convert.params_from_flax``; and writes a step-0
checkpoint of the port with ``convert.write_initial_checkpoint``: the
weights and a fresh optimizer.  The port's ``predict.restore_params``,
``evaluate``, ``serve`` and ``predict`` read it, and ``train --resume``
trains on from those weights (the optimizer's moments are not carried).

The config is the preset ``--config`` names, by default the one the
source's ``run_config.json`` records, with the source's recorded
``pool_mode`` and ``head_conv_impl_resolved`` applied on both sides
(``reconcile_config``), so the port's ``run_config.json`` records the same
modes.  The tool imports JAX and orbax: it runs where they are installed,
and nothing of the port imports it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> int:
    from jointpose.cli import add_platform_flag, apply_platform

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", required=True, help="the JAX package's checkpoint directory")
    parser.add_argument("--out", required=True,
                        help="the port's checkpoint directory to write (<workdir>/checkpoints)")
    parser.add_argument("--config", default=None,
                        help="preset name (default: the one the source records)")
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--step", type=int, default=None, help="convert this step (default: latest)")
    which.add_argument("--best", action="store_true", help="convert the kept-best checkpoint")
    add_platform_flag(parser)
    args = parser.parse_args(argv)
    apply_platform(args.platform)

    import jax

    from jointpose.checkpoint import load_run_metadata
    from jointpose.checkpoint import reconcile_config as reconcile_reference
    from jointpose.configs import get_config as reference_config
    from jointpose.predict import restore_params
    from jointpose_torch.checkpoint import Checkpointer, reconcile_config
    from jointpose_torch.configs import get_config
    from jointpose_torch.convert import params_from_flax, write_initial_checkpoint

    name = args.config or (load_run_metadata(args.src) or {}).get("config_name")
    if name is None:
        parser.error(f"{args.src} records no config name: pass --config")
    if Checkpointer(args.out).latest_step() is not None:
        parser.error(f"{args.out} already holds checkpoints of the port")
    variables, step = restore_params(reconcile_reference(reference_config(name), args.src),
                                     args.src, step=args.step, best=args.best)
    config = reconcile_config(get_config(name), args.src)
    write_initial_checkpoint(
        config, args.out, params_from_flax(jax.tree_util.tree_map(np.asarray, variables["params"])))
    print(f"converted step {step} of {args.src} ({name}, pool_mode {config.detector.pool_mode!r}, "
          f"head_conv_impl {config.detector.head_conv_impl!r}) into {args.out} as step 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
