"""Weights from the reference: a flax params tree -> a torch ``state_dict``.

The tree holds numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``
on the JAX side), with or without the top-level ``"params"`` key.  Conv
kernels go from HWIO to OIHW and are renamed ``weight``; biases and the
spatial model's ``raw_kernels`` (wh, ww, K, K) and ``raw_bias`` (K, K)
pass through.  Module paths keep their names: ``detector/trunk/conv0``
becomes ``detector.trunk.conv0``.  ``write_initial_checkpoint`` turns such
a ``state_dict`` into a checkpoint that ``train.fit`` resumes from.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{prefix}kernel: expected HWIO, got shape {arr.shape}")
                out[f"{prefix}weight"] = torch.from_numpy(arr.transpose(3, 2, 0, 1).copy())
            else:
                out[f"{prefix}{name}"] = torch.from_numpy(arr.copy())

    walk(tree, "")
    return out


def write_initial_checkpoint(config, checkpoint_dir: str, state_dict: dict[str, torch.Tensor]) -> None:
    """Write a step-0 checkpoint of the port holding ``state_dict`` (e.g.
    ``params_from_flax`` of the reference's initial parameters) with a
    fresh optimizer, so that ``train.fit(config, workdir, resume=True)``
    starts from those weights.  ``checkpoint_dir`` is
    ``<workdir>/<config.train.checkpoint_dir>``."""
    from jointpose_torch.checkpoint import Checkpointer
    from jointpose_torch.train import create_state

    state = create_state(config, torch.Generator().manual_seed(config.train.seed), device="cpu")
    state.model.load_state_dict(state_dict)
    Checkpointer(checkpoint_dir, keep=config.train.keep_checkpoints, config=config).save(0, state)
