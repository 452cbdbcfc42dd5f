"""Weights from the reference: a flax params tree -> a torch ``state_dict``.

The tree holds numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``
on the JAX side), with or without the top-level ``"params"`` key.  Conv
kernels go from HWIO to OIHW and are renamed ``weight``; biases and the
spatial model's ``raw_kernels`` (wh, ww, K, K) and ``raw_bias`` (K, K)
pass through.  Module paths keep their names: ``detector/trunk/conv0``
becomes ``detector.trunk.conv0``.
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
