"""Numerics sanitizers (counterpart of ``jointpose/debug.py``).

- ``checked_apply`` runs a model or a function and records the first
  place a NaN or an Inf came out: for an ``nn.Module``, forward hooks on
  every submodule name the first module (in the order they finish) whose
  output is not finite; the call's own outputs are checked too.  It
  returns (error, output), and ``error.throw()`` raises on what was
  recorded, as the reference's checkify error does.
- ``assert_finite_tree`` checks every tensor, array and float of a nested
  structure (dicts, lists, tuples, ``state_dict``\\ s) on the host.
- ``python -m jointpose_torch.train --check-numerics`` turns on
  ``torch.autograd.set_detect_anomaly``, which fails at the backward op
  that made a NaN.

The checks cost one reduction per checked tensor on its device and one
copy to the host at the end of the call.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_flatten_with_path, tree_leaves


class NumericsError:
    """What ``checked_apply`` found: ``get()`` is the message or None,
    ``throw()`` raises ``FloatingPointError`` with it."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def _not_finite(tree) -> torch.Tensor | None:
    """A 0-d bool on the tensors' device: some floating value of ``tree``
    is NaN or Inf (None: no floating tensor in it)."""
    flags = [~torch.isfinite(t).all() for t in tree_leaves(tree)
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    return torch.stack([f.to(flags[0].device) for f in flags]).any() if flags else None


def checked_apply(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` -> (error, output); ``error.throw()``
    raises on the first non-finite value recorded (see the module
    docstring)."""
    found: list[tuple[str, torch.Tensor]] = []
    handles = []
    if isinstance(fn, torch.nn.Module):
        for name, module in fn.named_modules():
            def hook(module, inputs, output, name=name or type(fn).__name__):
                flag = _not_finite(output)
                if flag is not None:
                    found.append((f"module {name!r} ({type(module).__name__})", flag))

            handles.append(module.register_forward_hook(hook))
    try:
        output = fn(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    flag = _not_finite(output)
    if flag is not None:
        found.append((f"the output of {getattr(fn, '__name__', type(fn).__name__)}", flag))
    if not found:
        return NumericsError(), output
    hits = torch.stack([f.cpu() for _, f in found]).tolist()
    where = next((what for (what, _), hit in zip(found, hits) if hit), None)
    return NumericsError(None if where is None else f"non-finite values in {where}"), output


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side finiteness check of every tensor in ``tree``; the error
    names the first offending leaf by its path, ``a/b/c``."""
    for path, leaf in tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, (np.ndarray, np.floating, float)):
            leaf = torch.as_tensor(leaf)
        if isinstance(leaf, torch.Tensor) and not torch.isfinite(leaf.detach()).all():
            keys = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            raise AssertionError(f"non-finite values in {name}:{keys}")
