"""Peaks of the card, the cost of a step, and the roofline built on them
(counterpart of ``jointpose/perf.py``).

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; a card set below it runs slower
under load).  ``chip_smoke.py``'s kernel bounds, ``step_cost`` and
``roofline_images_per_sec`` all read them from here.

``step_cost(fn, *args)`` counts one real call of ``fn``: PyTorch has no
compiled program whose cost analysis could be asked, as XLA's is.  It
runs ``fn`` under a dispatch mode and adds up

- FLOPs: ``torch.utils.flop_counter``'s per-op formulas (matrix products,
  convolutions and their backward, attention), as ``FlopCounterMode``
  counts them;
- bytes: the tensor operands plus the results of every aten op that is
  not a view, each once per op (the analogue of XLA's "bytes accessed");
- the port's own kernels: they run through ``ctypes`` inside
  ``torch.autograd.Function``s, out of every dispatch mode's sight, so
  each wrapper reports the bytes and operations of its function
  (``count_kernel``, with the cost formulas that sit beside it) when a
  count is active.

What the count leaves out: elementwise, reduction and normalization ops
add bytes but no FLOPs (the formulas cover only products); an op is
charged its operands and results whether or not they come from the L2
cache, and allocations (``empty``) and views are free; cuDNN's and
cuBLAS's own workspaces, re-reads and layout transforms are not seen;
host work (Python, launches, copies from pageable memory) is not a cost
here at all.  Kernel launches by other threads while a count is active
are counted too: the kernel hook is process-wide, so that the backward
pass, which autograd runs on a thread of its own on the card, is seen.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # CUDA cores, no tensor cores
BF16_FLOPS_PER_S = 989e12  # tensor cores, dense
TF32_FLOPS_PER_S = 495e12  # tensor cores, dense
INT8_OPS_PER_S = 1979e12  # tensor cores, dense


def nbytes(*tensors: torch.Tensor) -> int:
    """Bytes of the tensors' elements, each tensor once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, n_ops: float, peak: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time the card could take, in ms, and what binds it: the
    larger of ``n_bytes`` over the memory rate and ``n_ops`` over ``peak``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_ops_ms(n_ops: float, passes: int) -> float:
    """The least time, in ms, for ``n_ops`` products that must keep fp32's
    accuracy to within what ``passes`` TF32 passes give: on the tensor
    cores ``passes`` times over, or once on the CUDA cores, whichever is
    quicker (3xTF32 is admissible for fp32, one pass for MRF precision
    'default')."""
    return min(n_ops / FP32_FLOPS_PER_S, passes * n_ops / TF32_FLOPS_PER_S) * 1e3


def roofline_images_per_sec(
    flops_per_image: float,
    bytes_per_image: float = 0.0,
    peak_flops: float = BF16_FLOPS_PER_S,
    mxu_util: float = 1.0,
    hbm_eff: float = 1.0,
):
    """Images per second that the peaks allow: min(compute, memory) roofline.

    The reference's maths and signature.  With the defaults this is a
    bound, which no measurement on the card can exceed: the whole
    ``peak_flops`` and the raw memory rate.  (The reference's defaults of
    0.60 and 0.8 are fractions measured on a TPU v5e, no fact about this
    card.)  ``peak_flops`` must match the type the FLOPs were counted in;
    the bf16 tensor-core peak, the default, is the highest of the float
    types, so a count in any mix of them stays a bound under it.  None for
    a count of no FLOPs.
    """
    if flops_per_image <= 0:
        return None
    compute = peak_flops * mxu_util / flops_per_image
    if bytes_per_image > 0:
        return min(compute, HBM_BYTES_PER_S * hbm_eff / bytes_per_image)
    return compute


class Cost:
    """FLOPs and bytes counted so far, in all and by the port's kernels."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.kernels: dict[str, dict[str, int]] = defaultdict(
            lambda: {"launches": 0, "flops": 0, "bytes": 0})

    def as_dict(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes)}


_active: list[Cost] = []  # the counts open now; empty is the common case


def count_kernel(name: str, cost_fn: Callable[..., tuple[int, int]], *args) -> None:
    """A kernel wrapper's report of one launch: ``cost_fn(*args)`` gives the
    (bytes, operations) of its function.  Costs nothing but this test when
    no count is active, so it does not stand in the way of CUDA graphs."""
    if not _active:
        return
    n_bytes, n_ops = cost_fn(*args)
    for cost in _active:
        cost.flops += n_ops
        cost.bytes += n_bytes
        k = cost.kernels[name]
        k["launches"] += 1
        k["flops"] += n_ops
        k["bytes"] += n_bytes


_FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


class _ByteMode(TorchDispatchMode):
    """Charges every aten op that is not a view or an allocation its
    tensor operands (each read once) and its results (each written once):
    an in-place op reads and writes its target."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func._overloadpacket.__name__ not in _FREE_OPS:
            for tree in ((args, kwargs), out):  # read once, written once
                unique = {id(t): t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}
                self.cost.bytes += nbytes(*unique.values())
        return out


@contextlib.contextmanager
def count_cost():
    """Count what runs inside: yields a ``Cost`` that fills as ops run."""
    from torch.utils.flop_counter import FlopCounterMode

    cost = Cost()
    flops = FlopCounterMode(display=False)
    _active.append(cost)
    try:
        with flops, _ByteMode(cost):
            yield cost
    finally:
        _active.remove(cost)
        cost.flops += flops.get_total_flops()


def step_cost(fn: Callable, *args, **kwargs) -> dict:
    """{'flops', 'bytes'} of one real call ``fn(*args, **kwargs)`` (see the
    module docstring for what is counted).  The call runs: a caller that
    needs its result captures it inside ``fn``."""
    with count_cost() as cost:
        fn(*args, **kwargs)
    return cost.as_dict()
