"""Spatial parallelism: the detector trunk's image rows over 'model'
(counterpart of ``spatial_image_sharding`` and ``spatial_gather_sharding``
in ``jointpose/parallel/mesh.py``; here ``spatial_image_sharding`` and
``gather_rows``, functions that apply the layout to a tensor).

The reference annotates the trunk's activations with a row sharding and
lets XLA insert the halo exchanges that SAME convs need at the shard
edges, then gathers the rows before the head.  Here the exchanges are
written out:

- ``row_shard``: shard j of n holds rows [j H/n, (j+1) H/n) of a map of
  global height H.  The detector checks that H divides by n times its
  stride alignment, so every shard starts on an even row at every trunk
  level and the 2x2 pools, the average pyramid and the nearest upsample
  stay local.
- ``halo_rows``: the rows a conv reads beyond its shard, from the GLOBAL
  SAME padding (``ops/mrf_xla.same_pad``): a stride-s k-row conv whose
  padding is (top, bottom) reads ``top`` rows above the shard and
  ``k - s - top`` below, e.g. 1 above and 2 below for flagship's
  stride-2 5x5 convs on even rows, (k - 1)/2 each side at stride 1.
  The local height's own padding would zero-pad every shard edge and
  shift a stride-2 grid.  Zeros stand for rows beyond the image's top
  and bottom only.
- the exchange, by one of two row groups:
  - ``ProcessRows`` (one shard per process of a ``Mesh``, training and
    ``evaluate``): ``halo_exchange`` and ``gather_rows``, each a
    ``torch.autograd.Function`` built on ``Mesh.all_reduce`` over
    'model' of a zero buffer in which every rank fills its own slot.
    gloo takes CUDA tensors only in all-reduce and broadcast, and ranks
    sharing one card run on gloo; the buffer is fp32, and a sum of one
    value and zeros is that value, so the exchange moves no bits.  One
    path for nccl and gloo (a point-to-point form would move 1/n of the
    bytes);
  - ``DeviceRows`` (every shard in one process, one per device of a
    ``DeviceMesh`` row, inference): the halos and the gather are device
    copies.

The halo's backward is its adjoint: the gradient of each halo goes back to
the neighbour that sent the rows and is ADDED to its edge rows.  The
gather's backward takes this rank's rows of the incoming gradient and sums
nothing: after the gather every model rank holds the whole loss (the head
and the MRF run on the full map, ``parallel/mrf_tp.py``).  The trunk's
parameters see only a shard's rows, so the trainer sums their gradients
over 'model' (``models/pose.PoseModel.model_sliced_parameters``).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from jointpose_torch.ops.mrf_xla import same_pad
from jointpose_torch.parallel.mesh import MODEL_AXIS, Mesh


def row_shard(height: int, n: int, j: int) -> slice:
    """Rows of shard ``j`` of ``n`` of a map ``height`` rows tall."""
    if height % n:
        raise ValueError(f"{height} rows do not divide over {n} shards")
    rows = height // n
    return slice(j * rows, (j + 1) * rows)


def halo_rows(height: int, kernel: int, stride: int = 1) -> tuple[int, int]:
    """(above, below): the rows a SAME conv of ``kernel`` rows at
    ``stride`` reads beyond a shard of a map ``height`` rows tall (global),
    whose shards start on multiples of ``stride``."""
    top, _ = same_pad(height, kernel, stride)
    return top, kernel - stride - top


def _check_depth(rows: int, above: int, below: int) -> None:
    if above > rows or below > rows:
        raise ValueError(
            f"a halo of {above} row(s) above and {below} below is deeper than a shard's {rows} "
            "rows: use fewer shards over 'model' or taller images")


def _slots(x: torch.Tensor, n: int, depth: int) -> torch.Tensor:
    """A zero fp32 exchange buffer of ``n`` slots of ``depth`` rows of ``x``."""
    b, c, _, w = x.shape
    return torch.zeros((n, b, c, depth, w), dtype=torch.float32, device=x.device)


class _HaloExchange(torch.autograd.Function):
    """(B, C, h, W) rows of this rank -> (B, C, above + h + below, W), the
    neighbours' edge rows around them (zeros beyond the image)."""

    @staticmethod
    def forward(ctx, x, mesh, above, below):
        n, m, h = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS], x.shape[2]
        ctx.mesh, ctx.above, ctx.below, ctx.h = mesh, above, below, h
        # Slot m: this rank's first `below` rows (the bottom halo of rank
        # m - 1), then its last `above` rows (the top halo of rank m + 1).
        buf = _slots(x, n, below + above)
        buf[m, :, :, :below] = x[:, :, :below]
        buf[m, :, :, below:] = x[:, :, h - above:]
        mesh.all_reduce(buf, MODEL_AXIS)
        b, c, _, w = x.shape
        top = buf[m - 1, :, :, below:] if m > 0 else x.new_zeros((b, c, above, w))
        bottom = buf[m + 1, :, :, :below] if m < n - 1 else x.new_zeros((b, c, below, w))
        return torch.cat([top.to(x.dtype), x, bottom.to(x.dtype)], dim=2)

    @staticmethod
    def backward(ctx, g):
        mesh, above, below, h = ctx.mesh, ctx.above, ctx.below, ctx.h
        n, m = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]
        # Slot m: the gradient of the bottom halo (rows of rank m + 1), then
        # that of the top halo (rows of rank m - 1).
        buf = _slots(g, n, below + above)
        buf[m, :, :, :below] = g[:, :, above + h:]
        buf[m, :, :, below:] = g[:, :, :above]
        mesh.all_reduce(buf, MODEL_AXIS)
        dx = g[:, :, above:above + h].float().clone()
        if m > 0:
            dx[:, :, :below] += buf[m - 1, :, :, :below]
        if m < n - 1:
            dx[:, :, h - above:] += buf[m + 1, :, :, below:]
        return dx.to(g.dtype), None, None, None


class _GatherRows(torch.autograd.Function):
    """(B, C, h, W) rows of this rank -> (B, C, n h, W) on every model rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        n, m = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]
        ctx.rows = row_shard(n * x.shape[2], n, m)
        buf = torch.zeros((n, *x.shape), dtype=torch.float32, device=x.device)
        buf[m] = x
        mesh.all_reduce(buf, MODEL_AXIS)
        b, c, h, w = x.shape
        return buf.permute(1, 2, 0, 3, 4).reshape(b, c, n * h, w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        # Every model rank holds the whole loss: no sum over 'model'.
        return g[:, :, ctx.rows].contiguous(), None


def halo_exchange(x: torch.Tensor, mesh: Mesh, above: int, below: int) -> torch.Tensor:
    """This rank's rows ``x`` (NCHW) with ``above`` rows of the previous
    model rank and ``below`` of the next around them; the backward adds
    each halo's gradient into the neighbour's edge rows."""
    _check_depth(x.shape[2], above, below)
    return _HaloExchange.apply(x, mesh, above, below)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full-height map of every model rank's rows ``x`` (NCHW); the
    backward passes this rank's rows of the gradient on."""
    return _GatherRows.apply(x, mesh)


def spatial_image_sharding(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's rows of the full-height NCHW map ``x``."""
    return x[:, :, row_shard(x.shape[2], mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS])]



class ProcessRows:
    """The rows of one process of ``mesh``'s 'model' axis: one local shard,
    exchanged by collectives.  ``split`` raises where this rank has no
    process group over 'model' to exchange with."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.shape[MODEL_AXIS]

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        if self.n > 1 and not self.mesh.has_group(MODEL_AXIS):
            raise RuntimeError(
                f"{self.mesh!r} has no process group over 'model': spatial parallelism exchanges "
                "rows between the processes of make_mesh (python -m torch.distributed.run)")
        return [spatial_image_sharding(x, self.mesh)]

    def halo(self, shards: list[torch.Tensor], above: int, below: int) -> list[torch.Tensor]:
        return [halo_exchange(shards[0], self.mesh, above, below)]

    def gather(self, shards: list[torch.Tensor]) -> torch.Tensor:
        return gather_rows(shards[0], self.mesh)


class DeviceRows:
    """The rows of one process's devices (one shard each, a device may
    repeat): halos and the gather are copies; the gather lands on the
    first device."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = x.shape[2]
        return [x[:, :, row_shard(h, self.n, j)].to(d) for j, d in enumerate(self.devices)]

    def halo(self, shards: list[torch.Tensor], above: int, below: int) -> list[torch.Tensor]:
        out = []
        for j, x in enumerate(shards):
            b, c, h, w = x.shape
            _check_depth(h, above, below)
            prev = shards[j - 1] if j > 0 else None
            top = (prev[:, :, prev.shape[2] - above:].to(x.device) if prev is not None
                   else x.new_zeros((b, c, above, w)))
            bottom = (shards[j + 1][:, :, :below].to(x.device) if j < self.n - 1
                      else x.new_zeros((b, c, below, w)))
            out.append(torch.cat([top, x, bottom], dim=2))
        return out

    def gather(self, shards: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat([s.to(self.devices[0]) for s in shards], dim=2)
