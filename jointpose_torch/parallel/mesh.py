"""The process mesh, its collectives and the sharding rule (counterpart of
``jointpose/parallel/mesh.py``).

One process per device, PyTorch's idiom, where the reference's mesh spans
a process's local devices.  A run of N processes is launched as

    python -m torch.distributed.run --nproc-per-node N -m jointpose_torch.train \\
        --config flagship --workdir runs/f --mesh-data N

and ``init_distributed`` joins the process group from the variables that
launcher sets.  ``make_mesh`` lays a ('data', 'model') mesh over the
world, data-major as the reference's ``reshape(data, model)``: rank r sits
at data coordinate r // model and model coordinate r % model, and each
axis gets a process group of the ranks that differ only along it.

- ``data``: every rank takes its rows of the global batch
  (``shard_batch``); gradients and the loss's denominators are summed over
  the axis.
- ``model``: tensor parallelism.  The detector head's wide conv computes an
  OUTPUT-channel slice and the following 1x1 conv an INPUT-channel slice
  (``param_shardings``, the reference's rule and names), and the MRF
  message pass a slice of its source joints (``parallel/mrf_tp.py``).
  With ``MeshConfig.spatial`` the trunk also computes a slice of the
  image's rows (``parallel/spatial.py``).

Storage is replicated, compute is sliced: every rank keeps the whole
parameters and optimizer moments and computes only its slice, so
``shard_state`` is a broadcast from rank 0, the checkpoint layout is the
one-device layout, and a mesh run's checkpoint restores on one device and
the reverse.  A 1x1 mesh holds no process group and every collective on
it is the identity, so the one-device path is unchanged.

Inference in one process (``predict``, ``serve``) takes a ``DeviceMesh``
instead: a (data, model) grid of devices that one process drives, as the
pipelined predictor takes a device list.  The batch splits over 'data';
each data row's trunk splits its image rows over the row's devices; the
head, the MRF and the decode run on the row's first device.

The reference's sharding objects have no counterparts of their own:
PyTorch applies a layout to a tensor rather than annotating it.
``batch_sharding`` is what ``shard_batch`` applies, ``replicated`` what
``shard_params`` makes of the parameters (a broadcast from rank 0), and
``spatial_image_sharding`` and ``gather_rows`` (``spatial_gather_sharding``)
are functions of ``parallel/spatial.py`` that take this rank's rows and
gather them.
"""

from __future__ import annotations

import datetime
import os
from collections.abc import Mapping

import torch
import torch.distributed as dist

from jointpose_torch.configs import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape(cfg: MeshConfig, world: int) -> tuple[int, int]:
    """(data, model) of ``cfg`` over a world of ``world`` processes; a size
    of -1 or 0 means the rest of the world (1 on 'model').  The mesh must
    cover the world exactly: one process per device."""
    model = cfg.model if cfg.model > 0 else 1
    data = cfg.data if cfg.data > 0 else max(world // model, 1)
    if data * model != world:
        raise ValueError(
            f"mesh {data}x{model} does not cover the world of {world} process(es): one process "
            f"runs per device, so launch data x model processes (python -m torch.distributed.run "
            f"--nproc-per-node {data * model} ...) or pass a mesh of {world} devices"
        )
    return data, model


class Mesh:
    """A ('data', 'model') mesh over the process group's world.

    ``shape`` maps each axis to its size; ``coords`` this rank's position;
    ``backend`` the world group's backend (``'nccl'`` or ``'gloo'``), None
    for a world of one; ``all_reduce`` sums a tensor in place over one axis
    (or over the whole world with ``axis=None``) and is the identity where
    that size is 1.
    """

    def __init__(self, data: int, model: int, rank: int = 0, groups: Mapping | None = None,
                 backend: str | None = None):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.rank = rank
        self.coords = {DATA_AXIS: rank // model, MODEL_AXIS: rank % model}
        self._groups = dict(groups or {})
        self.backend = backend

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, rank={self.rank})"

    def has_group(self, axis: str | None) -> bool:
        """Whether this rank holds a process group over ``axis``."""
        return axis in self._groups

    def all_reduce(self, x: torch.Tensor, axis: str | None = None,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce contiguous ``x`` in place over ``axis`` (None: the world)."""
        n = self.size if axis is None else self.shape[axis]
        if n > 1:
            dist.all_reduce(x, op=op, group=self._groups[axis])
        return x

    def all_reduce_flat(self, tensors: list[torch.Tensor], axis: str | None = None) -> None:
        """Sum fp32 ``tensors`` over ``axis`` in place, as one collective."""
        n = self.size if axis is None else self.shape[axis]
        if n == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.all_reduce(flat, axis)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank of the world."""
        if self.size == 1:
            return flag
        device = torch.cuda.current_device() if self.backend == "nccl" else "cpu"
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        return bool(self.all_reduce(t, None, dist.ReduceOp.MAX).item())

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Overwrite ``x`` in place with the mesh's rank 0's."""
        if self.size > 1:
            group = self._groups[None]
            dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
        return x


def make_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """The ('data', 'model') mesh of ``cfg`` over the process group's world
    (a world of 1 without a process group).  Every rank must call it, in
    the same order as any other call that makes process groups."""
    cfg = cfg or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, model = mesh_shape(cfg, world)
    groups: dict = {}
    backend = None
    if world > 1:
        backend = dist.get_backend()
        groups[None] = dist.group.WORLD
        axes = {
            DATA_AXIS: [[d * model + m for d in range(data)] for m in range(model)],
            MODEL_AXIS: [[d * model + m for m in range(model)] for d in range(data)],
        }
        for axis, rank_sets in axes.items():
            if len(rank_sets[0]) == 1:
                continue
            for ranks in rank_sets:
                # new_group is collective: every rank makes every group.
                group = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    return Mesh(data, model, rank, groups, backend)


class DeviceMesh:
    """A ('data', 'model') grid of devices driven by one process: row d of
    the grid is ``row(d)``, data-major as ``make_mesh``.  A device may
    repeat (``[cuda:0] * 4`` on one card, ``["cpu"] * 4``)."""

    def __init__(self, devices, data: int, model: int):
        self.devices = [torch.device(d) for d in devices]
        if data < 1 or model < 1 or len(self.devices) != data * model:
            raise ValueError(f"a {data}x{model} device mesh needs {data * model} devices, "
                             f"got {len(self.devices)}")
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}

    def row(self, d: int) -> list[torch.device]:
        m = self.shape[MODEL_AXIS]
        return self.devices[d * m:(d + 1) * m]

    def __repr__(self) -> str:
        return (f"DeviceMesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"devices={[str(d) for d in self.devices]})")


def make_device_mesh(data: int, model: int, device: str | torch.device) -> DeviceMesh:
    """A ``data`` x ``model`` device mesh of ``device``'s type: on CUDA the
    process's cards in turn (one card repeats), on the CPU the CPU."""
    device = torch.device(device)
    n = data * model
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n)]
    else:
        devices = [device] * n
    return DeviceMesh(devices, data, model)


def shard_batch(batch: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's rows of a global batch: the ``data`` coordinate's slice
    of the leading axis of every entry."""
    n, d = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    out = {}
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} of {name!r} does not divide over the data axis ({n})")
        rows = x.shape[0] // n
        out[name] = x[d * rows:(d + 1) * rows]
    return out


def param_shardings(params: Mapping[str, torch.Tensor] | torch.nn.Module,
                    mesh: Mesh) -> dict[str, tuple[str, int] | None]:
    """The reference's tensor-parallel rule over a ``state_dict``'s names:
    name -> (axis, dim) for a tensor split over 'model', None for a
    replicated one.

    Where the 'model' size divides the channel count, the detector head's
    wide conv is split on its OUTPUT channels (weight dim 0 of OIHW, bias
    dim 0) and ``head_1x1_0`` on its INPUT channels (weight dim 1).
    Everything else, the MRF's pairwise parameters included, is
    replicated here: the MRF's tensor parallelism slices its source-joint
    axis at the activation level (``parallel/mrf_tp.py``).
    """
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    n = mesh.shape[MODEL_AXIS]
    out: dict[str, tuple[str, int] | None] = {}
    for name, x in params.items():
        parts = name.split(".")
        rule = None
        if n > 1:
            if "head_wide" in parts and parts[-1] in ("weight", "bias") and x.shape[0] % n == 0:
                rule = (MODEL_AXIS, 0)
            elif "head_1x1_0" in parts and parts[-1] == "weight" and x.shape[1] % n == 0:
                rule = (MODEL_AXIS, 1)
        out[name] = rule
    return out


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Make every rank hold rank 0's parameters (replicated storage; each
    rank computes its slice, ``param_shardings``), in place."""
    with torch.no_grad():
        for p in model.parameters():
            mesh.broadcast(p.data)
    return model


def shard_state(state, mesh: Mesh):
    """``shard_params`` for a ``train.TrainState``: the model's parameters
    and the optimizer's moments, broadcast from rank 0 in place."""
    shard_params(state.model, mesh)
    with torch.no_grad():
        for s in state.optimizer.state.values():
            for v in s.values():
                if torch.is_tensor(v) and v.dim() > 0:
                    mesh.broadcast(v)
    return state


def init_distributed(device: str | torch.device | None = None) -> torch.device | None:
    """Join the process group that ``python -m torch.distributed.run`` (or
    any launcher setting ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``) describes; returns this rank's
    device, or None (a no-op) without those variables.

    ``device`` is what the caller would run on alone: a CUDA device becomes
    ``cuda:{LOCAL_RANK % device_count}``.  The backend follows the
    topology: ``nccl`` when every local rank has a card of its own,
    ``gloo`` when ranks share a card (NCCL refuses two ranks on one GPU)
    and on the CPU.  ``JOINTPOSE_SHUTDOWN_TIMEOUT`` (seconds) is the
    group's timeout.  A failed init raises.
    """
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", "0"))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local % cards if device.index is None else device.index)
        torch.cuda.set_device(device)
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local_world <= cards else "gloo"
        why = (f"{local_world} local ranks on {cards} card(s)"
               + ("" if backend == "nccl" else ": ranks share a card"))
    else:
        backend, why = "gloo", "CPU"
    if dist.is_initialized():
        return device
    kwargs = {}
    timeout = env.get("JOINTPOSE_SHUTDOWN_TIMEOUT")
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=int(timeout))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, **kwargs)
    if rank == 0:
        print(f"[distributed] {world} processes, backend {backend} ({why})", flush=True)
    return device


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
