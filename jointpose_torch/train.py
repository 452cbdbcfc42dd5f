"""Staged training (counterpart of ``jointpose/train.py``).

    python -m jointpose_torch.train --config flagship --workdir runs/flagship
    python -m jointpose_torch.train --config tiny --workdir runs/tiny --device cpu
    python -m torch.distributed.run --nproc-per-node 4 -m jointpose_torch.train \
        --config flagship --workdir runs/f4 --mesh-data 2 --mesh-model 2 [--mesh-spatial]

``fit`` runs the whole staged training through the normal entry point:
datasets, state, detector stage, pairwise priors from the training
split, prior init of the spatial model at the first joint-stage step,
joint stage, PDJ evaluation every ``eval_every`` steps (with the
detector head alone until the joint stage begins), checkpoints
(``latest`` keep-N, ``best`` by PDJ) and resume.  The pieces can be
driven alone:

    config = get_config("flagship")
    state = create_state(config, torch.Generator().manual_seed(0))   # on the GPU
    step = make_train_step(config, "joint")
    state, metrics = step(state, {"image": u8, "joints": xy, "visible": vis})
    multi = make_train_multistep(config, "joint", train_ds.get_batch, k=10)
    state, metrics = multi(state, indices)   # (10, batch) int: 10 steps, the last one's metrics

One step: draw the augmentation, warp the batch and transform its
joints, render the Gaussian targets, take the detector loss (plus the
MRF loss in the joint stage) and its gradients, and apply the optimizer
update; under ``freeze_detector_in_joint`` the detector's parameters are
restored exactly afterwards.

The update matches the reference's optax chain, which keeps one step
count for all parameters and updates every parameter every step (a zero
gradient still decays the weights and the moments).  ``torch.optim``
skips a parameter whose ``.grad`` is None and counts steps per
parameter, so the step gives every parameter a gradient, zeros where
the loss does not reach it.

Under a mesh of several processes (``parallel/mesh.py``, one process per
device) every rank runs this loop on its rows of each global batch:
the same global indices and augmentation draw everywhere, the loss's
denominators and the gradients summed over 'data' (the head's split
convs and the MRF's pairwise parameters also over 'model', and under
``MeshConfig.spatial`` the trunk's, whose rows are split over 'model'),
rank 0 alone
writing metrics, figures and checkpoints, a barrier after each save, a
preemption on any rank seen by all at the dispatch boundary.

``fit`` takes up to ``steps_per_dispatch`` steps in one dispatch
(``make_train_multistep`` for on-device sources, ``make_train_multistep_arrays``
for a host-resident split), never across a log, eval, stage or end
boundary, as the reference's ``fit`` does; K steps in one dispatch are
bit-identical to K single steps.  Which form a dispatch takes is a rule
(``graph_dispatch``): one CUDA graph of the K steps, captured once per
multi-step function and replayed, on CUDA in a world of one process and
over an nccl mesh (each rank's graph holds the step's collectives); K
eager steps on the CPU, over a gloo mesh (ranks sharing a card) and under
anomaly detection.  Carried over from ``resilience.py``: SIGTERM checkpoints at
the next dispatch boundary and exits ``resilience.EXIT_PREEMPTED``; the
heartbeat is written after each dispatch, eval, prior init and save (none
before the first dispatch), and ``JOINTPOSE_FAULT_AT_STEP`` is checked
after each dispatch, so that ``python -m jointpose_torch.resilience``
supervises the run.  ``profile_steps`` (``--profile-steps``) traces whole
dispatches under ``metrics.ProfilerHook`` into ``<workdir>/profile/`` (over
a mesh of several ranks each rank traces its window into
``profile/rank<r>/``), a range ``train#<first step>`` each: from the first
dispatch that holds step ``start + 5`` or a later one and replays a graph
captured before it (or takes no graph), until they hold ``profile_steps``
steps or more; the window cuts no dispatch, and its trace holds the
dispatch's spans (``metrics.span``).  On CUDA the first step of each stage runs alone
under ``perf.count_cost`` and logs the step's GFLOP and MB per image, the
bound ``roofline_images_per_sec`` and the stage's first dispatch size
``steps_per_dispatch`` (the reference logs it on the TPU alone).
``save_figures`` (``--figures``) writes the prior grid after the prior
init and the PDJ curves and heatmap overlays at the end, under
``<workdir>/figures/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from jointpose_torch.cli import add_device_flag, apply_device
from jointpose_torch.configs import Config, get_config
from jointpose_torch.data.augment import AugmentParams, augment_batch, random_augment_params
from jointpose_torch.data.pipeline import as_index
from jointpose_torch.data.targets import image_to_heatmap_coords, render_gaussian_heatmaps
from jointpose_torch.graphs import Graph, GraphPool
from jointpose_torch.losses import heatmap_loss, mrf_heatmap_loss
from jointpose_torch.metrics import span
from jointpose_torch.models.mrf import priors_to_raw_kernels
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.predict import init_state_dict, resolve_device
from jointpose_torch.resilience import (
    Heartbeat, PreemptionHandler, mark_preempted, maybe_inject_fault,
)


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates, in place."""

    model: PoseModel
    optimizer: torch.optim.Optimizer
    step: int  # updates applied so far; the LR schedule reads it
    generator: torch.Generator  # augmentation draws, on the model's device
    # The CUDA graphs of the K-step dispatches taken on this state.
    graphs: DispatchGraphs = dataclasses.field(default_factory=lambda: DispatchGraphs())


def make_lr(config: Config) -> Callable[[int], float]:
    """The learning rate as a function of the updates already applied.

    'cosine' is ``optax.warmup_cosine_decay_schedule`` written out: a
    linear warmup from 0 over min(warmup_steps, max(total // 10, 1))
    updates, then a cosine decay to lr·lr_final_frac at ``total``.
    """
    t = config.train
    if t.lr_schedule == "constant":
        return lambda count: t.learning_rate
    if t.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")
    total = t.detector_steps + (t.joint_steps if config.mrf is not None else 0)
    warmup = min(t.warmup_steps, max(total // 10, 1))
    decay = total - warmup
    if decay <= 0:
        raise ValueError(f"the cosine schedule needs more than {warmup} steps, got {total}")
    peak = t.learning_rate
    alpha = 0.0 if peak == 0.0 else t.lr_final_frac

    def lr(count: int) -> float:
        if count < warmup:
            return peak * min(max(count, 0), warmup) / warmup
        c = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return lr


def make_optimizer(config: Config, model: PoseModel) -> torch.optim.Optimizer:
    """AdamW, or momentum SGD on weight-decayed gradients, over two param
    groups: the spatial model's parameters carry ``mrf_lr_mult``, the
    rest 1.  A step sets each group's lr to its multiple of ``make_lr``.

    On CUDA each group's lr is a 0-d float32 tensor on the card that a step
    writes in place (AdamW ``capturable``, SGD ``fused``: their updates take
    a tensor lr without reading it on the host), so that a CUDA graph of
    steps reads the rates of its replay; on the CPU it is a float.  A
    ``load_state_dict`` keeps this optimizer's lr tensors and flags (the
    loaded rates copied in), whichever device wrote the state.
    """
    t = config.train
    spatial = [p for n, p in model.named_parameters() if n.startswith("spatial_model.")]
    rest = [p for n, p in model.named_parameters() if not n.startswith("spatial_model.")]
    mult = t.mrf_lr_mult if config.mrf is not None else 1.0
    groups = [{"params": rest, "lr_mult": 1.0}]
    if spatial:
        groups.append({"params": spatial, "lr_mult": mult})
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    if on_card:
        for group in groups:
            group["lr"] = torch.tensor(t.learning_rate, dtype=torch.float32, device=device)
    if t.optimizer == "adamw":
        opt = torch.optim.AdamW(
            groups, lr=t.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=t.weight_decay,
            capturable=on_card,
        )
    elif t.optimizer == "momentum":
        opt = torch.optim.SGD(
            groups, lr=t.learning_rate, momentum=t.momentum, weight_decay=t.weight_decay,
            fused=on_card or None,
        )
    else:
        raise ValueError(f"unknown optimizer {t.optimizer!r}")
    own = [{k: g[k] for k in ("lr", "capturable", "fused", "foreach") if k in g}
           for g in opt.param_groups]

    def keep_route(optimizer: torch.optim.Optimizer) -> None:
        for group, mine in zip(optimizer.param_groups, own):
            loaded = float(group["lr"])
            group.update(mine)
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(loaded)
            else:
                group["lr"] = loaded

    opt.register_load_state_dict_post_hook(keep_route)
    return opt


def create_state(
    config: Config, generator: torch.Generator, device: str | torch.device | None = None,
    mesh=None,
) -> TrainState:
    """Seeded model, optimizer and augmentation generator on ``device``
    (CUDA unless the caller asks for the CPU; raises without CUDA).

    ``generator`` is a CPU generator: it draws the weights
    (``predict.init_state_dict``) and then the augmentation seed.  ``mesh``
    engages the model's tensor parallelism (``PoseModel(mesh=)``) and, with
    ``config.mesh.spatial``, its spatial parallelism; both only where the
    'model' axis is larger than 1.
    """
    device = resolve_device(device)
    model = PoseModel(config, mesh=mesh, spatial=config.mesh.spatial)
    model.load_state_dict(init_state_dict(config, generator))
    model = model.to(device).train()
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return TrainState(
        model=model,
        optimizer=make_optimizer(config, model),
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def _render_targets(config: Config, joints_xy: torch.Tensor, visible: torch.Tensor) -> dict:
    """Both target renderings: 'peak1' (MSE) and 'dist' (CE)."""
    joints_hm = image_to_heatmap_coords(joints_xy, config.data.heatmap_stride)
    kw = dict(heatmap_hw=config.heatmap_hw, sigma=config.data.sigma)
    return {
        "peak1": render_gaussian_heatmaps(joints_hm, visible, normalize=False, **kw),
        "dist": render_gaussian_heatmaps(joints_hm, visible, normalize=True, **kw),
    }


def _make_step_body(config: Config, stage: str, mesh=None) -> Callable:
    """``body(state, batch, lr, aug=None) -> (state, metrics)``: one step
    at learning rate ``lr`` (a float, or a 0-d tensor on the card for an
    optimizer whose groups hold tensor rates), shared by the single step
    and the K-step dispatches (the reference's ``_make_step_body``)."""
    if stage not in ("detector", "joint"):
        raise ValueError(f"unknown stage {stage!r}")
    use_mrf = stage == "joint" and config.mrf is not None
    freeze_detector = use_mrf and config.train.freeze_detector_in_joint
    t = config.train
    n_data = 1 if mesh is None else mesh.shape["data"]
    d = 0 if mesh is None else mesh.coords["data"]
    distributed = mesh is not None and mesh.size > 1

    def body(
        state: TrainState, batch: dict, lr, aug: AugmentParams | None = None
    ) -> tuple[TrainState, dict]:
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        images = batch["image"].to(device)
        joints = batch["joints"].to(device, torch.float32)
        visible = batch["visible"].to(device, torch.float32)
        if config.augment.enabled:
            rows = images.shape[0]
            if aug is None:
                # Every rank draws the global batch's augmentation from the
                # identically seeded generator and takes its rows.
                aug = random_augment_params(
                    state.generator, rows * n_data, config.augment, config.data.image_hw
                )
            aug = AugmentParams(*(None if v is None else v[d * rows:(d + 1) * rows].to(device)
                                  for v in aug))
            images, joints, visible = augment_batch(
                images, joints, visible, aug, warp_impl=config.augment.warp_impl
            )
        targets = _render_targets(config, joints, visible)

        opt.zero_grad(set_to_none=True)
        # The detector stage's loss does not read the spatial model's output.
        out = model(images, freeze_detector=freeze_detector, detector_only=not use_mrf)
        det = heatmap_loss(t.detector_loss, out["detector_logits"], targets, visible, mesh)
        metrics = {"detector_loss": det}
        if use_mrf:
            mrf = mrf_heatmap_loss(t.mrf_loss, out["mrf_log_heatmaps"], targets, visible, mesh)
            metrics["mrf_loss"] = mrf
            total = mrf if freeze_detector else mrf + det
        else:
            total = det
        metrics["loss"] = total
        total.backward()

        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if distributed:
            # Each rank's loss is its rows' share of the global loss: sums
            # over 'data' give the global gradient and metrics.  Gradients
            # of parameters used in a 'model' slice are zero outside it.
            sliced = model.model_sliced_parameters()
            named = list(model.named_parameters())
            mesh.all_reduce_flat([p.grad for n, p in named if n not in sliced], "data")
            mesh.all_reduce_flat([p.grad for n, p in named if n in sliced], None)
            values = torch.stack([v.detach().float() for v in metrics.values()])
            values = mesh.all_reduce(values, "data")
            metrics = dict(zip(metrics, values))
        metrics["grad_norm"] = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))
        if freeze_detector:
            det_before = [p.detach().clone() for p in model.detector.parameters()]
        for group in opt.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].copy_(lr * group["lr_mult"])
            else:
                group["lr"] = lr * group["lr_mult"]
        opt.step()
        if freeze_detector:
            # Exact freeze: AdamW's decoupled decay would still move the
            # detector's zero-gradient parameters.
            with torch.no_grad():
                for p, old in zip(model.detector.parameters(), det_before):
                    p.copy_(old)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return body


def _learning_rates(optimizer: torch.optim.Optimizer, lr_fn: Callable[[int], float], first: int,
                    k: int):
    """The rates of updates ``first`` to ``first + k - 1``: floats for groups
    that hold float rates, a (k,) float32 tensor on their device for groups
    that hold 0-d tensors (``make_optimizer`` on CUDA)."""
    values = [lr_fn(s) for s in range(first, first + k)]
    lr = optimizer.param_groups[0]["lr"]
    if not torch.is_tensor(lr):
        return values
    return torch.tensor(values, dtype=torch.float32).to(lr.device)


def make_train_step(config: Config, stage: str, mesh=None) -> Callable:
    """``step(state, batch) -> (state, metrics)`` for a stage
    ('detector' | 'joint').

    ``batch`` = {'image' (B, H, W, 3) uint8 or float in [0, 1], 'joints'
    (B, K, 2) image pixels (x, y), 'visible' (B, K)}, on any device.
    ``metrics``: 'detector_loss', 'mrf_loss' (joint stage), 'loss' and
    'grad_norm' (the global norm over all gradients), as 0-d tensors.
    ``aug`` replaces the step's own augmentation draw, so that two runs on
    different devices can warp alike.  After the step each parameter's
    ``.grad`` holds this step's gradient.

    Under a ``mesh`` (``parallel.mesh.Mesh``) ``batch`` is this rank's rows
    of the global batch (``mesh.shard_batch``): the augmentation is drawn
    for the global batch (``aug`` too is the global batch's) and sliced,
    the losses' denominators and the gradients are summed over 'data', the
    parameters the rank uses in a 'model' slice also over 'model', and the
    metrics are the global batch's.
    """
    body = _make_step_body(config, stage, mesh)
    lr_fn = make_lr(config)

    def step(
        state: TrainState, batch: dict, aug: AugmentParams | None = None
    ) -> tuple[TrainState, dict]:
        return body(state, batch, _learning_rates(state.optimizer, lr_fn, state.step, 1)[0], aug)

    return step


def graph_dispatch(device: torch.device, mesh=None) -> bool:
    """Which form a K-step dispatch takes, by rule: one CUDA graph of the K
    steps on CUDA in a world of one process (``mesh`` None or of size 1)
    and over a mesh whose backend is ``'nccl'`` (a card a rank: the graph
    holds the step's collectives); K eager steps on the CPU, over a gloo
    mesh on CUDA (ranks that share a card: gloo's collectives run on the
    host and cannot be captured) and under
    ``torch.autograd.set_detect_anomaly`` (``--check-numerics``: its checks
    read values on the host, which a capture cannot).  A capture that
    fails raises: no dispatch falls back to eager steps."""
    return (device.type == "cuda" and not torch.is_anomaly_enabled()
            and (mesh is None or mesh.size == 1 or mesh.backend == "nccl"))


def make_train_multistep(
    config: Config, stage: str, get_batch: Callable, k: int, mesh=None
) -> Callable:
    """K train steps in one dispatch for an on-device source (counterpart
    of the reference's ``make_train_multistep``).

    ``multi_step(state, indices)``: ``indices`` (K, rows) int holds this
    rank's rows of each step's global batch, and ``get_batch`` (the
    synthetic source, or a split ``device_cache`` holds) generates each
    step's batch inside the dispatch.  Returns the state after the K steps
    and the last step's metrics, bit-identical to K calls of
    ``make_train_step`` (the augmentation draw and the learning rate follow
    ``state.step`` there too).  The dispatch's form follows
    ``graph_dispatch``.
    """
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    body = _make_step_body(config, stage, mesh)
    lr_fn = make_lr(config)

    def multi_step(state: TrainState, indices) -> tuple[TrainState, dict]:
        indices = as_index(indices)
        if indices.dim() != 2 or indices.shape[0] != k:
            raise ValueError(f"indices must be ({k}, rows), got {tuple(indices.shape)}")
        return _dispatch(multi_step, state, stage, k, mesh, body, lr_fn, {"indices": indices},
                         lambda inputs, i: get_batch(inputs["indices"][i]))

    return multi_step


def make_train_multistep_arrays(config: Config, stage: str, k: int, mesh=None) -> Callable:
    """K train steps in one dispatch for a host-resident split (counterpart
    of the reference's ``make_train_multistep_arrays``).

    ``multi_step(state, batches)``: ``batches`` is ``make_train_step``'s
    batch with a leading axis of K on each tensor ((K, rows, H, W, 3)
    images, uint8 or float, ...), best in pinned memory on CUDA: each tensor
    crosses to the device in one copy, uint8 images as uint8.  Returns the
    state after the K steps and the last step's metrics, bit-identical to K
    calls of ``make_train_step``; the form follows ``graph_dispatch``.
    """
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    body = _make_step_body(config, stage, mesh)
    lr_fn = make_lr(config)

    def multi_step(state: TrainState, batches: dict) -> tuple[TrainState, dict]:
        if any(v.shape[0] != k for v in batches.values()):
            raise ValueError(f"each batch tensor must lead with {k} steps")
        return _dispatch(multi_step, state, stage, k, mesh, body, lr_fn, dict(batches),
                         lambda inputs, i: {name: v[i] for name, v in inputs.items()})

    return multi_step


def _dispatch(key, state, stage, k, mesh, body, lr_fn, inputs, batch_of):
    device = next(state.model.parameters()).device
    if graph_dispatch(device, mesh):
        return state.graphs.run(key, state, stage, k, body, lr_fn, inputs, batch_of, mesh)
    return _eager_steps(state, k, body, lr_fn, inputs, batch_of)


def _eager_steps(state, k, body, lr_fn, inputs, batch_of):
    """The K steps one after another; each tensor of ``inputs`` crosses to
    the device once."""
    device = next(state.model.parameters()).device
    with span("dispatch.prepare"):
        inputs = {name: v.to(device, non_blocking=True) for name, v in inputs.items()}
    with span("dispatch.rates"):
        lrs = _learning_rates(state.optimizer, lr_fn, state.step, k)
    for i in range(k):
        state, metrics = body(state, batch_of(inputs, i), lrs[i])
    return state, metrics


def _graph_anchors(state: TrainState) -> list[int]:
    """Where the tensors live that a captured dispatch reads and updates in
    place across replays: the parameters, the optimizer's state and rates,
    and the generator."""
    opt = state.optimizer
    tensors = [p for g in opt.param_groups for p in g["params"]]
    tensors += [g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"])]
    tensors += [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]
    return [id(state.generator), *(t.data_ptr() for t in tensors)]


class DispatchGraphs:
    """The graph form of the K-step dispatch: one CUDA graph
    (``graphs.Graph``) per multi-step function, captured at its first
    dispatch once its stage is warm, then replayed; all of a state's graphs
    share one ``graphs.GraphPool``.

    - A stage's first dispatch runs eagerly, on the capture stream
      (``GraphPool.warm``): it creates the optimizer's state (a capture
      would record its creation and replay it) and sets cuDNN and cuBLAS
      up for that stream; over a mesh its collectives create the
      communicator of every process group the step uses (NCCL creates one
      at a group's first collective, which a capture cannot hold).
    - A capture records the K steps' launches on the card and nothing on
      the host: the state's step count is put back afterwards, as the
      kernels' launch counters are; each replay advances the step count by
      K, and the augmentation generator (registered with the graph) as K
      eager steps would.
    - The host fills the graph's static inputs (indices or batches) and
      its K learning rates before each replay, and clones the last step's
      metrics after it; each parameter's ``.grad`` is then the graph's
      gradient of the last step.
    - When what the graphs read in place was replaced (a
      ``load_state_dict`` of the optimizer, a new parameter tensor), they
      are thrown away and the stages warmed again (``refresh``).
    - Over a mesh of several ranks (nccl) each rank holds its own graphs,
      whose collectives pair with the other ranks'; every rank decides
      alike to warm, capture or replay: ``refresh`` is a collective
      decision, and the rest follows from the same calls on every rank.
      Whether a capture succeeded is agreed on too (``_capture``): a
      capture that fails on one rank raises on every rank.
    """

    def __init__(self):
        self.graphs: dict = {}  # key -> (graph, static inputs, static rates, gradients)
        self.warm: set[str] = set()
        self.anchors: list[int] | None = None
        self.pool = GraphPool()

    def refresh(self, state, mesh=None) -> bool:
        """Throw the graphs away, and forget the warm stages, when what they
        read in place was replaced on any rank of ``mesh``; returns whether
        it did.  Over several ranks this is an all-reduce at the dispatch
        boundary, outside any graph: a rank that recaptured while another
        replayed would pair their collectives wrongly."""
        stale = _graph_anchors(state) != self.anchors
        if mesh is not None:
            stale = mesh.any(stale)
        if stale:
            self.release()
        return stale

    def replays(self, key, state) -> bool:
        """Whether the next dispatch of ``key`` replays a graph captured
        before it, as this rank sees the state now."""
        return key in self.graphs and _graph_anchors(state) == self.anchors

    def release(self) -> None:
        """Drop the graphs, their pool and the warm stages.  Over an nccl
        mesh a graph holds the communicators of the collectives it
        captured: NCCL destroys a communicator (``destroy_process_group``)
        only once no graph holds it."""
        self.graphs.clear()
        self.warm.clear()
        self.anchors = None
        self.pool.release()

    def run(self, key, state, stage, k, body, lr_fn, inputs, batch_of, mesh=None):
        device = next(state.model.parameters()).device
        with torch.cuda.device(device):
            with span("dispatch.prepare"):
                self.refresh(state, mesh)
            if stage not in self.warm:
                out = self.pool.warm(
                    lambda: _eager_steps(state, k, body, lr_fn, inputs, batch_of))
                self.warm.add(stage)
                self.anchors = _graph_anchors(state)
                return out
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(state, k, body, inputs, batch_of, mesh)
            graph, static, lrs, grads = entry
            with span("dispatch.prepare"):
                for name, v in inputs.items():
                    static[name].copy_(v, non_blocking=True)
            with span("dispatch.rates"):
                lrs.copy_(_learning_rates(state.optimizer, lr_fn, state.step, k))
            with span("dispatch.replay"):
                graph.replay()
            with span("dispatch.outputs"):
                state.step += k
                for p, g in zip(state.model.parameters(), grads):
                    p.grad = g
                return state, {name: v.clone() for name, v in graph.out.items()}

    def _capture(self, state, k, body, inputs, batch_of, mesh):
        """Capture a dispatch on every rank, or raise on every rank: a rank
        whose capture failed must not leave the others replaying
        collectives it never joins.  Nothing is run eagerly instead."""
        device = next(state.model.parameters()).device
        static = {name: torch.empty(v.shape, dtype=v.dtype, device=device)
                  for name, v in inputs.items()}
        lrs = torch.zeros(k, dtype=torch.float32, device=device)

        def steps():
            first = state.step
            try:
                for i in range(k):
                    _, metrics = body(state, batch_of(static, i), lrs[i])
            finally:
                state.step = first
            return metrics

        failure = None
        try:
            graph = Graph(self.pool, steps, state.generator)
        except Exception as e:  # agreed on with the other ranks, then raised
            failure = e
        if mesh is not None and mesh.any(failure is not None) and failure is None:
            raise RuntimeError("the capture of a K-step dispatch failed on another rank of the mesh")
        if failure is not None:
            raise failure
        return graph, static, lrs, [p.grad for p in state.model.parameters()]


def init_mrf_from_priors(state: TrainState, priors) -> TrainState:
    """Stage transition: set the spatial-model kernels from (wh, ww, K, K)
    prior maps, in place."""
    raw = priors_to_raw_kernels(priors)
    target = state.model.spatial_model.raw_kernels
    if tuple(target.shape) != tuple(raw.shape):
        raise ValueError(f"priors {tuple(raw.shape)} do not match kernels {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(raw.to(target.device, target.dtype))
    return state


@dataclasses.dataclass
class FitResult:
    state: TrainState
    metrics: dict
    workdir: str


def fit(
    config: Config,
    workdir: str,
    eval_max_batches: int | None = None,
    resume: bool = False,
    profile_steps: int = 0,
    device: str | torch.device | None = None,
    save_figures: bool = False,
) -> FitResult:
    """Run the full staged training on ``device`` (CUDA unless the caller
    asks for the CPU); returns the final state and eval metrics.

    The mesh is ``config.mesh`` over the process group's world
    (``parallel.mesh.make_mesh``; one process, one device without a
    group): every rank of a larger world calls ``fit`` alike."""
    from jointpose_torch.checkpoint import Checkpointer
    from jointpose_torch.data.pipeline import device_cache, epoch_order, epoch_steps, make_dataset
    from jointpose_torch.evaluate import evaluate, make_eval_step
    from jointpose_torch.metrics import MetricLogger, ProfilerHook
    from jointpose_torch.parallel.mesh import make_mesh, shard_state
    from jointpose_torch.perf import count_cost, roofline_images_per_sec
    from jointpose_torch.priors import estimate_priors

    device = resolve_device(device)
    t = config.train
    mesh = make_mesh(config.mesh)
    n_data, d = mesh.shape["data"], mesh.coords["data"]
    if t.batch_size % n_data:
        raise ValueError(
            f"batch_size {t.batch_size} must be divisible by the mesh data axis ({n_data})")
    rows = t.batch_size // n_data
    # Host-side artifacts with one writer (metrics.jsonl, figures) belong to
    # rank 0; checkpoints are written by rank 0 with a barrier after each
    # save (checkpoint.py).  Every rank traces its own profiled window.
    is_lead = mesh.rank == 0
    logger = MetricLogger(workdir, enabled=is_lead)
    # Records the architecture mode; fails fast on a resume whose
    # pool_mode contradicts the saved run's.
    ckpt = Checkpointer(f"{workdir}/{t.checkpoint_dir}", keep=t.keep_checkpoints, config=config)
    train_ds, test_ds = make_dataset(config.data, device)
    if config.data.device_cache_gb > 0:
        budget = config.data.device_cache_gb * 1e9
        train_ds = device_cache(train_ds, budget, device)
        test_ds = device_cache(test_ds, budget, device)
    state = create_state(config, torch.Generator().manual_seed(t.seed), device=device, mesh=mesh)
    state = shard_state(state, mesh)
    model = state.model

    start_step = 0
    mrf_initialized = False
    if resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = state.step
        # Strictly greater: a checkpoint taken at the stage boundary was
        # written before the prior init (which runs at the first joint
        # step), so resuming there must still apply it.
        mrf_initialized = start_step > t.detector_steps
        print(f"resumed from step {start_step}")

    det_steps = t.detector_steps
    joint_steps = t.joint_steps if config.mrf is not None else 0
    total_steps = det_steps + joint_steps
    step_fns = {stage: make_train_step(config, stage, mesh) for stage in ("detector", "joint")}

    # Deterministic dataset position: the batch of step s is a function of
    # (seed, s), so a resume continues the exact shuffled order with no
    # iterator state to save.
    steps_per_epoch = epoch_steps(train_ds, t.batch_size)
    epoch_cache: dict[int, np.ndarray] = {}

    def indices_for_step(s: int) -> np.ndarray:
        """This rank's rows of step s's global batch, which every rank
        computes alike."""
        epoch, pos = divmod(s, steps_per_epoch)
        order = epoch_cache.get(epoch)
        if order is None:
            order = epoch_order(train_ds.size, t.batch_size, np.random.default_rng(t.seed + epoch))
            epoch_cache.clear()  # only the current epoch is ever needed
            epoch_cache[epoch] = order
        lo = pos * t.batch_size + d * rows
        return order[lo : lo + rows]

    # Before the MRF has its prior init its uniform kernels box-blur the
    # unaries into a near-uniform field: evaluating through it says nothing
    # about the detector.  The detector head is scored until the joint
    # stage begins.
    eval_steps = {
        "detector": make_eval_step(config, functools.partial(model, detector_only=True)),
        "joint": make_eval_step(config, model),
    }

    # The supervisor's hang detector reads the heartbeat (resilience.py).
    # No beat before the first step: its clock starts at the first beat,
    # so start-up, cuDNN's algorithm choice and kernel builds stay exempt.
    heartbeat = Heartbeat(workdir)

    def run_eval(step: int) -> dict:
        stage_now = "detector" if step <= det_steps else "joint"
        ev = evaluate(model, test_ds, config, max_batches=eval_max_batches,
                      eval_step=eval_steps[stage_now], mesh=mesh)
        # Which graph produced the score: a detector-stage PDJ says nothing
        # about the full CNN+MRF model.
        ev["eval_stage"] = stage_now
        logger.log(
            step, eval_stage=stage_now, pdj_at_05_wrist_elbow=ev["pdj_at_05_wrist_elbow"],
            **{f"pdj05/{k}": v for k, v in ev["pdj_at_05"].items()},
        )
        heartbeat.beat(step)  # an eval blocks the loop
        return ev

    # An on-device source (synthetic, or a split device_cache holds)
    # generates each step's batch inside the dispatch from its indices; a
    # host-resident split stages the dispatch's batches in host memory,
    # pinned on CUDA, and each tensor crosses to the device in one copy.
    fused = not train_ds.host_resident
    multi_fns: dict[tuple[str, int], Callable] = {}

    def staged(batches: list[dict]) -> dict:
        out = {}
        for key in batches[0]:
            parts = [b[key] for b in batches]
            buf = torch.empty((len(parts), *parts[0].shape), dtype=parts[0].dtype,
                              pin_memory=device.type == "cuda")
            out[key] = torch.stack(parts, out=buf)
        return out

    def take_steps(stage: str, first: int, chunk: int):
        """Steps ``first`` to ``first + chunk - 1`` of ``stage`` in one dispatch."""
        if chunk == 1:
            return step_fns[stage](state, train_ds.get_batch(indices_for_step(first)))
        fn = multi_fns.get((stage, chunk))
        if fn is None:
            fn = multi_fns[stage, chunk] = (
                make_train_multistep(config, stage, train_ds.get_batch, chunk, mesh) if fused
                else make_train_multistep_arrays(config, stage, chunk, mesh))
        steps = range(first, first + chunk)
        if fused:
            return fn(state, np.stack([indices_for_step(s) for s in steps]))
        return fn(state, staged([train_ds.get_batch(indices_for_step(s)) for s in steps]))

    def counted_steps(stage: str, first: int, chunk: int):
        """A stage's first dispatch, its first step alone under
        ``perf.count_cost``, logged as the reference's per-stage cost record:
        what one step (its batch generated on the card included) reads,
        writes and multiplies, per image, the images per second the card's
        peaks would allow for it, and the dispatch's size."""
        with count_cost() as cost:
            out = take_steps(stage, first, 1)
        per_img_flops, per_img_bytes = cost.flops / rows, cost.bytes / rows
        logger.log(
            first, stage=stage, steps_per_dispatch=chunk,
            train_step_gflops_per_image=per_img_flops / 1e9,
            train_step_mb_per_image=per_img_bytes / 1e6,
            roofline_images_per_sec=roofline_images_per_sec(per_img_flops, per_img_bytes),
        )
        return take_steps(stage, first + 1, chunk - 1) if chunk > 1 else out

    # A trace of whole dispatches after the run's first steps, on every
    # rank, from the first that runs as the later ones of its kind do: it
    # replays a graph captured before it (cuDNN's algorithm choice, the
    # kernel builds, the warm-up and the capture stay out of the trace), or
    # takes no graph.  The window cuts no dispatch.
    profiler = (ProfilerHook(workdir, start_step=start_step + 5, num_steps=profile_steps,
                             rank=mesh.rank if mesh.size > 1 else None)
                if profile_steps > 0 else None)
    k_dispatch = max(t.steps_per_dispatch, 1)
    by_graph = k_dispatch > 1 and graph_dispatch(device, mesh)

    def settled(stage: str, chunk: int) -> bool:
        """Whether the dispatch of ``chunk`` steps replays a graph captured
        before it or takes no graph."""
        if chunk == 1 or not by_graph:
            return True
        fn = multi_fns.get((stage, chunk))
        return fn is not None and state.graphs.replays(fn, state)

    costed: set[str] = set()  # stages whose cost was logged (on CUDA only)

    def now() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.time()

    def dispatch_size(step: int) -> int:
        """Up to ``steps_per_dispatch`` steps, never across a log, eval,
        stage or end boundary (the reference's chunking).  Every rank of a
        mesh cuts alike."""
        bounds = [(step // t.log_every + 1) * t.log_every,
                  (step // t.eval_every + 1) * t.eval_every,
                  det_steps if step < det_steps else total_steps, total_steps]
        return min(k_dispatch, min(b for b in bounds if b > step) - step)

    step = start_step
    t_last, n_last = now(), step
    final_eval: dict = {}
    # SIGTERM -> checkpoint at the next dispatch boundary and exit EXIT_PREEMPTED,
    # from which --resume goes on (jointpose_torch/resilience.py).
    preemption = PreemptionHandler().install()
    try:
        while step < total_steps:
            stage = "detector" if step < det_steps else "joint"
            if stage == "joint" and config.mrf is not None and not mrf_initialized:
                print("estimating pairwise priors for MRF init ...")
                priors = estimate_priors(train_ds, config, max_examples=2048)
                state = init_mrf_from_priors(state, priors)
                mrf_initialized = True
                heartbeat.beat(step)  # the prior estimation blocks the loop too
                if save_figures and is_lead:
                    from jointpose_torch.visualize import save_prior_grid

                    save_prior_grid(np.asarray(priors), f"{workdir}/figures/priors.png")
            chunk = dispatch_size(step)
            run = take_steps
            if device.type == "cuda" and stage not in costed:
                costed.add(stage)
                run = counted_steps
            if profiler is not None:
                profiler.on_step(step, chunk, settled(stage, chunk))
                with profiler.annotation(step):
                    state, metrics = run(stage, step, chunk)
            else:
                state, metrics = run(stage, step, chunk)
            step += chunk
            heartbeat.beat(step)
            maybe_inject_fault(workdir, step)
            # A preemption of any rank is seen by all at this boundary, so
            # that no rank waits in a collective that another has left.
            if mesh.any(preemption.preempted):
                if ckpt.latest_step() != step:  # an eval may have saved this step
                    ckpt.save(step, state)
                logger.log(step, preempted=True)
                logger.close()
                ckpt.close()
                if is_lead:  # a rank launcher's exit code does not say it
                    mark_preempted(workdir, step)
                print(f"preempted: checkpointed at step {step}", flush=True)
                preemption.exit_preempted()

            if step % t.log_every == 0 or step == total_steps:
                t_now = now()
                ips = (step - n_last) * t.batch_size / max(t_now - t_last, 1e-9)
                logger.log(step, stage=stage, images_per_sec=ips,
                           **{k: float(v) for k, v in metrics.items()})
                t_last, n_last = t_now, step
            if step % t.eval_every == 0 or step == total_steps:
                final_eval = run_eval(step)
                # Only full-model scores may rank the kept-best checkpoint: a
                # detector-stage PDJ attached to a checkpoint that holds an
                # uninitialized MRF would let serving pick near-uniform MRF
                # output under a high recorded score.  Without an MRF the
                # detector head is the full model, so every eval qualifies.
                is_full_model = config.mrf is None or final_eval["eval_stage"] == "joint"
                ckpt.save(step, state, metrics=final_eval if is_full_model else None)
                heartbeat.beat(step)  # a blocking save counts as liveness too
                t_last = now()  # evals and saves stay out of the logged rate
    finally:
        preemption.uninstall()
        if mesh.size > 1:
            # The mesh's process groups outlive this run only to be
            # destroyed, which waits on every graph that holds them.
            state.graphs.release()
    if profiler is not None:
        profiler.close()  # write a trace still open at the loop's end

    if final_eval and save_figures:
        from jointpose_torch.ops.heatmaps import model_probs
        from jointpose_torch.visualize import save_heatmap_overlays, save_pdj_curves

        batch = test_ds.get_batch(np.arange(4))
        with torch.inference_mode():  # on every rank: a tensor-parallel model runs collectives
            probs = model_probs(model(batch["image"].to(device)))
        if is_lead:
            save_pdj_curves(final_eval, f"{workdir}/figures/pdj_curves.png")
            save_heatmap_overlays(batch["image"].cpu().numpy(), probs.cpu().numpy(),
                                  f"{workdir}/figures/heatmaps.png", batch["joints"].cpu().numpy())

    logger.close()
    ckpt.close()
    return FitResult(state=state, metrics=final_eval, workdir=workdir)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="jointpose_torch staged training")
    parser.add_argument("--config", default="joint", help="preset name")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--detector-steps", type=int, default=None)
    parser.add_argument("--joint-steps", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--lr-schedule", choices=["constant", "cosine"], default=None)
    parser.add_argument("--steps-per-dispatch", type=int, default=None,
                        help="train steps per dispatch (default: the config's): one CUDA graph of "
                             "them on the card, alone or a card a rank (nccl); eager steps on the "
                             "CPU and where ranks share a card (gloo)")
    parser.add_argument("--mrf-lr-mult", type=float, default=None,
                        help="LR multiplier for the spatial model's parameters")
    parser.add_argument("--mrf-loss", choices=["mse", "ce"], default=None,
                        help="loss on the MRF output heatmaps (per-pixel MSE, or the spatial "
                             "softmax cross-entropy)")
    parser.add_argument("--pool-mode", choices=["max", "stride"], default=None,
                        help="trunk downsampling: maxpool or stride-2 conv (same param shapes)")
    parser.add_argument("--warp-impl", choices=["gather", "shear"], default=None,
                        help="augmentation image resample: bilinear gather, or the two-pass "
                             "shear resample (the CUDA kernel; another augmentation stream)")
    parser.add_argument("--source", choices=["synthetic", "flic"], default=None)
    parser.add_argument("--flic-dir", default=None,
                        help="FLIC root (examples.mat + images/); defaults to the config's")
    parser.add_argument("--device-cache-gb", type=float, default=None,
                        help="device-memory budget for caching host splits (0 = stream)")
    parser.add_argument("--eval-max-batches", type=int, default=None)
    parser.add_argument("--eval-every", type=int, default=None,
                        help="eval + checkpoint cadence in steps")
    parser.add_argument("--log-every", type=int, default=None)
    parser.add_argument("--figures", action="store_true",
                        help="write the prior grid, PDJ curves and heatmap overlays to "
                             "<workdir>/figures/")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="trace N train steps with torch.profiler into <workdir>/profile "
                             "(over a mesh, each rank into <workdir>/profile/rank<r>)")
    parser.add_argument("--check-numerics", action="store_true",
                        help="torch.autograd.set_detect_anomaly: fail at the op that made a NaN")
    parser.add_argument("--mesh-data", type=int, default=None,
                        help="data-parallel processes (one per device; -1 = the world over "
                             "--mesh-model); launch them with python -m torch.distributed.run")
    parser.add_argument("--mesh-model", type=int, default=None,
                        help="model-axis processes: channel tensor parallelism on the detector "
                             "head and source-joint tensor parallelism in the MRF")
    parser.add_argument("--mesh-spatial", action="store_true",
                        help="with --mesh-model > 1, also split the detector trunk's image rows "
                             "over 'model' (halo exchanges)")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = apply_device(args.device)
    # Joins the process group of a multi-process launch (a no-op alone),
    # before any work on the device.
    from jointpose_torch.parallel.mesh import init_distributed, shutdown_distributed

    device = init_distributed(device) or device
    if args.check_numerics:
        torch.autograd.set_detect_anomaly(True)

    config = get_config(args.config)
    tr: dict[str, Any] = {
        name: getattr(args, name) for name in (
            "detector_steps", "joint_steps", "batch_size", "learning_rate", "lr_schedule",
            "mrf_lr_mult", "steps_per_dispatch", "mrf_loss", "eval_every", "log_every",
        ) if getattr(args, name) is not None
    }
    if tr:
        config = config.replace(train=dataclasses.replace(config.train, **tr))
    if args.pool_mode is not None:
        from jointpose_torch.configs import with_pool_mode

        config = with_pool_mode(config, args.pool_mode)
    if args.warp_impl is not None:
        config = config.replace(
            augment=dataclasses.replace(config.augment, warp_impl=args.warp_impl)
        )
    dd = {name: getattr(args, name) for name in ("source", "flic_dir", "device_cache_gb")
          if getattr(args, name) is not None}
    if dd:
        config = config.replace(data=dataclasses.replace(config.data, **dd))

    if args.mesh_data is not None or args.mesh_model is not None or args.mesh_spatial:
        mm: dict[str, Any] = {"spatial": args.mesh_spatial}
        mm.update((name, value) for name, value in (("data", args.mesh_data),
                                                    ("model", args.mesh_model))
                  if value is not None)
        config = config.replace(mesh=dataclasses.replace(config.mesh, **mm))

    try:
        result = fit(config, args.workdir, eval_max_batches=args.eval_max_batches,
                     resume=args.resume, profile_steps=args.profile_steps, device=device,
                     save_figures=args.figures)
    finally:
        shutdown_distributed()
    print("final:", {k: v for k, v in result.metrics.items() if k != "pdj_curves"})


if __name__ == "__main__":
    main()
