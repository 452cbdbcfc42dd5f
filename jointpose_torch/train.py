"""Training step (counterpart of ``jointpose/train.py:54-186`` and ``:269-285``).

    config = get_config("flagship")
    state = create_state(config, torch.Generator().manual_seed(0))   # on the GPU
    step = make_train_step(config, "joint")
    state, metrics = step(state, {"image": u8, "joints": xy, "visible": vis})

One step: draw the augmentation, warp the batch and transform its
joints, render the Gaussian targets, take the detector loss (plus the
MRF loss in the joint stage) and its gradients, and apply the optimizer
update; under ``freeze_detector_in_joint`` the detector's parameters are
restored exactly afterwards.  The trainer takes caller-supplied batches.

The update matches the reference's optax chain, which keeps one step
count for all parameters and updates every parameter every step (a zero
gradient still decays the weights and the moments).  ``torch.optim``
skips a parameter whose ``.grad`` is None and counts steps per
parameter, so the step gives every parameter a gradient, zeros where
the loss does not reach it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from jointpose_torch.configs import Config
from jointpose_torch.data.augment import AugmentParams, augment_batch, random_augment_params
from jointpose_torch.data.targets import image_to_heatmap_coords, render_gaussian_heatmaps
from jointpose_torch.losses import heatmap_loss, mrf_heatmap_loss
from jointpose_torch.models.mrf import priors_to_raw_kernels
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.predict import init_state_dict, resolve_device


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates, in place."""

    model: PoseModel
    optimizer: torch.optim.Optimizer
    step: int  # updates applied so far; the LR schedule reads it
    generator: torch.Generator  # augmentation draws, on the model's device


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
    rest 1.  A step sets each group's lr to its multiple of ``make_lr``."""
    t = config.train
    spatial = [p for n, p in model.named_parameters() if n.startswith("spatial_model.")]
    rest = [p for n, p in model.named_parameters() if not n.startswith("spatial_model.")]
    mult = t.mrf_lr_mult if config.mrf is not None else 1.0
    groups = [{"params": rest, "lr_mult": 1.0}]
    if spatial:
        groups.append({"params": spatial, "lr_mult": mult})
    if t.optimizer == "adamw":
        return torch.optim.AdamW(
            groups, lr=t.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=t.weight_decay
        )
    if t.optimizer == "momentum":
        return torch.optim.SGD(
            groups, lr=t.learning_rate, momentum=t.momentum, weight_decay=t.weight_decay
        )
    raise ValueError(f"unknown optimizer {t.optimizer!r}")


def create_state(
    config: Config, generator: torch.Generator, device: str | torch.device | None = None
) -> TrainState:
    """Seeded model, optimizer and augmentation generator on ``device``
    (CUDA unless the caller asks for the CPU; raises without CUDA).

    ``generator`` is a CPU generator: it draws the weights
    (``predict.init_state_dict``) and then the augmentation seed.
    """
    device = resolve_device(device)
    model = PoseModel(config)
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


def make_train_step(config: Config, stage: str) -> Callable:
    """``step(state, batch) -> (state, metrics)`` for a stage
    ('detector' | 'joint').

    ``batch`` = {'image' (B, H, W, 3) uint8 or float in [0, 1], 'joints'
    (B, K, 2) image pixels (x, y), 'visible' (B, K)}, on any device.
    ``metrics``: 'detector_loss', 'mrf_loss' (joint stage), 'loss' and
    'grad_norm' (the global norm over all gradients), as 0-d tensors.
    ``aug`` replaces the step's own augmentation draw, so that two runs on
    different devices can warp alike.  After the step each parameter's
    ``.grad`` holds this step's gradient.
    """
    if stage not in ("detector", "joint"):
        raise ValueError(f"unknown stage {stage!r}")
    use_mrf = stage == "joint" and config.mrf is not None
    freeze_detector = use_mrf and config.train.freeze_detector_in_joint
    lr_fn = make_lr(config)
    t = config.train

    def step(
        state: TrainState, batch: dict, aug: AugmentParams | None = None
    ) -> tuple[TrainState, dict]:
        model, opt = state.model, state.optimizer
        device = next(model.parameters()).device
        images = batch["image"].to(device)
        joints = batch["joints"].to(device, torch.float32)
        visible = batch["visible"].to(device, torch.float32)
        if config.augment.enabled:
            if aug is None:
                aug = random_augment_params(
                    state.generator, images.shape[0], config.augment, config.data.image_hw
                )
            else:
                aug = AugmentParams(*(None if t is None else t.to(device) for t in aug))
            images, joints, visible = augment_batch(
                images, joints, visible, aug, warp_impl=config.augment.warp_impl
            )
        targets = _render_targets(config, joints, visible)

        opt.zero_grad(set_to_none=True)
        out = model(images, freeze_detector=freeze_detector)
        det = heatmap_loss(t.detector_loss, out["detector_logits"], targets, visible)
        metrics = {"detector_loss": det}
        if use_mrf:
            mrf = mrf_heatmap_loss(t.mrf_loss, out["mrf_log_heatmaps"], targets, visible)
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
        metrics["grad_norm"] = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))
        if freeze_detector:
            det_before = [p.detach().clone() for p in model.detector.parameters()]
        lr = lr_fn(state.step)
        for group in opt.param_groups:
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

    return step


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
