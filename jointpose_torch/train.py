"""Staged training (counterpart of ``jointpose/train.py``, one device).

    python -m jointpose_torch.train --config flagship --workdir runs/flagship
    python -m jointpose_torch.train --config tiny --workdir runs/tiny --device cpu

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

Not carried over from the reference's ``fit`` (ROADMAP.md names each):
the mesh and multi-process branches and the K-step scan
(``steps_per_dispatch`` is read and ignored: one step per call).
Carried over from ``resilience.py``: SIGTERM checkpoints at the next step
boundary and exits ``resilience.EXIT_PREEMPTED``; the heartbeat is
written after each step, eval, prior init and save (none before the
first step), and ``JOINTPOSE_FAULT_AT_STEP`` is checked after each step,
so that ``python -m jointpose_torch.resilience`` supervises the run.
``profile_steps`` (``--profile-steps``) traces steps ``start + 5`` to
``start + 4 + profile_steps`` under ``metrics.ProfilerHook`` into
``<workdir>/profile/``.  On CUDA the first step of each stage runs under
``perf.count_cost`` and logs the step's GFLOP and MB per image and the
bound ``roofline_images_per_sec`` (the reference logs it on the TPU
alone).  ``save_figures`` (``--figures``) writes the prior grid after the
prior init and the PDJ curves and heatmap overlays at the end, under
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
from jointpose_torch.data.targets import image_to_heatmap_coords, render_gaussian_heatmaps
from jointpose_torch.losses import heatmap_loss, mrf_heatmap_loss
from jointpose_torch.models.mrf import priors_to_raw_kernels
from jointpose_torch.models.pose import PoseModel
from jointpose_torch.predict import init_state_dict, refuse_unported, resolve_device
from jointpose_torch.resilience import Heartbeat, PreemptionHandler, maybe_inject_fault


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
        # The detector stage's loss does not read the spatial model's output.
        out = model(images, freeze_detector=freeze_detector, detector_only=not use_mrf)
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
    asks for the CPU); returns the final state and eval metrics."""
    from jointpose_torch.checkpoint import Checkpointer
    from jointpose_torch.data.pipeline import device_cache, epoch_order, epoch_steps, make_dataset
    from jointpose_torch.evaluate import evaluate, make_eval_step
    from jointpose_torch.metrics import MetricLogger, ProfilerHook
    from jointpose_torch.perf import count_cost, roofline_images_per_sec
    from jointpose_torch.priors import estimate_priors

    device = resolve_device(device)
    t = config.train
    logger = MetricLogger(workdir)
    # Records the architecture mode; fails fast on a resume whose
    # pool_mode contradicts the saved run's.
    ckpt = Checkpointer(f"{workdir}/{t.checkpoint_dir}", keep=t.keep_checkpoints, config=config)
    train_ds, test_ds = make_dataset(config.data, device)
    if config.data.device_cache_gb > 0:
        budget = config.data.device_cache_gb * 1e9
        train_ds = device_cache(train_ds, budget, device)
        test_ds = device_cache(test_ds, budget, device)
    state = create_state(config, torch.Generator().manual_seed(t.seed), device=device)
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
    step_fns = {stage: make_train_step(config, stage) for stage in ("detector", "joint")}

    # Deterministic dataset position: the batch of step s is a function of
    # (seed, s), so a resume continues the exact shuffled order with no
    # iterator state to save.
    steps_per_epoch = epoch_steps(train_ds, t.batch_size)
    epoch_cache: dict[int, np.ndarray] = {}

    def indices_for_step(s: int) -> np.ndarray:
        epoch, pos = divmod(s, steps_per_epoch)
        order = epoch_cache.get(epoch)
        if order is None:
            order = epoch_order(train_ds.size, t.batch_size, np.random.default_rng(t.seed + epoch))
            epoch_cache.clear()  # only the current epoch is ever needed
            epoch_cache[epoch] = order
        lo = pos * t.batch_size
        return order[lo : lo + t.batch_size]

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
                      eval_step=eval_steps[stage_now])
        # Which graph produced the score: a detector-stage PDJ says nothing
        # about the full CNN+MRF model.
        ev["eval_stage"] = stage_now
        logger.log(
            step, eval_stage=stage_now, pdj_at_05_wrist_elbow=ev["pdj_at_05_wrist_elbow"],
            **{f"pdj05/{k}": v for k, v in ev["pdj_at_05"].items()},
        )
        heartbeat.beat(step)  # an eval blocks the loop
        return ev

    def take_step(stage: str, step: int):
        return step_fns[stage](state, train_ds.get_batch(indices_for_step(step)))

    def counted_step(stage: str, step: int):
        """The step under ``perf.count_cost``, logged as the reference's
        per-stage cost record: what the step (its batch generated on the
        card included) reads, writes and multiplies, per image, and the
        images per second the card's peaks would allow for it."""
        with count_cost() as cost:
            out = take_step(stage, step)
        per_img_flops, per_img_bytes = cost.flops / t.batch_size, cost.bytes / t.batch_size
        logger.log(
            step, stage=stage, steps_per_dispatch=1,
            train_step_gflops_per_image=per_img_flops / 1e9,
            train_step_mb_per_image=per_img_bytes / 1e6,
            roofline_images_per_sec=roofline_images_per_sec(per_img_flops, per_img_bytes),
        )
        return out

    # A trace of a window after the run's first steps (cuDNN's algorithm
    # choice and the kernel builds stay out of it).
    profiler = (ProfilerHook(workdir, start_step=start_step + 5, num_steps=profile_steps)
                if profile_steps > 0 else None)
    costed: set[str] = set()  # stages whose cost was logged (on CUDA only)

    def now() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.time()

    step = start_step
    t_last, n_last = now(), step
    final_eval: dict = {}
    # SIGTERM -> checkpoint at the next step boundary and exit EXIT_PREEMPTED,
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
                if save_figures:
                    from jointpose_torch.visualize import save_prior_grid

                    save_prior_grid(np.asarray(priors), f"{workdir}/figures/priors.png")
            run = take_step
            if device.type == "cuda" and stage not in costed:
                costed.add(stage)
                run = counted_step
            if profiler is not None:
                profiler.on_step(step)
                with profiler.annotation(step):
                    state, metrics = run(stage, step)
            else:
                state, metrics = run(stage, step)
            step += 1
            heartbeat.beat(step)
            maybe_inject_fault(workdir, step)
            if preemption.preempted:
                if ckpt.latest_step() != step:  # an eval may have saved this step
                    ckpt.save(step, state)
                logger.log(step, preempted=True)
                logger.close()
                ckpt.close()
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
    if profiler is not None:
        profiler.close()  # write a trace still open at the loop's end

    if final_eval and save_figures:
        from jointpose_torch.ops.heatmaps import model_probs
        from jointpose_torch.visualize import save_heatmap_overlays, save_pdj_curves

        save_pdj_curves(final_eval, f"{workdir}/figures/pdj_curves.png")
        batch = test_ds.get_batch(np.arange(4))
        with torch.inference_mode():
            probs = model_probs(model(batch["image"].to(device)))
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
                        help="accepted for the reference's command lines; one step per call here")
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
                        help="trace N train steps with torch.profiler into <workdir>/profile")
    parser.add_argument("--check-numerics", action="store_true",
                        help="torch.autograd.set_detect_anomaly: fail at the op that made a NaN")
    parser.add_argument("--mesh-data", type=int, default=None,
                        help="data-parallel devices; -1 (all), 0 and 1 mean the one device, "
                             "larger meshes are not ported yet (ROADMAP.md)")
    parser.add_argument("--mesh-model", type=int, default=None,
                        help="model-axis devices; only 1 (ROADMAP.md)")
    parser.add_argument("--mesh-spatial", action="store_true", help="not ported yet (ROADMAP.md)")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    refuse_unported([
        ("--mesh-data", args.mesh_data not in (None, -1, 0, 1)),
        ("--mesh-model", args.mesh_model not in (None, 1)), ("--mesh-spatial", args.mesh_spatial),
    ])
    device = apply_device(args.device)
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

    result = fit(config, args.workdir, eval_max_batches=args.eval_max_batches,
                 resume=args.resume, profile_steps=args.profile_steps, device=device,
                 save_figures=args.figures)
    print("final:", {k: v for k, v in result.metrics.items() if k != "pdj_curves"})


if __name__ == "__main__":
    main()
