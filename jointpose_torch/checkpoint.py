"""Checkpoint and resume (counterpart of ``jointpose/checkpoint.py``) on
``torch.save`` / ``torch.load``.

Two directories back the lifecycle, as in the reference:

- ``latest/<step>/``: the last ``keep`` checkpoints, whatever their
  metrics: what a resume continues from.
- ``best/<step>/``: the one checkpoint with the highest
  ``pdj_at_05_wrist_elbow`` among those saved with metrics: what serving
  restores.  Its ``metrics.json`` holds the scalar metrics.

A checkpoint is one file ``state.pt`` holding the model's ``state_dict``,
the optimizer's, the step and the augmentation generator's state, device
and seed (a state restored on another kind of device reseeds there).  It is
written under a temporary name and renamed, so a crash never leaves a
half-written step directory.  ``run_config.json`` beside the two
directories records the run's config with the reference's keys, so the
reference's ``load_run_metadata`` reads a directory written here.  The
reference's legacy single-directory layout is not read.

In a run of several processes (``torch.distributed``) rank 0 writes and a
barrier follows each save, so that no rank goes on (or resumes) before the
checkpoint is whole; every rank restores the same file.  The state is
replicated on every rank (``parallel/mesh.py``), so the file is the one
a single device writes and reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import torch

RUN_METADATA_FILE = "run_config.json"
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
BEST_METRIC = "pdj_at_05_wrist_elbow"


def load_run_metadata(directory: str) -> dict | None:
    """The saving run's recorded config, or None.  A corrupt file also
    returns None, with a warning: the metadata is a safety net, and an
    unreadable net must not block every entry point."""
    path = os.path.join(os.path.abspath(directory), RUN_METADATA_FILE)
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return None
    except ValueError:  # includes json.JSONDecodeError
        print(f"[checkpoint] WARNING: unreadable {path}; ignoring metadata")
        return None


def reconcile_config(config, checkpoint_dir: str, pool_mode: str | None = None):
    """Resolve the architecture-mode config for restoring a checkpoint.

    The trunk's pool_mode changes behaviour but not parameter shapes, so a
    mismatched restore succeeds and silently mis-evaluates.  Priority:
    explicit override > recorded checkpoint metadata > preset default; an
    override that contradicts the recorded mode is an error, and the
    recorded mode corrects a drifted preset default (with a notice).  A
    ``head_conv_impl`` of 'auto' is pinned to what the training run
    resolved it to.
    """
    from jointpose_torch.configs import with_pool_mode

    meta = load_run_metadata(checkpoint_dir) or {}
    recorded = meta.get("pool_mode")
    if pool_mode is not None:
        if recorded is not None and recorded != pool_mode:
            raise ValueError(
                f"pool_mode {pool_mode!r} contradicts the checkpoint's recorded trunk mode "
                f"{recorded!r} ({checkpoint_dir}); the modes share param shapes, so overriding "
                "would restore cleanly and silently mis-evaluate"
            )
        config = with_pool_mode(config, pool_mode)
    elif recorded is not None and recorded != config.detector.pool_mode:
        print(f"[checkpoint] adopting recorded pool_mode={recorded!r} "
              f"(preset default {config.detector.pool_mode!r})")
        config = with_pool_mode(config, recorded)
    impl = meta.get("head_conv_impl_resolved")
    if impl is not None and config.detector.head_conv_impl == "auto":
        print(f"[checkpoint] pinning head_conv_impl={impl!r} (resolved at training)")
        config = config.replace(
            detector=dataclasses.replace(config.detector, head_conv_impl=impl)
        )
    return config


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit())


class Checkpointer:
    """Saves and restores a ``train.TrainState``.

    Pass ``config`` from training runs: the first save records it as
    ``run_config.json``, and a resume whose pool_mode contradicts the
    recorded one fails fast instead of training another network on the
    restored weights.
    """

    def __init__(self, directory: str, keep: int = 3, config=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._config = config
        self._meta_written = False
        self._latest = os.path.join(self.directory, "latest")
        self._best = os.path.join(self.directory, "best")
        if config is not None:
            recorded = (load_run_metadata(self.directory) or {}).get("pool_mode")
            if recorded is not None and recorded != config.detector.pool_mode:
                raise ValueError(
                    f"checkpoint dir {self.directory} was written with pool_mode={recorded!r} "
                    f"but this run uses {config.detector.pool_mode!r}; pass --pool-mode "
                    f"{recorded} (param shapes match, behavior doesn't)"
                )

    def _write_metadata(self) -> None:
        from jointpose_torch.models.detector import resolve_head_conv_impl

        # (Over)written once per run: the run writing checkpoints is the
        # source of truth for what the weights match.
        self._meta_written = True
        meta = {
            "config_name": self._config.name,
            "pool_mode": self._config.detector.pool_mode,
            "head_conv_impl_resolved": resolve_head_conv_impl(self._config.detector),
            "config": dataclasses.asdict(self._config),
        }
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, RUN_METADATA_FILE)
        with open(path + ".tmp", "w") as f:
            json.dump(meta, f, indent=1, default=str)
        os.replace(path + ".tmp", path)

    @staticmethod
    def _publish(tmp: str, final: str) -> None:
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    def save(self, step: int, state: Any, metrics: dict | None = None) -> None:
        """Write ``latest/<step>`` and prune to ``keep``; with scalar
        ``metrics`` also ``best/<step>`` if its ``pdj_at_05_wrist_elbow``
        (0 when absent) is no lower than the kept best's.  Every rank of a
        process group calls it: rank 0 writes, then all meet at a barrier."""
        import torch.distributed as dist

        if not dist.is_initialized():
            self._save(step, state, metrics)
            return
        if dist.get_rank() == 0:
            self._save(step, state, metrics)
        dist.barrier()

    def _save(self, step: int, state: Any, metrics: dict | None) -> None:
        if self._config is not None and not self._meta_written:
            self._write_metadata()
        metrics = {
            k: float(v) for k, v in (metrics or {}).items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(step),
            "generator": state.generator.get_state(),
            "generator_device": state.generator.device.type,
            "generator_seed": state.generator.initial_seed(),
        }
        os.makedirs(self._latest, exist_ok=True)
        tmp = os.path.join(self._latest, f".tmp-{step}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        final = os.path.join(self._latest, str(step))
        self._publish(tmp, final)
        for old in _steps(self._latest)[: -self.keep]:
            shutil.rmtree(os.path.join(self._latest, str(old)))
        if not metrics:
            return
        kept = self.best_step()
        if kept is not None and kept != step:
            with open(os.path.join(self._best, str(kept), METRICS_FILE)) as f:
                if json.load(f).get(BEST_METRIC, 0.0) > metrics.get(BEST_METRIC, 0.0):
                    return
        os.makedirs(self._best, exist_ok=True)
        tmp = os.path.join(self._best, f".tmp-{step}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        shutil.copyfile(os.path.join(final, STATE_FILE), os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump(metrics, f, indent=1)
        self._publish(tmp, os.path.join(self._best, str(step)))
        for old in _steps(self._best):
            if old != step:
                shutil.rmtree(os.path.join(self._best, str(old)))

    def latest_step(self) -> int | None:
        steps = _steps(self._latest)
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        steps = _steps(self._best)
        return steps[-1] if steps else None

    def _load(self, step: int | None, map_location) -> dict:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        root = self._latest if step in _steps(self._latest) else self._best
        path = os.path.join(root, str(step), STATE_FILE)
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore(self, state: Any, step: int | None = None) -> Any:
        """Load a checkpoint into ``state`` (model, optimizer, step and
        generator), in place, on the state's device.  ``step=None`` takes
        the latest; an explicit step is looked up under ``latest/`` first,
        then ``best/``."""
        device = next(state.model.parameters()).device
        payload = self._load(step, device)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        device_kind = state.generator.device.type
        if payload.get("generator_device", device_kind) == device_kind:
            state.generator.set_state(payload["generator"].cpu())
        else:
            # A generator's state is its device's engine (the CPU's Mersenne
            # twister, CUDA's Philox counter) and cannot cross: the stream
            # starts again from the saved generator's seed, which is exact
            # for a step-0 checkpoint (convert.write_initial_checkpoint).
            state.generator.manual_seed(payload["generator_seed"])
        return state

    def restore_subtree(self, names: tuple[str, ...] = ("model",), step: int | None = None,
                        map_location="cpu") -> dict:
        """The named entries of a checkpoint ('model', 'optimizer', 'step',
        'generator') without a state to load them into: inference restores
        the weights without rebuilding the saving run's optimizer."""
        payload = self._load(step, map_location)
        return {name: payload[name] for name in names}

    def close(self) -> None:
        """Nothing is held open; kept for the reference's call sites."""
