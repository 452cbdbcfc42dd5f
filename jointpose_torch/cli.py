"""Shared plumbing of the entry points (counterpart of ``jointpose/cli.py``).

Every CLI of the port (train, evaluate, predict, serve, quantize) takes
``--device``: the CUDA card by default, ``cpu`` to run the kernels'
plain versions without one.  ``apply_device`` resolves it right after
the arguments are parsed, so that a CUDA run on a machine without CUDA
fails before any work, naming ``--device cpu``; on the card it also
settles where the kernels are built (``enable_compilation_cache``).
"""

from __future__ import annotations

import os

DEVICE_HELP = "'cpu' runs the kernels' plain versions; default: the CUDA device"


def enable_compilation_cache() -> str | None:
    """The directory the CUDA kernels are built into and reused from
    (``_build.build_dir()``: content-hashed libraries, so a warm restart
    skips ``nvcc``), created; None when ``JOINTPOSE_NO_COMPILE_CACHE`` is
    set, which builds into a fresh temporary directory per process.
    ``JOINTPOSE_CACHE_DIR`` moves it, for a package directory that is
    read-only; the default is ``build/jointpose_torch/`` at the
    repository root."""
    from jointpose_torch import _build

    if os.environ.get("JOINTPOSE_NO_COMPILE_CACHE"):
        return None
    path = _build.build_dir()
    path.mkdir(parents=True, exist_ok=True)
    return str(path)


def add_device_flag(parser, help: str = DEVICE_HELP) -> None:
    parser.add_argument("--device", default=None, help=help)


def apply_device(device: str | None):
    """Resolve ``--device`` before any work: the ``torch.device`` to run
    on.  Raises when CUDA is asked for (the default) and absent."""
    from jointpose_torch.predict import resolve_device

    resolved = resolve_device(device)
    if resolved.type == "cuda":
        enable_compilation_cache()
    return resolved
