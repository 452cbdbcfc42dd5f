"""The card a run uses, and what a run must refuse to do."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "jointpose")


def require_cards(n: int) -> None:
    """Exit non-zero, printing no result, unless CUDA has ``n`` cards: a
    measurement never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("benchmark: no CUDA device (torch.cuda.is_available() is False); "
                 "this benchmark measures the card and does not run on the CPU")
    if torch.cuda.device_count() < n:
        sys.exit(f"benchmark: the cell needs {n} CUDA devices, torch.cuda.device_count() is "
                 f"{torch.cuda.device_count()}")


def power_limit(index: int = 0) -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or 'unknown'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def describe(count: int, memory_peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes)}


def device_line(count: int) -> str:
    import torch

    return (f"device: {torch.cuda.get_device_name(0)} x{count} "
            f"(torch.cuda.device_count() {torch.cuda.device_count()}), power limit {power_limit()}")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name (before the first
    dot, compared whole) is JAX's, its libraries' or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})
