"""Cells of several processes, a card each: ``torch.distributed.run``
starts ``world`` copies of a script (``run.py`` with ``--rank-dir``) on this
machine (``--standalone``: its rendezvous on a free localhost port), and
ends them all when one fails.  Each rank writes its result to
``<rank dir>/rank<r>.pt`` with the modules of JAX, its libraries or the
JAX package found loaded in it once its window closed (``forbidden``)."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from benchmark.harness import device

RANK_TIMEOUT_S = 330


def run_py_command(cell, args) -> list[str]:
    run_py = Path(__file__).resolve().parent.parent / "run.py"
    return [str(run_py), "--workload", cell.name, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace), "--rank-dir"]


def launch(script_and_args: list[str], world: int, timeout_s: float = RANK_TIMEOUT_S) -> list:
    """Run ``script_and_args + [rank dir]`` as ``world`` ranks; their results."""
    with tempfile.TemporaryDirectory(prefix="bench_ranks_") as tmp:
        launcher = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    f"--nproc-per-node={world}", *script_and_args, tmp]
        proc = subprocess.Popen(launcher)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.terminate()  # the launcher ends its ranks, then itself
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            raise RuntimeError(f"the ranks did not end within {timeout_s} s") from None
        if rc != 0:
            raise RuntimeError(f"the ranks' launcher exited {rc}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def save_rank(result, rank_dir: str) -> None:
    """Write this rank's ``result`` with the forbidden modules loaded in it."""
    torch.save({"result": result, "forbidden": device.forbidden_modules()},
               os.path.join(rank_dir, f"rank{os.environ['RANK']}.pt"))


def forbidden(saved: list[dict]) -> list[str]:
    """The forbidden modules any rank found loaded."""
    return sorted({name for s in saved for name in s["forbidden"]})


def results(saved: list[dict]) -> list:
    return [s["result"] for s in saved]
