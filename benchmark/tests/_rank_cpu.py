"""One rank of a multi-rank loop on the CPU, for the tests, started by
``harness/ranks.launch``: ``_rank_cpu.py <cell.json> <seed> <seconds> <fault> <rank dir>``;
the fault ``no_exchange`` leaves out the gradient sums between ranks, and
``jax_in_rank_1`` puts a module named ``jax`` among rank 1's loaded modules."""

import json
import os
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from benchmark.harness import ranks, spec  # noqa: E402

cell_file, seed, seconds, fault, rank_dir = sys.argv[1:]
if fault == "no_exchange":
    from jointpose_torch.parallel.mesh import Mesh

    Mesh.all_reduce_flat = lambda self, tensors, axis=None: None
cell = spec.Cell(**json.loads(Path(cell_file).read_text()))
loop = spec.loop_module(cell.traffic["loop"])
result = loop.run(cell, int(seed), float(seconds), False, device="cpu")
if fault == "jax_in_rank_1" and os.environ["RANK"] == "1":
    sys.modules["jax"] = types.ModuleType("jax")
ranks.save_rank(result, rank_dir)
