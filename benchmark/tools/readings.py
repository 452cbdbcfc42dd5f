"""The readings a cell's limits are set from, on the card at the cell's own
sizes, in one process: the program's numbers over several seeds (short
windows of the cell's own loop), and the lower-precision control's (the
reference one precision step lower in the program's place) over a few.

    python benchmark/tools/readings.py --workload flagship.offline_b128 \\
        --first-seed 1000 --seeds 12 --controls 3 --seconds 1

Prints one JSON line per reading and writes them to ``--out`` if given.
A cell of several ranks runs them as processes, each going through the
seeds in turn (``--rank-dir``, given by ``harness/ranks.py``); the parent
combines each seed's results and plants the faults in the reference.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import ranks, spec  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    p.add_argument("--rank-dir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    cell = spec.find_cell(args.workload)
    loop = spec.loop_module(cell.traffic["loop"])
    seeds = [args.first_seed + i for i in range(args.seeds)]
    world = int(cell.traffic.get("ranks", 1))
    if args.rank_dir is not None:  # one rank: every seed's run, in turn
        ranks.save_rank([loop.run(cell, s, args.seconds, False) for s in seeds], args.rank_dir)
        return
    if world > 1:
        saved = ranks.launch([__file__, *sys.argv[1:], "--rank-dir"], world,
                             timeout_s=120 * len(seeds) + 300)
        if ranks.forbidden(saved):
            sys.exit(f"modules of JAX or the JAX package were loaded: {ranks.forbidden(saved)}")
        per_rank = ranks.results(saved)
        by_seed = {s: loop.combine(cell, s, [r[i] for r in per_rank], "cuda")
                   for i, s in enumerate(seeds)}
    lines = []
    for i, seed in enumerate(seeds):
        if world > 1:
            found = [("program", {k: v for k, v in by_seed[seed]["numbers"].items()
                                  if isinstance(v, float)})]
            found += list(loop.faults(cell, seed, "cuda")) if i < args.controls else []
        else:
            found = loop.readings(cell, seed, args.seconds, control=i < args.controls)
        for kind, numbers in found:
            line = {"workload": cell.name, "seed": seed, "kind": kind, "numbers": numbers}
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
