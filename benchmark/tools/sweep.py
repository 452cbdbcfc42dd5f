"""Find the knee of an open-loop serving cell on the card: the highest rate
at which the p95 latency stays within the traffic file's
``latency_limit_ms`` and the backlog does not grow.  One service, set up once, driven at each rate in turn.

    python benchmark/tools/sweep.py --workload joint.serve_open --seed 7 \\
        --rates 150,200,250,300 --seconds 20 --repeats 2

A backlog grows when the last third of a window's requests wait longer
than the first third (their p50 more than 1.5x, and by more than 10 ms).
Prints one JSON line per rate.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec, stats  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--repeats", type=int, default=1, help="windows a rate, each on its own seed")
    args = p.parse_args()
    cell = spec.find_cell(args.workload)
    loop = spec.loop_module(cell.traffic["loop"])
    limit_ms = cell.traffic["latency_limit_ms"]
    _, _, pool_np, service = loop._setup(cell, args.seed, "cuda", False)
    try:
        for rate, rep in ((float(r), k) for r in args.rates.split(",") for k in range(args.repeats)):
            res = loop.open_loop(service, pool_np, cell.traffic, rate, args.seconds, args.seed + rep)
            lat = res["latencies_ms"]
            third = max(len(lat) // 3, 1)
            head, tail = stats.percentile(lat[:third], 50), stats.percentile(lat[-third:], 50)
            growing = tail > 1.5 * head and tail - head > 10.0
            p95 = stats.percentile(lat, 95)
            print(json.dumps({
                "rate": rate, "seed": args.seed + rep, "p50_ms": float(stats.percentile(lat, 50)), "p95_ms": float(p95),
                "first_third_p50_ms": float(head), "last_third_p50_ms": float(tail), "backlog_grows": bool(growing),
                "failed": res["failed"], "attempted": res["attempted"],
                "images_per_dispatch": res["stats"]["images"] / max(res["stats"]["dispatches"], 1),
                "lateness_ms": res["lateness_ms"],
                "sustained": bool(p95 <= limit_ms and not growing and res["failed"] == 0),
            }), flush=True)
    finally:
        service.close()


if __name__ == "__main__":
    main()
