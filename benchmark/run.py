"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found by
name from ``BENCHMARK.json`` (``harness/spec.py``); the traffic names the
loop that drives the program (``loops/<loop>.py``).  With ``--trace 0`` the
result holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a traced slice of the window.  The last line
of standard output is one JSON object; the numbers that decided
``correct`` end it and end standard error, each beside its limit.

Exits non-zero, printing no result, without the CUDA cards the cell asks
for, or if JAX, its libraries or the JAX package were loaded in this
process or, in a cell of several ranks, in any rank.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import device, judge, ranks, spec, trace  # noqa: E402


def _finite(x: float) -> float:
    return x if math.isfinite(x) else (sys.float_info.max if x > 0 else -sys.float_info.max)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=[0, 1], default=0)
    parser.add_argument("--rank-dir", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    cell = spec.find_cell(args.workload)
    device.require_cards(cell.chips)
    loop = spec.loop_module(cell.traffic["loop"])
    world = int(cell.traffic.get("ranks", 1))
    if args.rank_dir is not None:  # one rank of a multi-process cell
        ranks.save_rank(loop.run(cell, args.seed, args.seconds, bool(args.trace)), args.rank_dir)
        return
    found: list[str] = []
    if world > 1:
        saved = ranks.launch(ranks.run_py_command(cell, args), world)
        found = ranks.forbidden(saved)
        result = loop.combine(cell, args.seed, ranks.results(saved), "cuda")
    else:
        result = loop.run(cell, args.seed, args.seconds, bool(args.trace))
    found = sorted(set(found) | set(device.forbidden_modules()))
    if found:
        sys.exit(f"benchmark: modules of JAX or the JAX package were loaded: {found}")

    correct, shown = judge.verdict(result["numbers"], cell.limits)
    metrics = {}
    if args.trace:
        ctx = {"config": cell.config["config"], "traffic": cell.traffic, "chips": cell.chips,
               "counts": result["counts"], "traces": result["traces"]}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = result["window_start"] - T0 if m["name"] == "setup_s" else result["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device.describe(cell.chips, result["memory_peak_bytes"])
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dev}
    if args.trace:
        traces = result["traces"]
        dev["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        dev["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        ops: dict[str, float] = {}
        gaps: dict[str, float] = {}
        for t in traces:
            for name, (_, s) in t["ops"].items():
                ops[name] = ops.get(name, 0.0) + s / len(traces)
            for name, s in t["gaps"].items():
                gaps[name] = gaps.get(name, 0.0) + s / len(traces)
        line["breakdown"] = {"device_ops": trace.top(ops), "idle_gaps": trace.top(gaps)}
    line["compared"] = {k: [_finite(v), lim] for k, (v, lim) in shown.items()}
    print(device.device_line(cell.chips), file=sys.stderr)
    for note in result.get("notes", []):
        print(note, file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr)
    for k, (v, lim) in shown.items():
        print(f"  {k} {v:.6g} limit {lim:.6g}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
