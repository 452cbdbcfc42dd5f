"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root, and the
files it names, found by name.

- a cell is an entry of ``workloads``;
- its configuration is the file that the ``configs`` entry of its
  ``config`` names (``benchmark/configs/<name>.json``);
- its traffic mix is ``benchmark/traffic/<traffic>.json``;
- the limits of its correctness comparison are ``benchmark/limits/<cell>.json``;
- a per-layer metric is ``benchmark/metrics/<name>.py`` with a
  ``read(ctx)`` function;
- the loop a traffic mix names (``"loop"``) is ``benchmark/loops/<loop>.py``.

A new cell needs only new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict
    limits: dict
    end_to_end: list[dict]  # the end-to-end metrics this cell reports
    per_layer: list[dict]  # the per-layer metrics this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with everything it names
    loaded; raises KeyError naming what is missing."""
    spec = spec if spec is not None else load_json(SPEC_FILE)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _reports(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=layer)


def _module(path: Path, name: str):
    if not path.is_file():
        raise KeyError(f"no file {path.relative_to(ROOT)} for {name!r}")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    return _module(BENCH_DIR / "metrics" / f"{name}.py", name).read


def loop_module(name: str):
    """``benchmark/loops/<name>.py``: its ``run(cell, seed, seconds, trace)``
    drives one process; a loop of several ranks also has ``combine``."""
    return _module(BENCH_DIR / "loops" / f"{name}.py", name)


def port_config(config_file: dict):
    """The program's ``Config`` for a configuration file: the preset it
    names, every value of its ``config`` set on it, and checked to be the
    file's configuration whole."""
    from jointpose_torch.configs import get_config

    cfg = get_config(config_file["preset"])
    cfg = _replaced(cfg, config_file["config"])
    got = json.loads(json.dumps(dataclasses.asdict(cfg)))
    if got != config_file["config"]:
        diff = sorted(k for k in set(got) | set(config_file["config"])
                      if got.get(k) != config_file["config"].get(k))
        raise ValueError(f"configuration file and program disagree on {diff}")
    return cfg


def _replaced(obj, values: dict):
    changes = {}
    for f in dataclasses.fields(obj):
        if f.name not in values:
            continue
        cur, new = getattr(obj, f.name), values[f.name]
        if dataclasses.is_dataclass(cur) and isinstance(new, dict):
            changes[f.name] = _replaced(cur, new)
        elif isinstance(cur, tuple):
            changes[f.name] = tuple(new)
        else:
            changes[f.name] = new
    return dataclasses.replace(obj, **changes)
