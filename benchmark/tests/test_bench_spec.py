"""The benchmark is data: every cell, configuration, traffic mix, limit and
metric is found by its name, and ``BENCHMARK.json`` keeps to its contract."""

import json
import re

import pytest

from benchmark.harness import spec

SPEC = spec.load_json(spec.SPEC_FILE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    c = spec.find_cell(cell)
    assert c.config["preset"] in ("flagship", "joint")
    assert spec.loop_module(c.traffic["loop"]).run
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert all(m["moves"] in names for m in c.per_layer)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_each_configuration_file_is_the_program_config_it_runs(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    doc = spec.load_json(spec.ROOT / entry["file"])
    cfg = spec.port_config(doc)
    assert cfg.name == doc["preset"] and cfg.mrf.precision == "default"
    assert entry["reduced"] == doc["reduced"] == []


def test_an_unknown_cell_is_named_in_the_error():
    with pytest.raises(KeyError, match="no workload 'nope'"):
        spec.find_cell("nope")


def test_the_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["command"][0] == "python3" and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[key]}) == len(SPEC[key])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (spec.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_metric_file_is_named_in_the_spec():
    files = {p.stem for p in (spec.BENCH_DIR / "metrics").glob("*.py")}
    assert files == {m["name"] for m in SPEC["per_layer"]}
