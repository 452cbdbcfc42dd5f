"""``jointpose_torch.metrics`` against ``jointpose/metrics.py``: the
MetricLogger's records, ``enabled=False`` and ``use_tensorboard``; and
``ProfilerHook`` through ``fit(profile_steps=...)`` on the CPU, whose
trace under ``<workdir>/profile/`` holds the annotated steps
``start_step + 5`` onwards."""

import dataclasses
import glob
import json
import os

import torch

from jointpose import metrics as jax_metrics
from jointpose_torch import get_config, metrics
from jointpose_torch import train as ttrain
from jointpose_torch.devtime import parse_trace


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metric_logger_writes_the_references_records(tmp_path, capsys):
    for name, module in (("jax", jax_metrics), ("torch", metrics)):
        logger = module.MetricLogger(str(tmp_path / name), use_tensorboard=True)
        logger.log(3, loss=torch.tensor(0.5) if name == "torch" else 0.5, stage="joint", n=2)
        logger.close()
    want, got = _read(tmp_path / "jax" / "metrics.jsonl"), _read(tmp_path / "torch" / "metrics.jsonl")
    assert [{k: v for k, v in r.items() if k != "time"} for r in got] == [
        {k: v for k, v in r.items() if k != "time"} for r in want] == [
        {"step": 3, "loss": 0.5, "stage": "joint", "n": 2.0}]
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "[step 3] loss=0.5, n=2"


def test_a_disabled_logger_writes_nothing(tmp_path, capsys):
    logger = metrics.MetricLogger(str(tmp_path / "off"), enabled=False)
    logger.log(1, loss=1.0)
    logger.close()
    assert logger.path is None and not os.path.exists(tmp_path / "off")
    assert capsys.readouterr().out == ""


def test_fit_traces_the_profiled_steps(tmp_path):
    cfg = get_config("tiny")
    cfg = cfg.replace(
        augment=dataclasses.replace(cfg.augment, enabled=False),
        train=dataclasses.replace(cfg.train, detector_steps=4, joint_steps=4, eval_every=8,
                                  log_every=8))
    ttrain.fit(cfg, str(tmp_path), eval_max_batches=1, profile_steps=2, device="cpu")
    (path,) = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("train#"))
    assert steps == ["train#5", "train#6"]
    assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::convolution" for e in events)
    assert parse_trace(str(tmp_path / "profile"), "train") is None  # no device on the CPU


def test_a_window_past_the_end_is_written_at_close(tmp_path):
    hook = metrics.ProfilerHook(str(tmp_path), start_step=1, num_steps=10)
    for step in range(3):
        hook.on_step(step)
        with hook.annotation(step):
            torch.ones(3).sum()
    hook.close()
    hook.close()  # a second close writes nothing more
    (path,) = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train#1", "train#2"} <= names and "train#0" not in names
