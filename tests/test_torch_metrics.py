"""``jointpose_torch.metrics`` against ``jointpose/metrics.py``: the
MetricLogger's records, ``enabled=False`` and ``use_tensorboard``;
``ProfilerHook`` through ``fit(profile_steps=...)`` on the CPU, whose
trace under ``<workdir>/profile/`` holds whole dispatches from the one
that holds step ``start_step + 5``; and the program's spans
(``metrics.span``) in the predictor and the K-step dispatch, which cost
no ``record_function`` with no profiler collecting; off the card the
predictor's call stays eager (its graph form is held on the card, in
``test_torch_kernels_cuda.py``)."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jointpose import metrics as jax_metrics
from jointpose_torch import get_config, metrics
from jointpose_torch import train as ttrain
from jointpose_torch.data.pipeline import make_dataset
from jointpose_torch.devtime import parse_trace
from jointpose_torch.parallel.mesh import make_device_mesh
from jointpose_torch.predict import build_predictor, init_state_dict


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
    ranges = [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
              if e.get("cat") == "user_annotation"]
    # Whole dispatches: steps 4-7 (one dispatch, eager on the CPU) hold step 5.
    assert [r for r in ranges if r.startswith("train#")] == ["train#4"]
    assert {"jointpose/dispatch.prepare", "jointpose/dispatch.rates"} <= set(ranges)
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


def _spans(prof, tmp_path):
    """The trace's ``jointpose/`` ranges as (name, start, end), by start."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"][len(metrics.SPAN_PREFIX):], e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(metrics.SPAN_PREFIX)), key=lambda s: s[1])


def _flat(spans):
    return all(end <= nxt for (_, _, end), (_, nxt, _) in zip(spans, spans[1:]))


def _tiny_predictor(mesh=None):
    cfg = get_config("tiny").replace(eval_flip_tta=False)
    predict = build_predictor(cfg, init_state_dict(cfg, torch.Generator().manual_seed(0)), "cpu",
                              mesh=mesh)
    images = torch.randint(0, 256, (2, *cfg.data.image_hw, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    return predict, images


def test_the_predictor_opens_its_four_spans_in_turn(tmp_path):
    predict, images = _tiny_predictor()
    predict(images)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            predict(images)
    spans = _spans(prof, tmp_path)
    assert [name for name, _, _ in spans] == ["input", "detector", "mrf", "decode"] * 2
    assert _flat(spans)  # none inside another


@pytest.mark.parametrize("data", [0, 2], ids=["one_device", "device_mesh"])
def test_off_the_card_the_predictor_stays_eager(tmp_path, data):
    """On the CPU, and over a device mesh, no graph engages: no capture, no
    replay, the eager call's spans (a mesh row's model opens its own), and
    each call returns tensors of its own."""
    predict, images = _tiny_predictor(make_device_mesh(data, 1, "cpu") if data else None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = predict(images)
        second = predict(images)
    assert not predict.graphs.enabled
    assert predict.graphs.captures == predict.graphs.replays == 0
    model_spans = ["detector", "mrf"] * max(data, 1)
    assert [name for name, _, _ in _spans(prof, tmp_path)] == (
        ["input", *model_spans, "decode"] * 2)
    for a, b in zip(first, second):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


def test_an_eager_dispatch_opens_its_copy_and_rate_spans(tmp_path):
    cfg = get_config("tiny")
    train_ds, _ = make_dataset(cfg.data, "cpu")
    state = ttrain.create_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = cfg.train.batch_size
    batches = {k: v.reshape(2, b, *v.shape[1:])
               for k, v in train_ds.get_batch(np.arange(2 * b)).items()}
    multi = ttrain.make_train_multistep_arrays(cfg, "joint", 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        multi(state, batches)
    spans = _spans(prof, tmp_path)
    assert [name for name, _, _ in spans] == [
        "dispatch.prepare", "dispatch.rates"] + ["detector", "mrf"] * 2
    assert _flat(spans)


def test_without_a_profiler_a_span_enters_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(metrics, "record_function", lambda name: entered.append(name))
    assert metrics.span("input") is metrics.span("mrf") is metrics._NO_SPAN
    predict, images = _tiny_predictor()
    predict(images)
    assert entered == []


def test_the_window_opens_at_a_settled_dispatch_and_holds_whole_ones(tmp_path):
    """The hook starts at the first dispatch, holding ``start_step`` or a
    later step, that the loop calls ready, and stops at the first boundary
    ``num_steps`` past its start; ``DispatchGraphs.replays`` says whether
    a dispatch would replay a graph captured before it."""
    hook = metrics.ProfilerHook(str(tmp_path), start_step=5, num_steps=12)
    opened = []
    for step, ready in ((0, True), (10, False), (20, True), (30, True), (40, True)):
        hook.on_step(step, 10, ready)
        opened.append(hook._prof is not None)
        with hook.annotation(step):
            torch.ones(3).sum()
    assert opened == [True, True, False, False, False] and hook.stop_step == 12
    hook = metrics.ProfilerHook(str(tmp_path / "late"), start_step=5, num_steps=12)
    opened = []
    for step, ready in ((0, False), (10, False), (20, True), (30, True), (40, True)):
        hook.on_step(step, 10, ready)
        opened.append(hook._prof is not None)
    assert opened == [False, False, True, True, False] and hook.stop_step == 32

    cfg = get_config("tiny")
    state = ttrain.create_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    graphs, key = ttrain.DispatchGraphs(), object()
    assert not graphs.replays(key, state)
    graphs.graphs[key], graphs.anchors = object(), ttrain._graph_anchors(state)
    assert graphs.replays(key, state) and not graphs.replays(object(), state)
    first = next(state.model.parameters())
    first.data = first.data.clone()  # what the graph reads in place was replaced
    assert not graphs.replays(key, state)
