"""The K-step dispatch (``train.make_train_multistep``,
``make_train_multistep_arrays`` and ``fit``'s chunking) on the CPU at the
``tiny`` preset: K steps in one dispatch against K calls of
``make_train_step``, bit for bit (parameters, the optimizer's state, the
generator, the last step's metrics), and ``fit`` at steps_per_dispatch 4
against 1.  On the CPU a dispatch is the eager form (``graph_dispatch``);
the graph form's equality with eager steps is held on the card
(``chip_smoke.py``'s kstep phase).  The reference's ``fit`` at the same K
is held in ``tests/test_torch_orbax_tool.py``, beside the converter that
shares its run."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from jointpose_torch import get_config
from jointpose_torch import train as ttrain
from jointpose_torch.data.pipeline import make_dataset

from test_torch_pipeline import make_fake_flic


def _tiny(**train):
    c = get_config("tiny")
    return c.replace(
        augment=dataclasses.replace(c.augment, enabled=True),
        train=dataclasses.replace(c.train, **train),
    )


def _opt_state(state):
    return [v for p in state.model.parameters() for v in state.optimizer.state[p].values()]


def _assert_same(got, want, got_metrics, want_metrics):
    assert got.step == want.step
    for (name, p), q in zip(got.model.named_parameters(), want.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p.grad, q.grad), name
    moments = list(zip(_opt_state(got), _opt_state(want)))
    assert moments and all(torch.equal(torch.as_tensor(a), torch.as_tensor(b)) for a, b in moments)
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
    assert got_metrics.keys() == want_metrics.keys()
    assert all(torch.equal(got_metrics[k], want_metrics[k]) for k in want_metrics)


def _states(cfg):
    return [ttrain.create_state(cfg, torch.Generator().manual_seed(3), device="cpu")
            for _ in range(2)]


def _indices(cfg, first, k):
    b = cfg.train.batch_size
    return np.stack([np.arange(s * b, (s + 1) * b) for s in range(first, first + k)])


@pytest.mark.parametrize("freeze", [False, True], ids=["end_to_end", "frozen_detector"])
@pytest.mark.parametrize("optimizer", ["adamw", "momentum"])
def test_index_fed_dispatch_equals_single_steps(optimizer, freeze):
    cfg = _tiny(optimizer=optimizer, freeze_detector_in_joint=freeze, mrf_lr_mult=10.0,
                lr_schedule="cosine", detector_steps=2, joint_steps=4)
    train_ds, _ = make_dataset(cfg.data, "cpu")
    got, want = _states(cfg)
    idx = _indices(cfg, 0, 3)
    step = ttrain.make_train_step(cfg, "joint")
    for i in range(3):
        want, want_metrics = step(want, train_ds.get_batch(idx[i]))
    got, got_metrics = ttrain.make_train_multistep(cfg, "joint", train_ds.get_batch, 3)(got, idx)
    _assert_same(got, want, got_metrics, want_metrics)


def test_dispatches_across_a_stage_switch_equal_single_steps():
    cfg = _tiny(detector_steps=2, joint_steps=2, lr_schedule="cosine")
    train_ds, _ = make_dataset(cfg.data, "cpu")
    got, want = _states(cfg)
    idx = _indices(cfg, 0, 4)
    for i, stage in enumerate(("detector", "detector", "joint", "joint")):
        want, want_metrics = ttrain.make_train_step(cfg, stage)(want, train_ds.get_batch(idx[i]))
    for stage, rows in (("detector", idx[:2]), ("joint", idx[2:])):
        multi = ttrain.make_train_multistep(cfg, stage, train_ds.get_batch, 2)
        got, got_metrics = multi(got, torch.from_numpy(rows))
    assert "mrf_loss" in got_metrics
    _assert_same(got, want, got_metrics, want_metrics)


@pytest.mark.parametrize("optimizer", ["adamw", "momentum"])
def test_array_fed_dispatch_equals_single_steps(tmp_path, optimizer):
    make_fake_flic(str(tmp_path / "flic"), n_train=6, n_test=2)
    cfg = _tiny(optimizer=optimizer)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, source="flic", flic_dir=str(tmp_path / "flic"), train_size=6, test_size=2))
    train_ds, _ = make_dataset(cfg.data, "cpu")
    assert train_ds.host_resident
    got, want = _states(cfg)
    batches = [train_ds.get_batch(np.arange(i, i + cfg.train.batch_size) % 6) for i in range(3)]
    for stage, (lo, hi) in (("detector", (0, 1)), ("joint", (1, 3))):
        for b in batches[lo:hi]:
            want, want_metrics = ttrain.make_train_step(cfg, stage)(want, b)
        stacked = {key: torch.stack([b[key] for b in batches[lo:hi]]) for key in batches[0]}
        assert stacked["image"].dtype == torch.uint8
        got, got_metrics = ttrain.make_train_multistep_arrays(cfg, stage, hi - lo)(got, stacked)
    _assert_same(got, want, got_metrics, want_metrics)


def test_a_dispatch_checks_its_size():
    cfg = _tiny()
    train_ds, _ = make_dataset(cfg.data, "cpu")
    state, _ = _states(cfg)
    with pytest.raises(ValueError, match=r"\(3, rows\)"):
        ttrain.make_train_multistep(cfg, "joint", train_ds.get_batch, 3)(state, _indices(cfg, 0, 2))
    with pytest.raises(ValueError, match="lead with 2"):
        ttrain.make_train_multistep_arrays(cfg, "joint", 2)(state, train_ds.get_batch(np.arange(4)))
    with pytest.raises(ValueError, match="at least 1"):
        ttrain.make_train_multistep_arrays(cfg, "joint", 0)


def test_the_form_of_a_dispatch_is_a_rule():
    class Mesh:
        def __init__(self, size, backend=None):
            self.size, self.backend = size, backend

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert ttrain.graph_dispatch(cuda) and ttrain.graph_dispatch(cuda, Mesh(1))
    # A card a rank (nccl): the graph holds the collectives.  Ranks that
    # share a card (gloo) cannot be captured.
    assert ttrain.graph_dispatch(cuda, Mesh(2, "nccl")) and ttrain.graph_dispatch(cuda, Mesh(4, "nccl"))
    assert not ttrain.graph_dispatch(cuda, Mesh(2, "gloo"))
    assert not ttrain.graph_dispatch(cpu) and not ttrain.graph_dispatch(cpu, Mesh(2, "gloo"))
    with torch.autograd.set_detect_anomaly(True):
        assert not ttrain.graph_dispatch(cuda) and not ttrain.graph_dispatch(cuda, Mesh(2, "nccl"))
    assert ttrain.graph_dispatch(cuda)


def _records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_in_dispatches_of_4_equals_one_step_a_dispatch(tmp_path, monkeypatch):
    sizes = []
    made = ttrain.make_train_multistep

    def spy(config, stage, get_batch, k, mesh=None):
        multi = made(config, stage, get_batch, k, mesh)

        def counted(state, indices):
            sizes.append((stage, k))
            return multi(state, indices)

        return counted

    monkeypatch.setattr(ttrain, "make_train_multistep", spy)
    results = {}
    for k in (1, 4):
        cfg = _tiny(detector_steps=6, joint_steps=5, log_every=4, eval_every=4,
                    steps_per_dispatch=k)
        results[k] = ttrain.fit(cfg, str(tmp_path / str(k)), eval_max_batches=1, device="cpu")
    # Chunks end at the log/eval steps 4 and 8, the stage boundary 6 and the end 11.
    assert sizes == [("detector", 4), ("detector", 2), ("joint", 2), ("joint", 3)]
    for (name, p), q in zip(results[4].state.model.named_parameters(),
                            results[1].state.model.parameters()):
        assert torch.equal(p, q), name
    assert results[4].state.step == results[1].state.step == 11
    wall = ("time", "images_per_sec")
    logged = [[{k: v for k, v in r.items() if k not in wall} for r in _records(w)]
              for w in (results[4].workdir, results[1].workdir)]
    assert logged[0] == logged[1]
    assert [(r["step"], r.get("stage", r.get("eval_stage"))) for r in logged[0]] == [
        (4, "detector"), (4, "detector"), (8, "joint"), (8, "joint"), (11, "joint"), (11, "joint")]


def test_a_profiled_window_takes_one_step_a_dispatch(tmp_path, monkeypatch):
    sizes = []
    made = ttrain.make_train_multistep
    monkeypatch.setattr(ttrain, "make_train_multistep",
                        lambda config, stage, get_batch, k, mesh=None:
                        sizes.append(k) or made(config, stage, get_batch, k, mesh))
    cfg = _tiny(detector_steps=4, joint_steps=6, log_every=10, eval_every=10, steps_per_dispatch=10)
    cfg = cfg.replace(augment=dataclasses.replace(cfg.augment, enabled=False))
    ttrain.fit(cfg, str(tmp_path), eval_max_batches=1, profile_steps=2, device="cpu")
    # Steps 0-3, then 4-9 as without a profiler: the window cuts no
    # dispatch, and traces the one that holds step 5 (an eager dispatch on
    # the CPU, which takes no graph).
    assert sizes == [4, 6]
    with open(next(iter(sorted((tmp_path / "profile").glob("*.pt.trace.json"))))) as f:
        events = json.load(f)["traceEvents"]
    assert sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                  and e["name"].startswith("train#")) == ["train#4"]


def test_a_loaded_state_keeps_the_optimizers_own_rates():
    """A state dict saved on the card holds 0-d tensor rates and the
    capturable flag; loaded into the CPU's optimizer, the rate comes back a
    float and the flags stay the CPU's."""
    cfg = _tiny()
    state, _ = _states(cfg)
    sd = state.optimizer.state_dict()
    for group in sd["param_groups"]:
        group["lr"] = torch.tensor(0.125)
        group["capturable"] = True
    state.optimizer.load_state_dict(sd)
    for group in state.optimizer.param_groups:
        assert group["lr"] == 0.125 and not torch.is_tensor(group["lr"])
        assert group["capturable"] is False
