"""The port's checkpoints (jointpose_torch.checkpoint, predict.restore_params):
a bit-exact round trip of parameters, optimizer moments, step and
generator; keep-N pruning; the kept-best by metric; and the run metadata,
which both packages' ``reconcile_config`` must read alike."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from jointpose import checkpoint as jckpt
from jointpose.configs import get_config as jax_get_config
from jointpose_torch import checkpoint as tckpt
from jointpose_torch import get_config
from jointpose_torch.configs import with_pool_mode
from jointpose_torch.convert import write_initial_checkpoint
from jointpose_torch.predict import build_predictor, init_state_dict, restore_params
from jointpose_torch.train import create_state, make_train_step


def _cfg(**train):
    c = get_config("tiny")
    return c.replace(train=dataclasses.replace(c.train, **train))


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    b, (h, w) = cfg.train.batch_size, cfg.data.image_hw
    return {"image": torch.from_numpy(rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8)),
            "joints": torch.from_numpy(rs.uniform([2, 2], [w - 3, h - 3], (b, 9, 2)).astype(np.float32)),
            "visible": torch.ones(b, 9)}


def _trained(cfg, steps=2, seed=0):
    state = create_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    for i in range(steps):
        state, _ = make_train_step(cfg, "joint")(state, _batch(cfg, i))
    return state


def _flat_opt(opt):
    sd = opt.state_dict()
    return {(i, k): v for i, st in sd["state"].items() for k, v in st.items()}, sd["param_groups"]


@pytest.mark.parametrize("optimizer", ["adamw", "momentum"])
def test_round_trip_is_bit_exact(tmp_path, optimizer):
    cfg = _cfg(optimizer=optimizer)
    state = _trained(cfg)
    ckpt = tckpt.Checkpointer(str(tmp_path), keep=2, config=cfg)
    ckpt.save(state.step, state)
    fresh = create_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    fresh = ckpt.restore(fresh)
    assert fresh.step == state.step == 2
    for (n, p), (_, q) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        assert torch.equal(p, q), n
    (want_state, want_groups), (got_state, got_groups) = _flat_opt(state.optimizer), _flat_opt(fresh.optimizer)
    assert set(got_state) == set(want_state) and got_groups == want_groups
    assert all(torch.equal(torch.as_tensor(got_state[k]), torch.as_tensor(want_state[k])) for k in want_state)
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    # ... and the next step goes on alike, augmentation draw included.
    a, _ = make_train_step(cfg, "joint")(state, _batch(cfg, 5))
    b, _ = make_train_step(cfg, "joint")(fresh, _batch(cfg, 5))
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))


def test_latest_keeps_n_and_best_keeps_the_highest_metric(tmp_path):
    cfg = _cfg()
    state = _trained(cfg, steps=0)
    ckpt = tckpt.Checkpointer(str(tmp_path), keep=2, config=cfg)
    assert ckpt.latest_step() is None and ckpt.best_step() is None
    scores = {10: 0.2, 20: None, 30: 0.5, 40: 0.3, 50: 0.5}
    for step, score in scores.items():
        metrics = None if score is None else {
            "pdj_at_05_wrist_elbow": score, "eval_stage": "joint", "pdj_curves": [[0.0]]}
        ckpt.save(step, state, metrics=metrics)
    assert sorted(os.listdir(tmp_path / "latest")) == ["40", "50"]
    assert ckpt.latest_step() == 50
    # 40 scored lower than 30 and was not kept; 50 ties and is the newer.
    assert os.listdir(tmp_path / "best") == ["50"] and ckpt.best_step() == 50
    with open(tmp_path / "best" / "50" / "metrics.json") as f:
        assert json.load(f) == {"pdj_at_05_wrist_elbow": 0.5}
    other = tckpt.Checkpointer(str(tmp_path / "other"), keep=3)
    other.save(1, state, metrics={"pdj_at_05_wrist_elbow": 0.4})
    other.save(2, state, metrics={"pdj_at_05_wrist_elbow": 0.1})
    assert other.best_step() == 1 and other.latest_step() == 2
    # An explicit step is found under latest/ first, then under best/.
    assert other.restore_subtree(("step",), step=1)["step"] == 1
    with pytest.raises(FileNotFoundError):
        tckpt.Checkpointer(str(tmp_path / "none")).restore_subtree()


def test_no_temporary_directories_are_left(tmp_path):
    cfg = _cfg()
    ckpt = tckpt.Checkpointer(str(tmp_path), keep=1, config=cfg)
    state = _trained(cfg, steps=0)
    ckpt.save(3, state, metrics={"pdj_at_05_wrist_elbow": 0.1})
    ckpt.save(3, state, metrics={"pdj_at_05_wrist_elbow": 0.2})  # the same step again
    assert os.listdir(tmp_path / "latest") == ["3"] and os.listdir(tmp_path / "best") == ["3"]
    assert sorted(os.listdir(tmp_path)) == ["best", "latest", "run_config.json"]


@pytest.mark.parametrize("pool_mode", ["max", "stride"])
def test_run_metadata_reads_alike_in_both_packages(tmp_path, pool_mode):
    cfg = with_pool_mode(_cfg(), pool_mode)
    ckpt = tckpt.Checkpointer(str(tmp_path), config=cfg)
    ckpt.save(1, _trained(cfg, steps=0))
    meta = tckpt.load_run_metadata(str(tmp_path))
    assert meta == jckpt.load_run_metadata(str(tmp_path))
    assert set(meta) == {"config_name", "pool_mode", "head_conv_impl_resolved", "config"}
    assert meta["config_name"] == "tiny" and meta["pool_mode"] == pool_mode
    assert meta["head_conv_impl_resolved"] == "direct"
    assert meta["config"] == json.loads(json.dumps(dataclasses.asdict(cfg), default=str))
    # Both reconcile a drifted preset default to the recorded mode and pin 'auto'.
    got = tckpt.reconcile_config(get_config("tiny"), str(tmp_path))
    want = jckpt.reconcile_config(jax_get_config("tiny"), str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.detector.pool_mode == pool_mode and got.detector.head_conv_impl == "direct"
    other = "stride" if pool_mode == "max" else "max"
    for reconcile, get in ((tckpt.reconcile_config, get_config), (jckpt.reconcile_config, jax_get_config)):
        with pytest.raises(ValueError, match="contradicts"):
            reconcile(get("tiny"), str(tmp_path), other)
    with pytest.raises(ValueError, match="pool_mode"):
        tckpt.Checkpointer(str(tmp_path), config=with_pool_mode(cfg, other))


def test_unreadable_metadata_is_ignored(tmp_path, capsys):
    (tmp_path / "run_config.json").write_text("{not json")
    assert tckpt.load_run_metadata(str(tmp_path)) is None
    assert "unreadable" in capsys.readouterr().out
    assert tckpt.load_run_metadata(str(tmp_path / "absent")) is None
    cfg = get_config("tiny")
    assert tckpt.reconcile_config(cfg, str(tmp_path / "absent")) is cfg


@pytest.mark.parametrize("tta", [False, True])
def test_restore_params_serves_what_was_saved(tmp_path, tta):
    cfg = _cfg().replace(eval_flip_tta=tta)
    state = _trained(cfg)
    ckpt = tckpt.Checkpointer(str(tmp_path), config=cfg)
    ckpt.save(2, state, metrics={"pdj_at_05_wrist_elbow": 0.3})
    state, _ = make_train_step(cfg, "joint")(state, _batch(cfg, 7))
    ckpt.save(3, state)
    images = _batch(cfg, 3)["image"]
    best, step = restore_params(cfg, str(tmp_path), best=True)
    assert step == 2 and all(v.device.type == "cpu" for v in best.values())
    latest, step = restore_params(cfg, str(tmp_path))
    assert step == 3
    want = build_predictor(cfg, state.model.state_dict(), device="cpu")(images)
    got = build_predictor(cfg, latest, device="cpu")(images)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(build_predictor(cfg, best, device="cpu")(images)[1], want[1])
    assert restore_params(cfg, str(tmp_path), step=2)[1] == 2
    with pytest.raises(ValueError, match="does not fit"):
        restore_params(cfg.replace(mrf=None), str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no best"):
        tckpt.Checkpointer(str(tmp_path / "nobest"), config=cfg).save(1, state)
        restore_params(cfg, str(tmp_path / "nobest"), best=True)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        restore_params(cfg, str(tmp_path / "empty"))


def test_write_initial_checkpoint_is_step_zero_with_the_given_weights(tmp_path):
    cfg = _cfg()
    weights = init_state_dict(cfg, torch.Generator().manual_seed(4))
    write_initial_checkpoint(cfg, str(tmp_path), weights)
    got, step = restore_params(cfg, str(tmp_path))
    assert step == 0 and all(torch.equal(got[k], weights[k]) for k in weights)
    state = tckpt.Checkpointer(str(tmp_path)).restore(
        create_state(cfg, torch.Generator().manual_seed(0), device="cpu"))
    assert state.step == 0 and not state.optimizer.state_dict()["state"]


def test_a_generator_state_from_another_device_kind_reseeds(tmp_path):
    """A generator's state belongs to its device's engine: a checkpoint
    whose generator ran on another kind of device (here a payload marked
    'cuda', whose Philox state is 16 bytes) restores by reseeding from the
    saved seed, the stream a fresh run on this device draws at step 0."""
    cfg = _cfg()
    weights = init_state_dict(cfg, torch.Generator().manual_seed(4))
    write_initial_checkpoint(cfg, str(tmp_path), weights)
    path = os.path.join(str(tmp_path), "latest", "0", tckpt.STATE_FILE)
    payload = torch.load(path, weights_only=True)
    fresh = create_state(cfg, torch.Generator().manual_seed(cfg.train.seed), device="cpu")
    assert payload["generator_seed"] == fresh.generator.initial_seed()
    torch.save({**payload, "generator": torch.zeros(16, dtype=torch.uint8),
                "generator_device": "cuda"}, path)
    state = create_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    state = tckpt.Checkpointer(str(tmp_path)).restore(state)
    assert torch.equal(state.generator.get_state(), fresh.generator.get_state())
