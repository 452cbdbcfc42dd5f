"""A run with its timed path broken underneath comes out not correct.

Each test drives a cell's own loop and comparison, with the cell's own
limits, at the small ``tiny``-based sizes of ``cells.py`` on the CPU (the
run's look for a card is all it skips), once sound and once with a fault
planted in the program: an answer altered where it is produced, a step
that returns its state unchanged, half of each batch left out (the mean
over the rest), the gradient sums between ranks left out, each step of a
dispatch given one batch, the augmentation drawn again.  A forbidden
module loaded in one rank of several is reported."""

import json
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark.harness import judge, ranks, spec
from benchmark.tests import cells


def verdict(cell, out) -> bool:
    return judge.verdict(out["numbers"], cell.limits)[0]


def shift_answers(predict):
    """The decode's answers moved by one heatmap cell along x."""
    def broken(images):
        coords, probs = predict(images)
        return coords + torch.tensor([4.0, 0.0]), probs
    return broken


@pytest.mark.parametrize("fault", [None, shift_answers], ids=["sound", "answers_altered"])
def test_offline_scoring(fault):
    cell = cells.offline()
    out = spec.loop_module("closed_batch").run(cell, 31, 0.5, False, device="cpu", fault=fault)
    assert verdict(cell, out) is (fault is None)


def answers_of_the_next_image(recorder):
    """Each image of a dispatch answered with its neighbour's coordinates."""
    predict = recorder.predict

    def broken(images):
        coords, probs = predict(images)
        return torch.roll(coords, 1, dims=0), probs
    recorder.predict = broken


@pytest.mark.parametrize("fault", [None, answers_of_the_next_image],
                         ids=["sound", "answers_altered"])
def test_open_loop_serving(fault):
    cell = cells.serve()
    out = spec.loop_module("open_serve").run(cell, 32, 1.5, False, device="cpu", fault=fault)
    assert out["failed"] == 0
    assert verdict(cell, out) is (fault is None)


def state_unchanged(step):
    def broken(state, batch):
        before = [p.detach().clone() for p in state.model.parameters()]
        state, metrics = step(state, batch)
        with torch.no_grad():
            for p, old in zip(state.model.parameters(), before):
                p.copy_(old)
        return state, metrics
    return broken


def half_batch(step):
    def broken(state, batch):
        rows = batch["image"].shape[1]
        return step(state, {k: v[:, : rows // 2] for k, v in batch.items()})
    return broken


def first_batch_every_step(step):
    """Each step of a dispatch given the dispatch's first batch."""
    def broken(state, batch):
        return step(state, {k: v[:1].expand_as(v).contiguous() for k, v in batch.items()})
    return broken


def draws_repeated(step):
    """Every dispatch drawing the first dispatch's augmentation again."""
    first = []

    def broken(state, batch):
        if first:
            state.generator.set_state(first[0])
        else:
            first.append(state.generator.get_state())
        return step(state, batch)
    return broken


@pytest.mark.parametrize("fault", [None, state_unchanged, half_batch, first_batch_every_step,
                                   draws_repeated],
                         ids=["sound", "state_unchanged", "half_batch", "first_batch_every_step",
                              "draws_repeated"])
def test_training(fault):
    cell = cells.train()
    out = spec.loop_module("train_steps").run(cell, 33, 0.3, False, device="cpu", fault=fault)
    assert verdict(cell, out) is (fault is None)


def _launch_two_ranks(fault: str, seed: int) -> tuple:
    cell = cells.train(ranks=2)
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(cell.__dict__, f)
    helper = Path(__file__).with_name("_rank_cpu.py")
    try:
        return cell, ranks.launch([str(helper), f.name, str(seed), "0.3", fault], 2)
    finally:
        Path(f.name).unlink()


def test_data_parallel_training_sums_the_ranks_gradients():
    """Two ranks on the CPU (fp32 both sides): every rank's readings agree
    with the one-process reference of the global batch to rounding, and
    with the gradient sums left out each rank's gradients and parameters
    stray from it.  (No cell of several ranks has limits of its own yet.)"""
    numbers = {}
    for fault in ("", "no_exchange"):
        cell, saved = _launch_two_ranks(fault, 34)
        assert ranks.forbidden(saved) == []
        numbers[fault] = spec.loop_module("train_steps").combine(
            cell, 34, ranks.results(saved), "cpu")["numbers"]
    assert max(numbers[""][k] for k in ("first_loss_gap", "dispatch_loss_gap", "grad_gap",
                                         "step_gap")) < 1e-5
    assert numbers["no_exchange"]["grad_gap"] > 0.1 and numbers["no_exchange"]["step_gap"] > 0.05


def test_a_forbidden_module_in_any_rank_is_reported():
    _, saved = _launch_two_ranks("jax_in_rank_1", 35)
    assert ranks.forbidden(saved) == ["jax"]
