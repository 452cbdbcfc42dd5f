"""Failure detection and recovery of the port's trainer
(jointpose_torch.resilience and its call sites in train.fit), as the
reference handles it (jointpose/train.py, jointpose/resilience.py):
SIGTERM checkpoints at the next step boundary and exits EXIT_PREEMPTED;
--resume goes on from that checkpoint.  Both packages' Supervisors give
the same events and return codes on the reference's four stub scenarios
(tests/test_resilience.py), each stub beating with its own package's
Heartbeat, and each package reads the other's heartbeat.  A supervised
``tiny`` run on the CPU killed by JOINTPOSE_FAULT_AT_STEP resumes and
ends bit-equal to an unbroken run.  Also: a mesh of one device
(--mesh-data -1) trains."""

import concurrent.futures
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

from jointpose import resilience as jax_resilience
from jointpose_torch import resilience, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train(workdir, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "jointpose_torch.train", "--config", "tiny", "--workdir", workdir,
         "--device", "cpu", "--eval-max-batches", "1", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
    )


def _records(workdir):
    path = os.path.join(workdir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_exit_code_equals_reference():
    assert resilience.EXIT_PREEMPTED == jax_resilience.EXIT_PREEMPTED == 85


def test_sigterm_checkpoints_and_resume_goes_on(tmp_path):
    workdir = str(tmp_path)
    # Long enough that the signal lands mid-run, with no eval before the end.
    proc = _train(workdir, "--detector-steps", "100000", "--joint-steps", "0",
                  "--log-every", "1", "--eval-every", "1000000")
    try:
        deadline = time.monotonic() + 120
        while not any("loss" in r for r in _records(workdir)):
            assert proc.poll() is None and time.monotonic() < deadline, proc.communicate()[0]
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == resilience.EXIT_PREEMPTED, out[-2000:]
    step = int(re.search(r"preempted: checkpointed at step (\d+)", out).group(1))
    assert step >= 1
    assert sorted(os.listdir(os.path.join(workdir, "checkpoints", "latest"))) == [str(step)]
    last = _records(workdir)[-1]
    assert last["step"] == step and last["preempted"] == 1  # logged as a float

    # --resume takes exactly the steps that are left (2 detector + 2 joint).
    resumed = _train(workdir, "--resume", "--detector-steps", str(step + 2), "--joint-steps", "2",
                     "--log-every", "1", "--eval-every", "1000000")
    out, _ = resumed.communicate(timeout=300)
    assert resumed.returncode == 0, out[-2000:]
    assert f"resumed from step {step}" in out
    logged = [r["step"] for r in _records(workdir) if "loss" in r]
    assert logged[-4:] == [step + 1, step + 2, step + 3, step + 4]
    assert str(step + 4) in os.listdir(os.path.join(workdir, "checkpoints", "latest"))


@pytest.mark.parametrize("mesh", [["--mesh-data", "-1"], ["--mesh-data", "1", "--mesh-model", "1"]],
                         ids=["all_devices", "one_by_one"])
def test_one_device_mesh_trains(tmp_path, mesh, capsys):
    train.main(["--config", "tiny", "--workdir", str(tmp_path), "--device", "cpu",
                "--detector-steps", "1", "--joint-steps", "0", "--eval-max-batches", "1", *mesh])
    assert "final:" in capsys.readouterr().out
    assert os.listdir(os.path.join(tmp_path, "checkpoints", "latest")) == ["1"]


def test_larger_meshes_still_raise(tmp_path):
    # One process per device: a mesh larger than the world of processes
    # raises, naming the launcher, with spatial parallelism too.
    for flags in (["--mesh-data", "2"], ["--mesh-model", "2"], ["--mesh-data", "2", "--mesh-spatial"]):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            train.main(["--config", "tiny", "--workdir", str(tmp_path), "--device", "cpu", *flags])


STUB = """
import os, sys, time
sys.path.insert(0, {root!r})
from {package}.resilience import Heartbeat, EXIT_PREEMPTED

workdir = sys.argv[sys.argv.index("--workdir") + 1]
attempts_file = os.path.join(workdir, "attempts")
n = int(open(attempts_file).read()) if os.path.exists(attempts_file) else 0
open(attempts_file, "w").write(str(n + 1))
hb = Heartbeat(workdir, min_interval=0.0)
hb.beat(n)
{body}
"""

# The reference's four scenarios: (stub body, Supervisor options).
SCENARIOS = {
    "crash_then_success": ("sys.exit(3 if n == 0 else 0)", dict(max_restarts=2)),
    "hang_killed_and_restarted": ("time.sleep(30 if n == 0 else 0); sys.exit(0)",
                                  dict(max_restarts=1, heartbeat_timeout=1.5, poll_interval=0.2,
                                       grace=5)),
    "preemption_costs_no_budget": (f"sys.exit({resilience.EXIT_PREEMPTED} if n == 0 else 0)",
                                   dict(max_restarts=0)),
    "gives_up_after_budget": ("sys.exit(7)", dict(max_restarts=1)),
}


def _supervise(module, workdir, body, options):
    os.makedirs(workdir)
    stub = os.path.join(workdir, "stub.py")
    with open(stub, "w") as f:
        f.write(STUB.format(root=ROOT, package=module.__name__.split(".")[0], body=body))
    sup = module.Supervisor([sys.executable, stub, "--workdir", workdir], workdir,
                            **{"heartbeat_timeout": 60, **options})
    rc = sup.run()
    with open(os.path.join(workdir, "supervisor.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [e["event"] for e in logged] == [e["event"] for e in sup.events]
    launches = [e["cmd"] for e in logged if e["event"] == "launch"]
    assert all("--resume" in cmd for cmd in launches[1:]) and "--resume" not in launches[0]
    return ([e["event"] for e in logged], rc, sup.restarts,
            [e.get("rc") for e in logged if e["event"] == "failure"])


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    """Every scenario through both packages' Supervisors, all at once:
    {scenario: (reference's run, port's run)}."""
    root = tmp_path_factory.mktemp("stubs")
    with concurrent.futures.ThreadPoolExecutor(2 * len(SCENARIOS)) as pool:
        runs = {(scenario, name): pool.submit(_supervise, module, str(root / scenario / name),
                                              *SCENARIOS[scenario])
                for scenario in SCENARIOS
                for name, module in (("jax", jax_resilience), ("torch", resilience))}
        return {scenario: (runs[scenario, "jax"].result(timeout=120),
                           runs[scenario, "torch"].result(timeout=120)) for scenario in SCENARIOS}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervisors_agree_on_the_reference_scenarios(supervised, scenario):
    want, got = supervised[scenario]
    assert got == want
    expected = {
        "crash_then_success": (["launch", "failure", "launch", "done"], 0, 1),
        "hang_killed_and_restarted": (["launch", "heartbeat_stale", "failure", "launch", "done"],
                                      0, 1),
        "preemption_costs_no_budget": (["launch", "preempted", "launch", "done"], 0, 0),
        "gives_up_after_budget": (["launch", "failure", "launch", "failure", "giving_up"], 7, 2),
    }[scenario]
    assert got[:3] == expected


def test_each_package_reads_the_others_heartbeat(tmp_path):
    for writer, reader in ((jax_resilience, resilience), (resilience, jax_resilience)):
        workdir = str(tmp_path / writer.__name__)
        assert reader.heartbeat_age(workdir) is None
        writer.Heartbeat(workdir, min_interval=0.0).beat(7)
        assert 0 <= reader.heartbeat_age(workdir) < 5.0
        with open(os.path.join(workdir, reader.HEARTBEAT_FILE)) as f:
            record = json.load(f)
        assert set(record) == {"step", "time"} and record["step"] == 7
        assert os.listdir(workdir) == ["heartbeat.json"]  # renamed over, no temp file left
    assert resilience.HEARTBEAT_FILE == jax_resilience.HEARTBEAT_FILE


def test_the_fault_fires_once_per_workdir(tmp_path, monkeypatch):
    monkeypatch.setenv("JOINTPOSE_FAULT_AT_STEP", "5")
    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    resilience.maybe_inject_fault(str(tmp_path), 4)
    assert exits == []
    resilience.maybe_inject_fault(str(tmp_path), 6)  # the first boundary at or past the target
    resilience.maybe_inject_fault(str(tmp_path), 7)
    assert exits == [41] and (tmp_path / ".fault_injected").read_text() == "6"


def test_supervised_fit_survives_a_fault_and_ends_bit_equal(tmp_path):
    """``python -m jointpose_torch.resilience`` over ``tiny`` on the CPU: the
    fault set for step 5 kills the child at the first dispatch boundary at
    or past it (step 8: the run takes its steps in dispatches of 4, cut at
    the evals), the restart resumes from the step-4 checkpoint and ends on
    the parameters of an unbroken run."""
    from jointpose_torch.checkpoint import Checkpointer

    def command(workdir, *pre):
        return [sys.executable, "-m", "jointpose_torch.resilience", *pre, "--", "--config", "tiny",
                "--workdir", workdir, "--device", "cpu", "--detector-steps", "4",
                "--joint-steps", "4", "--eval-every", "4", "--eval-max-batches", "1"]

    broken, straight = str(tmp_path / "broken"), str(tmp_path / "straight")
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT, env={**os.environ, **env})
             for cmd, env in ((command(broken, "--max-restarts", "1"),
                               {"JOINTPOSE_FAULT_AT_STEP": "5"}),
                              (command(straight), {}))]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    with open(os.path.join(broken, "supervisor.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [(e["event"], e.get("rc")) for e in events] == [
        ("launch", None), ("failure", 41), ("launch", None), ("done", None)]
    assert "injecting fault at step 8" in outs[0] and "resumed from step 4" in outs[0]
    assert outs[0].count("estimating pairwise priors") == 2  # step 4 predates the prior init

    got, want = (Checkpointer(os.path.join(w, "checkpoints")).restore_subtree()["model"]
                 for w in (broken, straight))
    assert got.keys() == want.keys()
    for name, p in want.items():
        assert torch.equal(got[name], p), name
