"""Preemption of the port's trainer (jointpose_torch.resilience and the
SIGTERM path of train.fit), as the reference handles it
(jointpose/train.py, jointpose/resilience.py): SIGTERM checkpoints at the
next step boundary and exits EXIT_PREEMPTED; --resume goes on from that
checkpoint.  Also: a mesh of one device (--mesh-data -1) trains."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

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
    for flags in (["--mesh-data", "2"], ["--mesh-model", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train.main(["--config", "tiny", "--workdir", str(tmp_path), "--device", "cpu", *flags])
