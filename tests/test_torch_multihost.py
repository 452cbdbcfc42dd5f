"""``train.main`` over two processes (counterpart of
``tests/test_multihost.py`` and ``tests/test_resilience_multiprocess.py``).

Two processes under ``python -m torch.distributed.run`` (gloo, CPU) run
the production CLI with ``--mesh-data 2``: a detector stage of 4 steps,
then a resume into the joint stage (prior init, 4 steps, evaluation over
the mesh), with rank 0 writing the checkpoints.  They end on the
parameters of the same two invocations in one process at the reference's
tolerance (rtol 1e-4, atol 2e-5) and on its final PDJ exactly.

A supervised two-process run (``python -m jointpose_torch.resilience
--nproc-per-node 2``; dispatches of 2 steps, so that step 6 is a dispatch
boundary, where the drills act) with a fault injected at step 6 loses
its group, is relaunched with ``--resume`` from the step-4 checkpoint, and ends on
the unbroken two-process run's parameters exactly.  So does a group
whose rank 1 is preempted (a SIGTERM) at step 6, free of the failure
budget though the launcher exits 1, and one whose rank 1 hangs at step
6: the supervisor finds the stale heartbeat and leaves no process of the
hung group running.

A profiled two-process run (``--profile-steps 2`` at 4 steps a dispatch)
leaves a trace of the window (the dispatch that holds step 5) for each rank under ``profile/rank<r>/`` and
ends on the unbroken run's parameters exactly.
"""

import glob
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from jointpose_torch import resilience

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_multihost.py:264-265.
RTOL, ATOL = 1e-4, 2e-5
BASE = ["--config", "tiny", "--device", "cpu", "--batch-size", "4", "--eval-max-batches", "2",
        "--lr-schedule", "constant", "--detector-steps", "4"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "JOINTPOSE_FAULT_AT_STEP"}
    env.update(PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2", **extra)
    return env


def _run(argv, timeout=600, **env):
    """Run ``argv`` to its end; on ``timeout`` kill it and every process
    below it (a launcher's ranks run in sessions of their own) and raise."""
    proc = subprocess.Popen(argv, env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        tree = resilience._process_tree(proc.pid)
        proc.kill()
        proc.communicate()
        resilience._kill_survivors(tree)
        raise
    assert proc.returncode == 0, out[-4000:] + err[-4000:]
    return out


def _torchrun(*train_args, timeout=600):
    return _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "2", "-m", "jointpose_torch.train", *train_args],
                timeout=timeout)


def _final_params(workdir):
    path = os.path.join(workdir, "checkpoints", "latest", "8", "state.pt")
    return torch.load(path, weights_only=True)["model"]


def _final_pdj(out):
    for line in out.splitlines():
        if line.startswith("final:"):
            return float(line.split("'pdj_at_05_wrist_elbow': ")[1].split(",")[0])
    raise AssertionError("no final eval line:\n" + out[-2000:])


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """The two-invocation schedule over two processes and in one."""
    root = tmp_path_factory.mktemp("multihost")
    dist_wd, ref_wd = str(root / "dist"), str(root / "ref")
    _torchrun(*BASE, "--workdir", dist_wd, "--mesh-data", "2", "--joint-steps", "0")
    out = _torchrun(*BASE, "--workdir", dist_wd, "--mesh-data", "2", "--joint-steps", "4",
                    "--resume")
    ref = [sys.executable, "-m", "jointpose_torch.train", *BASE, "--workdir", ref_wd]
    _run([*ref, "--joint-steps", "0"])
    ref_out = _run([*ref, "--joint-steps", "4", "--resume"])
    return dist_wd, out, ref_wd, ref_out


def test_two_process_fit_matches_one_process(unbroken):
    dist_wd, out, ref_wd, ref_out = unbroken
    assert "resumed from step 4" in out and "backend gloo (CPU)" in out
    got, want = _final_params(dist_wd), _final_params(ref_wd)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    # Counts are discrete: the evaluation over the mesh scores alike.
    assert _final_pdj(out) == _final_pdj(ref_out)
    # Rank 0 alone wrote the metrics: one record per logged step.
    with open(os.path.join(dist_wd, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f if '"loss"' in line]
    assert steps == [4, 8]


def test_supervised_two_process_fit_resumes_after_a_fault(unbroken, tmp_path):
    dist_wd = unbroken[0]
    workdir = str(tmp_path / "sup")
    _run([sys.executable, "-m", "jointpose_torch.resilience", "--nproc-per-node", "2",
          "--max-restarts", "1", "--", *BASE, "--workdir", workdir, "--mesh-data", "2",
          "--joint-steps", "4", "--eval-every", "4", "--steps-per-dispatch", "2"],
         JOINTPOSE_FAULT_AT_STEP="6")
    with open(os.path.join(workdir, "supervisor.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [e["event"] for e in events] == ["launch", "failure", "launch", "done"]
    assert events[2]["cmd"][-1] == "--resume"
    with open(os.path.join(workdir, ".fault_injected")) as f:
        assert int(f.read()) == 6
    # A failure is never recorded as a preemption.
    assert not os.path.exists(os.path.join(workdir, resilience.PREEMPTED_FILE))
    got, want = _final_params(workdir), _final_params(dist_wd)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_a_profiled_two_process_fit_traces_every_rank(unbroken, tmp_path):
    """Every rank traces the window, whole dispatches that it does not cut:
    the ranks' dispatches, and so their collectives, pair as in a run
    without a profiler (a rank whose dispatches differed would pair its
    dispatch-boundary all-reduces with its peer's gradient all-reduces,
    and the group would hang: the timeout)."""
    workdir = str(tmp_path / "prof")
    _torchrun(*BASE, "--workdir", workdir, "--mesh-data", "2", "--joint-steps", "4",
              "--eval-every", "4", "--steps-per-dispatch", "4", "--profile-steps", "2", timeout=300)
    for rank in range(2):
        (path,) = glob.glob(os.path.join(workdir, "profile", f"rank{rank}", "*.pt.trace.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        steps = sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                       and e["name"].startswith("train#"))
        assert steps == ["train#4"], rank  # the dispatch of steps 4-7 holds step 5
    assert not glob.glob(os.path.join(workdir, "profile", "*.pt.trace.json"))
    # The window changes the trace alone: the unbroken run's parameters.
    got, want = _final_params(workdir), _final_params(unbroken[0])
    for name in want:
        assert torch.equal(got[name], want[name]), name


# A rank of ``train.main`` whose rank 1 meets a drill at step 6, once per
# workdir: a preemption notice (SIGTERM to itself) or a hang.
_DRILL_RANK = r"""
import os, signal, sys, time
import jointpose_torch.train as train

_inject = train.maybe_inject_fault

def drill(workdir, step):
    _inject(workdir, step)
    marker = os.path.join(workdir, ".drill")
    if os.environ["RANK"] == "1" and step == 6 and not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write(str(step))
        if os.environ["DRILL"] == "preempt":
            os.kill(os.getpid(), signal.SIGTERM)
        else:
            time.sleep(3600)  # its peer waits in the step boundary's collective

train.maybe_inject_fault = drill
train.main(sys.argv[1:])
"""


def _supervise_drill(tmp_path, drill, **kw):
    """A supervised two-process fit with rank 1's drill -> (supervisor,
    workdir, the hung group's processes, if any)."""
    script, workdir = tmp_path / "rank.py", str(tmp_path / "sup")
    script.write_text(_DRILL_RANK)
    sup = resilience.Supervisor(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(script), *BASE, "--workdir", workdir, "--mesh-data", "2", "--joint-steps", "4",
         "--eval-every", "4", "--steps-per-dispatch", "2"], workdir=workdir, max_restarts=1,
        env=_env(DRILL=drill), **kw)
    rcs = []
    runner = threading.Thread(target=lambda: rcs.append(sup.run()))
    runner.start()
    tree = []
    if drill == "hang":
        while not os.path.exists(os.path.join(workdir, ".drill")) and runner.is_alive():
            time.sleep(0.1)
        tree = resilience._process_tree(sup.proc.pid)
    runner.join(timeout=600)
    assert rcs == [0]
    return sup, workdir, tree


def test_supervised_two_process_fit_resumes_after_a_preemption(unbroken, tmp_path):
    sup, workdir, _ = _supervise_drill(tmp_path, "preempt")
    assert [e["event"] for e in sup.events] == ["launch", "preempted", "launch", "done"]
    assert sup.restarts == 0 and sup.events[1]["rc"] != resilience.EXIT_PREEMPTED
    with open(os.path.join(workdir, resilience.PREEMPTED_FILE)) as f:
        assert json.load(f)["step"] == 6
    got, want = _final_params(workdir), _final_params(unbroken[0])
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_supervised_two_process_fit_ends_a_hung_group(unbroken, tmp_path):
    sup, workdir, tree = _supervise_drill(tmp_path, "hang", heartbeat_timeout=15.0, grace=3.0)
    assert [e["event"] for e in sup.events] == [
        "launch", "heartbeat_stale", "failure", "launch", "done"]
    assert sup.events[2]["why"] == "hang" and sup.restarts == 1
    assert not os.path.exists(os.path.join(workdir, resilience.PREEMPTED_FILE))
    assert len(tree) >= 2  # the launcher's two ranks, each in a session of its own
    for pid, started in tree:  # none left running: gone, reused, or a zombie
        stat = resilience._stat(pid)
        assert stat is None or stat[19] != started or stat[0] == "Z", pid
    got, want = _final_params(workdir), _final_params(unbroken[0])
    for name in want:
        assert torch.equal(got[name], want[name]), name
