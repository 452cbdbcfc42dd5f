"""Failure detection and recovery of a training run (counterpart of
``jointpose/resilience.py``).

1. **Heartbeat**: ``train.fit`` writes ``<workdir>/heartbeat.json``
   (step and wall time) after each step, eval, prior init and save; a
   hung card, a deadlocked launch or a stuck host shows as a stale file.
   The file has the reference's format, so either package's
   ``heartbeat_age`` reads the other's.
2. **Preemption**: SIGTERM, the usual preemption signal of a scheduler,
   flips a flag that ``fit`` reads once per step; the loop checkpoints at
   that step boundary and exits ``EXIT_PREEMPTED``.
3. **Supervisor**: runs training as a child process, resumes it
   (``--resume`` is step-exact) after a crash or a preemption, kills and
   restarts it when its heartbeat goes stale, and gives up after a budget
   of failures (preemptions are free).  The child is killed through its
   process handle, never by a name pattern.

Fault injection for drills and tests: ``JOINTPOSE_FAULT_AT_STEP=n``
ends the training process at once (``os._exit(41)``) at the first step
boundary at or after global step n, once per workdir (a marker file keeps
the fault from firing again after the resume).

    python -m jointpose_torch.resilience --max-restarts 3 -- \\
        --config flagship --workdir runs/f1
    python -m jointpose_torch.resilience --nproc-per-node 2 -- \\
        --config flagship --workdir runs/f2 --mesh-data 2

With ``--nproc-per-node N`` the supervised unit is ``python -m
torch.distributed.run --standalone --nproc-per-node N -m
jointpose_torch.train ...``: the launcher ends the whole group when a rank
fails (a faulted rank leaves its peers' collectives, which then fail too),
and the supervisor relaunches the group with ``--resume`` on a fresh
rendezvous port.  The ranks share the workdir's heartbeat file.  The
launcher exits 1 whatever its ranks' codes, so a group that checkpointed
on preemption says so in ``<workdir>/preempted.json`` (``mark_preempted``,
written by rank 0 after the save), and the supervisor resumes it free of
charge as it does a single process that exits ``EXIT_PREEMPTED``.  On a
hang the supervisor ends every process below its child, the ranks
included: the launcher starts each rank in a session of its own, out of
reach of a signal to its process group.

This module imports no ``torch``: the supervisor and the heartbeat start
fast, and the supervisor leaves the card to its child.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

EXIT_PREEMPTED = 85  # exit code of a run that checkpointed on preemption
EXIT_FAULT = 41  # exit code of an injected fault
HEARTBEAT_FILE = "heartbeat.json"
PREEMPTED_FILE = "preempted.json"


class Heartbeat:
    """Train side: write {step, time} to ``<workdir>/heartbeat.json``.

    At most one write per ``min_interval`` seconds, so that a beat per step
    costs a clock read.  The write goes to a file of this process and is
    renamed over the heartbeat, so the supervisor never reads a torn file;
    the process's rank (``RANK``, as ``torch.distributed`` launchers set
    it) and pid name that file, so processes that share the workdir do not
    tear each other's.
    """

    def __init__(self, workdir: str, min_interval: float = 1.0):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, HEARTBEAT_FILE)
        self.min_interval = min_interval
        self._last = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last < self.min_interval:
            return
        self._last = now
        tmp = f"{self.path}.{os.environ.get('RANK', '0')}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "time": now}, f)
        os.replace(tmp, self.path)


def heartbeat_age(workdir: str) -> float | None:
    """Seconds since the last heartbeat, or None if none was written yet."""
    try:
        return time.time() - os.stat(os.path.join(workdir, HEARTBEAT_FILE)).st_mtime
    except OSError:
        return None


class PreemptionHandler:
    """SIGTERM hook: set ``preempted``, let the loop checkpoint.

    The loop reads ``preempted`` once per step (a bool read) and leaves
    through ``exit_preempted()`` after saving.  The previous handler is
    chained for other users of SIGTERM, and put back by ``uninstall()``.
    ``install`` must run on the main thread, as ``signal.signal`` asks.
    """

    def __init__(self):
        self.preempted = False
        self._prev = None

    def install(self) -> "PreemptionHandler":
        def _handler(signum, frame):
            self.preempted = True
            if callable(self._prev):
                self._prev(signum, frame)

        self._prev = signal.signal(signal.SIGTERM, _handler)
        return self

    def uninstall(self) -> None:
        """Put back the handler that ``install`` replaced."""
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None

    @staticmethod
    def exit_preempted() -> None:
        sys.exit(EXIT_PREEMPTED)


def mark_preempted(workdir: str, step: int) -> None:
    """Train side, after the preemption checkpoint is whole: record it in
    ``<workdir>/preempted.json``, where a supervisor that sees only a
    launcher's exit code finds it."""
    path = os.path.join(workdir, PREEMPTED_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"step": int(step), "time": time.time()}, f)
    os.replace(tmp, path)


def _process_tree(pid: int) -> list[tuple[int, str]]:
    """The processes below ``pid`` (its children, theirs, ...), each with
    its start time (to tell it from a later process of the same pid), read
    from ``/proc``; empty where there is none."""
    children: dict[int, list[int]] = {}
    started: dict[int, str] = {}
    try:
        entries = [e for e in os.listdir("/proc") if e.isdigit()]
    except OSError:
        return []
    for entry in entries:
        stat = _stat(int(entry))
        if stat is not None:
            children.setdefault(int(stat[1]), []).append(int(entry))
            started[int(entry)] = stat[19]
    tree, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            tree.append((child, started[child]))
            todo.append(child)
    return tree


def _stat(pid: int) -> list[str] | None:
    """The fields of ``/proc/<pid>/stat`` after the command's name (state,
    ppid, ..., start time at 19), or None for a process that is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return None
    return stat[stat.rindex(")") + 2:].split()


def _kill_survivors(tree: list[tuple[int, str]]) -> None:
    """SIGKILL every process of ``tree`` that still runs (a zombie takes it
    harmlessly)."""
    for pid, started in tree:
        stat = _stat(pid)
        if stat is not None and stat[19] == started:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def maybe_inject_fault(workdir: str, step: int) -> None:
    """Drill hook: end the process at once at ``JOINTPOSE_FAULT_AT_STEP``,
    once per workdir.

    ``os._exit`` skips checkpoint flushes and ``atexit``, as a killed host
    would.  ``>=``: the hook runs at step boundaries, and the fault fires
    at the first one at or past the target; the marker file keeps it from
    firing again when the resumed run passes the same step.
    """
    target = os.environ.get("JOINTPOSE_FAULT_AT_STEP")
    if target is None or step < int(target):
        return
    marker = os.path.join(workdir, ".fault_injected")
    if os.path.exists(marker):
        return
    with open(marker, "w") as f:
        f.write(str(step))
    print(f"[resilience] injecting fault at step {step}", flush=True)
    os._exit(EXIT_FAULT)


class Supervisor:
    """Run a training command, resuming it after a crash, a hang or a
    preemption.

    Args:
      cmd: the child's argv (e.g. ``[sys.executable, '-m',
        'jointpose_torch.train', '--config', ..., '--workdir', workdir]``);
        ``--resume`` is appended for every restart unless present.
      workdir: where the child writes its heartbeat.
      max_restarts: the failure budget (crashes and hang-kills); preemption
        exits (``EXIT_PREEMPTED``, or a ``preempted.json`` written during
        the attempt) always resume and cost nothing.
      heartbeat_timeout: seconds of heartbeat silence after which the child
        is declared hung.  Enforced only once this attempt has beaten, so
        start-up and the first steps (cuDNN's algorithm choice, kernel
        builds) do not trip it (``start_timeout`` bounds those); it must
        exceed the longest blocking stretch after that: an eval, the prior
        estimation, a checkpoint save.  Hang-kills charge the budget, so
        that a stall that recurs cannot restart for ever.
      start_timeout: seconds to wait for this attempt's first heartbeat
        (None: no limit), so that a child that hangs before its first step
        ends is found too.
    """

    def __init__(
        self,
        cmd: list[str],
        workdir: str,
        max_restarts: int = 3,
        heartbeat_timeout: float = 1800.0,
        poll_interval: float = 0.5,
        grace: float = 30.0,
        start_timeout: float | None = 3600.0,
        env: dict[str, str] | None = None,
    ):
        self.cmd = list(cmd)
        self.workdir = workdir
        self.max_restarts = max_restarts
        self.heartbeat_timeout = heartbeat_timeout
        self.poll_interval = poll_interval
        self.grace = grace
        self.start_timeout = start_timeout
        self.env = env
        self.restarts = 0
        self.events: list[dict] = []
        self.proc: subprocess.Popen | None = None  # the attempt running now

    def _log(self, event: str, **kw) -> None:
        rec = {"event": event, "time": time.time(), **kw}
        self.events.append(rec)
        print(f"[supervisor] {event} {kw}", flush=True)
        os.makedirs(self.workdir, exist_ok=True)
        with open(os.path.join(self.workdir, "supervisor.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _watch(self, proc: subprocess.Popen) -> tuple[int, str]:
        """Wait for the child's exit; kill it on a stale heartbeat.
        -> (returncode, why)."""
        started = time.time()
        hb_path = os.path.join(self.workdir, HEARTBEAT_FILE)
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc, "exit"
            try:
                hb_mtime = os.stat(hb_path).st_mtime
            except OSError:
                hb_mtime = None
            # Only this attempt's beats count: a file left by the previous
            # attempt must not get a restarting child killed.
            if hb_mtime is None or hb_mtime < started:
                if self.start_timeout is not None and time.time() - started > self.start_timeout:
                    self._terminate(proc)
                    return proc.returncode, "no_first_heartbeat"
            elif time.time() - hb_mtime > self.heartbeat_timeout:
                self._log("heartbeat_stale", age_s=round(time.time() - hb_mtime, 1))
                self._terminate(proc)
                return proc.returncode, "hang"
            time.sleep(self.poll_interval)

    def _terminate(self, proc: subprocess.Popen) -> None:
        """SIGTERM (the child checkpoints; a rank launcher passes it on to
        its ranks), then, after ``grace``, SIGKILL to the child and to every
        process that was below it and still runs: a rank stuck in a
        collective is not left on the card."""
        tree = _process_tree(proc.pid)
        proc.terminate()
        try:
            proc.wait(timeout=self.grace)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        _kill_survivors(tree)

    def _preempted_since(self, started: float) -> bool:
        """Whether the child recorded a preemption checkpoint after
        ``started`` (``mark_preempted``)."""
        try:
            return os.stat(os.path.join(self.workdir, PREEMPTED_FILE)).st_mtime >= started
        except OSError:
            return False

    def run(self) -> int:
        cmd = list(self.cmd)
        while True:
            self._log("launch", cmd=cmd, restarts=self.restarts)
            started = time.time()
            self.proc = proc = subprocess.Popen(cmd, env=self.env)
            rc, why = self._watch(proc)
            if rc == 0:
                self._log("done")
                return 0
            resumed_cmd = cmd if "--resume" in cmd else cmd + ["--resume"]
            if why == "exit" and (rc == EXIT_PREEMPTED or self._preempted_since(started)):
                # A preemption from outside: the work is saved, resume free
                # of charge.  A hang-kill exits EXIT_PREEMPTED too (our own
                # SIGTERM reaches the child's handler); the ``why`` keeps a
                # stall that recurs inside the failure budget.
                self._log("preempted", rc=rc)
                cmd = resumed_cmd
                continue
            self.restarts += 1
            self._log("failure", rc=rc, why=why, restarts=self.restarts)
            if self.restarts > self.max_restarts:
                self._log("giving_up", rc=rc)
                return rc
            cmd = resumed_cmd


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="supervised training with auto-resume",
        usage="python -m jointpose_torch.resilience [opts] -- <jointpose_torch.train args>",
    )
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--heartbeat-timeout", type=float, default=1800.0)
    parser.add_argument("--start-timeout", type=float, default=3600.0)
    parser.add_argument("--nproc-per-node", type=int, default=0,
                        help="supervise a group of N training processes launched by "
                             "python -m torch.distributed.run (0: one process)")
    parser.add_argument("train_args", nargs=argparse.REMAINDER,
                        help="arguments for jointpose_torch.train after '--'")
    args = parser.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if "--workdir" not in train_args:
        parser.error("train args must include --workdir")
    workdir = train_args[train_args.index("--workdir") + 1]
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(args.nproc_per_node)] if args.nproc_per_node > 0
                else [sys.executable])
    sup = Supervisor(
        [*launcher, "-m", "jointpose_torch.train", *train_args],
        workdir=workdir,
        max_restarts=args.max_restarts,
        heartbeat_timeout=args.heartbeat_timeout,
        start_timeout=args.start_timeout,
    )
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
