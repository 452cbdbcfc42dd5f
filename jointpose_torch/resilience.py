"""Preemption of a training run (counterpart of the preemption hook of
``jointpose/resilience.py``).

SIGTERM, the usual preemption signal of a scheduler, flips a flag that
``train.fit`` reads once per step; the loop then checkpoints at that step
boundary and exits with ``EXIT_PREEMPTED``, so that a scheduler (or a
person) can restart the run with ``--resume`` and lose no step.
"""

from __future__ import annotations

import signal
import sys

EXIT_PREEMPTED = 85  # exit code of a run that checkpointed on preemption


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
