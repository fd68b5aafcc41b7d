"""Failure detection and crash recovery for host-side simulators.

The reference's one load-bearing reliability subsystem (reference:
mass/utils/experimentation.py:40-87, SURVEY.md §5.3): a SIGALRM
watchdog around every simulator call (Unity can hang unrecoverably) and
an infinite-retry experiment runner; progress survives restarts because
the driver advances its task cursor after each completed task.
"""

from __future__ import annotations

import os
import signal
import stat
from typing import Callable, Tuple, Type


class SimulatorCrashError(RuntimeError):
    """Raised when a simulator call times out or dies."""


class Watchdog:
    """SIGALRM timeout context for simulator-touching calls (reference:
    TimeoutDueToUnityCrash, mass/utils/experimentation.py:40-58)."""

    def __init__(self, seconds: int = 60):
        self.seconds = seconds

    def _handle(self, signum, frame):
        raise SimulatorCrashError(
            f"simulator unresponsive for {self.seconds}s")

    def __enter__(self):
        signal.signal(signal.SIGALRM, self._handle)
        signal.alarm(self.seconds)
        return self

    def __exit__(self, exc_type, exc, tb):
        signal.alarm(0)
        return False


def run_with_restart(fn: Callable, *args,
                     retry_on: Tuple[Type[BaseException], ...] = (
                         SimulatorCrashError,),
                     max_restarts: int = None, **kwargs):
    """Re-invoke ``fn`` until it returns without a simulator crash
    (reference: run_experiment_with_restart,
    mass/utils/experimentation.py:61-74).  ``fn`` must advance its own
    progress cursor so restarts skip completed work."""
    restarts = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as error:  # noqa: PERF203
            restarts += 1
            print(f"Restarting due to: {error}")
            if max_restarts is not None and restarts > max_restarts:
                raise


def force_remove_readonly(func, path, exc_info):
    """shutil.rmtree onerror hook clearing read-only bits (the simulator
    leaves read-only lock files; reference:
    mass/utils/experimentation.py:77-87)."""
    if not os.access(path, os.W_OK):
        os.chmod(path, stat.S_IWUSR)
        func(path)
