"""Failure injection + restart policy for fault-tolerance testing (a copy
of ``repro.runtime.fault``).

``FailureInjector`` raises ``InjectedFailure`` at configured steps —
standing in for preemptions / host crashes. ``run_with_restarts`` wraps a
training driver: on failure it re-enters the driver, which resumes from the
latest checkpoint (the driver owns restore logic). This mirrors the
orchestrator-level restart loop of a real cluster scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Set


class InjectedFailure(RuntimeError):
    pass


class FailureInjector:
    def __init__(self, fail_at_steps: Iterable[int] = (), max_failures: int = 10):
        self.fail_at: Set[int] = set(fail_at_steps)
        self.max_failures = max_failures
        self.failures: List[int] = []

    def maybe_fail(self, step: int):
        if step in self.fail_at and len(self.failures) < self.max_failures:
            self.fail_at.discard(step)
            self.failures.append(step)
            raise InjectedFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class RestartReport:
    restarts: int
    completed: bool
    final_step: int


def run_with_restarts(driver: Callable[[], int], max_restarts: int = 5) -> RestartReport:
    """driver() runs/resumes training and returns the final step; raises on
    (injected) failure. Returns how many restarts were needed."""
    restarts = 0
    while True:
        try:
            final = driver()
            return RestartReport(restarts=restarts, completed=True,
                                 final_step=final)
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                return RestartReport(restarts=restarts, completed=False,
                                     final_step=-1)
