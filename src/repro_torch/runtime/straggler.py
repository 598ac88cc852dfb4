"""Straggler detection & mitigation (a copy of ``repro.runtime.straggler``).

In SPMD training a slow host stalls every collective, so mitigation is (a) detect
— an EMA step-time watchdog flags steps beyond ``threshold``× the smoothed
time; (b) absorb — deep input prefetch (data/pipeline.py) and async
checkpointing keep host-side work off the critical path; (c) act — the
watchdog's callback can skip diagnostics, trigger re-meshing (elastic.py), or
page an operator. The policy object is deliberately dependency-free so it is
testable with injected clocks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    ema: float
    ratio: float


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.0, ema_alpha: float = 0.1,
                 warmup_steps: int = 5,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.threshold = threshold
        self.alpha = ema_alpha
        self.warmup = warmup_steps
        self.on_straggler = on_straggler
        self.ema: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self._seen = 0

    def observe(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        self._seen += 1
        if self.ema is None:
            self.ema = step_time
            return None
        ratio = step_time / max(self.ema, 1e-9)
        ev = None
        if self._seen > self.warmup and ratio > self.threshold:
            ev = StragglerEvent(step=step, step_time=step_time, ema=self.ema,
                                ratio=ratio)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            # do not poison the EMA with the straggler sample
            return ev
        self.ema = self.alpha * step_time + (1 - self.alpha) * self.ema
        return ev
