"""Periodic triggers and named wall-clock sections.

The port's copy of ``latent_diffusion_planning_tpu/utils/timers.py``'s
``Every`` and ``Timer``. A section measures host time: work the device still
has queued at its end is not in it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Every:
    """True once every ``period`` steps (step 0 counts)."""

    def __init__(self, period: int | None):
        self.period = period

    def __call__(self, step: int) -> bool:
        return bool(self.period) and step % self.period == 0


class Timer:
    """Named tick/tock accumulators with running averages."""

    def __init__(self) -> None:
        self._start: dict[str, float] = {}
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    def tick(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def tock(self, name: str) -> float:
        dt = time.perf_counter() - self._start.pop(name)
        self._total[name] += dt
        self._count[name] += 1
        return dt

    @contextlib.contextmanager
    def section(self, name: str):
        self.tick(name)
        try:
            yield
        finally:
            self.tock(name)

    def averages(self, reset: bool = True) -> dict[str, float]:
        out = {f"time/{k}": self._total[k] / max(1, self._count[k])
               for k in self._total}
        if reset:
            self._total.clear()
            self._count.clear()
        return out
