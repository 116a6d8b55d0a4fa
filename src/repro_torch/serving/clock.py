"""Pluggable service clocks: deterministic iteration time vs wall time.

The sim-to-real contract hinges on the service being drivable under two
notions of time:

* :class:`IterationClock` — time *is* the scheduler iteration index. The
  engine loop advances it; arrival coroutines sleep on it. Every run is
  bit-reproducible, which is what lets the parity suite demand the async
  service's admission order and per-iteration membership equal
  ``plan_rollout`` exactly.
* :class:`WallClock` — iteration units mapped onto real seconds
  (``period_s`` per iteration). Arrivals happen in real time; the measured
  benchmark uses it to hold wall-clock TTFT/TPOT against the planned
  schedule.
"""
from __future__ import annotations

import asyncio
import time


class IterationClock:
    """Virtual clock counting scheduler iterations; engine-driven."""

    deterministic = True

    def __init__(self):
        self.now: float = -1.0          # before iteration 0
        self._waiters: list[tuple[float, asyncio.Event]] = []

    async def sleep_until(self, t: float) -> None:
        while self.now < t:
            ev = asyncio.Event()
            self._waiters.append((t, ev))
            await ev.wait()

    def advance(self, t: float) -> None:
        if t <= self.now:
            return
        self.now = t
        still = []
        for due, ev in self._waiters:
            if due <= self.now:
                ev.set()
            else:
                still.append((due, ev))
        self._waiters = still


class WallClock:
    """Real time, expressed in iteration units of ``period_s`` seconds."""

    deterministic = False

    def __init__(self, period_s: float = 0.01):
        self.period_s = float(period_s)
        self._t0 = time.perf_counter()

    @property
    def now(self) -> float:
        return (time.perf_counter() - self._t0) / self.period_s

    async def sleep_until(self, t: float) -> None:
        dt = (t - self.now) * self.period_s
        if dt > 0:
            await asyncio.sleep(dt)

    def advance(self, t: float) -> None:   # engine cannot steer real time
        pass
