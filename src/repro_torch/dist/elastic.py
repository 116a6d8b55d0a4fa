"""Elastic-capacity helpers: mesh derivation from the currently-healthy
chip count and a step-time straggler monitor. A copy of the JAX package's
``dist/elastic.py``."""
from __future__ import annotations

from dataclasses import dataclass


def current_mesh_shape(n_chips: int, model_axis: int) -> tuple[int, int, int]:
    """(pod, data, model) mesh for ``n_chips`` healthy chips with a fixed
    model axis: keep 2 pods whenever the chip count allows, absorb capacity
    changes on the data axis (the only axis that can shrink without
    resharding model-parallel params)."""
    assert n_chips % model_axis == 0, (n_chips, model_axis)
    pod = 2 if n_chips % (2 * model_axis) == 0 and n_chips >= 2 * model_axis else 1
    return (pod, n_chips // (pod * model_axis), model_axis)


@dataclass
class StragglerMonitor:
    """EWMA step-time monitor: ``step(t)`` returns True when ``t`` exceeds
    ``factor`` x the running mean. Slow steps do not pollute the EWMA."""

    factor: float = 2.0
    alpha: float = 0.2
    ewma: float | None = None
    slow_steps: int = 0

    def step(self, seconds: float) -> bool:
        if self.ewma is None:
            self.ewma = float(seconds)
            return False
        slow = seconds > self.factor * self.ewma
        if slow:
            self.slow_steps += 1
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return slow
