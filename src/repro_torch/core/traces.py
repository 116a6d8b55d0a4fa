"""Sequence-length traces and serving-strategy workload orchestration
(paper §V intro, §VI-A "Scenario Setup", §VI-F).

The *sequence length trace* is the novel DSE input of Compass: batches are
sampled from a (input_len, output_len) distribution so the searched mapping /
hardware is conditioned on the serving scenario rather than one fixed shape.

Two built-in scenario families match the paper:
* ShareGPT-like (dialogue): short inputs, long outputs (means 78 / 483);
* GovReport-like (summarisation): long inputs, short outputs (9652 / 602).

Both are modelled as clipped log-normals fitted to the published means (the
real datasets are not shipped; the distribution object also accepts explicit
sample lists, so real traces can be plugged in).

Serving-strategy batch compositions (§VI-F, Fig. 9) are no longer built
here by hand: ``repro_torch.core.streams`` rolls a ``RequestStream`` out under
the *real* ``repro_torch.serving.scheduler`` policies (vLLM-separated,
Orca-mixed, Chunked-Prefill), one shared composition path for search and
serving. ``ServingWorkload`` remains only as the container behind the
legacy ``Scenario(workload=...)`` deprecation shim.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .workload import PREFILL, Request, decode_request, prefill_request


@dataclass
class TraceDistribution:
    """Log-normal (input, output) length distribution, clipped to bounds."""

    name: str
    mean_input: float
    mean_output: float
    sigma_input: float = 1.0
    sigma_output: float = 1.0
    min_len: int = 1
    max_len: int = 161_281  # ShareGPT's observed max (paper §I)

    def _sample_lognormal(self, rng, mean, sigma, n):
        mu = math.log(mean) - sigma**2 / 2.0  # E[lognormal] = exp(mu + s^2/2)
        x = rng.lognormal(mu, sigma, size=n)
        return np.clip(np.round(x), self.min_len, self.max_len).astype(int)

    def sample(self, rng: np.random.Generator, n: int) -> list[tuple[int, int]]:
        ins = self._sample_lognormal(rng, self.mean_input, self.sigma_input, n)
        outs = self._sample_lognormal(rng, self.mean_output, self.sigma_output, n)
        return list(zip(ins.tolist(), outs.tolist()))


SHAREGPT = TraceDistribution("sharegpt", mean_input=78, mean_output=483)
GOVREPORT = TraceDistribution("govreport", mean_input=9652, mean_output=602,
                              sigma_input=0.5, sigma_output=0.5)

TRACES = {"sharegpt": SHAREGPT, "govreport": GOVREPORT}


def prefill_batch(trace: TraceDistribution, rng, batch_size: int) -> list[Request]:
    """A prefill-phase batch: every request processes its full input."""
    return [prefill_request(i) for i, _ in trace.sample(rng, batch_size)]


def decode_batch(trace: TraceDistribution, rng, batch_size: int) -> list[Request]:
    """A decode-phase batch snapshot: context = input + progress * output."""
    reqs = []
    for i, o in trace.sample(rng, batch_size):
        progress = rng.random()
        reqs.append(decode_request(int(i + progress * o) + 1))
    return reqs


def fixed_length_batch(kind: str, length: int, batch_size: int) -> list[Request]:
    """Gemini-style fixed/padded workload (baseline, §VI-A)."""
    if kind == PREFILL:
        return [prefill_request(length) for _ in range(batch_size)]
    return [decode_request(length) for _ in range(batch_size)]


def sample_batches(trace: TraceDistribution, phase: str, batch_size: int,
                   n_batches: int, seed: int = 0) -> list[list[Request]]:
    rng = np.random.default_rng(seed)
    fn = prefill_batch if phase == PREFILL else decode_batch
    return [fn(trace, rng, batch_size) for _ in range(n_batches)]


# --------------------------------------------------------------------------
# Legacy workload container (deprecated — use RequestStream + Scheduler)
# --------------------------------------------------------------------------


@dataclass
class ServingWorkload:
    """A DSE workload = explicit sequence of per-iteration batches.

    Deprecated: batch compositions now come from rolling a
    ``repro_torch.core.streams.RequestStream`` out under a real
    ``repro_torch.serving.scheduler`` policy; ``Scenario(workload=...)`` wraps
    this container into a fixed-batch stream for backwards compatibility.
    """

    name: str
    batches: list[list[Request]]

    def n_requests(self) -> int:
        return sum(len(b) for b in self.batches)
