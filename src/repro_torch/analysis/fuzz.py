"""Fuzz harness: analyzer-accepts <=> oracle-prices-cleanly.

The port's copy of the JAX package's harness, run against the port's own
analyzer and numpy oracle; it touches no device.

The acceptance contract of the legality analyzer is behavioural, not
syntactic: an encoding the analyzer accepts must price through the numpy
oracle without error and produce finite, causally-consistent timings; an
encoding it rejects must be refused by the strict evaluator gate
(``repro_torch.core.evaluator.evaluate(..., verify=True)`` — the same check the
``REPRO_VERIFY_MAPPINGS=1`` debug gate enables). This module drives that
equivalence over randomly bred *and* randomly corrupted encodings.

Run as a module for the CI smoke / the full acceptance sweep:

    PYTHONPATH=src python -m repro_torch.analysis.fuzz --n 10000 --seed 0

The corpus mixes (per trial): a clean ``random_encoding`` draw, a GA
crossover+mutation child of two clean draws, and with probability
``p_corrupt`` one targeted corruption (out-of-range chiplet id, negative
id, non-binary segmentation bit) whose intended rule id is asserted when
the analyzer rejects. Results: every accepted encoding is priced (finite
latency/energy, non-negative op end times); every rejected encoding makes
the strict gate raise ``MappingLegalityError``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..core.encoding import StackedPopulation, random_encoding
from ..core.ga import crossover, mutate
from .diagnostics import is_legal
from .mapping import (
    MappingLegalityError,
    population_legal_mask,
    verify_encoding,
)


@dataclasses.dataclass
class FuzzReport:
    trials: int = 0
    accepted: int = 0
    rejected: int = 0
    corrupted: int = 0
    # contract violations (must all stay 0)
    accepted_but_failed: int = 0
    rejected_but_priced: int = 0
    wrong_rule: int = 0

    @property
    def ok(self) -> bool:
        return not (self.accepted_but_failed or self.rejected_but_priced
                    or self.wrong_rule)


def _small_scenario():
    """A tiny-but-real mixed prefill+decode execution graph and hardware
    point: small enough that 10k oracle evaluations stay in seconds, real
    enough that every cost-table term is exercised."""
    from ..configs import all_archs
    from ..core.hardware import make_hardware
    from ..core.workload import build_execution_graph, decode_request, \
        prefill_request

    spec = all_archs()["llama3.2-3b"].llm_spec()
    hw = make_hardware(64, "S", tensor_parallel=1)
    batch = [prefill_request(48), decode_request(96)]
    graph = build_execution_graph(spec, batch, micro_batch_size=1, tp=1,
                                  n_blocks=1)
    return graph, hw


def _corrupt(rng: np.random.Generator, enc):
    """Apply one targeted corruption; returns (encoding, expected rule)."""
    kind = int(rng.integers(3))
    enc = enc.copy()
    b = int(rng.integers(enc.rows))
    l = int(rng.integers(enc.n_cols))
    if kind == 0:       # out-of-range chiplet id (high)
        enc.layer_to_chip[b, l] = 10_000
        return enc, "MAP003"
    if kind == 1:       # negative chiplet id — numpy fancy indexing would
        enc.layer_to_chip[b, l] = -1          # wrap this silently
        return enc, "MAP003"
    if len(enc.segmentation):                 # non-binary segmentation bit
        enc.segmentation[int(rng.integers(len(enc.segmentation)))] = 2
        return enc, "MAP002"
    enc.layer_to_chip[b, l] = -1
    return enc, "MAP003"


def run_fuzz(n: int = 10_000, seed: int = 0, p_corrupt: float = 0.4,
             progress_every: int = 0) -> FuzzReport:
    from ..core.evaluator import CostTables, evaluate

    graph, hw = _small_scenario()
    tables = CostTables.build(graph, hw)
    rng = np.random.default_rng(seed)
    rows, m_cols, chips = graph.rows, graph.n_cols, hw.n_chiplets
    rep = FuzzReport()

    for i in range(n):
        # breed: clean draw or GA child (crossover + phase-random mutation)
        if rng.random() < 0.5:
            enc = random_encoding(rng, rows, m_cols, chips)
        else:
            a = random_encoding(rng, rows, m_cols, chips)
            b = random_encoding(rng, rows, m_cols, chips)
            enc = crossover(rng, a, b)
            mutate(rng, enc, chips, progress=float(rng.random()))
        expected = None
        if rng.random() < p_corrupt:
            enc, expected = _corrupt(rng, enc)
            rep.corrupted += 1

        diags = verify_encoding(enc, chips, graph=graph)
        legal = is_legal(diags)
        # the vectorised fast path must agree with the diagnostic path
        mask = population_legal_mask(
            StackedPopulation(enc.segmentation[None],
                              enc.layer_to_chip[None]),
            chips, graph=graph)
        assert bool(mask[0]) == legal, "mask/diagnostic paths disagree"
        if expected is not None and legal:
            rep.wrong_rule += 1
        elif expected is not None and expected not in {d.rule for d in diags}:
            rep.wrong_rule += 1

        if legal:
            rep.accepted += 1
            try:
                res = evaluate(graph, enc, hw, tables=tables, verify=True)
                clean = (np.isfinite(res.latency_s) and res.latency_s > 0
                         and np.isfinite(res.energy_j)
                         and (res.op_end_s >= 0).all())
            except Exception:
                clean = False
            if not clean:
                rep.accepted_but_failed += 1
        else:
            rep.rejected += 1
            try:
                evaluate(graph, enc, hw, tables=tables, verify=True)
                rep.rejected_but_priced += 1
            except MappingLegalityError:
                pass
        rep.trials += 1
        if progress_every and (i + 1) % progress_every == 0:
            print(f"  {i + 1}/{n}: {rep.accepted} accepted,"
                  f" {rep.rejected} rejected, violations="
                  f"{rep.accepted_but_failed + rep.rejected_but_priced + rep.wrong_rule}")
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000,
                    help="number of fuzzed encodings (acceptance bar: 10k)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--p-corrupt", type=float, default=0.4)
    ap.add_argument("--progress-every", type=int, default=2000)
    args = ap.parse_args(argv)
    rep = run_fuzz(args.n, args.seed, args.p_corrupt, args.progress_every)
    print(f"fuzz: {rep.trials} trials, {rep.accepted} accepted,"
          f" {rep.rejected} rejected ({rep.corrupted} corrupted);"
          f" accepted_but_failed={rep.accepted_but_failed},"
          f" rejected_but_priced={rep.rejected_but_priced},"
          f" wrong_rule={rep.wrong_rule}")
    if not rep.ok:
        print("FUZZ CONTRACT VIOLATED")
        return 1
    print("ok: analyzer-accepts <=> oracle-prices-cleanly held on every trial")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
