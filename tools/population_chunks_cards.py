"""Population chunks across several cards against one card.

On the canonical llama3.2-3b search scenario's graph (3 ShareGPT prefill
batches of 8, 4 blocks; a hardware point of rows 4 x M 80), for the dense,
kernel and fused backends at P 64, 512 and 4,096, times
``GroupPopulationEvaluator.evaluate_population`` with

* ``one``: ``device="cuda:0"``, the unsplit path;
* ``cards``: one chunk on each visible card (``device=[cuda:0, ...]``);
* ``chunks``: as many chunks, all on cuda:0;

checks that the three give equal results bit for bit, and prints the host
wall of each call (each call ends in a host copy of its outputs, so a wall
includes every card's work) as medians of ``--reps`` calls in turns. Then
one ``search_mapping`` (GA 512 x 16, fused) on ``cuda:0`` and split over
every card, equal in score and encodings, walls in turns. Needs two cards
or more:

  python3 tools/population_chunks_cards.py [--reps 7]

Prints one JSON object per line, the cards' names and power limits first;
the same lines go to ``chiprun_out/population_chunks_cards.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

POPS = (64, 512, 4096)
BACKENDS = ("dense", "kernel", "fused")


def _emit(obj, out) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def _scenario():
    from repro_torch.configs import llm_spec
    from repro_torch.core.compass import Scenario
    from repro_torch.core.streams import RequestStream
    from repro_torch.core.traces import SHAREGPT, sample_batches

    batches = sample_batches(SHAREGPT, "prefill", 8, 3, seed=0)
    return Scenario("llama3_2_3b_prefill", llm_spec("llama3.2-3b"),
                    target_tops=512,
                    stream=RequestStream.fixed_batches(batches), n_blocks=4)


def _walls(fns: dict, reps: int) -> dict:
    """Median host ms per call of each callable, called in turns
    (a, b, c, c, b, a, ...) after one warm-up call each."""
    for fn in fns.values():
        fn()
    got = {k: [] for k in fns}
    keys = list(fns)
    for r in range(reps):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            t0 = time.perf_counter()
            fns[k]()
            got[k].append(1e3 * (time.perf_counter() - t0))
    return {k: statistics.median(v) for k, v in got.items()}


def _same(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"population_chunks_cards: needs two cards or more, found {n}",
              file=sys.stderr)
        return 1
    from repro_torch.core.compass import search_mapping
    from repro_torch.core.encoding import random_encoding
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.timing import get_graph_and_tables
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = open(os.path.join(ROOT, "chiprun_out",
                            "population_chunks_cards.jsonl"), "w")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    _emit({"cards": smi, "count": n, "torch": torch.__version__}, out)

    os.environ["REPRO_FUSED_GRID_ORDER"] = "batch_major"   # no probe
    scenario = _scenario()
    hw = make_hardware(scenario.target_tops, tensor_parallel=8,
                       micro_batch_prefill=2)
    batches = scenario.rollout().batches
    pairs = [get_graph_and_tables(scenario.spec, b, hw, 2, scenario.n_blocks)
             for b in batches]
    graphs, tables = [g for g, _ in pairs], [t for _, t in pairs]
    g = graphs[0]
    rng = np.random.default_rng(28)
    cards = [torch.device("cuda", i) for i in range(n)]
    devices = {"one": "cuda:0", "cards": cards,
               "chunks": [torch.device("cuda", 0)] * n}
    ok = True
    for backend in BACKENDS:
        evs = {k: GroupPopulationEvaluator(graphs, tables, hw,
                                           backend=backend, device=d)
               for k, d in devices.items()}
        for p in POPS:
            encs = [random_encoding(rng, g.rows, g.n_cols, hw.n_chiplets)
                    for _ in range(p)]
            res = {k: ev.evaluate_population(encs) for k, ev in evs.items()}
            same = _same(res["one"], res["cards"]) \
                and _same(res["one"], res["chunks"])
            ok &= same
            ms = _walls({k: (lambda ev=ev: ev.evaluate_population(encs))
                         for k, ev in evs.items()}, args.reps)
            _emit({"backend": backend, "population": p, "chunks": n,
                   "bitwise": same, "ms_per_call": ms,
                   "cards_over_one": ms["cards"] / ms["one"],
                   "cards_over_chunks": ms["cards"] / ms["chunks"]}, out)

    mbs = [scenario.micro_batch(hw, b) for b in batches]
    ga = GAConfig(population=512, generations=16, seed=0)

    def search(dev):
        return search_mapping(scenario.spec, batches, hw, mbs, ga,
                              n_blocks=scenario.n_blocks,
                              timing_backend="fused", device=dev)

    o1, on = search("cuda:0"), search(cards)
    same = (o1.score == on.score and all(
        np.array_equal(o1.encodings[k].layer_to_chip,
                       on.encodings[k].layer_to_chip)
        and np.array_equal(o1.encodings[k].segmentation,
                           on.encodings[k].segmentation)
        for k in o1.encodings))
    ok &= same
    ms = _walls({"one": lambda: search("cuda:0"),
                 "every_card": lambda: search(cards)}, 3)
    _emit({"search": "fused", "population": 512, "generations": 16,
           "chunks": n, "equal": same, "score": o1.score,
           "ms_per_search": ms,
           "every_card_over_one": ms["every_card"] / ms["one"]}, out)
    out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
