"""Batched BO across several cards against one card (ROADMAP F2).

``explore(bo_batch=4)`` on the canonical llama3.2-3b prefill scenario (3
ShareGPT prefill batches of 8, 4 blocks; GA 64 x 4; BO 4 initial and 4
proposed points), as ``tests/test_torch_search.py::
test_batched_bo_across_cards_matches_one_card`` runs it, twice:

* ``spread``: ``device=None``, unpinned — each batch's points priced
  concurrently, one mapping search per point, pinned round robin to the
  visible cards, from a thread each;
* ``one``: ``device="cuda:0"`` — the same points priced one after another.

Checks that both propose the same points and give the same scores, counts
the fused mapping-eval launches and reads each card's peak allocated
bytes (which cards did work), and prints the host wall of each
``explore`` (to a sync of every card), warm, in turns (spread, one, one,
spread, ...). Needs two cards or more:

  python3 tools/batched_bo_cards.py [--reps 2]

Prints one JSON object per line, the cards' names and power limits first;
the same lines go to ``chiprun_out/batched_bo_cards.jsonl``.
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


def _emit(obj, out) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def _explore(device):
    """(the result, host seconds, the fused launches, the peak bytes
    allocated on each card) of one ``explore`` on ``device``."""
    import torch

    from repro_torch.configs import llm_spec
    from repro_torch.core.compass import Scenario, explore
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.streams import RequestStream
    from repro_torch.core.traces import SHAREGPT, sample_batches
    from repro_torch.kernels import ops

    sc = Scenario("llama3_2_3b_prefill", llm_spec("llama3.2-3b"),
                  target_tops=512, n_blocks=4,
                  stream=RequestStream.fixed_batches(
                      sample_batches(SHAREGPT, "prefill", 8, 3, seed=0)))
    cfg = GAConfig(population=64, generations=4, seed=0)
    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = explore(sc, bo_iters=4, bo_init=4, ga_config=cfg, seed=0,
                  bo_batch=4, device=device)
    for i in cards:
        torch.cuda.synchronize(i)
    wall = time.perf_counter() - t0
    return (res, wall, ops.launch_counts()["mapping_eval_fused"],
            [torch.cuda.max_memory_allocated(i) for i in cards])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("batched_bo_cards: needs two CUDA cards or more",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    with open(os.path.join(ROOT, "chiprun_out", "batched_bo_cards.jsonl"),
              "w") as out:
        _emit({"cards": cards, "count": torch.cuda.device_count()}, out)
        runs = {"spread": None, "one": "cuda:0"}
        first = {k: _explore(dev) for k, dev in runs.items()}
        spread, one = first["spread"][0], first["one"][0]
        same = ([p.key() for p in spread.bo.points]
                == [p.key() for p in one.bo.points]
                and spread.bo.scores == one.bo.scores)
        _emit({"run": "parity", "points": len(spread.bo.points),
               "same_points_and_scores": same,
               "best_score": spread.bo.best_score,
               "fused_launches": {k: r[2] for k, r in first.items()},
               "peak_bytes_per_card": {k: r[3] for k, r in first.items()},
               "first_wall_s": {k: r[1] for k, r in first.items()}}, out)
        walls = {k: [] for k in runs}
        keys = list(runs)
        for r in range(args.reps):
            for k in (keys if r % 2 == 0 else keys[::-1]):
                walls[k].append(_explore(runs[k])[1])
        _emit({"run": "walls", "reps": args.reps, "wall_s": walls,
               "median_s": {k: statistics.median(v)
                            for k, v in walls.items()},
               "spread_over_one": statistics.median(walls["spread"])
               / statistics.median(walls["one"])}, out)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
