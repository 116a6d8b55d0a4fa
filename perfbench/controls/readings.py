"""Readings that the limits of a cell's check are set from: the program's
compared numbers and the precision control's (the reference in bfloat16
in the program's place) over many seeds, in one process, at the cell's
own sizes and load with a short window.

    python3 perfbench/controls/readings.py --workload <cell> --seeds 12 --seconds 15 [--first-seed N]

Each seed prints one JSON line; needs the card."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=15)
    a = ap.parse_args()
    for i in range(a.seeds):
        seed = a.first_seed + 7_777 * i
        t = time.perf_counter()
        rec, res = run.run_cell(a.workload, seed, a.seconds, False, t_process=t,
                                control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {c["name"]: c["value"] for c in rec["checks"]},
                          "control": rec["control"],
                          "checked_tokens": rec.get("checked_tokens"),
                          "run": {k: rec[k] for k in ("n_batches", "generations",
                                                      "search_walls_s", "setup_s",
                                                      "tokens", "processed_tokens")
                                  if k in rec},
                          "metrics": res["metrics"]}), flush=True)
        del rec, res
        gc.collect()
        import torch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
