"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``cells/<cell>.json``) names its configuration
(``configs/``), its traffic (``traffic/``) and its driver; the metrics it
reports are the entries of ``BENCHMARK.json`` that list it (or list no
cells), each read by ``metrics/<name>.py``. With ``--trace 0`` they are
the end-to-end metrics, with ``--trace 1`` the per-layer ones. The last
line of standard output is the result; each compared number and its limit
are the last lines of standard error."""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from bench import common  # noqa: E402


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: float | None = None,
             **driver_kw) -> tuple[dict, dict]:
    """The cell's run record and its result (the dict the last line
    prints). ``device`` and ``driver_kw`` are for the benchmark's own
    tests on the CPU."""
    common.prepare_environment()
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = common.load_cell(name)
    cell["traffic_data"].update(driver_kw.pop("traffic_override", {}))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cell["driver"] == "search":
        from bench import search as driver
    elif cell["driver"] == "serve":
        from bench import serve as driver
    else:
        raise ValueError(f"unknown driver {cell['driver']!r}")
    rec = driver.run(cell, seed, seconds, trace, device,
                     T_PROCESS if t_process is None else t_process, **driver_kw)
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        v = metric_reader(m["name"])(rec, cell)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(c["ok"] for c in rec["checks"]) and rec["attempted"] > 0
    return rec, {"correct": correct, "metrics": metrics}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    common.prepare_environment()
    import torch

    cell = common.load_cell(a.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    rec, res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = common.forbidden_modules()
    if bad:
        print(f"no result: the process loaded {bad}", file=sys.stderr)
        return 4
    print("setup_split_s " + json.dumps(rec["setup_split"]))
    print("run " + json.dumps({k: rec[k] for k in rec
                               if k in ("window_wall_s", "setup_s", "generations",
                                        "evals", "searches_finished", "search_walls_s",
                                        "window_cpu_s", "traced_evals",
                                        "search_eval_walls_s", "search_setup_walls_s",
                                        "reference_weights_s", "check_s",
                                        "allocated_before_reference",
                                        "requests", "tokens", "decode_calls",
                                        "checked_tokens", "control")}))
    trace = rec.get("trace")
    device = common.device_block(torch, chips, rec["peak_bytes"],
                                 trace if a.trace else None)
    common.print_checks(rec["checks"])
    print(common.result_line(res["correct"], rec["attempted"], rec["failed"],
                             res["metrics"], device, rec["checks"],
                             trace["breakdown"] if (a.trace and trace) else None),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
