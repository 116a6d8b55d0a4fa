"""What every run of the benchmark shares: where things are, the
environment it gives the program, the look for JAX in the process, the
records of one run and the result line."""
from __future__ import annotations

import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]       # the benchmark's folder
ROOT = BENCH.parent                               # the checkout
# top-level module names that may not be loaded in a run: JAX and the
# JAX package the port was made from (compared whole: the port's own name
# begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# published H100 SXM peaks (NVIDIA's data sheet; dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def prepare_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, the
    port's source on the path, and no JAX pulled in by a library. Thread
    counts are left as the process finds them."""
    cache = ROOT / ".benchcache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_json(*parts: str) -> dict:
    with open(BENCH.joinpath(*parts)) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's file with its configuration and traffic files read in."""
    cell = load_json("cells", f"{name}.json")
    cell["name"] = name
    cell["config_data"] = load_json("configs", f"{cell['config']}.json")
    cell["traffic_data"] = load_json("traffic", f"{cell['traffic']}.json")
    return cell


class Spans:
    """Named host-clock spans of the harness's own calls into the program,
    kept in memory and read after the run."""

    def __init__(self):
        self.spans: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + seconds

    class _Span:
        def __init__(self, owner, name):
            self.owner, self.name = owner, name

        def __enter__(self):
            self.t = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.owner.add(self.name, time.perf_counter() - self.t)
            return False

    def span(self, name: str):
        return self._Span(self, name)


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def device_block(torch, count: int, peak_bytes: int, trace: dict | None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        d["busy_s"] = trace["busy_s"]
        d["window_s"] = trace["window_s"]
    return d


def print_checks(checks: list[dict]) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    sys.stderr.flush()


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list[dict], breakdown: dict | None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # JSON has no infinity: a number that could not be read is null here
    # (its stderr line above keeps the reading)
    out["checks"] = {c["name"]: {"value": c["value"] if finite(c["value"]) else None,
                                 "limit": c["limit"]} for c in checks}
    return json.dumps(out)


def check(name: str, value: float, limit: float) -> dict:
    """A compared number: it passes when it is finite and at most its
    limit."""
    ok = finite(value) and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}
