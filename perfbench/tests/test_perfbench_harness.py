"""The harness on the CPU at tiny sizes: the look for JAX, what the
reference may import, a cell added as files alone, the precision control
and the faults that the check has to catch.

The CPU runs go through ``run.run_cell`` with ``device="cpu"``: the look
for a card is skipped, the rest of a run (set-up, window, check) is the
benchmark's own path, with the port's plain versions of its kernels."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from bench import common  # noqa: E402

TINY_DENSE = dict(name="tiny-dense", vocab=512, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128)
TINY_MOE = dict(name="tiny-moe", vocab=512, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=4, head_dim=16, d_ff=128,
                moe=dict(n_routed=8, n_shared=1, top_k=2, d_expert=32))


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "repro", "repro.core",
            "repro_torch", "repro_torch.core", "reprox", "numpy"]
    assert common.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "repro", "repro.core"]


def test_sources_import_no_jax_and_reference_imports_no_program():
    for p in BENCH.rglob("*.py"):
        if "tests" in p.parts:
            continue
        names = _imports(p)
        assert not names & set(common.FORBIDDEN), (p, names)
        if "reference" in p.parts:
            assert "repro_torch" not in names and "bench" not in names, p


def _copy(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copytree(BENCH, dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_without_the_program_or_a_card_no_result(tmp_path):
    dst = _copy(tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "search.glm4-9b.sharegpt", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=dst, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


E2E = {"search": "search_device_us_per_eval", "open_loop": "throwaway_processed_tokens_per_s",
       "chat": "out_tokens_per_s"}
# end-to-end metrics read from the device trace: a CPU run has none to read
DEVICE_ONLY = {"search_device_us_per_eval"}
OPEN_LOOP_TRAFFIC = {"kind": "open_loop", "about": "throwaway", "arrival": "poisson",
                     "rate_per_s": 4.0,
                     "prompt": {"mean": 768, "sigma": 0.6, "min": 256, "max": 2048},
                     "output": {"mean": 32, "sigma": 0.5, "min": 16, "max": 64},
                     "stratified": True}
OPEN_LOOP_CELL = {"driver": "serve", "chips": 1, "scheduler": "chunked_prefill",
                  "prefill_chunk": 512, "max_batch": 16, "max_len": 2304, "block_len": 16,
                  "check": {"served_tokens": 300, "max_requests": 12,
                            "limits": {"served_logit_gap": 0.001}}}


def _tiny_files(dst: Path, kind: str) -> str:
    """A throwaway configuration, traffic, cell and metric, added as new
    files and new entries of the copy's BENCHMARK.json."""
    b = dst / "perfbench"
    if kind == "search":
        cfg = json.loads((b / "configs/glm4-9b.json").read_text())
        cfg["model"].update(TINY_DENSE)
        t = json.loads((b / "traffic/sharegpt.json").read_text())
        t["n_requests"] = 24
        cell = json.loads((b / "cells/search.glm4-9b.sharegpt.json").read_text())
        cell["ga"].update(population=32, generations=4)
        cell["max_stream_iters"] = 24
    elif kind == "open_loop":
        # no cell of the benchmark is open loop yet: a later one brings its
        # own traffic and cell files, as this one does
        cfg = json.loads((b / "configs/glm4-9b.json").read_text())
        cfg["model"].update(TINY_DENSE)
        t = json.loads(json.dumps(OPEN_LOOP_TRAFFIC))
        cell = json.loads(json.dumps(OPEN_LOOP_CELL))
    else:
        cfg = json.loads((b / "configs/deepseek-moe-16b.json").read_text())
        cfg["model"].update(TINY_MOE)
        t = json.loads((b / "traffic/chat.json").read_text())
        # short answers, so that queued requests are answered in a short window
        t["output"] = {"mean": 24, "sigma": 0.5, "min": 4, "max": 64}
        cell = json.loads((b / "cells/serve.deepseek-moe-16b.chat.json").read_text())
    name = f"throwaway.{kind}"
    cfg["name"] = f"throwaway-{kind}"
    cell.update(config=cfg["name"], traffic=f"throwaway-{kind}", trace_seconds=1)
    (b / f"configs/{cfg['name']}.json").write_text(json.dumps(cfg))
    (b / f"traffic/throwaway-{kind}.json").write_text(json.dumps(t))
    (b / f"cells/{name}.json").write_text(json.dumps(cell))
    (b / f"metrics/throwaway_{kind}_attempted.py").write_text(
        "def read(rec, cell):\n    return float(rec['attempted'])\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": f"perfbench/configs/{cfg['name']}.json",
                             "reduced": cfg["reduced"], "why": "throwaway"})
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": f"throwaway-{kind}", "chips": 1, "why": "x"})
    e2e = E2E[kind]
    if kind == "open_loop":
        (b / f"metrics/{e2e}.py").write_text(
            "def read(rec, cell):\n    return rec['processed_tokens'] / rec['window_s']\n")
        bench["end_to_end"].append({"name": e2e, "unit": "tokens/s", "better": "higher",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": [name]})
    for m in bench["end_to_end"]:
        if m["name"] == e2e and name not in m["workloads"]:
            m["workloads"].append(name)
    bench["per_layer"].append({"name": f"throwaway_{kind}_attempted", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": e2e, "workloads": [name]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def _run_in(dst: Path, name: str, extra: str = "", trace: bool = False,
            seconds: float = 3.0) -> dict:
    """``run.run_cell`` on the CPU in a fresh process in the copy."""
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(dst / 'perfbench')!r})\n"
        "import run\n"
        "from bench.common import forbidden_modules\n"
        f"{extra}\n"
        f"rec, res = run.run_cell({name!r}, 2**31 + 11, {seconds}, {trace}, device='cpu',"
        " t_process=time.perf_counter(), **KW)\n"
        "print(json.dumps({'res': res, 'checks': rec['checks'],"
        " 'forbidden': forbidden_modules(), 'control': rec.get('control')}))\n")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=dst, capture_output=True,
                       text=True, timeout=900, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture
def copy_with_src(tmp_path):
    dst = _copy(tmp_path)
    os.symlink(ROOT / "src", dst / "src")
    return dst


@pytest.mark.parametrize("kind", ["search", "open_loop", "chat"])
def test_cell_added_as_files_runs_and_control_fails(copy_with_src, kind):
    """A new cell, configuration, traffic mix and metric, all new files:
    the harness finds them by name, edits nothing that was there, loads no
    JAX, is correct, and its precision control reads past every limit it
    is held to."""
    dst = copy_with_src
    before = {p: p.read_bytes() for p in (dst / "perfbench").rglob("*") if p.is_file()}
    name = _tiny_files(dst, kind)
    out = _run_in(dst, name, "KW = dict(control=True)",
                  seconds=3.0 if kind == "search" else 6.0)
    after = {p: p.read_bytes() for p in before}
    assert after == before
    res = out["res"]
    assert res["correct"], out["checks"]
    assert set(res["metrics"]) == {E2E[kind], "setup_s"} - DEVICE_ONLY
    assert out["forbidden"] == []
    limits = {c["name"]: c["limit"] for c in out["checks"]}
    control = out["control"]
    assert any(control[k] > limits[k] for k in control), (control, limits)


def test_search_readers_take_the_whole_window():
    import run

    rec = {"kind": "search", "evals": 5120, "window_s": 50.0, "traced_evals": 6144,
           "trace": {"busy_s": 0.0384, "window_s": 50.0}}
    assert run.metric_reader("search_device_us_per_eval")(rec, {}) == 6.25
    assert run.metric_reader("search.evals_per_s")(rec, {}) == 102.4
    # no trace (a run off the card), or nothing traced: nothing to read
    assert run.metric_reader("search_device_us_per_eval")(dict(rec, trace=None), {}) is None
    assert run.metric_reader("search_device_us_per_eval")(dict(rec, traced_evals=0), {}) is None


SEARCH_FAULTS = {
    # an answer altered where it is produced
    "answer_altered": "def f(lat, en):\n    lat = lat.copy(); lat[0, 0] *= 1.001\n    return lat, en\n",
    # half of the batches left out, the rest standing in for them
    "half_batch": ("def f(lat, en):\n    lat, en = lat.copy(), en.copy(); h = lat.shape[0] // 2\n"
                   "    lat[h:2 * h] = lat[:h]; en[h:2 * h] = en[:h]\n    return lat, en\n"),
    # a pass that returns its input unchanged: every batch as the first
    "state_unchanged": ("def f(lat, en):\n    import numpy as np\n"
                        "    return np.repeat(lat[:1], lat.shape[0], 0), np.repeat(en[:1], en.shape[0], 0)\n"),
}
# faults planted in the search's genetic algorithm and in its answer
GA_FAULTS = {
    # the tournament keeps the worst entrant
    "selection_inverted": ("import repro_torch.core.ga as G\n_t = G.tournament_select\n"
                           "G.tournament_select = lambda rng, s, k, n: _t(rng, -s, k, n)\n"),
    # children are copies of their first parent: no crossover, no mutation
    "no_variation": ("import repro_torch.core.ga as G\n"
                     "G.crossover_population = lambda rng, sa, la, sb, lb: (sa.copy(), la.copy())\n"
                     "G.mutate_population = lambda *a, **k: None\n"),
    # the search's answer altered where it is produced
    "result_altered": ("import dataclasses\nimport repro_torch.core.compass as C\n_f = C._finalise\n"
                       "C._finalise = lambda *a, **k: dataclasses.replace("
                       "_f(*a, **k), energy_j=_f(*a, **k).energy_j * 1.001)\n"),
}
SERVE_FAULTS = {
    "token_altered": "def f(rid, i, tok):\n    return (tok + 1) % 512 if i == 2 else tok\n",
    "half_batch": "def f(rid, i, tok):\n    return 0 if rid % 2 and i > 0 else tok\n",
    "state_unchanged": "LAST = {}\ndef f(rid, i, tok):\n    LAST.setdefault(rid, tok)\n    return LAST[rid]\n",
}


@pytest.mark.parametrize("fault", sorted(SEARCH_FAULTS))
def test_search_faults_are_not_correct(copy_with_src, fault):
    dst = copy_with_src
    name = _tiny_files(dst, "search")
    out = _run_in(dst, name, SEARCH_FAULTS[fault] + "KW = dict(break_eval=f)")
    assert not out["res"]["correct"], out["checks"]
    gap = {c["name"]: c for c in out["checks"]}["eval_rel_gap"]
    assert gap["value"] > gap["limit"] and gap["value"] != float("inf")


@pytest.mark.parametrize("fault", sorted(GA_FAULTS))
def test_search_ga_faults_are_not_correct(copy_with_src, fault):
    dst = copy_with_src
    name = _tiny_files(dst, "search")
    # the program's modules are patched before the run imports them
    out = _run_in(dst, name, "sys.path.insert(0, 'src')\n" + GA_FAULTS[fault] + "KW = {}")
    assert not out["res"]["correct"], out["checks"]
    checks = {c["name"]: c for c in out["checks"]}
    assert checks["eval_rel_gap"]["ok"]
    key = "search_result_rel_gap" if fault == "result_altered" else "ga_individuals_differing"
    assert checks[key]["value"] > checks[key]["limit"], checks
    assert checks[key]["value"] != float("inf")


@pytest.mark.parametrize("kind", ["open_loop", "chat"])
@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_serve_faults_are_not_correct(copy_with_src, kind, fault):
    dst = copy_with_src
    name = _tiny_files(dst, kind)
    out = _run_in(dst, name, SERVE_FAULTS[fault] + "KW = dict(break_tokens=f)",
                  seconds=6.0)
    assert not out["res"]["correct"], out["checks"]
    gap = {c["name"]: c for c in out["checks"]}["served_logit_gap"]
    assert gap["value"] > gap["limit"] and gap["value"] != float("inf")


# the program rounds the weights it was given to bfloat16, in place
WEIGHTS_ROUNDED = """import torch
import bench.weights as W
_pm = W.port_model
def pm(cfg, w):
    with torch.no_grad():
        for v in w.values():
            v.copy_(v.to(torch.bfloat16).float())
    return _pm(cfg, w)
W.port_model = pm
KW = {}
"""


@pytest.mark.parametrize("kind", ["open_loop", "chat"])
def test_serve_weights_changed_in_place_are_not_correct(copy_with_src, kind):
    """The reference draws its own weights: a program that alters the
    tensors it was handed cannot carry the reference along."""
    dst = copy_with_src
    name = _tiny_files(dst, kind)
    out = _run_in(dst, name, WEIGHTS_ROUNDED, seconds=6.0)
    assert not out["res"]["correct"], out["checks"]
    gap = {c["name"]: c for c in out["checks"]}["served_logit_gap"]
    assert gap["value"] > gap["limit"] and gap["value"] != float("inf")


@pytest.mark.cuda
def test_cells_on_the_card_are_correct():
    """Every cell of BENCHMARK.json, one short run each on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", w["name"],
                            "--seed", "4242", "--seconds", "10", "--trace", "0"],
                           cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
