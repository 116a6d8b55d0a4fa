"""BENCHMARK.json and the benchmark's files against the benchmark's own
rules: names, units and text; every entry's file; which cell reports
which metric; the chip-time budget of a full check."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|"
                   r"_dim$|_rank$|experts_per_tok|kv_channels|ffn_hidden)")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def bench():
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def _line(s: str, lo: int = 1, hi: int = 200) -> bool:
    return isinstance(s, str) and lo <= len(s) <= hi and "\n" not in s and "\t" not in s


def test_keys_and_text(bench):
    assert set(bench) == KEYS["top"]
    for group, kind in (("configs", "config"), ("workloads", "workload"),
                        ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        for e in bench[group]:
            required = KEYS[kind] - {"workloads"}
            assert required <= set(e) <= KEYS[kind], (group, e.get("name"))
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[g]]
    for g in ("configs", "workloads"):
        assert len({e["name"] for e in bench[g]}) == len(bench[g])
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_command_paths_and_budget(bench):
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w.split("/") for w in cmd)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    files = [w for w in cmd if "/" in w]
    assert all(any(f.startswith(p + "/") for p in bench["paths"]) for f in files)
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with the most cells later PRs may reach must fit
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_bounds(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names and 1 <= len(bench["end_to_end"]) <= 16
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        if m["name"] == "setup_s":
            assert m["bound"] <= 0.25


def test_files_exist_and_configs_are_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        for k in c["reduced"]:
            assert not WIDTH.search(k), k
            assert k in data and data[k] != data["published"][k], k
        assert (BENCH / "configs" / f"{c['name']}.json") == ROOT / c["file"]
    for w in bench["workloads"]:
        cell = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell.get("chips", 1) == w["chips"]
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_and_moves_are_reported(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for c in m.get("workloads", []):
            assert c in cells, (m["name"], c)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert _reports(e2e[m["moves"]], c), (m["name"], c)
    for c in cells:
        got = [n for n, m in e2e.items() if _reports(m, c)]
        assert "setup_s" in got and len(got) >= 2, c
        assert any(_reports(m, c) for m in bench["per_layer"]), c
    layers: dict[str, str] = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), m["layer"])
        assert layers[m["layer"].lower()] == m["layer"]
