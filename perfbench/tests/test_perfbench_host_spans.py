"""The host spans laid over the device trace (``bench/host_spans.py``) on
synthetic intervals: idle time goes to the innermost span covering it,
idle time no span covers is unattributed, intervals outside the stretch
are clipped; the readings and the printed line from a real recording of
the port on the CPU."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from bench import common  # noqa: E402
from bench.host_spans import (  # noqa: E402
    UNATTRIBUTED,
    attribute_idle,
    host_spans_line,
    idle_intervals,
    innermost_segments,
    merge,
    readings,
)


def _spans(**intervals):
    return {name: {"count": len(iv), "host_s": sum(b - a for a, b in iv) / 1e9,
                   "counts": {}, "intervals": [list(x) for x in iv]}
            for name, iv in intervals.items()}


def test_merge_and_idle_intervals():
    busy = merge([(50, 60), (10, 20), (15, 30), (30, 35)])
    assert busy == [(10, 35), (50, 60)]
    assert idle_intervals(busy, 0, 100) == [(0, 10), (35, 50), (60, 100)]
    # the stretch clips: busy time before and after it is dropped
    assert idle_intervals(busy, 20, 55) == [(35, 50)]
    assert idle_intervals([], 5, 9) == [(5, 9)]


def test_innermost_span_wins():
    sp = _spans(outer=[(0, 100)], mid=[(10, 60)], inner=[(20, 30), (40, 50)])
    assert innermost_segments(sp, 0, 100) == [
        (0, 10, "outer"), (10, 20, "mid"), (20, 30, "inner"), (30, 40, "mid"),
        (40, 50, "inner"), (50, 60, "mid"), (60, 100, "outer")]
    # the device is idle everywhere but 45-55
    idle = attribute_idle([(45, 55)], sp, 0, 100)
    assert idle == pytest.approx({"outer": 50e-9, "mid": 25e-9, "inner": 15e-9})


def test_uncovered_idle_is_unattributed():
    sp = _spans(a=[(10, 20)], b=[(30, 40)])
    idle = attribute_idle([(15, 35)], sp, 0, 50)
    # idle: 0-15 (a covers 10-15), 35-50 (b covers 35-40)
    assert idle == pytest.approx({UNATTRIBUTED: 20e-9, "a": 5e-9, "b": 5e-9})


def test_intervals_outside_the_stretch_are_clipped():
    sp = _spans(long=[(-50, 30)], late=[(80, 200)])
    idle = attribute_idle([(-40, -10), (150, 190)], sp, 0, 100)
    assert idle == pytest.approx({"long": 30e-9, UNATTRIBUTED: 50e-9, "late": 20e-9})
    assert sum(idle.values()) == pytest.approx(100e-9)


def test_readings_and_line_from_synthetic_spans():
    sp = _spans(**{"ga.breed": [(0, 30), (100, 130)], "evaluator.prepare": [(30, 40)],
                   "evaluator.issue": [(40, 50)], "search.graphs_tables": [(-5, 0)]})
    idle = {"ga.breed": 6e-8, UNATTRIBUTED: 2e-8}
    r = readings("search", sp, idle)
    assert r["search.ga_host_ms_per_gen"] == pytest.approx(1e3 * 30e-9)
    assert r["search.evaluator_host_ms_per_gen"] == pytest.approx(1e3 * 20e-9)
    assert r["search.per_search_host_s"] == pytest.approx(5e-9)
    assert r["search.idle_unattributed_pct"] == pytest.approx(25.0)
    line = host_spans_line(sp, idle)
    assert line.startswith("host_spans ")
    d = json.loads(line.split(" ", 1)[1])
    assert d["host_s"][0][0] == "ga.breed" and d["idle_s"][0] == ["ga.breed", 6e-8]
    # nothing recorded: nothing to read
    assert readings("search", {}, {}) == {}
    assert readings("serve", {}, {UNATTRIBUTED: 1.0}) == {}


def test_a_recorded_serve_reads_every_serve_number():
    """The port's paged service on the CPU at a tiny MoE width, recorded:
    the serve readings that need no device all read a number, and the
    idle share reads from made-up device intervals."""
    common.prepare_environment()
    import torch

    from repro_torch import configs, spans
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import AsyncLLMService, ServeRequest, ServiceConfig, \
        get_scheduler

    torch.manual_seed(0)
    cfg = configs.get("deepseek-moe-16b").reduced()
    params = init_model(cfg, seed=0, device="cpu")
    svc = AsyncLLMService(params, cfg, ServiceConfig(max_batch=2, max_len=64),
                          impl="eager", device="cpu")
    reqs = [ServeRequest(i, list(range(5, 12 + i)), 4) for i in range(3)]
    with spans.recording():
        svc.serve_sync(reqs, get_scheduler("orca"))
    s = spans.summary()
    sp = s["spans"]
    lo, hi = s["start_ns"], s["stop_ns"]
    mid = (lo + hi) // 2
    idle = attribute_idle([(mid, mid + 1000)], sp, lo, hi)
    r = readings("serve", sp, idle)
    assert set(r) == {"serve.host_issue_ms_per_iter.chat", "serve.paged_gather_mb_per_iter.chat",
                      "serve.moe_host_ms_per_iter.chat",
                      "serve.expert_rows_per_routed_row.chat",
                      "serve.idle_unattributed_pct.chat"}
    assert 0 <= r.pop("serve.idle_unattributed_pct.chat") < 100.0
    assert all(v > 0 for v in r.values())
    json.loads(host_spans_line(sp, idle).split(" ", 1)[1])
