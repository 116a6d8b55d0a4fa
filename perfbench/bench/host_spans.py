"""The program's host spans laid over the device trace: what the host was
doing while the device sat idle.

The port records spans (``repro_torch.spans``) on the clock of the
profiler's trace. Given the device's busy intervals over a traced stretch
(the union of its operations' intervals, as ``DeviceTrace.summary``
takes them) and the spans recorded over the same stretch, each idle
interval of the device is attributed to the innermost span that covers
it; idle time that no span covers is unattributed. The per-layer readings
of a cell come from the same spans and their counts (``readings``), and
``host_spans_line`` prints the spans that took the most host time and
the most idle device time.

Nothing here reads a program module: the spans arrive as the summary the
program returned (a dict), the device intervals as numbers."""
from __future__ import annotations

import json

UNATTRIBUTED = "unattributed"


def device_busy_ns(prof) -> list[tuple[int, int]]:
    """The union of the CUDA operations' intervals of a stopped
    ``torch.profiler`` run, sorted, in the profiler's nanoseconds."""
    from torch.autograd import DeviceType

    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA)
    return merge(ops)


def merge(intervals) -> list[tuple[int, int]]:
    """Sorted intervals, overlapping or touching ones joined."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_intervals(busy, lo: int, hi: int) -> list[tuple[int, int]]:
    """The gaps of the sorted, joined ``busy`` intervals inside [lo, hi]."""
    out, cur = [], lo
    for s, e in busy:
        if e <= cur:
            continue
        if s >= hi:
            break
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def innermost_segments(spans: dict, lo: int, hi: int) -> list[tuple[int, int, str]]:
    """[lo, hi] cut into consecutive pieces, each named by the innermost
    span that covers it (``UNATTRIBUTED`` where none does). ``spans`` is a
    summary's ``spans`` dict; spans of one thread nest, so the innermost
    of those covering a point is the one that opened last."""
    flat = sorted(((t0, -t1, name) for name, s in spans.items()
                   for t0, t1 in s["intervals"]))
    out: list[tuple[int, int, str]] = []

    def emit(a, b, name):
        a, b = max(a, lo), min(b, hi)
        if a < b:
            if out and out[-1][2] == name and out[-1][1] == a:
                out[-1] = (out[-1][0], b, name)
            else:
                out.append((a, b, name))

    stack: list[tuple[int, str]] = []       # (end, name) of the open spans
    cur = lo
    for t0, neg_t1, name in flat:
        t1 = -neg_t1
        while stack and stack[-1][0] <= t0:
            end, top = stack.pop()
            emit(cur, end, top)
            cur = max(cur, end)
        emit(cur, t0, stack[-1][1] if stack else UNATTRIBUTED)
        cur = max(cur, t0)
        if stack:
            t1 = min(t1, stack[-1][0])      # a child ends with its parent
        stack.append((t1, name))
    while stack:
        end, top = stack.pop()
        emit(cur, end, top)
        cur = max(cur, end)
    emit(cur, hi, UNATTRIBUTED)
    return out


def attribute_idle(busy, spans: dict, lo: int, hi: int) -> dict[str, float]:
    """Idle device seconds inside [lo, hi] by the innermost span covering
    them (``UNATTRIBUTED``: no span did)."""
    out: dict[str, float] = {}
    segs = innermost_segments(spans, lo, hi)
    j = 0
    for a, b in idle_intervals(busy, lo, hi):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name = segs[k]
            d = min(b, s1) - max(a, s0)
            if d > 0:
                out[name] = out.get(name, 0.0) + d / 1e9
            k += 1
    return out


def _host(spans, name):
    return spans.get(name, {}).get("host_s", 0.0)


def _count(spans, name):
    return spans.get(name, {}).get("count", 0)


def _counter(spans, name, key):
    return spans.get(name, {}).get("counts", {}).get(key, 0)


def readings(kind: str, spans: dict, idle: dict[str, float]) -> dict[str, float]:
    """The per-layer numbers of a traced stretch of a cell of ``kind``
    (``search`` or ``serve``), from the spans it recorded and the idle
    seconds attributed to them; a number whose spans were not recorded
    is left out."""
    out: dict[str, float] = {}
    total_idle = sum(idle.values())
    if kind == "search":
        gens, evals = _count(spans, "ga.breed"), _count(spans, "evaluator.prepare")
        searches = _count(spans, "search.graphs_tables")
        if gens:
            out["search.ga_host_ms_per_gen"] = 1e3 * _host(spans, "ga.breed") / gens
        if evals:
            out["search.evaluator_host_ms_per_gen"] = 1e3 * (
                _host(spans, "evaluator.prepare") + _host(spans, "evaluator.issue")) / evals
        if searches:
            out["search.per_search_host_s"] = sum(
                _host(spans, n) for n in ("search.graphs_tables", "search.evaluator_build",
                                          "search.finalise")) / searches
        if total_idle > 0 and spans:
            out["search.idle_unattributed_pct"] = \
                100.0 * idle.get(UNATTRIBUTED, 0.0) / total_idle
    elif kind == "serve":
        iters = _count(spans, "service.decode")
        if iters:
            out["serve.host_issue_ms_per_iter.chat"] = 1e3 * (
                _host(spans, "service.iteration") - _host(spans, "service.readback")) / iters
            out["serve.paged_gather_mb_per_iter.chat"] = \
                _counter(spans, "paged.gather", "bytes") / 1e6 / iters
            if _count(spans, "model.moe"):
                out["serve.moe_host_ms_per_iter.chat"] = 1e3 * _host(spans, "model.moe") / iters
        routed = _counter(spans, "model.moe", "routed_rows")
        if routed:
            out["serve.expert_rows_per_routed_row.chat"] = \
                _counter(spans, "model.moe", "expert_rows") / routed
        if total_idle > 0 and spans:
            out["serve.idle_unattributed_pct.chat"] = \
                100.0 * idle.get(UNATTRIBUTED, 0.0) / total_idle
    return out


def host_spans_line(spans: dict, idle: dict[str, float], top: int = 10) -> str:
    """``host_spans {...}``: the spans that took the most host seconds and
    the most idle device seconds, the top ``top`` of each."""
    host = sorted(((n, s["host_s"]) for n, s in spans.items()),
                  key=lambda kv: kv[1], reverse=True)
    by_idle = sorted(idle.items(), key=lambda kv: kv[1], reverse=True)
    return "host_spans " + json.dumps({
        "host_s": [[n, v] for n, v in host[:top]],
        "idle_s": [[n, v] for n, v in by_idle[:top]],
        "idle_total_s": sum(idle.values()),
        "counts": {n: s["count"] for n, s in spans.items()}})
