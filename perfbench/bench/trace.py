"""The device trace of a traced run: ``torch.profiler`` over the CUDA
activity alone, started and stopped around a stretch of the window, and
its raw events summed by name (a frozen copy of ``chip_smoke``'s
``_device_records``, which gives what ``key_averages()`` gives without
building a record per event)."""
from __future__ import annotations

import time


class DeviceTrace:
    """Start once, stop once; ``summary()`` afterwards."""

    def __init__(self):
        self.prof = None
        self.t_start = self.t_stop = None

    def warm(self) -> None:
        """One short profile in set-up: the profiler's first start takes
        seconds (it loads and initialises CUPTI), which would otherwise
        fall inside the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t_start = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t_stop is None

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def summary(self, top: int = 10) -> dict:
        """``window_s`` (host clock, start to stop), ``busy_s`` (the union
        of the device's operation intervals), ``ops`` {name: [count,
        seconds]}, and the ``breakdown`` of the result line: the device
        operations that took most time and the longest idle stretches,
        each named by the operations on either side of it."""
        from torch.autograd import DeviceType

        spans = []
        ops: dict[str, list] = {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            spans.append((s, s + d, name))
            rec = ops.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += d / 1e9
        spans.sort()
        busy_ns, gaps = 0, {}
        cur_s = cur_e = None
        prev_name = None
        for s, e, name in spans:
            if cur_e is None:
                cur_s, cur_e = s, e
            elif s > cur_e:
                busy_ns += cur_e - cur_s
                key = f"{_short(prev_name)} -> {_short(name)}"
                gaps[key] = gaps.get(key, 0.0) + (s - cur_e) / 1e9
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            prev_name = name
        if cur_e is not None:
            busy_ns += cur_e - cur_s
        window = self.t_stop - self.t_start
        by_time = sorted(ops.items(), key=lambda kv: kv[1][1], reverse=True)
        by_gap = sorted(gaps.items(), key=lambda kv: kv[1], reverse=True)
        return {"window_s": window, "busy_s": busy_ns / 1e9, "ops": ops,
                "launches": sum(v[0] for v in ops.values()),
                "breakdown": {"device_ops": [[_short(k), v[1]] for k, v in by_time[:top]],
                              "idle_gaps": [[k, v] for k, v in by_gap[:top]]}}


def _short(name: str | None, n: int = 60) -> str:
    if name is None:
        return "start"
    return name if len(name) <= n else name[: n - 3] + "..."


def device_seconds(ops: dict, *patterns: str) -> tuple[int, float]:
    """Launches and device seconds of the operations whose names contain
    any of ``patterns``."""
    n, s = 0, 0.0
    for name, (count, sec) in ops.items():
        if any(p in name for p in patterns):
            n += count
            s += sec
    return n, s
