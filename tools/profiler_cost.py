#!/usr/bin/env python3
"""What ``torch.profiler`` costs around one orca engine run on the card.

Serves chip_smoke's 8 requests (prompts of 64-512 tokens, 16 new tokens
each) with the orca engine at the full width of ``--arch`` (seeded random
float32 weights; decode through ``decode_attention``) once to warm up, then
under the profiler with the host ops and the CUDA activity traced and with
the CUDA activity alone, in turns (both, CUDA, CUDA, both), then once
untraced. For each traced run it prints one JSON line: the run's wall, the
device busy time and idle share read from ``key_averages()``, the kernels
seen, and the seconds the profiler took to stop and to build
``key_averages()``, beside the busy time, kernels and seconds of
chip_smoke's ``_device_records`` (the raw trace's device events summed by
name) on the same trace. The card's name and power limit are printed first.
Needs one CUDA card.

Run from the repository root:  python3 tools/profiler_cost.py
[--arch qwen2-1.5b]
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.models import init_model
    from repro_torch.serving import OrcaScheduler
    from repro_torch.serving.engine import ServingEngine

    if not torch.cuda.is_available():
        print("profiler_cost: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(cs.card_line(), flush=True)
    cfg = get(args.arch).model
    params = init_model(cfg, seed=0, device=device)
    eng = ServingEngine(params, cfg, max_batch=cs.SERVE_REQUESTS,
                        max_len=cs.SERVE_MAX_LEN, device=device)

    def serve() -> float:
        t0 = time.perf_counter()
        eng.run(cs._serve_requests(cfg.vocab), OrcaScheduler())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    serve()
    for traced in (("cpu", "cuda"), ("cuda",), ("cuda",), ("cpu", "cuda")):
        acts = [ProfilerActivity.CPU] * ("cpu" in traced) \
            + [ProfilerActivity.CUDA]
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            wall = serve()
        torch.cuda.synchronize()
        stop_s = time.perf_counter() - t0 - wall
        t1 = time.perf_counter()
        raw = cs._device_records(prof)
        raw_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        averages_s = time.perf_counter() - t1
        busy_ms = sum(cs._dev_us(e) for e in kern) / 1e3
        print(json.dumps({
            "arch": args.arch, "traced": list(traced), "wall_ms": 1e3 * wall,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
            "kernel_launches": sum(e.count for e in kern),
            "stop_s": stop_s, "key_averages_s": averages_s,
            "raw_records_s": raw_s,
            "raw_device_busy_ms": sum(e.self_device_time_total
                                      for e in raw) / 1e3,
            "raw_kernel_launches": sum(e.count for e in raw)}), flush=True)
    print(json.dumps({"arch": args.arch, "traced": None,
                      "wall_ms": 1e3 * serve()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
