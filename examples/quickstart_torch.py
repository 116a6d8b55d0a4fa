"""Quickstart on the PyTorch/CUDA port: Compass mapping + hardware
co-exploration on a small LLM serving scenario, with a Fig.-8-style
spatio-temporal timeline of the found mapping. The twin of
``examples/quickstart.py``: the same arguments, calls and printed lines,
on ``repro_torch``; the search prices its populations on the card through
the ``mapping_eval_fused`` kernel (``--device cpu``: its plain version).

  PYTHONPATH=src python examples/quickstart_torch.py [--timeline] \
      [--device cpu]

``main(argv)`` returns what it printed, unrounded, as a dict.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def search_record(res) -> dict:
    """The best hardware point, its mapping's metrics and the BO history
    of an ``explore`` result."""
    hw = res.hardware
    ws = sum(1 for x in hw.layout if x == "WS")
    return {"spec": hw.spec_name, "grid": list(hw.grid), "ws": ws,
            "os": hw.n_chiplets - ws, "nop": hw.nop_bw_gbps,
            "dram": hw.dram_bw_gbps, "mb": hw.micro_batch_decode,
            "tp": hw.tensor_parallel,
            "latency_s": float(res.mapping.latency_s),
            "energy_j": float(res.mapping.energy_j),
            "mc": float(res.mapping.mc_total), "edp": float(res.mapping.edp),
            "bo_history": [float(h) for h in res.bo.history]}


def timeline_lanes(g, enc, hw, r) -> list:
    """Per chiplet, its ops as (end ms, layer name, row), in order of end:
    the first block of the mapping ``enc`` evaluated as ``r``."""
    end = r.op_end_s / g.scale * 1e3
    lanes = []
    for c in range(hw.n_chiplets):
        ops = [(float(end[b, layer]), g.layers[layer].name, b)
               for b in range(g.rows) for layer in range(g.n_cols)
               if enc.layer_to_chip[b, layer] == c]
        ops.sort()
        lanes.append(ops)
    return lanes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--bo-iters", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to search on (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.core import RequestStream, Scenario, explore
    from repro_torch.core.evaluator import evaluate
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.timing import resolve_device
    from repro_torch.core.traces import SHAREGPT
    from repro_torch.core.workload import LLMSpec, build_execution_graph

    device = resolve_device(args.device)
    spec = LLMSpec("demo-1b", d_model=2048, n_heads=16, n_kv_heads=16,
                   head_dim=128, d_ff=8192, vocab=32000, n_layers=16)
    # stream-first scenario: ShareGPT lengths, Poisson arrivals, a warm
    # decode pool, rolled out under the Orca continuous-batching policy
    stream = RequestStream("sharegpt", trace=SHAREGPT, rate=2.0,
                           n_requests=16, warm_fraction=0.75,
                           max_new_tokens_cap=4, seed=args.seed)
    sc = Scenario("sharegpt-serve-64T", spec, target_tops=64, stream=stream,
                  scheduler="orca", objective="edp_mc", n_blocks=1,
                  max_stream_iters=24, seed=args.seed)
    print("co-exploring mapping x hardware (reduced budget)...")
    res = explore(sc, bo_iters=args.bo_iters, bo_init=3,
                  ga_config=GAConfig(population=16, generations=8),
                  seed=args.seed, device=device)
    hw = res.hardware
    out = search_record(res)
    print(f"\nbest hardware: spec={hw.spec_name} grid={hw.grid} "
          f"WS={out['ws']} OS={out['os']} nop={hw.nop_bw_gbps}GB/s "
          f"dram={hw.dram_bw_gbps}GB/s mb={hw.micro_batch_decode} "
          f"tp={hw.tensor_parallel}")
    print(f"latency={res.mapping.latency_s*1e3:.2f} ms  "
          f"energy={res.mapping.energy_j:.3f} J  "
          f"MC=${res.mapping.mc_total:.1f}  EDP={res.mapping.edp:.3e}")
    print("BO best-so-far:", " -> ".join(f"{h:.2e}" for h in res.bo.history))

    out["timeline"] = None
    if args.timeline:
        batch = sc.batches(hw)[0]
        g = build_execution_graph(spec, batch, sc.micro_batch(hw, batch),
                                  tp=hw.tensor_parallel, n_blocks=1)
        enc = res.mapping.encodings[(g.rows, g.n_cols)]
        out["timeline"] = timeline_lanes(g, enc, hw, evaluate(g, enc, hw))
        print("\nspatio-temporal execution (first block, ms):")
        for c, ops in enumerate(out["timeline"]):
            lane = " ".join(f"{n}@r{b}:{t:.2f}" for t, n, b in ops[:6])
            print(f"  chiplet {c} [{hw.layout[c]}]: {lane}"
                  + (" ..." if len(ops) > 6 else ""))
    return out


if __name__ == "__main__":
    main()
