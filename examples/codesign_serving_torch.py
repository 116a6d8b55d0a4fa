"""Co-design bridge on the PyTorch/CUDA port: Compass's searched mapping
drives the serving configuration. The twin of
``examples/codesign_serving.py``: the same arguments, calls and printed
lines, on ``repro_torch``.

1. Run the DSE on the target arch's workload spec (sequence-length trace),
   pricing populations through the ``mapping_eval_fused`` kernel.
2. Translate the searched z_sys (micro-batch size, tensor parallelism) and
   segmentation into engine batching + sharding choices.
3. Serve a reduced model under that configuration (every decode iteration
   through the ``decode_attention`` kernel) and report throughput.

  PYTHONPATH=src python examples/codesign_serving_torch.py --arch qwen2-1.5b \
      [--device cpu]

``--device cpu`` runs the kernels' plain versions. ``main(argv)`` returns
what it printed, unrounded, as a dict, with the count of the engine's
``decode_iterations`` (each calls decode attention once per layer).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to search and serve on (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_archs
    from repro_torch.core import RequestStream, Scenario, explore
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.timing import resolve_device
    from repro_torch.core.traces import SHAREGPT
    from repro_torch.models import init_model
    from repro_torch.serving import (SCHEDULERS, ServeRequest, ServingEngine,
                                     summarize)

    device = resolve_device(args.device)
    arch = all_archs()[args.arch]
    # search under the SAME scheduler policy the engine below will run
    stream = RequestStream(f"{args.arch}-stream", trace=SHAREGPT, rate=2.0,
                           n_requests=16, warm_fraction=0.8,
                           max_new_tokens_cap=4, seed=args.seed)
    sc = Scenario(f"{args.arch}-serve", arch.llm_spec(), target_tops=64,
                  stream=stream, scheduler="orca", n_blocks=1,
                  max_stream_iters=24, seed=args.seed)
    print("[1/3] DSE on the serving stream (orca continuous batching)...")
    res = explore(sc, bo_iters=3, bo_init=3,
                  ga_config=GAConfig(population=12, generations=5),
                  seed=args.seed, device=device)
    hw = res.hardware
    ws = sum(1 for x in hw.layout if x == "WS")
    os_ = sum(1 for x in hw.layout if x == "OS")
    print(f"    searched: micro_batch={hw.micro_batch_decode} "
          f"tp={hw.tensor_parallel} spec={hw.spec_name} WS/OS={ws}/{os_}")

    # 2. translate: micro-batch -> engine batch slots; tp -> model-axis hint
    engine_batch = int(min(8, max(2, hw.micro_batch_decode)))
    print(f"[2/3] engine config from DSE: batch slots={engine_batch} "
          f"(model-parallel degree {hw.tensor_parallel} applies on a real "
          f"multi-device mesh via dist.sharding)")

    cfg = arch.reduced()
    params = init_model(cfg, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [ServeRequest(i, rng.integers(0, cfg.vocab,
                                         size=int(rng.integers(8, 40))).tolist(), 8)
            for i in range(8)]
    print("[3/3] serving with the searched configuration...")
    eng = ServingEngine(params, cfg, max_batch=engine_batch, max_len=96,
                        device=device)
    fin, stats = eng.run(reqs, SCHEDULERS["orca"]())
    summary = summarize(fin, stats)
    print("   ", summary)
    return {"micro_batch": hw.micro_batch_decode, "tp": hw.tensor_parallel,
            "spec": hw.spec_name, "ws": ws, "os": os_,
            "engine_batch": engine_batch, "summary": summary,
            "decode_iterations": sum(1 for st in stats if st.n_decode)}


if __name__ == "__main__":
    main()
