"""End-to-end serving driver on the PyTorch/CUDA port: a reduced LLM
serving a batched request stream under each of the three SOTA schedulers,
with throughput / TTFT comparison. The twin of ``examples/serve_llm.py``:
the same arguments, calls and printed lines, on ``repro_torch``. Every
decode iteration runs the ``decode_attention`` kernel (``impl="kernel"``);
an encoder-decoder ``--arch`` (whisper-tiny) also runs ``flash_attention``
in its ``encode`` and cross-attention. ``--device cpu`` runs the kernels'
plain versions.

  PYTHONPATH=src python examples/serve_llm_torch.py --arch qwen1.5-0.5b \
      [--device cpu]

``--service`` swaps the stepped engine for the async continuous-batching
service (paged KV cache, bounded admission queue, entry points cached per
bucket) and additionally reports block residency and — on a wall clock —
measured TTFT in seconds.

``main(argv)`` returns what it printed, unrounded, as a dict; each
scheduler's entry also counts its ``decode_iterations``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np


def decode_iterations(stats) -> int:
    """The iterations that ran a decode step: each calls decode attention
    once per attention layer."""
    return sum(1 for st in stats if st.n_decode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--service", action="store_true",
                    help="serve through the async paged service instead of "
                         "the stepped dense engine")
    ap.add_argument("--wall-clock", action="store_true",
                    help="with --service: arrivals in real time "
                         "(10ms per iteration unit) instead of the "
                         "deterministic iteration clock")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import all_archs
    from repro_torch.core.timing import resolve_device
    from repro_torch.models import encode, init_model
    from repro_torch.serving import (SCHEDULERS, ServeRequest, ServingEngine,
                                     summarize)

    device = resolve_device(args.device)
    arch = all_archs()[args.arch]
    cfg = arch.reduced()
    params = init_model(cfg, seed=args.seed, device=device)
    enc_out = None
    if cfg.encoder_layers > 0:
        gen = torch.Generator(device=device).manual_seed(1)
        frames = torch.randn((4, cfg.encoder_len, cfg.d_model),
                             generator=gen, device=device) * 0.02
        enc_out = encode(params, cfg, frames, impl="kernel", device=device)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 48))).tolist()
               for _ in range(args.requests)]
    out = {}
    for name in ("vllm", "orca", "chunked_prefill"):
        sched = (SCHEDULERS[name](chunk=16) if name == "chunked_prefill"
                 else SCHEDULERS[name]())
        reqs = [ServeRequest(i, list(p), args.max_new,
                             arrived_iter=i // 2)       # staggered arrivals
                for i, p in enumerate(prompts)]
        if args.service:
            if enc_out is not None:
                raise SystemExit("--service has no encoder–decoder path; "
                                 "pick a decoder-only --arch")
            from repro_torch.serving import (AsyncLLMService, ServiceConfig,
                                             WallClock)
            svc = AsyncLLMService(
                params, cfg, ServiceConfig(max_batch=4, max_len=128),
                clock=WallClock(period_s=0.01) if args.wall_clock else None,
                device=device)
            res = svc.serve_sync(reqs, sched)
            s = dict(res.summary(),
                     blocks_peak_used=res.counters["blocks_peak_used"],
                     blocks_capacity=res.counters["blocks_capacity"],
                     decode_iterations=decode_iterations(res.stats))
            extra = (f" blocks peak={s['blocks_peak_used']}"
                     f"/{s['blocks_capacity']}")
            if args.wall_clock:
                wt = res.wall_timings()
                s["wall_ttft_s"] = float(np.mean(wt.ttft_s[wt.finished]))
                extra += f" wall TTFT={s['wall_ttft_s']:.3f}s"
        else:
            eng = ServingEngine(params, cfg, max_batch=4, max_len=128,
                                enc_out=enc_out, device=device)
            fin, stats = eng.run(reqs, sched)
            s = dict(summarize(fin, stats),
                     decode_iterations=decode_iterations(stats))
            extra = ""
        out[name] = s
        print(f"{name:16s} iters={s['iterations']:3d} "
              f"tok/s={s['tokens_per_second']:7.2f} "
              f"mean TTFT={s['mean_ttft_iters']:.1f} iters"
              f" queue~{s['mean_queue_depth']:.1f}{extra}")
    return out


if __name__ == "__main__":
    main()
