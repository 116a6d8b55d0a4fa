"""Serving launcher: run the engine against a synthetic request stream under
any of the three schedulers, on the card unless ``--device cpu``. An
encoder-decoder model (whisper-tiny) serves against the encoding of
``max_batch`` seeded frame sets, one per slot.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --scheduler chunked_prefill --requests 8
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs import all_archs
from ..core.timing import resolve_device
from ..models.transformer import encode, init_model
from ..serving import SCHEDULERS, ServeRequest
from ..serving.engine import ServingEngine, summarize


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--scheduler", default="orca",
                    choices=list(SCHEDULERS.keys()))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=160)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = all_archs()[args.arch].reduced()
    params = init_model(cfg, seed=args.seed, device=device)

    enc_out = None
    if cfg.encoder_layers > 0:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        frames = torch.randn((args.max_batch, cfg.encoder_len, cfg.d_model),
                             generator=gen, device=device) * 0.02
        enc_out = encode(params, cfg, frames, impl="kernel", device=device)

    rng = np.random.default_rng(args.seed)
    reqs = [
        ServeRequest(i, rng.integers(0, cfg.vocab,
                                     size=int(rng.integers(8, 64))).tolist(),
                     args.max_new)
        for i in range(args.requests)
    ]
    sched = (SCHEDULERS[args.scheduler](chunk=args.chunk)
             if args.scheduler == "chunked_prefill"
             else SCHEDULERS[args.scheduler]())
    eng = ServingEngine(params, cfg, max_batch=args.max_batch,
                        max_len=args.max_len, device=device, enc_out=enc_out)
    finished, stats = eng.run(reqs, sched)
    print(json.dumps(summarize(finished, stats), indent=1))
    for r in finished[:3]:
        print(f"req {r.rid}: prompt[:8]={r.prompt[:8]} -> {r.generated}")
    return 0


if __name__ == "__main__":
    main()
