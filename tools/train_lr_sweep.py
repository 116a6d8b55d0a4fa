#!/usr/bin/env python3
"""Training at llama3.2-3b's full width on one card: how AdamW's first
steps behave across learning rates, and whether the gradient is the
loss's slope at full depth.

For each depth in ``--layers`` (28 is the published depth; 2 the float64
gradient check's in chip_smoke): the loss of each of the 4 seeded
``TokenStream`` batches at the seed-0 init, the loss's central difference
along the gradient at steps of 1e-3, 1e-2 and 1e-1 in parameter norm
against the gradient's norm, then, for each (lr, warm-up) of ``--runs``,
4 ``make_train_step`` steps from the same init (remat on, B 2 x L 512)
with each step's loss and batch 0's loss after them. One JSON line per
measurement; the card's name and power limit first.

    python3 tools/train_lr_sweep.py [--layers 28,2] \
        [--runs 1e-5:2,3e-5:2,1e-4:2,3e-4:2,3e-4:0,2e-3:2]

Needs a CUDA card (about 62 GB of device memory at 28 layers).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="28,2")
    ap.add_argument("--runs", default="1e-5:2,3e-5:2,1e-4:2,3e-4:2,3e-4:0,"
                                      "2e-3:2", help="lr:warmup,...")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_lr_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.models import init_model
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optimizer import AdamWConfig, named_leaves
    from repro_torch.training.train_loop import (
        TrainConfig,
        init_train_state,
        loss_and_grads,
        loss_fn,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    emit({"card": subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()})
    full = get("llama3.2-3b").model
    stream = TokenStream(DataConfig(vocab=full.vocab, seq_len=512,
                                    global_batch=2, seed=0))
    batches = [torch.as_tensor(next(stream), device=dev) for _ in range(4)]
    for layers in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(full, n_layers=layers)
        params = init_model(cfg, seed=0, device=dev).requires_grad_(True)
        with torch.no_grad():
            init = [float(loss_fn(params, cfg, b)) for b in batches]
        _, grads = loss_and_grads(params, cfg, TrainConfig(), batches[0])
        norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in grads.values())))
        leaves = named_leaves(params)
        slope = {}
        with torch.no_grad():
            for eps in (1e-3, 1e-2, 1e-1):
                moved = []
                for sign in (1.0, -1.0):
                    for k, p in leaves.items():
                        p.add_(grads[k], alpha=sign * eps / norm)
                    moved.append(float(loss_fn(params, cfg, batches[0])))
                    for k, p in leaves.items():
                        p.add_(grads[k], alpha=-sign * eps / norm)
                slope[str(eps)] = (moved[0] - moved[1]) / (2 * eps)
        emit({"layers": layers, "init_loss_per_batch": init,
              "grad_norm": norm, "central_difference": slope})
        del params, grads, leaves
        torch.cuda.empty_cache()
        for run in args.runs.split(","):
            lr, warm = run.split(":")
            params, state = init_train_state(0, cfg, dev)
            step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(
                lr=float(lr), warmup_steps=int(warm), total_steps=12)))
            losses, norms = [], []
            for tok in batches:
                params, state, stats = step(params, state, tok)
                losses.append(float(stats["loss"]))
                norms.append(float(stats["grad_norm"]))
            with torch.no_grad():
                after = float(loss_fn(params, cfg, batches[0]))
            emit({"layers": layers, "lr": float(lr), "warmup": int(warm),
                  "losses": losses, "grad_norms": norms,
                  "batch0_loss_after": after})
            del params, state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
