"""Training launcher: the JAX package's ``launch/train.py`` on the port's
pieces — seeded weights on the device, AdamW, the eager train step, the
resumable token stream, async checkpoints with the data step, and the
straggler monitor. Runs on the card unless ``--device cpu``.

One device gives the (1, 1) (data, model) mesh. More than one device is
refused at entry (ROADMAP R6 a): the reference's launcher calls
``current_mesh_shape(n_dev)`` without the model axis it requires, so it
raises ``TypeError`` on any host with more than one device, and the port
has no SPMD partitioner to shard a step. Pin one card (``--device
cuda:0``) on a host with several. With ``--compress-grads`` the residual
is carried through the loop and, as in the reference, not checkpointed:
a resumed run restarts it from nothing (R6 b).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --reduced --steps 50 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import all_archs
from ..core.timing import resolve_devices
from ..dist.elastic import StragglerMonitor
from ..training import checkpoint as ckpt
from ..training.data import DataConfig, TokenStream, shard_batch
from ..training.optimizer import AdamWConfig
from ..training.train_loop import TrainConfig, init_train_state, make_train_step
from .mesh import make_mesh


def _one_device(device) -> torch.device:
    """The one device to train on. An unpinned ``cuda`` stands, as in the
    reference's launcher, for every device of the host: on a host with
    several cards it is refused (ROADMAP R6 a)."""
    dev = resolve_devices(device)[0]
    unpinned = dev == torch.device("cuda")
    n_dev = torch.cuda.device_count() if unpinned else 1
    if n_dev > 1:
        raise NotImplementedError(
            f"launch.train on {n_dev} devices: the reference's launcher "
            "calls current_mesh_shape(n_dev) without the model axis it "
            "requires (TypeError on any host with more than one device), "
            "and the port has no SPMD partitioner (ROADMAP R6 a); pass "
            "--device cuda:0")
    return torch.device("cuda", torch.cuda.current_device()) if unpinned \
        else dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    arch = all_archs()[args.arch]
    cfg = arch.reduced() if args.reduced else arch.model

    dev = _one_device(args.device)
    mesh = make_mesh((1, 1), ("data", "model"), devices=[dev])
    print(f"[train] mesh {mesh.shape}")

    # on the (1, 1) mesh every sharding spec is replicated: the weights,
    # the moments and the tokens stay whole on the one device
    params, opt = init_train_state(args.seed, cfg, dev)

    tcfg = TrainConfig(
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        opt=AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps),
    )
    step_fn = make_train_step(cfg, tcfg)

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                    global_batch=args.global_batch, seed=args.seed)
    stream = TokenStream(dc)
    start = 0
    residual = None
    if args.ckpt_dir and (latest := ckpt.latest_step(args.ckpt_dir)):
        restored, extra = ckpt.restore(args.ckpt_dir, latest,
                                       {"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        stream.restore(extra["data_step"])
        start = latest
        print(f"[train] resumed from step {latest}")

    mon = StragglerMonitor()
    losses, walls = {}, {}
    for step in range(start, args.steps):
        tokens = shard_batch(next(stream), dev)
        t0 = time.perf_counter()
        if tcfg.compress_grads:
            params, opt, stats, residual = step_fn(params, opt, tokens,
                                                   residual)
        else:
            params, opt, stats = step_fn(params, opt, tokens)
        loss = float(stats["loss"])            # waits for the step
        walls[step] = time.perf_counter() - t0
        slow = mon.step(walls[step])
        losses[step] = loss
        print(f"step {step:4d} loss {loss:.4f} "
              f"lr {float(stats['lr']):.2e}"
              + ("  [straggler]" if slow else ""))
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt},
                            extra={"data_step": stream.state()})
    ckpt.wait_pending()
    print(f"[train] done; straggler steps: {mon.slow_steps}")
    return {"start": start, "losses": losses, "step_s": walls,
            "straggler_steps": mon.slow_steps}


if __name__ == "__main__":
    main()
