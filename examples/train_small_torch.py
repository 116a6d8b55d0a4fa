"""Train a ~100M-parameter model with the full production loop on the
PyTorch/CUDA port: microbatched grad accumulation, remat, async
checkpointing, deterministic resume. The twin of
``examples/train_small.py``: the same arguments, calls and printed lines,
on ``repro_torch``; training is eager torch, as the reference's is (no
hand-written kernel runs under grad). Its checkpoints are the JAX
package's format, so either script resumes from the other's.

  PYTHONPATH=src python examples/train_small_torch.py --steps 200 \
      [--device cpu]
(reduce --steps for a quick smoke run; resume is automatic from --ckpt-dir,
by default ``repro_train_small`` in the temporary directory)

``main(argv)`` returns the parameter count, the step it resumed from and
the per-step logs as a dict.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_small"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.core.timing import resolve_device
    from repro_torch.models import ModelConfig, init_model, param_count
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, train

    device = resolve_device(args.device)
    cfg = ModelConfig(name="demo-100m", vocab=32_000, d_model=768,
                      n_layers=12, n_heads=12, n_kv_heads=12, head_dim=64,
                      d_ff=3072, max_seq=512)
    n = param_count(init_model(cfg, seed=0, device=device))
    print(f"model: {n/1e6:.1f}M params")

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    tc = TrainConfig(microbatches=2, remat=True,
                     opt=AdamWConfig(lr=3e-4, warmup_steps=20,
                                     total_steps=args.steps))
    stream = TokenStream(dc)
    params = opt = None
    start = 0
    if latest := ckpt.latest_step(args.ckpt_dir):
        from repro_torch.training.train_loop import init_train_state
        p0, o0 = init_train_state(0, cfg, device=device)
        restored, extra = ckpt.restore(args.ckpt_dir, latest,
                                       {"params": p0, "opt": o0})
        params, opt = restored["params"], restored["opt"]
        stream.restore(extra["data_step"])
        start = latest
        print(f"resuming from step {latest}")
    _, _, logs = train(cfg, tc, stream, steps=args.steps,
                       ckpt_dir=args.ckpt_dir, ckpt_every=25, params=params,
                       opt_state=opt, start_step=start, log_every=5,
                       device=device)
    return {"params": n, "resumed_from": latest, "logs": logs}


if __name__ == "__main__":
    main()
