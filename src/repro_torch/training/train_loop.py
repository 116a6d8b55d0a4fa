"""Training loop, a copy of the JAX package's ``training/train_loop.py`` in
eager torch: next-token CE, microbatched gradient accumulation, remat per
block, optional error-feedback gradient compression, checkpoint/restart.

The forward is :func:`repro_torch.models.forward` at ``impl="eager"``, as
the reference's ``loss_fn`` runs its ``forward`` at ``impl="xla"``: the
hand kernels have no backward (the reference has no backward kernel
either), and ``forward`` refuses ``impl="kernel"`` under grad. Gradients
are :func:`torch.autograd.grad` of the loss with respect to
:func:`~.optimizer.named_leaves`, which :func:`init_train_state` makes
require grad. No ``torch.compile``: each step is one eager forward and
backward per microbatch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..core.timing import resolve_device
from ..dist.compression import roundtrip
from ..models.stacked import StackedParams
from ..models.transformer import ModelConfig, forward, forward_scanned
from .data import shard_batch
from .optimizer import AdamWConfig, adamw_init, adamw_update, named_leaves

_ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    compress_grads: bool = False
    grad_accum_dtype: str = "float32"   # float32 | bfloat16
    opt: AdamWConfig = AdamWConfig()


def masked_ce(logits, tgt):
    """Mean cross-entropy with the gold logit taken by a masked sum over
    the vocabulary (the reference's vocab-shardable form): logsumexp minus
    the masked sum."""
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vocab == tgt[..., None], logits, 0.0).sum(-1)
    return torch.mean(logz - gold)


def loss_fn(params, cfg: ModelConfig, tokens, remat: bool = True):
    """tokens: [B, L+1] -> scalar mean CE, on the device the weights lie
    on; stacked params (:func:`~repro_torch.models.stack_params`) go
    through the scanned forward, as in the reference."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    fwd = forward_scanned if isinstance(params, StackedParams) else forward
    logits = fwd(params, cfg, inp, impl="eager",
                 device=params.embed.e.device, remat=remat)
    return masked_ce(logits.float(), tgt)


def _grads(params, leaves: dict, cfg, tokens, remat: bool):
    """(loss, gradients by name); a tensor the loss does not reach gets a
    zero gradient, as in the reference."""
    loss = loss_fn(params, cfg, tokens, remat)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), got)}


def loss_and_grads(params, cfg: ModelConfig, tcfg: TrainConfig, tokens):
    """(mean loss, gradients by name) of one step's ``tokens`` [B, L+1]:
    over ``tcfg.microbatches`` microbatches of B / microbatches rows, their
    gradients summed in ``grad_accum_dtype`` and divided by their count,
    as the reference's ``train_step`` does before its update."""
    leaves = named_leaves(params)
    mb = tcfg.microbatches
    if mb == 1:
        return _grads(params, leaves, cfg, tokens, tcfg.remat)
    acc_dt = _ACCUM_DTYPES[tcfg.grad_accum_dtype]
    acc = {k: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
           for k, p in leaves.items()}
    losses = []
    for tok in tokens.reshape(mb, tokens.shape[0] // mb, tokens.shape[1]):
        loss, g = _grads(params, leaves, cfg, tok, tcfg.remat)
        for k in acc:
            acc[k] += g[k].to(acc_dt)
        losses.append(loss)
        del g
    div = torch.full((), mb, dtype=acc_dt, device=tokens.device)
    return torch.mean(torch.stack(losses)), {k: a / div
                                             for k, a in acc.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, tokens[, residual]) ->
    (params, opt_state, stats[, residual]): ``params`` (a
    :class:`~repro_torch.models.Transformer` whose weights require grad,
    :func:`init_train_state`) updated in place, from the gradients of
    :func:`loss_and_grads`; with ``compress_grads`` they go through
    :func:`~repro_torch.dist.compression.roundtrip` with the residual."""
    _ACCUM_DTYPES[tcfg.grad_accum_dtype]     # an unknown type raises here

    def train_step(params, opt_state, tokens, residual=None):
        loss, grads = loss_and_grads(params, cfg, tcfg, tokens)
        if tcfg.compress_grads:
            grads, residual = roundtrip(grads, residual)
        _, opt_state, stats = adamw_update(grads, opt_state,
                                           named_leaves(params), tcfg.opt)
        stats = dict(stats, loss=loss)
        if tcfg.compress_grads:
            return params, opt_state, stats, residual
        return params, opt_state, stats

    return train_step


def init_train_state(seed: int, cfg: ModelConfig, device=None,
                     dtype=torch.float32):
    """(a model of seeded random weights on ``device``, ``None`` = CUDA,
    that require grad; its zero AdamW state)."""
    from ..models.transformer import init_model

    params = init_model(cfg, seed=seed, dtype=dtype, device=device)
    params.requires_grad_(True)
    return params, adamw_init(named_leaves(params))


def train(cfg: ModelConfig, tcfg: TrainConfig, data_iter, steps: int,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          params=None, opt_state=None, start_step: int = 0,
          log_every: int = 10, seed: int = 0, device=None):
    """Single-host driver with checkpoint/restart on ``device`` (``None`` =
    CUDA). With ``compress_grads`` it raises ``NotImplementedError``: the
    step then returns a residual that the reference's driver does not
    take (it fails unpacking it), and no checkpoint holds it (ROADMAP
    R5 g)."""
    from . import checkpoint as ckpt

    if tcfg.compress_grads:
        raise NotImplementedError(
            "train() with compress_grads: the residual is neither carried "
            "nor checkpointed by the reference's driver (ROADMAP R5 g); "
            "call make_train_step and carry it")
    dev = resolve_device(device)
    if params is None:
        params, opt_state = init_train_state(seed, cfg, dev)
    step_fn = make_train_step(cfg, tcfg)
    logs = []
    for step in range(start_step, steps):
        tokens = shard_batch(next(data_iter), dev)
        t0 = time.perf_counter()
        params, opt_state, stats = step_fn(params, opt_state, tokens)
        loss, lr = float(stats["loss"]), float(stats["lr"])
        dt = time.perf_counter() - t0
        logs.append({"step": step, "loss": loss, "lr": lr, "sec": dt})
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} lr {lr:.2e} ({dt:.2f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save_async(ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            extra={"data_step": data_iter.state()})
    if ckpt_dir:
        ckpt.wait_pending()
    return params, opt_state, logs
