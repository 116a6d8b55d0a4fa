"""AdamW + gradient clipping + LR schedules, a copy of the JAX package's
``training/optimizer.py`` in torch (no ``torch.optim``).

The trees the reference keeps as pytrees are dicts of tensors here, keyed
by parameter name (``blocks.0.attn.wq.w``) in the reference's flatten
order (:func:`named_leaves`, :func:`jax_order`): the global norm sums its
leaves in that order, as the reference's does. Arithmetic is float32
tensors throughout, the schedule's cosine and ``b1 ** step`` included;
every divisor is a tensor on the parameters' device (CUDA torch divides
by a Python number as a product with its rounded reciprocal).

The update writes the parameters (the model's own tensors, so its modules
see the new values) and the moments in place, one leaf at a time: no
second copy of the weights or of the moments is made, which keeps a
3 B-parameter model's weights, gradients and moments within one card.
Each in-place product or sum is the same float32 operation, on the same
operands, as the reference's expression, so the bits are those of an
out-of-place update.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def jax_order(name: str) -> tuple:
    """The sort key of a parameter name in the reference's flatten order:
    dict keys by name, list entries by index."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def named_leaves(params) -> dict:
    """A model's tensors by name, in the reference's flatten order: a
    :class:`~repro_torch.models.Transformer`'s parameters, or a
    :class:`~repro_torch.models.stacked.StackedParams`' under the names of
    the reference's stacked tree (``blocks_stacked.0.attn.wq.w``,
    ``enc_stacked.0.…``)."""
    from ..models.stacked import StackedParams

    if isinstance(params, StackedParams):
        out = {f"{name}.{k}": t for name in StackedParams._SHARED
               if hasattr(params, name)
               for k, t in getattr(params, name).named_parameters()}
        for tree, slots in (("blocks_stacked", params.slots),
                            ("enc_stacked",
                             getattr(params, "enc_stacked", []))):
            out.update({f"{tree}.{j}.{k}": t for j, slot in enumerate(slots)
                        for k, t in slot.items()})
    else:
        out = dict(params.named_parameters())
    return {k: out[k] for k in sorted(out, key=jax_order)}


def adamw_init(params: dict) -> dict:
    """Zero moments of each tensor of ``params`` (a dict by name) and a
    0-d int32 step."""
    dev = next(iter(params.values())).device
    return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _f32(x: float, device) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio: a float32 0-d tensor
    (on ``step``'s device, or ``device`` for an int ``step``)."""
    step = torch.as_tensor(step, dtype=torch.int32, device=device)
    dev = step.device
    warm = torch.minimum(step.float() / _f32(max(cfg.warmup_steps, 1), dev),
                         _f32(1.0, dev))
    prog = ((step - cfg.warmup_steps).float()
            / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev)
            ).clamp(0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares, leaf sums added in the reference's
    flatten order."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree, key=jax_order)))


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params: dict,
                 cfg: AdamWConfig):
    """One AdamW step with global-norm clipping: ``params`` (a dict by
    name, as :func:`named_leaves` gives) and the moments of ``opt_state``
    written in place; returns (params, the optimizer state with the new
    step, {"lr", "grad_norm"})."""
    step = opt_state["step"] + 1
    dev = step.device
    lr = lr_schedule(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, dev),
                          _f32(cfg.grad_clip, dev) / (gnorm + 1e-9))

    b1c = 1 - torch.pow(_f32(cfg.b1, dev), step.float())
    b2c = 1 - torch.pow(_f32(cfg.b2, dev), step.float())
    mu, nu = opt_state["mu"], opt_state["nu"]
    for k, p in params.items():
        g32 = (grads[k] * scale).float()
        m = mu[k].mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v = nu[k].mul_(cfg.b2).add_(g32 * (1 - cfg.b2) * g32)
        mh = m / b1c
        vh = v / b2c
        p32 = p.float()
        p.copy_((p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                             + cfg.weight_decay * p32)).to(p.dtype))
    return params, {"mu": mu, "nu": nu, "step": step}, {
        "lr": lr, "grad_norm": gnorm}
