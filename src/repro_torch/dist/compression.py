"""Error-feedback gradient compression (1-bit-Adam-style, int8 variant),
a copy of the JAX package's ``dist/compression.py`` in torch.

Gradients (a dict of tensors) are quantised per tensor to int8 with a
symmetric max-abs scale; the quantisation error is returned as a residual
that the caller feeds back into the next step (:func:`roundtrip`), so the
compression bias cancels over time instead of accumulating. Float32
throughout. The divisor 127 is a tensor on the gradient's device: CUDA
torch divides by a Python number as a product with its rounded reciprocal,
which may differ from the quotient in the last bit; by a tensor it
divides, as the reference does.
"""
from __future__ import annotations

import torch

_EPS = 1e-30


def _scale_of(g):
    s = g.abs().amax().float() / torch.full((), 127.0, device=g.device)
    return s.clamp(min=_EPS)


def compress_grads(grads: dict):
    """dict of float grads -> ({"q": int8 dict, "scale": 0-d float32
    dict}, residual dict); residual == grads - dequantised exactly."""
    scales = {k: _scale_of(g) for k, g in grads.items()}
    q = {k: torch.round(g.float() / scales[k]).clamp(-127, 127).to(
        torch.int8) for k, g in grads.items()}
    comp = {"q": q, "scale": scales}
    deq = decompress_grads(comp)
    residual = {k: g.float() - deq[k] for k, g in grads.items()}
    return comp, residual


def decompress_grads(comp: dict) -> dict:
    return {k: q.float() * comp["scale"][k] for k, q in comp["q"].items()}


def roundtrip(grads: dict, residual: dict | None = None):
    """One error-feedback step: compress (grads + residual), return the
    decompressed gradient to apply and the new residual to carry."""
    if residual is not None:
        grads = {k: g.float() + residual[k] for k, g in grads.items()}
    comp, new_residual = compress_grads(grads)
    return decompress_grads(comp), new_residual
