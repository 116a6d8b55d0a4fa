"""Scan over layers: the stacked layout of the JAX package's
``models/stacked.py``.

A layer stack of period p (the lcm of a hybrid's attention interleave and
the MoE interleave: slot j's block structure repeats every p layers) is
rearranged so that pattern slot j holds, for every parameter or cache
leaf of layers j, p + j, 2p + j, ..., one tensor with a leading
[n_steps] dimension (n_steps = n_layers / p), as the reference's leaves
have. The reference runs one ``lax.scan`` over the steps; torch has
none, so the port's scanned entry points (``forward_scanned``,
``prefill_scanned`` and ``decode_step_scanned`` in :mod:`.transformer`)
run the unscanned entry points on the stacked tensors read in layer
order, as views ``leaf[k]``: no weight is copied per call, and scanned
equals unscanned bit for bit.

Parameters: :func:`stack_params` gives a :class:`StackedParams`, whose
``embed``, ``final_norm``, ``lm_head`` and ``enc_norm`` are the source's
own modules (not copies) and whose ``slots[j]`` maps each parameter name
of a block (``attn.wq.w``) to its stacked tensor; an encoder's blocks are
stacked at period 1 into ``enc_stacked`` (the reference's name).
``layers()`` reads it as the unscanned entry points read a
:class:`~.transformer.Transformer`, with layer k * p + j's block step k
of slot j as a :class:`BlockView`. Caches:
:func:`stack_cache` gives one dict of stacked tensors per slot and
:func:`unstack_cache` its per-layer views; the scanned serving paths
write the attention rows through the views in place and copy a layer's
new ``len`` and Mamba state back into its slot.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch import nn


def layer_period(cfg) -> int:
    p = 1
    if cfg.mixer == "hybrid":
        p = cfg.attn_every
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe_every)
    return p


def _stack_trees(trees: list[dict], period: int) -> list[dict]:
    """``trees``: one dict of tensors per layer -> ``period`` dicts whose
    tensors have a leading [n_steps] dim (slot j: layers k * period + j)."""
    n = len(trees)
    if n % period:
        raise ValueError(f"{n} layers are not whole steps of period "
                         f"{period}")
    slots = []
    for j in range(period):
        grp = trees[j::period]
        if any(set(t) != set(grp[0]) for t in grp):
            raise ValueError(f"the layers of slot {j} differ in structure")
        slots.append({key: torch.stack([t[key] for t in grp])
                      for key in grp[0]})
    return slots


def _unstack_trees(slots: list[dict], period: int) -> list[dict]:
    steps = next(iter(slots[0].values())).shape[0]
    return [{key: t[k] for key, t in slots[j].items()}
            for k in range(steps) for j in range(period)]


def stack_blocks(blocks, period: int) -> list[dict]:
    """blocks: n_layers :class:`~.transformer.Block` modules -> ``period``
    slot dicts of parameter name -> tensor with a leading [n_steps] dim."""
    return _stack_trees([dict(b.named_parameters()) for b in blocks], period)


def unstack_blocks(slots: list[dict], period: int) -> list[dict]:
    """The inverse of :func:`stack_blocks`: one dict of parameter name ->
    tensor (a view of the slot's) per layer."""
    return _unstack_trees(slots, period)


def stack_cache(cache: list, cfg) -> list[dict]:
    """Per-layer caches -> one dict of stacked tensors per slot."""
    return _stack_trees(cache, layer_period(cfg))


def unstack_cache(slots: list[dict], cfg) -> list[dict]:
    """Per-slot stacked caches -> per-layer caches (views of the slots)."""
    return _unstack_trees(slots, layer_period(cfg))


class BlockView:
    """Step ``k`` of a stacked slot, read through the attribute names of
    its ``template`` block (built on the meta device): ``view.attn.wq.w``
    is ``tensors["attn.wq.w"][k]``. A name the template lacks raises
    ``AttributeError``, so ``hasattr`` reads the block's structure as on a
    Block; a bias the template has as ``None`` is ``None``. Each name is
    resolved once and kept."""

    def __init__(self, template: nn.Module, tensors: dict, k: int,
                 prefix: str = ""):
        self._template, self._tensors = template, tensors
        self._k, self._prefix = k, prefix

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        x = getattr(self._template, name)
        if isinstance(x, nn.Module):
            x = BlockView(x, self._tensors, self._k,
                          f"{self._prefix}{name}.")
        elif x is not None:
            x = self._tensors[self._prefix + name][self._k]
        setattr(self, name, x)
        return x


def _views(blocks, period: int, templates: list, what: str) -> list:
    """Blocks in layer order as :class:`BlockView`s of their stacked
    slots, after checking each slot against its template block."""
    for j, t in enumerate(templates):
        names = dict(t.named_parameters())
        if set(names) != set(blocks[j]) or any(
                blocks[j][n].shape[1:] != names[n].shape for n in names):
            raise ValueError(f"slot {j}'s blocks are not {what}'s "
                             f"Block({j})")
    steps = next(iter(blocks[0].values())).shape[0]
    return [BlockView(templates[j], blocks[j], k)
            for k in range(steps) for j in range(period)]


class StackedParams:
    """A model's parameters in the scanned layout (:func:`stack_params`).
    ``embed``, ``final_norm`` and, untied, ``lm_head`` are the source's
    own modules; ``slots[j]`` maps each parameter name of slot j's blocks
    to a tensor with a leading [n_steps] dim. An encoder-decoder model
    adds the source's ``enc_norm`` and ``enc_stacked``, its encoder blocks
    stacked at period 1 (one slot)."""

    _SHARED = ("embed", "final_norm", "lm_head", "enc_norm")

    def __init__(self, params, cfg):
        from .transformer import Block

        dtype = params.embed.e.dtype
        self.embed, self.final_norm = params.embed, params.final_norm
        if not cfg.tie_embeddings:
            self.lm_head = params.lm_head
        self.period = layer_period(cfg)
        self.slots = stack_blocks(params.blocks, self.period)
        self.n_steps = cfg.n_layers // self.period
        templates = [Block(cfg, j, dtype, "meta", None,
                           cfg.cross_attention) for j in range(self.period)]
        layers = {name: getattr(self, name) for name in self._SHARED
                  if hasattr(self, name)}
        layers["blocks"] = _views(self.slots, self.period, templates,
                                  cfg.name)
        if cfg.encoder_layers > 0:
            self.enc_norm = params.enc_norm
            self.enc_stacked = stack_blocks(params.enc_blocks, 1)
            layers.update(enc_norm=self.enc_norm, enc_blocks=_views(
                self.enc_stacked, 1, [Block(cfg, 0, dtype, "meta", None)],
                f"{cfg.name}'s encoder"))
        # a closure over the tensors, not a bound method: the namespace
        # must not refer back to self, or the stacked copy would live on
        # in a reference cycle until the garbage collector ran
        tensors = tuple(self.parameters())
        self._layers = SimpleNamespace(**layers,
                                       parameters=lambda: iter(tensors))

    def parameters(self):
        """Every tensor of the model: the shared modules' parameters and
        the stacked tensors."""
        for name in self._SHARED:
            if hasattr(self, name):
                yield from getattr(self, name).parameters()
        for slot in self.slots + getattr(self, "enc_stacked", []):
            yield from slot.values()

    def layers(self) -> SimpleNamespace:
        """The model in layer order, as the unscanned entry points read a
        :class:`~.transformer.Transformer`: ``embed``, ``final_norm``, an
        untied ``lm_head``, ``blocks``, whose entry ``k * period + j`` is
        step k of slot j, an encoder's ``enc_blocks`` and ``enc_norm``, and
        ``parameters()``."""
        return self._layers


def stack_params(params, cfg) -> StackedParams:
    """A :class:`~.transformer.Transformer`'s parameters in the scanned
    layout. The blocks' weights are copied once into the stacked tensors;
    the source's other modules are shared."""
    with torch.no_grad():
        return StackedParams(params, cfg)
