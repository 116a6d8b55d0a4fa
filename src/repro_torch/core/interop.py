"""Build the port's data objects from plain fields and numpy arrays.

Each function reads attributes by name from any object that has them
(duck typing), so a mapping population, a set of cost tables or a hardware
point made elsewhere — for example by the JAX reference package in a
parity test — becomes the port's own object with copied arrays and no
reference to the source; a model's parameter tree and caches (nested
dicts and lists of numpy arrays) become the port's model and caches.
Nothing here imports the source's package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .encoding import MappingEncoding, StackedPopulation
from .evaluator import CostTables
from .hardware import HardwareConfig
from .workload import LLMSpec, MoESpec, Request


def encoding_from(obj) -> MappingEncoding:
    """``segmentation`` (M-1,) and ``layer_to_chip`` (rows, M)."""
    return MappingEncoding(np.array(obj.segmentation, dtype=np.uint8),
                           np.array(obj.layer_to_chip, dtype=np.int32))


def population_from(obj) -> StackedPopulation:
    """A stacked population (``segmentation`` (P, M-1), ``layer_to_chip``
    (P, rows, M)) or a sequence of encodings."""
    if hasattr(obj, "segmentation"):
        return StackedPopulation(np.array(obj.segmentation, dtype=np.uint8),
                                 np.array(obj.layer_to_chip, dtype=np.int32))
    return StackedPopulation.from_encodings([encoding_from(e) for e in obj])


def cost_tables_from(obj) -> CostTables:
    """Every :class:`CostTables` field, copied by name."""
    return CostTables(**{f.name: np.array(getattr(obj, f.name))
                         for f in dataclasses.fields(CostTables)})


def hardware_from(obj) -> HardwareConfig:
    """Every :class:`HardwareConfig` field, copied by name."""
    return HardwareConfig(
        spec_name=str(obj.spec_name), grid=tuple(obj.grid),
        layout=tuple(obj.layout), nop_bw_gbps=float(obj.nop_bw_gbps),
        dram_bw_gbps=float(obj.dram_bw_gbps),
        micro_batch_prefill=int(obj.micro_batch_prefill),
        micro_batch_decode=int(obj.micro_batch_decode),
        tensor_parallel=int(obj.tensor_parallel))


def spec_from(obj) -> LLMSpec:
    """Every :class:`LLMSpec` field, copied by name (``moe`` rebuilt as the
    port's :class:`MoESpec`)."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(LLMSpec)}
    if kw["moe"] is not None:
        kw["moe"] = MoESpec(**{f.name: getattr(kw["moe"], f.name)
                               for f in dataclasses.fields(MoESpec)})
    return LLMSpec(**kw)


def request_from(obj) -> Request:
    """``kind``, ``q_len`` and ``kv_len`` of one batch entry."""
    return Request(str(obj.kind), int(obj.q_len), int(obj.kv_len))


def _flatten(tree, prefix=""):
    """Dotted paths of a nested dict/list tree of arrays, the way
    :meth:`torch.nn.Module.named_parameters` names them."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from _flatten(sub, f"{prefix}.{key}" if prefix else str(key))


def params_from_jax(tree, cfg, device, dtype=torch.float32):
    """The port's model for ``cfg`` holding the weights of a JAX parameter
    tree (``repro.models.init_model``'s pytree with numpy leaves), copied
    onto ``device`` (``None`` = CUDA). Every leaf path must name a
    parameter of the port's model with the same shape, and every parameter
    must be given."""
    from ..models.transformer import Transformer
    from .timing import resolve_device

    leaves = dict(_flatten(tree))
    with torch.no_grad():
        model = Transformer(cfg, dtype=dtype, device=resolve_device(device))
        params = dict(model.named_parameters())
        if set(params) != set(leaves):
            raise ValueError(
                f"parameter trees differ: only in the source "
                f"{sorted(set(leaves) - set(params))}, only in the port "
                f"{sorted(set(params) - set(leaves))}")
        for name, p in params.items():
            src = torch.tensor(np.asarray(leaves[name]))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
    return model


CACHE_LEAVES = ({"k", "v", "len"}, {"kv", "len"}, {"state", "len"},
                {"k", "v", "k_scale", "v_scale", "len"},
                {"kv", "kv_scale", "len"})


def cache_from_jax(caches, device):
    """A list of per-layer cache dicts with numpy leaves (``k``, ``v``,
    ``len`` of an attention layer, or ``kv``, ``len`` of an MLA layer,
    float32 or bfloat16; the same of an int8 cache with its float32
    ``k_scale``, ``v_scale`` or ``kv_scale``; ``state``, ``len`` of a Mamba
    layer) as the port's caches on ``device`` (``None`` = CUDA), in the
    leaves' types. Any other set of leaves, and scales beside rows that
    are not int8, are refused."""
    from .timing import resolve_device

    dev = resolve_device(device)
    for i, layer in enumerate(caches):
        if set(layer) not in CACHE_LEAVES:
            raise ValueError(f"cache layer {i} has leaves {sorted(layer)}, "
                             f"not one of {[sorted(c) for c in CACHE_LEAVES]}")
        if "state" in layer:
            continue
        rows = np.asarray(layer["kv" if "kv" in layer else "k"])
        scaled = any(key.endswith("_scale") for key in layer)
        if scaled != (rows.dtype == np.int8):
            raise ValueError(f"cache layer {i} has leaves {sorted(layer)} "
                             f"over {rows.dtype} rows: an int8 cache, and "
                             f"only an int8 cache, has scales")
    return [{k: _tensor(v, dev) for k, v in layer.items()}
            for layer in caches]


def _tensor(x, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; a bfloat16 array (numpy
    has no such type of its own, so it arrives as ``ml_dtypes.bfloat16``)
    goes through float32, which holds every bfloat16 value exactly."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(x, device=device)
