"""Build the port's data objects from plain fields and numpy arrays.

Each function reads attributes by name from any object that has them
(duck typing), so a mapping population, a set of cost tables or a hardware
point made elsewhere — for example by the JAX reference package in a
parity test — becomes the port's own object with copied arrays and no
reference to the source. Nothing here imports the source's package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
