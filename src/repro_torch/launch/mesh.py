"""Meshes of the port: named device axes as the JAX package's
``launch/mesh.py`` builds them, without JAX.

A :class:`Mesh` carries its axis names, a ``shape`` dict (axis name ->
size, read by the sharding rules as they read a JAX mesh's) and, where
real devices back it, their list. The production meshes (single pod =
16 x 16 (data, model) = 256 chips; multi-pod (2, 16, 16) = 512) are
abstract: they name no device and exist for the sharding rules, the dry
run and the roofline. :func:`make_mesh` backs a mesh with devices.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: dict
    devices: tuple | None = None

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, dict(zip(axes, shape)))


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: the first CUDA devices), as many
    as the product of ``shape``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    n = math.prod(shape)
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(min(n, count))]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got "
                         f"{len(devices)}")
    return Mesh(axes, dict(zip(axes, shape)), devices)
