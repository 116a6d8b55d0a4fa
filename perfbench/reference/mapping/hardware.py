"""Frozen copy of the port's ``core/hardware.py`` (pure Python and numpy), kept
beside the benchmark so that the reference rebuilds what the port derives
(rollouts, execution graphs, cost tables) with code that later changes to
the port cannot move. The original docstring follows.

Hardware model for multi-chiplet accelerators (paper §III-B, §V-B).

Defines the chiplet library (capacity x dataflow), the package-level
configuration tensor Z = [z_sys, z_shape, z_layout], NoP mesh geometry with
XY routing, DRAM placement, and the monetary-cost model (yield formula from
Gemini, IO-die + package costs).

All technology constants are 12nm-class estimates and are documented inline;
the paper's absolute dollar/energy numbers depend on its (unpublished)
constants, so ours are self-consistent rather than matched (DESIGN.md §11).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence

# --------------------------------------------------------------------------
# Technology constants (TSMC 12nm-class, 1 GHz clock — paper §VI-A)
# --------------------------------------------------------------------------
FREQ_HZ = 1.0e9

# Energy per action (picojoules). Sources: Simba (16nm MAC ~0.39pJ),
# typical SRAM ~0.5-1 pJ/B, LPDDR ~30-60 pJ/B, GRS NoP links ~1 pJ/bit/hop.
E_MAC_PJ = 0.8          # one bf16 MAC
E_GLB_PJ_PER_BYTE = 1.0  # GLB (SRAM) access
E_DRAM_PJ_PER_BYTE = 40.0
E_NOP_PJ_PER_BYTE_HOP = 4.0
E_VECTOR_PJ_PER_OP = 0.4  # post-processing (softmax/norm/activation) ops

# Area model (mm^2).
MM2_PER_MAC = 1.0 / 700.0       # ~700 MACs/mm^2 at 12nm incl. datapath
MM2_PER_MB_SRAM = 0.85
NOC_AREA_FRACTION = 0.05        # chiplet-internal NoC overhead
MM2_OTHERS = 1.0                # control + post-processing + pads
ALPHA_MM2_PER_GBPS_NOP = 0.01   # chiplet PHY area per GB/s of NoP bandwidth
BETA_MM2_PER_GBPS_NOP = 0.02    # IO-die area per GB/s of NoP bandwidth
GAMMA_MM2_PER_GBPS_DRAM = 0.05  # IO-die area per GB/s of DRAM bandwidth

# Yield / cost (Gemini's model: Y_c = Y_unit ** (A_c / A_unit)).
Y_UNIT = 0.95
A_UNIT_MM2 = 10.0
COST_PER_MM2_CHIP = 0.08   # 12nm compute die
COST_PER_MM2_IO = 0.04     # older-node IO die
COST_PER_MM2_PACKAGE = 0.005
Y_IO = 0.98

N_DRAM_CHIPS = 4  # evenly distributed on left/right edges (paper §VI-A)

BYTES_PER_ELEM = 2  # bf16 end to end

# --------------------------------------------------------------------------
# Chiplet library (paper Table IV)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ChipletSpec:
    name: str
    macs: int         # MAC units in the PE array
    glb_bytes: int    # global buffer capacity

    @property
    def array_dim(self) -> int:
        """Side of the (square) PE array."""
        return int(math.isqrt(self.macs))

    @property
    def tops(self) -> float:
        return 2.0 * self.macs * FREQ_HZ / 1e12


CHIPLET_LIBRARY: dict[str, ChipletSpec] = {
    "S": ChipletSpec("S", 1024, 2 * 2**20),
    "M": ChipletSpec("M", 4096, 8 * 2**20),
    "L": ChipletSpec("L", 16384, 32 * 2**20),
}

DATAFLOWS: tuple[str, ...] = ("WS", "OS")

# Candidate values (paper Table IV)
NOP_BW_CANDIDATES_GBPS = (32, 64, 128, 256, 512)
DRAM_BW_CANDIDATES_GBPS = (16, 32, 64, 128, 256)
MICRO_BATCH_PREFILL_CANDIDATES = (1, 2, 4)
MICRO_BATCH_DECODE_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128)
TENSOR_PARALLEL_CANDIDATES = (4, 8, 16, 32, 64)


def n_chiplets_for_target(target_tops: float, spec: ChipletSpec) -> int:
    """Total-compute constraint: the uniform capacity dictates chiplet count.

    Matches the paper's counts: 64 TOPS / L -> 2; 512 / L -> 16; 2048 / L -> 64;
    512 / M -> 64.
    """
    return max(1, math.ceil(target_tops / spec.tops))


def grid_for_count(n: int) -> tuple[int, int]:
    """Near-square (H, W) factorisation of the chiplet count."""
    h = int(math.isqrt(n))
    while n % h != 0:
        h -= 1
    return (h, n // h)


@dataclass(frozen=True)
class HardwareConfig:
    """A point Z = [z_sys, z_shape, z_layout] in the hardware space (§V-B)."""

    spec_name: str                 # z_shape: uniform chiplet capacity
    grid: tuple[int, int]          # (H, W) array dimension
    layout: tuple[str, ...]        # z_layout: dataflow per slot, len H*W
    nop_bw_gbps: float             # z_sys
    dram_bw_gbps: float            # z_sys, per DRAM chip
    micro_batch_prefill: int = 4   # z_sys (searched by BO, paper §V-A)
    micro_batch_decode: int = 16   # z_sys
    tensor_parallel: int = 8       # z_sys: number of FFN layer partitions

    def __post_init__(self):
        assert self.spec_name in CHIPLET_LIBRARY
        assert len(self.layout) == self.grid[0] * self.grid[1]
        assert all(d in DATAFLOWS for d in self.layout)

    @property
    def spec(self) -> ChipletSpec:
        return CHIPLET_LIBRARY[self.spec_name]

    @property
    def n_chiplets(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def nop_bw(self) -> float:
        return self.nop_bw_gbps * 1e9

    @property
    def dram_bw(self) -> float:
        return self.dram_bw_gbps * 1e9

    def coords(self, chip: int) -> tuple[int, int]:
        return divmod(chip, self.grid[1])

    def hops(self, a: int, b: int) -> int:
        """XY-routing hop count on the package mesh."""
        (ya, xa), (yb, xb) = self.coords(a), self.coords(b)
        return abs(xa - xb) + abs(ya - yb)

    def dram_hops(self, chip: int) -> int:
        """Hops to the nearest edge IO die (DRAM on left/right edges)."""
        _, x = self.coords(chip)
        return 1 + min(x, self.grid[1] - 1 - x)

    def replace(self, **kw) -> "HardwareConfig":
        return dataclasses.replace(self, **kw)


def make_hardware(
    target_tops: float,
    spec_name: str = "L",
    layout: Sequence[str] | None = None,
    nop_bw_gbps: float = 32,
    dram_bw_gbps: float = 16,
    **kw,
) -> HardwareConfig:
    spec = CHIPLET_LIBRARY[spec_name]
    n = n_chiplets_for_target(target_tops, spec)
    grid = grid_for_count(n)
    if layout is None:
        layout = ("WS",) * n
    layout = tuple(layout)
    assert len(layout) == n, f"layout len {len(layout)} != {n} chiplets"
    return HardwareConfig(
        spec_name=spec_name, grid=grid, layout=layout,
        nop_bw_gbps=nop_bw_gbps, dram_bw_gbps=dram_bw_gbps, **kw,
    )


# --------------------------------------------------------------------------
# Monetary cost (paper §V-C, Gemini yield model)
# --------------------------------------------------------------------------


def chiplet_area_mm2(hw: HardwareConfig) -> float:
    spec = hw.spec
    a_mac = spec.macs * MM2_PER_MAC
    a_sram = spec.glb_bytes / 2**20 * MM2_PER_MB_SRAM
    a_noc = NOC_AREA_FRACTION * (a_mac + a_sram)
    return a_mac + a_sram + a_noc + ALPHA_MM2_PER_GBPS_NOP * hw.nop_bw_gbps + MM2_OTHERS


def monetary_cost(hw: HardwareConfig) -> dict[str, float]:
    """MC_total = sum chiplet costs + IO-die costs + package cost."""
    a_c = chiplet_area_mm2(hw)
    y_c = Y_UNIT ** (a_c / A_UNIT_MM2)
    mc_chip = a_c / y_c * COST_PER_MM2_CHIP
    mc_chips = hw.n_chiplets * mc_chip

    a_io = (BETA_MM2_PER_GBPS_NOP * hw.nop_bw_gbps
            + GAMMA_MM2_PER_GBPS_DRAM * hw.dram_bw_gbps)
    mc_io = N_DRAM_CHIPS * (a_io / Y_IO * COST_PER_MM2_IO)

    total_area = hw.n_chiplets * a_c + N_DRAM_CHIPS * a_io
    mc_pack = total_area * COST_PER_MM2_PACKAGE
    total = mc_chips + mc_io + mc_pack
    return {
        "chiplet_area_mm2": a_c,
        "chiplet_yield": y_c,
        "mc_chiplets": mc_chips,
        "mc_io": mc_io,
        "mc_package": mc_pack,
        "mc_total": total,
    }
