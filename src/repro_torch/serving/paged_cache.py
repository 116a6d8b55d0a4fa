"""Paged KV residency: free-list block allocator + pooled cache + transfer
buffers (the serving memory model of vLLM / SHARK's block cache).

``BlockAllocator`` is the host-side truth about KV memory: a fixed pool of
``num_blocks`` blocks of ``block_len`` token positions each, a free list,
and per-request block tables. Admission reserves a request's *worst-case*
demand (prompt + max_new_tokens) up front, so an admitted request can never
run out of blocks mid-flight — OOM-of-blocks is an admission-time signal
the scheduler sees (the service reports 0 schedulable slots while the head
of the queue cannot be reserved), never a mid-decode crash.

``PagedKVCache`` owns the device pools (torch tensors on one device; see
``repro_torch.models.paged`` for the layout and the null-block/scratch-slot
conventions) plus the slot-indexed host bookkeeping (block tables, live
lengths) the service's entry points are fed from.

``TransferBufferPool`` recycles the small host staging arrays (tokens,
block tables, lengths) that every iteration ships to the device, so the
steady-state serving loop performs no per-iteration host allocation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.timing import resolve_device
from ..models.paged import NULL_BLOCK, init_paged_pools, is_slot_layer
from . import stats

__all__ = ["BlockAllocator", "PagedKVCache", "TransferBufferPool"]


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` KV blocks.

    Block ``NULL_BLOCK`` (= 0) is reserved as the pad/garbage-sink target
    and is never handed out; usable capacity is ``num_blocks - 1`` blocks.
    """

    def __init__(self, num_blocks: int, block_len: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if block_len < 1:
            raise ValueError("block_len must be >= 1")
        self.num_blocks = num_blocks
        self.block_len = block_len
        self._free = list(range(1, num_blocks))     # pop() -> highest id
        self._tables: dict[int, list[int]] = {}
        self.oom_events = 0
        self.peak_used = 0

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_used(self) -> int:
        return self.capacity - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.block_len))

    def can_reserve(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.blocks_free

    def reserve(self, rid: int, n_tokens: int) -> bool:
        """Allocate the blocks covering ``n_tokens`` for ``rid``; False (and
        an OOM event) when the free list cannot cover the demand."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already holds blocks")
        need = self.blocks_for(n_tokens)
        if need > self.blocks_free:
            self.oom_events += 1
            stats.bump("oom_events")
            return False
        blocks = [self._free.pop() for _ in range(need)]
        self._tables[rid] = blocks
        self.peak_used = max(self.peak_used, self.blocks_used)
        stats.bump("blocks_reserved", need)
        stats.high_water("peak_blocks_used", self.blocks_used)
        return True

    def table(self, rid: int) -> list[int]:
        return list(self._tables[rid])

    def free(self, rid: int) -> int:
        """Return ``rid``'s blocks to the free list (LIFO, so the next
        reservation reuses the hottest blocks). Returns the count."""
        blocks = self._tables.pop(rid)
        self._free.extend(reversed(blocks))
        stats.bump("blocks_freed", len(blocks))
        return len(blocks)

    def owners(self) -> dict[int, list[int]]:
        """rid -> owned block ids (copy), for invariant checks."""
        return {rid: list(t) for rid, t in self._tables.items()}


class PagedKVCache:
    """Device block pools + host bookkeeping for up to ``max_batch``
    concurrently resident requests of at most ``max_len`` tokens each.
    The attention pools hold ``dtype`` (a ``torch.dtype``: float32, or
    bfloat16 as the engine's cache may); they live on ``device``
    (``None`` = CUDA, raising where there is none)."""

    def __init__(self, cfg, max_batch: int, max_len: int,
                 block_len: int = 16, num_blocks: int | None = None,
                 dtype=torch.float32, device=None):
        if max_len % block_len:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of block_len "
                f"({block_len}) so the gathered dense view matches the "
                "legacy cache shape exactly")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.blocks_per_seq = max_len // block_len
        if num_blocks is None:
            # enough for every slot to be fully resident, + the null block
            num_blocks = max_batch * self.blocks_per_seq + 1
        self.allocator = BlockAllocator(num_blocks, block_len)
        self.device = resolve_device(device)
        self.pools = init_paged_pools(cfg, max_batch, num_blocks, block_len,
                                      dtype, self.device)
        self.tables_np = np.full((max_batch, self.blocks_per_seq),
                                 NULL_BLOCK, np.int32)
        self.lens_np = np.zeros((max_batch,), np.int32)
        self.scratch_slot = max_batch       # padding lanes' state row
        self.has_slot_state = any(is_slot_layer(p) for p in self.pools)

    @property
    def block_len(self) -> int:
        return self.allocator.block_len

    def capacity_tokens(self) -> int:
        return self.allocator.capacity * self.block_len

    def bind(self, slot: int, rid: int) -> None:
        """Point ``slot`` at ``rid``'s reserved blocks and reset its live
        length. No KV zeroing happens here — stale block contents are
        masked by length everywhere (copy-on-admit, not zero-on-admit);
        only the (tiny) recurrent state rows are cleared, in place."""
        table = self.allocator.table(rid)
        self.tables_np[slot] = NULL_BLOCK
        self.tables_np[slot, :len(table)] = table
        self.lens_np[slot] = 0
        for layer in self.pools:
            if is_slot_layer(layer):
                for v in layer.values():
                    v[slot].zero_()

    def release(self, slot: int, rid: int) -> None:
        self.allocator.free(rid)
        self.tables_np[slot] = NULL_BLOCK
        self.lens_np[slot] = 0

    def resident_bytes(self) -> int:
        total = 0
        for layer in self.pools:
            for v in layer.values():
                total += v.numel() * v.element_size()
        return int(total)


class TransferBufferPool:
    """Reusable host staging buffers, keyed by (shape, dtype).

    ``acquire`` hands back an *uninitialised* buffer (callers overwrite it
    fully); ``release`` returns it for reuse. Keeps at most ``capacity``
    buffers per key so a pathological shape mix cannot hoard memory.
    """

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._pools: dict[tuple, list[np.ndarray]] = {}
        self.hits = 0
        self.misses = 0

    def acquire(self, shape: tuple, dtype=np.int32) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        pool = self._pools.setdefault(key, [])
        if pool:
            self.hits += 1
            stats.bump("transfer_pool_hits")
            return pool.pop()
        self.misses += 1
        stats.bump("transfer_pool_misses")
        return np.empty(shape, dtype)

    def release(self, buf: np.ndarray) -> None:
        key = (buf.shape, buf.dtype.str)
        pool = self._pools.setdefault(key, [])
        if len(pool) < self.capacity:
            pool.append(buf)
