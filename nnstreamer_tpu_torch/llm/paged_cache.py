"""Paged KV cache: fixed-size blocks + free-list allocator (counterpart
of the JAX package's llm/paged_cache.py).

The pool holds `num_blocks` blocks of `block_size` token slots; every
sequence owns an ordered block table mapping its positions onto pool
blocks. Memory is bounded by the pool, admission by free blocks, and any
free block serves any sequence (the table, not adjacency, orders them).

Block 0 is the scratch block: padding rows of a bucketed decode batch and
the padded tail of a bucketed prefill write there, so pow2 padding never
touches a live sequence's cache. No live row's mask ever reaches it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

#: pool block index reserved for padding writes (never allocated)
SCRATCH_BLOCK = 0


class BlockAllocator:
    """Free-list allocator over the pool's block indices.

    All-or-nothing `alloc(n)`: a request gets its whole block set or
    stays queued (None) — partial grants would deadlock two
    half-admitted requests against each other. Single-threaded: the
    engine owns it from one scheduler thread.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"paged pool needs >= 2 blocks (1 scratch + 1 usable), "
                f"got {num_blocks}")
        self.num_blocks = num_blocks
        # LIFO free list: recently freed blocks are reused first
        self._free: List[int] = list(range(num_blocks - 1, SCRATCH_BLOCK, -1))
        self._owner: Dict[int, object] = {}
        self.high_water = 0
        self.alloc_calls = 0
        self.failed_allocs = 0

    @property
    def total(self) -> int:
        """Allocatable blocks (the scratch block is never granted)."""
        return self.num_blocks - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.total - len(self._free)

    def alloc(self, n: int, owner: object = None) -> Optional[List[int]]:
        """Grant `n` blocks or None (the caller queues)."""
        self.alloc_calls += 1
        if n < 0:
            raise ValueError(f"alloc({n}): negative block count")
        if n > len(self._free):
            self.failed_allocs += 1
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._owner[b] = owner
        self.high_water = max(self.high_water, self.used)
        return blocks

    def free_blocks(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._owner:
                raise ValueError(
                    f"free of unallocated block {b} (double free, or a "
                    f"block the allocator never granted)")
            del self._owner[b]
            self._free.append(b)

    def stats(self) -> dict:
        return {
            "blocks_total": self.total,
            "blocks_free": self.free,
            "blocks_used": self.used,
            "blocks_high_water": self.high_water,
            "utilization": round(self.used / self.total, 4),
            "alloc_calls": self.alloc_calls,
            "failed_allocs": self.failed_allocs,
        }


class PagedKVCache:
    """The device-resident block pool + its allocator.

    k/v pools: (n_layers, num_blocks, block_size, n_kv, head_dim) f32
    torch tensors on `device` (the paged kernels read f32 pools). The
    executor writes them in place; this class owns layout and
    accounting, never math.

    Sharded serving hands a `placer(shape, dtype)` that builds each pool
    as one slice per shard device, split on the kv-head axis
    (serving/sharding.kv_pool_placer): k and v are then lists of those
    slices. Allocator and tables are untouched; only where the bytes live
    changes.
    """

    def __init__(self, *, num_blocks: int, block_size: int, n_layers: int,
                 n_kv: int, head_dim: int, device=None, placer=None):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.n_layers = int(n_layers)
        self.n_kv = int(n_kv)
        self.head_dim = int(head_dim)
        shape = (self.n_layers, self.num_blocks, self.block_size,
                 self.n_kv, self.head_dim)
        if placer is not None:
            self.k = placer(shape, torch.float32)
            self.v = placer(shape, torch.float32)
        else:
            self.k = torch.zeros(shape, dtype=torch.float32, device=device)
            self.v = torch.zeros(shape, dtype=torch.float32, device=device)
        self.allocator = BlockAllocator(self.num_blocks)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold `n_tokens` token slots."""
        return max(1, -(-int(n_tokens) // self.block_size))

    @property
    def tokens_capacity(self) -> int:
        return self.allocator.total * self.block_size

    def stats(self) -> dict:
        out = self.allocator.stats()
        out["block_size"] = self.block_size
        out["tokens_capacity"] = self.tokens_capacity
        return out
