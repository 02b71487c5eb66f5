"""Paged KV cache: fixed-size pages + per-sequence block tables (port of
the JAX package's ``runtime/paged_cache.py``, which imports JAX, so the
port owns this copy).

- Page 0 is the trash page: never allocated; it absorbs writes from
  inactive slots and prefill padding, and table entries past a
  sequence's allocation point at it so every gather index is valid.
- Logical block ``j`` of a sequence holds tokens ``[j*bs, (j+1)*bs)``;
  ``block_tables[slot, j]`` is its physical page.
- Every non-trash page is either free (refcount 0) or owned by one live
  slot (refcount 1); ``audit_partition`` asserts this.  (Pages held by
  the prefix trie come with the prefix cache, ROADMAP item 7.)

The page pools ``k_pages``/``v_pages`` live on the device and are
written in place by the model steps; the host keeps the allocator, the
block tables and the lengths, and hands the device a small int32 view
of them each step (``view``, or ``fill`` into a step's own buffers and
``bind``).  Pools are float32 or bfloat16, or uint8 in codes
mode (each element a DNA-TEQ code under its layer's per-head table).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

TRASH_PAGE = 0


class PagedView(NamedTuple):
    """What a model step reads and writes.

    k_pages/v_pages: [L, num_blocks, block_size, n_kv, hd]
    block_tables:    [B, cols] int32 physical page ids
    lengths:         [B] int32 tokens already present per sequence
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k_pages.shape[2]


class BlockAllocator:
    """Free-list page allocator with refcounts and reservations
    (``reserve`` earmarks capacity; ``alloc(reserved=False)`` cannot eat
    into it)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (page 0 is reserved trash)")
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, TRASH_PAGE, -1))
        self._refcount = np.zeros((num_blocks,), np.int32)
        self._reserved = 0
        self.peak_in_use = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def can_reserve(self, n: int) -> bool:
        return n <= len(self._free) - self._reserved

    def reserve(self, n: int) -> None:
        if not self.can_reserve(n):
            raise RuntimeError(
                f"reservation of {n} blocks exceeds free capacity "
                f"({len(self._free)} free, {self._reserved} reserved)")
        self._reserved += n

    def alloc(self, n: int = 1, *, reserved: bool = True) -> list[int]:
        """Pop ``n`` pages; ``reserved=True`` consumes reservations."""
        if reserved:
            if n > self._reserved:
                raise RuntimeError(f"alloc({n}) exceeds reservation "
                                   f"({self._reserved})")
            self._reserved -= n
        elif n > len(self._free) - self._reserved:
            raise RuntimeError(f"alloc({n}) exceeds unreserved capacity")
        out = [self._free.pop() for _ in range(n)]
        self._refcount[out] = 1
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)
        return out

    def refcount(self, block: int) -> int:
        return int(self._refcount[block])

    def decref(self, block: int) -> None:
        """Drop one reference; the page frees when the count hits 0."""
        assert block != TRASH_PAGE and self._refcount[block] > 0, block
        self._refcount[block] -= 1
        if self._refcount[block] == 0:
            self._free.append(block)

    def free(self, blocks: list[int]) -> None:
        """Release exclusively held pages (refcount must be 1)."""
        for b in blocks:
            assert b != TRASH_PAGE and b not in self._free, b
            assert self._refcount[b] == 1, (b, self._refcount[b])
            self.decref(b)


class PagedKVCache:
    """Page pool + per-slot block tables for a fixed set of decode slots.
    ``dtype``: float32, bfloat16, float8_e4m3fn (1 B an element) or uint8
    codes."""

    def __init__(self, *, num_layers: int, num_kv_heads: int, head_dim: int,
                 num_slots: int, block_size: int, num_blocks: int,
                 max_blocks_per_seq: int, dtype=torch.float32, device=None):
        self.block_size = block_size
        self.num_slots = num_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.dtype = dtype
        shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.allocator = BlockAllocator(num_blocks)
        # host metadata; rows of unused slots point at the trash page
        self.block_tables = np.full((num_slots, max_blocks_per_seq),
                                    TRASH_PAGE, np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.slot_blocks: list[list[int]] = [[] for _ in range(num_slots)]

    @property
    def nbytes(self) -> int:
        """Device bytes of both page pools."""
        return self.k_pages.nbytes + self.v_pages.nbytes

    def blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_size))

    # ------------------------------------------------------------ slot ops
    def bind_slot(self, slot: int, prompt_tokens: int, *,
                  reserved: bool = True) -> list[int]:
        """Install the table row for a new sequence with freshly
        allocated pages covering the prompt.  Returns the new pages.
        (Splicing shared prefix pages comes with the prefix cache,
        ROADMAP Queue 1 item 7.)"""
        assert not self.slot_blocks[slot], "slot already bound"
        owned = self.allocator.alloc(self.blocks_for(prompt_tokens),
                                     reserved=reserved)
        self.slot_blocks[slot] = list(owned)
        self.block_tables[slot, :] = TRASH_PAGE
        self.block_tables[slot, : len(owned)] = owned
        self.lengths[slot] = prompt_tokens
        return owned

    def ensure_capacity(self, slot: int, *, reserved: bool = True) -> None:
        """Grow the slot by one page iff the next write crosses into an
        unallocated logical block."""
        pos = int(self.lengths[slot])
        owned = len(self.slot_blocks[slot])
        if pos == owned * self.block_size:
            if owned >= self.max_blocks_per_seq:
                raise RuntimeError(
                    f"slot {slot} exceeded max_blocks_per_seq={owned}")
            (blk,) = self.allocator.alloc(1, reserved=reserved)
            self.slot_blocks[slot].append(blk)
            self.block_tables[slot, owned] = blk

    def release_slot(self, slot: int) -> int:
        """Retire a sequence: its pages go back to the free list.
        Returns the number of pages freed."""
        blocks = self.slot_blocks[slot]
        self.allocator.free(blocks)
        self.slot_blocks[slot] = []
        self.block_tables[slot, :] = TRASH_PAGE
        self.lengths[slot] = 0
        return len(blocks)

    # ------------------------------------------------------------ audit
    def audit_partition(self) -> None:
        """Assert that free, slot-owned and trash pages cover every page
        exactly once, with refcount 0 for free and 1 for owned pages."""
        alloc = self.allocator
        free = set(alloc._free)
        owned: set[int] = set()
        for slot in range(self.num_slots):
            for b in self.slot_blocks[slot]:
                assert b not in owned, (slot, b, "owned twice")
                owned.add(b)
        assert TRASH_PAGE not in free | owned
        assert not free & owned, free & owned
        universe = free | owned | {TRASH_PAGE}
        assert universe == set(range(alloc.num_blocks)), (
            set(range(alloc.num_blocks)) - universe)
        for b in free:
            assert alloc.refcount(b) == 0, (b, alloc.refcount(b))
        for b in owned:
            assert alloc.refcount(b) == 1, (b, alloc.refcount(b))

    # ------------------------------------------------------------ views
    def fill(self, block_tables: np.ndarray, lengths: np.ndarray) -> None:
        """Write the block tables' first ``block_tables.shape[1]``
        columns and the lengths into the given host arrays (a step's
        pinned input buffer), making no device tensor."""
        block_tables[...] = self.block_tables[:, :block_tables.shape[1]]
        lengths[...] = self.lengths

    def bind(self, block_tables: torch.Tensor,
             lengths: torch.Tensor) -> PagedView:
        """The page pools under device tables and lengths the caller
        owns (a step's static input buffers)."""
        return PagedView(self.k_pages, self.v_pages, block_tables, lengths)

    def view(self, cols: int | None = None) -> PagedView:
        """Device view of every slot.  ``cols`` trims the block table to
        its first ``cols`` logical columns, so the kernels see no column
        that no live sequence reaches."""
        bt, ln = self.block_tables, self.lengths
        if cols is not None:
            bt = bt[:, :cols]
        dev = self.k_pages.device
        return PagedView(self.k_pages, self.v_pages,
                         torch.as_tensor(np.ascontiguousarray(bt), device=dev),
                         torch.as_tensor(np.ascontiguousarray(ln), device=dev))
