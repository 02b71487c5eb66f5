"""Paged KV cache: fixed-size pages + per-sequence block tables (port of
the JAX package's ``runtime/paged_cache.py``, which imports JAX, so the
port owns this copy).

- Page 0 is the trash page: never allocated; it absorbs writes from
  inactive slots and prefill padding, and table entries past a
  sequence's allocation point at it so every gather index is valid.
- Logical block ``j`` of a sequence holds tokens ``[j*bs, (j+1)*bs)``;
  ``block_tables[slot, j]`` is its physical page.
- Every non-trash page is free (refcount 0), owned by one live slot
  (refcount 1), or held by the prefix trie (refcount 1 plus one per
  slot that pins it); ``audit_partition`` asserts this partition.
- A slot writes only pages it owns: prefix pages pinned from the trie
  are read-only, and the engine copies a shared page
  (``cow_slot_page``) before the first write into it.

The page pools ``k_pages``/``v_pages`` live on the device and are
written in place by the model steps; the host keeps the allocator, the
block tables and the lengths, and hands the device a small int32 view
of them each step (``view``, or ``fill`` into a step's own buffers and
``bind``).  Pools are float32, bfloat16 or float8_e4m3fn, or uint8 in
codes mode (each element a DNA-TEQ code under its layer's per-head
table).

Migration (the disaggregated cluster's KV handoff): ``export_slot``
gathers a slot's pages on the device in block-table order and copies
them to pinned host memory -- the handoff is host-resident, a host copy
standing in for an inter-host link, as in the reference -- and
``import_slot`` copies such pages to the device and scatters them in
place into fresh pages of another pool, binding the slot as if it had
prefilled there.  Pools, block tables and lengths are all written in
place: captured steps hold their pointers.

The engine's checksum audit reads pages through ``page_checksums``: the
reference's CRC32 of a page's K bytes then V bytes (the pools have its
layout, so byte-equal pages give its CRC), all pages of a call in one
gather and one copy to the host.  ``corrupt_page`` (chaos) writes in
place, so a captured step sees it.
"""

from __future__ import annotations

import math
import weakref
import zlib
from typing import NamedTuple, Sequence

import numpy as np
import torch

TRASH_PAGE = 0
F8 = torch.float8_e4m3fn


class PagedView(NamedTuple):
    """What a model step reads and writes.

    k_pages/v_pages: [L, num_blocks, block_size, n_kv, hd]
    block_tables:    [B, cols] int32 physical page ids
    lengths:         [B] int32 tokens already present per sequence
    moe_counts:      [3] int64 the cache's MoE capacity tally, or None
                     (:attr:`PagedKVCache.moe_counts`)
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    moe_counts: torch.Tensor | None = None

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

    def incref(self, block: int) -> None:
        assert block != TRASH_PAGE and self._refcount[block] > 0, block
        self._refcount[block] += 1

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
        # the subset of slot_blocks[i] pinned from the prefix trie:
        # read-only for the slot, written only after cow_slot_page
        self.slot_shared: list[set[int]] = [set() for _ in range(num_slots)]
        self._crc_host: torch.Tensor | None = None   # page_checksums' buffer
        # the MoE layers' capacity tally (routed calls, slots routed,
        # slots dropped past capacity), added to on the device by every
        # routed dispatch through this cache's views: allocated with the
        # pools, so a captured step's adds land here as long as the
        # graphs that write the pools live
        self.moe_counts = torch.zeros(3, dtype=torch.int64, device=device)

    @property
    def nbytes(self) -> int:
        """Device bytes of both page pools."""
        return self.k_pages.nbytes + self.v_pages.nbytes

    def moe_capacity(self) -> dict:
        """The MoE capacity tally (a host read): routed calls, slots
        routed and slots dropped, over every dispatch through this
        cache."""
        calls, slots, dropped = self.moe_counts.tolist()
        return {"calls": calls, "slots": slots, "dropped": dropped}

    def blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_size))

    @property
    def bytes_per_block(self) -> int:
        """Bytes of one page: K and V, every layer."""
        l, _, bs, kv, hd = self.k_pages.shape
        return 2 * l * bs * kv * hd * self.k_pages.element_size()

    def kv_bytes_in_use(self) -> int:
        return self.allocator.blocks_in_use * self.bytes_per_block

    def peak_kv_bytes(self) -> int:
        return self.allocator.peak_in_use * self.bytes_per_block

    def register_metrics(self, scope) -> None:
        """Register the allocator's gauges under ``engine.pages.*`` in a
        metrics scope (a ``telemetry.Scope``; this module does not
        import it).  Callback-backed: a read sees the live free list.  The
        byte gauges hold the cache weakly (0 once it is gone), so a
        registry that outlives its engine does not keep the pools."""
        a, ref = self.allocator, weakref.ref(self)
        scope.gauge("engine.pages.free", lambda: a.free_blocks,
                    help="pages on the free list")
        scope.gauge("engine.pages.in_use", lambda: a.blocks_in_use)
        scope.gauge("engine.pages.peak", lambda: a.peak_in_use)
        scope.gauge("engine.pages.bytes_in_use",
                    lambda: 0 if ref() is None else ref().kv_bytes_in_use())
        scope.gauge("engine.pages.peak_bytes",
                    lambda: 0 if ref() is None else ref().peak_kv_bytes())

    # ------------------------------------------------------------ slot ops
    def bind_slot(self, slot: int, prompt_tokens: int,
                  shared: Sequence[int] = (), *,
                  reserved: bool = True) -> list[int]:
        """Install the table row for a new sequence: the ``shared`` pages
        (already pinned from the prefix trie) spliced read-only at the
        front, then freshly allocated pages covering the rest of the
        prompt.  Returns the new (owned) pages."""
        assert not self.slot_blocks[slot], "slot already bound"
        need = self.blocks_for(prompt_tokens) - len(shared)
        assert need >= 0, (prompt_tokens, len(shared))
        owned = self.allocator.alloc(need, reserved=reserved) if need else []
        blocks = list(shared) + owned
        self.slot_blocks[slot] = blocks
        self.slot_shared[slot] = set(shared)
        self.block_tables[slot, :] = TRASH_PAGE
        self.block_tables[slot, : len(blocks)] = blocks
        self.lengths[slot] = prompt_tokens
        return owned

    def cow_slot_page(self, slot: int, col: int) -> tuple[int, int]:
        """Copy-on-write logical block ``col``: allocate a private page,
        copy the shared page into it (every layer, K and V, on the
        pools' device, ordered on the stream before the next step) and
        swap the table entry.  The shared page keeps its trie reference
        (the engine unpins it).  Returns ``(old_page, new_page)``."""
        old = self.slot_blocks[slot][col]
        assert old in self.slot_shared[slot], (slot, col, old)
        (new,) = self.allocator.alloc(1, reserved=False)
        for pool in (self.k_pages, self.v_pages):
            # through bytes: index_copy_ has no CPU kernel for e4m3
            raw = pool.view(torch.uint8) if pool.dtype == F8 else pool
            raw[:, new].copy_(raw[:, old])
        self.slot_blocks[slot][col] = new
        self.slot_shared[slot].discard(old)
        self.block_tables[slot, col] = new
        return old, new

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
        """Retire a sequence: its owned pages go back to the free list;
        shared (trie-pinned) pages are left to the engine's unpin.
        Returns the number of owned pages freed."""
        shared = self.slot_shared[slot]
        owned = [b for b in self.slot_blocks[slot] if b not in shared]
        self.allocator.free(owned)
        self.clear_slot(slot)
        return len(owned)

    def clear_slot(self, slot: int) -> list[int]:
        """Detach a slot without freeing anything (the caller took the
        pages over, e.g. into the prefix trie).  Returns the slot's
        block list."""
        blocks = self.slot_blocks[slot]
        self.slot_blocks[slot] = []
        self.slot_shared[slot] = set()
        self.block_tables[slot, :] = TRASH_PAGE
        self.lengths[slot] = 0
        return blocks

    # ------------------------------------------------------- migration
    def export_slot(self, slot: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Copy a slot's KV pages out of the pool for migration to another
        worker's pool: host tensors ``[L, n_pages, bs, n_kv, hd]`` for K
        and V in the pool's dtype, in block-table order -- what
        :meth:`import_slot` scatters into a peer pool.  Shared (trie)
        pages are exported too: the importer gets private copies.  The
        positions past ``lengths[slot]`` in the last page ride along as
        they are, as in the reference; the attention kernels give them
        the reference's weight 0.  One gather a pool on the device, then
        one copy of both into pinned host memory (on the card)."""
        blocks = self.slot_blocks[slot]
        assert blocks, f"slot {slot} has no pages to export"
        dev = self.k_pages.device
        idx = torch.as_tensor(blocks, dtype=torch.long, device=dev)
        l, _, bs, kv, hd = self.k_pages.shape
        # through bytes: index_select has no CPU kernel for e4m3
        raw = [p.view(torch.uint8) if p.dtype == F8 else p
               for p in (self.k_pages, self.v_pages)]
        shape = (2, l, len(blocks), bs, kv, hd)
        both = torch.empty(shape, dtype=raw[0].dtype, device=dev)
        for i, r in enumerate(raw):
            torch.index_select(r, 1, idx, out=both[i])
        if both.is_cuda:
            host = torch.empty(shape, dtype=both.dtype, pin_memory=True)
            host.copy_(both)
            both = host
        if self.dtype == F8:
            both = both.view(F8)
        return both[0], both[1]

    def import_slot(self, slot: int, length: int, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, *, reserved: bool = False
                    ) -> list[int]:
        """Adopt migrated KV content into this pool: allocate fresh
        pages, copy the exported pages to the device and scatter them in
        place, and bind the slot as if it had prefilled here (owned
        pages, none shared; its table row and length written in place).
        Only content and block-table order migrate; the page ids are
        this pool's.  Returns the new block list."""
        assert not self.slot_blocks[slot], "slot already bound"
        l, n, bs, kv, hd = k_pages.shape
        el, _, ebs, ekv, ehd = self.k_pages.shape
        assert (l, bs, kv, hd) == (el, ebs, ekv, ehd), (
            f"page geometry mismatch: import {(l, bs, kv, hd)} vs pool "
            f"{(el, ebs, ekv, ehd)}")
        assert n == self.blocks_for(length), (n, length, self.block_size)
        assert n <= self.max_blocks_per_seq, (n, self.max_blocks_per_seq)
        if k_pages.dtype != self.dtype or v_pages.dtype != self.dtype:
            raise TypeError(f"handoff pages {k_pages.dtype} into a "
                            f"{self.dtype} pool")
        blocks = self.allocator.alloc(n, reserved=reserved)
        dev = self.k_pages.device
        idx = torch.as_tensor(blocks, dtype=torch.long, device=dev)
        for pool, pages in ((self.k_pages, k_pages), (self.v_pages, v_pages)):
            # through bytes: index_copy_ has no CPU kernel for e4m3
            raw = pool.view(torch.uint8) if pool.dtype == F8 else pool
            src = pages.view(torch.uint8) if pages.dtype == F8 else pages
            src = src.to(dev, non_blocking=src.is_pinned())
            raw.index_copy_(1, idx, src)
        self.slot_blocks[slot] = list(blocks)
        self.slot_shared[slot] = set()
        self.block_tables[slot, :] = TRASH_PAGE
        self.block_tables[slot, :n] = blocks
        self.lengths[slot] = length
        return blocks

    # ------------------------------------------------------- checksums
    def page_checksums(self, pages: Sequence[int]) -> list[int]:
        """CRC32 of each page's K bytes then V bytes, all layers (the
        reference's ``page_checksum``: the pools have its layout, so
        byte-equal pages give its CRC).  The pages cross to the host in
        one gather and one copy, whatever their number."""
        if not len(pages):
            return []
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.k_pages.device)
        # through bytes (no CPU e4m3 gather), page-major: [n, 2, L, ...]
        both = torch.stack([p.view(torch.uint8).index_select(1, idx)
                            for p in (self.k_pages, self.v_pages)], 1)
        both = both.transpose(0, 2).contiguous()
        host = both
        if both.is_cuda:
            # one pinned staging buffer, kept and grown as needed
            if self._crc_host is None or self._crc_host.numel() < both.numel():
                self._crc_host = torch.empty(both.numel(), dtype=torch.uint8,
                                             pin_memory=True)
            host = self._crc_host[:both.numel()].view(both.shape)
            host.copy_(both)
        buf = host.numpy()
        return [zlib.crc32(buf[j]) for j in range(len(pages))]

    def page_checksum(self, page: int) -> int:
        """CRC32 over one page's K and V bytes, all layers: what the
        engine's checksum audit records after every write to a page and
        verifies before the next dispatch."""
        return self.page_checksums([page])[0]

    def corrupt_page(self, page: int) -> None:
        """Chaos helper: set one stored element of ``page`` (layer 0,
        position 0, head 0, lane 0 of K) to a value it does not hold
        (7 -> 11, else 7), so the page's checksum changes in every pool
        dtype.  In place, through that element's bytes: a captured step
        reads the corrupt page, and the bytes are the reference's."""
        assert page != TRASH_PAGE, "corrupting the trash page is a no-op"
        cur = float(self.k_pages[0, page, 0, 0, 0].float())
        bad = torch.tensor([11.0 if cur == 7 else 7.0]).to(self.dtype)
        n = self.k_pages.element_size()
        raw = self.k_pages.view(torch.uint8)
        raw[0, page, 0, 0, :n].copy_(bad.view(torch.uint8))

    # ------------------------------------------------------------ audit
    def audit_partition(self, trie_pages: set[int] = frozenset(),
                        trie_pins: dict[int, int] | None = None) -> None:
        """Assert the page partition: free, slot-owned, trie and trash
        pages cover every page exactly once, and the refcounts agree
        (owned pages 1; trie pages 1 plus one per pinning slot, which
        ``trie_pins`` must count too when given)."""
        alloc = self.allocator
        free = set(alloc._free)
        owned: set[int] = set()
        pins: dict[int, int] = {}
        for slot in range(self.num_slots):
            shared = self.slot_shared[slot]
            for b in self.slot_blocks[slot]:
                if b in shared:
                    assert b in trie_pages, (slot, b, "shared not in trie")
                    pins[b] = pins.get(b, 0) + 1
                else:
                    assert b not in owned, (slot, b, "owned twice")
                    owned.add(b)
        trie_pages = set(trie_pages)
        assert TRASH_PAGE not in free | owned | trie_pages
        assert not free & owned, free & owned
        assert not free & trie_pages, free & trie_pages
        assert not owned & trie_pages, owned & trie_pages
        universe = free | owned | trie_pages | {TRASH_PAGE}
        assert universe == set(range(alloc.num_blocks)), (
            set(range(alloc.num_blocks)) - universe)
        for b in free:
            assert alloc.refcount(b) == 0, (b, alloc.refcount(b))
        for b in owned:
            assert alloc.refcount(b) == 1, (b, alloc.refcount(b))
        for b in trie_pages:
            assert alloc.refcount(b) == 1 + pins.get(b, 0), (
                b, alloc.refcount(b), pins.get(b, 0))
        if trie_pins is not None:
            for b, n in pins.items():
                assert trie_pins.get(b, 0) == n, (b, trie_pins.get(b), n)

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
        return PagedView(self.k_pages, self.v_pages, block_tables, lengths,
                         self.moe_counts)

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
                         torch.as_tensor(np.ascontiguousarray(ln), device=dev),
                         self.moe_counts)
