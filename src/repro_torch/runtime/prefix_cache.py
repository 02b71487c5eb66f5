"""Prefix cache: a radix tree over token prefixes mapping to KV pages
(the port's own copy of the JAX package's ``runtime/prefix_cache.py``,
over the port's :class:`~repro_torch.runtime.paged_cache.BlockAllocator`;
pure Python and numpy, no tensor is touched).

The paper's thesis is that the cheapest byte is the one never moved;
in serving, the biggest avoidable byte-mover left after paging is
re-prefilling identical prompt prefixes (system prompts, few-shot
headers, chat history) into fresh KV pages on every request.  This
module indexes *finished* sequences' KV pages by their token content
so later requests can splice the cached pages into their block tables
and prefill only the uncached tail.

Structure
- A trie keyed at page granularity: each node is one physical page of
  the :class:`~repro_torch.runtime.paged_cache.PagedKVCache` pool, its edge
  key the exact ``block_size``-token chunk the page holds.  A node's
  root path spells the full token prefix, so a match guarantees the
  cached KV was computed under byte-identical context (RoPE positions
  are absolute — page ``j`` always holds positions ``[j*bs, (j+1)*bs)``).
- The last page of a retired sequence is usually *partial* (fewer than
  ``block_size`` tokens).  It is inserted as a leaf keyed by its short
  chunk; a later request matching it takes a copy-on-write clone
  before filling the remainder — shared pages are never mutated.
- Nodes carry a pin count (sequences currently reading the page) and
  an LRU stamp.  ``evict`` frees unpinned leaves oldest-first; pinned
  nodes and interior nodes (their children's context) are immovable.

Ownership: a page in the trie holds one allocator refcount; each pin
adds one.  Eviction drops the trie's count, returning the page to the
free list iff no sequence still reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.runtime.paged_cache import BlockAllocator


@dataclasses.dataclass
class PrefixStats:
    """Counters for the hit-rate / bytes-not-moved story."""
    queries: int = 0            # admission-time lookups
    hits: int = 0               # lookups that matched >= 1 page
    tokens_reused: int = 0      # prompt tokens served from the trie
    tokens_missed: int = 0      # prompt tokens that had to be prefilled
    inserted_pages: int = 0     # pages adopted into the trie
    dedup_pages: int = 0        # retired pages freed as duplicates
    evicted_pages: int = 0      # pages reclaimed under pressure
    cow_copies: int = 0         # shared pages cloned before a write
    corrupt_dropped: int = 0    # pages dropped by the checksum audit

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.queries, 1)

    @property
    def token_hit_rate(self) -> float:
        total = self.tokens_reused + self.tokens_missed
        return self.tokens_reused / max(total, 1)


class PrefixNode:
    """One cached page.  ``key`` is the exact token chunk it holds
    (``block_size`` ints, fewer for a partial tail page)."""

    __slots__ = ("key", "page", "children", "parent", "refs", "last_used")

    def __init__(self, key: tuple[int, ...], page: int,
                 parent: "PrefixNode | None"):
        self.key = key
        self.page = page
        self.children: dict[tuple[int, ...], PrefixNode] = {}
        self.parent = parent
        self.refs = 0           # sequences currently pinning this page
        self.last_used = 0

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"PrefixNode(page={self.page}, len={len(self.key)}, "
                f"refs={self.refs}, children={len(self.children)})")


class PrefixCache:
    """Radix index over token prefixes -> physical KV pages."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self.root = PrefixNode((), -1, None)
        self.stats = PrefixStats()
        self._tick = 0
        # structural version: bumped whenever a node is added (insert)
        # or removed (evict).  match() over a fixed prompt is a pure
        # function of this — the engine caches per-request matches
        # across scheduler ticks and revalidates on the generation.
        self.generation = 0

    # ------------------------------------------------------------ walk
    def _nodes(self) -> Iterator[PrefixNode]:
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    @property
    def num_pages(self) -> int:
        return sum(1 for _ in self._nodes())

    def pages(self) -> set[int]:
        return {nd.page for nd in self._nodes()}

    def pins(self) -> dict[int, int]:
        return {nd.page: nd.refs for nd in self._nodes() if nd.refs}

    # ----------------------------------------------------------- match
    def match(self, tokens: np.ndarray) -> tuple[list[PrefixNode], int]:
        """Longest cached prefix of ``tokens``: the node chain from the
        root and the number of tokens it covers.  Descent follows
        whole-page edges; the final edge may be *partially* used —
        cached KV at position ``p`` depends only on tokens up to ``p``,
        so the common prefix of an edge key and the remaining prompt is
        reusable even when the page holds more (the engine CoWs such a
        boundary page before writing past the match).  Does NOT pin —
        call :meth:`pin` on the result while using it."""
        bs = self.block_size
        n = len(tokens)
        out: list[PrefixNode] = []
        node, c = self.root, 0
        while True:
            nxt = None
            if c + bs <= n:
                nxt = node.children.get(tuple(int(t) for t in tokens[c:c + bs]))
            if nxt is not None:
                out.append(nxt)
                node, c = nxt, c + bs
                continue
            # no whole-page edge: take the child sharing the longest
            # common prefix with what's left of the prompt (a partial
            # stored leaf, or the head of a full page)
            best, best_use = None, 0
            for key, ch in node.children.items():
                use = 0
                for k, t in zip(key, tokens[c:]):
                    if k != int(t):
                        break
                    use += 1
                if use > best_use:
                    best, best_use = ch, use
            if best is not None:
                out.append(best)
                c += best_use
            break
        return out, c

    def match_len(self, tokens: np.ndarray) -> int:
        """Tokens of ``tokens`` covered by the longest cached prefix —
        a read-only peek (no pin, no LRU touch, no stats)."""
        return self.match(tokens)[1]

    def pin(self, nodes: Sequence[PrefixNode]) -> None:
        """Take a read reference on each matched page (refcount++), and
        freshen its LRU stamp — pinned pages cannot be evicted."""
        self._tick += 1
        for nd in nodes:
            nd.refs += 1
            nd.last_used = self._tick
            self.allocator.incref(nd.page)

    def unpin(self, nodes: Sequence[PrefixNode]) -> None:
        for nd in nodes:
            assert nd.refs > 0, nd
            nd.refs -= 1
            self.allocator.decref(nd.page)

    # ---------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray, blocks: Sequence[int],
               shared: set[int]) -> None:
        """Adopt a retired sequence's pages into the trie.

        ``tokens`` is the KV *content* of the sequence (prompt plus
        generated tokens whose KV was actually written) and ``blocks``
        its ordered page list; page ``j`` holds ``tokens[j*bs:(j+1)*bs]``.
        Ownership of each owned page transfers to the trie (it keeps
        the page's refcount); a page whose chunk is already cached is
        a duplicate and is freed instead.  Pages in ``shared`` were
        pinned from the trie at admission and are skipped (the caller
        unpins them separately)."""
        bs = self.block_size
        self._tick += 1
        node, c = self.root, 0
        for j, page in enumerate(blocks):
            chunk = tuple(int(t) for t in tokens[c:min(c + bs, len(tokens))])
            if not chunk:
                # allocated-ahead page with no content yet: not cacheable
                if page not in shared:
                    self.allocator.free([page])
                continue
            existing = node.children.get(chunk)
            if existing is not None:
                existing.last_used = self._tick
                if existing.page != page and page not in shared:
                    # same content already cached under the same prefix
                    self.stats.dedup_pages += 1
                    self.allocator.free([page])
                node = existing
            elif len(chunk) == bs:
                if page in shared:
                    # pinned from a *partial* node but completed to a
                    # full page by this sequence — that means it was
                    # CoW'd and can't still be shared; guard anyway.
                    node = self.root  # pragma: no cover - unreachable
                    break
                child = PrefixNode(chunk, page, node)
                child.last_used = self._tick
                node.children[chunk] = child
                node = child
                self.stats.inserted_pages += 1
                self.generation += 1
            else:
                # partial tail page: insert as a leaf and stop
                if page not in shared:
                    leaf = PrefixNode(chunk, page, node)
                    leaf.last_used = self._tick
                    node.children[chunk] = leaf
                    self.stats.inserted_pages += 1
                    self.generation += 1
                break
            c += bs
        # NOTE: a partial node matched at admission stays a leaf; a
        # sequence that extended it did so in a CoW copy, which lands
        # here as a *sibling* full node under the same parent.

    # ------------------------------------------------------ corruption
    def drop_subtree(self, page: int) -> list[int]:
        """Remove the node holding ``page`` AND its whole subtree,
        freeing every page.  Used by the engine's checksum audit when a
        cached page's bytes flip: descendants spell prefixes *through*
        the corrupt page, so matching them would splice corrupt KV into
        a new sequence's context — the entire branch is unservable.

        Every node in the subtree must be unpinned: the engine fails
        (and thereby unpins) all sequences reading the corrupt page
        first, and pinning a descendant implies pinning the whole chain
        from the root, so no descendant can stay pinned once the
        corrupt node's own readers are gone.  Returns the freed pages.
        """
        target = next((nd for nd in self._nodes() if nd.page == page),
                      None)
        if target is None:
            return []
        subtree: list[PrefixNode] = []
        stack = [target]
        while stack:
            nd = stack.pop()
            subtree.append(nd)
            stack.extend(nd.children.values())
        for nd in subtree:
            assert nd.refs == 0, (nd, "pinned node in corrupt subtree")
        del target.parent.children[target.key]
        freed = []
        for nd in subtree:
            self.allocator.decref(nd.page)
            self.stats.corrupt_dropped += 1
            self.generation += 1
            freed.append(nd.page)
        return freed

    # ----------------------------------------------------------- evict
    def evict(self, n: int) -> int:
        """Free up to ``n`` pages, LRU-leaf-first.  Only unpinned
        leaves are evictable (an interior node is load-bearing context
        for its children).  Works in waves — one trie walk collects
        the current evictable leaves, oldest go first; evicting a leaf
        may expose its parent for the next wave — so reclaiming ``n``
        pages costs O(waves * trie + n log n), not O(n * trie).
        Returns the number of pages freed."""
        freed = 0
        while freed < n:
            leaves = sorted(
                (nd for nd in self._nodes()
                 if not nd.children and not nd.refs),
                key=lambda nd: nd.last_used)
            if not leaves:
                break
            for nd in leaves[: n - freed]:
                del nd.parent.children[nd.key]
                self.allocator.decref(nd.page)
                self.stats.evicted_pages += 1
                self.generation += 1
                freed += 1
        return freed


__all__ = ["PrefixCache", "PrefixNode", "PrefixStats"]
