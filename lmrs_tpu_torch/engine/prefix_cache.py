"""Shared-prefix KV cache: radix-tree page reuse over the paged pool (the
resident tier of the reference's ``engine/prefix_cache.py``).

Every map request carries the same preamble before its chunk text, and the
reduce tree repeats its prompt head per node.  This module lets a new
request *start* its prefill at the first uncached token.

* Host-side radix tree keyed on TOKEN IDS at page granularity: an edge
  labels one or more full pages' worth of tokens and owns the matching KV
  page ids in the pool.  Only whole pages are cached or matched.
* Pages are REF-COUNTED in the allocator (``PageAllocator.incref``/
  ``free``): the cache holds one reference on every page it retains, every
  live sequence cloning a cached prefix holds its own, so a cached page is
  shared read-only.
* ``match`` caps the usable prefix at the largest page multiple
  <= len - 1: the final prompt token is always recomputed (sampling needs
  its logits), and its K/V never lands in a shared page.
* ``insert`` runs when a sequence's prefill completes; the tree adopts
  only pages it does not already cover (first writer wins).
* Eviction is LRU over nodes no live sequence shares (every page's only
  reference is the cache's), triggered by ``max_pages`` and by pool
  back-pressure (``PagedKVCache.reclaim_cb`` -> ``evict``).

There is no host or disk tier: an evicted page is gone, exactly as the
reference behaves with its host tier off; the generated tokens are the
same either way.  All methods run on the scheduler thread, between
dispatches.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("lmrs_torch.prefix_cache")


class _Node:
    """One radix-tree edge: ``tokens`` (length a multiple of page_size;
    empty at the root) and the KV pages holding them, one per page_size
    tokens.  ``tick`` is the LRU stamp, bumped on every match/insert walk
    through the node."""

    __slots__ = ("tokens", "pages", "children", "parent", "tick")

    def __init__(self, tokens: tuple, pages: list[int], parent: "_Node | None"):
        self.tokens = tokens
        self.pages = pages
        self.children: dict[tuple, _Node] = {}  # first-page token block -> child
        self.parent = parent
        self.tick = 0


class PrefixCache:
    """Radix tree mapping token-id prefixes to ref-counted KV pages.

    The cache owns one allocator reference per retained page; ``match``
    hands the caller pages with an EXTRA reference (the caller releases
    them through its normal ``close_sequence`` free)."""

    def __init__(self, allocator, page_size: int, max_pages: int = 0):
        self.allocator = allocator
        self.page_size = page_size
        # 0 = no explicit budget: retained pages are bounded by the pool
        # itself (back-pressure eviction via evict())
        self.max_pages = max_pages
        self.root = _Node((), [], None)
        self.cached_pages = 0
        self._tick = 0
        # structural counters only — hit/query/tokens-reused accounting
        # lives in the scheduler (counted once per admission)
        self.evicted_pages = 0
        self.inserted_pages = 0

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def _take(self, child: _Node, ids: list[int], matched: int,
              limit: int) -> int:
        """Tokens of ``child``'s edge that ``ids[matched:]`` repeats, in
        whole pages, without passing ``limit``."""
        ps = self.page_size
        take = 0
        for off in range(0, len(child.tokens), ps):
            if (matched + off + ps > limit
                    or tuple(ids[matched + off: matched + off + ps])
                    != child.tokens[off: off + ps]):
                break
            take += ps
        return take

    # ------------------------------------------------------------- matching

    def match(self, ids: list[int]) -> tuple[list[int], int]:
        """Longest cached prefix of ``ids`` at page granularity.

        Returns ``(pages, n_tokens)`` with one extra allocator reference
        taken on every returned page (the caller owns it).  ``n_tokens`` is
        capped at the largest page multiple <= len(ids) - 1 so the final
        prompt token is always recomputed."""
        ps = self.page_size
        usable = ((len(ids) - 1) // ps) * ps
        pages: list[int] = []
        matched = 0
        node = self.root
        self._touch(node)
        while matched < usable:
            child = node.children.get(tuple(ids[matched: matched + ps]))
            if child is None:
                break
            take = self._take(child, ids, matched, usable)
            if take == 0:
                break
            if take < len(child.tokens):
                # partial edge use: split at the page boundary so the used
                # prefix becomes its own node, and stop — the rest diverges
                child = self._split(child, take)
            pages += child.pages
            matched += take
            node = child
            self._touch(node)
        if matched:
            self.allocator.incref(pages)
        return pages, matched

    def peek(self, ids: list[int]) -> dict:
        """Read-only coverage probe (no reference, no LRU touch): how many
        leading tokens and pages of ``ids`` are cached right now, at full
        page granularity with no ``len - 1`` cap (a capacity view, not an
        admission plan).  Feeds the scheduler's ``prefix_summary``; the
        ``spilled_*`` keys of the reference's probe stay 0, as the port
        keeps no spill tier."""
        ps = self.page_size
        limit = (len(ids) // ps) * ps
        out = {"resident_tokens": 0, "resident_pages": 0,
               "spilled_tokens": 0, "spilled_pages": 0}
        node = self.root
        matched = 0
        while matched < limit:
            child = node.children.get(tuple(ids[matched: matched + ps]))
            if child is None:
                break
            take = self._take(child, ids, matched, limit)
            if take == 0:
                break
            out["resident_tokens"] += take
            out["resident_pages"] += take // ps
            if take < len(child.tokens):
                break
            matched += take
            node = child
        return out

    def _split(self, node: _Node, k: int) -> _Node:
        """Split ``node``'s edge after ``k`` tokens (a page multiple): the
        prefix becomes a new parent node; ``node`` keeps the suffix.
        Returns the new prefix node."""
        ps = self.page_size
        upper = _Node(node.tokens[:k], node.pages[: k // ps], node.parent)
        upper.tick = node.tick
        node.parent.children[node.tokens[:ps]] = upper
        node.tokens = node.tokens[k:]
        node.pages = node.pages[k // ps:]
        node.parent = upper
        upper.children[node.tokens[:ps]] = node
        return upper

    # ------------------------------------------------------------ insertion

    def insert(self, ids: list[int], pages: list[int],
               max_tokens: int | None = None) -> int:
        """Adopt the full-page prefix of ``ids`` (KV in ``pages``, the
        sequence's page table) into the tree; returns the number of pages
        adopted.  Pages the tree already covers are skipped (the caller's
        duplicates are released by its own close).  ``max_tokens`` caps
        adoption to ceil-to-page of that many leading tokens (the request's
        ``cache_prefix`` hint).  Adopted pages gain one allocator reference
        (the cache's); the caller keeps its own."""
        ps = self.page_size
        limit = (len(ids) // ps) * ps
        if max_tokens is not None:
            limit = min(limit, -(-max_tokens // ps) * ps)
        if limit <= 0:
            return 0
        node = self.root
        self._touch(node)
        matched = 0
        while matched < limit:
            child = node.children.get(tuple(ids[matched: matched + ps]))
            if child is None:
                break
            take = self._take(child, ids, matched, limit)
            if take == 0:
                break
            if take < len(child.tokens):
                child = self._split(child, take)
            matched += take
            node = child
            self._touch(node)
        adopt = (limit - matched) // ps
        if adopt <= 0:
            return 0
        if self.max_pages:
            over = self.cached_pages + adopt - self.max_pages
            if over > 0:
                # pin the walk path: evicting the node we are about to
                # attach under would orphan the new leaf
                pin = set()
                cur = node
                while cur is not None:
                    pin.add(id(cur))
                    cur = cur.parent
                self._evict_lru(over, keep=pin)
            # still over budget (live sequences pin nodes): trim adoption
            adopt = min(adopt, max(self.max_pages - self.cached_pages, 0))
            if adopt <= 0:
                return 0
        new_tokens = tuple(ids[matched: matched + adopt * ps])
        new_pages = list(pages[matched // ps: matched // ps + adopt])
        self.allocator.incref(new_pages)
        leaf = _Node(new_tokens, new_pages, node)
        node.children[new_tokens[:ps]] = leaf
        self._touch(leaf)
        self.cached_pages += adopt
        self.inserted_pages += adopt
        return adopt

    # ------------------------------------------------------------- eviction

    def evict(self, n_pages: int) -> int:
        """Free at least ``n_pages`` pages of unshared cache (LRU node
        order), or as many as exist.  Returns pages freed.  Wired into the
        pool's back-pressure path (``PagedKVCache.reclaim_cb``), so a full
        cache never starves admission or decode growth."""
        return self._evict_lru(n_pages)

    def _evict_lru(self, n_pages: int, keep: set | None = None) -> int:
        freed = 0
        while freed < n_pages:
            # victim = LRU node no live sequence shares (every page's only
            # reference is the cache's own) with no descendants; one
            # ancestor-marking pass excludes inner nodes
            nodes: list[_Node] = []
            stack = [self.root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node is not self.root:
                    nodes.append(node)
            blocked: set[int] = set()
            for node in nodes:
                cur = node.parent
                while cur is not None and id(cur) not in blocked:
                    blocked.add(id(cur))
                    cur = cur.parent
            victim = None
            for node in nodes:
                if (id(node) in blocked or (keep and id(node) in keep)
                        or not all(self.allocator.refcount(p) == 1
                                   for p in node.pages)):
                    continue
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                break
            freed += self._drop(victim)
        if freed:
            logger.debug("evicted %d cached pages (%d retained)",
                         freed, self.cached_pages)
        return freed

    def _drop(self, node: _Node) -> int:
        """Remove a leaf and release the cache's references on its pages
        (they return to the free list: no live sequence holds them)."""
        del node.parent.children[node.tokens[: self.page_size]]
        node.parent = None
        n = len(node.pages)
        self.allocator.free(node.pages)
        self.cached_pages -= n
        self.evicted_pages += n
        return n

    def clear(self) -> int:
        """Drop every node no live sequence shares (pool recovery, tests)."""
        return self._evict_lru(self.cached_pages) if self.cached_pages else 0

    # ---------------------------------------------------------------- audit

    def retained_pages(self) -> list[int]:
        """Every page id the tree holds a reference on (one entry per
        retention — duplicates would themselves be a bug ``audit``
        reports)."""
        out: list[int] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            out.extend(node.pages)
        return out

    def audit(self) -> list[str]:
        """Radix-tree structural invariants, one string per violation:
        every non-root node labels ``len(pages) * page_size`` tokens and is
        non-empty; each child is keyed by its first page's token block and
        points back at its parent; no page is retained twice;
        ``cached_pages`` matches the walk; every retained page is live in
        the allocator.  Refcount BALANCE against live sequences is the
        scheduler auditor's job."""
        ps = self.page_size
        violations: list[str] = []
        seen: dict[int, int] = {}
        total = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                if not node.tokens:
                    violations.append("non-root node with empty edge label")
                if len(node.tokens) != len(node.pages) * ps:
                    violations.append(
                        f"node with {len(node.tokens)} tokens holds "
                        f"{len(node.pages)} pages (page_size {ps})")
            for key, child in node.children.items():
                if child.parent is not node:
                    violations.append("child's parent link is stale")
                if tuple(child.tokens[:ps]) != key:
                    violations.append(
                        "child keyed by a block that is not its first page")
                stack.append(child)
            for p in node.pages:
                seen[p] = seen.get(p, 0) + 1
                total += 1
                if self.allocator.refcount(p) < 1:
                    violations.append(f"cache retains freed page {p}")
        for p, n in seen.items():
            if n > 1:
                violations.append(f"page {p} retained {n} times")
        if total != self.cached_pages:
            violations.append(
                f"cached_pages counter {self.cached_pages} != {total} "
                "pages found in the tree")
        return violations

    def stats(self) -> dict:
        """Structural counters (page footprint) for metrics_report()."""
        return {"cached_pages": self.cached_pages,
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages}
