"""Shared-prefix KV cache: radix-tree page reuse over the paged pool, with
the host-RAM and disk spill tiers behind it (the port of the reference's
``engine/prefix_cache.py``).

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
* Eviction is LRU over RESIDENT nodes no live sequence shares (every
  page's only reference is the cache's) and with no resident descendants,
  triggered by ``max_pages`` and by pool back-pressure
  (``PagedKVCache.reclaim_cb`` -> ``evict``).

Host tier (``engine/host_kv.HostKVPool``, with a ``capture_cb``): an
eviction captures the victim's page content into the bounded host pool and
the node stays in the tree as a *spilled* node (``pages == []``, payload on
``spill``).  ``match_hier`` reports the spilled chain extending a resident
match; the scheduler allocates fresh pages and ``prefetch_into`` restores
each segment (``PagedKVCache.import_pages``), promoting the node back to
resident.  ``insert`` promotes spilled nodes its walk passes through (the
inserting sequence just recomputed the same K/V).  Host budget pressure
drops LRU spilled subtrees; an entry larger than the whole budget is not
captured (it drops as with the tier off).  Shared nodes never spill.

Disk tier (``pool.disk``, a ``host_kv.DiskKVPool``): host budget pressure
DEMOTES the LRU host entry to a spill file (the payload becomes a
descriptor); a later match promotes it disk→host→device through the same
``prefetch_into``.  A missing, torn or corrupt file (``DiskReadError``)
drops the entry and the segment re-prefills.  Recency is the node's radix
``tick`` across all three tiers.

The tier's own failures degrade (an entry gone between match and prefetch,
a ``DiskReadError``, a failed spill-file write); a device error in capture
or restore raises.  All methods run on the scheduler thread, between
dispatches.
"""

from __future__ import annotations

import logging
import os
import time

from lmrs_tpu_torch.engine.host_kv import DiskReadError
from lmrs_tpu_torch.testing import faults
from lmrs_tpu_torch.testing.faults import InjectedFault

logger = logging.getLogger("lmrs_torch.prefix_cache")


class _Node:
    """One radix-tree edge: ``tokens`` (length a multiple of page_size;
    empty at the root) and the KV pages holding them, one per page_size
    tokens.  ``tick`` is the LRU stamp, bumped on every match/insert walk
    through the node.  ``spill`` is the payload of a SPILLED node (pages
    freed, content captured): exactly one of ``pages`` / ``spill`` is
    populated on a non-root node."""

    __slots__ = ("tokens", "pages", "children", "parent", "tick", "spill")

    def __init__(self, tokens: tuple, pages: list[int], parent: "_Node | None"):
        self.tokens = tokens
        self.pages = pages
        self.children: dict[tuple, _Node] = {}  # first-page token block -> child
        self.parent = parent
        self.tick = 0
        self.spill: dict | None = None


def _payload_bytes(payload: dict) -> int:
    if payload.get("disk"):
        return int(payload["nbytes"])
    return int(payload["k"].nbytes) + int(payload["v"].nbytes)


def _spill_pages(payload: dict) -> int:
    """Payload pages of a spill entry, either tier (k is [L, n, K, ps,
    hd]; a disk descriptor records the shape)."""
    if payload.get("disk"):
        return int(payload["k_shape"][1])
    return int(payload["k"].shape[1])


def _halve(pay: dict, kp: int) -> tuple[dict, dict]:
    """A host payload cut after ``kp`` pages (copies)."""
    return tuple({"k": pay["k"][:, sl].copy(), "v": pay["v"][:, sl].copy(),
                  "dtype": pay.get("dtype")}
                 for sl in (slice(None, kp), slice(kp, None)))


class PrefixCache:
    """Radix tree mapping token-id prefixes to ref-counted KV pages.

    The cache owns one allocator reference per retained page; ``match``
    hands the caller pages with an EXTRA reference (the caller releases
    them through its normal ``close_sequence`` free).

    ``spill_pool``/``capture_cb``/``page_bytes`` arm the spill tiers
    (module doc); ``metrics`` is an optional dict of counters the spill
    paths feed (``spill_pages``, ``spill_dropped``, ``spill_capture_s``,
    ``disk_demoted``, ``disk_promoted``, ``disk_dropped``,
    ``disk_read_fail``: each an object with ``inc``/``observe``), absent
    keys skipped."""

    def __init__(self, allocator, page_size: int, max_pages: int = 0,
                 spill_pool=None, capture_cb=None, page_bytes: int = 0,
                 metrics: dict | None = None):
        self.allocator = allocator
        self.page_size = page_size
        # 0 = no explicit budget: retained pages are bounded by the pool
        # itself (back-pressure eviction via evict())
        self.max_pages = max_pages
        self.pool = spill_pool
        self.capture_cb = capture_cb
        self.page_bytes = page_bytes  # per-page payload size (fits())
        self.metrics = metrics or {}
        self.root = _Node((), [], None)
        self.cached_pages = 0
        self._tick = 0
        # structural counters only — hit/query/tokens-reused accounting
        # lives in the scheduler (counted once per admission)
        self.evicted_pages = 0
        self.inserted_pages = 0

    @property
    def disk(self):
        """The disk tier under the host pool, or None."""
        return None if self.pool is None else getattr(self.pool, "disk", None)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    def _metric(self, name: str, op: str, *args) -> None:
        inst = self.metrics.get(name)
        if inst is not None:
            getattr(inst, op)(*args)

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
        """Longest RESIDENT cached prefix of ``ids`` at page granularity.

        Returns ``(pages, n_tokens)`` with one extra allocator reference
        taken on every returned page (the caller owns it).  ``n_tokens`` is
        capped at the largest page multiple <= len(ids) - 1 so the final
        prompt token is always recomputed.  The walk stops at a spilled
        node (``match_hier`` is the spill-aware probe)."""
        pages, matched, _chain = self.match_hier(ids, with_spill=False)
        return pages, matched

    def match_hier(self, ids: list[int], with_spill: bool = True
                   ) -> tuple[list[int], int, list[tuple[_Node, int]]]:
        """Spill-aware probe: the resident prefix (pages with a reference
        taken, as ``match``) plus the chain of consecutive WHOLE spilled
        nodes extending it, ``[(node, n_tokens), ...]`` in positional
        order.  No reference is held on a spilled entry, so dropping the
        chain costs nothing.  The same usable-prefix cap applies across
        both tiers."""
        ps = self.page_size
        usable = ((len(ids) - 1) // ps) * ps
        pages: list[int] = []
        matched = 0
        node = self.root
        self._touch(node)
        while matched < usable:
            child = node.children.get(tuple(ids[matched: matched + ps]))
            if child is None or child.spill is not None:
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
        chain: list[tuple[_Node, int]] = []
        if with_spill and self.pool is not None:
            # whole spilled nodes only; promotions run top-down, so the
            # walk shape is [resident*][spilled*]
            pos = matched
            while pos < usable:
                child = node.children.get(tuple(ids[pos: pos + ps]))
                if (child is None or child.spill is None
                        or pos + len(child.tokens) > usable
                        or tuple(ids[pos: pos + len(child.tokens)])
                        != child.tokens):
                    break
                chain.append((child, len(child.tokens)))
                pos += len(child.tokens)
                node = child
                self._touch(node)
        return pages, matched, chain

    def peek(self, ids: list[int]) -> dict:
        """Read-only coverage probe (no reference, no LRU touch): how many
        leading tokens and pages of ``ids`` are resident and spilled right
        now, at full page granularity with no ``len - 1`` cap (a capacity
        view, not an admission plan).  Feeds ``prefix_summary``."""
        ps = self.page_size
        limit = (len(ids) // ps) * ps
        out = {"resident_tokens": 0, "resident_pages": 0,
               "spilled_tokens": 0, "spilled_pages": 0}
        node = self.root
        matched = 0
        in_spill = False
        while matched < limit:
            child = node.children.get(tuple(ids[matched: matched + ps]))
            if child is None:
                break
            take = self._take(child, ids, matched, limit)
            if take == 0:
                break
            in_spill = in_spill or child.spill is not None
            kind = "spilled" if in_spill else "resident"
            out[f"{kind}_tokens"] += take
            out[f"{kind}_pages"] += take // ps
            if take < len(child.tokens):
                break
            matched += take
            node = child
        return out

    def _split(self, node: _Node, k: int) -> _Node | None:
        """Split ``node``'s edge after ``k`` tokens (a page multiple): the
        prefix becomes a new parent node; ``node`` keeps the suffix.
        Returns the new prefix node.  A spilled node splits its payload
        too; a disk node reads its file back, and on a ``DiskReadError``
        or a failed re-write the entry drops and the split returns None
        (the caller treats it as a missing child)."""
        ps = self.page_size
        kp = k // ps
        upper = _Node(node.tokens[:k], node.pages[:kp], node.parent)
        upper.tick = node.tick
        if node.spill is not None and node.spill.get("disk"):
            disk = self.disk
            try:
                halves = _halve(self._disk_read(node.spill), kp)
            except DiskReadError:
                logger.warning("disk spill read failed during split; "
                               "dropping entry", exc_info=True)
                self._drop_subtree(node)
                return None
            descs: list[dict] = []
            try:
                for half in halves:
                    descs.append(disk.write(half))
            except OSError:
                logger.warning("disk spill write failed during split; "
                               "dropping entry", exc_info=True)
                for desc in descs:
                    disk.free(desc)
                self._drop_subtree(node)
                return None
            disk.remove(node)
            disk.free(node.spill)
            upper.spill, node.spill = descs
            # a split is not a new demotion: re-register the bytes only
            disk.add(upper, descs[0]["nbytes"], 0)
            disk.add(node, descs[1]["nbytes"], 0)
        elif node.spill is not None:
            self.pool.remove(node)
            upper.spill, node.spill = _halve(node.spill, kp)
            # a split is not a new spill: re-register the bytes only
            self.pool.add(upper, _payload_bytes(upper.spill), 0)
            self.pool.add(node, _payload_bytes(node.spill), 0)
        node.parent.children[node.tokens[:ps]] = upper
        node.tokens = node.tokens[k:]
        node.pages = node.pages[kp:]
        node.parent = upper
        upper.children[node.tokens[:ps]] = node
        return upper

    # ------------------------------------------------------------ insertion

    def insert(self, ids: list[int], pages: list[int],
               max_tokens: int | None = None) -> int:
        """Adopt the full-page prefix of ``ids`` (KV in ``pages``, the
        sequence's page table) into the tree; returns the number of pages
        adopted or promoted.  Pages the tree already covers are skipped
        (the caller's duplicates are released by its own close).
        ``max_tokens`` caps adoption to ceil-to-page of that many leading
        tokens (the request's ``cache_prefix`` hint).  Adopted pages gain
        one allocator reference (the cache's); the caller keeps its own.
        Spilled nodes the walk passes through are PROMOTED back to resident
        on the caller's pages (identical content, freshly computed)."""
        # injection site: fires before any tree or refcount mutation, so a
        # fault leaves the cache as it was (the scheduler treats it as a
        # lost optimization)
        faults.fire("prefix_cache.insert")
        ps = self.page_size
        limit = (len(ids) // ps) * ps
        if max_tokens is not None:
            limit = min(limit, -(-max_tokens // ps) * ps)
        if limit <= 0:
            return 0
        node = self.root
        self._touch(node)
        matched = 0
        promoted = 0
        while matched < limit:
            child = node.children.get(tuple(ids[matched: matched + ps]))
            if child is None:
                break
            take = self._take(child, ids, matched, limit)
            if take == 0:
                break
            if take < len(child.tokens):
                child = self._split(child, take)
                if child is None:
                    # a disk split degraded to an entry drop: the
                    # remainder adopts as a fresh leaf below
                    break
            if child.spill is not None:
                promoted += self._promote(
                    child, pages[matched // ps: (matched + take) // ps])
            matched += take
            node = child
            self._touch(node)
        adopt = (limit - matched) // ps
        if adopt <= 0:
            return promoted
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
                return promoted
        new_tokens = tuple(ids[matched: matched + adopt * ps])
        new_pages = list(pages[matched // ps: matched // ps + adopt])
        self.allocator.incref(new_pages)
        leaf = _Node(new_tokens, new_pages, node)
        node.children[new_tokens[:ps]] = leaf
        self._touch(leaf)
        self.cached_pages += adopt
        self.inserted_pages += adopt
        return adopt + promoted

    def _promote(self, node: _Node, dest_pages: list[int]) -> int:
        """Flip a spilled node back to resident on ``dest_pages`` (the
        cache takes its own reference; the caller keeps its own); the
        payload leaves its tier (a disk entry deletes its file)."""
        n = len(dest_pages)
        assert n == len(node.tokens) // self.page_size
        desc = node.spill
        self.allocator.incref(list(dest_pages))
        node.pages = list(dest_pages)
        node.spill = None
        if desc is not None and desc.get("disk"):
            self.disk.free(desc)
            self.disk.remove(node)
        else:
            self.pool.remove(node)
        self.cached_pages += n
        self.inserted_pages += n
        return n

    # ------------------------------------------------------------- prefetch

    def _disk_read(self, desc: dict) -> dict:
        """Read a disk descriptor back into a host payload, counting a
        ``DiskReadError`` before it propagates.  The ``kv.disk_read``
        injection site raises a ``DiskReadError`` there, so every caller's
        degrade path takes it."""
        try:
            faults.fire("kv.disk_read", DiskReadError)
            return self.disk.read(desc)
        except DiskReadError:
            self.disk.read_failures_total += 1
            self._metric("disk_read_fail", "inc")
            raise

    def prefetch_into(self, node: _Node, dest_pages: list[int],
                      kv_cache, sync: bool = False) -> int:
        """Restore a spilled node's payload into freshly allocated device
        pages (``PagedKVCache.import_pages``, asynchronous unless ``sync``)
        and promote the node to resident on them.  A disk entry reads its
        file back first; a ``DiskReadError`` drops the entry and raises.
        An entry dropped since the match raises ``LookupError``.  Either
        way the caller re-prefills the segment."""
        payload = node.spill
        if payload is None:
            raise LookupError("spilled entry dropped before prefetch")
        was_disk = bool(payload.get("disk"))
        if was_disk:
            try:
                payload = self._disk_read(payload)
            except DiskReadError:
                # a corrupt file would fail every later match too: drop the
                # entry so the tree stops advertising it
                self._drop_subtree(node)
                raise
        kv_cache.import_pages(dest_pages, payload, sync=sync)
        n = self._promote(node, dest_pages)
        # promotion by prefetch is a tier hit, not an insert
        self.inserted_pages -= n
        if was_disk:
            self.disk.note_promote(n)
            self._metric("disk_promoted", "inc", n)
        else:
            self.pool.note_prefetch(n)
        self._touch(node)
        return n

    def spill_payload(self, node: _Node) -> dict | None:
        """In-memory payload of a spilled node, either tier, WITHOUT
        promoting it (``kv_export`` reads warm state and leaves this cache
        untouched).  A ``DiskReadError`` drops the entry and returns None:
        the export covers fewer tokens."""
        payload = node.spill
        if payload is None:
            return None
        if payload.get("disk"):
            try:
                return self._disk_read(payload)
            except DiskReadError:
                logger.warning("disk spill read failed during export; "
                               "dropping entry", exc_info=True)
                self._drop_subtree(node)
                return None
        return payload

    # ------------------------------------------------------------- eviction

    def evict(self, n_pages: int) -> int:
        """Free at least ``n_pages`` DEVICE pages of unshared cache (LRU
        node order), or as many as exist.  Returns pages freed.  Wired into
        the pool's back-pressure path (``PagedKVCache.reclaim_cb``), so a
        full cache never starves admission or decode growth.  With the
        host tier armed the content spills instead of vanishing."""
        return self._evict_lru(n_pages)

    def _evict_lru(self, n_pages: int, keep: set | None = None,
                   spill: bool = True) -> int:
        freed = 0
        while freed < n_pages:
            # victim = LRU RESIDENT node no live sequence shares (every
            # page's only reference is the cache's) with no resident
            # descendants (spilled descendants ride along); one
            # ancestor-marking pass excludes inner nodes
            resident: list[_Node] = []
            stack = [self.root]
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node is not self.root and node.pages:
                    resident.append(node)
            blocked: set[int] = set()
            for node in resident:
                cur = node.parent
                while cur is not None and id(cur) not in blocked:
                    blocked.add(id(cur))
                    cur = cur.parent
            victim = None
            for node in resident:
                if (id(node) in blocked or (keep and id(node) in keep)
                        or not all(self.allocator.refcount(p) == 1
                                   for p in node.pages)):
                    continue
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                break
            freed += self._drop(victim, keep=keep, spill=spill)
        if freed:
            logger.debug("evicted %d cached pages (%d retained)",
                         freed, self.cached_pages)
        return freed

    def _drop(self, node: _Node, keep: set | None = None,
              spill: bool = True) -> int:
        """Release a victim's DEVICE pages.  With the host tier armed (and
        ``spill``) the content is captured first and the node stays as a
        spilled node; otherwise (tier off, or an entry over the whole host
        budget) the node and its spilled descendants drop."""
        n = len(node.pages)
        if (spill and n and self.pool is not None
                and self.capture_cb is not None
                and self.pool.fits(n * self.page_bytes)):
            try:
                # injection site: the spill capture fails before any
                # gather; the victim's pages free uncached (evict means
                # gone), as with the tier off
                faults.fire("prefix.spill")
            except InjectedFault:
                logger.warning("KV spill capture failed; pages free "
                               "uncached", exc_info=True)
                return self._drop_subtree(node)
            t0 = time.time()
            payload = self.capture_cb(node.pages)
            self._metric("spill_capture_s", "observe", time.time() - t0)
            self.allocator.free(node.pages)
            node.pages = []
            node.spill = payload
            self.cached_pages -= n
            self.evicted_pages += n
            self.pool.add(node, _payload_bytes(payload), n)
            self._metric("spill_pages", "inc", n)
            self._enforce_host_budget(keep)
            return n
        return self._drop_subtree(node)

    def _drop_subtree(self, node: _Node) -> int:
        """Remove ``node`` and everything under it: release the cache's
        device-page references and drop spilled descendants' entries (disk
        entries delete their files).  Returns DEVICE pages freed."""
        ps = self.page_size
        if node.parent is not None:
            del node.parent.children[node.tokens[:ps]]
        freed = 0
        stack = [node]
        while stack:
            cur = stack.pop()
            stack.extend(cur.children.values())
            if cur.pages:
                self.allocator.free(cur.pages)
                freed += len(cur.pages)
                self.cached_pages -= len(cur.pages)
                self.evicted_pages += len(cur.pages)
            if cur.spill is not None:
                npg = len(cur.tokens) // ps
                if cur.spill.get("disk"):
                    if self.disk is not None:
                        self.disk.free(cur.spill)
                        self.disk.remove(cur, n_pages=npg, dropped=True)
                        self._metric("disk_dropped", "inc", npg)
                elif self.pool is not None:
                    self.pool.remove(cur, n_pages=npg, dropped=True)
                    self._metric("spill_dropped", "inc", npg)
                cur.spill = None
            cur.children = {}
            cur.parent = None
        return freed

    def _enforce_host_budget(self, keep: set | None = None) -> None:
        """Re-fit the spill tiers to their budgets: host pressure demotes
        the LRU host entry to disk (tier armed, entry fits, write works)
        or drops its subtree; disk pressure drops LRU disk subtrees.
        ``keep`` pins the current walk chain (one root path, so a victim
        outside it never contains a kept node)."""
        if self.pool is None:
            return
        disk = self.disk
        while self.pool.over_budget():
            victim = self.pool.victim(keep=keep)
            if victim is None:
                break
            if (disk is not None
                    and disk.fits(_payload_bytes(victim.spill))
                    and self._demote(victim)):
                continue
            self._drop_subtree(victim)
        if disk is not None:
            while disk.over_budget():
                victim = disk.victim(keep=keep)
                if victim is None:
                    break
                self._drop_subtree(victim)

    def _demote(self, node: _Node) -> bool:
        """Move one host entry down to the disk tier; False on a failed
        spill-file write (the caller drops the subtree instead)."""
        disk = self.disk
        try:
            desc = disk.write(node.spill)
        except OSError:
            logger.warning("disk spill write failed; entry drops from the "
                           "host tier", exc_info=True)
            return False
        npg = len(node.tokens) // self.page_size
        self.pool.remove(node)  # a demotion, not a drop: pages move tiers
        node.spill = desc
        disk.add(node, desc["nbytes"], npg)
        self._metric("disk_demoted", "inc", npg)
        return True

    def clear(self) -> int:
        """Drop every node no live sequence shares, across every tier
        (pool recovery, tests): resident nodes free their pages without
        spilling, every spilled entry drops (disk files deleted)."""
        freed = (self._evict_lru(self.cached_pages, spill=False)
                 if self.cached_pages else 0)
        for pool in (self.pool, self.disk):
            if pool is None:
                continue
            for node, _nbytes in list(pool.entries.values()):
                if id(node) in pool.entries:  # a sibling drop may race
                    self._drop_subtree(node)
        return freed

    # ---------------------------------------------------------------- audit

    def retained_pages(self) -> list[int]:
        """Every DEVICE page id the tree holds a reference on (one entry per
        retention — duplicates would themselves be a bug ``audit``
        reports).  Spilled nodes hold no device pages."""
        out: list[int] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            out.extend(node.pages)
        return out

    def audit(self) -> list[str]:
        """Radix-tree structural invariants, one string per violation:
        every non-root node is exactly one of resident/spilled and
        non-empty; a resident node labels ``len(pages) * page_size`` tokens
        and a spilled node's payload covers its label; each child is keyed
        by its first page's token block and points back at its parent; no
        page is retained twice; ``cached_pages`` matches the walk; every
        retained page is live in the allocator; each pool's entries are
        exactly the tree's nodes of its tier, with bytes that add up, and
        every disk entry's file exists.  Refcount BALANCE against live
        sequences is the scheduler auditor's job."""
        ps = self.page_size
        violations: list[str] = []
        seen: dict[int, int] = {}
        total = 0
        spilled_nodes: list[_Node] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                if node.pages and node.spill is not None:
                    violations.append("node retained by BOTH tiers (device "
                                      "pages and a host-pool payload)")
                if not node.pages and node.spill is None:
                    violations.append("non-root node with neither pages nor "
                                      "spill payload")
                if node.pages and len(node.tokens) != len(node.pages) * ps:
                    violations.append(
                        f"node with {len(node.tokens)} tokens holds "
                        f"{len(node.pages)} pages (page_size {ps})")
                if node.spill is not None:
                    spilled_nodes.append(node)
                    if _spill_pages(node.spill) * ps != len(node.tokens):
                        violations.append(
                            f"spilled node with {len(node.tokens)} tokens "
                            f"carries {_spill_pages(node.spill)} payload "
                            "pages")
                if not node.tokens:
                    violations.append("non-root node with empty edge label")
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
        host_nodes = [n for n in spilled_nodes if not n.spill.get("disk")]
        disk_nodes = [n for n in spilled_nodes if n.spill.get("disk")]
        if self.pool is not None:
            tree_ids = {id(n) for n in host_nodes}
            pool_ids = set(self.pool.entries)
            if tree_ids != pool_ids:
                violations.append(
                    f"host-pool entries ({len(pool_ids)}) and spilled tree "
                    f"nodes ({len(tree_ids)}) diverge")
            used = sum(nbytes for _n, nbytes in self.pool.entries.values())
            if used != self.pool.used_bytes:
                violations.append(
                    f"host pool used_bytes {self.pool.used_bytes} != "
                    f"{used} summed over entries")
        elif spilled_nodes:
            violations.append("spilled nodes exist with no host pool "
                              "attached")
        disk = self.disk
        if disk is not None:
            tree_ids = {id(n) for n in disk_nodes}
            pool_ids = set(disk.entries)
            if tree_ids != pool_ids:
                violations.append(
                    f"disk-pool entries ({len(pool_ids)}) and disk-tier "
                    f"tree nodes ({len(tree_ids)}) diverge")
            used = sum(nbytes for _n, nbytes in disk.entries.values())
            if used != disk.used_bytes:
                violations.append(
                    f"disk pool used_bytes {disk.used_bytes} != "
                    f"{used} summed over entries")
            for n in disk_nodes:
                ent = disk.entries.get(id(n))
                if ent is not None and ent[1] != _payload_bytes(n.spill):
                    violations.append(
                        "disk entry bytes diverge from its descriptor")
                if not os.path.isfile(n.spill["path"]):
                    violations.append(
                        f"disk spill file missing: {n.spill['path']}")
        elif disk_nodes:
            violations.append("disk-tier nodes exist with no disk pool "
                              "attached")
        return violations

    # -------------------------------------------------------------- reports

    def spilled_pages(self) -> int:
        """Pages currently held by the host tier."""
        if self.pool is None:
            return 0
        return sum(len(node.tokens) // self.page_size
                   for node, _nbytes in self.pool.entries.values())

    def disk_pages(self) -> int:
        """Pages currently held by the disk tier."""
        if self.disk is None:
            return 0
        return sum(len(node.tokens) // self.page_size
                   for node, _nbytes in self.disk.entries.values())

    def stats(self) -> dict:
        """Structural counters (page footprint) for ``metrics_report``."""
        out = {"cached_pages": self.cached_pages,
               "inserted_pages": self.inserted_pages,
               "evicted_pages": self.evicted_pages}
        if self.pool is not None:
            out["spilled_pages"] = self.spilled_pages()
            out.update(self.pool.stats())
            if self.disk is not None:
                out["disk_pages"] = self.disk_pages()
        return out
