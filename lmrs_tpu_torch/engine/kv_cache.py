"""Paged KV cache: a page pool on the device + a host-side page allocator
(the port of the reference's ``engine/kv_cache.py``: pool, ref-counted
allocator, page growth and the prefix cache's reclaim hook — export/import
of page sets is a later slice).

Pool layout [n_layers * num_pages, K, page_size, hd], PAGE-major with the
layer axis flattened into the page axis: layer ``li``'s copy of logical page
``p`` is physical page ``li * num_pages + p``.  Page 0 is the null page:
never handed out, so an inactive row's all-zero page table points at memory
no sequence owns.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from lmrs_tpu_torch.config import ModelConfig

logger = logging.getLogger("lmrs_torch.kv_cache")


class OutOfPages(RuntimeError):
    """Page pool exhausted — callers treat this as back-pressure."""


class PageAllocator:
    """Ref-counted free-list page allocator; page 0 is reserved.  Freeing a
    page that is already free raises instead of corrupting the pool."""

    RESERVED = 1  # page 0

    def __init__(self, num_pages: int):
        if num_pages <= self.RESERVED:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, self.RESERVED - 1, -1))
        self._refs = [0] * num_pages

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def _check(self, pages: list[int], op: str) -> None:
        """Validate a free/incref batch BEFORE any mutation: range-check
        every id, and require each page's refcount to cover its
        multiplicity in the call — a rejected call leaves the pool
        untouched."""
        need: dict[int, int] = {}
        for p in pages:
            if not self.RESERVED <= p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            need[p] = need.get(p, 0) + 1
        for p, n in need.items():
            if self._refs[p] < n:
                raise ValueError(
                    f"{op} of page {p} with refcount {self._refs[p]} "
                    f"(x{n} in call): double-free / unowned page")

    def incref(self, pages: list[int]) -> None:
        """Add one reference per listed page (prefix-cache sharing).  Only
        live (refcount > 0) pages may gain holders."""
        self._check(pages, "incref")
        for p in pages:
            self._refs[p] += 1

    def refcount(self, page: int) -> int:
        if not 0 <= page < self.num_pages:
            raise ValueError(f"bad page id {page}")
        return self._refs[page]

    def free(self, pages: list[int]) -> None:
        """Release one reference per listed page; pages reaching refcount 0
        return to the free list.  Raises on double-free (see ``_check``)."""
        self._check(pages, "free")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)


@dataclass
class SequencePages:
    """Page table of one active sequence."""

    pages: list[int]

    def capacity(self, page_size: int) -> int:
        return len(self.pages) * page_size


class PagedKVCache:
    """Device page pool + host page tables."""

    def __init__(self, model_cfg: ModelConfig, num_pages: int, page_size: int,
                 max_pages_per_slot: int, device, dtype: torch.dtype):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_slot = max_pages_per_slot
        shape = (model_cfg.n_layers * num_pages, model_cfg.n_kv_heads,
                 page_size, model_cfg.hd)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.allocator = PageAllocator(num_pages)
        # page-pressure reclaim hook (engine/prefix_cache.py): an allocation
        # that would exceed the free list first asks it to release
        # reclaimable pages (LRU cache eviction), so cached pages never
        # starve admission or growth
        self.reclaim_cb = None
        logger.info("paged KV cache: %d pages x %d tokens (%.1f MiB)",
                    num_pages, page_size,
                    2 * self.k.numel() * self.k.element_size() / 2**20)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc_pages(self, n: int) -> list[int]:
        """``allocator.alloc`` with the reclaim hook applied: under pressure,
        ask the prefix cache to evict before declaring OutOfPages."""
        if n > self.allocator.free_count and self.reclaim_cb is not None:
            self.reclaim_cb(n - self.allocator.free_count)
        return self.allocator.alloc(n)

    def grow(self, seq: SequencePages, n_tokens: int) -> None:
        """Ensure capacity for n_tokens, allocating more pages as needed."""
        need = self.pages_needed(n_tokens) - len(seq.pages)
        if need > 0:
            if len(seq.pages) + need > self.max_pages_per_slot:
                raise OutOfPages("sequence exceeds max_pages_per_slot")
            seq.pages.extend(self.alloc_pages(need))

    def close_sequence(self, seq: SequencePages) -> None:
        self.allocator.free(seq.pages)
        seq.pages = []

    def page_table_array(self, seqs: list[SequencePages | None]) -> np.ndarray:
        """[B, max_pages_per_slot] int32 table; unused entries point at the
        null page 0 (masked by per-row lengths)."""
        out = np.zeros((len(seqs), self.max_pages_per_slot), np.int32)
        for i, s in enumerate(seqs):
            if s is not None:
                out[i, : len(s.pages)] = s.pages
        return out


def audit_allocator(allocator, num_pages: int,
                    holders: dict[int, int]) -> list[str]:
    """Page-pool invariant audit: every non-reserved page is free or held,
    each page's refcount equals the caller's accounted holders, and the null
    page is never held.  One string per violation (empty = clean)."""
    violations: list[str] = []
    reserved = getattr(type(allocator), "RESERVED", 1)
    held = 0
    for p in range(reserved, num_pages):
        rc = allocator.refcount(p)
        if rc < 0:
            violations.append(f"page {p}: negative refcount {rc}")
            continue
        if rc > 0:
            held += 1
        expected = holders.get(p, 0)
        if rc != expected:
            kind = "leaked" if expected == 0 else "unbalanced"
            violations.append(f"page {p}: refcount {rc} but {expected} "
                              f"accounted holder(s) ({kind})")
    if allocator.free_count + held != num_pages - reserved:
        violations.append(f"page conservation broken: {allocator.free_count} "
                          f"free + {held} held != {num_pages - reserved} usable")
    for p in holders:
        if not reserved <= p < num_pages:
            violations.append(f"holder references out-of-range page {p}")
    if allocator.refcount(0) != 0:
        violations.append("reserved null page has a nonzero refcount")
    return violations
