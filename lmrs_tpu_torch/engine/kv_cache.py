"""Paged KV cache: a page pool on the device + a host-side page allocator
(the port of the reference's ``engine/kv_cache.py``: pool, ref-counted
allocator, page growth, the prefix cache's reclaim hook, and the page-set
moves of the spill tiers and the disaggregated handoff).  The allocator is
the native runtime's (``runtime/native``) unless ``LMRS_NATIVE=0``.

Pool layout [n_layers * num_pages, K, page_size, hd], PAGE-major with the
layer axis flattened into the page axis: layer ``li``'s copy of logical page
``p`` is physical page ``li * num_pages + p``.  Page 0 is the null page:
never handed out, so an inactive row's all-zero page table points at memory
no sequence owns.

Page-set moves (``export_pages``/``export_sequence`` out, ``import_pages``/
``import_sequence`` in) carry numpy payloads ``k``/``v`` of shape [L, n, K,
ps, hd] and the wire dtype name (``"bfloat16"``, ``"int8"``, ``"float32"``;
bf16 as raw words, ``engine/host_kv.BF16``).  On the card an export is one
``index_select`` over the flattened pool per tensor into a pinned host
buffer, then a sync (the host needs the bytes); an import is one
``non_blocking`` H2D copy from pinned memory on the current stream, then
``index_copy_`` into the pool, with the host arrays kept alive until an
event recorded after the copy has passed.
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from lmrs_tpu_torch.testing import faults

from lmrs_tpu_torch.config import ModelConfig
from lmrs_tpu_torch.engine.host_kv import as_dtype, dtype_name
from lmrs_tpu_torch.runtime import native

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


def make_page_allocator(num_pages: int):
    """The C++ allocator (``runtime/native``), or ``PageAllocator`` under
    ``LMRS_NATIVE=0``.  Both keep the same contract and hand out the same
    pages in the same order; a native build that fails raises."""
    if native.enabled():
        return native.NativePageAllocator(num_pages)
    return PageAllocator(num_pages)


@dataclass
class SequencePages:
    """Page table of one active sequence."""

    pages: list[int]
    length: int = 0  # tokens written (an imported sequence's kv_len)

    def capacity(self, page_size: int) -> int:
        return len(self.pages) * page_size


class PagedKVCache:
    """Device page pool + host page tables."""

    def __init__(self, model_cfg: ModelConfig, num_pages: int, page_size: int,
                 max_pages_per_slot: int, device, dtype: torch.dtype,
                 allocator=None):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_slot = max_pages_per_slot
        shape = (model_cfg.n_layers * num_pages, model_cfg.n_kv_heads,
                 page_size, model_cfg.hd)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.allocator = allocator or make_page_allocator(num_pages)
        # page-pressure reclaim hook (engine/prefix_cache.py): an allocation
        # that would exceed the free list first asks it to release
        # reclaimable pages (LRU cache eviction), so cached pages never
        # starve admission or growth
        self.reclaim_cb = None
        # imports in flight: (event, host arrays) kept alive until the
        # event recorded after their H2D copy has passed
        self._h2d_inflight: list[tuple] = []
        logger.info("paged KV cache: %d pages x %d tokens (%.1f MiB)",
                    num_pages, page_size,
                    2 * self.k.numel() * self.k.element_size() / 2**20)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc_pages(self, n: int) -> list[int]:
        """``allocator.alloc`` with the reclaim hook applied: under pressure,
        ask the prefix cache to evict before declaring OutOfPages."""
        # injection site: a fired plan forces the back-pressure path even
        # with free pages on hand (every caller treats OutOfPages as
        # pressure, not error)
        faults.fire("kv_cache.allocate", OutOfPages)
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
        seq.length = 0

    def page_table_array(self, seqs: list[SequencePages | None]) -> np.ndarray:
        """[B, max_pages_per_slot] int32 table; unused entries point at the
        null page 0 (masked by per-row lengths)."""
        out = np.zeros((len(seqs), self.max_pages_per_slot), np.int32)
        for i, s in enumerate(seqs):
            if s is not None:
                out[i, : len(s.pages)] = s.pages
        return out


    # -------------------------------------------- page-set export / import

    @property
    def n_layers(self) -> int:
        return self.k.shape[0] // self.num_pages

    @property
    def wire_dtype(self) -> str:
        """The pool's dtype as the payloads name it (the reference's
        names: ``"bfloat16"``, ``"int8"``, ``"float32"``)."""
        return str(self.k.dtype).removeprefix("torch.")

    def _phys_ids(self, pages: list[int]) -> np.ndarray:
        """Physical page ids of a logical page set, all layers: layer li's
        copy of logical page p is physical page ``li * P + p``."""
        pg = np.asarray(pages, np.int64)
        return (np.arange(self.n_layers)[:, None] * self.num_pages
                + pg[None, :]).reshape(-1)

    def _gather(self, pages: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of a page set's K and V, [L, n, K, ps, hd] each: one
        ``index_select`` per pool; on the card into pinned buffers with
        ``non_blocking`` copies, then one sync of the current stream."""
        phys = torch.from_numpy(self._phys_ids(pages)).to(self.k.device)
        shape = (self.n_layers, len(pages)) + tuple(self.k.shape[1:])
        out = []
        for pool in (self.k, self.v):
            rows = pool.index_select(0, phys)
            if pool.is_cuda:
                host = torch.empty(shape, dtype=pool.dtype, pin_memory=True)
                host.view(rows.shape).copy_(rows, non_blocking=True)
                out.append(host)
            else:
                out.append(rows.reshape(shape))
        if self.k.is_cuda:
            torch.cuda.current_stream(self.k.device).synchronize()
        return tuple(_to_numpy(t, self.wire_dtype) for t in out)

    def _scatter(self, pages: list[int], k: np.ndarray, v: np.ndarray,
                 sync: bool) -> None:
        """Write [L, n, K, ps, hd] host arrays into a page set: on the card
        one ``non_blocking`` H2D copy per pool from pinned memory on the
        current stream (the stream every dispatch runs on, so the pages
        land before any later read), then ``index_copy_``."""
        phys = torch.from_numpy(self._phys_ids(pages)).to(self.k.device)
        flat = (len(phys),) + tuple(self.k.shape[1:])
        keep = []
        for pool, a in ((self.k, k), (self.v, v)):
            src = _from_numpy(a, pool.dtype).reshape(flat)
            if pool.is_cuda:
                if not src.is_pinned():
                    src = src.pin_memory()
                keep.append(src)
                src = src.to(pool.device, non_blocking=True)
            pool.index_copy_(0, phys, src)
        if self.k.is_cuda:
            # the host arrays stay referenced until the copies have landed
            done = self._h2d_inflight
            while done and done[0][0].query():
                done.pop(0)
            ev = torch.cuda.Event()
            ev.record()
            done.append((ev, k, v, keep))
            if sync:
                ev.synchronize()
                done.clear()

    def export_sequence(self, seq: SequencePages, length: int) -> dict:
        """A sequence's page set as a host payload — the transferable unit
        of the disaggregated prefill→decode handoff (``serving/handoff.py``
        carries it over the wire).  Only the pages covering ``length``
        tokens travel; the last may be partial (``kv_len`` masks its
        tail).  bf16 and int8 pools alike (int8's per-slot scales are the
        scheduler's and ride the payload separately).  The sequence is
        untouched: the caller keeps its pages pinned until the ack."""
        # injection site: the pin-time capture fails (the scheduler turns
        # it into a marked per-request error)
        faults.fire("handoff.export")
        n = self.pages_needed(max(1, length))
        if n > len(seq.pages):
            raise ValueError(
                f"export of {length} tokens needs {n} pages; sequence "
                f"holds {len(seq.pages)}")
        k, v = self._gather(seq.pages[:n])
        kh, _ps, hd = self.k.shape[1:]
        return {
            "version": 1,
            "kv_len": int(length),
            "n_pages": n,
            "page_size": self.page_size,
            "n_layers": self.n_layers,
            "n_kv_heads": int(kh),
            "head_dim": int(hd),
            "dtype": self.wire_dtype,
            "k": k,
            "v": v,
        }

    def export_pages(self, pages: list[int]) -> dict:
        """Host capture of a page set's contents, all layers — the spill
        tier's device→host path (``engine/prefix_cache.py``); the radix
        node carries the token labels, so the payload is page content and
        dtype only."""
        k, v = self._gather(pages)
        return {"k": k, "v": v, "dtype": self.wire_dtype}

    def _check_pages(self, payload: dict, n: int, what: str):
        """The payload's k/v arrays, shape-checked against ``n`` pages of
        this pool's geometry (``ValueError`` otherwise)."""
        kh, ps, hd = (int(x) for x in self.k.shape[1:])
        shape = (self.n_layers, n, kh, ps, hd)
        k, v = np.asarray(payload["k"]), np.asarray(payload["v"])
        if k.shape != shape or v.shape != shape:
            raise ValueError(f"{what} shape {k.shape} != expected {shape}")
        if k.dtype.itemsize != self.k.element_size() \
                or v.dtype.itemsize != self.k.element_size():
            raise ValueError(f"{what} element size {k.dtype.itemsize} != "
                             f"pool's {self.k.element_size()}")
        return k, v

    def import_pages(self, pages: list[int], payload: dict,
                     sync: bool = False) -> None:
        """Scatter a spilled payload back into freshly allocated pages —
        the prefetch half of the host tier.  Asynchronous by default (the
        copy is ordered before the next dispatch on the same stream);
        ``sync=True`` blocks until it lands (``LMRS_HOST_KV_SYNC``).  A
        dtype or geometry mismatch raises ``ValueError``; the caller
        re-prefills."""
        if payload.get("dtype") != self.wire_dtype:
            raise ValueError(f"spill payload dtype {payload.get('dtype')!r} "
                             f"!= pool {self.wire_dtype}")
        k, v = self._check_pages(payload, len(pages), "spill payload")
        self._scatter(pages, k, v, sync)

    def page_payload_bytes(self) -> int:
        """Host bytes one spilled page costs (k + v, all layers) — the
        spill tier's budget arithmetic."""
        kh, ps, hd = (int(x) for x in self.k.shape[1:])
        return 2 * self.n_layers * kh * ps * hd * self.k.element_size()

    def import_sequence(self, payload: dict) -> SequencePages:
        """Scatter an exported page set into freshly allocated local pages
        and return the live sequence (``length`` = the payload's kv_len).
        An incompatible payload (pool geometry, dtype, page count) raises
        ``ValueError``; pool pressure raises ``OutOfPages`` (back-pressure:
        the importer retries).  A failure after allocation frees the
        pages."""
        # injection site: the decode-side scatter fails before any
        # allocation (a marked import error, the pool untouched)
        faults.fire("handoff.import")
        kh, ps, hd = (int(x) for x in self.k.shape[1:])
        want = {"page_size": self.page_size, "n_layers": self.n_layers,
                "n_kv_heads": kh, "head_dim": hd, "dtype": self.wire_dtype}
        for key, val in want.items():
            got = payload.get(key)
            if got != val:
                raise ValueError(
                    f"incompatible handoff payload: {key}={got!r}, this "
                    f"pool has {val!r}")
        n = int(payload["n_pages"])
        length = int(payload["kv_len"])
        if not 0 < n <= self.max_pages_per_slot:
            raise ValueError(f"bad handoff page count {n}")
        if self.pages_needed(max(1, length)) != n:
            raise ValueError(
                f"handoff kv_len {length} does not cover {n} pages")
        k, v = self._check_pages(payload, n, "handoff page data")
        pages = self.alloc_pages(n)
        try:
            self._scatter(pages, k, v, sync=False)
        except BaseException:
            self.allocator.free(pages)
            raise
        return SequencePages(pages=pages, length=length)


def _to_numpy(t: torch.Tensor, wire: str) -> np.ndarray:
    """A CPU tensor as a numpy array of the wire dtype (bf16 as raw words,
    sharing the tensor's memory)."""
    if t.dtype == torch.bfloat16:
        return as_dtype(t.view(torch.int16).numpy(), wire)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of the pool's dtype, sharing memory
    (raw bf16 words are viewed as bfloat16).  A read-only array (a decoded
    wire payload) is only ever read."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        a = a.view(np.int16)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        t = torch.from_numpy(a)
    return t.view(dtype) if t.dtype != dtype else t


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
