"""Host-side page-pool allocator for the paged KV cache (PyTorch port;
a copy of the reference's ``serving/kv_pages.py``).

The device side of paged KV is just two leaves in the engine state —
a pool of KV pages per layer (``(n_layers, n_pages, page_size, kvh,
dh)``) and a per-slot page table (``(n_slots, pages_per_slot)``
int32).  This module owns the *host* side: which physical pages are
free, and how many owners (live slots + the prefix cache) reference
each page.  Refcounting is what makes shared-prefix pages safe: a
page is returned to the free list only when its last owner lets go,
so LRU eviction in ``prefix_cache`` can never free a page a live
slot is still reading.

Physical page 0 is reserved as the *garbage page* and is never handed
out by ``alloc``.  Retired slots keep decoding inside the frozen
on-device chunk loop (their lane is masked, but the cache scatter
still happens); resetting a retired slot's page-table row to 0 aims
those dead writes at the garbage page instead of at pages that may
since have been reallocated to another request.
"""
from __future__ import annotations

from typing import Iterable, Optional

GARBAGE_PAGE = 0


class PoolExhausted(RuntimeError):
    """Raised by ``PagePool.alloc`` when the free list cannot cover a
    request; the engine reacts by evicting cache-only prefix pages or
    deferring admission until a slot retires."""


class PagePool:
    """Free-list allocator with refcounted pages.

    ``order`` (optional) fixes the free-list hand-out order — the
    property tests use a shuffled order to prove any page-table
    permutation is bit-identical to the contiguous layout.  ``reset``
    restores the same order, so an engine reset reproduces the same
    allocation sequence.
    """

    def __init__(self, n_pages: int, page_size: int,
                 order: Optional[Iterable[int]] = None):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        if order is None:
            self._order = list(range(1, self.n_pages))
        else:
            self._order = [int(p) for p in order]
            if sorted(self._order) != list(range(1, self.n_pages)):
                raise ValueError(
                    "order must be a permutation of 1..n_pages-1 "
                    "(page 0 is the reserved garbage page)")
        self.alloc_ops = 0          # alloc/ref/unref count (benchmarked)
        self.reset()

    def reset(self) -> None:
        """Return every page to the free list and zero all refcounts."""
        self._free = list(reversed(self._order))   # pop() -> order[0] first
        self.refcount = [0] * self.n_pages
        self.peak_used = 0

    # -- queries ----------------------------------------------------------
    def free_pages(self) -> int:
        """Pages currently allocatable."""
        return len(self._free)

    def used_pages(self) -> int:
        """Pages held by at least one reference (garbage page excluded)."""
        return (self.n_pages - 1) - len(self._free)

    # -- operations -------------------------------------------------------
    def alloc(self, n: int) -> list[int]:
        """Hand out ``n`` pages with refcount 1 each; all-or-nothing."""
        if n < 0:
            raise ValueError("alloc of negative page count")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"(pool of {self.n_pages - 1} usable)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        self.alloc_ops += n
        self.peak_used = max(self.peak_used, self.used_pages())
        return pages

    def ref(self, page: int) -> None:
        """Add an owner to an already-allocated page (prefix-cache hit)."""
        if page == GARBAGE_PAGE:
            raise ValueError("page 0 is the reserved garbage page")
        if self.refcount[page] <= 0:
            raise ValueError(f"ref of free page {page}")
        self.refcount[page] += 1
        self.alloc_ops += 1

    def unref(self, page: int) -> None:
        """Drop an owner; the page returns to the free list at zero."""
        if page == GARBAGE_PAGE:
            raise ValueError("page 0 is the reserved garbage page")
        if self.refcount[page] <= 0:
            raise ValueError(f"unref of free page {page}")
        self.refcount[page] -= 1
        self.alloc_ops += 1
        if self.refcount[page] == 0:
            self._free.append(page)
