"""Paged KV-cache management: block-table paging for the serving engine
(twin of `llamavk_tpu/runtime/paged.py`, NumPy only, a copy).

K/V live in a POOL of fixed-size pages `[L, NP, H, PS, D]` shared by every
request slot (int8 pools page their scale planes `[L, NP, PS, H]` through
the same tables), and each slot addresses its logical context through a
block table `table[slot, j] -> page`. Compared with the flat per-slot slabs
this buys:

  * KV memory = pages in use, not max_batch x n_ctx: long-context slots and
    short ones share one budget;
  * prefix sharing by aliasing: a registered prefix's full pages appear in
    many slots' tables read-only (refcounted), with no copy at admission;
  * any eviction order: freeing a slot returns its pages to the free list.

Host side (this module): a free-list allocator with per-page refcounts.
Device side: the attention kernels take the block table as an int32
`[B, MAXLB]` tensor and read logical row j of batch row b at page
`table[b, j // PS]`, row `j % PS` (`ops/flash_attn.py`,
`ops/flash_decode.py`).

The table has a fixed shape; unused entries hold 0 (page 0 is the engine's
trash page, and the kernels bound their reads by n_past). Pages are mapped
ahead of each decode block, so the table is constant inside it.
"""

from __future__ import annotations

import numpy as np


class PageAllocator:
    """Free-list page allocator with refcounts (host-side, tiny).

    Pages are identified by int ids in [0, n_pages). `alloc` pops from the
    free list; `retain` bumps a shared page's refcount (prefix aliasing);
    `release` decrements and frees at zero.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free: list[int] = list(range(n_pages - 1, -1, -1))
        self.refs = np.zeros(n_pages, np.int32)

    @property
    def n_free(self) -> int:
        return len(self.free)

    def alloc(self, n: int = 1) -> list[int]:
        if n > len(self.free):
            raise MemoryError(
                f"KV page pool exhausted: need {n}, have {len(self.free)} "
                f"of {self.n_pages}"
            )
        out = [self.free.pop() for _ in range(n)]
        for p in out:
            self.refs[p] = 1
        return out

    def retain(self, pages: list[int]) -> None:
        for p in pages:
            assert self.refs[p] > 0, f"retain of free page {p}"
            self.refs[p] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            assert self.refs[p] > 0, f"double free of page {p}"
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self.free.append(p)


class SlotPages:
    """Per-slot page list + the host mirror of the device block table."""

    def __init__(self, max_batch: int, max_pages_per_slot: int,
                 allocator: PageAllocator):
        self.alloc = allocator
        self.table = np.zeros((max_batch, max_pages_per_slot), np.int32)
        self.owned: list[list[int]] = [[] for _ in range(max_batch)]
        self.n_mapped = np.zeros(max_batch, np.int32)  # pages mapped per slot
        self.dirty = False  # host table changed since last device sync

    def ensure(self, slot: int, n_positions: int, page_size: int) -> None:
        """Map enough pages for `n_positions` logical rows in `slot`."""
        need = -(-n_positions // page_size)
        if need > self.table.shape[1]:
            raise MemoryError(
                f"slot {slot} needs {need} pages > table width "
                f"{self.table.shape[1]}"
            )
        have = int(self.n_mapped[slot])
        if need > have:
            new = self.alloc.alloc(need - have)
            self.owned[slot].extend(new)
            self.table[slot, have:need] = new
            self.n_mapped[slot] = need
            self.dirty = True

    def share(self, slot: int, pages: list[int]) -> None:
        """Alias `pages` (a prefix's full pages) read-only at the start of
        `slot`'s table. Caller must release() them when the slot frees."""
        assert self.n_mapped[slot] == 0, "share() must precede ensure()"
        self.alloc.retain(pages)
        self.owned[slot].extend(pages)
        self.table[slot, : len(pages)] = pages
        self.n_mapped[slot] = len(pages)
        self.dirty = True

    def free_slot(self, slot: int) -> None:
        self.alloc.release(self.owned[slot])
        self.owned[slot] = []
        self.table[slot] = 0
        self.n_mapped[slot] = 0
        self.dirty = True
