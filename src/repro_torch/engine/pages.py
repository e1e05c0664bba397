"""Host-side page tables for the paged KV decode caches (the port's own
copy of ``repro.engine.pages``; numpy only, no torch).

Physical cache memory is a pool of fixed-size pages shared by every serving
slot (``models/attention.py`` holds the device layout); this module is the
*allocator*: per-slot page lists, alloc on insert, grow-by-one as a slot's
clock crosses a page boundary, free on ``free_slot``. Allocation decisions
are host control flow between generate steps; the page map reaches the
device as data (an int32 tensor uploaded when ``PageTable.version`` moves).

Pages are **refcounted**: a page may back the same logical index of several
slots at once (shared prompt prefixes map the same pages instead of copying
them), and the prefix index below may pin it so it outlives its last slot.
A page with ``refs > 1`` is read-only for everyone — any slot that needs to
write into it must copy-on-write first (``cow``). Freeing only happens when
the refcount reaches zero; ``release`` reports exactly the pages that hit
zero so the engine scrubs just those rows on device.

Page id 0 is the reserved **null page**: it backs every unallocated map
entry, soaks up the discarded writes of inactive slots, and is masked on
every read. A pool that should serve N real pages therefore needs N + 1
rows. The null page is never allocated, never refcounted, and never shared
in the prefix-index sense.

The SOI payoff: the compressed middle gets its own table whose logical
length is ``soi_mid_len(max_len, stride)`` — a slot allocates middle pages
at 1/stride the rate of outer pages, so the paper's partial-state
compression shows up directly as fewer resident pages per request — and a
shared prefix shares its middle pages at the same 1/stride rate.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np


class PageTable:
    """Refcounted page allocator for ONE cache group (outer full-rate, or
    SOI middle).

    ``map`` is the (n_slots, pages_per_slot) int32 page-list matrix the
    generate step indexes through; rows are dense in *logical page index*
    (logical position ``l`` lives in map column ``l // page_size``), with 0
    marking unallocated entries. Ring semantics are inherited from the
    logical index: position ``t`` maps to ``t % logical_len`` first.

    ``refs`` counts the owners of each page: slots mapping it plus prefix-
    index pins. ``refs[pid] > 1`` means the page is shared and therefore
    read-only — writers go through ``cow``.
    """

    def __init__(self, n_slots: int, logical_len: int, page_size: int,
                 n_pages: int):
        if logical_len % page_size:
            raise ValueError(f"page_size {page_size} must divide the "
                             f"logical cache length {logical_len}")
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is the reserved "
                             "null page)")
        self.page_size = page_size
        self.logical_len = logical_len
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.pages_per_slot = logical_len // page_size
        self.map = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self.refs = np.zeros(n_pages, np.int32)
        self._free = list(range(n_pages - 1, 0, -1))   # pop() -> lowest id
        # peak simultaneously-allocated page count (capacity planning,
        # ``SOIEngine.pool_stats``); never resets — it describes the pool's
        # whole lifetime
        self.high_water = 0
        # bumped on every ``map`` mutation. The engine keys its device copy
        # of the map on this, so steady-state decode steps (no boundary
        # crossing, no insert/free) skip the per-step host->device upload
        # entirely — refcount-only changes (pin/unpin of still-mapped
        # pages) deliberately don't bump it.
        self.version = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Currently allocated pages (excludes the null page)."""
        return self.n_pages - 1 - len(self._free)

    def _alloc_one(self, slot: int, idx: int) -> int:
        if not self._free:
            raise RuntimeError(
                f"KV page pool exhausted ({self.n_pages - 1} pages of "
                f"{self.page_size} positions): free slots or size the pool "
                f"for the resident token population")
        pid = self._free.pop()
        self.map[slot, idx] = pid
        self.version += 1
        self.refs[pid] = 1
        if self.used_pages > self.high_water:
            self.high_water = self.used_pages
        return pid

    def _decref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page hit zero and went
        back to the free list (the caller must scrub it on device)."""
        self.refs[pid] -= 1
        if self.refs[pid] < 0:
            raise RuntimeError(f"page {pid} refcount went negative — "
                               f"double release")
        if self.refs[pid] == 0:
            self._free.append(int(pid))
            return True
        return False

    def adopt(self, slot: int, idx: int, pid: int):
        """Map an already-resident page into ``slot``'s row (prefix sharing:
        bump the refcount instead of copying page contents)."""
        if not 0 < pid < self.n_pages:
            raise ValueError(f"cannot adopt page {pid} (null/out of range)")
        if self.refs[pid] <= 0:
            raise ValueError(f"cannot adopt page {pid}: not resident")
        if self.map[slot, idx]:
            raise RuntimeError(f"slot {slot} map entry {idx} already backed")
        self.map[slot, idx] = pid
        self.version += 1
        self.refs[pid] += 1

    def pin(self, pid: int):
        """Add an off-slot reference (the prefix index holding a page alive
        past its last sharer's free)."""
        if not 0 < pid < self.n_pages or self.refs[pid] <= 0:
            raise ValueError(f"cannot pin page {pid}: not resident")
        self.refs[pid] += 1

    def unpin(self, pid: int) -> bool:
        """Drop an off-slot reference; True when the page was freed (scrub
        it)."""
        return self._decref(pid)

    def is_shared(self, pid: int) -> bool:
        return pid > 0 and self.refs[pid] > 1

    def pages_needed(self, n_positions: int) -> int:
        """Pages ``alloc_slot(slot, n_positions)`` would consume."""
        return -(-min(n_positions, self.logical_len) // self.page_size)

    def freeable_after_release(self, slot: int) -> int:
        """Free pages available once ``slot`` releases: the current free
        list plus the slot's exclusively-owned (refs == 1) pages. Shared
        pages survive a release, so they don't count."""
        row = self.map[slot]
        own = int(sum(1 for pid in row[row > 0] if self.refs[pid] == 1))
        return self.free_pages + own

    def alloc_slot(self, slot: int, n_positions: int,
                   shared: dict | None = None) -> tuple:
        """Back logical positions [0, n_positions) (clamped to the ring
        length) for a freshly inserted request.

        ``shared`` maps logical page indices to already-resident page ids:
        those entries are *adopted* (refcount bump, no copy); the rest are
        freshly allocated. Returns ``(map_row, write_row)``: the slot's full
        page row, and the same row with shared entries masked to the null
        page — the device cache fill writes through ``write_row`` so shared
        pages are never re-written (their content is already correct and may
        be concurrently read by other slots).
        """
        if self.map[slot].any():
            raise RuntimeError(f"slot {slot} still owns pages; release it "
                               f"before re-inserting")
        shared = shared or {}
        n_positions = min(n_positions, self.logical_len)
        n = -(-n_positions // self.page_size)
        write = np.zeros(self.pages_per_slot, np.int32)
        for i in range(n):
            pid = shared.get(i)
            if pid is not None:
                self.adopt(slot, i, pid)
            else:
                write[i] = self._alloc_one(slot, i)
        return self.map[slot].copy(), write

    def ensure(self, slot: int, position: int):
        """Make sure the page backing absolute ``position`` exists (the
        grow-by-one step of decode). Returns the newly allocated page id, or
        None if the position was already backed."""
        idx = (position % self.logical_len) // self.page_size
        if self.map[slot, idx] == 0:
            return self._alloc_one(slot, idx)
        return None

    def drop(self, slot: int, idx: int) -> bool:
        """Unmap one page entry from ``slot`` without touching the rest of
        its row — the rollback of a speculative grow-by-one whose position
        was rejected. Returns True when the page went back to the free
        list. A page that was never written (speculative backing routes
        rejected writes to the null page) needs no device scrub. No-op on
        an already-empty entry, so rollback after a partial failure (or
        after ``release`` already swept the slot) is idempotent."""
        pid = int(self.map[slot, idx])
        if pid == 0:
            return False
        self.map[slot, idx] = 0
        self.version += 1
        return self._decref(pid)

    def cow(self, slot: int, idx: int) -> tuple:
        """Copy-on-write: give ``slot`` a private page for map entry ``idx``
        (currently shared). Returns ``(old_pid, new_pid)`` — the caller
        copies the device rows old -> new. The old page keeps its other
        references; the new page starts exclusive."""
        old = int(self.map[slot, idx])
        if old == 0:
            raise RuntimeError(f"slot {slot} entry {idx} is unallocated")
        if self.refs[old] <= 1:
            raise RuntimeError(f"page {old} is exclusive; no COW needed")
        new = self._alloc_one(slot, idx)       # overwrites map[slot, idx]
        self.refs[old] -= 1                    # was > 1: can't hit zero
        return old, new

    def release(self, slot: int) -> np.ndarray:
        """Drop the slot's references. Pages whose refcount hits zero return
        to the free list; the returned row holds exactly those page ids
        (0 elsewhere) so the caller scrubs only truly-freed device rows —
        pages still shared (other slots or prefix-index pins) keep their
        contents readable."""
        row = self.map[slot].copy()
        freed = np.zeros_like(row)
        for i, pid in enumerate(row):
            if pid > 0 and self._decref(int(pid)):
                freed[i] = pid
        self.map[slot] = 0
        self.version += 1
        return freed


# ---------------------------------------------------------------------------
# Prefix index: token-id page blocks -> resident pages
# ---------------------------------------------------------------------------

def chain_keys(tokens: np.ndarray, block: int) -> dict:
    """Rolling hash over ``block``-sized token-id blocks.

    Returns {boundary: digest} for every full-block boundary: the key at
    boundary ``b`` commits to all tokens [0, b), computed as
    ``H(H(prev), block_bytes)`` — a radix-style chain, so extending a prompt
    only hashes its new blocks.
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out = {}
    h = hashlib.blake2b(digest_size=16)
    for j in range(len(toks) // block):
        h.update(toks[j * block:(j + 1) * block].tobytes())
        out[(j + 1) * block] = h.digest()
        h = hashlib.blake2b(h.digest(), digest_size=16)
    return out


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix boundary: the resident pages holding the caches of
    tokens [0, length), plus the SOI carries needed to resume a chunked
    prefill at that boundary (None for non-SOI configs)."""
    length: int                    # tokens covered (page- and chunk-aligned)
    tokens: np.ndarray             # the actual ids (guards hash collisions)
    outer_pages: tuple             # page ids for logical pages [0, length/P)
    mid_pages: tuple               # SOI middle pages, 1/stride rate
    conv_buf: object               # (1, stride-1, d) pre-trunk conv window
    queue: object                  # (1, stride, d) extrapolation queue
    # (the engine keeps the two SOI carries as host tensors: numpy has no
    # bfloat16)


class PrefixIndex:
    """LRU map from chain keys to :class:`PrefixEntry`.

    Purely host-side bookkeeping: the *engine* owns the pin/unpin protocol
    (every page an entry references holds one pin per entry) and the device
    scrub of pages freed by eviction; this class only orders the entries.
    """

    def __init__(self):
        self._entries: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def entries(self) -> list:
        """Snapshot of the live entries (LRU order, oldest first)."""
        return list(self._entries.values())

    def get(self, key, tokens: np.ndarray) -> PrefixEntry | None:
        """Lookup + collision guard + LRU touch."""
        e = self._entries.get(key)
        if e is None or not np.array_equal(e.tokens, tokens):
            return None
        self._entries.move_to_end(key)
        return e

    def put(self, key, entry: PrefixEntry):
        if key in self._entries:
            raise ValueError("prefix key already registered")
        self._entries[key] = entry

    def pop_lru(self) -> PrefixEntry | None:
        """Remove and return the least-recently-used entry (the caller
        unpins its pages), or None when empty."""
        if not self._entries:
            return None
        _, entry = self._entries.popitem(last=False)
        return entry
