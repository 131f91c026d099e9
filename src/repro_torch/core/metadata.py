"""Pool-resident metadata: page directory with seqlock-versioned entries.

The paper (§4.3.1) replaces RPC-based metadata services with a shared
CXL memory region accessed via load/store.  We model that region as a set
of flat numpy arrays (the "pool namespace") plus an access-accounting hook
so the serving simulator can charge every metadata load/store to the
fabric cost model — the point being that lookups cost *memory ops*, not
RPCs.

Entries follow single-writer seqlock semantics: a writer bumps the version
to odd (claim), mutates, bumps to even (commit); readers retry on odd or
changed versions.  ``MetadataRegion.stats`` counts the cache-line touches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

LINE = 64  # CXL cache-line granularity


@dataclasses.dataclass
class AccessStats:
    loads: int = 0
    stores: int = 0

    def lines(self) -> int:
        return self.loads + self.stores


class PageDirectory:
    """Maps (seq_hash, page_no) -> (device_id, page_id) in pool memory.

    Open-addressed hash table living in the shared region; every probe is
    one cache-line load, every publish is two stores (claim+commit bracket
    folded into the line count).
    """

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.keys = np.full(capacity, -1, np.int64)        # packed key
        self.vals = np.full((capacity, 2), -1, np.int32)   # (device, page)
        self.version = np.zeros(capacity, np.int64)        # seqlock
        self.stats = AccessStats()

    @staticmethod
    def _pack(seq_hash: int, page_no: int) -> int:
        return ((seq_hash & 0xFFFFFFFF) << 24) | (page_no & 0xFFFFFF)

    def _probe(self, key: int):
        h = (key * 0x9E3779B97F4A7C15) % self.capacity
        for i in range(self.capacity):
            slot = (h + i) % self.capacity
            self.stats.loads += 1
            if self.keys[slot] == key or self.keys[slot] == -1:
                return slot
        raise RuntimeError("page directory full")

    def publish(self, seq_hash: int, page_no: int, device: int, page: int):
        key = self._pack(seq_hash, page_no)
        slot = self._probe(key)
        # seqlock write bracket: version odd -> mutate -> even
        self.version[slot] += 1
        self.stats.stores += 1
        self.keys[slot] = key
        self.vals[slot] = (device, page)
        self.version[slot] += 1
        self.stats.stores += 1

    def lookup(self, seq_hash: int, page_no: int
               ) -> Optional[Tuple[int, int]]:
        key = self._pack(seq_hash, page_no)
        for _ in range(8):  # seqlock retry loop
            slot = self._probe(key)
            v0 = int(self.version[slot])
            self.stats.loads += 1
            if v0 % 2 == 1:
                continue
            if self.keys[slot] != key:
                return None
            dev, page = (int(self.vals[slot][0]), int(self.vals[slot][1]))
            self.stats.loads += 1
            if int(self.version[slot]) == v0:
                return dev, page
        return None

    def unpublish(self, seq_hash: int, page_no: int):
        key = self._pack(seq_hash, page_no)
        slot = self._probe(key)
        if self.keys[slot] == key:
            self.version[slot] += 1
            self.keys[slot] = -1
            self.vals[slot] = (-1, -1)
            self.version[slot] += 1
            self.stats.stores += 3


class PoolAllocator:
    """Per-device page allocator for the pool (O(1) ops, O(live) memory).

    One allocator per CXL device; the scheduler's interleaving decides
    *which* device a request's pages go to (core/pool.py).  Never-used
    pages are represented by a high-water mark (a 2 TB pool at 16-token
    pages is hundreds of millions of pages — materializing a free list
    would cost GBs of host memory); released pages go to a returned
    stack that is drained first.
    """

    def __init__(self, n_devices: int, pages_per_device: int):
        self.n_devices = n_devices
        self.pages_per_device = pages_per_device
        self._next = [0] * n_devices             # high-water mark
        self._returned = [[] for _ in range(n_devices)]

    def alloc(self, device: int, n: int):
        if self.free_pages(device) < n:
            return None
        ret = self._returned[device]
        take = min(len(ret), n)
        pages = [ret.pop() for _ in range(take)]
        fresh = n - take
        hw = self._next[device]
        pages.extend(range(hw, hw + fresh))
        self._next[device] = hw + fresh
        return pages

    def release(self, device: int, pages):
        self._returned[device].extend(pages)

    def free_pages(self, device: int) -> int:
        return (self.pages_per_device - self._next[device]
                + len(self._returned[device]))

    def utilization(self) -> float:
        total = self.n_devices * self.pages_per_device
        used = sum(self._next[d] - len(self._returned[d])
                   for d in range(self.n_devices))
        return used / total
