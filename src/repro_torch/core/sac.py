"""SAC facade (``repro/core/sac.py``).

Two halves:

1. **On the device** (``sparse_attend``, ``window_attend``,
   ``dense_attend``): the per-layer decode attention of the paper's
   Figure 6 -- indexer scoring -> masked top-k -> pool fetch (injected
   ``fetch_fn``, the gather kernel by default) -> sparse attention,
   absorbed-MLA or GQA; with the hot tier and ``prefetch_width > 0``
   the step's speculated entrants are fetched too (with the default
   fetch, by the same gather launch as the demand set) and
   warm-inserted for the next step.  ``sparse_attend`` also runs over a
   pool sharded over ranks (``core/pool.py::make_pooled_fetch``).

2. **On the host** (``SACSystem``): pool page placement, metadata
   publishing and fabric-cost accounting for the serving engine, copied
   from the reference and running on the port's copies of the host
   modules.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hisparse
from repro_torch.core.fabric import FabricTopology
from repro_torch.core.metadata import PageDirectory, PoolAllocator
from repro_torch.core.placement import (Placer, pages_for_tokens,
                                        policy_for_interleave)
from repro_torch.core.pool import FetchFn, local_fetch, to_kv_dtype
from repro_torch.core.traffic import FabricAccountant
from repro_torch.core.transfer import FABRICS, FabricModel
from repro_torch.kernels import ops
from repro_torch.models import dsa


# ---------------------------------------------------------------------------
# decode attention on the device (used by models/transformer.py)
# ---------------------------------------------------------------------------


def _attend(p_attn, x, cfg, entries, valid, positions):
    if cfg.mla:
        return dsa.mla_absorbed_decode(p_attn, x, cfg, entries, valid,
                                       positions)
    return dsa.gqa_sparse_decode(p_attn, x, cfg, entries, valid, positions)


def sparse_attend(p_attn: Dict, p_idx: Dict, x: torch.Tensor,
                  cfg: ModelConfig, kv_pool_l: torch.Tensor,
                  idx_pool_l: torch.Tensor, cache_len: torch.Tensor,
                  positions: torch.Tensor, own_entry: torch.Tensor,
                  fetch_fn: FetchFn = local_fetch,
                  topk_fn: Optional[Callable] = None,
                  window: int = 0,
                  buf_state: Optional[hisparse.BufferState] = None,
                  prefetch_width: int = 0,
                  prefetch_fn: Optional[Callable] = None,
                  score_margin: float = -1.0,
                  pf_budget: Optional[torch.Tensor] = None):
    """One layer of SAC decode attention.  x: [B, D] -> [B, D].

    kv_pool_l: [B, S, d_entry]; idx_pool_l: [B, S, d_idx]; own_entry:
    [B, d_entry] (the current token's entry, appended so the token
    attends to itself before the write-back lands).  ``window`` > 0
    restricts the candidates to the trailing window.  ``topk_fn(scores,
    cache_len) -> (idx, valid)`` overrides the selection.

    With ``buf_state`` (this layer's HiSparse hot tier) the read goes
    through ``hisparse.read_through``: values are bit-identical, and
    the hits/misses are measured.  Returns the plain output when
    ``buf_state`` is None, else ``(out, new_buf_state, hits, misses)``.

    ``prefetch_width`` > 0 (buffered path only) also warm-inserts the
    next step's speculated entrants after the demand swap-in:
    ``prefetch_fn(scores, cache_len) -> (idx [B, w], valid)``, by
    default ranks [k, k+w) of this step's scores (from the same top-k as
    the demand set, unless ``topk_fn`` replaces that).  ``score_margin
    >= 0`` cuts the default tail at a score threshold; ``pf_budget``
    ([B] int32, the arbiter's grants) caps the lanes each request may
    issue.  Prefetch touches only the hot tier, so the output does not
    depend on any of these; the buffer's ``pf_*`` counters measure it.

    A pool sharded over ranks (``fetch_fn`` from ``make_pooled_fetch``,
    which carries its ``shard``): the pools are this rank's slices, the
    indexer scores the slice, and the scores are all-gathered over the
    pool axis before the selection, so that the window mask, the top-k,
    the speculation tail, ``topk_fn`` and ``prefetch_fn`` see ``[B, S]``
    scores as on one device.  A ``topk_fn`` with ``local_scores``
    (``core/topk.py``'s hierarchical top-k) takes the slice's scores
    instead (masked at their global positions); with speculation it
    also gives the tail, ranks [k, k+w) of the global scores
    (``with_tail``), bit for bit the fused selection's.  It takes no
    ``prefetch_fn``, which would see only the slice.
    """
    shard = getattr(fetch_fn, "shard", None)
    local_sel = getattr(topk_fn, "local_scores", False)
    speculate = buf_state is not None and prefetch_width > 0
    if local_sel and (shard is None or (speculate and prefetch_fn)):
        raise ValueError("a top-k over local scores needs the pooled fetch "
                         "and takes no prefetch_fn (it sees the slice)")
    scores = dsa.indexer_scores(p_idx, x, idx_pool_l, cfg)
    base, seq_len = 0, scores.shape[-1]
    if shard is not None:
        base = shard.base(seq_len) if local_sel else 0
        seq_len = shard.seq_len(seq_len)
        if not local_sel:
            scores = shard.all_gather(scores)
    if window:
        pos = base + torch.arange(scores.shape[-1], dtype=torch.int32,
                                  device=scores.device)
        in_win = pos[None, :] > (cache_len[:, None] - window)
        scores = torch.where(in_win, scores, dsa.NEG_INF)
    spec_idx = spec_valid = None
    if local_sel and speculate:
        idx, valid, spec_idx, spec_valid = topk_fn.with_tail(
            scores, cache_len, cfg.sac.topk, prefetch_width, score_margin)
    elif topk_fn is not None:
        idx, valid = topk_fn(scores, cache_len)
    elif speculate and prefetch_fn is None:
        # fused selection: one top-(k+w) gives the (bit-identical)
        # demand set and the speculation tail
        idx, valid, spec_idx, spec_valid = dsa.topk_select_with_tail(
            scores, cache_len, cfg.sac.topk, prefetch_width, score_margin)
    else:
        idx, valid = dsa.topk_select(scores, cache_len, cfg.sac.topk)
    if speculate and spec_idx is None:
        spec_idx, spec_valid = (
            prefetch_fn(scores, cache_len) if prefetch_fn is not None
            else dsa.speculate_next_topk(scores, cache_len, cfg.sac.topk,
                                         prefetch_width, score_margin))
    spec_vals = None
    if speculate and fetch_fn is local_fetch:
        # the demand set and the speculation tail in one gather launch
        # (which clamps the tail's indices into the pool itself)
        fetched, spec_vals = ops.batched_gather_many(
            [(kv_pool_l, idx), (kv_pool_l, spec_idx)])
    else:
        fetched = fetch_fn(kv_pool_l, idx)
    if buf_state is not None:
        fetched, buf_state, hits, misses = hisparse.read_through(
            buf_state, idx, fetched, valid)
        if speculate:
            if pf_budget is not None:
                spec_valid = dsa.budget_mask(spec_valid, pf_budget)
            if spec_vals is None:
                spec_vals = fetch_fn(kv_pool_l, torch.clamp(
                    spec_idx, 0, seq_len - 1))
            buf_state, _ = hisparse.warm_insert(buf_state, spec_idx,
                                                spec_vals, spec_valid)
    fetched = torch.cat([fetched, to_kv_dtype(own_entry[:, None, :],
                                              fetched.dtype)], dim=1)
    valid = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)
    out = _attend(p_attn, x, cfg, fetched, valid, positions)
    if buf_state is not None:
        return out, buf_state, hits, misses
    return out


def window_attend(p_attn: Dict, x: torch.Tensor, cfg: ModelConfig,
                  kv_pool_l: torch.Tensor, cache_len: torch.Tensor,
                  positions: torch.Tensor, own_entry: torch.Tensor,
                  window: int, fetch_fn: FetchFn = local_fetch
                  ) -> torch.Tensor:
    """Sliding-window decode: fetch the trailing ``window-1`` entries
    (contiguous indices through the same fetch path, the gather kernel on
    the card) + the own entry.  Over a sharded pool ``kv_pool_l`` is the
    rank's slice and the indices are clamped into the whole pool."""
    B = x.shape[0]
    w = window - 1
    S = kv_pool_l.shape[1]
    shard = getattr(fetch_fn, "shard", None)
    if shard is not None:
        S = shard.seq_len(S)
    idx = (cache_len[:, None] - w
           + torch.arange(w, dtype=torch.int32, device=x.device)[None, :])
    valid = idx >= 0
    idx = torch.clamp(idx, 0, S - 1).to(torch.int32)
    fetched = fetch_fn(kv_pool_l, idx)
    fetched = torch.cat([fetched, to_kv_dtype(own_entry[:, None, :],
                                              fetched.dtype)], dim=1)
    valid = torch.cat([valid, torch.ones((B, 1), dtype=torch.bool,
                                         device=x.device)], dim=1)
    return _attend(p_attn, x, cfg, fetched, valid, positions)


def dense_attend(p_attn: Dict, x: torch.Tensor, cfg: ModelConfig,
                 kv_pool_l: torch.Tensor, cache_len: torch.Tensor,
                 positions: torch.Tensor, own_entry: torch.Tensor
                 ) -> torch.Tensor:
    """Dense decode over the full pool slice (full-prefetch baseline).
    Over a sharded pool the caller hands in the whole layer
    (``PoolShard.gather_pool``)."""
    B, S, _ = kv_pool_l.shape
    pool = torch.cat([kv_pool_l, to_kv_dtype(own_entry[:, None, :],
                                             kv_pool_l.dtype)], dim=1)
    pos = torch.arange(S, dtype=torch.int32, device=kv_pool_l.device)
    valid = torch.cat([pos[None, :] < cache_len[:, None],
                       torch.ones((B, 1), dtype=torch.bool,
                                  device=kv_pool_l.device)], dim=1)
    return _attend(p_attn, x, cfg, pool, valid, positions)


# ---------------------------------------------------------------------------
# host-level pool system (serving engine / simulator substrate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestPages:
    request_id: int
    device: int
    pages: list
    n_tokens: int


class SACSystem:
    """Disaggregated KV-cache system state for one serving cluster.

    ``backend`` picks the fabric cost model: "cxl" (SAC), "rdma"
    (full-prefetch baseline), "dram"/"hbm" (non-disaggregated baselines).

    Placement goes through the shared :class:`~repro_torch.core.placement.Placer`
    (one implementation for engine, scheduler, and simulator); traffic is
    charged to the shared :class:`~repro_torch.core.traffic.FabricAccountant`
    whose ``TrafficStats`` the engine exposes directly.

    With a radix index attached (``attach_radix``, serving/radix.py) the
    system also owns the cached-prefix page lifecycle: ``release`` can
    retain a finished request's prefix pages under radix ownership
    (still booked against the device's byte/page budgets via
    ``Placer.adjust``), ``radix_evict`` returns evicted prefixes' pages
    to the allocator, ``place`` evicts LRU prefixes when the pool is
    exhausted, and every page ``release`` actually frees is purged from
    the index — the allocator and the index can never disagree about a
    page (the PR 5 stale-page property, tests/test_radix.py).
    """

    def __init__(self, cfg: ModelConfig, *, backend: str = "cxl",
                 n_pool_devices: int = 2, device_bytes: int = 256 << 30,
                 interleave: bool = True, placement: Optional[str] = None,
                 pressure_fn=None, seq_capacity: int = 1 << 17,
                 topology=None):
        self.cfg = cfg
        self.backend = backend
        self.fabric: FabricModel = FABRICS[backend]
        self.interleave = interleave
        # fabric switch topology (core/fabric.py): accepts None (flat
        # star — the exact pre-PR 7 per-device accounting), a spec
        # string ("tree:4x2", ...), or a FabricTopology.  One object is
        # shared by the accountant (per-segment charging), the placer
        # (bottleneck-pressure projection), and — via the engine — the
        # demand tracker and budget arbiter.
        self.topology = FabricTopology.from_spec(topology, n_pool_devices)
        self.n_devices = n_pool_devices
        self.entry_bytes = cfg.kv_bytes_per_token_layer + 2 * cfg.sac.d_idx
        self.page_tokens = cfg.sac.page_size
        self.page_bytes = (self.entry_bytes * self.page_tokens
                           * max(cfg.n_attn_layers, 1))
        pages_per_device = max(device_bytes // max(self.page_bytes, 1), 1)
        self.allocator = PoolAllocator(n_pool_devices, pages_per_device)
        self.placer = Placer(
            n_pool_devices,
            policy=placement or policy_for_interleave(interleave),
            capacity_bytes=float(device_bytes),
            capacity_pages=pages_per_device,
            pressure_fn=pressure_fn,
            topology=self.topology)
        self.traffic = FabricAccountant(self.fabric,
                                        n_devices=n_pool_devices,
                                        topology=self.topology)
        self.directory = PageDirectory()
        self.requests: Dict[int, RequestPages] = {}
        # radix prefix cache ownership: the index (attach_radix) plus the
        # per-device set of page ids the CACHE owns — retained at request
        # finish, returned to the allocator only when the index evicts or
        # invalidates them.  Pages backing LIVE requests never enter this
        # set (their booking still owns them).
        self.radix = None
        self._radix_pages = [set() for _ in range(n_pool_devices)]
        self.radix_evicted_pages = 0     # cumulative cache pages returned
                                         # to the allocator (place-time
                                         # pressure + headroom evictions)
        # PR 6 page dedup: requests whose leading pages are refcount-
        # shared with a cached prefix (request_id -> that shared page
        # list), per-page sharer refcounts, and the orphan set — shared
        # pages whose owning copy left (owner departed un-retained, or
        # the cache evicted under a sharer) stay allocated + booked
        # until the LAST sharer departs, then return to the pool here
        self._shared_pages: Dict[int, list] = {}
        self._shared_refs: Dict[Tuple[int, int], int] = {}
        self._orphaned = [set() for _ in range(n_pool_devices)]
        self.replicated_pages = 0        # cumulative replica pages copied
        self.dedup_shared_pages = 0      # cumulative pages refcount-shared
                                         # instead of privately held
        self.booked_pages_cum = 0        # cumulative request pages booked
                                         # net of dedup (the pool-bytes-
                                         # per-request numerator)

    # -- placement ---------------------------------------------------------
    def set_pressure_fn(self, fn) -> None:
        """Attach the live per-device link-pressure feed the
        ``pressure_aware`` placement policy reads (core/placement.py).
        Both serving layers wire the shared
        :class:`repro_torch.serving.policy.PressureFeed` in here — tracker
        demand plus the warm-up seed while its window is open — so the
        engine's and the simulator's placers consume one feed class."""
        self.placer.set_pressure_fn(fn)

    def note_pressure_update(self) -> None:
        """Tell the placer the pressure feed was re-measured (once per
        engine step) so its in-flight correction resets."""
        self.placer.note_pressure_update()

    def attach_radix(self, radix) -> None:
        """Hand the system the radix prefix index whose page lifecycle it
        owns (duck-typed ``RadixIndex``; the engine builds one, the
        lifecycle tests drive the pair directly)."""
        self.radix = radix

    def place(self, request_id: int, n_tokens: int, *,
              affinity=None, affinity_s: float = 0.0
              ) -> Optional[RequestPages]:
        """Allocate pool pages for a request on one device (paper stores a
        request's KV within a single device; the shared placer interleaves
        requests across devices).

        ``affinity``/``affinity_s`` thread a radix-matched prefix's
        device — or, with replicas, every device holding a copy — and
        the seconds reuse there saves to the placement policy.  Under
        pool page pressure, unpinned LRU cached prefixes are evicted
        until the request fits or nothing is evictable.
        """
        n_pages = pages_for_tokens(n_tokens, self.page_tokens)
        n_bytes = n_pages * self.page_bytes
        while True:
            dev = self.placer.place(request_id, n_pages=n_pages,
                                    n_bytes=n_bytes, affinity=affinity,
                                    affinity_s=affinity_s)
            if dev is not None:
                break
            if self.radix is None or not self._evict_for_fit(
                    n_bytes, n_pages):
                return None      # genuinely full: nothing left to evict
        pages = self.allocator.alloc(dev, n_pages)
        assert pages is not None, \
            "placer and allocator page budgets diverged"
        rp = RequestPages(request_id, dev, pages, n_tokens)
        self.requests[request_id] = rp
        for pno, page in enumerate(pages):
            self.directory.publish(request_id, pno, dev, page)
        self.booked_pages_cum += n_pages
        return rp

    # -- hot-prefix replication / page dedup (PR 6) ------------------------
    def replica_copy_cost_s(self, n_pages: int) -> float:
        """One-time fabric cost of copying ``n_pages`` to another pool
        device (read leg + write leg run on different links; a symmetric
        fabric makes them equal, so charge one bulk transfer)."""
        return self.fabric.bulk_transfer_time(n_pages * self.page_bytes)

    def replicate_prefix(self, tokens, pages, src_device: int,
                         dst_device: int) -> int:
        """Copy a cached prefix's pages onto ``dst_device`` (hot-prefix
        replication): allocate fresh pages there, register them as a
        replica on the backing radix node, book them against the
        device's budgets, and charge the one-time copy traffic — a bulk
        read on the owning link plus a bulk write on the target link.
        The copy is charged UNkeyed: it belongs to the cache, not to any
        request, so no departure ever subtracts it from the pressure
        signal.  Returns pages replicated (0 when the target doesn't
        fit, the node already has a copy there, or no node matches)."""
        if (self.radix is None or src_device == dst_device
                or not 0 <= dst_device < self.n_devices):
            return 0
        n_pages = len(pages)
        n_bytes = n_pages * self.page_bytes
        if n_pages == 0 or not self.placer.fits(dst_device, n_bytes=n_bytes,
                                                n_pages=n_pages):
            return 0
        new_pages = self.allocator.alloc(dst_device, n_pages)
        if new_pages is None:
            return 0
        took = self.radix.add_replica(tokens, dst_device, new_pages)
        if not took:
            self.allocator.release(dst_device, new_pages)
            return 0
        self.placer.adjust(dst_device, n_bytes=n_bytes, n_pages=n_pages)
        self._radix_pages[dst_device].update(new_pages)
        self.traffic.bulk_fetch(n_bytes, device=src_device)
        self.traffic.write_back(n_bytes, device=dst_device)
        self.replicated_pages += took
        return took

    def dedup_match(self, request_id: int, shared_pages) -> int:
        """Refcount-share a matched prefix's cached pages with a live
        request (page dedup): the request's freshly allocated private
        copies of the matched prefix return straight to the pool, its
        booking shrinks by the same amount, and its directory entries
        re-point at the cached pages.  Decode never mutates prefix
        pages, so no copy-on-write path is needed; the caller keeps the
        backing radix path pinned for the request's lifetime, which is
        what keeps the shared pages resident.  Returns pages shared."""
        rp = self.requests.get(request_id)
        if rp is None or request_id in self._shared_pages:
            return 0
        n = min(len(shared_pages), len(rp.pages))
        if n <= 0:
            return 0
        shared = list(shared_pages)[:n]
        self.allocator.release(rp.device, rp.pages[:n])
        self.placer.shrink(request_id, n_bytes=n * self.page_bytes,
                           n_pages=n)
        rp.pages = shared + rp.pages[n:]
        for pno, page in enumerate(shared):
            self.directory.publish(request_id, pno, rp.device, page)
        self._shared_pages[request_id] = shared
        for p in shared:
            k = (rp.device, p)
            self._shared_refs[k] = self._shared_refs.get(k, 0) + 1
        self.dedup_shared_pages += n
        self.booked_pages_cum -= n
        return n

    def release(self, request_id: int, *, keep_pages: int = 0) -> int:
        """Free a finished request's pool pages.

        ``keep_pages`` > 0 retains the request's first that-many pages
        (the radix-registered prefix) under cache ownership instead of
        freeing them: the allocator keeps them allocated, the device's
        byte/page budgets keep charging them (``Placer.adjust``), and
        they return to the pool only through ``radix_evict``.  Every
        page actually freed is purged from the attached index in the
        same motion — the index can never advertise a freed page.
        Returns the number of pages retained (0 on unknown requests).

        Shared pages (PR 6 dedup) never free here under another live
        sharer: pages this request BORROWED only drop a refcount (the
        last sharer out frees an orphaned page); pages this request OWNS
        that others still share turn sticky — excluded from invalidation
        and from the freed list, they stay allocated + booked as cache
        pages (if the index still references them) or orphans (freed at
        the last sharer's departure).  No double-free, no leak.
        """
        rp = self.requests.pop(request_id, None)
        if rp is None:
            return 0
        self.placer.release(request_id)
        dev = rp.device
        # drop this request's borrowed-page refcounts first; an orphan
        # whose last sharer just left finally returns to the pool
        borrowed = set(self._shared_pages.pop(request_id, []))
        for p in borrowed:
            k = (dev, p)
            left = self._shared_refs.get(k, 0) - 1
            if left > 0:
                self._shared_refs[k] = left
                continue
            self._shared_refs.pop(k, None)
            if p in self._orphaned[dev]:
                self._orphaned[dev].discard(p)
                self.allocator.release(dev, [p])
                self.placer.adjust(dev, n_bytes=-self.page_bytes,
                                   n_pages=-1)
        # pages OTHER live requests still share out of this one's
        # allocation are sticky: this departure must not free them
        sticky = {p for p in rp.pages
                  if p not in borrowed and (dev, p) in self._shared_refs}
        keep = max(0, min(int(keep_pages), len(rp.pages)))
        kept: list = []
        if self.radix is not None:
            # purge the freed tail FIRST: any node referencing one of
            # those pages loses its whole payload (a partially-freed
            # prefix is unreadable), which may un-register pages inside
            # the keep range too — retention is node-granular, so only
            # pages a surviving node still references are retained
            tail = [p for p in rp.pages[keep:]
                    if p not in borrowed and p not in sticky]
            if tail:
                self.radix.invalidate_pages(dev, tail)
            kept = [p for p in rp.pages[:keep]
                    if p not in borrowed and self.radix.owns(dev, p)]
        kept_set = set(kept)
        for p in sticky - kept_set:
            if self.radix is not None and self.radix.owns(dev, p):
                kept.append(p)      # sharer's pin keeps the node alive
            else:
                self._orphaned[dev].add(p)
                self.placer.adjust(dev, n_bytes=self.page_bytes, n_pages=1)
        kept_set = set(kept)
        freed = [p for p in rp.pages
                 if p not in kept_set and p not in borrowed
                 and p not in self._orphaned[dev]]
        if kept:
            self.placer.adjust(dev, n_bytes=len(kept) * self.page_bytes,
                               n_pages=len(kept))
            self._radix_pages[dev].update(kept)
        if freed:
            self.allocator.release(dev, freed)
        for pno in range(len(rp.pages)):
            self.directory.unpublish(request_id, pno)
        return len(kept)

    # -- radix page lifecycle ----------------------------------------------
    def _reclaim(self, evicted) -> int:
        """Return evicted prefixes' CACHE-OWNED pages to the allocator.
        Pages still backing a live request — possible when a caller
        inserted without retaining — are dropped from the index but
        stay allocated (the request's own release frees them)."""
        n_freed = 0
        for dev, pages in evicted:
            if not 0 <= dev < self.n_devices:
                continue
            owned = [p for p in pages if p in self._radix_pages[dev]]
            if not owned:
                continue
            self._radix_pages[dev].difference_update(owned)
            # a cache page a live request still refcount-shares must not
            # return to the pool under the sharer's feet: it is orphaned
            # (still allocated + booked) until the last sharer departs
            free_now = [p for p in owned
                        if (dev, p) not in self._shared_refs]
            self._orphaned[dev].update(
                p for p in owned if (dev, p) in self._shared_refs)
            if free_now:
                self.allocator.release(dev, free_now)
                self.placer.adjust(
                    dev, n_bytes=-len(free_now) * self.page_bytes,
                    n_pages=-len(free_now))
            n_freed += len(free_now)
        self.radix_evicted_pages += n_freed
        return n_freed

    def radix_evict(self, n_leaves: int = 1,
                    device: Optional[int] = None) -> int:
        """Evict up to ``n_leaves`` unpinned LRU cached prefixes
        (optionally restricted to one device) and reclaim their
        cache-owned pages.  Returns pages freed — note a 0 can also
        mean the victims' pages were live-request-backed; loops that
        need a 'nothing left to evict' signal must check the index
        (``evict_lru`` returning empty), as ``_evict_for_fit`` and
        ``evict_to_headroom`` do."""
        if self.radix is None:
            return 0
        return self._reclaim(self.radix.evict_lru(n_leaves, device=device))

    def _evictable_pages(self, device: int) -> int:
        """Cache-owned pages on ``device`` whose backing node is
        unpinned — what eviction can actually reclaim.  Pinned copies
        (a live request is reusing them) and live-request-backed pages
        must not count toward 'freeing the cache would fit it', or the
        feasibility guard drains unpinned prefixes for nothing."""
        held = self._radix_pages[device]
        if not held or self.radix is None:
            return 0
        return sum(1 for (d, p), node in self.radix.cached_pages().items()
                   if d == device and node.refs == 0 and p in held)

    def _evict_for_fit(self, n_bytes: float, n_pages: int) -> bool:
        """Placement-pressure eviction: free cached prefixes ONLY on a
        device whose EVICTABLE cache pages would actually make the
        request fit — a global LRU walk would drain healthy devices'
        caches without unblocking anything.  Evicts until that device
        fits the request (the caller retries placement); returns False
        when no device can be helped."""
        for dev in range(self.n_devices):
            evictable = self._evictable_pages(dev)
            if not evictable:
                continue
            if not (self.placer.pages_used[dev] - evictable + n_pages
                    <= self.placer.capacity_pages
                    and self.placer.bytes_used[dev]
                    - evictable * self.page_bytes + n_bytes
                    <= self.placer.capacity_bytes):
                continue        # even a fully-drained cache won't fit it
            reclaimed = 0
            while (self.placer.pages_used[dev] + n_pages
                   > self.placer.capacity_pages
                   or self.placer.bytes_used[dev] + n_bytes
                   > self.placer.capacity_bytes):
                evicted = self.radix.evict_lru(4, device=dev)
                if not evicted:
                    break       # remaining copies are pinned
                reclaimed += self._reclaim(evicted)
            if reclaimed:
                return True
        return False

    def radix_held_pages(self, device: Optional[int] = None) -> int:
        """Pages currently owned by the prefix cache (one device or all)."""
        if device is not None:
            return len(self._radix_pages[device])
        return sum(len(s) for s in self._radix_pages)

    def evict_to_headroom(self, frac: float) -> int:
        """Evict LRU cached prefixes until every device keeps at least
        ``frac`` of its pages free (finish-time pool pressure relief) —
        victims come from the PRESSURED device only.  Returns total
        pages freed; stops when nothing there is evictable."""
        if self.radix is None or frac <= 0:
            return 0
        total = 0
        for dev in range(self.n_devices):
            while (self.allocator.free_pages(dev)
                   < frac * self.allocator.pages_per_device
                   and self._radix_pages[dev]):
                # batched victims: one tree walk reclaims several
                # prefixes, instead of a full rescan per node
                evicted = self.radix.evict_lru(4, device=dev)
                if not evicted:
                    break
                total += self._reclaim(evicted)
        return total

    def note_departure(self, device: int, seconds: float) -> None:
        """Forward a finished request's measured demand share to the
        placer's pressure-keyed policies (core/placement.py)."""
        if 0 <= device < self.n_devices:
            self.placer.note_departure(device, seconds)

    # -- fabric accounting (delegates to the shared accountant) ------------
    @property
    def bytes_fetched(self) -> float:
        return self.traffic.stats.bytes_fetched

    @property
    def bytes_written(self) -> float:
        return self.traffic.stats.bytes_written

    def sparse_fetch_time(self, n_entries: int, *, device: int = 0,
                          contention: float = 1.0, key=None) -> float:
        return self.traffic.sparse_fetch(n_entries, self.entry_bytes,
                                         device=device,
                                         contention=contention, key=key)

    def prefetch_fetch_time(self, n_entries: int, *, device: int = 0,
                            contention: float = 1.0) -> float:
        """Speculative/warm-up entry fetch (fetch pipeline): same wire cost
        as a demand fetch, attributed to prefetch traffic."""
        return self.traffic.prefetch_fetch(n_entries, self.entry_bytes,
                                           device=device,
                                           contention=contention)

    def full_prefetch_time(self, n_tokens: int, *, device: int = 0,
                           contention: float = 1.0) -> float:
        n_bytes = n_tokens * self.entry_bytes * max(self.cfg.n_attn_layers, 1)
        return self.traffic.bulk_fetch(n_bytes, device=device,
                                       contention=contention)

    def write_back_time(self, n_tokens: int, *, device: int = 0,
                        contention: float = 1.0, key=None) -> float:
        n_bytes = n_tokens * self.entry_bytes * max(self.cfg.n_attn_layers, 1)
        return self.traffic.write_back(n_bytes, device=device,
                                       contention=contention, key=key)

    def device_of(self, request_id: int) -> int:
        rp = self.requests.get(request_id)
        return rp.device if rp else 0
