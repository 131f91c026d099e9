"""Radix prefix cache over pool pages (paper §A.3: custom Radix Cache
integration within HiSparse; KV fully offloaded to the pool backend).

Token sequences are interned in a radix tree whose edges carry token-id
chunks; every *paged* node maps a page-aligned prefix to the pool pages
(real :class:`~repro_torch.core.metadata.PoolAllocator` ids) that back it.
Lookup returns the longest cached prefix so prefill can skip
recomputation of the matched tokens and the fabric write of the matched
pages (Round-2 "cache hit" scenario = full hit) — reuse is only valid on
the device the pages live on, which is what the ``radix_affinity``
placement policy (core/placement.py) trades against link pressure.

Lifecycle contract (the PR 5 correctness property, tests/test_radix.py):

  - ``insert`` registers a request's **actual** pool pages and reports
    whether it took them (an identical prefix already cached keeps the
    first copy; the caller then must NOT hand those pages over);
  - ``pin``/``release`` refcount a matched path for a request's
    lifetime; **eviction never drops a pinned prefix**, and an edge
    split inherits the refcount so pin/release walks stay balanced
    across structural changes;
  - ``evict_lru`` drops unpinned LRU leaves and *returns* the freed
    (device, pages) so the owner (``SACSystem``) can return them to the
    allocator — and it re-merges/cleans the page-less split nodes left
    behind, so the node count stays bounded by the live paths;
  - ``invalidate_pages`` purges every node whose backing pages the pool
    just freed — the index never returns a (device, pages) tuple the
    ``PoolAllocator`` considers free, under ANY interleaving of
    admit/finish/evict (hypothesis-tested).

A node's ``pages`` list is cumulative: it covers the node's FULL prefix
from the root (each request writes its own copy of the whole prefix, so
one allocation backs one node — page ids are never shared between
nodes).  ``match`` therefore reports the deepest paged node's (device,
pages) as the reusable unit, with the match length rounded DOWN to page
granularity — a raw edge walk can overshoot into page-less split nodes,
and crediting those tokens would count reuse no page actually backs.

PR 6 adds hot-prefix REPLICATION: a paged node can carry full copies of
its page list on other devices (``add_replica``), all registered in the
same owner map and reported by ``match`` through ``MatchResult.copies``
so placement can pick the cheapest copy.  Replicas are second-class on
the way out: per-device eviction drops them before primaries, a primary
whose pages are evicted/invalidated promotes its hottest surviving
replica, and only the loss of the LAST copy kills the node's payload —
a cached prefix always retains one primary.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class _Node:
    node_id: int
    edge: Tuple[int, ...] = ()                    # tokens on the edge in
    pages: List[int] = dataclasses.field(default_factory=list)
    device: int = -1
    children: Dict[int, "_Node"] = dataclasses.field(default_factory=dict)
    parent: Optional["_Node"] = None
    refs: int = 0
    last_use: float = 0.0
    # PR 6 hot-prefix replication: additional full copies of this node's
    # cumulative page list on OTHER devices (device -> page list), each
    # with its own LRU stamp so replica eviction is per-copy.  The
    # (pages, device) pair above stays the PRIMARY copy — a paged node
    # always retains one primary (eviction promotes a replica first).
    replicas: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    replica_use: Dict[int, float] = dataclasses.field(default_factory=dict)

    def depth_tokens(self) -> int:
        n, d = self, 0
        while n is not None:
            d += len(n.edge)
            n = n.parent
        return d


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """One prefix lookup: raw walk length vs the page-backed reuse."""

    tokens: int                 # raw matched tokens (token-granular walk,
                                # may end mid-edge)
    paged_tokens: int           # page-granular reusable prefix length
    device: int                 # device of the backing node (-1: none)
    pages: List[int]            # backing pages covering the matched
                                # prefix (a leading slice of the backing
                                # node's cumulative page list)
    pin_tokens: Tuple[int, ...] = ()
                                # the BACKING node's full token prefix —
                                # what a caller must pin to keep the
                                # reused pages alive (the backing node
                                # may sit deeper than the match point)
    copies: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
                                # EVERY device holding a copy of the
                                # backing node -> that copy's FULL page
                                # list (primary + replicas); ``device``/
                                # ``pages`` above remain the primary's
                                # matched slice for back-compat

    @property
    def hit(self) -> bool:
        return self.paged_tokens > 0


class RadixIndex:
    """page_size-granular radix tree: prefix tokens -> (device, pages)."""

    def __init__(self, page_size: int = 16):
        self.page_size = page_size
        self.root = _Node(0)
        self._ids = itertools.count(1)
        self._clock = itertools.count(1)
        # (device, page) -> the one node whose pages list contains it
        # (page ids come from per-request allocations, so no sharing)
        self._page_owner: Dict[Tuple[int, int], _Node] = {}

    # -- lookup ---------------------------------------------------------------
    def _walk(self, tokens: Sequence[int]) -> Tuple[int, List[_Node]]:
        """Longest whole-edge walk; returns (tokens matched, path nodes)."""
        node = self.root
        i = 0
        path: List[_Node] = []
        toks = tuple(tokens)
        while True:
            nxt = node.children.get(toks[i]) if i < len(toks) else None
            if nxt is None:
                break
            el = len(nxt.edge)
            if toks[i:i + el] != nxt.edge:
                break
            i += el
            node = nxt
            node.last_use = next(self._clock)
            path.append(node)
        return i, path

    def _prefix_tokens(self, node: _Node) -> Tuple[int, ...]:
        parts = []
        while node is not None and node is not self.root:
            parts.append(node.edge)
            node = node.parent
        return tuple(t for edge in reversed(parts) for t in edge)

    @staticmethod
    def _best_paged(sub_root: _Node) -> Optional[_Node]:
        """Hottest paged node in a subtree (every node below the match
        point shares the matched prefix, so any of their cumulative page
        lists backs it — prefer the most recently used copy)."""
        best = None
        stack = [sub_root]
        while stack:
            n = stack.pop()
            if n.pages and (best is None or n.last_use > best.last_use):
                best = n
            stack.extend(n.children.values())
        return best

    def match(self, tokens: Sequence[int]) -> MatchResult:
        """Longest cached prefix with its page backing.

        The walk is TOKEN-granular: it descends whole matching edges and
        then extends into the next edge as far as tokens agree (a shared
        prefix that diverges mid-edge — the common case before any split
        exists — still matches).  The page backing comes from the
        hottest paged node at or below the match point: every node in
        that subtree shares the matched prefix, and its cumulative page
        list's leading slice covers it.  ``paged_tokens`` rounds the
        match DOWN to page granularity — reuse is page-granular, and the
        pre-PR 5 accounting credited split-node tokens no page backs.
        ``pin_tokens`` is the backing node's own prefix: pinning it (not
        just the matched tokens) is what keeps the reused pages alive,
        since the backing copy may sit deeper than the match point.
        """
        node = self.root
        i = 0
        toks = tuple(tokens)
        sub_root = self.root
        while True:
            nxt = node.children.get(toks[i]) if i < len(toks) else None
            if nxt is None:
                sub_root = node
                break
            el = len(nxt.edge)
            common = 0
            while (common < el and i + common < len(toks)
                   and nxt.edge[common] == toks[i + common]):
                common += 1
            i += common
            if common < el:
                # diverged (or query exhausted) mid-edge: everything
                # under nxt still shares the first i tokens
                sub_root = nxt
                break
            node = nxt
            node.last_use = next(self._clock)
        if sub_root is self.root:
            return MatchResult(i, 0, -1, [])
        backing = self._best_paged(sub_root)
        if backing is None:
            return MatchResult(i, 0, -1, [])
        paged = (i // self.page_size) * self.page_size
        paged = min(paged, len(backing.pages) * self.page_size)
        if paged <= 0:
            return MatchResult(i, 0, -1, [])
        backing.last_use = next(self._clock)
        copies = {backing.device: list(backing.pages)}
        for dev, pgs in backing.replicas.items():
            copies[dev] = list(pgs)
        return MatchResult(i, paged, backing.device,
                           list(backing.pages[:paged // self.page_size]),
                           self._prefix_tokens(backing), copies)

    def match_prefix(self, tokens: Sequence[int]
                     ) -> Tuple[int, List[Tuple[int, List[int]]]]:
        """Legacy tuple API: (raw tokens matched, [(device, pages), ...]
        along the path).  Prefer :meth:`match` — it reports the
        page-granular reuse the serving layers must account."""
        i, path = self._walk(tokens)
        return i, [(n.device, list(n.pages)) for n in path if n.pages]

    # -- insert ---------------------------------------------------------------
    def insert(self, tokens: Sequence[int], device: int, pages: List[int]
               ) -> int:
        """Register ``tokens`` (page-aligned length) as cached by ``pages``.

        Returns the number of pages the index actually took: ``0`` when
        an identical prefix is already cached (the first copy wins — the
        caller keeps ownership of ``pages``), else ``len(pages)`` (the
        caller must keep those pages allocated until the index gives
        them back through ``evict_lru`` or ``invalidate_pages``).
        """
        toks = tuple(tokens)
        assert len(toks) % self.page_size == 0, "insert page-aligned prefixes"
        if not toks:
            return 0
        node = self.root
        i = 0
        while i < len(toks):
            nxt = node.children.get(toks[i])
            if nxt is None:
                child = _Node(next(self._ids), edge=toks[i:], parent=node)
                node.children[toks[i]] = child
                node = child
                i = len(toks)
                break
            # walk common prefix of edge
            el = len(nxt.edge)
            common = 0
            while (common < el and i + common < len(toks)
                   and nxt.edge[common] == toks[i + common]):
                common += 1
            if common == el:
                node = nxt
                i += el
                continue
            # split edge at `common`; the mid node inherits the refcount
            # so a pin taken before the split still releases balanced
            # (pin/release walk EVERY node on the path)
            mid = _Node(next(self._ids), edge=nxt.edge[:common], parent=node,
                        refs=nxt.refs, last_use=nxt.last_use)
            node.children[toks[i]] = mid
            nxt.edge = nxt.edge[common:]
            nxt.parent = mid
            mid.children[nxt.edge[0]] = nxt
            # pages stay with the deeper node (they cover its full prefix)
            node = mid
            i += common
        node.last_use = next(self._clock)
        if node.pages:
            return 0        # identical prefix already cached: keep it
        node.pages = list(pages)
        node.device = device
        for p in pages:
            assert (device, p) not in self._page_owner, \
                f"page {(device, p)} already backs node " \
                f"{self._page_owner[(device, p)].node_id}"
            self._page_owner[(device, p)] = node
        return len(pages)

    def _find_paged(self, tokens: Sequence[int]) -> Optional[_Node]:
        """The paged node whose full prefix is exactly ``tokens`` (whole-
        edge walk ending on a node boundary), or None."""
        toks = tuple(tokens)
        node = self.root
        i = 0
        while i < len(toks):
            nxt = node.children.get(toks[i])
            if nxt is None or toks[i:i + len(nxt.edge)] != nxt.edge:
                return None
            i += len(nxt.edge)
            node = nxt
        return node if (node is not self.root and node.pages) else None

    def add_replica(self, tokens: Sequence[int], device: int,
                    pages: List[int]) -> int:
        """Register ``pages`` as a full copy of the prefix ``tokens`` on
        another ``device`` (hot-prefix replication, PR 6).

        Returns the pages taken (0 if the prefix is not cached as an
        exact paged node, the device already holds a copy, or the page
        count does not mirror the primary's) — the caller keeps
        ownership on 0, hands it over otherwise (pages come back through
        ``evict_lru`` / ``invalidate_pages`` like primary pages)."""
        node = self._find_paged(tokens)
        if (node is None or node.device == device
                or device in node.replicas
                or len(pages) != len(node.pages)):
            return 0
        for p in pages:
            assert (device, p) not in self._page_owner, \
                f"replica page {(device, p)} already backs node " \
                f"{self._page_owner[(device, p)].node_id}"
        node.replicas[device] = list(pages)
        node.replica_use[device] = next(self._clock)
        for p in pages:
            self._page_owner[(device, p)] = node
        return len(pages)

    # -- pin / release --------------------------------------------------------
    def pin(self, tokens: Sequence[int]) -> None:
        self._walk_refs(tokens, +1)

    def release(self, tokens: Sequence[int]) -> None:
        self._walk_refs(tokens, -1)

    def _walk_refs(self, tokens: Sequence[int], delta: int) -> None:
        node = self.root
        i = 0
        toks = tuple(tokens)
        while i < len(toks):
            nxt = node.children.get(toks[i])
            if nxt is None or toks[i:i + len(nxt.edge)] != nxt.edge:
                break
            nxt.refs = max(0, nxt.refs + delta)
            i += len(nxt.edge)
            node = nxt

    # -- eviction / invalidation ----------------------------------------------
    def _drop_payload(self, node: _Node) -> List[Tuple[int, List[int]]]:
        """Forget a node's ENTIRE page backing — the primary copy and
        every replica (owner-map consistent).  Returns freed
        (device, pages) tuples, one per copy."""
        freed: List[Tuple[int, List[int]]] = []
        for dev in list(node.replicas):
            got = self._drop_replica(node, dev)
            if got is not None:
                freed.append(got)
        if node.pages:
            freed.append((node.device, node.pages))
            for p in node.pages:
                self._page_owner.pop((node.device, p), None)
            node.pages = []
            node.device = -1
        return freed

    def _drop_replica(self, node: _Node, device: int
                      ) -> Optional[Tuple[int, List[int]]]:
        """Forget one replica copy; the primary (and the node) survive."""
        pages = node.replicas.pop(device, None)
        node.replica_use.pop(device, None)
        if pages is None:
            return None
        for p in pages:
            self._page_owner.pop((device, p), None)
        return (device, pages)

    def _promote_replica(self, node: _Node) -> bool:
        """Make the hottest replica the node's primary copy (called when
        the primary's pages are being evicted/invalidated but replicas
        survive — a prefix always retains one primary).  The owner map
        needs no update: replica pages already point at this node."""
        if not node.replicas:
            return False
        dev = max(node.replicas, key=lambda d: node.replica_use.get(d, 0.0))
        node.pages = node.replicas.pop(dev)
        node.device = dev
        node.replica_use.pop(dev, None)
        return True

    def _cleanup(self, node: Optional[_Node]) -> None:
        """Re-merge / remove the structural debris a removal leaves:
        walking up from ``node``, drop page-less childless unpinned
        nodes, and fold a page-less unpinned single-child node into its
        child (edge concat) — the split-node leak of the pre-PR 5
        ``evict_lru``, which kept every dead mid node forever."""
        while node is not None and node is not self.root:
            parent = node.parent
            if not node.pages and node.refs == 0:
                if not node.children:
                    parent.children.pop(node.edge[0], None)
                elif len(node.children) == 1:
                    (child,) = node.children.values()
                    child.edge = node.edge + child.edge
                    child.parent = parent
                    parent.children[child.edge[0]] = child
            node = parent

    def evict_lru(self, n_leaves: int = 1, *, device: Optional[int] = None
                  ) -> List[Tuple[int, List[int]]]:
        """Drop up to n unpinned LRU leaves; returns freed (device, pages).

        A pinned prefix (any node with refs > 0 on its path) is never
        dropped — pins protect ancestors by construction, since a pin
        walk increments every node down the path.

        ``device`` restricts victims to unpinned COPIES on that device —
        a replica, or a primary, on a leaf or an interior node (pool-
        pressure relief must not drain healthy devices' caches; a global
        LRU walk would evict the cluster's coldest prefixes first no
        matter whose budget is blocked).  Replicas evict FIRST (cheapest
        relief: the node keeps its primary and stays matchable) and a
        primary with surviving replicas is only demoted — its pages free
        and the hottest replica is promoted, so a prefix always retains
        one primary.  Without ``device``, any unpinned leaf — including
        page-less debris — qualifies (its replicas go with it), which is
        what collapses the tree on drain.
        """
        freed: List[Tuple[int, List[int]]] = []
        evicted = 0
        while evicted < n_leaves:
            # ONE tree walk per batch (not per victim): collect every
            # candidate, sort LRU-first, evict up to the budget.
            # Evicting one candidate never invalidates another — cleanup
            # only removes/merges page-less refs-0 nodes (never
            # candidates), and a promotion moves a copy from a DIFFERENT
            # device, never another candidate of this batch's device.
            if device is None:
                cands = [(1, n.last_use, n) for n in self._all_nodes()
                         if not n.children and n.refs == 0
                         and n is not self.root]
            else:
                cands = []
                for n in self._all_nodes():
                    if n is self.root or n.refs != 0:
                        continue
                    if device in n.replicas:
                        cands.append((0, n.replica_use.get(device, 0.0), n))
                    elif n.pages and n.device == device:
                        cands.append((1, n.last_use, n))
            if not cands:
                break
            cands.sort(key=lambda c: (c[0], c[1]))
            for is_primary, _, victim in cands[:n_leaves - evicted]:
                if device is not None and not is_primary:
                    got = self._drop_replica(victim, device)
                    if got is not None:
                        freed.append(got)
                elif device is not None and victim.replicas:
                    # demote the primary: free its pages, promote the
                    # hottest replica — node structure untouched
                    freed.append((victim.device, victim.pages))
                    for p in victim.pages:
                        self._page_owner.pop((victim.device, p), None)
                    victim.pages = []
                    victim.device = -1
                    self._promote_replica(victim)
                else:
                    freed.extend(self._drop_payload(victim))
                    if not victim.children:
                        parent = victim.parent
                        if parent is not None:
                            parent.children.pop(victim.edge[0], None)
                        self._cleanup(parent)
                    else:
                        self._cleanup(victim)
                evicted += 1
            if device is None and evicted < n_leaves:
                continue    # leaf eviction exposes new leaves: re-walk
            break
        return freed

    def invalidate_pages(self, device: int, pages: Iterable[int]
                         ) -> int:
        """Purge every node backed by any of these (freed) pool pages.

        Called by the pool owner the moment it frees pages a request
        left behind, so the index can never hand out a (device, pages)
        tuple the allocator considers free.  Invalidation is per COPY:
        a freed replica page drops only that replica (the primary and
        the node survive); a freed primary page drops the primary's
        whole pages list (partially freed prefixes are unreadable) and
        promotes a surviving replica if any — only a node whose LAST
        copy is invalidated loses its payload and gets the structural
        cleanup.  Returns nodes that lost at least one copy.
        """
        victims: Dict[int, list] = {}   # id(node) -> [node, primary?, devs]
        for p in pages:
            node = self._page_owner.get((device, p))
            if node is None:
                continue
            ent = victims.setdefault(id(node), [node, False, set()])
            if node.device == device:
                ent[1] = True
            elif device in node.replicas:
                ent[2].add(device)
        for node, primary_hit, rep_devs in victims.values():
            for d in rep_devs:
                self._drop_replica(node, d)
            if not primary_hit:
                continue
            for p in node.pages:
                self._page_owner.pop((node.device, p), None)
            node.pages = []
            node.device = -1
            if self._promote_replica(node):
                continue
            if not node.children and node.refs == 0:
                if node.parent is not None:
                    node.parent.children.pop(node.edge[0], None)
                self._cleanup(node.parent)
            else:
                self._cleanup(node)
        return len(victims)

    # -- introspection --------------------------------------------------------
    def _all_nodes(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def owns(self, device: int, page: int) -> bool:
        """True iff some node's payload currently references this page."""
        return (device, page) in self._page_owner

    def replica_pages(self, device: Optional[int] = None) -> int:
        """Pages held by replica (non-primary) copies, one device or all."""
        return sum(len(p) for n in self._all_nodes()
                   for d, p in n.replicas.items()
                   if device is None or d == device)

    def n_nodes(self) -> int:
        """Node count excluding the root (boundedness invariant)."""
        return sum(1 for _ in self._all_nodes()) - 1

    def n_paged_nodes(self) -> int:
        return sum(1 for n in self._all_nodes() if n.pages)

    def cached_pages(self) -> Dict[Tuple[int, int], "_Node"]:
        """Live (device, page) -> node map (the owner index)."""
        return dict(self._page_owner)

    def n_cached_tokens(self) -> int:
        return sum(len(n.pages) * self.page_size for n in self._all_nodes())
