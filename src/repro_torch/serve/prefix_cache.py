"""Radix-tree prefix cache: content-addressed sharing of paged KV (port
of ``repro.serve.prefix_cache``; framework-free, a copy of the
reference's).

Each node owns ONE physical page of the paged pool and is keyed by the
``page_size`` tokens that page covers; the path from the root spells the
token history ``[0, depth * page_size)``.  K/V at position ``p`` is a
function of the tokens ``[0, p]`` (causal attention, absolute rotary), so
a matched node's page equals what a fresh prefill would write: the serve
loop maps it read-only into a new slot and skips that prefill.

Pages are ref-counted by the loop's ``PageManager``: the tree holds one
reference per node (taken over at ``insert``, or the offered page is
released when a node already exists); a slot mapping a cached page holds
one more (``lock``).  ``evict`` removes only LRU leaves whose refcount is
exactly the tree's, so a page a slot reads is never reclaimed.

The tree is also where a preempted slot's written pages park (keyed by
prompt + generated tokens): under pressure ``evict`` reclaims them and
the resume recomputes; otherwise the resume's ``match`` maps them back
and the replay shrinks to a suffix prefill.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.serve import telemetry


class RadixNode:
    """One cached page: ``key`` = the page's tokens, path = history."""

    __slots__ = ("key", "page_id", "parent", "children", "tick")

    def __init__(self, key: Tuple[int, ...], page_id: int,
                 parent: Optional["RadixNode"]):
        self.key = key
        self.page_id = page_id
        self.parent = parent
        self.children: dict = {}
        self.tick = 0


class PrefixCache:
    """Token-keyed radix tree over a ref-counted page pool.

    ``max_pages`` (0 = unbounded) caps the pages the tree keeps; past it,
    LRU leaves are evicted after each insert.  Under pool pressure the
    serve loop also calls ``evict`` directly.  ``tel`` (the loop's
    telemetry facade, ``telemetry.NULL`` when None) records each eviction
    as a ``prefix_evict`` event."""

    def __init__(self, page_size: int, pages, max_pages: int = 0,
                 tel=None):
        self.P = page_size
        self.pages = pages                    # serve.paged.PageManager
        self.max_pages = max_pages
        self.tel = tel if tel is not None else telemetry.NULL
        self.root = RadixNode((), -1, None)   # sentinel: owns no page
        self.n_nodes = 0
        self._tick = 0
        self.hit_blocks = 0       # matched pages across admitted lookups
        self.miss_blocks = 0      # full prompt pages that missed
        self.inserted = 0         # nodes created
        self.deduped = 0          # insert found the page already cached
        self.evicted = 0          # nodes evicted
        self.locks = 0            # slot map-references taken on matches

    # -- lookup -------------------------------------------------------------

    def _touch(self, node: RadixNode) -> None:
        self._tick += 1
        node.tick = self._tick

    def _page_key(self, prompt: Sequence[int], i: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in prompt[i * self.P:(i + 1) * self.P])

    def match(self, prompt: Sequence[int],
              record: bool = True) -> List[RadixNode]:
        """Longest cached page-aligned prefix of ``prompt`` as its node
        path (``[n]`` maps block ``n``).  Touches the nodes (MRU) but
        takes no reference: ``lock`` before anything can evict.
        ``record=False`` skips the hit/miss stats (a blocked head
        re-matches every round)."""
        out: List[RadixNode] = []
        node = self.root
        for i in range(len(prompt) // self.P):
            child = node.children.get(self._page_key(prompt, i))
            if child is None:
                break
            out.append(child)
            node = child
        if record:
            self.record_lookup(len(out), len(prompt) // self.P - len(out))
        for n in out:
            self._touch(n)
        return out

    def record_lookup(self, hits: int, misses: int) -> None:
        self.hit_blocks += hits
        self.miss_blocks += misses

    def lock(self, nodes: List[RadixNode]) -> None:
        """One page reference per matched node for a slot about to map
        them (released by the loop at finish)."""
        self.pages.retain([n.page_id for n in nodes])
        self.locks += len(nodes)

    # -- insert / merge -----------------------------------------------------

    def insert(self, prompt: Sequence[int], page_ids: Sequence[int]) -> int:
        """Insert the first ``len(page_ids)`` full pages of ``prompt``.
        Each offered page reference transfers to the tree: a new node
        keeps the page; an existing node keeps its own and the offered
        one is released.  Returns the number of new nodes."""
        node = self.root
        new = 0
        for i, pid in enumerate(page_ids):
            key = self._page_key(prompt, i)
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, int(pid), node)
                node.children[key] = child
                self.n_nodes += 1
                self.inserted += 1
                new += 1
            else:
                self.pages.release([int(pid)])
                self.deduped += 1
            self._touch(child)
            node = child
        if self.max_pages and self.n_nodes > self.max_pages:
            self.evict(self.n_nodes - self.max_pages)
        return new

    # -- eviction -----------------------------------------------------------

    def _evictable_leaves(self) -> List[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.children \
                    and self.pages.refcnt[n.page_id] == 1:
                out.append(n)
        return out

    def evictable(self) -> int:
        """Pages ``evict`` can reclaim now: nodes whose whole subtree is
        held by the tree alone (refcount 1 throughout)."""
        def walk(node: RadixNode):
            size, child_rec = 1, 0
            fully = self.pages.refcnt[node.page_id] == 1
            for c in node.children.values():
                cs, cr, cf = walk(c)
                size += cs
                child_rec += cr
                fully = fully and cf
            return size, (size if fully else child_rec), fully

        return sum(walk(c)[1] for c in self.root.children.values())

    def evict(self, n: int) -> int:
        """Free up to ``n`` pages by evicting LRU unreferenced leaves (a
        parent stripped of its last child joins the next round).
        Returns the pages freed."""
        freed = 0
        while freed < n:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            take = sorted(leaves, key=lambda nd: nd.tick)[: n - freed]
            for victim in take:
                del victim.parent.children[victim.key]
                self.pages.release([victim.page_id])
                self.n_nodes -= 1
                self.evicted += 1
                freed += 1
        if freed:
            self.tel.event("prefix_evict", pages=freed,
                           nodes_left=self.n_nodes)
        return freed

    # -- introspection ------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        total = self.hit_blocks + self.miss_blocks
        return self.hit_blocks / total if total else 0.0

    def stats(self) -> dict:
        return {
            "nodes": self.n_nodes,
            "hit_blocks": self.hit_blocks,
            "miss_blocks": self.miss_blocks,
            "hit_rate": self.hit_rate,
            "inserted": self.inserted,
            "deduped": self.deduped,
            "evicted": self.evicted,
            "locks": self.locks,
        }

    def check(self) -> None:
        """Every node's page is live (refcount >= 1), no page twice, the
        node count matches, and no node owns the scratch page."""
        seen = set()
        stack = list(self.root.children.values())
        count = 0
        while stack:
            n = stack.pop()
            count += 1
            assert n.page_id != 0, "tree owns the scratch page"
            assert n.page_id not in seen, "duplicate page in tree"
            seen.add(n.page_id)
            assert self.pages.refcnt[n.page_id] >= 1, \
                f"tree page {n.page_id} has no reference"
            assert n.parent.children.get(n.key) is n, "broken parent link"
            stack.extend(n.children.values())
        assert count == self.n_nodes, (count, self.n_nodes)
