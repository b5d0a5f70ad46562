"""Host-RAM page swap tier (port of ``repro.serve.swap``): a preempted
request's KV pages are copied to host memory and restored at resume
instead of being recomputed from its tokens.

``SwapStore``
    A content-addressed host store keyed as the radix prefix tree is:
    page ``i`` of a sequence is keyed by ``tuple(tokens[:(i + 1) * P])``,
    so a swapped-out prefix serves any request that shares it.  A host
    page holds raw copies of every pool leaf (codes and scales of a
    quantised pool), so the round trip is lossless by construction.  A
    CRC-32 seal taken at put is verified at every match; a page that
    fails it is dropped and recomputed, never scattered back.  The store
    is a cache: an evicted or refused page costs recompute, never
    correctness.

``StagingRing``
    A bounded ring of in-flight device-to-host transactions.  Each
    transaction is one fixed-width gather of pages into a fresh device
    tensor (on the stream the forwards run on), copied without blocking
    into pinned host buffers, with one CUDA event recorded after the
    copies.  The ring keeps the gathered tensor alive and forces (waits
    on the event of) the oldest transaction once more than ``depth`` are
    in flight, so the gather of transaction ``n + 1`` is queued while
    ``n``'s copy runs.  The reference relies on JAX's immutable arrays
    for this; here the loop drains the ring before the victim's pages
    are released, so no later write can race a pending gather.

Host pages are nested dicts and lists like the pool's (``[{'b0': {'k',
'v'[, 'ks', 'vs']}}]``) with numpy leaves ``[n_layers, page_size, ...]``,
C-contiguous, bf16 leaves held as ``uint16`` views of the same bytes.
Checksums and the fault injector's draws follow JAX's leaf order
(``faults.tree_leaves``), so host pages, checksums and fault streams are
the reference's.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.faults import NULL_FAULTS, tree_leaves, tree_map

__all__ = ["HostPage", "SwapStore", "StagingRing", "page_checksum",
           "host_array", "stage_to_device"]


def page_checksum(data) -> int:
    """CRC-32 chained over a host page's leaf bytes, in JAX's leaf
    order: the seal taken at swap-out and verified at swap-in."""
    c = 0
    for a in tree_leaves(data):
        c = zlib.crc32(np.ascontiguousarray(a).tobytes(), c)
    return c


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, sharing its memory (bf16 as ``uint16``)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def stage_to_device(pages, device: torch.device) -> torch.Tensor:
    """One leaf of host pages ``[n_layers, P, ...]``, stacked on axis 1
    into a tensor on ``device`` (bf16 bytes as int16).  On the card it
    goes through a pinned buffer copied without blocking; the pinned
    allocator does not hand the buffer out again before the copy is done."""
    a0 = pages[0]
    view = np.int16 if a0.dtype == np.uint16 else a0.dtype
    if device.type != "cuda":
        return torch.from_numpy(np.stack(pages, axis=1).view(view))
    buf = torch.empty((a0.shape[0], len(pages), *a0.shape[1:]),
                      dtype=torch.from_numpy(np.empty(0, view)).dtype,
                      pin_memory=True)
    np.stack(pages, axis=1, out=buf.numpy().view(a0.dtype))
    return buf.to(device, non_blocking=True)


class HostPage:
    """One swapped-out KV page: host copies of every pool leaf,
    ``[n_layers, page_size, ...]`` each.  ``nbytes`` is its footprint in
    the budget ledgers, ``checksum`` the seal taken at store time,
    ``tenant`` the ledger it is charged to."""

    __slots__ = ("key", "data", "nbytes", "tick", "checksum", "tenant")

    def __init__(self, key: Tuple[int, ...], data, tick: int,
                 tenant: Optional[str] = None):
        self.key = key
        self.data = data
        self.nbytes = int(sum(a.nbytes for a in tree_leaves(data)))
        self.tick = tick
        self.checksum = page_checksum(data)
        self.tenant = tenant

    def verify(self) -> bool:
        """True iff the page bytes still match the store-time seal."""
        return page_checksum(self.data) == self.checksum

    def __repr__(self):  # pragma: no cover - debug aid
        return f"HostPage(len={len(self.key)}, nbytes={self.nbytes})"


class SwapStore:
    """Content-addressed host store of swapped KV pages.

    ``max_bytes`` bounds the store (0 = unbounded; puts LRU-evict until
    the page fits, a page larger than the budget is refused);
    ``tenant_budget`` bounds each tenant's bytes, and a put over it
    evicts that tenant's own LRU pages only.  ``faults`` is the seeded
    injector: ``swap_put`` refuses a put, ``swap_corrupt`` flips a byte
    of a stored page after its seal."""

    def __init__(self, page_size: int, max_bytes: int = 0,
                 tenant_budget: int = 0, faults=None):
        self.page_size = int(page_size)
        self.max_bytes = int(max_bytes)
        self.tenant_budget = int(tenant_budget)
        self.faults = NULL_FAULTS if faults is None else faults
        self.entries: Dict[Tuple[int, ...], HostPage] = {}
        self.bytes = 0
        self.tenant_bytes: Dict[str, int] = {}
        self._tick = 0
        self.puts = 0
        self.dup_puts = 0
        self.refused_puts = 0
        self.hit_blocks = 0
        self.miss_lookups = 0
        self.evicted_pages = 0
        self.evicted_bytes = 0
        self.corrupt_dropped = 0      # pages that failed their verify
        self.corrupt_dropped_bytes = 0
        self.purged_pages = 0         # cancel and deadline purges
        self.purged_bytes = 0

    def __len__(self) -> int:
        return len(self.entries)

    def _key(self, tokens, i: int) -> Tuple[int, ...]:
        return tuple(int(t) for t in tokens[: (i + 1) * self.page_size])

    # -- writes ---------------------------------------------------------

    def put(self, tokens, i: int, data, tenant: Optional[str] = None) -> bool:
        """Store host page ``data`` as block ``i`` of ``tokens``.  True
        if the page is resident afterwards (a duplicate only refreshes
        its LRU tick and stays charged to its first putter), False if the
        budget or an injected fault refused it."""
        if self.faults.fire("swap_put"):
            self.refused_puts += 1
            return False
        key = self._key(tokens, i)
        self._tick += 1
        hit = self.entries.get(key)
        if hit is not None:
            hit.tick = self._tick
            self.dup_puts += 1
            return True
        page = HostPage(key, data, self._tick, tenant=tenant)
        if self.tenant_budget and tenant is not None:
            if page.nbytes > self.tenant_budget:
                self.refused_puts += 1
                return False
            self._evict_tenant_to(tenant, self.tenant_budget - page.nbytes)
        if self.max_bytes:
            if page.nbytes > self.max_bytes:
                self.refused_puts += 1
                return False
            self._evict_to(self.max_bytes - page.nbytes)
        self.entries[key] = page
        self.bytes += page.nbytes
        if tenant is not None:
            self.tenant_bytes[tenant] = \
                self.tenant_bytes.get(tenant, 0) + page.nbytes
        self.puts += 1
        if self.faults.fire("swap_corrupt"):
            # torn write after the seal: the verify at match must see it
            self.faults.corrupt(page.data)
        return True

    def _drop(self, key: Tuple[int, ...]) -> HostPage:
        """Remove one entry; every removal keeps both ledgers exact."""
        page = self.entries.pop(key)
        self.bytes -= page.nbytes
        if page.tenant is not None:
            left = self.tenant_bytes[page.tenant] - page.nbytes
            if left:
                self.tenant_bytes[page.tenant] = left
            else:
                del self.tenant_bytes[page.tenant]
        return page

    def _evict_to(self, budget: int) -> int:
        """LRU-evict whole pages until ``bytes <= budget``."""
        n = 0
        while self.bytes > budget and self.entries:
            key = min(self.entries, key=lambda k: self.entries[k].tick)
            page = self._drop(key)
            self.evicted_pages += 1
            self.evicted_bytes += page.nbytes
            n += 1
        return n

    def _evict_tenant_to(self, tenant: str, budget: int) -> int:
        """LRU-evict ``tenant``'s own pages until its ledger fits."""
        n = 0
        while self.tenant_bytes.get(tenant, 0) > budget:
            keys = [k for k, p in self.entries.items() if p.tenant == tenant]
            key = min(keys, key=lambda k: self.entries[k].tick)
            page = self._drop(key)
            self.evicted_pages += 1
            self.evicted_bytes += page.nbytes
            n += 1
        return n

    def purge(self, tokens, n_blocks: int) -> Tuple[int, int]:
        """Drop blocks ``[0, n_blocks)`` of this token history (a
        cancelled or expired swapped-out request), skipping missing ones.
        Returns ``(pages, bytes)`` removed."""
        pages = nbytes = 0
        for i in range(n_blocks):
            key = self._key(tokens, i)
            if key not in self.entries:
                continue
            page = self._drop(key)
            pages += 1
            nbytes += page.nbytes
        self.purged_pages += pages
        self.purged_bytes += nbytes
        return pages, nbytes

    # -- reads ----------------------------------------------------------

    def match(self, tokens, start_block: int = 0) -> List[HostPage]:
        """The longest run of consecutive stored blocks from
        ``start_block``.  Every page is verified against its seal; a page
        that fails is dropped (``corrupt_dropped``) and ends the run.
        Matching refreshes LRU ticks."""
        n_blocks = len(tokens) // self.page_size
        out: List[HostPage] = []
        for i in range(start_block, n_blocks):
            key = self._key(tokens, i)
            page = self.entries.get(key)
            if page is None:
                break
            if not page.verify():
                self._drop(key)
                self.corrupt_dropped += 1
                self.corrupt_dropped_bytes += page.nbytes
                break
            self._tick += 1
            page.tick = self._tick
            out.append(page)
        if out:
            self.hit_blocks += len(out)
        else:
            self.miss_lookups += 1
        return out

    # -- bookkeeping -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "pages": len(self.entries),
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "tenant_budget": self.tenant_budget,
            "tenant_bytes": dict(self.tenant_bytes),
            "puts": self.puts,
            "dup_puts": self.dup_puts,
            "refused_puts": self.refused_puts,
            "hit_blocks": self.hit_blocks,
            "miss_lookups": self.miss_lookups,
            "evicted_pages": self.evicted_pages,
            "evicted_bytes": self.evicted_bytes,
            "corrupt_dropped": self.corrupt_dropped,
            "corrupt_dropped_bytes": self.corrupt_dropped_bytes,
            "purged_pages": self.purged_pages,
            "purged_bytes": self.purged_bytes,
        }

    def check(self) -> None:
        """Ledger invariants (checksums are not re-verified: a torn page
        stays resident until a match drops it)."""
        ledger = sum(p.nbytes for p in self.entries.values())
        assert ledger == self.bytes, \
            f"swap byte ledger drift: {self.bytes} != {ledger}"
        tled: Dict[str, int] = {}
        for p in self.entries.values():
            if p.tenant is not None:
                tled[p.tenant] = tled.get(p.tenant, 0) + p.nbytes
        assert tled == self.tenant_bytes, \
            f"tenant byte ledger drift: {self.tenant_bytes} != {tled}"
        if self.tenant_budget:
            for t, b in self.tenant_bytes.items():
                assert b <= self.tenant_budget, \
                    f"tenant {t!r} over swap budget: {b} > " \
                    f"{self.tenant_budget}"
        if self.max_bytes:
            assert self.bytes <= self.max_bytes, \
                f"swap store over budget: {self.bytes} > {self.max_bytes}"
        for key, page in self.entries.items():
            assert len(key) % self.page_size == 0 and len(key) > 0, \
                f"swap key length {len(key)} not a page multiple"
            assert page.key == key


class StagingRing:
    """Bounded ring of in-flight device-to-host transactions.

    ``stage(meta, device_tree)`` starts the copies of one transaction
    (CUDA leaves into pinned buffers, one event after them) and returns
    the transactions that matured as ``(meta, host_tree)`` pairs with
    numpy leaves; ``drain`` forces the rest.  CPU leaves are already on
    the host."""

    def __init__(self, width: int, depth: int = 2):
        assert width >= 1 and depth >= 1
        self.width = int(width)     # pages per transaction
        self.depth = int(depth)
        self._ring: List[tuple] = []
        self.transactions = 0

    @staticmethod
    def _start(device_tree):
        cuda = [t for t in tree_leaves(device_tree) if t.is_cuda]
        if not cuda:
            return device_tree, None

        def copy(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h
        host = tree_map(copy, device_tree)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(cuda[0].device))
        return host, done

    @staticmethod
    def _force(item):
        meta, _dev, host, done = item     # _dev stays alive until here
        if done is not None:
            done.synchronize()
        return meta, tree_map(host_array, host)

    def stage(self, meta, device_tree) -> List[tuple]:
        """Enqueue one transaction; return any that matured to host."""
        host, done = self._start(device_tree)
        self._ring.append((meta, device_tree, host, done))
        self.transactions += 1
        out = []
        while len(self._ring) > self.depth:
            out.append(self._force(self._ring.pop(0)))
        return out

    def drain(self) -> List[tuple]:
        out = [self._force(it) for it in self._ring]
        self._ring.clear()
        return out
