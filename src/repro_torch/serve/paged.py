"""Paged continuous-batching serve loop (port of the core of
``repro.serve.paged``).

Every attention layer's K/V lives in a paged pool; a request owns a list
of pages recorded in its slot's block-table row.  Prompts are prefilled
in fixed-size chunks; each decode step advances every live slot by one
token at its own position, and a slot freed by a finished request is
refilled from the queue at once (continuous batching).

This core admits FIFO with reserved (worst-case) page accounting: a
request's prompt plus its whole ``max_new_tokens`` budget is allocated
at admission, so the pool can never run dry mid-decode.  Prefix cache,
speculation, priorities, preemption, swap, fault injection and
telemetry are not ported yet.

Physical page 0 is the scratch page: pinned, never handed out; idle
slots' decode writes land there and freed rows are reset to it.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels.paged import PageSpec, spec_for
from repro_torch.models import lm
from repro_torch.serve.loop import Request


class AdmissionError(ValueError):
    """A request that can never be served (rejected at submit)."""


class PoolExhaustedError(RuntimeError):
    """Every slot is free and the queue head still gets no pages."""


class PageManager:
    """Host-side ref-counted physical-page pool; page 0 is the pinned
    scratch page.  ``release`` frees a page at refcount 0; double frees
    and frees of the scratch page raise."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free = deque(range(1, n_pages))
        self.refcnt = np.zeros(n_pages, np.int64)
        self.refcnt[0] = 1
        self.peak = 0
        self.exhaustions = 0

    @property
    def in_use(self) -> int:
        return self.n_pages - 1 - len(self.free)

    @property
    def available(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self.free):
            self.exhaustions += 1
            return None
        pages = [self.free.popleft() for _ in range(n)]
        for p in pages:
            if self.refcnt[p] != 0:
                raise AssertionError(
                    f"free list corrupt: page {p} has refcount "
                    f"{self.refcnt[p]}")
            self.refcnt[p] = 1
        self.peak = max(self.peak, self.in_use)
        return pages

    def release(self, pages: List[int]) -> None:
        for p in pages:
            p = int(p)
            if p == 0:
                raise ValueError("release of scratch page 0")
            if self.refcnt[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self.refcnt[p] -= 1
            if self.refcnt[p] == 0:
                self.free.append(p)

    def check(self) -> None:
        """Pages 1..n-1 partition into {free, refcount 0} and {off-list,
        refcount >= 1}; the scratch page is pinned and never listed."""
        free = list(self.free)
        assert len(set(free)) == len(free), "duplicate page on free list"
        assert 0 not in free, "scratch page on free list"
        assert self.refcnt[0] >= 1, "scratch page unpinned"
        fs = set(free)
        for p in range(1, self.n_pages):
            if p in fs:
                assert self.refcnt[p] == 0, \
                    f"page {p} free with refcount {self.refcnt[p]}"
            else:
                assert self.refcnt[p] >= 1, \
                    f"page {p} leaked (off-list, refcount 0)"


class PagedServeLoop:
    """Slot-based continuous batching over a paged KV cache; greedy
    decoding, FIFO admission, reserved page accounting.  ``params`` is
    the ``ParamTree`` of ``lm.init_lm`` (or ``convert.params_from_jax``)
    on ``device``."""

    def __init__(self, params, cfg, batch_slots: int = 4, s_max: int = 128,
                 eos_id: Optional[int] = None, page_size: int = 16,
                 chunk: int = 16, n_pages: Optional[int] = None,
                 device="cuda"):
        lm.segments_for(cfg)          # raises for families not ported
        want = torch.device(device)
        have = next(params.parameters()).device
        if have.type != want.type or want.index not in (None, have.index):
            raise ValueError(f"params live on {have}, loop device is {want}")
        self.device = have
        self.params, self.cfg = params, cfg
        self.B, self.S_max = batch_slots, s_max
        self.eos_id = eos_id
        self.chunk = chunk
        self.spec: PageSpec = spec_for(s_max, batch_slots,
                                       page_size=page_size, n_pages=n_pages)
        padded_max = -(-s_max // chunk) * chunk
        if padded_max > self.spec.s_alloc:
            raise ValueError(
                f"chunk={chunk} pads prompts up to {padded_max} tokens, "
                f"past the block-table range {self.spec.s_alloc}")
        self.pages = PageManager(self.spec.n_pages)
        self.caches = lm.init_caches(cfg, self.spec, device=self.device)
        self.queue: deque = deque()
        self.done: List[Request] = []
        self.refills = 0              # mid-decode slot admissions
        self.decode_steps = 0
        self.block_table = np.zeros((batch_slots, self.spec.max_blocks),
                                    np.int32)
        self.lens = np.zeros(batch_slots, np.int32)
        self.slots: List[Optional[dict]] = [None] * batch_slots

    # -- the two forwards ----------------------------------------------------

    def _prefill_chunk(self, tokens, start: int, bt_row, last: int):
        logits, _ = lm.prefill_chunk(self.params, self.caches, tokens, start,
                                     bt_row, self.cfg, last=last)
        return logits

    def _decode(self, tokens, positions, block_table):
        logits, _ = lm.decode_step_paged(self.params, self.caches, tokens,
                                         positions, block_table, self.cfg)
        return logits

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True)).to(self.device)

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request):
        """Enqueue a request; one that can never be served raises
        ``AdmissionError`` here."""
        L = len(req.prompt)
        if not 0 < L <= self.S_max:
            raise AdmissionError(
                f"prompt length {L} outside (0, s_max={self.S_max}]")
        need = self._worst_blocks(L, req.max_new_tokens)
        if need > self.spec.n_pages - 1:
            raise AdmissionError(
                f"request {req.rid} can never fit: needs {need} pages, "
                f"pool has {self.spec.n_pages - 1}")
        self.queue.append(req)

    def _worst_blocks(self, L: int, max_new: int) -> int:
        """Blocks a request can ever touch: the padded prefill plus decode
        writes at positions [L, L + max_new - 1), clamped to s_alloc."""
        C, P = self.chunk, self.spec.page_size
        hi = min(max(-(-L // C) * C, L + max_new - 1), self.spec.s_alloc)
        return -(-hi // P)

    def _admit(self, slot_i: int) -> str:
        """Prefill the queue head into a free slot.  Returns 'admitted',
        'finished' (done on its first token: the slot is free again) or
        'blocked' (empty queue or pool short)."""
        if not self.queue:
            return "blocked"
        req = self.queue[0]
        tokens = np.asarray(req.prompt, np.int32)
        L = len(tokens)
        total = self._worst_blocks(L, req.max_new_tokens)
        page_ids = self.pages.alloc(total)
        if page_ids is None:
            return "blocked"
        self.queue.popleft()
        blocks = np.asarray(page_ids, np.int32)
        row = np.zeros(self.spec.max_blocks, np.int32)
        row[:total] = blocks
        self.block_table[slot_i] = row
        bt_row = self._to_dev(row)
        C = self.chunk
        n_chunks = -(-L // C)
        logits = None
        for ci in range(n_chunks):
            buf = np.zeros(C, np.int32)
            seg = tokens[ci * C:(ci + 1) * C]
            buf[: len(seg)] = seg
            last = (L - 1) - ci * C if ci == n_chunks - 1 else 0
            logits = self._prefill_chunk(self._to_dev(buf[None]), ci * C,
                                         bt_row, last)
        tok0 = int(torch.argmax(logits))
        self.lens[slot_i] = L
        entry = {"req": req, "out": [tok0], "cur": tok0, "blocks": blocks}
        if self._done_now(entry) or L >= self.S_max:
            self._finish(slot_i, entry)
            return "finished"
        self.slots[slot_i] = entry
        return "admitted"

    # -- lifecycle -----------------------------------------------------------

    def _done_now(self, entry) -> bool:
        return ((self.eos_id is not None and entry["out"][-1] == self.eos_id)
                or len(entry["out"]) >= entry["req"].max_new_tokens)

    def _finish(self, slot_i: int, entry) -> None:
        req = entry["req"]
        req.output = np.asarray(entry["out"], np.int32)
        req.finish_reason = (
            "stop" if (self.eos_id is not None
                       and entry["out"][-1] == self.eos_id) else "length")
        self.done.append(req)
        self.pages.release(list(entry["blocks"]))
        self.block_table[slot_i] = 0      # scratch page: no stale aliasing
        self.lens[slot_i] = 0
        self.slots[slot_i] = None

    def _fill_free_slots(self, mid_decode: bool) -> None:
        for i in range(self.B):
            while self.slots[i] is None:
                status = self._admit(i)
                if status == "blocked":
                    break
                if mid_decode:
                    self.refills += 1
                if status == "admitted":
                    break

    def run(self) -> List[Request]:
        """Drain the queue; returns finished requests."""
        while self.step():
            pass
        return self.done

    def step(self) -> bool:
        """One round: admissions into free slots, one decode step over the
        live slots, then refill.  Returns True while work remains."""
        mid = any(s is not None for s in self.slots)
        self._fill_free_slots(mid_decode=mid)
        live = [i for i in range(self.B) if self.slots[i] is not None]
        if not live:
            if self.queue:
                req = self.queue[0]
                raise PoolExhaustedError(
                    f"request {req.rid} needs "
                    f"{self._worst_blocks(len(req.prompt), req.max_new_tokens)}"
                    f" pages; pool has {self.spec.n_pages - 1}")
            return False
        if self._decode_once(live):
            self._fill_free_slots(mid_decode=True)
        return bool(self.queue or any(s is not None for s in self.slots))

    def _decode_once(self, live: List[int]) -> bool:
        """One ``[B, 1]`` decode step; True if any slot finished."""
        cur = np.zeros((self.B, 1), np.int32)
        for i in live:
            cur[i, 0] = self.slots[i]["cur"]
        logits = self._decode(self._to_dev(cur), self._to_dev(self.lens),
                              self._to_dev(self.block_table))
        self.decode_steps += 1
        nxt = torch.argmax(logits, -1).cpu().numpy()
        freed = False
        for i in live:
            entry = self.slots[i]
            self.lens[i] += 1
            tok = int(nxt[i])
            entry["out"].append(tok)
            entry["cur"] = tok
            if self._done_now(entry) or self.lens[i] >= self.S_max:
                self._finish(i, entry)
                freed = True
        return freed

    def kv_pool_bytes(self) -> int:
        """Device bytes of the whole paged KV pool (every layer)."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for seg in self.caches for pool in seg.values()
                       for leaf in pool.values()))
