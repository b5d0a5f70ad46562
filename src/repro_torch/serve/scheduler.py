"""Priority admission queue, preemption policy and swap policy of the
paged loop (port of ``repro.serve.scheduler``).

With on-demand pages (``cfg.serve_on_demand_pages``) a decode step can
find the pool empty; this module makes that survivable:

- typed errors: ``AdmissionError`` fails a ``submit`` that can never be
  served (empty prompt, prompt past ``s_max``, prompt pages past the
  pool, the ``serve_queue_limit`` backpressure bound);
  ``DeadlineExceededError`` (a spent TTL, at the door or in flight) and
  ``QuotaExceededError`` (a tenant's queued share is full) extend it;
  ``CancelledError`` is attached to a cancelled request, never raised;
  ``PoolExhaustedError`` is raised by ``step`` when the pool cannot
  cover a lone request and no victim exists;
- the queue drains best-first by ``priority`` (higher sooner), FIFO
  among equals, and an entry waiting ``aging`` ticks gains one level, so
  nothing starves;
- ``select_victim`` picks the live slot to park on exhaustion: lowest
  priority, then most pages, then least progress, then latest slot;
  ``policy='never'`` forbids preemption;
- ``peek(tenant_load=...)`` breaks equal effective priorities toward the
  tenant holding the fewest pool pages, and ``peek(eligible=...)`` lets
  the loop pass over tenants at their page quota;
- a parked entry's ``tokens`` are prompt plus every generated token, and
  re-admission replays them through chunked prefill (recompute-resume);
- ``SwapPolicy`` decides per victim between that replay and copying its
  pages to host memory (``serve/swap.py``), from measured rates.

Pure host metadata.  ``queue_wait_s`` (a bounded ``telemetry.Histogram``)
records each admitted entry's wait since its latest enqueue, observed at
``pop`` (``remove``, a cancel or deadline shed, observes nothing).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.serve.telemetry import Histogram


class AdmissionError(ValueError):
    """A request that can never be served as submitted (rejected at
    ``submit``)."""


class DeadlineExceededError(AdmissionError):
    """The request's deadline budget is spent: raised by ``submit`` for a
    budget already spent, attached as ``Request.error`` when the loop
    sheds a queued or live request past its deadline."""


class QuotaExceededError(AdmissionError):
    """A tenant's queued-request share is full (raised by ``submit``)."""


class CancelledError(RuntimeError):
    """The request was cancelled; attached as ``Request.error``, never
    raised by the loop."""


class PoolExhaustedError(RuntimeError):
    """The page pool cannot cover required growth and no preemption
    victim exists (or ``serve_preempt_policy='never'`` forbids one)."""


def tenant_of(req) -> str:
    """A request's tenant label; unset/None is the shared 'default'."""
    return getattr(req, "tenant", None) or "default"


@dataclasses.dataclass
class SchedEntry:
    """One queued unit of work: a fresh request, or a preempted one
    parked for recompute-resume.  ``tokens`` is what admission prefills
    (prompt, or prompt + generated so far); ``out`` the tokens already
    emitted, so finish accounting spans the interruption."""

    req: object                  # serve.loop.Request
    priority: int
    tokens: object               # np.ndarray [L] int32
    out: List[int]
    seq: int                     # FIFO tiebreak among equal priority
    enqueue_tick: int            # scheduler tick at (re-)enqueue (aging)
    t_submit: float              # original submit time
    t_enqueue: float             # latest enqueue time
    preemptions: int = 0
    deadline_s: Optional[float] = None  # TTL from t_submit (None: none);
                                 # enforced at step boundaries
    swap_blocks: int = 0         # full blocks this parked entry may hold
                                 # in the host SwapStore (set at swap-out,
                                 # cleared at re-admission): a cancel or
                                 # deadline shed purges exactly these


class Scheduler:
    """Priority-ordered admission queue + preemption victim policy."""

    POLICIES = ("priority", "never")

    def __init__(self, policy: str = "priority", aging: int = 64,
                 default_priority: int = 0):
        if policy not in self.POLICIES:
            raise ValueError(
                f"serve_preempt_policy {policy!r} not in {self.POLICIES}")
        self.policy = policy
        self.aging = int(aging)
        self.default_priority = int(default_priority)
        self._q: List[SchedEntry] = []
        self._seq = 0
        self.ticks = 0
        self.submitted = 0
        self.requeued = 0        # preemption re-entries
        self.removed = 0         # entries dropped without admission
        self.peak_queue = 0
        self.queue_wait_s = Histogram()

    # -- queue --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req, priority: Optional[int] = None) -> SchedEntry:
        """Enqueue a fresh request (``priority=None`` takes the default)."""
        prio = self.default_priority if priority is None else int(priority)
        now = time.monotonic()
        ent = SchedEntry(req=req, priority=prio, tokens=req.prompt,
                         out=[], seq=self._seq, enqueue_tick=self.ticks,
                         t_submit=now, t_enqueue=now)
        self._seq += 1
        self._q.append(ent)
        self.submitted += 1
        self.peak_queue = max(self.peak_queue, len(self._q))
        return ent

    def requeue(self, ent: SchedEntry) -> None:
        """Re-enqueue a preempted entry: same priority and submit time, a
        fresh seq (behind same-priority peers) and a fresh aging clock."""
        ent.seq = self._seq
        self._seq += 1
        ent.enqueue_tick = self.ticks
        ent.t_enqueue = time.monotonic()
        ent.preemptions += 1
        self._q.append(ent)
        self.requeued += 1
        self.peak_queue = max(self.peak_queue, len(self._q))

    def tick(self) -> None:
        """One scheduling round (the aging clock)."""
        self.ticks += 1

    def effective_priority(self, ent: SchedEntry) -> int:
        """Priority plus the aging boost earned while waiting."""
        if self.aging <= 0:
            return ent.priority
        return ent.priority + (self.ticks - ent.enqueue_tick) // self.aging

    def peek(self, eligible=None,
             tenant_load: Optional[dict] = None) -> Optional[SchedEntry]:
        """Best admission candidate: highest effective priority, FIFO
        among equals (never overtaken by a smaller lower-priority one).
        ``tenant_load`` (tenant -> pages held) breaks ties toward the
        lightest tenant; ``eligible`` restricts the candidates."""
        cands = self._q if eligible is None \
            else [e for e in self._q if eligible(e)]
        if not cands:
            return None
        if tenant_load:
            return max(cands, key=lambda e: (
                self.effective_priority(e),
                -tenant_load.get(tenant_of(e.req), 0), -e.seq))
        return max(cands,
                   key=lambda e: (self.effective_priority(e), -e.seq))

    def pop(self, ent: SchedEntry) -> None:
        """Remove an entry the loop is admitting; records its queue wait
        (since the latest enqueue: a resume's wait counts from its
        requeue)."""
        self._q.remove(ent)
        self.queue_wait_s.observe(time.monotonic() - ent.t_enqueue)

    def remove(self, ent: SchedEntry) -> None:
        """Drop a queued entry without admitting it (no queue-wait
        observation: that histogram measures waits ended by admission)."""
        self._q.remove(ent)
        self.removed += 1

    # -- preemption ---------------------------------------------------------

    def select_victim(
        self, candidates: Iterable[Tuple[int, int, int, int]],
    ) -> Optional[int]:
        """The slot to preempt from ``(slot, priority, pages, progress)``
        tuples: lowest priority, then most pages, then least progress,
        then the latest slot.  None when the policy forbids preemption or
        there is no candidate."""
        cands = list(candidates)
        if self.policy == "never" or not cands:
            return None
        return min(cands, key=lambda c: (c[1], -c[2], c[3], -c[0]))[0]

    # -- introspection ------------------------------------------------------

    def queued(self) -> Sequence[SchedEntry]:
        return tuple(self._q)

    def stats(self) -> dict:
        return {
            "policy": self.policy,
            "aging": self.aging,
            "queued": len(self._q),
            "submitted": self.submitted,
            "requeued": self.requeued,
            "removed": self.removed,
            "peak_queue": self.peak_queue,
            "ticks": self.ticks,
            "queue_wait_s": self.queue_wait_s.summary(),
        }

    def check(self) -> None:
        """Structural invariants: unique seqs, no entry from the future,
        no empty or finished entry queued."""
        seqs = [e.seq for e in self._q]
        assert len(set(seqs)) == len(seqs), "duplicate scheduler seq"
        for e in self._q:
            assert e.enqueue_tick <= self.ticks, "entry from the future"
            assert len(e.tokens) > 0, "empty entry in queue"
            assert len(e.out) < getattr(e.req, "max_new_tokens", 1 << 30), \
                "finished entry still queued"


class SwapPolicy:
    """Per-victim recompute-vs-swap decision from measured rates.  Swap
    wins when ``2 * nbytes / copy_bytes_per_s < replay_tokens /
    prefill_tok_per_s``; both rates are exponential moving averages of
    what the loop measures (``observe_prefill`` around its chunked
    prefill, ``observe_copy`` around the swap copies).  Until both exist
    the policy swaps (the only way to learn the copy rate).
    ``mode='always'`` pins the swap path, ``'never'`` disables it,
    ``'auto'`` compares."""

    MODES = ("auto", "always", "never")

    def __init__(self, mode: str = "auto", alpha: float = 0.25):
        if mode not in self.MODES:
            raise ValueError(
                f"swap policy {mode!r} not in {self.MODES}")
        self.mode = mode
        self.alpha = float(alpha)
        self.prefill_tok_per_s = 0.0     # 0.0: not measured yet
        self.copy_bytes_per_s = 0.0
        self.chose_swap = 0
        self.chose_recompute = 0

    def _ema(self, old: float, sample: float) -> float:
        return sample if old == 0.0 else \
            (1.0 - self.alpha) * old + self.alpha * sample

    def observe_prefill(self, tokens: int, dt_s: float) -> None:
        if tokens > 0 and dt_s > 0.0:
            self.prefill_tok_per_s = self._ema(
                self.prefill_tok_per_s, tokens / dt_s)

    def observe_copy(self, nbytes: int, dt_s: float) -> None:
        if nbytes > 0 and dt_s > 0.0:
            self.copy_bytes_per_s = self._ema(
                self.copy_bytes_per_s, nbytes / dt_s)

    def decide(self, replay_tokens: int, nbytes: int) -> bool:
        """True: swap this victim's pages out; False: recompute."""
        if self.mode == "never":
            swap = False
        elif self.mode == "always":
            swap = True
        elif not (self.prefill_tok_per_s and self.copy_bytes_per_s):
            swap = True
        else:
            swap_cost_s = 2.0 * nbytes / self.copy_bytes_per_s
            replay_cost_s = replay_tokens / self.prefill_tok_per_s
            swap = swap_cost_s < replay_cost_s
        if swap:
            self.chose_swap += 1
        else:
            self.chose_recompute += 1
        return swap

    def stats(self) -> dict:
        return {
            "mode": self.mode,
            "prefill_tok_per_s": self.prefill_tok_per_s,
            "copy_bytes_per_s": self.copy_bytes_per_s,
            "chose_swap": self.chose_swap,
            "chose_recompute": self.chose_recompute,
        }
