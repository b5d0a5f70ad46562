"""Paged continuous-batching serve loop (port of ``repro.serve.paged``).

Every attention layer's K/V lives in a paged pool; a request owns a list
of pages recorded in its slot's block-table row.  Prompts are prefilled
in fixed-size chunks; each decode step advances every live slot by one
token at its own position, and a slot freed by a finished request is
refilled at once (continuous batching).  The defaults are the
reference's (``configs/base.py``):

- **On-demand pages** (``serve_on_demand_pages``): admission covers only
  the padded prefill; decode pages are allocated at page-boundary
  crossings, so concurrency is bounded by the live working set.  With it
  off, admission reserves prompt + ``max_new_tokens`` (worst case).
- **Priority scheduler and recompute preemption** (``serve/scheduler.py``,
  ``serve_preempt_policy``): the queue drains best-first with aging; when
  on-demand growth finds the pool empty, a victim slot (lowest priority,
  most pages, least progress) is parked: its fully written pages move
  into the prefix cache, and the request requeues with its generated
  tokens, which re-admission replays through chunked prefill.
- **Prefix cache** (``serve/prefix_cache.py``, ``serve_prefix_cache``):
  finished prompts' pages are kept in a radix tree keyed by token
  content; admission maps the longest cached page-aligned prefix
  read-only into the slot and prefills only from the first chunk it does
  not cover.  Shared pages are ref-counted; a cached page the suffix
  prefill would write is copied first (copy-on-write).

- **Self-speculative decoding** (``serve_spec_k`` > 0, ``serve/spec.py``):
  a model-free drafter (prompt-lookup n-grams by default) proposes up to
  ``k`` tokens per live slot; one batched ``[B, k + 1]`` verify forward
  scores the current token and the draft, and greedy acceptance keeps
  the longest draft prefix that matches the model's own argmax chain
  plus one bonus token.  Rejected rows roll back by not advancing
  ``lens``; padding rows of the fixed window write to the scratch page.
  A draft that cannot get pages is truncated, never preempted for.
  Verify attention is the gather + masked softmax, so with a drafter on
  the decode reader is pinned to the same ``'lax'`` reader
  (``serve_paged_attn_impl``): one output stream, one attention path.
- **Swap tier** (``serve_swap``, ``serve/swap.py``): a victim's written
  pages can instead be copied to host memory through the staging ring
  (codes and scales: quantised pools swap losslessly) and, at resume,
  scattered into fresh pages before the block table maps them: no token
  replay, at the price of two copies.  ``scheduler.SwapPolicy`` chooses
  per victim from measured prefill and copy rates; the host store is
  keyed like the radix tree, so swapped prefixes serve any request that
  shares them, and it may evict freely (an evicted page costs recompute).
  Every host page carries a CRC-32 seal, verified before it is restored.
- **Faults, cancellation, deadlines, tenants** (``serve/faults.py``):
  ``cancel`` ends a request in any state (live, queued, swapped out) and
  releases its pages and host bytes; a request past its ``deadline_s``
  is shed at the next step boundary; both keep the partial output and a
  typed ``Request.error`` and land in ``failed``.  A tenant at its page
  quota is passed over at admission while an under-quota tenant waits;
  per-tenant swap-byte budgets and queue limits bound the rest.  A
  seeded ``FaultPlan`` injects pool exhaustion, swap refusals, torn host
  pages, admission stalls and cancels.
- **Autotune** (``serve_tlmac_impl``, ``serve_paged_attn_impl``, both
  ``'auto'`` by default, ``kernels/autotune.py``): the serve linears and
  the decode reader dispatch the cache's winner for their shape, a
  host-side read that a capture may do; a miss takes kernel 1 and
  flash-decode at 4 splits.  ``tune`` fills the cache for this loop's
  shapes before its graphs are captured; serving never tunes.
- **Telemetry** (``serve_telemetry``, ``serve/telemetry.py``): the
  reference's lifecycle events per request, phase histograms
  (``phase.reserve_s``, ``phase.prefill_chunk_s``, ``phase.decode_s``,
  ``phase.verify_s``, ``phase.cow_s``), gauges and profiler ranges; off,
  the loop holds the inert ``telemetry.NULL``.  TTFT and queue-wait
  histograms are always kept.

``submit`` rejects (``AdmissionError``) only what can never run: an empty
prompt, one past ``s_max``, a padded prefill larger than the pool, a
spent deadline (``DeadlineExceededError``), a tenant at its queue limit
(``QuotaExceededError``) and the ``serve_queue_limit`` backpressure
bound; ``step`` raises
``PoolExhaustedError`` when every slot is free and the best entry still
gets no pages (reserved mode), or growth finds no victim.

The forward set is fixed: one ``[1, chunk]`` prefill chunk, one ``[B,
1]`` decode step and, with a drafter on, one ``[B, k + 1]`` verify
window, for any mix of prompt lengths.  On a CUDA device each is
captured once in a CUDA graph (after an eager warm-up) into one graph
pool and replayed from static device buffers that one host-to-device
copy per argument fills per call: the counterpart of the reference's one
``jax.jit`` executable per shape.  On the CPU the same functions run
eagerly.  ``compiled_shapes`` / ``check_compiled`` assert the set.  The
swap gather and scatter are eager indexing outside the set; the scatter
writes the pools in place, so the graphs read the restored pages.

Physical page 0 is the scratch page: pinned, never handed out; idle
slots' decode writes land there and freed rows are reset to it.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import bitplanes as _bp
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import int8_experts as _i8
from repro_torch.kernels import paged as paged_kernels
from repro_torch.kernels import tlmac_fused as _tf
from repro_torch.kernels import tlmac_gemm as _tg
from repro_torch.kernels.paged import PageSpec, qspec_for, spec_for
from repro_torch.models import lm
from repro_torch.models.attention import DECODE_IMPLS
from repro_torch.serve.faults import make_injector, tree_leaves, tree_map
from repro_torch.serve.loop import Request
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import (AdmissionError, CancelledError,
                                         DeadlineExceededError,
                                         PoolExhaustedError,
                                         QuotaExceededError, SchedEntry,
                                         Scheduler, SwapPolicy, tenant_of)
from repro_torch.serve.spec import make_drafter
from repro_torch.serve.swap import StagingRing, SwapStore, stage_to_device
from repro_torch.serve.telemetry import NULL, Histogram, Telemetry, jsonable

__all__ = ["AdmissionError", "CancelledError", "DeadlineExceededError",
           "PoolExhaustedError", "QuotaExceededError", "PageManager",
           "PagedServeLoop"]

# the launch counters a captured graph records: name -> (module, counter);
# kernel 1's expert-stack launches are also in its total; kernels 4 + 3
# run where 'auto' picked 'pallas' for a serve linear
_COUNTED = {"tlmac_gemm_fused": (_tf, "launches"),
            "tlmac_gemm_fused_expert": (_tf, "expert_launches"),
            "flash_decode": (_fd, "launches"),
            "pack_bitplanes": (_bp, "launches"),
            "tlmac_gemm": (_tg, "launches"),
            "int8_experts": (_i8, "launches")}
# one warm-up and capture stream per device, shared by every loop's
# forwards: cuBLAS keeps a workspace for each stream it has run on, so a
# stream per capture would hold one more workspace for every graph built
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    s = _CAPTURE_STREAMS.get(dev)
    if s is None:
        s = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return s


def _tlmac_linears(tree):
    """Every single (not expert-stacked) tlmac serve linear of a params
    tree, one per stacked segment leaf, layer 0's view."""
    if isinstance(tree, list):
        for t in tree:
            yield from _tlmac_linears(t)
    elif isinstance(tree, dict):
        if "exec_idx" in tree:
            ex = tree["exec_idx"]
            if ex.dim() == 4:          # [n_layers, n_tiles, kg, dp]
                yield {k: v[0] for k, v in tree.items()}
            elif ex.dim() == 3:
                yield tree
            return
        for v in tree.values():
            yield from _tlmac_linears(v)


class PageManager:
    """Host-side ref-counted physical-page pool; page 0 is the pinned
    scratch page.  Every other page is free (refcount 0) or referenced
    (one per owning slot or tree node, one more per sharer).  ``release``
    frees a page at refcount 0; double frees and frees of the scratch
    page raise."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free = deque(range(1, n_pages))
        self.refcnt = np.zeros(n_pages, np.int64)
        self.refcnt[0] = 1
        self.allocs = 0      # pages handed out
        self.frees = 0       # pages returned to the free list
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
        self.allocs += n
        self.peak = max(self.peak, self.in_use)
        return pages

    def retain(self, pages: List[int]) -> None:
        """One more reference per page (sharing an already-live page)."""
        for p in pages:
            if self.refcnt[p] <= 0:
                raise ValueError(f"retain of free page {p}")
            self.refcnt[p] += 1

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
                self.frees += 1

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


class FixedShapeForward:
    """One forward entry point of the loop at fixed argument shapes.

    Called with host arrays (numpy or ints, int32).  On the CPU it runs
    ``fn`` eagerly on tensors made from them and records each distinct
    argument shape (what ``jit`` would trace).  On a CUDA device the
    first call at a shape allocates static device buffers, runs ``fn``
    once eagerly on them (the warm-up: kernels built, workspaces
    allocated), then captures ``fn`` into a CUDA graph in ``pool``, both
    on one side stream per device shared by every loop; every
    call copies its arguments into the static buffers (one pinned
    host-to-device copy each) and replays the graph.  The returned logits
    are the graph's static output: read them before the next call of any
    forward sharing the pool.  A capture failure raises.

    Kernel wrappers count their launches in Python, which a replay does
    not run: ``graph_launches`` holds each kernel's launches recorded at
    capture, ``replays`` the replays, and ``eager`` the eager runs
    (warm-ups, or every CPU call); launches on the card are then
    ``eager launches + graph_launches * replays``."""

    def __init__(self, fn, device: torch.device, pool=None):
        self.fn = fn
        self.device = device
        self.pool = pool
        self.shapes = set()
        self.graphs: Dict[tuple, dict] = {}
        self.eager = 0
        self.replays = 0

    @property
    def graph_launches(self) -> Dict[str, int]:
        out = dict.fromkeys(_COUNTED, 0)
        for g in self.graphs.values():
            for k, n in g["launches"].items():
                out[k] += n
        return out

    def n_compiled(self) -> int:
        return len(self.graphs) if self.device.type == "cuda" \
            else len(self.shapes)

    def __call__(self, *args):
        arrays = [np.asarray(a, np.int32) for a in args]
        key = tuple(a.shape for a in arrays)
        if self.device.type != "cuda":
            self.shapes.add(key)
            self.eager += 1
            return self.fn(*[torch.from_numpy(a.copy()).to(self.device)
                             for a in arrays])
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(key, arrays)
        g["ready"].synchronize()          # the pinned buffers are free again
        for host, a in zip(g["host"], arrays):
            host.numpy()[...] = a
        for static, host in zip(g["static"], g["host"]):
            static.copy_(host, non_blocking=True)
        g["ready"].record()
        g["graph"].replay()
        self.replays += 1
        return g["out"]

    def _capture(self, key, arrays) -> dict:
        dev = self.device
        host = [torch.from_numpy(a.copy()).pin_memory() for a in arrays]
        static = [h.to(dev) for h in host]
        cur = torch.cuda.current_stream(dev)
        side = _capture_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn(*static)
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        self.eager += 1
        before = {k: getattr(m, a) for k, (m, a) in _COUNTED.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            out = self.fn(*static)
        g = {"graph": graph, "static": static, "host": host, "out": out,
             "ready": torch.cuda.Event(),
             "launches": {k: getattr(m, a) - before[k]
                          for k, (m, a) in _COUNTED.items()}}
        g["ready"].record(cur)
        self.graphs[key] = g
        return g


class PagedServeLoop:
    """Slot-based continuous batching over a paged KV cache; greedy
    decoding, priority admission with aging, on-demand pages with
    recompute preemption and a prefix cache by default.  ``attn_impl``,
    ``prefix_cache``, ``spec_k``, ``drafter`` (a name or a
    ``spec.Drafter``), ``on_demand``, ``preempt_policy``, ``swap``,
    ``swap_bytes``, ``swap_policy``, ``check_invariants``, ``telemetry``,
    ``trace_path``, ``tenant_page_quota``, ``tenant_swap_bytes``,
    ``tenant_queue_limit`` and ``deadline_s`` follow the config when
    None; ``faults`` is a ``faults.FaultPlan``, an injector or None
    (inert).  ``params`` is the ``ParamTree`` of ``lm.init_lm`` (or
    ``convert.params_from_jax``) on ``device``; ``Request.priority``
    (higher sooner), ``tenant`` and ``deadline_s`` are honoured."""

    def __init__(self, params, cfg, batch_slots: int = 4, s_max: int = 128,
                 eos_id: Optional[int] = None, page_size: int = 16,
                 chunk: int = 16, n_pages: Optional[int] = None,
                 attn_impl: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 spec_k: Optional[int] = None, drafter=None,
                 on_demand: Optional[bool] = None,
                 preempt_policy: Optional[str] = None,
                 swap: Optional[bool] = None,
                 swap_bytes: Optional[int] = None,
                 swap_policy: Optional[str] = None,
                 check_invariants: Optional[bool] = None,
                 telemetry: Optional[bool] = None,
                 trace_path: Optional[str] = None,
                 tenant_page_quota: Optional[int] = None,
                 tenant_swap_bytes: Optional[int] = None,
                 tenant_queue_limit: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 faults=None,
                 device="cuda"):
        if not lm.supports_paged(cfg):   # raises for families not ported
            raise ValueError(
                f"config {cfg.name!r} has non-pageable block kinds; "
                "use serve.loop.ServeLoop (dense caches)")
        want = torch.device(device)
        have = next(params.parameters()).device
        if have.type != want.type or want.index not in (None, have.index):
            raise ValueError(f"params live on {have}, loop device is {want}")
        self.device = have
        if attn_impl is not None:
            cfg = dataclasses.replace(cfg, serve_paged_attn_impl=attn_impl)
        self.spec_k = int(cfg.serve_spec_k if spec_k is None else spec_k)
        if self.spec_k > 0:
            self.drafter = make_drafter(
                cfg.serve_spec_drafter if drafter is None else drafter)
        else:
            self.drafter = None
            if drafter is not None and make_drafter(drafter) is not None:
                raise ValueError(
                    "a drafter was passed but speculation is off; set "
                    "spec_k > 0 (or cfg.serve_spec_k) to enable it")
        if self.drafter is not None:
            # verify attention is the gather + masked softmax; decode is
            # pinned to the same reader so that one output stream never
            # mixes two attention paths.  An explicit other reader is an
            # error, not a silent override.
            if attn_impl is not None and attn_impl != "lax":
                raise ValueError(
                    f"attn_impl={attn_impl!r} conflicts with speculative "
                    "decoding: verify attention always runs the gathered "
                    "reader, so the decode step is pinned to 'lax'; pass "
                    "attn_impl='lax' (or None), or disable speculation")
            cfg = dataclasses.replace(cfg, serve_paged_attn_impl="lax")
        if cfg.serve_paged_attn_impl not in DECODE_IMPLS:
            raise ValueError(
                f"serve_paged_attn_impl {cfg.serve_paged_attn_impl!r} not "
                f"in {DECODE_IMPLS}")
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
        self.on_demand = bool(cfg.serve_on_demand_pages
                              if on_demand is None else on_demand)
        self.sched = Scheduler(
            policy=(cfg.serve_preempt_policy if preempt_policy is None
                    else preempt_policy),
            aging=cfg.serve_sched_aging,
            default_priority=cfg.serve_priority_default)
        self.queue_limit = int(cfg.serve_queue_limit)
        # per-tenant knobs (0 = off): the page quota is soft (passed over
        # only while an under-quota tenant waits), the queue limit hard
        self.tenant_page_quota = int(cfg.serve_tenant_page_quota
                                     if tenant_page_quota is None
                                     else tenant_page_quota)
        self.tenant_queue_limit = int(cfg.serve_tenant_queue_limit
                                      if tenant_queue_limit is None
                                      else tenant_queue_limit)
        # default TTL (a request's own deadline_s overrides; 0 = none)
        self.deadline_s = float(cfg.serve_deadline_s if deadline_s is None
                                else deadline_s)
        # made before the swap store, which shares it
        self.faults = make_injector(faults)
        self._injected_block = False   # an admission this step was blocked
                                       # by an injected fault, not the pool
        # host-RAM swap tier: off, the store, policy and ring are None
        swap_on = bool(cfg.serve_swap if swap is None else swap)
        if swap_on:
            self.swap: Optional[SwapStore] = SwapStore(
                page_size,
                max_bytes=int(cfg.serve_swap_bytes if swap_bytes is None
                              else swap_bytes),
                tenant_budget=int(cfg.serve_tenant_swap_bytes
                                  if tenant_swap_bytes is None
                                  else tenant_swap_bytes),
                faults=self.faults)
            self.swap_policy: Optional[SwapPolicy] = SwapPolicy(
                mode=(cfg.serve_swap_policy if swap_policy is None
                      else swap_policy))
            self.swap_ring: Optional[StagingRing] = StagingRing(
                width=int(cfg.serve_swap_ring_pages))
        else:
            self.swap = None
            self.swap_policy = None
            self.swap_ring = None
        self.check_invariants = bool(cfg.serve_check_invariants
                                     if check_invariants is None
                                     else check_invariants)
        # host-side either way: the forwards and their graphs are the same
        tel_on = bool(cfg.serve_telemetry if telemetry is None
                      else telemetry)
        self.tel = Telemetry() if tel_on else NULL
        self.trace_path = str(cfg.serve_trace_path if trace_path is None
                              else trace_path)
        if prefix_cache is None:
            prefix_cache = cfg.serve_prefix_cache
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(page_size, self.pages,
                        max_pages=cfg.serve_prefix_cache_pages, tel=self.tel)
            if prefix_cache else None)
        self.caches = lm.init_caches(cfg, self.spec, device=self.device)
        self.done: List[Request] = []
        # cancelled or expired requests (partial output, typed error);
        # disjoint from done
        self.failed: List[Request] = []
        self.cancelled = 0            # client or injected cancels
        self.expired = 0              # deadline sheds
        self.tenant_counters: dict = {}   # tenant -> terminal counters
        self.refills = 0              # mid-decode slot admissions
        self.prefill_tokens_run = 0   # chunk tokens actually prefilled
        self.prefill_tokens_saved = 0  # chunk tokens skipped via the cache
        self.cow_copies = 0           # copy-on-write page duplications
        self.decode_steps = 0         # plain [B, 1] decode forwards
        self.spec_steps = 0           # [B, k+1] verify forwards
        self.spec_proposed = 0        # draft tokens offered to verify
        self.spec_accepted = 0        # draft tokens the argmax confirmed
        self.gen_tokens = 0           # tokens emitted by decode/verify
        self.slot_steps = 0           # live-slot participations in
                                      # decode/verify forwards
        self.preemptions = 0          # slots parked on pool exhaustion
        self.resumes = 0              # parked requests re-admitted
        self.resume_prefill_tokens = 0  # chunk tokens replayed at resume
        self.preempted_tokens = 0     # KV positions dropped at preempt
        self.swapped_out_pages = 0    # pages landed in the host store
        self.swapped_in_pages = 0     # host pages restored to the device
        self.swap_out_bytes = 0       # device -> host bytes stored
        self.swap_in_bytes = 0        # host -> device bytes restored
        self.swap_restored_tokens = 0  # positions resumed without replay
        self.grown_pages = 0          # on-demand page-boundary allocs
        self.peak_live_slots = 0
        self.ttft_s = Histogram()     # submit -> first token, per request
        self.block_table = np.zeros((batch_slots, self.spec.max_blocks),
                                    np.int32)
        self.lens = np.zeros(batch_slots, np.int32)
        self.slots: List[Optional[dict]] = [None] * batch_slots
        # the loop's whole forward set; on the card all share one pool
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        self.forwards = {
            "chunk": FixedShapeForward(self._chunk_fn, self.device, pool),
            "decode": FixedShapeForward(self._decode_fn, self.device, pool),
        }
        if self.drafter is not None:
            self.forwards["verify"] = FixedShapeForward(
                self._verify_fn, self.device, pool)

    # -- autotune -----------------------------------------------------------

    @torch.no_grad()
    def tune(self, reps: int = 5) -> Dict[str, dict]:
        """Tune, eagerly and on concrete tensors, every ``'auto'`` shape
        this loop's forwards dispatch, before any graph is captured (a
        capture only reads the cache).  The tlmac serve linears are tuned
        at the chunk's, the decode step's and (with a drafter) the verify
        window's rows, on seeded random activation codes and each shape's
        first linear's plan; the paged decode reader, under
        ``serve_paged_attn_impl='auto'``, on a seeded random pool with
        every slot at ``s_max`` positions.  A shape already in the cache
        is not tuned again.  Returns the config of every key."""
        if any(f.graphs for f in self.forwards.values()):
            raise RuntimeError("tune before the first forward: captured "
                               "graphs keep the configs they resolved")
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(0)
        out: Dict[str, dict] = {}
        rows = {self.chunk, self.B}
        if self.drafter is not None:
            rows.add(self.B * (self.spec_k + 1))
        if cfg.serve_tlmac_impl == "auto":
            for lin in _tlmac_linears(self.params.tree()):
                n_tiles, kg, dp = lin["exec_idx"].shape
                K, N = kg * cfg.tlmac_G, n_tiles * dp
                table = lin.get("table_narrow", lin["table"])
                for M in sorted(rows):
                    key = autotune.shape_key(
                        M, K, N, B_a=cfg.quant.a_bits, G=cfg.tlmac_G, D_p=dp,
                        R=int(np.prod(table.shape[:-1])), device=dev)
                    if key in out:
                        continue
                    conf = autotune.lookup(key)
                    if conf is None:
                        a = torch.randint(0, 2**cfg.quant.a_bits, (M, K),
                                          generator=gen, device=dev,
                                          dtype=torch.int8)
                        conf = autotune.tune(
                            a, table, lin["exec_idx"], lin["step_cluster"],
                            B_a=cfg.quant.a_bits, G=cfg.tlmac_G, N=N,
                            reps=reps)
                    out[key] = conf
        if cfg.serve_paged_attn_impl == "auto":
            out.update(self._tune_attention(gen, reps))
        return out

    def _tune_attention(self, gen, reps: int):
        cfg, dev, spec = self.cfg, self.device, self.spec
        qs = qspec_for(cfg)
        KV, hd, H = cfg.n_kv, cfg.kv_head_dim, cfg.n_heads
        pool = paged_kernels.zero_kv_pool(spec, KV, hd, qs, device=dev)
        n = spec.n_pages * spec.page_size
        kv = torch.randn((2, n, KV, hd), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        pid = torch.arange(spec.n_pages, device=dev).repeat_interleave(
            spec.page_size)
        off = torch.arange(spec.page_size, device=dev).repeat(spec.n_pages)
        paged_kernels._write_kv(pool, pid, off, kv[0], kv[1], qs)
        bt = (1 + torch.arange(self.B * spec.max_blocks, dtype=torch.int32,
                               device=dev) % (spec.n_pages - 1)).reshape(
            self.B, spec.max_blocks)
        positions = torch.full((self.B,), self.S_max - 1,
                               dtype=torch.int32, device=dev)
        q = torch.randn((self.B, 1, H, hd), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        windows = {cfg.local_window if kind == "attn_local" else None
                   for seg in lm.segments_for(cfg) for kind in seg.pattern}
        out = {}
        ksc, vsc = paged_kernels.pool_scales(pool)
        for window in sorted(windows, key=lambda w: -1 if w is None else w):
            key = autotune.attn_shape_key(
                self.B, KV, H // KV, hd, spec.max_blocks, spec.page_size,
                window, kv_dtype=qs.dtype, device=dev)
            conf = autotune.lookup(key)
            if conf is None:
                conf = autotune.tune_attention(
                    q, pool["k"], pool["v"], bt, positions, window=window,
                    reps=reps, k_scales=ksc, v_scales=vsc, qspec=qs)
            out[key] = conf
        return out

    # -- the forwards --------------------------------------------------------

    def _chunk_fn(self, tokens, start, bt_row, last):
        return lm.prefill_chunk(self.params, self.caches, tokens, start,
                                bt_row, self.cfg, last=last)[0]

    def _decode_fn(self, tokens, positions, block_table):
        return lm.decode_step_paged(self.params, self.caches, tokens,
                                    positions, block_table, self.cfg)[0]

    def _verify_fn(self, tokens, positions, n_writes, block_table):
        return lm.verify_step_paged(self.params, self.caches, tokens,
                                    positions, n_writes, block_table,
                                    self.cfg)[0]

    def _prefill_chunk(self, tokens, start, bt_row, last):
        """tokens ``[1, C]``, ``start``, ``bt_row [max_blocks]``, ``last``
        (host int32) -> logits ``[vocab]`` on the device."""
        return self.forwards["chunk"](tokens, start, bt_row, last)

    def _decode(self, tokens, positions, block_table):
        """tokens ``[B, 1]``, positions ``[B]``, block table ``[B,
        max_blocks]`` (host int32) -> logits ``[B, vocab]`` on the
        device."""
        return self.forwards["decode"](tokens, positions, block_table)

    def _verify(self, tokens, positions, n_writes, block_table):
        """tokens ``[B, k+1]``, positions ``[B]``, n_writes ``[B]``, block
        table ``[B, max_blocks]`` (host int32) -> logits ``[B, k+1,
        vocab]`` on the device."""
        return self.forwards["verify"](tokens, positions, n_writes,
                                       block_table)

    def _sync(self) -> None:
        """Wait for the device (telemetry on: a phase span then covers the
        device's work, not its launch)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request):
        """Enqueue a request.  One that can never be served, one with a
        spent deadline (``DeadlineExceededError``), one whose tenant is
        at its queue limit (``QuotaExceededError``) or one past the queue
        limit raises an ``AdmissionError``; every check runs before the
        push and the event, so a rejected submit leaves nothing behind."""
        L = len(req.prompt)
        if not 0 < L <= self.S_max:
            raise AdmissionError(
                f"prompt length {L} outside (0, s_max={self.S_max}]")
        usable = self.spec.n_pages - 1
        if self._prefill_blocks(L) > usable:
            # even fully cached prompt blocks are pages of this pool
            raise AdmissionError(
                f"request {req.rid} can never fit: prompt needs "
                f"{self._prefill_blocks(L)} pages, pool has {usable}")
        dl = req.deadline_s
        if dl is None and self.deadline_s > 0:
            dl = self.deadline_s
        if dl is not None and dl <= 0:
            raise DeadlineExceededError(
                f"request {req.rid} submitted with a spent deadline "
                f"budget ({dl}s); shed at the door")
        tenant = tenant_of(req)
        if self.tenant_queue_limit:
            n_t = sum(1 for e in self.sched.queued()
                      if tenant_of(e.req) == tenant)
            if n_t >= self.tenant_queue_limit:
                raise QuotaExceededError(
                    f"tenant {tenant!r} at serve_tenant_queue_limit="
                    f"{self.tenant_queue_limit}; retry later")
        if self.queue_limit and len(self.sched) >= self.queue_limit:
            raise AdmissionError(
                f"backpressure: queue at serve_queue_limit="
                f"{self.queue_limit}; retry later")
        ent = self.sched.push(req, req.priority)
        ent.deadline_s = dl
        self.tel.event("submit", req.rid, prompt_tokens=L,
                       priority=ent.priority, tenant=tenant)

    def _prefill_blocks(self, L: int) -> int:
        """Blocks the padded chunk prefill of ``L`` tokens writes."""
        C, P = self.chunk, self.spec.page_size
        return -(-min(-(-L // C) * C, self.spec.s_alloc) // P)

    def _worst_blocks(self, L: int, max_new: int) -> int:
        """Blocks a request can ever touch: the padded prefill plus decode
        writes at positions [L, L + max_new - 1), clamped to s_alloc."""
        C, P = self.chunk, self.spec.page_size
        hi = min(max(-(-L // C) * C, L + max_new - 1), self.spec.s_alloc)
        return -(-hi // P)

    def _admit_blocks(self, ent: SchedEntry) -> int:
        """Blocks admission covers: the padded prefill (on-demand) or the
        worst case through the remaining ``max_new`` budget (reserved)."""
        L = len(ent.tokens)
        if self.on_demand:
            return self._prefill_blocks(L)
        return self._worst_blocks(L, ent.req.max_new_tokens - len(ent.out))

    def _plan(self, ent: SchedEntry, n_cached: int, n_swap: int = 0):
        """Admission plan given ``n_cached`` matched prefix blocks and
        ``n_swap`` host-store blocks after them.  The first position that
        must run is ``p0 = min((n_cached + n_swap) * P, L - 1)`` (the
        last token always reruns: its logits seed decoding); chunks start
        on C boundaries, so the first live chunk is ``ci0 = p0 // C``,
        and a cached block overlapping ``[ci0 * C, ...)`` is CoW
        duplicated.  Restored blocks land in fresh private pages and need
        no copy (a recompute over one rewrites the same K/V).  Returns
        ``(total, ci0, n_keep, n_cow, need, n_swap)``: ``n_keep`` cached
        blocks stay mapped read-only, ``n_cow`` are copied, and ``need``
        fresh pages cover the copies, the restored blocks and the rest."""
        C, P = self.chunk, self.spec.page_size
        L = len(ent.tokens)
        total = self._admit_blocks(ent)
        n_cached = min(n_cached, total)
        n_swap = min(n_swap, total - n_cached)
        p0 = min((n_cached + n_swap) * P, L - 1)
        ci0 = p0 // C
        n_keep = min(n_cached, (ci0 * C) // P)
        n_cow = n_cached - n_keep
        need = (total - n_cached) + n_cow
        return total, ci0, n_keep, n_cow, need, n_swap

    def _pages_needed(self, req: Request, n_cached: int = 0) -> int:
        """Fresh pages admission allocates for a fresh ``req``."""
        return self._plan(self._transient_entry(req), n_cached)[4]

    def _transient_entry(self, req: Request) -> SchedEntry:
        """A throwaway entry for planning and error paths (never queued)."""
        return SchedEntry(req=req, priority=0, tokens=req.prompt, out=[],
                          seq=-1, enqueue_tick=0, t_submit=0.0,
                          t_enqueue=0.0)

    def _match_blocks(self, ent: SchedEntry) -> int:
        """Cached full-page prefix length (blocks), taking no reference."""
        if self.prefix is None:
            return 0
        return len(self.prefix.match(ent.tokens, record=False))

    def _tenant_pages(self) -> dict:
        """Pool pages each tenant's live slots reference (a shared page
        counts once per referencing tenant)."""
        held: dict = {}
        for s in self.slots:
            if s is not None:
                t = tenant_of(s["req"])
                held[t] = held.get(t, 0) + len(s["blocks"])
        return held

    def _next_entry(self) -> Optional[SchedEntry]:
        """The admission head: best-first (effective priority, then the
        lightest-loaded tenant, then FIFO), except that a tenant at its
        page quota is passed over while an under-quota tenant has work
        queued; with only over-quota work waiting the best admits anyway
        (soft, work-conserving)."""
        held = self._tenant_pages()
        ent = self.sched.peek(tenant_load=held)
        if (ent is not None and self.tenant_page_quota
                and held.get(tenant_of(ent.req), 0)
                >= self.tenant_page_quota):
            alt = self.sched.peek(
                eligible=lambda e: (held.get(tenant_of(e.req), 0)
                                    < self.tenant_page_quota),
                tenant_load=held)
            if alt is not None:
                ent = alt
        return ent

    def _alloc_with_evict(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, evicting LRU unreferenced cached
        prefixes when that can cover the shortfall."""
        pages = self.pages.alloc(n)
        if pages is None and self.prefix is not None:
            short = n - self.pages.available
            if self.prefix.evictable() >= short:
                self.prefix.evict(short)
                pages = self.pages.alloc(n)
        return pages

    def _cow(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate page ``src`` into the fresh ``dst``
        across every layer's pool (eager, outside the forward set)."""
        tel = self.tel
        t0 = tel.now()
        with tel.annotate("repro_torch.serve.cow_copy"):
            lm.cache_copy_page(self.caches, src, dst)
            if tel.enabled:
                self._sync()
        t1 = tel.now()
        tel.event("cow_copy", t0=t0, t1=t1, src=src, dst=dst)
        tel.observe("phase.cow_s", t1 - t0)
        self.cow_copies += 1

    def _admit(self, slot_i: int) -> str:
        """Prefill the scheduler's best entry into a free slot.  Returns
        'admitted', 'finished' (done on its first token: the slot is free
        again) or 'blocked' (empty queue or pool short: the best entry
        waits, nothing overtakes it).  A resumed entry's tokens are
        prompt + generated so far: the replay recomputes the dropped K/V
        and its last logits continue the argmax chain; host-store hits
        after the device hits are restored instead of replayed."""
        ent = self._next_entry()
        if ent is None:
            return "blocked"
        if self.faults.fire("admit_stall"):
            self._injected_block = True   # the head waits one round
            return "blocked"
        tokens = ent.tokens
        L = len(tokens)
        # record=False: a blocked head re-matches every round
        hits = self.prefix.match(tokens, record=False) \
            if self.prefix is not None else []
        # host-store hits fill in after the device hits (only a
        # consecutive run maps, and a device page is cheaper)
        swap_hits = self.swap.match(tokens, start_block=len(hits)) \
            if self.swap is not None else []
        total, ci0, n_keep, n_cow, need, n_swap = self._plan(
            ent, len(hits), len(swap_hits))
        hits = hits[: n_keep + n_cow]
        swap_hits = swap_hits[:n_swap]
        if hits:
            # held so that eviction (ours, below) cannot reclaim them
            self.prefix.lock(hits)
        if self.faults.fire("alloc"):
            # injected exhaustion: as a short pool, drop the locks, wait
            if hits:
                self.pages.release([n.page_id for n in hits])
            self._injected_block = True
            return "blocked"
        page_ids = self._alloc_with_evict(need)
        if page_ids is None and hits:
            # the locked hits can pin the pool themselves: admit without
            # the cache (a request that fits alone always admits once
            # every slot is free); host-store hits pin no pool page, so
            # they are matched again from block 0
            self.pages.release([n.page_id for n in hits])
            hits = []
            swap_hits = self.swap.match(tokens, start_block=0) \
                if self.swap is not None else []
            total, ci0, n_keep, n_cow, need, n_swap = self._plan(
                ent, 0, len(swap_hits))
            swap_hits = swap_hits[:n_swap]
            page_ids = self._alloc_with_evict(need)
        if page_ids is None:
            return "blocked"
        self.sched.pop(ent)
        # live again: its host pages are plain shared cache from here on
        ent.swap_blocks = 0
        tel, rid = self.tel, ent.req.rid
        t_adm = tel.now()
        # the queued span covers the latest (re-)enqueue; a resume shows
        # preempted -> queued -> resumed on the request's track
        tel.event("queued", rid, t0=tel.rel(ent.t_enqueue), t1=t_adm,
                  preemptions=ent.preemptions)
        if swap_hits:
            tel.event("swapped_in", rid, blocks=len(swap_hits))
        tel.event("resumed" if ent.out else "admitted", rid,
                  cached_blocks=len(hits), restored_blocks=len(swap_hits),
                  fresh_pages=need, cow=n_cow)
        C, P = self.chunk, self.spec.page_size
        if self.prefix is not None:
            self.prefix.record_lookup(len(hits), L // P - len(hits))
        blocks = np.zeros(total, np.int32)
        shared = np.zeros(total, bool)
        for b, node in enumerate(hits):
            blocks[b] = node.page_id
            shared[b] = True
        blocks[len(hits):] = page_ids[: total - len(hits)]
        # CoW the cached blocks the suffix prefill writes
        cow_pool = page_ids[total - len(hits):]
        for j, b in enumerate(range(n_keep, n_keep + n_cow)):
            src, dst = int(blocks[b]), int(cow_pool[j])
            self._cow(src, dst)
            self.pages.release([src])     # drop the map reference
            blocks[b] = dst
            shared[b] = False
        if swap_hits:
            # restored before the block table maps the pages: every
            # position below the first live chunk holds its K/V by the
            # time the suffix prefill (or the first decode) reads it
            lo = len(hits)
            self._swap_restore(swap_hits, blocks[lo: lo + len(swap_hits)])
            self.swap_restored_tokens += len(swap_hits) * P
        row = np.zeros(self.spec.max_blocks, np.int32)
        row[:total] = blocks
        self.block_table[slot_i] = row
        n_chunks = -(-L // C)
        logits = None
        # perf_counter, not tel.now() (NULL's clock reads 0): the swap
        # policy needs real rates with telemetry off
        t0p = time.perf_counter() if self.swap_policy is not None else 0.0
        for ci in range(ci0, n_chunks):
            buf = np.zeros((1, C), np.int32)
            seg = tokens[ci * C:(ci + 1) * C]
            buf[0, : len(seg)] = seg
            last = (L - 1) - ci * C if ci == n_chunks - 1 else 0
            t0c = tel.now()
            with tel.annotate("repro_torch.serve.prefill_chunk"):
                logits = self._prefill_chunk(buf, ci * C, row, last)
                if tel.enabled:
                    self._sync()
            t1c = tel.now()
            tel.event("prefill_chunk", rid, t0=t0c, t1=t1c, chunk=ci,
                      start=ci * C, tokens=C)
            tel.observe("phase.prefill_chunk_s", t1c - t0c)
        run_tokens = (n_chunks - ci0) * C
        self.prefill_tokens_run += run_tokens
        self.prefill_tokens_saved += ci0 * C
        if ent.out:
            self.resumes += 1
            self.resume_prefill_tokens += run_tokens
        tok0 = int(torch.argmax(logits))
        if self.swap_policy is not None and n_chunks > ci0:
            # the argmax read waited for the device: the window covers the
            # chunks' execution
            self.swap_policy.observe_prefill(
                run_tokens, time.perf_counter() - t0p)
        if not ent.out:
            self.ttft_s.observe(time.monotonic() - ent.t_submit)
        self.lens[slot_i] = L
        entry = {"req": ent.req, "out": ent.out + [tok0], "cur": tok0,
                 "blocks": blocks, "shared": shared,
                 "prio": ent.priority, "sched": ent}
        if self._done_now(entry) or L >= self.S_max:
            self._finish(slot_i, entry)
            return "finished"
        self.slots[slot_i] = entry
        return "admitted"

    # -- lifecycle -----------------------------------------------------------

    def _done_now(self, entry) -> bool:
        return ((self.eos_id is not None and entry["out"][-1] == self.eos_id)
                or len(entry["out"]) >= entry["req"].max_new_tokens)

    def _history(self, slot_i: int, entry) -> np.ndarray:
        """The slot's token history, prompt + generated; positions ``[0,
        lens)`` of it are written (the last emitted token is not)."""
        full = np.concatenate([np.asarray(entry["req"].prompt, np.int32),
                               np.asarray(entry["out"], np.int32)])
        lens = int(self.lens[slot_i])
        assert len(full) == lens + 1, \
            f"slot {slot_i} token accounting diverged: {len(full)} vs " \
            f"lens {lens} + 1"
        return full

    def _release_slot(self, slot_i: int, entry, park: bool = True):
        """Reset the slot.  With ``park``, its fully written pages (keyed
        by the token history) move into the prefix cache and the rest
        free; without, every page frees (a shared page drops this slot's
        reference only)."""
        full = self._history(slot_i, entry)
        blocks = entry["blocks"]
        n_full = int(self.lens[slot_i]) // self.spec.page_size
        if park and self.prefix is not None and n_full:
            self.prefix.insert(full, blocks[:n_full])
            blocks = blocks[n_full:]
        if len(blocks):
            self.pages.release(list(blocks))
        self.block_table[slot_i] = 0      # scratch page: no stale aliasing
        self.lens[slot_i] = 0
        self.slots[slot_i] = None

    def _finish(self, slot_i: int, entry) -> None:
        req = entry["req"]
        req.output = np.asarray(entry["out"], np.int32)
        req.finish_reason = (
            "stop" if (self.eos_id is not None
                       and entry["out"][-1] == self.eos_id) else "length")
        self.done.append(req)
        self._tenant_bump(tenant_of(req), "completed")
        self.tel.event("finished", req.rid, tokens=len(entry["out"]),
                       pages=len(entry["blocks"]))
        self._release_slot(slot_i, entry)

    def _preempt(self, slot_i: int) -> None:
        """Park a live slot on pool exhaustion.  Its fully written pages
        are either copied to the host store (swap tier on and the policy
        says so: every device page then frees, and the resume restores
        them) or moved into the prefix cache (recompute: evictable, and
        mapped back at resume if they survive); the request requeues with
        its generated tokens.  A put refused by the host budget only
        costs replay."""
        entry = self.slots[slot_i]
        ent: SchedEntry = entry["sched"]
        lens = int(self.lens[slot_i])
        full = self._history(slot_i, entry)
        n_full = lens // self.spec.page_size
        swapped = 0
        if (n_full and self.swap is not None
                and self.swap_policy.decide(
                    replay_tokens=lens,
                    nbytes=n_full * self.page_bytes())):
            # the ring is drained inside: every gather has landed on the
            # host before the pages are released below
            swapped = self._swap_out(full, entry["blocks"][:n_full],
                                     tenant=tenant_of(entry["req"]))
        parked = n_full if not swapped and self.prefix is not None else 0
        self._release_slot(slot_i, entry, park=not swapped)
        ent.tokens = full
        ent.out = list(entry["out"])
        # what a cancel or deadline shed while parked purges (refused
        # puts leave gaps; purge skips them)
        ent.swap_blocks = n_full if swapped else 0
        self.sched.requeue(ent)
        self.preemptions += 1
        self.preempted_tokens += lens
        self.tel.event("preempted", entry["req"].rid, tokens_dropped=lens,
                       pages_parked=parked, pages_swapped=swapped)
        if swapped:
            self.tel.event("swapped_out", entry["req"].rid, pages=swapped,
                           bytes=swapped * self.page_bytes())

    # -- cancellation / deadlines --------------------------------------------

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """End request ``rid`` from any state and release what it holds:
        a live slot parks its written full pages in the prefix cache and
        frees the rest; a queued entry leaves the queue (no queue-wait
        observation), and a swapped-out one has its host pages purged.
        The request lands in ``failed`` with its partial output, a typed
        ``error`` and ``finish_reason``.  False when ``rid`` is not in
        flight (cancel is idempotent)."""
        for i in range(self.B):
            e = self.slots[i]
            if e is not None and e["req"].rid == rid:
                self._terminate_slot(i, e, reason)
                return True
        for ent in self.sched.queued():
            if ent.req.rid == rid:
                self.sched.remove(ent)
                self._purge_swapped(ent)
                self._mark_terminated(ent.req, reason, ent.out)
                return True
        return False

    def _terminate_slot(self, slot_i: int, entry, reason: str) -> None:
        """Release a live slot as a recompute preemption does, but end
        the request instead of parking it."""
        self._release_slot(slot_i, entry)
        self._mark_terminated(entry["req"], reason, entry["out"])

    def _purge_swapped(self, ent: SchedEntry) -> None:
        """Drop a parked entry's host-store pages (no-op unless it owns
        swapped blocks)."""
        if self.swap is not None and ent.swap_blocks:
            self.swap.purge(ent.tokens, ent.swap_blocks)
            ent.swap_blocks = 0

    def _mark_terminated(self, req: Request, reason: str, out) -> None:
        """Terminal bookkeeping of a cancel or a deadline shed."""
        req.output = np.asarray(list(out), np.int32)
        req.finish_reason = reason
        if reason == "deadline":
            req.error = DeadlineExceededError(
                f"request {req.rid} exceeded its deadline budget")
            self.expired += 1
            self._tenant_bump(tenant_of(req), "expired")
        else:
            req.error = CancelledError(f"request {req.rid} cancelled")
            self.cancelled += 1
            self._tenant_bump(tenant_of(req), "cancelled")
        self.failed.append(req)
        self.tel.event("cancelled", req.rid, reason=reason,
                       tokens=len(req.output))

    def _enforce_deadlines(self) -> None:
        """Shed every request past its TTL, queued (host pages purged) or
        live, once per step before admissions: a doomed entry never
        prefills.  Never mid-forward."""
        now = time.monotonic()
        for ent in list(self.sched.queued()):
            if (ent.deadline_s is not None
                    and now - ent.t_submit >= ent.deadline_s):
                self.sched.remove(ent)
                self._purge_swapped(ent)
                self._mark_terminated(ent.req, "deadline", ent.out)
        for i in range(self.B):
            e = self.slots[i]
            if e is None:
                continue
            dl = e["sched"].deadline_s
            if dl is not None and now - e["sched"].t_submit >= dl:
                self._terminate_slot(i, e, "deadline")

    def _tenant_bump(self, tenant: str, key: str) -> None:
        d = self.tenant_counters.setdefault(tenant, {})
        d[key] = d.get(key, 0) + 1

    # -- host-RAM swap tier ---------------------------------------------------

    def page_bytes(self) -> int:
        """Bytes of one physical page across every layer's pool (codes
        and scales): the swap policy's unit, a host page's footprint."""
        return self.kv_pool_bytes() // self.spec.n_pages

    def _swap_out(self, full, blocks, tenant=None) -> int:
        """Copy the written full pages ``blocks`` of token history
        ``full`` to the host through the staging ring and put each in the
        store.  Returns how many are host-resident afterwards.  Each
        transaction gathers the ring's width of pages (a short tail pads
        with the scratch page, sliced off before storing)."""
        ring = self.swap_ring
        R = ring.width
        t0 = time.perf_counter()
        stored = 0
        bytes0 = self.swap_out_bytes
        for base in range(0, len(blocks), R):
            tail = [int(b) for b in blocks[base: base + R]]
            pids = np.zeros(R, np.int64)     # scratch-page padding
            pids[: len(tail)] = tail
            with self.tel.annotate("repro_torch.serve.swap_gather"):
                dev = lm.cache_swap_out(
                    self.caches, torch.from_numpy(pids).to(self.device))
            for meta, host in ring.stage((base, len(tail)), dev):
                stored += self._store_staged(full, meta, host, tenant)
        for meta, host in ring.drain():
            stored += self._store_staged(full, meta, host, tenant)
        moved = self.swap_out_bytes - bytes0
        if moved:
            self.swap_policy.observe_copy(moved, time.perf_counter() - t0)
        self.swapped_out_pages += stored
        if self.tel.enabled and stored:
            self.tel.inc("swap.out_pages", stored)
            self.tel.inc("swap.out_bytes", moved)
        return stored

    def _store_staged(self, full, meta, host, tenant=None) -> int:
        """Split one matured transaction (leaves ``[n_layers, R, P,
        ...]``) into per-page copies, ``[n_layers, P, ...]`` and
        C-contiguous, and store each under its content key."""
        base, n = meta
        stored = 0
        for j in range(n):
            page = tree_map(lambda a: a[:, j].copy(), host)
            if self.swap.put(full, base + j, page, tenant=tenant):
                stored += 1
                self.swap_out_bytes += int(
                    sum(a.nbytes for a in tree_leaves(page)))
        return stored

    def _swap_restore(self, host_pages, dest) -> None:
        """Scatter host pages into the fresh device pages ``dest`` in
        ring-width transactions (a short tail repeats its last page onto
        the scratch page), in place; then wait for the device, so the
        policy learns copy times, not launch times."""
        R = self.swap_ring.width
        t0 = time.perf_counter()
        nbytes = 0
        for base in range(0, len(host_pages), R):
            tail = host_pages[base: base + R]
            pids = np.zeros(R, np.int64)
            pids[: len(tail)] = dest[base: base + len(tail)]
            padded = list(tail) + [tail[-1]] * (R - len(tail))
            staged = tree_map(lambda *xs: stage_to_device(xs, self.device),
                              *[p.data for p in padded])
            with self.tel.annotate("repro_torch.serve.swap_scatter"):
                lm.cache_swap_in(self.caches, staged,
                                 torch.from_numpy(pids).to(self.device))
            nbytes += sum(p.nbytes for p in tail)
        self._sync()
        self.swap_policy.observe_copy(nbytes, time.perf_counter() - t0)
        self.swapped_in_pages += len(host_pages)
        self.swap_in_bytes += nbytes
        if self.tel.enabled:
            self.tel.inc("swap.in_pages", len(host_pages))
            self.tel.inc("swap.in_bytes", nbytes)

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
        """Drain the queue; returns finished requests.  With telemetry on
        and a trace path set, the drain exports the Chrome trace (and a
        JSONL twin) when it completes."""
        while self.step():
            pass
        if self.trace_path and self.tel.enabled:
            self.export_trace()
        return self.done

    def step(self) -> bool:
        """One round: an injected cancel if the plan fires one, deadline
        sheds, admissions into free slots, then one decode or verify
        forward over the live slots (preempting first if on-demand growth
        finds the pool empty), then refill.  Returns True while work
        remains."""
        self.sched.tick()
        self._injected_block = False
        if self.faults.fire("cancel"):
            # a client disconnect: a seeded pick over everything in
            # flight, live slots first, then the queue
            rids = [s["req"].rid for s in self.slots if s is not None]
            rids += [e.req.rid for e in self.sched.queued()]
            if rids:
                self.cancel(self.faults.choice(rids))
        self._enforce_deadlines()
        mid = any(s is not None for s in self.slots)
        self._fill_free_slots(mid_decode=mid)
        live = [i for i in range(self.B) if self.slots[i] is not None]
        self.peak_live_slots = max(self.peak_live_slots, len(live))
        if not live:
            if len(self.sched):
                if self._injected_block:
                    return True           # a fake fault: retry next round
                ent = self.sched.peek()
                raise PoolExhaustedError(
                    f"request {ent.req.rid} needs "
                    f"{self._plan(ent, self._match_blocks(ent))[4]} "
                    f"fresh pages; pool has {self.spec.n_pages - 1}")
            if self.check_invariants:
                self._check()
            return False
        drafts = self._propose(live)
        t0r = self.tel.now()
        live, drafts = self._reserve_step(live, drafts)
        self.tel.observe("phase.reserve_s", self.tel.now() - t0r)
        freed = True        # every slot preempted: admit next round
        if live:
            if any(len(drafts[i]) for i in live):
                freed = self._verify_once(live, drafts)
            else:
                # no slot drafted (speculation off, an n-gram miss, or
                # every draft clamped to 0): the [B, 1] decode shape
                freed = self._decode_once(live)
        if freed:
            self._fill_free_slots(mid_decode=True)
            self.peak_live_slots = max(
                self.peak_live_slots, sum(s is not None for s in self.slots))
        if self.check_invariants:
            self._check()
        if self.tel.enabled:
            self.tel.set_gauge("live_slots",
                               sum(s is not None for s in self.slots))
            self.tel.set_gauge("queued", len(self.sched))
            self.tel.set_gauge("pool_pages_in_use", self.pages.in_use)
        return bool(len(self.sched) or any(s is not None for s in self.slots))

    # -- on-demand growth / preemption ---------------------------------------

    def _grow_to(self, slot_i: int, entry, last_blk: int) -> bool:
        """Cover block ``last_blk`` in the slot's table (on-demand
        growth); False when the pool and evictable prefixes cannot."""
        while len(entry["blocks"]) <= last_blk:
            # the injected exhaustion fires only where a real alloc is due
            if self.faults.fire("alloc"):
                return False
            pages = self._alloc_with_evict(1)
            if pages is None:
                return False
            b = len(entry["blocks"])
            entry["blocks"] = np.append(entry["blocks"], np.int32(pages[0]))
            entry["shared"] = np.append(entry["shared"], False)
            self.block_table[slot_i, b] = pages[0]
            self.grown_pages += 1
            self.tel.event("grow_page", entry["req"].rid, page=pages[0],
                           block=b)
        return True

    def _reserve_step(self, live: List[int], drafts: dict):
        """Secure this step's page writes for every live slot, highest
        priority first.  The one-token write is worth preempting for: on
        exhaustion the policy picks a victim (possibly the needer itself)
        and parks it.  A draft that cannot get pages is truncated, never
        preempted for.  Returns the slots that stay live and the (possibly
        truncated) drafts."""
        P = self.spec.page_size
        order = sorted(live, key=lambda i: (-self.slots[i]["prio"], i))
        dropped = set()
        for i in order:
            if i in dropped:
                continue
            entry = self.slots[i]
            lens = int(self.lens[i])
            while not self._grow_to(i, entry, lens // P):
                cands = [(j, self.slots[j]["prio"],
                          len(self.slots[j]["blocks"]),
                          len(self.slots[j]["out"]))
                         for j in live if j not in dropped]
                vict = self.sched.select_victim(cands)
                if vict is None:
                    raise PoolExhaustedError(
                        f"pool exhausted growing slot {i} and "
                        f"serve_preempt_policy={self.sched.policy!r} "
                        "allows no victim")
                self._preempt(vict)
                dropped.add(vict)
                if vict == i:
                    break
            if i in dropped:
                continue
            d = drafts.get(i)
            if d is not None and len(d):
                while len(d) and not self._grow_to(
                        i, entry, (lens + len(d)) // P):
                    # shrink to what the allocated pages hold; the failed
                    # grow means len(d) exceeds the fit, so this ends
                    fit = len(entry["blocks"]) * P - 1 - lens
                    d = d[: max(0, fit)]
                drafts[i] = d
        return [i for i in live if i not in dropped], drafts

    def _ensure_writable(self, slot_i: int, entry, blk: int) -> None:
        """Copy-on-write guard before a decode write to block ``blk``
        (keeps "no write lands on a page with other readers" local)."""
        if blk >= len(entry["shared"]) or not entry["shared"][blk]:
            return
        pages = self._alloc_with_evict(1)
        if pages is None:
            raise PoolExhaustedError(
                "pool exhausted during copy-on-write; admission should "
                "have reserved this page")
        src, dst = int(entry["blocks"][blk]), pages[0]
        self._cow(src, dst)
        self.pages.release([src])
        entry["blocks"][blk] = dst
        entry["shared"][blk] = False
        self.block_table[slot_i, blk] = dst

    # -- speculative decoding ------------------------------------------------

    def _draft_cap(self, i: int, entry) -> int:
        """Longest draft slot ``i`` may verify this step: a full accept
        (``k`` drafts + 1 bonus) must not overshoot ``max_new`` or
        ``S_max``; reserved mode also clamps to the slot's allocated
        pages (on-demand mode grows or truncates in ``_reserve_step``)."""
        lens = int(self.lens[i])
        remaining = entry["req"].max_new_tokens - len(entry["out"])
        alloc_room = (self.S_max if self.on_demand
                      else len(entry["blocks"]) * self.spec.page_size)
        room = min(self.S_max, alloc_room) - 1 - lens
        return max(0, min(self.spec_k, remaining - 1, room))

    def _propose(self, live: List[int]) -> dict:
        """Per-slot draft proposals (empty arrays when not drafting)."""
        empty = np.zeros(0, np.int32)
        if self.drafter is None:
            return {i: empty for i in live}
        drafts = {}
        for i in live:
            entry = self.slots[i]
            cap = self._draft_cap(i, entry)
            if cap <= 0:
                drafts[i] = empty
                continue
            ctx = np.concatenate([np.asarray(entry["req"].prompt, np.int32),
                                  np.asarray(entry["out"], np.int32)])
            d = np.asarray(self.drafter.propose(ctx, cap), np.int32)
            drafts[i] = d[:cap]
        return drafts

    def _accept(self, i: int, entry, tokens):
        """Append ``tokens`` to slot ``i`` one by one with a sequential
        decode's finish checks (eos drops the rest).  Returns
        ``(appended, finished)``."""
        for n, t in enumerate(tokens):
            self.lens[i] += 1
            tok = int(t)
            entry["out"].append(tok)
            entry["cur"] = tok
            self.gen_tokens += 1
            if self._done_now(entry) or self.lens[i] >= self.S_max:
                self._finish(i, entry)
                return n + 1, True
        return len(tokens), False

    def _decode_once(self, live: List[int]) -> bool:
        """One ``[B, 1]`` decode step; True if any slot finished."""
        P = self.spec.page_size
        cur = np.zeros((self.B, 1), np.int32)
        for i in live:
            self._ensure_writable(i, self.slots[i], int(self.lens[i]) // P)
            cur[i, 0] = self.slots[i]["cur"]
        tel = self.tel
        t0 = tel.now()
        with tel.annotate("repro_torch.serve.decode_step"):
            logits = self._decode(cur, self.lens, self.block_table)
        self.decode_steps += 1
        self.slot_steps += len(live)
        nxt = torch.argmax(logits, -1).cpu().numpy()   # the step's host read
        # the host read waited for the device, so t1 covers the step; the
        # events go out before _accept so 'finished' follows 'decode'
        t1 = tel.now()
        tel.observe("phase.decode_s", t1 - t0)
        freed = False
        for i in live:
            tel.event("decode", self.slots[i]["req"].rid, t0=t0, t1=t1,
                      pos=int(self.lens[i]))
            _, fin = self._accept(i, self.slots[i], [int(nxt[i])])
            freed |= fin
        return freed

    def _verify_once(self, live: List[int], drafts: dict) -> bool:
        """One ``[B, k+1]`` verify step: score every slot's current token
        and draft in one forward, keep the longest draft prefix matching
        the argmax chain plus one bonus token.  Rejected rows cost
        nothing: ``lens`` advances over accepted tokens only, so their
        writes sit past every later mask until overwritten.  Every block
        the window's valid writes touch is copy-on-write guarded first."""
        K1 = self.spec_k + 1
        P = self.spec.page_size
        toks = np.zeros((self.B, K1), np.int32)
        n_writes = np.zeros(self.B, np.int32)
        for i in live:
            entry = self.slots[i]
            d = drafts[i]
            toks[i, 0] = entry["cur"]
            toks[i, 1: 1 + len(d)] = d
            n_writes[i] = 1 + len(d)
            lens = int(self.lens[i])
            for blk in range(lens // P, (lens + len(d)) // P + 1):
                self._ensure_writable(i, entry, blk)
        tel = self.tel
        t0 = tel.now()
        with tel.annotate("repro_torch.serve.verify_step"):
            logits = self._verify(toks, self.lens, n_writes, self.block_table)
        self.spec_steps += 1
        self.slot_steps += len(live)
        greedy = torch.argmax(logits, -1).cpu().numpy()      # [B, K1]
        t1 = tel.now()
        tel.observe("phase.verify_s", t1 - t0)
        freed = False
        for i in live:
            entry = self.slots[i]
            d, g = drafts[i], greedy[i]
            m = 0
            while m < len(d) and g[m] == d[m]:
                m += 1
            tel.event("verify", entry["req"].rid, t0=t0, t1=t1,
                      proposed=len(d), matched=m, pos=int(self.lens[i]))
            self.spec_proposed += len(d)
            # g[:m] is the accepted draft and g[m] the bonus token (for
            # m == 0, row 0's argmax: the plain decode step's token); an
            # eos inside the window drops the rest of the match
            appended, fin = self._accept(i, entry, g[: m + 1])
            self.spec_accepted += min(appended, m)
            freed |= fin
        return freed

    # -- introspection -------------------------------------------------------

    def _check(self) -> None:
        """Structural checks (``serve_check_invariants``): page-pool
        partition, tree consistency, swap ledgers, queue sanity."""
        self.pages.check()
        if self.prefix is not None:
            self.prefix.check()
        if self.swap is not None:
            self.swap.check()
        self.sched.check()

    def kv_pool_bytes(self) -> int:
        """Device bytes of the whole paged KV pool (every layer)."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for seg in self.caches for pool in seg.values()
                       for leaf in pool.values()))

    def spec_stats(self) -> dict:
        """Decode-phase accounting: ``tokens_per_step`` is tokens emitted
        per live-slot participation in a decode/verify forward, so plain
        greedy decode measures exactly 1.0 at any batch size."""
        return {
            "decode_steps": self.decode_steps,
            "spec_steps": self.spec_steps,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "accept_rate": self.spec_accepted / max(self.spec_proposed, 1),
            "tokens_per_step": self.gen_tokens / max(self.slot_steps, 1),
        }

    def sched_stats(self) -> dict:
        """Scheduling and preemption accounting, with the bounded TTFT
        and queue-wait summaries."""
        return {
            **self.sched.stats(),
            "on_demand": self.on_demand,
            "cancelled": self.cancelled,
            "expired": self.expired,
            "failed": len(self.failed),
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "resume_prefill_tokens": self.resume_prefill_tokens,
            "preempted_tokens": self.preempted_tokens,
            "swapped_out_pages": self.swapped_out_pages,
            "swapped_in_pages": self.swapped_in_pages,
            "swap_restored_tokens": self.swap_restored_tokens,
            "grown_pages": self.grown_pages,
            "peak_live_slots": self.peak_live_slots,
            "pool_pages_peak": self.pages.peak,
            "pool_exhaustions": self.pages.exhaustions,
            "ttft_s": self.ttft_s.summary(),
        }

    def pool_stats(self) -> dict:
        """Page-pool accounting."""
        return {
            "n_pages": self.pages.n_pages,
            "usable": self.pages.n_pages - 1,
            "in_use": self.pages.in_use,
            "available": self.pages.available,
            "allocs": self.pages.allocs,
            "frees": self.pages.frees,
            "peak": self.pages.peak,
            "exhaustions": self.pages.exhaustions,
            "cow_copies": self.cow_copies,
            "grown_pages": self.grown_pages,
            "pool_bytes": self.kv_pool_bytes(),
        }

    def swap_stats(self) -> dict:
        """Swap-tier accounting: store occupancy, the policy's choices
        and measured rates, traffic each way, and ``restored_tokens``
        (positions resumed without replay)."""
        if self.swap is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "store": self.swap.stats(),
            "policy": self.swap_policy.stats(),
            "ring_width": self.swap_ring.width,
            "ring_transactions": self.swap_ring.transactions,
            "swapped_out_pages": self.swapped_out_pages,
            "swapped_in_pages": self.swapped_in_pages,
            "swap_out_bytes": self.swap_out_bytes,
            "swap_in_bytes": self.swap_in_bytes,
            "restored_tokens": self.swap_restored_tokens,
            "page_bytes": self.page_bytes(),
        }

    def tenant_stats(self) -> dict:
        """Per-tenant accounting: live pages and queue depth, terminal
        counters and swap bytes per tenant, and the configured quotas."""
        held = self._tenant_pages()
        queued: dict = {}
        for e in self.sched.queued():
            t = tenant_of(e.req)
            queued[t] = queued.get(t, 0) + 1
        swap_b = self.swap.tenant_bytes if self.swap is not None else {}
        names = sorted(set(held) | set(queued)
                       | set(self.tenant_counters) | set(swap_b))
        per = {}
        for t in names:
            c = self.tenant_counters.get(t, {})
            per[t] = {
                "pages_held": held.get(t, 0),
                "queued": queued.get(t, 0),
                "completed": c.get("completed", 0),
                "cancelled": c.get("cancelled", 0),
                "expired": c.get("expired", 0),
                "swap_bytes": swap_b.get(t, 0),
            }
        return {
            "page_quota": self.tenant_page_quota,
            "queue_limit": self.tenant_queue_limit,
            "swap_budget": (self.swap.tenant_budget
                            if self.swap is not None else 0),
            "tenants": per,
        }

    def metrics(self) -> dict:
        """One JSON-serialisable snapshot of every subsystem: pool,
        prefix cache, speculation, KV quantisation, scheduler, swap tier,
        tenants, fault injection and the autotuner's process-wide lookup
        and tune counters; the ``telemetry`` section (registry and tracer
        depth) appears only with telemetry on."""
        qs = qspec_for(self.cfg)
        doc = {
            "pool": self.pool_stats(),
            "prefix_cache": (self.prefix.stats() if self.prefix is not None
                             else {"enabled": False}),
            "spec": {**self.spec_stats(),
                     "k": self.spec_k,
                     "gen_tokens": self.gen_tokens,
                     "refills": self.refills,
                     "prefill_tokens_run": self.prefill_tokens_run,
                     "prefill_tokens_saved": self.prefill_tokens_saved},
            "quant": {"kv_dtype": qs.dtype, "quantised": qs.quantised,
                      "pool_bytes": self.kv_pool_bytes()},
            "scheduler": self.sched_stats(),
            "swap": self.swap_stats(),
            "tenants": self.tenant_stats(),
            "faults": self.faults.stats(),
            "autotune": autotune.snapshot_stats(),
        }
        if self.tel.enabled:
            doc["telemetry"] = {
                **self.tel.registry.snapshot(),
                "trace_events": len(self.tel.tracer.events),
                "trace_dropped": self.tel.tracer.dropped,
            }
        return jsonable(doc)

    def export_trace(self, chrome_path: Optional[str] = None,
                     jsonl_path: Optional[str] = None) -> dict:
        """Write the lifecycle trace: Chrome trace-event JSON at
        ``chrome_path`` (default ``trace_path``) and a JSONL twin
        (default: the same path + 'l').  ``{}`` when telemetry is off or
        no path is given."""
        path = chrome_path or self.trace_path
        if not path or not self.tel.enabled:
            return {}
        return self.tel.export(chrome_path=path,
                               jsonl_path=jsonl_path or path + "l")

    def compiled_shapes(self) -> dict:
        """Per-forward compile counts: captured CUDA graphs on the card,
        distinct argument shapes seen on the CPU (what ``jit`` would
        trace)."""
        return {k: f.n_compiled() for k, f in self.forwards.items()}

    def check_compiled(self) -> None:
        """At most one compiled shape per forward (chunk, decode and, with
        a drafter, verify; the CoW page copy and the swap gather and
        scatter run eagerly, outside the set)."""
        for name, n in self.compiled_shapes().items():
            assert n <= 1, f"{name} forward compiled {n} shapes"
