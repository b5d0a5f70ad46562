"""Dense-cache serving loop with slot-based continuous batching (port of
``repro.serve.loop``): the oracle that ``serve.paged.PagedServeLoop`` is
held against.  Paged greedy outputs equal each request run solo through
this loop at equal KV quantisation (under a quantised
``serve_kv_dtype`` the dense caches hold round-tripped f32 values).

A static batch of B slots shares one decode position (prompts are
left-padded).  A finished slot is refilled mid-decode: the queue head,
when its prompt fits the current shared length ``L``, is prefilled alone
left-padded to ``L`` and its caches copied into the freed slot, so the
next decode step advances it with the running slots.  The loop runs
eagerly (no CUDA graphs: it is an oracle), on the params' device.

It serves every decoder-only family: the dense and MoE families, MLA on
latent caches, and the recurrent families (xLSTM, RG-LRU hybrids) on
their states, whose leaves ``_write_slot`` copies like any cache leaf.
As in the reference, left padding runs through a recurrent state
unmasked, and a refill's prefill at a length past 64 that is not a
multiple of 64 raises in the xLSTM scan (``models.xlstm.chunked_scan``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import lm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    output: Optional[np.ndarray] = None   # generated tokens; a cancelled
                                          # or expired request's partial
                                          # output (a prefix of the full)
    priority: Optional[int] = None        # admission priority (higher =
                                          # sooner; None = the config's);
                                          # the dense loop is FIFO
    tenant: Optional[str] = None          # fairness label: page quotas,
                                          # swap-byte budgets; None = the
                                          # shared 'default' tenant
    deadline_s: Optional[float] = None    # TTL in seconds from submit;
                                          # None follows serve_deadline_s
    finish_reason: Optional[str] = None   # 'stop' (eos) | 'length' |
                                          # 'cancelled' | 'deadline'
    error: Optional[BaseException] = None  # CancelledError or
                                          # DeadlineExceededError of a
                                          # request that did not complete


class ServeLoop:
    """Greedy dense-cache serving of ``params`` (a ``ParamTree`` on
    ``device``): ``submit`` requests, then ``run`` drains the queue in
    batches of ``batch_slots`` and returns the finished requests."""

    def __init__(self, params, cfg, batch_slots: int = 4, s_max: int = 128,
                 eos_id: Optional[int] = None, device="cuda"):
        want = torch.device(device)
        have = next(params.parameters()).device
        if have.type != want.type or want.index not in (None, have.index):
            raise ValueError(f"params live on {have}, loop device is {want}")
        lm.segments_for(cfg)          # raises for families not ported
        if cfg.n_enc_layers:
            raise ValueError(
                f"{cfg.name}: an encoder-decoder config cannot be served by "
                "ServeLoop, whose prefill passes no frames (the reference's "
                "cannot either); serve it through lm.prefill(tokens, "
                "frames=...) and lm.decode_step")
        self.device = have
        self.params, self.cfg = params, cfg
        self.B, self.S_max = batch_slots, s_max
        self.eos_id = eos_id
        self.queue = deque()
        self.done: List[Request] = []
        self.refills = 0              # mid-decode slot refills

    def submit(self, req: Request):
        self.queue.append(req)

    def run(self) -> List[Request]:
        """Process the queue; greedy decoding.  Returns finished requests."""
        while self.queue:
            n = min(self.B, len(self.queue))
            batch = [self.queue.popleft() for _ in range(n)]
            self._run_batch(batch)
        return self.done

    # -- continuous batch ---------------------------------------------------

    def _argmax(self, logits) -> np.ndarray:
        return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)

    def _finish(self, slot):
        slot["req"].output = np.asarray(slot["out"], np.int32)
        self.done.append(slot["req"])

    @staticmethod
    @torch.no_grad()
    def _write_slot(caches, caches_one, i: int) -> None:
        """Copy a 1-request prefill cache into batch slot ``i`` (axis 1 of
        every ``[n_layers, B, ...]`` leaf), in place."""
        for seg, one in zip(caches, caches_one):
            for b, pool in seg.items():
                for name, leaf in pool.items():
                    leaf[:, i] = one[b][name][:, 0]

    def _try_refill(self, caches, cur_np, L: int, slot_i: int):
        """Admit the queue head into a freed slot if its prompt fits the
        current shared length ``L``.  Returns the slot entry or None."""
        if not self.queue or len(self.queue[0].prompt) > L or L >= self.S_max:
            return None
        req = self.queue.popleft()
        toks = np.zeros((1, L), np.int32)
        toks[0, L - len(req.prompt):] = req.prompt       # left-pad to L
        logits, caches_one = lm.prefill(
            self.params, torch.from_numpy(toks).to(self.device), self.cfg,
            S_max=self.S_max)
        self._write_slot(caches, caches_one, slot_i)
        del caches_one
        cur_np[slot_i, 0] = self._argmax(logits)[0]
        self.refills += 1
        return {"req": req, "out": []}

    def _run_batch(self, reqs: List[Request]):
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt       # left-pad
        logits, caches = lm.prefill(
            self.params, torch.from_numpy(toks).to(self.device), self.cfg,
            S_max=self.S_max)
        slots = [{"req": r, "out": []} for r in reqs]
        cur_np = self._argmax(logits)[:, None]
        step = 0
        while True:
            # 1) record the pending token per live slot; finish + free
            for i in range(B):
                slot = slots[i]
                if slot is None:
                    continue
                slot["out"].append(int(cur_np[i, 0]))
                hit_eos = (self.eos_id is not None
                           and slot["out"][-1] == self.eos_id)
                if hit_eos or len(slot["out"]) >= slot["req"].max_new_tokens:
                    self._finish(slot)
                    slots[i] = None
            # 2) refill freed slots: the next decode writes position
            #    S + step, so the refill's prefill covers [0, S + step)
            #    and its argmax is the request's first generated token
            for i in range(B):
                while slots[i] is None:
                    entry = self._try_refill(caches, cur_np, S + step, i)
                    if entry is None:
                        break
                    tok0 = int(cur_np[i, 0])
                    entry["out"].append(tok0)
                    done_now = (
                        (self.eos_id is not None and tok0 == self.eos_id)
                        or len(entry["out"]) >= entry["req"].max_new_tokens
                    )
                    if done_now:
                        self._finish(entry)   # the slot frees again
                    else:
                        slots[i] = entry
            if not any(s is not None for s in slots):
                break
            if S + step >= self.S_max:
                # cache capacity exhausted: emit what we have
                for i in range(B):
                    if slots[i] is not None:
                        self._finish(slots[i])
                        slots[i] = None
                break
            # 3) one decode step for the whole batch
            logits, caches = lm.decode_step(
                self.params, caches,
                torch.from_numpy(cur_np).to(self.device), S + step,
                self.cfg)
            cur_np = self._argmax(logits)[:, None]
            step += 1
