"""Seeded fault injection for the paged serve loop (port of
``repro.serve.faults``).

``FaultPlan`` is pure data: one RNG seed, a firing probability per site
and a cap on each site's fires (so a faulted drain still ends: once the
budget is spent the loop runs fault-free).  ``FaultInjector`` is what the
loop threads through its sites; each ``fire(site)`` consumes the RNG
(``random.Random(plan.seed)``, as the reference) only for a site with a
nonzero rate still under its cap, so a plan and a workload replay the
same fault sequence in both packages.  Loops built without a plan hold
the inert ``NULL_FAULTS``.

Sites (``fire`` refuses no name, but ``FaultPlan`` refuses a rate for an
unknown one):

- ``alloc``: a page allocation in admission or on-demand growth behaves
  as if the pool were exhausted (the pool itself is untouched);
- ``swap_put``: ``SwapStore.put`` refuses the page as if the host budget
  were spent (the victim recomputes at resume);
- ``swap_corrupt``: one byte of a just-stored host page is flipped after
  its checksum was taken; the swap-in verify must catch it;
- ``admit_stall``: the admission head waits one round;
- ``cancel``: the loop cancels one in-flight request that the injector
  picks.

Host pages are nested dicts and lists of numpy arrays; ``tree_leaves``
lists their leaves in ``jax.tree.leaves`` order (dict keys sorted), which
is the order the page checksum and ``corrupt``'s draws follow.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict

import numpy as np

__all__ = ["SITES", "FaultPlan", "FaultInjector", "NULL_FAULTS",
           "make_injector", "tree_leaves", "tree_map"]

SITES = ("alloc", "swap_put", "swap_corrupt", "admit_stall", "cancel")


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples, in JAX's order: a
    dict's values by sorted key, a sequence's in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same positions of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule: ``rates`` maps a site to its firing
    probability per arming (absent = never); ``max_fires`` caps each
    site's fires (<= 0 = unlimited)."""

    seed: int = 0
    rates: Dict[str, float] = dataclasses.field(default_factory=dict)
    max_fires: int = 64

    def __post_init__(self):
        bad = set(self.rates) - set(SITES)
        if bad:
            raise ValueError(
                f"unknown fault site(s) {sorted(bad)}; known: {SITES}")
        for site, rate in self.rates.items():
            if not 0.0 <= float(rate) <= 1.0:
                raise ValueError(
                    f"fault rate for {site!r} must be in [0, 1], "
                    f"got {rate}")


class FaultInjector:
    """Live seeded injector: ``fire(site)`` rolls the plan's RNG and says
    whether the site faults this time."""

    enabled = True

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.armed: Dict[str, int] = {s: 0 for s in SITES}
        self.fired: Dict[str, int] = {s: 0 for s in SITES}

    def fire(self, site: str) -> bool:
        """One arming of ``site``; True: the caller must fault."""
        rate = self.plan.rates.get(site, 0.0)
        self.armed[site] += 1
        if rate <= 0.0:
            return False
        if self.plan.max_fires > 0 and \
                self.fired[site] >= self.plan.max_fires:
            return False
        if self.rng.random() < rate:
            self.fired[site] += 1
            return True
        return False

    def choice(self, seq):
        """Seeded pick (which request an injected cancel hits)."""
        return self.rng.choice(list(seq))

    def corrupt(self, data) -> None:
        """Flip one byte of one non-empty leaf of a host page in place
        (the torn write behind ``swap_corrupt``)."""
        leaves = [a for a in tree_leaves(data) if a.size]
        leaf = leaves[self.rng.randrange(len(leaves))]
        flat = leaf.reshape(-1).view(np.uint8)
        flat[self.rng.randrange(flat.size)] ^= 0xFF

    def stats(self) -> dict:
        return {
            "enabled": True,
            "seed": self.plan.seed,
            "max_fires": self.plan.max_fires,
            "rates": dict(self.plan.rates),
            "armed": dict(self.armed),
            "fired": dict(self.fired),
        }


class _NullFaultInjector:
    """Inert twin: every site check is a constant ``False``."""

    enabled = False

    def fire(self, site: str) -> bool:
        return False

    def stats(self) -> dict:
        return {"enabled": False}


NULL_FAULTS = _NullFaultInjector()


def make_injector(faults) -> object:
    """``None`` -> the shared inert twin, a ``FaultPlan`` -> a fresh
    injector; an injector passes through."""
    if faults is None:
        return NULL_FAULTS
    if isinstance(faults, FaultPlan):
        return FaultInjector(faults)
    return faults
