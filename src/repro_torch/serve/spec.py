"""Draft proposers for self-speculative decoding on the paged loop (port
of ``repro.serve.spec``; framework-free, a copy of the reference's).

A drafter proposes up to ``k`` continuation tokens per live slot; one
batched verify forward (``lm.verify_step_paged``) scores all ``k + 1``
positions, and greedy acceptance keeps the longest draft prefix that
matches the model's own argmax chain plus one bonus token, so a verify
step yields 1 to ``k + 1`` tokens for one weight pass.

The drafters here are model-free (prompt lookup over n-grams): they match
the context's trailing n-gram against its earlier occurrences and
propose what followed.  Correctness never depends on the drafter: a bad
draft only costs the verify rows it wastes (their page writes go to the
scratch page or are overwritten before any mask exposes them), and the
accepted chain is the model's own greedy output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Drafter:
    """Protocol: propose up to ``k`` continuation tokens for a context.

    ``context`` is the slot's whole token history (prompt + generated,
    including the current not-yet-verified token); the result is a 1-D
    int array of length ``<= k`` (empty: nothing worth proposing; the
    loop runs a plain decode step when no slot drafts)."""

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: match the context's trailing n-gram
    against its earlier occurrences and propose the continuation.

    Tries n-gram sizes from ``max_n`` down to ``min_n``; the most recent
    earlier match wins.  Host-side numpy over a few hundred tokens per
    slot per step."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context)
        L = len(ctx)
        if k <= 0:
            return np.zeros(0, np.int32)
        for n in range(self.max_n, self.min_n - 1, -1):
            if L < n + 1:
                continue
            pat = ctx[L - n:]
            # windows[i] == ctx[i : i + n]; the latest match strictly
            # before the suffix itself
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.flatnonzero((windows[: L - n] == pat).all(axis=1))
            if hits.size:
                i = int(hits[-1])
                cont = ctx[i + n: i + n + k]
                if cont.size:
                    return cont.astype(np.int32)
        return np.zeros(0, np.int32)


DRAFTERS = {"ngram": NGramDrafter}


def make_drafter(spec: "str | Drafter | None") -> Optional[Drafter]:
    """Resolve ``cfg.serve_spec_drafter`` into a ``Drafter``: a registry
    name (``'ngram'``), ``'none'``/``None`` (no drafting), or a built
    ``Drafter`` instance (the hook a small-model drafter plugs into)."""
    if spec is None or spec == "none":
        return None
    if isinstance(spec, Drafter):
        return spec
    if isinstance(spec, str):
        try:
            return DRAFTERS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown drafter {spec!r}; known: {sorted(DRAFTERS)} "
                "(or pass a serve.spec.Drafter instance)") from None
    raise TypeError(f"drafter spec must be str/None/Drafter, got {spec!r}")
