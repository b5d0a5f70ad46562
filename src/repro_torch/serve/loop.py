"""The request record of the serve loops (port of
``repro.serve.loop.Request``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    output: Optional[np.ndarray] = None   # generated tokens; a cancelled
                                          # or expired request's partial
                                          # output (a prefix of the full)
    priority: Optional[int] = None        # admission priority (higher =
                                          # sooner; None = the config's)
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
