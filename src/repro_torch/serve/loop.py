"""The request record of the serve loops (port of
``repro.serve.loop.Request``, serve-core fields and ``priority``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    output: Optional[np.ndarray] = None   # generated tokens once finished
    finish_reason: Optional[str] = None   # 'stop' (eos) | 'length'
    priority: Optional[int] = None        # admission priority (higher =
                                          # sooner; None = the config's)
