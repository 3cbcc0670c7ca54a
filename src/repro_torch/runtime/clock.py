"""The runtime's clock (from ``repro.runtime.clock``).

Only the wall clock for now; the virtual clock and the simulator-fed cost
source come with the virtual-clock runtime (ROADMAP Queue 1, slice 6).
"""
from __future__ import annotations

import time


class WallClock:
    """Real time (the default): ``now()`` is ``time.perf_counter()``."""

    virtual = False

    def now(self) -> float:
        return time.perf_counter()
