"""
Wall-clock accounting of the host-side stages (index builds, candidate
joins, exact overlap areas) that a device profiler cannot see.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class TimingRegistry:
    """Accumulates (count, total seconds) per named stage."""

    def __init__(self):
        self._records: Dict[str, list] = defaultdict(lambda: [0, 0.0])

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            record = self._records[name]
            record[0] += 1
            record[1] += time.perf_counter() - t0

    def summary(self) -> Dict[str, dict]:
        return {
            name: {"count": count, "total_s": total}
            for name, (count, total) in sorted(
                self._records.items(), key=lambda kv: -kv[1][1]
            )
        }

    def reset(self) -> None:
        self._records.clear()


#: Registry used by the instrumented host stages.
timings = TimingRegistry()
timed = timings.timed
