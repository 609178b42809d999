"""Wall-clock timing (utils.c:6-16 equivalent) and device-phase timers."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


def wall_clock_ns() -> int:
    """Nanosecond wall clock (reference: CLOCK_REALTIME, utils.c:6-16)."""
    return time.time_ns()


class PhaseTimers:
    """Named accumulating timers for codec phases (pack/encode/gather/...).

    Device work is asynchronous: a timed region must end in
    ``jax.block_until_ready`` (or a host readback such as ``np.asarray``)
    or it measures only the enqueue.  The chunked drivers' host-side
    readbacks of the liveness flag and the results provide this.
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        rows = [
            f"  {k:<12} {v:8.3f}s  {100.0 * v / total:5.1f}%"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "phase timings:\n" + "\n".join(rows)
