"""Named-phase timer (reference: cobs/util/timer.{hpp,cpp}).

Accumulates wall time per named phase ("hashes", "io", "add rows",
"sort results") and prints the reference's `TIMER info=... name=secs ...`
text protocol.
"""

import sys
import time


class Timer:
    def __init__(self):
        self._order: list[str] = []
        self._durations: dict[str, float] = {}
        self._running: str | None = None
        self._start: float = 0.0
        self._total: float = 0.0

    def active(self, name: str) -> None:
        now = time.perf_counter()
        if self._running is not None:
            self._accumulate(self._running, now - self._start)
        self._running = name
        self._start = now

    def stop(self) -> None:
        now = time.perf_counter()
        if self._running is not None:
            self._accumulate(self._running, now - self._start)
        self._running = None

    def _accumulate(self, name: str, dt: float) -> None:
        if name not in self._durations:
            self._order.append(name)
            self._durations[name] = 0.0
        self._durations[name] += dt
        self._total += dt

    def get(self, name: str) -> float:
        return self._durations.get(name, 0.0)

    def merge(self, other: "Timer") -> "Timer":
        """Fold another (e.g. a worker thread's private) timer's phases
        into this one (reference: cobs/util/timer.cpp:67-75)."""
        for name in other._order:
            self._accumulate(name, other._durations[name])
        return self

    def reset(self) -> None:
        self._order.clear()
        self._durations.clear()
        self._total = 0.0
        self._running = None

    def print(self, info: str, file=None) -> None:
        file = file or sys.stderr
        parts = [f"TIMER info={info}"]
        for name in self._order:
            parts.append(f"{name}={self._durations[name]}")
        parts.append(f"total={self._total}")
        print(" ".join(parts), file=file)
