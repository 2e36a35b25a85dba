"""Phase profiler + API trace (profile.h / RTC_TRACE analogs).

`ProfileTimer` records min/avg/max wall time per named phase
(common/sys/profile.h:24-110); `trace` is the per-API-call logging macro
(RTC_TRACE, rtcore.cpp) gated by an env var / flag instead of a compile
flag. This module covers the host-side phases (commit, build, pack);
the traversal kernel has its own `stats` counters.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

TRACE = bool(int(os.environ.get("EMBREE_TPU_TRACE", "0")))


class ProfileTimer:
    """Accumulates per-phase timings; print() mirrors the reference's
    verbose build-phase report."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self, name: str):
        s = self.samples.get(name, [])
        if not s:
            return None
        return {"min": min(s), "avg": sum(s) / len(s), "max": max(s),
                "count": len(s)}

    def print(self, prefix: str = "") -> None:
        for name in self.samples:
            st = self.stats(name)
            print(f"{prefix}{name}: avg {st['avg'] * 1e3:.2f} ms "
                  f"(min {st['min'] * 1e3:.2f}, max {st['max'] * 1e3:.2f}, "
                  f"n={st['count']})")


_global = ProfileTimer()


def profile_phase(name: str):
    return _global.phase(name)


def global_profiler() -> ProfileTimer:
    return _global


def trace(api: str, *args) -> None:
    """RTC_TRACE analog: per-API-call log line when EMBREE_TPU_TRACE=1."""
    if TRACE:
        print(f"[rtc-trace] {api}{args}")
