"""Phase timing with an end-of-run report.

Keeps the reference's "phase seconds table at the end of every run" UX
(display_stats, src/profiling.cpp:87-307) with host wall-clock phases
around the device stages; device-internal detail comes from
jax.profiler traces when requested.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import time

_TRACE = bool(os.environ.get("PROFILE_TRACE"))
_T0 = time.perf_counter()


class PhaseProfiler:
    def __init__(self):
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            dt = t1 - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if _TRACE:
                print(f"[trace {t0 - _T0:9.3f} +{dt:7.3f}] {name}",
                      file=sys.stderr)

    def report(self, file=None):
        if not self.totals:
            return
        file = file or sys.stderr
        total = sum(self.totals.values())
        print("\nRuntime profile (seconds):", file=file)
        width = max(len(k) for k in self.totals)
        for name, secs in sorted(self.totals.items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {name:<{width}}  {secs:9.3f}  "
                  f"({100.0 * secs / total:5.1f}%)  "
                  f"x{self.counts[name]}", file=file)
        print(f"  {'TOTAL':<{width}}  {total:9.3f}", file=file)


PROFILER = PhaseProfiler()
