"""Wall-clock phase instrumentation.

Own copy of `armour_tpu/utils/timers.py`: the counterpart of the
reference's chrono timers around reachable-set generation and the NLP
(`armour_main.cu:89,224-230,292-316`) and the MATLAB
`P.info.planning_time` field (`simulator_armtd.m:179`).  Host wall time
only: a phase that launches device work must end in
``torch.cuda.synchronize()`` to time it; for device traces use
``torch.profiler`` around the same scopes.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:>28}: {tot:8.3f}s total, {tot / max(n, 1) * 1e3:8.2f}ms avg x{n}")
        return "\n".join(lines)
