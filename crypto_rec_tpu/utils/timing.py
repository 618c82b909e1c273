"""Phase timing + throughput counters.

The reference writes per-phase wall-clock ms into the results file
(/root/reference/main.cpp:152,172-173).  We keep that and add queries/s —
the BASELINE.json headline counter — plus an optional jax.profiler trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, trace_dir: Optional[str] = None):
        ctx = (
            jax.profiler.trace(trace_dir)
            if trace_dir
            else contextlib.nullcontext()
        )
        start = time.perf_counter()
        with ctx:
            yield
        self.phases[name] = self.phases.get(name, 0.0) + (
            time.perf_counter() - start
        )

    def ms(self, name: str) -> int:
        return int(self.phases.get(name, 0.0) * 1000)

    def qps(self, name: str, n_queries: int) -> float:
        dt = self.phases.get(name, 0.0)
        return n_queries / dt if dt > 0 else float("inf")
