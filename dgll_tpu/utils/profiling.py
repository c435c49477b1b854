"""Profiling & phase timing.

Parity with the reference's observability (SURVEY.md §5): ``record_function`` scopes
('gpu-load'/'gpu-compute', 'cache-*') become named phase timers + ``jax.profiler``
trace annotations; COG's phase-timing CSV (``cog.py:108-253``) becomes
``PhaseTimer.to_csv``.
"""
from __future__ import annotations

import contextlib
import csv
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import jax


class PhaseTimer:
    """Accumulates wall-clock per named phase; nestable via context manager."""

    def __init__(self, sync: bool = False):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync  # block_until_ready barrier around device phases

    @contextlib.contextmanager
    def phase(self, name: str, result=None) -> Iterator[None]:
        with jax.profiler.TraceAnnotation(name):
            t0 = time.perf_counter()
            yield
            if self.sync and result is not None:
                jax.block_until_ready(result)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["phase", "total_s", "count", "mean_s"])
            for k in self.totals:
                w.writerow([k, self.totals[k], self.counts[k], self.mean(k)])

    def report(self) -> str:
        lines = ["phase                 total(s)   count   mean(ms)"]
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append(
                f"{k:<20} {self.totals[k]:9.3f} {self.counts[k]:7d} "
                f"{self.mean(k)*1e3:9.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """jax.profiler trace context (TensorBoard-compatible) — the JAX twin of the
    reference's ``torch.autograd.profiler.profile(use_cuda=True)`` wrapper."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
