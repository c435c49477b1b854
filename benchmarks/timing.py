"""Steady-state step timing.

Build a K-step *dependent chain* (each step consumes the previous output), wait
for it with ``block_until_ready``, and fit the per-step slope from two chain
lengths: the slope drops the constant launch and synchronisation overhead.
"""
from __future__ import annotations

import time
from typing import Callable

import jax


def chain_time(step: Callable, x0, k_small: int = 5, k_large: int = 20,
               repeats: int = 2) -> float:
    """Per-step seconds of ``x = step(x)`` in steady state (slope fit).

    ``step`` must return something of the same structure as its input and contain a
    real data dependency on it.
    """
    def run(k: int) -> float:
        x = x0
        t0 = time.perf_counter()
        for _ in range(k):
            x = step(x)
        jax.block_until_ready(x)
        return time.perf_counter() - t0

    run(2)  # warm
    ts, tl = min(run(k_small) for _ in range(repeats)), min(
        run(k_large) for _ in range(repeats)
    )
    return max((tl - ts) / (k_large - k_small), 1e-9)
