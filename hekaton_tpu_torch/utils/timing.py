"""Scoped timers with buffered per-rank logs.

Equivalent of the reference's two tracing layers (SURVEY.md §5): arkworks
start_timer!/end_timer! (enabled by the print-trace feature) and the buffered
start_timer_buf!/end_timer_buf! macros that accumulate per-rank lines printed
as one block at the end (mpi-snark/src/bin/node.rs:52-81,620). Enable with
HEKATON_PRINT_TRACE=1 or by passing a TimerBuf explicitly.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

_ENABLED = bool(os.environ.get("HEKATON_PRINT_TRACE"))


class TimerBuf:
    def __init__(self, rank: int = 0):
        self.rank = rank
        self.lines: list = []

    def add(self, label: str, secs: float):
        self.lines.append(f"{label}: {secs * 1000:.1f}ms")

    def flush(self) -> str:
        out = f"Rank {self.rank} log: " + "; ".join(self.lines)
        self.lines.clear()
        return out


@contextmanager
def timer(label: str, buf: TimerBuf | None = None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if buf is not None:
            buf.add(label, dt)
        elif _ENABLED:
            print(f"[timer] {label}: {dt * 1000:.1f}ms", flush=True)


@contextmanager
def print_timer(label: str):
    """timer() that prints when HEKATON_PRINT_TRACE is set (no buffer)."""
    with timer(label):
        yield
