"""The nearest-rank 95th percentile of every call's latency in the window, in
ms, each read from a pair of CUDA events around the call (the device's clock);
the run prints the sample count and how many lie beyond it."""
from ..run import p95


def read(window):
    return p95(window.latencies_ms) if window.latencies_ms else None
