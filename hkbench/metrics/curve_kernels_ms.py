"""Device time a call in the program's own kernels (a `__global__` of
hekaton_tpu_torch/csrc/*.cu), averaged over the traced calls."""


def read(summary):
    calls = summary.calls
    total = sum(c.port_us for c in calls)
    return total / len(calls) / 1e3 if total > 0 else None
