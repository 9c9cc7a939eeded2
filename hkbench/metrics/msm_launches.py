"""Kernel launches a call, counted in the trace, averaged over the traced
calls: what the host issues for the call's glue and kernels."""


def read(summary):
    calls = summary.calls
    total = sum(c.launches for c in calls)
    return total / len(calls) if total > 0 else None
