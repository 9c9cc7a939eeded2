"""Device time a call: the union of the device intervals (kernels, copies,
fills) that start inside the call's range, averaged over the traced calls."""


def read(summary):
    calls = summary.calls
    total = sum(c.device_us for c in calls)
    return total / len(calls) / 1e3 if total > 0 else None
