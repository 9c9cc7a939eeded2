"""Device time a call in operations that are not the program's own kernels
(PyTorch's sort, gather, scan, elementwise kernels, copies and fills),
averaged over the traced calls."""


def read(summary):
    calls = summary.calls
    if not calls or sum(c.device_us for c in calls) <= 0:
        return None
    return sum(c.other_us for c in calls) / len(calls) / 1e3
