"""The least time of the traced calls' work (hkbench/work.py, from their
scalars alone) over their device time (msm_device_ms), in %."""


def read(summary):
    calls = [c for c in summary.calls if c.least_s is not None]
    device_s = sum(c.device_us for c in calls) / 1e6
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(c.least_s for c in calls) / device_s
