"""Reads of the device by the host a call: msm_gpu's "host_syncs" counter
over the call's spans, averaged over the traced calls."""
from .. import spans


def read(summary):
    total = spans.counter_total(summary, "host_syncs")
    return None if total is None else total / len(summary.calls)
