"""The share of the plan's slab entries that hold a point with a nonzero
digit, in %: 100 x "nonzero_digits" / "slab_entries", both counted in
msm_gpu's "msm.plan" span, summed over the traced calls."""
from .. import spans


def read(summary):
    nonzero = spans.counter_total(summary, "nonzero_digits")
    slab = spans.counter_total(summary, "slab_entries")
    if nonzero is None or not slab:
        return None
    return 100.0 * nonzero / slab
