"""Device time a call of msm_gpu's "msm.horner" span (the device's clock
between CUDA events at the span's ends, idle gaps included), averaged over
the traced calls."""
from .. import spans


def read(summary):
    return spans.stage_ms(summary, "msm.horner")
