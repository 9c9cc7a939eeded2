"""The program's own records of the traced calls: the "msm" spans that
hekaton_tpu_torch/utils/timing.py keeps while a profiler collects.

The traced window is the run's only profiled region, the program records
only while a profiler collects, and no MSM runs between the window and the
readers: so the program holds exactly one top-level "msm" span a traced
call. A program without those records (an older tree, whose timing module
has no `records`) gives None, and so does any other count of "msm" spans,
which would pair spans with the wrong calls (a call that made two MSMs,
say).
"""
from __future__ import annotations


def msm_records(summary):
    """The traced calls' "msm" records, oldest first, or None."""
    n = len(summary.calls)
    if n == 0:
        return None
    try:
        from hekaton_tpu_torch.utils import timing
    except ImportError:
        return None
    records = getattr(timing, "records", None)
    if records is None:
        return None
    msm = [r for r in records() if r.name == "msm"]
    return msm if len(msm) == n else None


def stage_ms(summary, name: str):
    """Device ms of the stage span `name` a call, averaged over the traced
    calls, or None."""
    recs = msm_records(summary)
    if recs is None:
        return None
    ms = [c.device_ms for r in recs for c in r.children if c.name == name]
    if len(ms) != len(recs) or any(v is None for v in ms):
        return None
    return sum(ms) / len(ms)


def _tree_count(rec, name: str) -> int:
    return rec.counters.get(name, 0) + sum(_tree_count(c, name) for c in rec.children)


def counter_total(summary, name: str):
    """The counter `name` summed over each traced call's span tree, over all
    the traced calls (None without records)."""
    recs = msm_records(summary)
    if recs is None:
        return None
    return sum(_tree_count(r, name) for r in recs)
