"""torch.profiler's trace of a window, reduced to what the per-layer readers
read. Frozen with the benchmark.

`profile_calls` runs the window's calls under torch.profiler (CPU and CUDA
activities), each call inside a `record_function(CALL)` range that ends with
torch.cuda.synchronize(), after the call's inputs were made and synchronised
outside it. So every device operation that starts inside a call's range is
that call's. The Chrome trace is written to a temporary file (under
TMPDIR), read and deleted.

`summarize` gives, per call: the union of its device intervals (kernels,
copies and fills), its kernel launches, and the device time in the
program's own kernels (a `__global__` of hekaton_tpu_torch/csrc/*.cu, read
from the sources) and in all other operations (PyTorch's). Over the window,
from the first call's start to the last call's end: the busy time (the
union of every device interval in it), the device operations that took the
most time, and the longest idle gaps named by what the host was doing.
"""
from __future__ import annotations

import glob
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

CALL = "hkbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernel_names(csrc_dir: str) -> set:
    """The `__global__` function names of the program's CUDA sources."""
    names = set()
    for path in sorted(glob.glob(os.path.join(csrc_dir, "*.cu")) + glob.glob(os.path.join(csrc_dir, "*.cuh"))):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return names


def kernel_id(name: str) -> str:
    """A device operation's function name without its return type,
    namespace, template arguments and parameters ("void (anonymous
    namespace)::horner_kernel<1>(int const*, ...)" -> "horner_kernel")."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[len("void "):]
    cut = next((i for i, ch in enumerate(n) if ch in "<("), len(n))
    return n[:cut].split("::")[-1].strip() or name


def profile_calls(run_call, calls: int) -> list:
    """Run run_call(j) for j < calls under torch.profiler; returns the trace's
    complete events ("ph": "X")."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for j in range(calls):
            run_call(j, record_function)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals: list) -> float:
    return sum(e - s for s, e in intervals)


@dataclass
class CallStats:
    device_us: float  # union of the call's device intervals
    launches: int  # kernels
    port_us: float  # in the program's own kernels
    other_us: float  # in every other device operation
    least_s: float | None = None  # the least time of its work (work.py), set by the driver


@dataclass
class Summary:
    calls: list = field(default_factory=list)
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: list = field(default_factory=list)  # [[name, seconds]], most first
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds]], most first


def _innermost(host: list, points: list) -> list:
    """For each sorted point, the name of the shortest host event that
    contains it ("host, no op" where none does); host events properly
    nested, as on one thread."""
    host = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for m in points:
        while i < len(host) and host[i]["ts"] <= m:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= host[i]["ts"]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= m:
            stack.pop()
        out.append(stack[-1]["name"] if stack else "host, no op")
    return out


def summarize(events: list, port_names: set) -> Summary:
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == CALL)
    if not ranges:
        return Summary()
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    s = Summary()
    by_op = {}
    for lo, hi in ranges:
        mine = [e for e in dev if lo <= e["ts"] < hi]
        port = [e for e in mine if e["cat"] == "kernel" and kernel_id(e["name"]) in port_names]
        s.calls.append(CallStats(
            device_us=_length(_union([(e["ts"], e["ts"] + e["dur"]) for e in mine])),
            launches=sum(1 for e in mine if e["cat"] == "kernel"),
            port_us=sum(e["dur"] for e in port),
            other_us=sum(e["dur"] for e in mine) - sum(e["dur"] for e in port),
        ))
        for e in mine:
            key = kernel_id(e["name"])
            by_op[key] = by_op.get(key, 0.0) + e["dur"]
    w_lo, w_hi = ranges[0][0], ranges[-1][1]
    busy = _union([(max(e["ts"], w_lo), min(e["ts"] + e["dur"], w_hi)) for e in dev
                   if e["ts"] < w_hi and e["ts"] + e["dur"] > w_lo])
    s.window_s = (w_hi - w_lo) / 1e6
    s.busy_s = _length(busy) / 1e6
    s.device_ops = [[k, v / 1e6] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]]

    edges = [w_lo] + [x for iv in busy for x in iv] + [w_hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    tids = {e.get("tid") for e in events if e.get("cat") == "user_annotation" and e.get("name") == CALL}
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("tid") in tids]
    names = _innermost(host, [(a + b) / 2 for a, b in gaps])
    by_gap = {}
    for (a, b), name in zip(gaps, names):
        by_gap[name] = by_gap.get(name, 0.0) + (b - a)
    s.idle_gaps = [[k, v / 1e6] for k, v in sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]]
    return s
