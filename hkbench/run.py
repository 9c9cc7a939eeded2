"""Run one benchmark cell once and print its result line.

    python3 -m hkbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is found by name: its workload in
BENCHMARK.json names a configuration (hkbench/configs/<config>.json, whose
`driver` names hkbench/drivers/<driver>.py) and a traffic mix
(hkbench/traffic/<mix>.json); the end-to-end metrics are read by
hkbench/e2e/<metric>.py and the per-layer ones by hkbench/metrics/<metric>.py.

With --trace 0 the window is a closed loop of calls for --seconds seconds,
and the line carries the cell's end-to-end metrics. With --trace 1 the
window is the configuration's `trace_calls` calls under torch.profiler, and
the line carries the per-layer metrics, busy_s, window_s and a breakdown.
Either way the outputs of every call of the window are then held to the
plain reference, and the numbers compared are printed beside their limits,
last on standard error and last in the line. A run prints no result (and
exits non-zero) without as many CUDA devices as the cell asks for, or if a
module of JAX or of the JAX package was loaded.
"""
import time

T0 = time.time()  # set-up counts from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "hkbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "hekaton_tpu")


def load_cell(name: str) -> dict:
    """The workload `name` of BENCHMARK.json with its configuration, mix and
    metric entries."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)

    def mine(m):
        return name in m.get("workloads", [name])

    return {"cell": cell, "cfg": cfg, "mix_file": os.path.join(HERE, "traffic", cell["traffic"] + ".json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def forbidden_modules() -> list:
    """Loaded modules of JAX or of the JAX package, by whole top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def p95(values: list) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class Window:
    """What a window measured: the calls' outputs, their latencies (ms, on
    the device's clock where there is one) and its length."""

    def __init__(self):
        self.outputs, self.latencies_ms, self.seconds, self.items = [], [], 0.0, 0


def timed_window(cell, seconds: float) -> Window:
    import torch

    cuda = cell.device.type == "cuda"
    w, marks = Window(), []
    start = time.perf_counter()
    j = 0
    while time.perf_counter() - start < seconds:
        x = cell.inputs(j)
        cell.sync()
        if cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        out = cell.call(x)
        if cuda:
            e1.record()
        cell.sync()
        marks.append((e0, e1) if cuda else (time.perf_counter() - t0) * 1e3)
        w.outputs.append((j, out))
        j += 1
    w.seconds = time.perf_counter() - start
    w.items = cell.items * j
    w.latencies_ms = [m[0].elapsed_time(m[1]) if cuda else m for m in marks]
    return w


def traced_window(cell, calls: int):
    from . import trace

    w = Window()

    def run_call(j, record_function):
        x = cell.inputs(j)
        cell.sync()
        with record_function(trace.CALL):
            w.outputs.append((j, cell.call(x)))
            cell.sync()

    events = trace.profile_calls(run_call, calls)
    summary = trace.summarize(events, trace.port_kernel_names(os.path.join(ROOT, "hekaton_tpu_torch", "csrc")))
    w.items = cell.items * calls
    w.seconds = summary.window_s
    return w, summary


def _reader(kind: str, name: str):
    return importlib.import_module(f"hkbench.{kind}.{name}").read


def measure(spec: dict, seed: int, seconds: float, traced: bool, device: str = "cuda", entry=None) -> dict:
    """One run of the cell `spec` (load_cell) on `device`: set-up, window,
    check. Returns the result's parts; `entry` replaces the call under test
    (the control and the fault tests)."""
    import torch

    from . import traffic

    cfg = spec["cfg"]
    driver = importlib.import_module(f"hkbench.drivers.{cfg['driver']}")
    cell = driver.Cell(cfg, traffic.load(spec["mix_file"]), seed, device, entry=entry)
    cell.setup()
    setup_s = time.time() - T0
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    out = {"setup_s": setup_s, "metrics": {}}
    if traced:
        window, summary = traced_window(cell, int(cfg["trace_calls"]))
        for call, (j, _) in zip(summary.calls, window.outputs):
            call.least_s = cell.least_seconds(j)
        for m in spec["per_layer"]:
            value = _reader("metrics", m["name"])(summary)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        out["busy"] = (summary.busy_s, summary.window_s)
        out["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    else:
        window = timed_window(cell, seconds)
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = _reader("e2e", m["name"])(window)
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if cuda:
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(cell.device)
    out["window"] = window
    out["checks"], out["failed"] = cell.check(window.outputs)
    out["attempted"] = len(window.outputs)
    out["correct"] = all(value <= limit for _, value, limit in out["checks"])
    return out


def result_line(res: dict, card: str, chips: int, traced: bool) -> str:
    device = {"platform": "gpu", "kind": card, "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if traced:
        device["busy_s"], device["window_s"] = res["busy"]
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if traced:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in res["checks"]}
    return json.dumps(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    chips = int(spec["cell"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hkbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    res = measure(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"hkbench: modules of JAX or of the JAX package were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    w = res["window"]
    err = sys.stderr
    print(f"hkbench: {args.workload} seed {args.seed}: setup {res['setup_s']:.3f} s, "
          f"{res['attempted']} calls in {w.seconds:.3f} s", file=err)
    if w.latencies_ms:
        lat = sorted(w.latencies_ms)
        beyond = sum(1 for v in lat if v > p95(lat))
        print(f"hkbench: latency ms over {len(lat)} calls: min {lat[0]:.4f}, median {lat[len(lat) // 2]:.4f}, "
              f"p95 {p95(lat):.4f} ({beyond} beyond it), max {lat[-1]:.4f}", file=err)
    for name, value, limit in res["checks"]:
        print(f"check {name} {value} limit {limit} {'ok' if value <= limit else 'FAILED'}", file=err)
    print(result_line(res, torch.cuda.get_device_name(0), chips, bool(args.trace)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
