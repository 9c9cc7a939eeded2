"""The control of a cell's check: the program run at a lower precision.

    python3 -m hkbench.control --workload <name> --seeds 11,12,13 --calls 20

For each seed, in one process: the cell's set-up, then `calls` calls of the
program as the window makes them and `calls` calls of the control, each
held to the reference by the cell's own check. The benchmark's runs never
run this.

The control is msm_gpu with its `nbits` cut to (W - 1) c - 1, W =
ceil(254 / c): the scalars lose the top window of bits, the precision one
window below the 254 bits the configuration states (a route that drops its
top window, or reads scalars narrower than r, is the step that would tempt
a later change). Its mismatch share must come out far above the program's.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time

from . import run, traffic


def control_entry(cell):
    from hekaton_tpu_torch.msm.pippenger import msm_gpu

    nbits = (math.ceil(254 / cell.c) - 1) * cell.c - 1
    return nbits, lambda ax, ay, sc: msm_gpu(ax, ay, sc, c=cell.c, L=cell.L, nbits=nbits)


def readings(spec: dict, seed: int, calls: int, device: str = "cuda") -> dict:
    cfg = spec["cfg"]
    driver = importlib.import_module(f"hkbench.drivers.{cfg['driver']}")
    cell = driver.Cell(cfg, traffic.load(spec["mix_file"]), seed, device)
    cell.setup()
    out = {"seed": seed}
    program = cell.entry
    nbits, control = control_entry(cell)
    for name, entry in (("program", program), ("control", control)):
        cell.entry = entry
        outputs = []
        for j in range(calls):
            outputs.append((j, cell.call(cell.inputs(j))))
            cell.sync()
        checks, _ = cell.check(outputs)
        out[name] = {k: v for k, v, _ in checks}
    out["control_nbits"] = nbits
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    spec = run.load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        rows.append(readings(spec, seed, args.calls))
        print(f"{args.workload} seed {seed}: program {rows[-1]['program']}, control {rows[-1]['control']} "
              f"(nbits {rows[-1]['control_nbits']}), {time.time() - t:.1f} s", flush=True)
    prog = [r["program"]["mismatch_pct"] for r in rows]
    ctrl = [r["control"]["mismatch_pct"] for r in rows]
    print(json.dumps({"workload": args.workload, "seeds": len(rows), "program_max_mismatch_pct": max(prog),
                      "control_min_mismatch_pct": min(ctrl)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
