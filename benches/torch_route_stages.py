"""Where the time of msm_gpu's G1 routes goes, on one CUDA card.

    python3 benches/torch_route_stages.py [--log2n 20] [--reps 3]

Runs hekaton_tpu_torch's msm_gpu at 2^log2n points (chip_smoke.py's point
set, c and L as TorchBackend picks them) along the v9 route and the
routes of chip_smoke.py's ROUTES, and times each stage on the device clock:
a CUDA event is recorded before and after every call of the plan, the
interleave, the level 1, the collapse, the suffix scan and the Horner fold
(msm.pippenger's own functions, wrapped for the run), and a stage's time is
the sum of its calls' spans; "other" is the rest of the call (the bucket
readout, conversions). Each route runs once to warm up, then `reps` times,
the routes in turn, every other turn in reverse order; the table holds the
median. Then the halves pairing on the 2^log2n plan's slab in both layouts
(l1_aff_halves, l1_aff_halves_t) and the mega kernel in both, timed in
turns (rows, transposed, transposed, rows).

Prints one line per route and layout, the card's name and power limit,
and needs the card: it exits non-zero where torch.cuda.is_available() is
false.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"
STAGES = ("_plan_sorted_w", "_plan_sorted_t", "_plan_tpu", "interleave_slab_t", "_level1_pair", "l1_aff_halves_t",
          "_level1_mega", "_level1_rows", "_level1_tpu", "_collapse_columns", "_suffix_weighted", "horner_fold")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_route_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hekaton_tpu_torch import host as h
    from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
    from hekaton_tpu_torch.curves import cuda_curve as cc
    from hekaton_tpu_torch.curves.torch_curve import G1
    from hekaton_tpu_torch.msm import pippenger as pip

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    n = 1 << args.log2n
    rs = np.random.RandomState(cs.SEED)
    k0, delta = (int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(2))
    ax, ay = (torch.from_numpy(a).to(DEVICE) for a in G1.pack_affine(cs.chain_points(n, k0, delta, h)))
    sc = torch.randint(0, 1 << 16, (n, 16), dtype=torch.int32, device=DEVICE)
    sc[:, 15] %= 0x3064
    c, L = TorchBackend.msm_params(n)

    spans = []  # (stage, start event, end event) of the current call

    def timed(name, fn):
        def run(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            spans.append((name, start, end))
            return out
        return run

    plain = {name: getattr(pip, name) for name in STAGES}
    for name, fn in plain.items():
        setattr(pip, name, timed(name, fn))

    routes = [("v9", L, {})] + [(label, rl, route) for label, rl, route in cs.ROUTES]
    runs = {label: [] for label, _, _ in routes}
    for rep in range(args.reps + 1):  # round-robin over the routes; rep 0 warms up
        # every other turn runs the routes in reverse, so that no route always follows the same one
        for label, rl, route in routes if rep % 2 else routes[::-1]:
            spans.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # route (f) warns that "pair" becomes "steps"
                pip.msm_gpu(ax, ay, sc, c=c, L=rl, **route)
            end.record()
            torch.cuda.synchronize()
            if rep == 0:
                continue
            per = {}
            for name, s, e in spans:
                per[name] = per.get(name, 0.0) + s.elapsed_time(e)
            per["total"] = start.elapsed_time(end)
            per["other"] = per["total"] - sum(v for k, v in per.items() if k != "total")
            runs[label].append(per)
    for label, rl, route in routes:
        rows = runs[label]
        keys = [k for k in rows[0] if k not in ("total", "other")] + ["other", "total"]
        med = {k: statistics.median(r[k] for r in rows) for k in keys}
        accum, level1, plan = pip.resolve_route(False, rl, **route)
        print(f"[stages] {label} accum={accum} level1={level1} plan={plan} L={rl}: "
              + ", ".join(f"{k.strip('_')} {med[k]:.2f}" for k in keys) + f" ms (median of {args.reps}; totals "
              + ", ".join(f"{r['total']:.1f}" for r in rows) + f") on {card}")

    # the halves pairing and the mega kernel in both slab layouts, in turns
    for name, fn in plain.items():
        setattr(pip, name, fn)
    slab, _, meta = pip._plan_sorted_w(ax, ay, sc, c, L)
    slab_t = slab.t().contiguous()
    pairs = (("l1_aff_halves", lambda: cc.l1_aff_halves(slab, L), lambda: cc.l1_aff_halves_t(slab_t, L)),
             ("l1_rcb_mega", lambda: cc.l1_rcb_mega(slab, L), lambda: cc.l1_rcb_mega(slab_t, L, transposed=True)))
    for name, rows_fn, tr_fn in pairs:
        got = [cs.cuda_ms(fn, 5) for fn in (rows_fn, tr_fn, tr_fn, rows_fn)]
        print(f"[layouts] {name} on {meta[4]} columns x L={L}: rows {got[0]:.3f}, {got[3]:.3f} ms; transposed "
              f"{got[1]:.3f}, {got[2]:.3f} ms on {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
