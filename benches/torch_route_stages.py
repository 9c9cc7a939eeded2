"""Where the time of msm_gpu's routes goes, on one CUDA card.

    python3 benches/torch_route_stages.py [--log2n 20] [--reps 3] [--curve bn254|bls12_381|g2]
        [--routes v9,(d),(e)] [--old build/old/<source>.cu ... [--old-root-width 1024]] [--fixed-base 18]

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

With --curve bls12_381 it times BLS12-381 G1 instead, on chip_smoke.py's
msm_bls set (4,096 distinct points tiled, scalars below BLS12-381's r), along
that curve's default route and, as chip_smoke.py runs them, BLS_ROUTES on the
first N_BLS_ROUTES points; their Horner is the generic one
(`_horner_generic`). The layouts are BN254's and not run.

With --curve g2 it times the BN254 G2 MSM on chip_smoke.py's msm_g2 set
(chip_smoke.g2_set: 4,096 distinct points k_j * G2 tiled, row 5 the
infinity sentinel; random scalars below r) along its one route (sort plan,
projective steps; the Horner is `_horner_generic`), and inside level 1 and
the Horner also the spans of `_mixed_step`'s `unpack_words` and of the three
G2 kernel wrappers, each summed over the call ("of which" columns after the
total, left out of "other"); on BN254 the same columns give the spans of
`unpack_words` and of the `pmadd_rcb` wrapper (route (c)'s steps). Then the G2 Horner of one call alone, from each
library (g2_horner_clocks): its host clock over its launches against its
kernels' device time a launch (torch.profiler), and the share of the host
span the device was busy.

--routes keeps the routes of those labels (comma-separated; "v9", "(a)"...
"(h)", "default", "pair", ...). With --old (csrc sources, for example an
older commit's curve.cu and curve_g2.cu, placed in the git-ignored build/;
each .cu beside the field.cuh it includes, see benches/torch_aff_ab.py)
it builds a second kernel library with those files in place of the csrc
files of their names (cuda_lib.build(swap=...)) and runs every kept route from both
libraries in the same round-robin, the old library's as a route of its own
("<label> [old]"). With --old-root-width N, tf.batch_inv runs a mont_mul
tree down to N lanes and inverts those (tf._batch_inv) while the old
library runs, so that an older field.cu runs at the root width it was
written for (1024 before the divstep inversion); this tree's batch_inv
inverts every lane.

With --fixed-base LOG2N (BN254 G1 only) it then times
TorchBackend.fixed_base of 2^LOG2N G1 scalars from this tree's library and
the old one in turns: the host clock of a warm call, and the device time of
the next one from torch.profiler's trace, madd_kernel's part of it.

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
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"
# spans inside the stages, by curve: G2's level 1 and Horner; BN254 route (c)'s steps
NESTED = {"g2": ("unpack_words", "pmadd_rcb_g2", "padd_rcb_g2", "pdbl_rcb_g2"), "bn254": ("unpack_words", "pmadd_rcb"),
          "bls12_381": ()}
STAGES = ("_plan_sorted_w", "_plan_sorted_t", "_plan_tpu", "interleave_slab_t", "_level1_pair", "l1_aff_halves_t",
          "_level1_mega", "_level1_rows", "_level1_tpu", "_collapse_columns", "_suffix_weighted", "horner_fold",
          "_horner_generic")


def g2_horner_clocks(cs, pip, cc, cuda_lib, ax, ay, sc, c, L, curve, old_lib, card) -> None:
    """The G2 Horner (`_horner_generic` on one lane) of one msm_gpu call,
    from each library in turns (this tree, old, old, this tree): its host
    clock (a synchronize before and after, best of 3) over its launches,
    against its kernels' device time a launch, from torch.profiler's trace
    of one more call (chip_smoke.kernel_device_times); and the share of the
    host span the device was busy, where the trace holds every launch."""
    horner, got = pip._horner_generic, {}

    def grab(*a):
        got["args"] = a
        return horner(*a)

    pip._horner_generic = grab
    pip.msm_gpu(ax, ay, sc, c=c, L=L, curve=curve)
    pip._horner_generic = horner
    kernels = ("pdbl_rcb_g2", "padd_rcb_g2")
    turns = [("this tree", cuda_lib.lib())]
    if old_lib is not None:
        turns = [turns[0], ("old", old_lib), ("old", old_lib), turns[0]]
    for label, lib in turns:
        with cuda_lib.using(lib):
            horner(*got["args"])
            host = []
            for _ in range(3):
                for k in kernels:
                    getattr(cc, k).launches = 0
                torch.cuda.synchronize()
                t = time.perf_counter()
                horner(*got["args"])
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t) * 1e3)
            launches = {f"{k}_kernel": getattr(cc, k).launches for k in kernels}
            dev = cs.kernel_device_times(lambda: horner(*got["args"]), launches)
        host_ms, n = min(host), sum(launches.values())
        parts = []
        for k, (count, us) in dev.items():
            parts.append(f"{k[:-len('_kernel')]} {launches[k]} x "
                         + (f"{us:.2f} us" if us is not None else f"not measured (the trace holds {count})"))
        complete = all(us is not None for _, us in dev.values())
        busy = sum(launches[k] * us for k, (_, us) in dev.items()) / 1e3 if complete else None
        print(f"[g2_horner] {label}: host {host_ms:.2f} ms (best of {len(host)}) for {n} launches, "
              f"{host_ms * 1e3 / max(n, 1):.1f} us a launch; device " + ", ".join(parts) + "; device busy "
              + (f"{busy:.3f} ms, {100 * busy / host_ms:.1f}% of the host span" if complete else "not measured")
              + f"; on {card}", flush=True)


def fixed_base_turns(cs, h, backend, cuda_lib, rs, log2n: int, old_lib, reps: int, card) -> None:
    """TorchBackend.fixed_base of 2^log2n G1 scalars (one base), warm, from
    each library in turns (this tree, old, old, this tree, ...; a first
    round warms up): its host clock (the call returns host points) and the
    device time of a second call (chip_smoke.device_busy: the kernels' time
    in torch.profiler's trace), madd_kernel's part of it; every library's
    points equal."""
    base = h.ch.pt_mul(h.ch.g1_gen(), int.from_bytes(rs.bytes(32), "little") % h.R)
    scalars = [int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(1 << log2n)]
    libs = {"this tree": cuda_lib.lib(), **({"old": old_lib} if old_lib is not None else {})}
    out = {label: [] for label in libs}
    want = None
    for rep in range(reps + 1):
        for label in list(libs) if rep % 2 else list(libs)[::-1]:
            with cuda_lib.using(libs[label]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = backend.fixed_base(base, scalars)
                wall = time.perf_counter() - t
                dev, parts = cs.device_busy(lambda: backend.fixed_base(base, scalars), ("madd_kernel",))
            want = got if want is None else want
            cs.require(got == want, f"fixed_base from the {label} library differs")
            if rep:
                out[label].append((wall, dev, parts["madd_kernel"]))
    for label, runs in out.items():
        print(f"[fixed_base] G1 {1 << log2n} scalars, {label}: warm host clock "
              + ", ".join(f"{w:.3f}" for w, _, _ in runs) + " s; device time "
              + ", ".join("not measured" if d is None else f"{d:.2f}" for _, d, _ in runs) + " ms, of which madd_kernel "
              + ", ".join(f"{m:.2f}" for _, _, m in runs) + f" ms (torch.profiler) on {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--curve", choices=("bn254", "bls12_381", "g2"), default="bn254")
    ap.add_argument("--routes", help="comma-separated labels of the routes to run (default: all)")
    ap.add_argument("--old", nargs="+", help="csrc sources to build a second library with, every route run from both")
    ap.add_argument("--old-root-width", type=int, help="batch_inv's tree root width while the old library runs")
    ap.add_argument("--fixed-base", type=int, metavar="LOG2N",
                    help="also time TorchBackend.fixed_base of 2^LOG2N G1 scalars from each library, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_route_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hekaton_tpu_torch import cuda_lib
    from hekaton_tpu_torch import host as h
    from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
    from hekaton_tpu_torch.curves import cuda_curve as cc
    from hekaton_tpu_torch.curves.torch_curve import G1, G2, g1_bls12_381
    from hekaton_tpu_torch.fields import cuda_field as cf
    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.msm import pippenger as pip

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    n = 1 << args.log2n
    rs = np.random.RandomState(cs.SEED)
    c, L = TorchBackend.msm_params(n)
    bls = args.curve == "bls12_381"
    if args.curve == "g2":
        curve = G2
        _, _, ax, ay = cs.g2_set(h, G2, rs, n)
        sc = pip.pack_scalars(cs.rand_scalars(rs, n, h.R), G2).to(DEVICE)
        routes = [("G2", L, {}, n)]
    elif bls:
        curve, P, R = g1_bls12_381(), h.bls.P, h.bls.R
        pts = [cs.bls_mul(h.bls.G1_GEN, int.from_bytes(rs.bytes(48), "little") % R, P)]
        step = cs.bls_mul(h.bls.G1_GEN, int.from_bytes(rs.bytes(48), "little") % R, P)
        while len(pts) < min(n, cs.N_BLS_DISTINCT):
            pts.append(cs.bls_add(pts[-1], step, P))
        ax, ay = (torch.from_numpy(a).to(DEVICE).repeat(n // len(pts), 1) for a in curve.pack_affine(pts))
        words = rs.randint(0, 2**63, size=(n, 5), dtype=np.int64)
        sc = pip.pack_scalars([sum(int(w) << (63 * i) for i, w in enumerate(r)) for r in words], curve).to(DEVICE)
        routes = [("default", L, {}, n)] + [(label, L, route, min(n, cs.N_BLS_ROUTES)) for label, route in cs.BLS_ROUTES]
    else:
        curve = G1
        k0, delta = (int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(2))
        ax, ay = (torch.from_numpy(a).to(DEVICE) for a in G1.pack_affine(cs.chain_points(n, k0, delta, h)))
        sc = torch.randint(0, 1 << 16, (n, 16), dtype=torch.int32, device=DEVICE)
        sc[:, 15] %= 0x3064
        routes = [("v9", L, {}, n)] + [(label, rl, route, n) for label, rl, route in cs.ROUTES]
    if args.routes:
        keep = args.routes.split(",")
        routes = [r for r in routes if r[0] in keep]
    libs = {}  # old-library route label -> its library
    this_batch_inv = old_batch_inv = tf.batch_inv
    if args.old_root_width:
        def old_batch_inv(spec, a):
            return tf._batch_inv(spec, a, cf.mont_mul, cf.fermat_inv, args.old_root_width)
    if args.old:
        old_lib = cuda_lib.load(cuda_lib.build(swap=args.old)[0])
        twins = []
        for label, *rest in routes:
            twins += [(f"{label} [old]", *rest), (label, *rest)]
            libs[f"{label} [old]"] = old_lib
        routes = twins
        how = f"a mont_mul tree down to {args.old_root_width} lanes" if args.old_root_width else "this tree's"
        print(f"[old] {' '.join(args.old)}: its routes run with batch_inv as {how}")

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
    nested = {}
    nested_names = NESTED[args.curve]
    if nested_names:
        for name in nested_names:
            mod = pip if name == "unpack_words" else cc
            nested[name] = (mod, getattr(mod, name))
            setattr(mod, name, timed(name, nested[name][1]))
            getattr(mod, name).launches = 0  # the wrappers count on the module-level name

    runs = {label: [] for label, *_ in routes}
    for rep in range(args.reps + 1):  # round-robin over the routes; rep 0 warms up
        # every other turn runs the routes in reverse, so that no route always follows the same one
        for label, rl, route, m in routes if rep % 2 else routes[::-1]:
            spans.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            tf.batch_inv = old_batch_inv if label in libs else this_batch_inv  # callers look it up on tf
            with warnings.catch_warnings(), cuda_lib.using(libs.get(label) or cuda_lib.lib()):
                warnings.simplefilter("ignore")  # route (f) warns that "pair" becomes "steps"
                pip.msm_gpu(ax[:m], ay[:m], sc[:m], c=c, L=rl, curve=curve, **route)
            tf.batch_inv = this_batch_inv
            end.record()
            torch.cuda.synchronize()
            if rep == 0:
                continue
            per = {}
            for name, s, e in spans:
                per[name] = per.get(name, 0.0) + s.elapsed_time(e)
            per["total"] = start.elapsed_time(end)
            per["other"] = per["total"] - sum(v for k, v in per.items() if k not in nested_names + ("total",))
            runs[label].append(per)
    for label, rl, route, m in routes:
        rows = runs[label]
        keys = [k for k in rows[0] if k not in nested_names + ("total", "other")] + ["other", "total"]
        keys += [k for k in nested_names if k in rows[0]]  # summed over the stages they run in
        med = {k: statistics.median(r.get(k, 0.0) for r in rows) for k in keys}
        accum, level1, plan = pip.resolve_route(curve, rl, **route)
        print(f"[stages] {label} accum={accum} level1={level1} plan={plan} {m} points, c={c}, L={rl}: "
              + ", ".join(f"{'of which ' if k in nested_names else ''}{k.strip('_')} {med[k]:.2f}" for k in keys)
              + f" ms (median of {args.reps}; totals "
              + ", ".join(f"{r['total']:.1f}" for r in rows) + f") on {card}")

    # the halves pairing and the mega kernel in both slab layouts, in turns
    for name, fn in plain.items():
        setattr(pip, name, fn)
    for name, (mod, fn) in nested.items():
        setattr(mod, name, fn)
    if args.curve == "g2":
        g2_horner_clocks(cs, pip, cc, cuda_lib, ax, ay, sc, c, L, curve, old_lib if args.old else None, card)
    if args.curve != "bn254":
        print(card)
        return 0
    if args.fixed_base:
        fixed_base_turns(cs, h, TorchBackend(DEVICE), cuda_lib, rs, args.fixed_base, old_lib if args.old else None,
                         args.reps, card)
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
