"""The port's kernels against an older csrc, on one CUDA card: the A/B of
two kernel libraries.

    python3 benches/torch_aff_ab.py --old build/old [--kernels pairs,halves,others,inv,g2,k_add,compact]
        [--variant build/var/curve.cu ...] [--reps 10] [--k-add 2,4,8] [--only madd,padd_rcb]

--old is a directory holding an older commit's csrc sources, all of them
or some (a .cu includes the field.cuh of its own directory, so each .cu
there needs the header it was written against beside it), for example PR
8's (build/ is git-ignored):

    mkdir -p build/old && for f in field.cuh field.cu curve.cu curve_g2.cu; do
        git show 54aef4e:hekaton_tpu_torch/csrc/$f > build/old/$f; done

It builds one kernel library with the .cu files of --old swapped in
(cuda_lib.build(swap=...)) and this tree's, and prints ptxas's registers
and spills and the SASS instruction counts (cuobjdump -sass: in all, and in
the longest loop) of every kernel of both. The older library is opened
with its entry points declared here (open_old); where it has PR 8's
affine pair and halves (hk_halves_fin), the bench drives them with PR 8's
launch sequence (old_aff_add, old_halves: a root kernel, batch_inv of one
root a chain, a finish kernel, once a round for the halves), else through
this tree's wrappers.

Each --variant is a csrc source of this tree changed (a curve.cu with
other launch bounds, say): a library is built with it swapped in, and the
two affine pairs, the halves and the others rows of VARIANT_TIMED
(horner_fold, pmadd_rcb, l1_rcb_mega, madd, padd_rcb, dbl, add and the
chain kernels) are timed from it
too ("variant <i>", after "new" in the turns).

--kernels picks the sections, run in this order (all by default). Each
times its kernels from both libraries in turns (old, new, new, old;
chip_smoke.cuda_ms, the mean of --reps launches after a warm one):
- pairs: aff_add_fused and aff_add_mixed_packed at 2^18 lanes
  (chip_smoke.aff_edge_lanes: doubling, inverse and infinity lanes), where
  both libraries must equal the plain version bit for bit, and at N_WIDE
  lanes (random points of the 2^20-point set), where they must equal
  each other; this tree's also at each lanes-a-thread count of --k-add
  (cuda_curve.K_ADD, read at call time);
- halves: l1_aff_halves and l1_aff_halves_t on the level-1 slab of the
  2^20-point v9 plan (734,740 columns x 32) and of a 2^16-point
  one (chip_smoke's phase-2 slab), both layouts, equal across libraries,
  and at 2^16 equal to the plain version; one call is one level 1;
- others: every other kernel row of chip_smoke.py at its phase-2 shape
  (mont_mul at 2^20 lanes, 16 and 24 limbs; the point ops and the G2 trio
  at 2^18 lanes with chip_smoke's edge lanes; horner_fold at the (W, c)
  of the 2^20, 2^16, 2^15 and 2^12 MSMs and at W=20, c=0; l1_rcb_mega on the
  2^16 slab; aff_prep, aff_fin; madd also at chip_smoke.MADD_WIDE lanes, a
  fixed-base width without edges, and padd_rcb at chip_smoke.PADD_WIDTHS,
  the suffix scan's and the collapse's), both libraries equal to the plain
  version limb for limb; and pmadd_rcb and l1_rcb_mega at the widths the main paths
  launch them at (route (c)'s level-1 step, 734,740 lanes at 2^20 points
  (chip_smoke.g1_level1_inputs); the 2^20 v9 slab in both layouts; route
  (b)'s L=24 slab), the libraries equal to each other; the compact msm's
  chain kernels (jac_ladder, jac_sum, jac_horner) at CHAIN_SHAPES, the
  main paths' shapes, on chip_smoke.chain_inputs' edge inputs, equal to the
  plain version, where an older library that lacks them runs the loop of
  single ops they replace (torch_curve.CurveOps' ladder, sum_in_order and
  horner on its dbl, madd and add: chain_loop), as this tree's library
  does too ("loop (new)"); an older library's chain kernels (one thread a
  lane on the Jacobian formulas: jac_ladder as at d01b559, jac_sum and
  jac_horner as at 3ba6b39) and the loops of single ops are held to the
  plain version as affine points (this tree's chains run the RCB
  formulas), and each library's chain kernel is timed on the device clock
  too (chip_smoke.graph_ms: a short launch is issued slower than it runs);
  --only keeps the
  rows of the kernels it names (and builds no other row's inputs); then the Horner chain's latency a point op, from the c=13
  and c=0 times, and one product's latency in the old one-thread body
  (from its products and additions a double and an add), times the new
  chain's dependent product levels: a diagnostic, not a bound;
- inv: fermat_inv at the widths the main paths invert at (BN254 Fq at 1024
  lanes, 2^18 and N_WIDE, Fr at 1024, BLS12-381 Fq at 1024 and N_WIDE) on
  chip_smoke.inv_lanes, every library equal to mont_inv; beside this
  tree's time, the time its divstep SASS takes at an SM's instruction rate
  (INSTR_PER_SM_CLOCK), a diagnostic of the algorithm, not a bound of the
  function, and the length of its dependent chain (chip_smoke.inv_chain);
- g2: pmadd_rcb_g2, padd_rcb_g2 and pdbl_rcb_g2 at the G2 MSM's own
  level-1 width (chip_smoke.g2_level1_inputs on the 2^20-point msm_g2 set),
  and pdbl_rcb_g2 at one lane (the width of the one-lane Horner launches,
  also against the plain version), the libraries equal; then the G2 window
  Horner at G2_HORNER_SHAPES and at W=20, c=0: horner_fold_g2 (one launch)
  against, in a library without it, the loop of one-lane pdbl_rcb_g2 /
  padd_rcb_g2 launches it replaced (cuda_curve.fold_windows on PROJ_G2), both
  equal to horner_fold_g2_plain, and the time of a point op from the c=13
  and c=0 times;
- k_add: the widths of every affine-pair launch of one 2^20-point v9
  msm_gpu and one route (h) (steps, affine) are recorded, and each
  lanes-a-thread count of --k-add is timed at each width, the counts in
  turns (forward, then backward; the lesser of the two); the sum over the
  launches is printed per count and per kernel;
- compact: msm/pippenger.py::msm on BN254 G1 at COMPACT_POINTS (the
  ladder, c=3, c=8; chip_smoke's msm_compact inputs), each against
  msm_host, on the host clock (torch.cuda.synchronize around each call),
  the median of --reps calls, in turns: "old" is the older library with
  its own chain kernels, or where it has none G1's chains run as CurveOps'
  loops of single ops (SingleOpG1: the launch sequence before the chain
  kernels), "new" this tree, and the device time of two calls of each
  (chip_smoke.device_busy: the kernels' time in a torch.profiler trace);
  then the
  Horner combine at CHAIN_SHAPES' (W, c) two ways, in turns on this tree:
  jac_horner, and msm_gpu's route (curves/proj.py from_jacobian,
  horner_fold, to_jacobian), the same point.
The point sets are chip_smoke.py's, of N_MSM = 2^20 points (its 2^18-lane
shapes take distinct points for P and Q). Each line carries the bound
(chip_smoke.Bound on the work chip_smoke.py counts for the row) and the
card's name and power limit. Exits non-zero
where torch.cuda.is_available() is false.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"
N_WIDE = 734_740  # the widest affine add and inversion of the 2^20 G1 MSM (over every level-1 column)
SECTIONS = ("pairs", "halves", "others", "inv", "g2", "k_add", "compact")
# the chain kernels' shapes on the main paths (chip_smoke.py's [coverage]): the ladder at (lanes, nbits),
# the chunk sum at (K, lanes), the Horner at (W, c)
CHAIN_SHAPES = {"jac_ladder": ((32, 254), (28, 254)), "jac_sum": ((64, 128), (7, 85), (32, 1), (28, 1), (4, 32)),
                "jac_horner": ((85, 3), (32, 8))}
G2_HORNER_SHAPES = ((20, 13),)  # (W, c) of the G2 window Horner of the 2^20 G2 MSM
COMPACT_POINTS = (32, 33, 2048)
VARIANT_TIMED = ("horner_fold", "pmadd_rcb", "l1_rcb_mega", "madd", "padd_rcb", "dbl", "add", "jac_ladder", "jac_sum",
                 "jac_horner")  # the others rows --variant times
INSTR_PER_SM_CLOCK = 128  # thread instructions an SM starts a clock: 4 schedulers, one 32-lane warp each


def open_old(cuda_lib, path: str) -> ctypes.CDLL:
    """Open an older kernel library: this tree's entry points as it has
    them, PR 8's affine pair and halves (the pair without the fold's
    scratch, the halves as one root and one finish kernel a round) where it
    has hk_halves_fin."""
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    handle = ctypes.CDLL(path)
    sigs = dict(cuda_lib.SIGNATURES)
    if hasattr(handle, "hk_halves_fin"):
        sigs.update({
            "hk_aff_root": [vp] * 6 + [ll, ll, i32, vp],
            "hk_aff_fin": [vp] * 8 + [ll, ll, i32, vp],
            "hk_aff_root_packed": [vp] * 5 + [ll, ll, i32, vp],
            "hk_aff_fin_packed": [vp] * 7 + [ll, ll, i32, vp],
            "hk_halves_root": [vp] * 3 + [ll, i32, i32, vp],
            "hk_halves_fin": [vp] * 4 + [ll, i32, i32, vp],
        })
    for name, argtypes in sigs.items():
        if hasattr(handle, name):
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return handle


def old_aff_add(cuda_lib, tf, lib, entries, x1, y1, q_args, k=8):
    """PR 8's wrapper: k lanes a thread, every thread's chain end inverted."""
    n = x1.numel() // 16
    ox, oy = torch.empty_like(x1), torch.empty_like(y1)
    nthreads = (n + k - 1) // k
    pre = torch.empty((k * nthreads, 8), dtype=torch.int32, device=x1.device)
    roots = torch.empty((nthreads, 16), dtype=torch.int32, device=x1.device)
    ins = (x1.data_ptr(), y1.data_ptr(), *(t.data_ptr() for t in q_args))
    stream = cuda_lib.stream_ptr(x1.device)
    cuda_lib.check(entries[0], getattr(lib, entries[0])(*ins, pre.data_ptr(), roots.data_ptr(), n, nthreads, k,
                                                         stream))
    rinv = tf.batch_inv(tf.FQ, roots)
    cuda_lib.check(entries[1], getattr(lib, entries[1])(*ins, pre.data_ptr(), rinv.data_ptr(), ox.data_ptr(),
                                                         oy.data_ptr(), n, nthreads, k, stream))
    return ox, oy


def old_halves(cuda_lib, tf, lib, v, L: int, ncols: int, transposed: bool):
    """PR 8's wrapper: a root kernel, batch_inv of every column's root and a
    finish kernel, for each of the log2(L) rounds."""
    stream = cuda_lib.stream_ptr(v.device)
    l = L
    while l > 1 and ncols:
        k = l // 2
        pre = torch.empty((k * ncols, 8), dtype=torch.int32, device=v.device)
        roots = torch.empty((ncols, 16), dtype=torch.int32, device=v.device)
        cuda_lib.check("hk_halves_root", lib.hk_halves_root(v.data_ptr(), pre.data_ptr(), roots.data_ptr(), ncols,
                                                            k, int(transposed), stream))
        rinv = tf.batch_inv(tf.FQ, roots)
        out = torch.empty((k * 16, ncols) if transposed else (ncols, k * 16), dtype=torch.int32, device=v.device)
        cuda_lib.check("hk_halves_fin", lib.hk_halves_fin(v.data_ptr(), pre.data_ptr(), rinv.data_ptr(),
                                                          out.data_ptr(), ncols, k, int(transposed), stream))
        v, l = out, k
    return v


def sass_counts(cs, so: str) -> dict:
    """{kernel instance: (SASS instructions, instructions of its longest
    loop)} of every kernel of the library `so`, from `cuobjdump -sass`; a
    loop is a branch back to a lower address."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.Popen([tool, "-sass", so], stdout=subprocess.PIPE, text=True)
    out, name, ins = {}, None, []

    def close():
        if name:
            loops = [(a - int(t, 16)) // 16 + 1 for a, t in ins if t and int(t, 16) < a]
            out[name] = (len(ins), max(loops, default=0))

    for line in proc.stdout:
        if "Function : " in line:
            close()
            mangled = line.split()[-1]
            name, ins = (cs.kernel_name(mangled) if "_kernel" in mangled else None), []
        elif name:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                branch = re.search(r"\bBRA (0x[0-9a-f]+)", m.group(2))
                ins.append((int(m.group(1), 16), branch.group(1) if branch else None))
    close()
    cs.require(proc.wait() == 0, f"cuobjdump -sass {so} failed")
    return out


def mega_rows(cs, cc, pip, ax, ay, gen, c: int, L: int, n_pts: int) -> list:
    """The others section's l1_rcb_mega rows and pmadd_rcb at route (c)'s
    width: the mega kernel on chip_smoke's 2^16-point slab (against the plain
    version), then at the widths the main paths launch them at, route (c)'s
    level-1 step (the 2^20 v9 slab's columns after 3 steps), that slab in
    both layouts and route (b)'s L=24 slab, with no plain version
    (chip_smoke.py holds them to it): the libraries equal each other."""
    slab, _, meta = pip._plan_sorted_w(ax[:cs.N_PLAN].contiguous(), ay[:cs.N_PLAN].contiguous(),
                                       cs.rand_limbs(cs.N_PLAN, gen), 11, 32)
    ncols = meta[4]
    rows = [("l1_rcb_mega", f"{ncols} columns x L=32", lambda: tuple(cc.l1_rcb_mega(slab, 32)),
             lambda: tuple(cc.l1_rcb_mega_plain(slab, 32)), cs.mega_work(slab, 32))]
    sc20 = torch.randint(0, 1 << 16, (n_pts, 16), generator=gen, device=DEVICE, dtype=torch.int32)
    sc20[:, 15] %= 0x3064
    slab20 = pip._plan_sorted_w(ax, ay, sc20, c, L)[0]
    slab20_t = slab20.t().contiguous()
    slab24 = pip._plan_sorted_w(ax, ay, sc20, c, 24)[0]
    pargs = cs.g1_level1_inputs(pip, slab20, L)
    m = pargs[0].shape[0]
    sentinels = int((pargs[4] == 0).all(-1).sum())
    rows.append(("pmadd_rcb", f"{m} lanes (route (c)'s step)", lambda: tuple(cc.pmadd_rcb(*pargs)), None,
                 (8 * 64 * m, cs.g1_work("pmadd_rcb", m - sentinels))))
    for label, v, lL, tr, wslab in (("rows", slab20, L, False, slab20), ("transposed", slab20_t, L, True, slab20),
                                    ("rows", slab24, 24, False, slab24)):
        rows.append(("l1_rcb_mega", f"{wslab.shape[0]} columns x L={lL} ({label}, 2^{n_pts.bit_length() - 1} "
                                    f"points)", lambda v=v, lL=lL, tr=tr: tuple(cc.l1_rcb_mega(v, lL, tr)),
                     None, cs.mega_work(wslab, lL)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, help="a directory with an older commit's csrc sources")
    ap.add_argument("--kernels", default=",".join(SECTIONS), help="the sections to run: " + ",".join(SECTIONS))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variant", nargs="*", default=[], help="changed csrc sources of this tree to time too")
    ap.add_argument("--k-add", default="2,4,8", help="lanes a thread of this tree's affine pair to time")
    ap.add_argument("--only", help="comma-separated kernel names: the rows of the others section to run")
    args = ap.parse_args()
    sections = args.kernels.split(",")
    if not set(sections) <= set(SECTIONS):
        ap.error(f"--kernels: unknown sections {set(sections) - set(SECTIONS)}")
    if not torch.cuda.is_available():
        print("torch_aff_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    from hekaton_tpu_torch import cuda_lib
    from hekaton_tpu_torch import host as h
    from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
    from hekaton_tpu_torch.curves import cuda_curve as cc
    from hekaton_tpu_torch.curves import proj
    from hekaton_tpu_torch.curves.torch_curve import G1, G2, CurveOps, G1Ops, Jac

    class SingleOpG1(G1Ops):
        """BN254 G1 with its chains as CurveOps' loops of single-op launches
        (the compact msm's launch sequence before the chain kernels)."""

        ladder, sum_in_order, horner = CurveOps.ladder, CurveOps.sum_in_order, CurveOps.horner

    g1_loops = SingleOpG1(G1.f, G1.name, G1.scalar)

    def chain_loop(name: str, cargs: tuple) -> tuple:
        """The chain kernel `name` on its wrapper's arguments as g1_loops'
        loop of single ops."""
        if name == "jac_ladder":
            return tuple(g1_loops.ladder(*cargs))
        if name == "jac_sum":
            return tuple(g1_loops.sum_in_order(Jac(*cargs)))
        return tuple(g1_loops.horner(Jac(*cargs[:3]), cargs[3]))
    from hekaton_tpu_torch.fields import cuda_field as cf
    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.msm import pippenger as pip

    card = cs.smi("name,power.limit")
    swap = [os.path.join(args.old, f) for f in ("field.cu", "curve.cu", "curve_g2.cu")
            if os.path.exists(os.path.join(args.old, f))]
    cs.require(bool(swap), f"--old {args.old}: no csrc source there")
    old_path, old_report = cuda_lib.build(swap=swap)
    new_path, new_report = cuda_lib.build()
    old, new = open_old(cuda_lib, old_path), cuda_lib.lib()
    pr8_pairs = hasattr(old, "hk_halves_fin")
    builds = [("old", old_path, old_report), ("this tree", new_path, new_report)]
    variants = {}
    for i, path in enumerate(args.variant):
        v_path, v_report = cuda_lib.build(swap=[path])
        variants[f"variant {i}"] = cuda_lib.load(v_path)
        builds.append((f"variant {i} ({path})", v_path, v_report))
    new_sass = {}
    for label, path, report in builds:
        sass = sass_counts(cs, path)
        if label == "this tree":
            new_sass = sass
        resident = cuda_lib.occupancy(ctypes.CDLL(path))
        for name, regs, spill in cs.ptxas_summary(report):
            total, loop = sass.get(name, (0, 0))
            print(f"[ptxas] {label} {name}: {regs} registers, {spill} bytes spilled, "
                  f"{resident.get(name, 'not queried')} blocks an SM, SASS {total} instructions, "
                  f"{loop} in its longest loop")

    bound = cs.Bound()
    gen = torch.Generator(device=DEVICE).manual_seed(cs.SEED)
    rs = np.random.RandomState(cs.SEED)
    n_pts = cs.N_MSM
    k0, delta = (int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(2))
    host_pts = cs.chain_points(n_pts, k0, delta, h)
    host_pts[5], host_pts[7] = None, host_pts[6]  # chip_smoke's msm_g1 set: an infinity row, a repeated point
    ax, ay = (torch.from_numpy(a).to(DEVICE) for a in G1.pack_affine(host_pts))
    scalars = cs.rand_scalars(rs, 4096, h.R)
    scalars[0], scalars[1], scalars[2], scalars[7] = 0, 1, h.R - 1, scalars[6]
    c, L = TorchBackend.msm_params(n_pts)
    k_adds = [int(k) for k in args.k_add.split(",")]
    k_default = cc.K_ADD

    def in_turns(label, shape, fns: dict, work, extra=""):
        """Time fns ({library: fn}) old, new, new, old; print one line."""
        ms = {k: [] for k in fns}
        for lib_label in list(fns) + list(fns)[::-1]:
            ms[lib_label].append(cs.cuda_ms(fns[lib_label], args.reps))
        b_ms, b_by = bound(*work)
        ratio = min(ms["old"]) / min(ms["new"]) if "old" in ms else 1.0
        print(f"[ab] {label} {shape}: " + "; ".join(f"{k} {v[0]:.4f}, {v[1]:.4f} ms" for k, v in ms.items())
              + f"; old / new {ratio:.2f}; bound {b_ms:.4f} ms ({b_by}){extra}; bit-identical; on {card}",
              flush=True)
        return ms

    def using(lib, fn):
        def run():
            with cuda_lib.using(lib):
                return fn()
        return run

    if "pairs" in sections:
        edge = cs.aff_edge_lanes(tf, ax, ay)
        n_wide = min(N_WIDE, n_pts - 1)  # lane i adds points i and i + n_pts - n_wide
        wide = (ax[:n_wide], ay[:n_wide], ax[n_pts - n_wide:], ay[n_pts - n_wide:])
        for name, entries in (("aff_add_fused", ("hk_aff_root", "hk_aff_fin")),
                              ("aff_add_mixed_packed", ("hk_aff_root_packed", "hk_aff_fin_packed"))):
            packed = name == "aff_add_mixed_packed"
            fn = getattr(cc, name)
            for shape, lanes in ((f"{cs.N_LANES} lanes", edge), (f"{n_wide} lanes", wide)):
                x1, y1, x2, y2 = (t.contiguous() for t in lanes)
                q = (cc.AffineOps.pack_rows(cc.Aff(x2, y2)).contiguous(),) if packed else (x2, y2)
                got = fn(x1, y1, *q)
                ref = getattr(cc, name + "_plain")(x1, y1, *q) if lanes is edge else got
                run_old = (lambda: old_aff_add(cuda_lib, tf, old, entries, x1, y1, q)) if pr8_pairs \
                    else using(old, lambda: fn(x1, y1, *q))
                cs.require(cs.max_abs_err(got, ref) == 0 and cs.max_abs_err(run_old(), ref) == 0,
                           f"{name} {shape}: a library differs")
                for label, lib in variants.items():
                    with cuda_lib.using(lib):
                        cs.require(cs.max_abs_err(fn(x1, y1, *q), ref) == 0, f"{name} {shape}: {label} differs")
                in_turns(name, shape, {"old": run_old, "new": lambda: fn(x1, y1, *q),
                                       **{k: using(lib, lambda: fn(x1, y1, *q)) for k, lib in variants.items()}},
                         cs.aff_work(x1, y1, x2, y2, (6 - packed) * 64 * x1.shape[0]))
                for k in k_adds:
                    cc.K_ADD = k
                    cs.require(cs.max_abs_err(fn(x1, y1, *q), ref) == 0, f"{name} K_ADD={k} differs")
                    print(f"[k_add] {name} {shape} K_ADD={k}: {cs.cuda_ms(lambda: fn(x1, y1, *q), args.reps):.4f} "
                          f"ms on {card}", flush=True)
                cc.K_ADD = k_default
        del wide, edge

    if "halves" in sections:  # the 2^20 v9 slab and the 2^16 one
        sc = torch.randint(0, 1 << 16, (n_pts, 16), generator=gen, device=DEVICE, dtype=torch.int32)
        sc[:, 15] %= 0x3064
        for m, (mc, mL) in ((n_pts, (c, L)), (cs.N_PLAN, (11, 32))):
            slab, _, meta = pip._plan_sorted_w(ax[:m].contiguous(), ay[:m].contiguous(), sc[:m].contiguous(), mc, mL)
            ncols = meta[4]
            slab_t = slab.t().contiguous()
            work = cs.halves_work(slab, mL)
            for name, v, tr in (("l1_aff_halves", slab, False), ("l1_aff_halves_t", slab_t, True)):
                fn = getattr(cc, name)
                got = fn(v, mL)
                run_old = (lambda: old_halves(cuda_lib, tf, old, v, mL, ncols, tr)) if pr8_pairs \
                    else using(old, lambda: fn(v, mL))
                cs.require(cs.max_abs_err(got, run_old()) == 0, f"{name} {ncols} columns: the libraries differ")
                if m == cs.N_PLAN:
                    cs.require(cs.max_abs_err(got, getattr(cc, name + "_plain")(v, mL)) == 0,
                               f"{name} {ncols} columns: differs from the plain version")
                for label, lib in variants.items():
                    with cuda_lib.using(lib):
                        cs.require(cs.max_abs_err(fn(v, mL), got) == 0, f"{name} {ncols} columns: {label} differs")
                in_turns(name, f"{ncols} columns x L={mL}", {
                    "old": run_old, "new": lambda: fn(v, mL),
                    **{k: using(lib, lambda: fn(v, mL)) for k, lib in variants.items()}}, work)
            del slab, slab_t
        del sc

    only = set(args.only.split(",")) if args.only else None

    def want(name):  # a row of the others section that --only keeps
        return only is None or name in only

    g2x = g2y = None
    if ("others" in sections and any(want(op + "_g2") for op in ("pmadd_rcb", "padd_rcb", "pdbl_rcb"))
            or "g2" in sections):
        _, _, g2x, g2y = cs.g2_set(h, G2, rs, n_pts)

    if "others" in sections:  # before and after the field product
        n = cs.N_LANES
        others = []
        for spec, nl in ((tf.FQ, 16), (tf.FQ_BLS, 24)):
            if not want(f"mont_mul {spec.name}"):
                continue
            a, b = cs.rand_limbs(cs.N_MUL, gen, spec), cs.rand_limbs(cs.N_MUL, gen, spec)
            others.append((f"mont_mul {spec.name}", f"{cs.N_MUL} lanes",
                           lambda spec=spec, a=a, b=b: cf.mont_mul(spec, a, b),
                           lambda spec=spec, a=a, b=b: cf.mont_mul_plain(spec, a, b),
                           (3 * 4 * nl * cs.N_MUL, cs.N_MUL, nl // 2)))
        if want("aff_prep") or want("aff_fin"):
            args_aff = cs.aff_edge_lanes(tf, ax, ay)
            den, num = cc.aff_prep(*args_aff)
            fin_args = (*args_aff, tf.batch_inv(tf.FQ, den), num)
            adds, dbls = cs.aff_lanes(*args_aff)
            others += [("aff_prep", f"{n} lanes", lambda: cc.aff_prep(*args_aff),
                        lambda: cc.aff_prep_plain(*args_aff), (6 * 64 * n, cs.g1_products(0, dbls))),
                       ("aff_fin", f"{n} lanes", lambda: cc.aff_fin(*fin_args), lambda: cc.aff_fin_plain(*fin_args),
                        (8 * 64 * n, cs.g1_work("aff_sum", adds)))]
        if want("madd"):  # chip_smoke's edge lanes, and a fixed-base width without edges
            for m, edges in ((n, True), (cs.MADD_WIDE, False)):
                jp, (qx, qy) = cs.g1_edge_lanes(tf, ax, ay, gen, m, edges)
                margs = (*jp, qx, qy)
                others.append(("madd", f"{m} lanes" + ("" if edges else " (no edges)"),
                               lambda margs=margs: cc.madd(*margs), lambda margs=margs: cc.madd_plain(*margs),
                               cs.madd_work(tf, *margs)))
        if want("dbl") or want("add"):
            jp2, jq2 = cs.g1_jacobian_pairs(tf, ax, ay, gen)
            others += [("dbl", f"{n} lanes", lambda: cc.dbl(*jp2), lambda: cc.dbl_plain(*jp2),
                        cs.dbl_work(*jp2)),
                       ("add", f"{n} lanes", lambda: cc.add(*jp2, *jq2), lambda: cc.add_plain(*jp2, *jq2),
                        cs.add_work(tf, *jp2, *jq2))]
        for name, shapes in CHAIN_SHAPES.items():  # the loop of single ops they replace, from either library
            for shape in (shapes if want(name) else ()):
                cargs, work, label, _ = cs.chain_inputs(h, tf, cc, G1, name, shape, host_pts, scalars, gen)
                others.append((name, label, lambda name=name, cargs=cargs: tuple(getattr(cc, name)(*cargs)),
                               lambda name=name, cargs=cargs: tuple(getattr(cc, name + "_plain")(*cargs)), work,
                               lambda name=name, cargs=cargs: chain_loop(name, cargs)))
        g1_rcb = tuple(cs.g1_work(op, 1) for op in ("pmadd_rcb", "padd_rcb", "pdbl_rcb"))
        for sfx, pts, coord_bytes, products in (("", (ax, ay), 64, g1_rcb),
                                                ("_g2", (g2x, g2y), 128, tuple(cs.RCB_G2_PRODUCTS.values()))):
            if not any(want(op + sfx) for op in ("pmadd_rcb", "padd_rcb", "pdbl_rcb")):
                continue
            gp, gq, (bx, by) = cs.proj_edge_lanes(tf, proj, *pts, gen)
            for op, kargs, nio, prods in zip(("pmadd_rcb", "padd_rcb", "pdbl_rcb"),
                                             ((*gp, bx, by), (*gp, *gq), tuple(gp)), (8, 9, 6), products):
                kargs = tuple(t.contiguous() for t in kargs)
                fn, plain = getattr(cc, op + sfx), getattr(cc, op + sfx + "_plain")
                others.append((op + sfx, f"{n} lanes", lambda fn=fn, kargs=kargs: fn(*kargs),
                               lambda plain=plain, kargs=kargs: plain(*kargs), (nio * coord_bytes * n, prods * n)))
        if want("padd_rcb"):  # the suffix scan's and the collapse's widths
            for m in cs.PADD_WIDTHS:
                kargs = cs.proj_lanes(tf, ax, ay, gen, m)
                others.append(("padd_rcb", f"{m} lanes", lambda kargs=kargs: cc.padd_rcb(*kargs),
                               lambda kargs=kargs: cc.padd_rcb_plain(*kargs), (9 * 64 * m, cs.g1_work("padd_rcb", m))))
        # horner_fold at the (W, c) of the 2^20, 2^16, 2^15 and 2^12 MSMs (chip_smoke.horner_shapes), and at c=0
        # (adds only) for the latency fit below
        for W, hc in ((*cs.horner_shapes(), (20, 0)) if want("horner_fold") else ()):
            hp = cs.horner_windows(proj, ax, ay, W)
            others.append(("horner_fold", f"W={W}, c={hc}",
                           lambda hp=hp, hc=hc: tuple(cc.horner_fold(hp.x, hp.y, hp.z, hc)),
                           lambda hp=hp, hc=hc: tuple(cc.horner_fold_plain(hp.x, hp.y, hp.z, hc)),
                           cs.horner_work(W, hc)))
        if want("l1_rcb_mega") or want("pmadd_rcb"):
            others += mega_rows(cs, cc, pip, ax, ay, gen, c, L, n_pts)
        if only is not None:
            others = [o for o in others if o[0] in only]
        horner_ms = {}
        for name, shape, fn, plain, work, *loop in others:
            ref = plain() if plain else None
            libs = {"old": old, "new": new, **(variants if name in VARIANT_TIMED else {})}
            runs = {label: using(lib, fn) for label, lib in libs.items()}
            if loop and not hasattr(old, "hk_" + name):  # the older library runs the loop of single ops it replaces
                runs.update({"old": using(old, loop[0]), "loop (new)": using(new, loop[0])})
            for label, run in runs.items():
                got = run()
                ref = got if ref is None else ref  # without a plain version, the libraries equal the first
                if name in CHAIN_SHAPES and label in ("old", "loop (new)"):  # other formulas: the same points
                    cs.require(G1.unpack_jacobian(Jac(*got)) == G1.unpack_jacobian(Jac(*ref)),
                               f"{name} {shape} from the {label} library: other points than the plain version's")
                    continue
                err = cs.max_abs_err(got, ref)
                cs.require(err == 0, f"{name} {shape} from the {label} library differs from the "
                                     + ("plain version" if plain else "old library"))
            ms = in_turns(name, shape, runs, work)
            if name in CHAIN_SHAPES:  # a short launch: the host may issue it slower than the card runs it
                dev = {label: [] for label in ("old", "new")}
                for label in ("old", "new", "new", "old"):
                    dev[label].append(cs.graph_ms(runs[label], reps=args.reps))
                print(f"[device] {name} {shape}: " + "; ".join(f"{k} {v[0]:.4f}, {v[1]:.4f} ms" for k, v in dev.items())
                      + f" of device time a launch (chip_smoke.graph_ms, in turns); on {card}", flush=True)
            if name == "horner_fold":
                horner_ms[shape] = {k: min(v) for k, v in ms.items()}
        if {"W=20, c=13", "W=20, c=0"} <= set(horner_ms):  # both Horner rows ran (not cut by --only)
            # the Horner chain's latency: (W-1) adds at c=0, 13 (W-1) doublings more at c=13; the old
            # one-thread body runs 8 products and 13 field additions a double, 12 and 27 an add, in
            # program order (the carry chains are volatile), which gives one product's latency there
            full, adds = horner_ms["W=20, c=13"], horner_ms["W=20, c=0"]
            per = {k: (adds[k] / 19, (full[k] - adds[k]) / (19 * 13)) for k in full}
            a_old, d_old = per["old"]
            prod_us = (27 * d_old - 13 * a_old) / (27 * 8 - 13 * 12) * 1e3
            add_us = (d_old * 1e3 - 8 * prod_us) / 13
            levels = 2 * 19 * 14
            print("[horner] per point op (W=20): " + "; ".join(f"{k} double {d * 1e3:.3f} us, add {a * 1e3:.3f} us"
                                                            for k, (a, d) in per.items())
                  + f"; the old body's product ~{prod_us:.3f} us, field "
                  f"addition ~{add_us:.3f} us; the new chain's {levels} dependent product levels x one product = "
                  f"{levels * prod_us / 1e3:.3f} ms (a latency diagnostic, not a bound) against {full['new']:.3f} ms; "
                  f"on {card}", flush=True)

    if "inv" in sections:
        fids = {"fq": 0, "fr": 1, "fq_bls381": 2}
        instr_rate = INSTR_PER_SM_CLOCK * bound.sms * bound.clock_hz
        for spec, m in ((tf.FQ, 1024), (tf.FQ, cs.N_LANES), (tf.FQ, N_WIDE), (tf.FR, 1024), (tf.FQ_BLS, 1024),
                        (tf.FQ_BLS, N_WIDE)):
            nw = spec.nlimbs // 2
            a = cs.inv_lanes(tf, spec, m, gen)
            ref = cf.fermat_inv_plain(spec, a)
            fn = lambda spec=spec, a=a: cf.fermat_inv(spec, a)  # noqa: E731
            for label, lib in (("old", old), ("new", new)):
                with cuda_lib.using(lib):
                    err = cs.max_abs_err(fn(), ref)
                cs.require(err == 0, f"fermat_inv {spec.name} {m} lanes from the {label} library differs from mont_inv")
            # this tree's SASS a lane: the kernel once, its loop (a batch of 30 divsteps) once a batch
            total, loop = new_sass[f"fermat_inv_kernel<{fids[spec.name]}>"]
            ins = total - loop + cs.INV_SHAPES[nw][1] * loop
            ms = in_turns(f"fermat_inv {spec.name}", f"{m} lanes", {"old": using(old, fn), "new": using(new, fn)},
                          bound.inv(m, nw))
            instr_ms = m * ins / instr_rate * 1e3
            print(f"[inv] fermat_inv {spec.name} {m} lanes: this tree's divsteps {ins} SASS instructions a lane, "
                  f"at {INSTR_PER_SM_CLOCK} an SM a clock {instr_ms:.4f} ms ({100 * instr_ms / min(ms['new']):.1f}% "
                  f"of its time); dependent chain ~{cs.inv_chain(nw)} operations; on {card}", flush=True)

    if "g2" in sections:  # at the G2 MSM's own level-1 width
        sc = pip.pack_scalars(cs.rand_scalars(rs, n_pts, h.R), G2).to(DEVICE)
        ncols, pm_args, pa_args = cs.g2_level1_inputs(pip, g2x, g2y, sc, c, L)
        for op, kargs, nio in (("pmadd_rcb_g2", pm_args, 8), ("padd_rcb_g2", pa_args, 9)):
            fn = getattr(cc, op)
            got = fn(*kargs)
            with cuda_lib.using(old):
                cs.require(cs.max_abs_err(fn(*kargs), got) == 0, f"{op} at {ncols} lanes: the libraries differ")
            in_turns(op, f"{ncols} lanes (the msm_g2 level-1 width)",
                     {"old": using(old, lambda: fn(*kargs)), "new": lambda: fn(*kargs)},
                     (nio * 128 * ncols, cs.RCB_G2_PRODUCTS[op] * ncols))
        # pdbl_rcb_g2 on the level-1 width's projective points, and on one lane (the G2 Horner's launches)
        fn = cc.pdbl_rcb_g2
        for m in (ncols, 1):
            kargs = tuple(t[:m].contiguous() for t in pa_args[:3])
            got = fn(*kargs)
            if m == 1:
                cs.require(cs.max_abs_err(got, cc.pdbl_rcb_g2_plain(*kargs)) == 0,
                           "pdbl_rcb_g2 at 1 lane differs from its plain version")
            with cuda_lib.using(old):
                cs.require(cs.max_abs_err(fn(*kargs), got) == 0, f"pdbl_rcb_g2 at {m} lanes: the libraries differ")
            in_turns("pdbl_rcb_g2", f"{m} lanes", {"old": using(old, lambda: fn(*kargs)), "new": lambda: fn(*kargs)},
                     (6 * 128 * m, cs.RCB_G2_PRODUCTS["pdbl_rcb_g2"] * m))
        del sc
        # the G2 window Horner: one horner_fold_g2 launch against the loop of one-lane launches it replaced
        old_fold = (lambda p, hc: cc.horner_fold_g2(*p, hc)) if hasattr(old, "hk_horner_g2") \
            else (lambda p, hc: cc.fold_windows(proj.PROJ_G2, *p, hc))
        g2_ms = {}
        for W, hc in (*G2_HORNER_SHAPES, (20, 0)):
            p = cs.horner_windows(proj, g2x, g2y, W, proj.PROJ_G2)
            ref = cc.horner_fold_g2_plain(*p, hc)
            with cuda_lib.using(old):
                cs.require(cs.max_abs_err(old_fold(p, hc), ref) == 0, f"G2 Horner W={W}, c={hc}: the old library differs")
            cs.require(cs.max_abs_err(cc.horner_fold_g2(*p, hc), ref) == 0,
                       f"horner_fold_g2 W={W}, c={hc} differs from its plain version")
            ms = in_turns("horner_fold_g2", f"W={W}, c={hc}", {"old": using(old, lambda: old_fold(p, hc)),
                                                               "new": lambda: cc.horner_fold_g2(*p, hc)},
                          cs.horner_g2_work(W, hc), f"; {cs.latency_note(cs.chain_levels('horner_fold_g2', (W, hc)))}")
            g2_ms[(W, hc)] = {k: min(v) for k, v in ms.items()}
        if (20, 13) in g2_ms:
            full, adds = g2_ms[(20, 13)], g2_ms[(20, 0)]
            print("[horner_g2] per point op (W=20): " + "; ".join(
                f"{k} double {(full[k] - adds[k]) / (19 * 13) * 1e3:.3f} us, add {adds[k] / 19 * 1e3:.3f} us"
                for k in full) + f"; on {card}", flush=True)

    if "k_add" in sections:  # K_ADD at the main path's widths
        widths = {}
        launch = cc._launch_aff_add

        def recorded(fn, entries, x1, *rest):
            key = (fn.__name__, x1.numel() // 16)
            widths[key] = widths.get(key, 0) + 1
            return launch(fn, entries, x1, *rest)

        cc._launch_aff_add = recorded
        sc = cs.rand_limbs(n_pts, gen)
        pip.msm_gpu(ax, ay, sc, c=c, L=L)
        pip.msm_gpu(ax, ay, sc, c=c, L=L, level1="steps")
        cc._launch_aff_add = launch
        print(f"[k_add] {sum(widths.values())} affine-pair launches at {len(widths)} widths: "
              + ", ".join(f"{name} {n} x{k}" for (name, n), k in sorted(widths.items(), key=lambda kv: -kv[1])[:12]))
        totals, by_name, per = {}, {}, {}
        for (name, n), calls in widths.items():
            x1, y1 = ax[:n].contiguous(), ay[:n].contiguous()
            x2, y2 = ax[n_pts - n:].contiguous(), ay[n_pts - n:].contiguous()
            q = (cc.AffineOps.pack_rows(cc.Aff(x2, y2)).contiguous(),) if name == "aff_add_mixed_packed" else (x2, y2)
            fn = getattr(cc, name)
            ms = {k: [] for k in k_adds}
            for k in k_adds + k_adds[::-1]:  # in turns: forward, then backward
                cc.K_ADD = k
                ms[k].append(cs.cuda_ms(lambda: fn(x1, y1, *q), args.reps))
            for k in k_adds:
                per[(name, n, k)] = min(ms[k])
                totals[k] = totals.get(k, 0.0) + calls * per[(name, n, k)]
                by_name[(name, k)] = by_name.get((name, k), 0.0) + calls * per[(name, n, k)]
        cc.K_ADD = k_default
        for name, n in sorted(widths, key=lambda w: -widths[w] * per[(*w, k_default)])[:8]:
            print(f"[k_add] {name} {n} lanes x{widths[(name, n)]}: "
                  + ", ".join(f"K_ADD={k} {per[(name, n, k)]:.4f} ms" for k in k_adds))
        print("[k_add] the two routes' affine-pair launches summed: "
              + ", ".join(f"K_ADD={k} {t:.3f} ms" for k, t in totals.items()) + "; by kernel: "
              + ", ".join(f"{name} K_ADD={k} {t:.3f} ms" for (name, k), t in sorted(by_name.items())) + f" on {card}")
    if "compact" in sections:  # the compact msm, the chains as loops of single ops (old) or one launch each (new)
        old_g1 = G1 if hasattr(old, "hk_jac_ladder") else g1_loops  # an older library's own chain kernels

        def old_msm(*a, **kw):
            with cuda_lib.using(old):
                return pip.msm(old_g1, *a, **kw)

        def host_ms(fn):
            times = []
            for _ in range(args.reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            return sorted(times)[len(times) // 2]

        for n in COMPACT_POINTS:
            pts = list(host_pts[:n])
            px, py = (torch.from_numpy(a).to(DEVICE) for a in G1.pack_affine(pts))
            psc = pip.pack_scalars(scalars[:n], G1).to(DEVICE)
            cn = TorchBackend.compact_window(n)
            want = h.ch.msm_host(pts, scalars[:n])
            fns = {"old": lambda: old_msm(px, py, psc, c=cn), "new": lambda: pip.msm(G1, px, py, psc, c=cn)}
            for label, fn in fns.items():
                out = fn()
                cs.require(G1.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == want,
                           f"compact msm of {n} points from the {label} code differs from msm_host")
            ms = {k: [] for k in fns}
            for label in list(fns) + list(fns)[::-1]:
                ms[label].append(host_ms(fns[label]))
            busy = {label: [cs.device_busy(fns[label])[0] for _ in range(2)] for label in fns}
            print(f"[compact] G1 {n} points ({'ladder' if n <= pip.MSM_LADDER_THRESHOLD else f'c={cn}'}), host "
                  f"clock, medians of {args.reps}: " + "; ".join(f"{k} {v[0]:.2f}, {v[1]:.2f} ms" for k, v in ms.items())
                  + f"; old / new {min(ms['old']) / min(ms['new']):.1f}; device time a call (torch.profiler): "
                  + "; ".join(f"{k} " + ", ".join("not measured" if t is None else f"{t:.3f}" for t in v) + " ms"
                              for k, v in busy.items())
                  + f"; both equal msm_host; on {card}", flush=True)
        # the Horner combine two ways on the same window sums: jac_horner, and
        # msm_gpu's horner_fold between the Jacobian and projective forms
        for shape in CHAIN_SHAPES["jac_horner"]:
            (x, y, z, c), _, label, _ = cs.chain_inputs(h, tf, cc, G1, "jac_horner", shape, host_pts, scalars, gen)
            routes = {"jac_horner": lambda: cc.jac_horner(x, y, z, c),
                      "horner_fold route": lambda: proj.PROJ_G1.to_jacobian(
                          cc.horner_fold(*(a.contiguous() for a in proj.PROJ_G1.from_jacobian(Jac(x, y, z))), c))}
            got = [G1.unpack_jacobian(Jac(*(a[None] for a in fn())))[0] for fn in routes.values()]
            cs.require(got[0] == got[1], f"Horner {label}: the two routes differ as points")
            ms = {k: [] for k in routes}
            for k in list(routes) + list(routes)[::-1]:
                ms[k].append(cs.cuda_ms(routes[k], args.reps))
            print(f"[horner] {label}: " + "; ".join(f"{k} {v[0]:.4f}, {v[1]:.4f} ms" for k, v in ms.items())
                  + f" (CUDA events, in turns); the same point; on {card}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
