"""The G2 MSM's RCB kernels (pmadd_rcb_g2, padd_rcb_g2, pdbl_rcb_g2) against
an older csrc/curve_g2.cu, on one CUDA card.

    python3 benches/torch_g2_ab.py --old build/old/curve_g2.cu [more.cu ...] [--reps 20] [--log2n 20]

Builds one more kernel library for each --old file (a curve_g2.cu), from
hekaton_tpu_torch/csrc with csrc/curve_g2.cu swapped for that file
(`cuda_lib.build(swap=...)`; put an older version in the git-ignored build/, for
example `git show <commit>:hekaton_tpu_torch/csrc/curve_g2.cu >
build/old/curve_g2.cu`), prints ptxas's registers and spills of every
build's G2 kernels, and times each kernel from every library in turns (the
--old files in order, this tree's, then the same backwards: old, new, new,
old for one file) on the same inputs with CUDA events (chip_smoke.cuda_ms:
the mean of --reps launches after one warm launch):
- at 2^18 lanes with chip_smoke.py's completeness lanes (proj_edge_lanes
  on the msm_g2 set), where every library's outputs must equal the plain
  version's bit for bit;
- pmadd_rcb_g2 and padd_rcb_g2 at the G2 MSM's own level-1 width, the
  columns of the 2^log2n-point msm_g2 set's plan (chip_smoke.g2_level1_inputs),
  where every library must agree with this tree's bit for bit.
Each line carries the kernel's bound (chip_smoke.Bound) and the card's name
and power limit. Exits non-zero where torch.cuda.is_available() is false.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"
KERNELS = ("pmadd_rcb_g2_kernel", "padd_rcb_g2_kernel", "pdbl_rcb_g2_kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, nargs="+", help="the curve_g2.cu files to compare with")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--log2n", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_g2_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hekaton_tpu_torch import cuda_lib
    from hekaton_tpu_torch import host as h
    from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
    from hekaton_tpu_torch.curves import cuda_curve as cc
    from hekaton_tpu_torch.curves import proj
    from hekaton_tpu_torch.curves.torch_curve import G2
    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.msm import pippenger as pip

    card = cs.smi("name,power.limit")
    libs, reports = {}, {}
    for path in args.old:
        lib_path, reports[path] = cuda_lib.build(swap=path)
        libs[path] = cuda_lib.load(lib_path)
    reports["this tree"] = cuda_lib.build()[1]
    libs["this tree"] = cuda_lib.lib()
    for label, report in reports.items():
        for name, regs, spill in cs.ptxas_summary(report):
            if name in KERNELS:
                print(f"[ptxas] {label} {name}: {regs} registers, {spill} bytes spilled")

    n = 1 << args.log2n
    rs = np.random.RandomState(cs.SEED)
    _, _, g2x, g2y = cs.g2_set(h, G2, rs, n)
    sc = pip.pack_scalars(cs.rand_scalars(rs, n, h.R), G2).to(DEVICE)
    c, L = TorchBackend.msm_params(n)
    bound = cs.Bound()
    gen = torch.Generator(device=DEVICE).manual_seed(cs.SEED)
    gp, gq, (bx, by) = cs.proj_edge_lanes(tf, proj, g2x, g2y, gen)
    ncols, pm_args, pa_args = cs.g2_level1_inputs(pip, g2x, g2y, sc, c, L)
    cases = [("pmadd_rcb_g2", cs.N_LANES, (*gp, bx, by), 8, True),
             ("padd_rcb_g2", cs.N_LANES, (*gp, *gq), 9, True),
             ("pdbl_rcb_g2", cs.N_LANES, tuple(gp), 6, True),
             ("pmadd_rcb_g2", ncols, pm_args, 8, False),
             ("padd_rcb_g2", ncols, pa_args, 9, False)]
    for op, lanes, kargs, nio, edge in cases:
        fn = getattr(cc, op)
        outs = {}
        for label, lib in libs.items():
            with cuda_lib.using(lib):
                outs[label] = fn(*kargs)
        ref = getattr(cc, op + "_plain")(*kargs) if edge else outs["this tree"]
        err = max(cs.max_abs_err(out, ref) for out in outs.values())
        cs.require(err == 0, f"{op} at {lanes} lanes: the libraries or the plain version differ ({err})")
        ms = {label: [] for label in libs}
        for label in list(libs) + list(libs)[::-1]:
            with cuda_lib.using(libs[label]):
                ms[label].append(cs.cuda_ms(lambda: fn(*kargs), args.reps))
        b_ms, b_by = bound(nio * 128 * lanes, cs.RCB_G2_PRODUCTS[op] * lanes)
        print(f"[ab] {op} {lanes} lanes ({'completeness lanes, = plain' if edge else 'msm_g2 level-1 width'}): "
              + "; ".join(f"{label} {t[0]:.3f}, {t[1]:.3f} ms" for label, t in ms.items())
              + f"; bound {b_ms:.4f} ms ({b_by}); bit-identical; on {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
