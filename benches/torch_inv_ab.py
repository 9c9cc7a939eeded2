"""The inversion kernel (fermat_inv) against an older csrc/field.cu, on one
CUDA card.

    python3 benches/torch_inv_ab.py --old build/old/field.cu [more.cu ...] [--reps 20]

Builds one more kernel library for each --old file (a field.cu), from
hekaton_tpu_torch/csrc with csrc/field.cu swapped for that file
(`cuda_lib.build(swap=...)`). A field.cu includes "field.cuh" from its own
directory first, so each file's directory holds the header it was written
against; for an older commit:

    mkdir -p build/old && for f in field.cu field.cuh; do
        git show <commit>:hekaton_tpu_torch/csrc/$f > build/old/$f; done

(build/ is git-ignored.) Prints ptxas's registers and spills of every
build's fermat_inv_kernel instances, and their SASS (cuobjdump -sass):
instructions in all and in the longest loop, for this tree's library a
batch of 30 divsteps with its matrix updates, run once a batch. Then it
times fermat_inv from every library in turns (the --old files in order,
this tree's, then the same backwards: old, new, new, old for one file) with
CUDA events (chip_smoke.cuda_ms: the mean of --reps launches after one warm
launch) at the widths the main paths use: BN254 Fq at 1024 lanes, 2^18
(to_affine_device on a fixed-base chunk) and N_WIDE lanes, Fr at 1024 and
BLS12-381 Fq (24 limbs) at 1024 and N_WIDE, on chip_smoke.inv_lanes (its
edge lanes, 0 among them, then random lanes). Every library's output must
equal the plain version's (tf.mont_inv, the Fermat chain) bit for bit. Each
line carries the bound of the function (chip_smoke.Bound.inv: the lanes'
bytes, or Montgomery's trick's 3 products a lane), and, for this tree's
library, the time its SASS instructions take at the instruction rate of an SM
(INSTR_PER_SM_CLOCK), a diagnostic of the divstep algorithm, not a bound
of the function; and the card's name and power limit. Exits non-zero where
torch.cuda.is_available() is false.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE = "cuda"
N_WIDE = 734_740  # the widest width the 2^20 G1 and BLS12-381 MSMs invert at most (a level-1 round)
INSTR_PER_SM_CLOCK = 128  # thread instructions an SM starts a clock: 4 schedulers, one 32-lane warp each


def sass_counts(so: str) -> dict:
    """{fermat_inv_kernel instance: (SASS instructions, instructions of its
    longest loop)} from `cuobjdump -sass` of the library `so`; a loop is a
    branch back to a lower address."""
    import chip_smoke as cs

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
            name, ins = (cs.kernel_name(line.split()[-1]) if "fermat_inv_kernel" in line else None), []
        elif name:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                branch = re.search(r"\bBRA (0x[0-9a-f]+)", m.group(2))
                ins.append((int(m.group(1), 16), branch.group(1) if branch else None))
    close()
    cs.require(proc.wait() == 0, f"cuobjdump -sass {so} failed")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, nargs="+", help="the field.cu files to compare with")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_inv_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hekaton_tpu_torch import cuda_lib
    from hekaton_tpu_torch.fields import cuda_field as cf
    from hekaton_tpu_torch.fields import torch_field as tf

    card = cs.smi("name,power.limit")
    libs, reports, paths = {}, {}, {}
    for path in args.old:
        paths[path], reports[path] = cuda_lib.build(swap=path)
        libs[path] = cuda_lib.load(paths[path])
    paths["this tree"], reports["this tree"] = cuda_lib.build()
    libs["this tree"] = cuda_lib.lib()
    per_lane = {}  # this tree's SASS instructions a lane, by field id
    for label, report in reports.items():
        sass = sass_counts(paths[label])
        for name, regs, spill in cs.ptxas_summary(report):
            if name.startswith("fermat_inv_kernel"):
                total, loop = sass[name]
                print(f"[ptxas] {label} {name}: {regs} registers, {spill} bytes spilled; SASS {total} "
                      f"instructions, {loop} in its longest loop")
                if label == "this tree":
                    fid = int(name[-2])
                    batches = cs.INV_SHAPES[12 if fid == 2 else 8][1]
                    per_lane[fid] = total - loop + batches * loop

    bound = cs.Bound()
    instr_rate = INSTR_PER_SM_CLOCK * bound.sms * bound.clock_hz
    gen = torch.Generator(device=DEVICE).manual_seed(cs.SEED)
    fids = {"fq": 0, "fr": 1, "fq_bls381": 2}
    for spec, m in ((tf.FQ, 1024), (tf.FQ, cs.N_LANES), (tf.FQ, N_WIDE), (tf.FR, 1024), (tf.FQ_BLS, 1024),
                    (tf.FQ_BLS, N_WIDE)):
        nw = spec.nlimbs // 2
        a = cs.inv_lanes(tf, spec, m, gen)
        ref = cf.fermat_inv_plain(spec, a)
        for label, lib in libs.items():
            with cuda_lib.using(lib):
                err = cs.max_abs_err(cf.fermat_inv(spec, a), ref)
            cs.require(err == 0, f"fermat_inv {spec.name} {m} lanes from {label} differs from mont_inv ({err})")
        ms = {label: [] for label in libs}
        for label in list(libs) + list(libs)[::-1]:
            with cuda_lib.using(libs[label]):
                ms[label].append(cs.cuda_ms(lambda: cf.fermat_inv(spec, a), args.reps))
        work = bound.inv(m, nw)
        b_ms, b_by = bound(*work)
        ins = per_lane[fids[spec.name]]
        instr_ms = m * ins / instr_rate * 1e3
        new_ms = min(ms["this tree"])
        print(f"[ab] fermat_inv {spec.name} {m} lanes: "
              + "; ".join(f"{label} {t[0]:.4f}, {t[1]:.4f} ms" for label, t in ms.items())
              + f"; bound {b_ms:.4f} ms ({b_by}), this tree at {100 * b_ms / new_ms:.1f}% of it; divsteps: "
              f"{ins} SASS instructions a lane at {INSTR_PER_SM_CLOCK} a SM a clock {instr_ms:.4f} ms "
              f"({100 * instr_ms / new_ms:.1f}% of this tree's time), dependent chain ~{cs.inv_chain(nw)} "
              f"operations; bit-identical with mont_inv; on {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
