"""Smoke run of the PyTorch + CUDA port (hekaton_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the kernels are built from hekaton_tpu_torch/csrc
at first use, one nvcc per source, all at once) and a host C++ compiler (the
native host library). Phases, one line each, every failure raises:

  1. device: the card's name and power limit; build the kernels;
  2. kernels: each CUDA kernel entry point against its plain
     PyTorch version on the card, at the main paths' shapes, bit for bit,
     with both times and the kernel's bound (and l1_rcb_mega on the
     transposed slab as well), mont_mul and fermat_inv also at BLS12-381's
     24 limbs (rows of their own); fermat_inv (the divstep inversion) on
     Fq at 1024 and 2^18 lanes, Fr at 1024 and BLS12-381 Fq at 1024, with
     inv_edge_values' lanes (0 -> 0 among them) against mont_inv (the plain
     Fermat chain), its two rows after the main paths (below); the C entry
     points refuse an unknown field id;
     pmadd_rcb_g2 and padd_rcb_g2 also at the G2 MSM's own level-1 width
     (the msm_g2 set's plan, every lane against the plain version; lines of
     their own), pdbl_rcb_g2 on those accumulators, on one lane (the width
     of the one-lane Horner launches horner_fold_g2 replaced; timed, with
     its device time a launch from torch.profiler) and on 2^18 edge lanes as
     unaligned views;
     l1_aff_halves and l1_aff_halves_t on the G1 MSM's own v9 slab (734,740 columns x 32 at 2^20 points; one launch is one level 1),
     every column against the plain version, and on a 2^16-point plan's
     slab (lines of their own); l1_rcb_mega on the same v9 slab (its row;
     the transposed layout a line), on route (b)'s L=24 slab in both
     layouts and on the 2^16-point slab (lines), every column against the
     plain version; pmadd_rcb at route (c)'s width (the v9 slab's columns
     after 3 level-1 steps; its row) and on 2^18 edge lanes, also as
     unaligned views (a line); madd (its row on 2^18 edge lanes, also as
     unaligned views) at 255,357 lanes, a fixed-base width without edges,
     and padd_rcb (its row at 2^18, also unaligned) at 81,940 and 734,740
     lanes, the suffix scan's and the collapse's widths (lines of their
     own); pdbl_rcb, dbl and add (their rows) on 2^18 edge lanes, also as
     unaligned views; aff_add_fused and aff_add_mixed_packed on
     2^18 edge lanes (lines of their own; their rows come after the main
     paths, below); no kernel may spill, and each kernel's registers,
     spills and resident blocks an SM (CUDA's occupancy query) are printed;
  3. the main paths, each driven with every launch count set to 0 just
     before it and read just after it:
     - msm_g1: the G1 MSM at 2^20 points against a closed-form host result;
     - msm_routes: the same MSM along msm_gpu's other routes (ROUTES:
       projective, mega, tsort, gather and affine steps), each against the
       same host result, with its peak memory;
     - unfused_affine: aff_prep, batch_inv and aff_fin on 2^18 lanes
       against aff_add_fused;
     - msm_compact: the compact msm (TorchBackend's route up to 2,048
       points) on G1 at 32 (the ladder), 33 and 2,048 points and on G2 at 33
       points, with zero scalars, r-1, a repeated and an infinity point,
       against curves/host.py::msm_host; on G1 its chains run in
       CHAIN_KERNELS, one jac_ladder launch a ladder and one jac_horner
       launch a bucket MSM (every main path is held to that);
     - msm_g2: the G2 MSM at 2^20 points (4,096 distinct points k_j * G2
       tiled 256 times, an infinity row) against (sum_i s_i k_(i mod 4096))
       * G2 by one host mul; its window Horner in one horner_fold_g2 launch
       (every main path is held to one a G2 msm_gpu call);
     - msm_bls: the BLS12-381 G1 MSM at 2^20 points on msm_gpu's default
       route for that curve (4,096 distinct points k_j * G tiled 256 times,
       an infinity row, scalars below BLS12-381's r) against (sum_i s_i
       k_(i mod 4096)) * G by one host mul, then its routes BLS_ROUTES at
       2^16 points and the compact msm at 32 and 33 points;
     - exec_tree: the coordinator's generate_exec_tree on ROM and RAM
       transcripts of 2^16 entries over 32 subcircuits, with
       HEKATON_DEVICE_TREE=1 (the device tree, on the card) and without it
       (the host tree), with equal roots, levels and leaves;
     - fixed_base: TorchBackend.fixed_base of 2^18 scalars on G1 and on G2
       against the native host muls on 4,096 sampled lanes, with the
       device time of a warm G1 call and madd's part of it (torch.profiler);
     - slice: BASELINE.json configuration 1 (Big-Merkle, 4 subcircuits,
       1 SHA2 iteration, 8 portals) through the port's coordinator and
       worker with TorchBackend("cuda"): setup (fixed-base on the card),
       stage 0, stage 1, per-proof verify, SnarkPack aggregation and
       aggregate verify; a tampered proof is rejected; the stage-1 proofs
       equal HostBackend's bit for bit; backend.ran shows no host route;
     - mesh: the slice's keys and requests through the port's mesh runtime
       (runtime/mesh_prover.py::MeshProver) on a world of one rank over
       NCCL on the card (the card runs one rank): stage 0 and stage 1, whose
       commitments and proofs must equal the slice's bit for bit; stage 0
       again with force_ladder (every commitment MSM on jac_ladder and
       jac_sum), its commitments equal to the default path's; the sharded
       NTT (ntt/sharded.py) at D = 1 at configuration 1's domain size
       against the port's ntt, forward and inverse;
     - cli: BASELINE.json configuration 4 (VM, cut) and configuration 1
       through the port's CLI in-process (CLI_RUNS): `setup-*`, then `work
       --spill-dir`, which must print that the aggregate proof verified and
       round-trip stage 0 through the wire format; configuration 1's stage-0
       commitments take the compact msm; configuration 1's key file then
       through `work --mesh 1x1`, which must print the mesh line and verify
       the aggregate;
     after the main paths, [sha256]: hashes/sha256_torch.py on 2^20
     messages of 64 bytes (one Merkle level of two-child hashes, two
     blocks each) on the card, every digest against hashlib, with its time
     and rate (plain PyTorch: no kernel of its own);
     after msm_bls, [batch_inv]: tf.batch_inv's calls on SWEPT_PATHS,
     recorded by (field, lanes), each timed at every root width of
     ROOT_WIDTHS (and held bit for bit against no tree), summed per path;
     after the last path, the kernel table's fermat_inv rows: at the widths
     the main paths launched it at, recorded with their launches, the
     kernel held bit for bit against mont_inv at the width with the most
     lanes and timed at the width launched most often (inv_rows); and the
     affine pair's rows the same way (aff_rows: held against the plain
     version at the widest width, the one with the most lanes and the one
     launched most often, with edge lanes, timed at the last); before them
     the chain kernels' rows (chain_rows: each limb for limb against its
     plain version and as points against a host walk at every shape the
     main paths launched it at, with edge inputs whose chains double, reach
     the identity and take a Jacobian infinity with X, Y != (1, 1), timed at
     the shape launched most often); before them
     horner_fold's row (horner_rows): limb for limb against
     horner_fold_plain at every (W, c) the main paths launched it at and at
     those of 2^20-, 2^16-, 2^15- and 2^12-point MSMs (horner_shapes), timed
     at the one launched most often, on edge window sums
     (horner_edge_sets) and at its widest W, one window more refused;
     horner_fold_g2's row the same way (horner_g2_rows: every (W, c) the
     main paths launched, G2 edge window sums, the widest W, one more
     refused), timed beside the loop of one-lane pdbl_rcb_g2 / padd_rcb_g2
     launches it replaces; each chain and fold row logs a latency
     diagnostic (chain_levels: its dependent product levels times
     PRODUCT_LATENCY_US);
  4. coverage: every kernel of each path was launched in that path's run,
     the point-op kernels' launches by width (lanes), the level-1 slab
     kernels' by (columns, L) and horner_fold's by (W, c), summed over the
     main paths, are printed, every width and the lanes summed,
     fermat_inv as often as its callers (tf.batch_inv, to_affine_device)
     were called on CUDA tensors,
     no path but msm_routes launched one of ROUTE_KERNELS, none but
     unfused_affine one of UNFUSED_KERNELS, none but msm_bls one of
     BLS_KERNELS (the 24-limb instances), and msm_bls nothing else; no path
     launched dbl or pdbl_rcb_g2 (NO_PATH_KERNELS) or add on one lane; one
     horner_fold_g2 launch a G2 msm_gpu call.

It prints the kernel table as one JSON line, the card's name and power limit,
and last {"ok": true, "device": {...}}. It exits non-zero, printing no
result, where torch.cuda.is_available() is false.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

SEED = 20261016
DEVICE = "cuda"
N_MSM = 1 << 20  # the G1 and G2 MSMs (bench.py's size, TorchBackend.G1_CHUNK / G2_CHUNK)
N_MUL = 1 << 20  # mont_mul lanes in phase 2
N_LANES = 1 << 18  # lanes of the point-op kernels in phase 2 (TorchBackend.FB_CHUNK)
N_PLAN = 1 << 16  # points of the plan whose level-1 slab phase 2 reduces
N_FB = 1 << 18  # fixed-base scalars per curve
MADD_WIDE = 255_357  # a madd width of the setup's fixed-base calls (launched 128 times over the main paths)
PADD_WIDTHS = (81_940, 734_740)  # padd_rcb's widest suffix-scan (20 windows x 4,097 buckets) and collapse widths
N_G2_DISTINCT = 4096  # distinct G2 points of the G2 MSM, tiled to N_MSM
N_SAMPLE = 4096  # fixed-base lanes checked against the host
N_COMPACT = ((1, 32), (1, 33), (1, 2048), (2, 33))  # (curve, points) of the compact msm checks
# msm_routes: (label, L, msm_gpu route arguments) at the msm_g1 set's c
ROUTES = (
    ("(a)", 32, {"accum": "proj"}),  # resolves to level1="mega"
    ("(b)", 24, {}),  # L not a power of two: mega, then affine accumulation
    ("(c)", 32, {"accum": "proj", "level1": "steps"}),  # one pmadd_rcb launch per slab row
    ("(d)", 32, {"plan": "tsort"}),  # interleave_slab_t, then l1_aff_halves_t
    ("(e)", 32, {"plan": "tsort", "accum": "proj"}),  # interleave_slab_t, then mega on the transposed slab
    ("(f)", 32, {"plan": "gather"}),  # warns: "pair" becomes "steps", one add_packed per gathered row
    ("(g)", 32, {"plan": "gather", "level1": "mega"}),  # mega on the gathered slab
    ("(h)", 32, {"level1": "steps"}),  # wsort, one aff_add_mixed_packed per slab row
)
WARNS = ("(f)",)  # the routes that warn
ROUTE_KERNELS = ("pmadd_rcb", "padd_rcb", "pdbl_rcb", "l1_rcb_mega", "aff_add_mixed_packed", "interleave_slab_t",
                 "l1_aff_halves_t")  # only msm_routes launches them
UNFUSED_KERNELS = ("aff_prep", "aff_fin")  # no MSM route runs them: only unfused_affine
BLS_KERNELS = ("mont_mul fq_bls381", "fermat_inv fq_bls381")  # the 24-limb instances: only msm_bls
# the compact msm's chains of Jacobian ops on BN254 G1, one launch each: the
# ladders, the in-order chunk sums of its tree reduction, the Horner combine
CHAIN_KERNELS = ("jac_ladder", "jac_sum", "jac_horner")
NO_PATH_KERNELS = ("dbl", "pdbl_rcb_g2")  # held in [kernels] only: the chains and folds double inside their kernels
N_BLS_DISTINCT = 4096  # distinct BLS12-381 G1 points of msm_bls, tiled to N_MSM
N_BLS_ROUTES = 1 << 16  # points of the BLS12-381 routes other than the default
# msm_bls's other routes: (label, msm_gpu route arguments), c and L of msm_g1
BLS_ROUTES = (
    ("pair", {"level1": "pair"}),  # the generic pairwise tree, a batch inversion per round
    ("proj", {"accum": "proj"}),  # generic projective mixed adds, no inversion
    ("gather", {"plan": "gather"}),  # the gather plan, one add_packed per gathered row
)
N_BLS_COMPACT = (32, 33)  # points of the compact BLS12-381 msm (the ladder, then windows)
# batch_inv's root widths swept in [batch_inv] (None: no tree), over the
# calls of the paths in SWEPT_PATHS
ROOT_WIDTHS = (1024, 4096, 16384, 65536, 1 << 18, None)
SWEPT_PATHS = ("msm_g1", "unfused_affine", "msm_bls")
N_TREE = 1 << 16  # transcript entries of the exec_tree phase
N_TREE_SUB = 32  # its subcircuits
N_SHA = 1 << 20  # messages of the [sha256] phase: one Merkle level of two-child hashes
# The [cli] phase's CLI runs: (label, setup command, whether its key file
# also goes through `work --mesh 1x1`). BASELINE.json
# configuration 4 (VM, 32 subcircuits, 1,024 cycles per subcircuit) is cut to
# fit the script's time limit: a VM subcircuit holds ~1,000 constraints per
# cycle, and at full size setup took ~300 s and stage 1 did not end within
# 900 s (host synthesis and matrix evaluation of ~1M constraints per
# subcircuit). Subcircuits are cut first, then cycles. Every MSM of a VM
# subcircuit has more than 2,048 points, so configuration 1 (uncut) runs
# through the CLI as well: its stage-0 commitments take the compact msm.
CLI_RUNS = (
    ("configuration 4 cut to VM, 8 subcircuits, 256 cycles each",
     ["setup-vm", "--num-subcircuits", "8", "--num-cycles-per-subcircuit", "256"], False),
    ("configuration 1 (Big-Merkle, 4 subcircuits, 1 SHA2 iteration, 8 portals)",
     ["setup-big-merkle", "--num-subcircuits", "4", "--num-sha2-iters", "1", "--num-portals", "8"], True),
)

# The bound of a kernel: the larger of its bytes over the card's memory rate
# and its 32-bit multiplies over the card's integer multiply rate.
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_MULS_PER_SM_CLOCK = 64  # 32-bit integer multiply(-add)s per SM per clock, compute capability 9.0


def muls_per_product(nw: int = 8) -> int:
    """32-bit multiplies of one nw-word CIOS Montgomery product
    (csrc/field.cuh::fe_mul): nw^2 word products a_i*b_j and nw^2 m*p_j,
    each a low and a high multiply, plus nw m = t0*ninv: 264 at 8 words
    (BN254), 588 at 12 (BLS12-381)."""
    return 4 * nw * nw + nw


def muls_per_square(nw: int = 8) -> int:
    """32-bit multiplies of one nw-word square (csrc/field.cuh::fe_sqr): the
    nw(nw-1)/2 cross products a_i*a_j and the nw squares a_i^2, each a low
    and a high multiply, then the reduction's 2 nw^2 + nw: 208 at 8 words."""
    return nw * (nw + 1) + 2 * nw * nw + nw


def g1_products(products: float, squares: float) -> float:
    """BN254 products and squares in CIOS products' worth (muls_per_product)."""
    return products + squares * muls_per_square() / muls_per_product()


# What a BN254 G1 op needs a lane, (products, squares), csrc/curve.cu: an
# affine sum from 1/den is lambda, lambda^2 and lambda (x1 - x3) (Montgomery's
# trick adds 3 products an add, a doubling lane the square x1^2). The
# Jacobian ops and the RCB ops are counted by lazy_products
# (LAZY_G1_PRODUCTS).
G1_OPS = {"aff_sum": (2, 1)}


def lazy_products(wide: int, reductions: int, nw: int = 8, squares: int = 0) -> float:
    """The 32-bit multiplies of `wide` nw x nw-word products (nw^2 word
    products, each a low and a high multiply), `squares` wide squares
    (nw (nw+1) / 2 word products) and `reductions` Montgomery reductions of
    a 2nw-word value (nw^2 m*p_j, low and high, and nw m = t0*ninv), in
    CIOS products' worth (muls_per_product): the least a formula needs with
    one reduction a result, a sum of two products reduced once (lazy
    reduction); on Fq2, Karatsuba's 3 wide products an Fq2 product (2 a
    square)."""
    return (wide * 2 * nw * nw + squares * nw * (nw + 1) + reductions * (2 * nw * nw + nw)) / muls_per_product(nw)


# What the G1 RCB ops need a lane (lazy_products): a mixed add is 11
# products and 8 results, 3 of them sums of two products (the closing x3,
# y3, z3); an add 12 products and 9 results (3 sums); a double 6 products
# and 2 squares and 7 results (y3 = t2 z3 + t0 y3 a sum). By CIOS
# products (muls_per_product, muls_per_square) they were 11, 12 and 6 + 2
# squares: 2,904, 3,168 and 2,000 multiplies against 2,496, 2,760 and 1,864.
# The Jacobian ops are counted at the least work their function needs on
# lazy sums, whatever formula the kernel runs. dbl-2009-l: 4 products, 3
# squares, 6 results, 1,544 multiplies: a = x^2 (e = 3 a by two additions),
# b = y^2, d = 2((x + b)^2 - a - c) as 4 x b, x3 = e^2 - 2 d, y3 = e (d - x3)
# - 8 c one sum with -8 c = (2 b) 4 (p - b), z3 = 2 y z; the formula as
# written (2, 5, 7) is 1,568, csrc/curve.cu::jac_dbl's (e = x (3 x) a
# product: 5, 2, 6) 1,600. add-2007-bl on a lane with both operands finite
# and Q != P: 11 products, 5 squares, 15 results (y3 = r2 (v - x3) - 2 s1 j
# one sum), 3,808; the kernel's (::add_diffs, ::madd_finish: z3 = 2 z1 z2 h,
# 12, 4, 15) 3,864. madd-2007-bl likewise: 7, 4, 10 with z3 = (z1 + h)^2 -
# z1z1 - hh, 2,544; the kernel's (::madd_diffs, ::madd_finish: z3 = 2 z1 h,
# 8, 3, 10) 2,600. On the kernels' column products a square is a full
# product, so their choices cost no multiply there and save additions. A
# doubling lane (Q = P) needs h and rr (madd 3, 1, 4; add 6, 2, 8: no z1 z2)
# and the doubling; a lane with an infinite operand, and a doubling of the
# identity, none (step_work, dbl_work).
_DBL = lazy_products(4, 6, squares=3)
LAZY_G1_PRODUCTS = {"pmadd_rcb": lazy_products(11, 8), "padd_rcb": lazy_products(12, 9),
                    "pdbl_rcb": lazy_products(6, 7, squares=2), "madd": lazy_products(7, 10, squares=4),
                    "madd_dbl": lazy_products(3, 4, squares=1) + _DBL, "dbl": _DBL,
                    "add": lazy_products(11, 15, squares=5), "add_dbl": lazy_products(6, 8, squares=2) + _DBL}


def g1_work(op: str, lanes: float) -> float:
    """The products of `lanes` lanes of the G1 op `op` (G1_OPS, or
    LAZY_G1_PRODUCTS for madd, its doubling lanes and the RCB ops)."""
    if op in LAZY_G1_PRODUCTS:
        return LAZY_G1_PRODUCTS[op] * lanes
    products, squares = G1_OPS[op]
    return g1_products(products * lanes, squares * lanes)


# What the G2 RCB ops need a lane (lazy_products): a mixed add is 13 Fq2
# products (39 wide) and 10 results, 3 of them sums of two products (20
# reductions); an add 14 products (42) and 11 results (22); a double 7
# products and 2 squares (25) and 8 results, 1 a sum (16).
RCB_G2_PRODUCTS = {"pmadd_rcb_g2": lazy_products(39, 20), "padd_rcb_g2": lazy_products(42, 22),
                   "pdbl_rcb_g2": lazy_products(25, 16)}

# One Montgomery product's latency on one H100 thread, us: the fit of the
# one-thread horner_fold body of 1b89d60 from benches/torch_aff_ab.py's
# Horner times (two products ~0.56 us, PERF.md). A chain's dependent product levels times it is a latency
# diagnostic beside its operations bound, not a bound (chain_levels).
PRODUCT_LATENCY_US = 0.28


def require(cond: bool, msg: str) -> None:
    """Fail the run (assert statements vanish under python -O)."""
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The `*_kernel` identifier (and template arguments) in a mangled name:
    the identifier is preceded by its length in decimal."""
    end = mangled.index("_kernel") + len("_kernel")
    for start in range(end - len("_kernel"), 0, -1):
        if any(mangled[start - k : start].isdigit() and int(mangled[start - k : start]) == end - start
               for k in (1, 2, 3) if start >= k):
            m = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(1))) if m else ""
            return mangled[start:end] + (f"<{args}>" if m else "")
    return mangled


def ptxas_summary(report: str) -> list:
    """(kernel, registers, spill-store bytes) from nvcc's -Xptxas -v output."""
    out, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"entry function '(\w+_kernel\w*)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs after one warm run (ms)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one fn() in ms with the host's launch cost out of the
    way: `calls` calls of fn captured in one CUDA graph, the graph replayed
    reps times between CUDA events (cuda_ms). A wrapper issues a short
    kernel slower than the card runs it, and cuda_ms then reads the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


def device_trace(fn, reps: int = 1) -> dict:
    """{kernel: (launches, device time in us summed)} over torch.profiler's
    trace of reps calls of fn (warmed by the caller)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0))
            for e in prof.key_averages()}


def kernel_device_times(fn, launches: dict, reps: int = 1) -> dict:
    """{kernel: (trace count, device time in us a launch)} of the CUDA
    kernels named in `launches` ({part of a kernel's name: its launches a
    call of fn}) over reps calls of fn after a warm one (device_trace); the
    time is None (not measured) unless the trace holds every launch,
    launches x reps of them."""
    fn()
    trace = device_trace(fn, reps)
    out = {}
    for kernel, n in launches.items():
        count = sum(c for k, (c, _) in trace.items() if kernel in k)
        total = sum(us for k, (_, us) in trace.items() if kernel in k)
        out[kernel] = (count, total / count if count == n * reps and total else None)
    return out


def device_busy(fn, names: tuple = ()) -> tuple:
    """(the device time of one fn(), warmed by the caller, {name: the device
    time of its kernels whose names hold `name`}) in ms (device_trace): the
    card's busy time, where a host-bound call's wall time is mostly idle.
    None where the trace holds no device time."""
    trace = device_trace(fn)
    total = sum(us for _, us in trace.values()) / 1e3
    return (total or None), {n: sum(us for k, (_, us) in trace.items() if n in k) / 1e3 for n in names}


def timed_once(fn) -> tuple:
    """(fn(), its device time in ms), one run: for a plain version that
    takes seconds at the main path's width."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(got, ref) -> int:
    got = got if isinstance(got, (tuple, list)) else [got]
    ref = ref if isinstance(ref, (tuple, list)) else [ref]
    return max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))


def rand_limbs(shape, gen: torch.Generator, spec=None) -> torch.Tensor:
    """(..., nlimbs) random canonical Montgomery limbs below the top limb of
    the field `spec` times 2^(16(nlimbs-1)): by default 16 limbs below 0x3064
    * 2^240 (< p for both BN254 fields, whose top limb is 0x3064)."""
    nl, top = (16, 0x3064) if spec is None else (spec.nlimbs, spec.modulus >> (16 * (spec.nlimbs - 1)))
    shape = (shape, nl) if isinstance(shape, int) else tuple(shape) + (nl,)
    limbs = torch.randint(0, 1 << 16, shape, generator=gen, device=DEVICE, dtype=torch.int32)
    limbs[..., nl - 1] %= top
    return limbs


def inv_edge_values(spec) -> list:
    """Field values whose lanes probe the inversion kernel's edges: 0, 1 (the
    Montgomery one), 2, p-1, p-2, (p-1)/2, (p+1)/2, 2^k for every k below the
    bit length, and long runs of one and zero bits (2^k - 1, p - 2^k, every
    seventh k); then the same patterns as raw Montgomery words (the values
    x R^-1, whose lanes hold x: a raw 1, a raw p-1, ...)."""
    p = spec.modulus
    bits = p.bit_length()
    base = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2] + [1 << k for k in range(bits)]
    base += [(1 << k) - 1 for k in range(2, bits, 7)] + [p - (1 << k) for k in range(1, bits, 7)]
    rinv = pow(spec.mont_r, -1, p)
    return list(dict.fromkeys(v % p for v in base + [x * rinv for x in base]))


def inv_lanes(tf, spec, m: int, gen: torch.Generator) -> torch.Tensor:
    """m random lanes of `spec` with inv_edge_values' lanes first (0 first)."""
    a = rand_limbs(m, gen, spec)
    edge = inv_edge_values(spec)[:m]
    a[: len(edge)] = tf.tensor(spec.pack(edge), DEVICE)
    return a


def bls_add(p, q, P):
    """Affine P + Q on BLS12-381 G1 over Python ints (None = infinity)."""
    if p is None or q is None:
        return q if p is None else p
    if p[0] == q[0]:
        if (p[1] + q[1]) % P == 0:
            return None
        lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, P) % P
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, P) % P
    x = (lam * lam - p[0] - q[0]) % P
    return (x, (lam * (p[0] - x) - p[1]) % P)


def bls_mul(p, k: int, P):
    acc = None
    while k:
        if k & 1:
            acc = bls_add(acc, p, P)
        p, k = bls_add(p, p, P), k >> 1
    return acc


def chain_points(n: int, k0: int, delta: int, h) -> list:
    """P_i = (k0 + i*delta) * G for i < n (n a multiple of 1024), as
    P_{1024a+b} = A_a + B_b with A_a = 1024*a*delta*G and B_b =
    (k0 + b*delta)*G, each block of 1024 sums sharing one host inversion."""
    P = h.P
    g = h.ch.g1_gen()
    step, big = h.ch.pt_mul(g, delta), h.ch.pt_mul(g, 1024 * delta % h.R)
    B = [h.ch.pt_mul(g, k0)]
    for _ in range(1023):
        B.append(h.ch.pt_add(B[-1], step))
    out = list(B)
    A = big
    for _ in range(1, n // 1024):
        xa, ya = A
        dens = [(xb - xa) % P for xb, _ in B]
        pre, acc = [], 1
        for d in dens:
            require(d != 0, "chain_points: a block sum met its own x (k0, delta collide)")
            acc = acc * d % P
            pre.append(acc)
        inv = pow(acc, P - 2, P)
        invs = [0] * 1024
        for j in range(1023, -1, -1):
            invs[j] = inv * pre[j - 1] % P if j else inv
            inv = inv * dens[j] % P
        for (xb, yb), iv in zip(B, invs):
            lam = (yb - ya) * iv % P
            x3 = (lam * lam - xa - xb) % P
            out.append((x3, (lam * (xa - x3) - ya) % P))
        A = h.ch.pt_add(A, big)
    return out


# The divstep inversion (csrc/field.cu::fermat_inv_kernel): signed 30-bit
# limbs and batches of 30 divsteps per word count, as field.cu's InvShape
INV_SHAPES = {8: (9, 25), 12: (13, 37)}
# the kernel-table rows of the inversion kernel and the fields each counts
INV_ROWS = {"fermat_inv": ("fq", "fr"), "fermat_inv fq_bls381": ("fq_bls381",)}


# the kernel-table rows of the affine pair, at the widths the main paths
# launched it at (aff_rows), and the TPU kernels they replace
AFF_ROWS = {"aff_add_fused": "hekaton_tpu/curves/pallas_curve.py:760",
            "aff_add_mixed_packed": "hekaton_tpu/curves/pallas_curve.py:712"}


def inv_divsteps(nw: int = 8) -> int:
    """Divsteps of one inversion at nw words: 750 at 8, 1,110 at 12."""
    return 30 * INV_SHAPES[nw][1]


def inv_muls(nw: int = 8) -> int:
    """32-bit multiplies of one divstep inversion: per batch, the matrix on
    f, g, d, e and the multiples of p, 10 L 32x32->64 multiply-adds at 2
    each (low and high halves), and the 2 low products of p^-1 that pick
    those multiples; the divsteps themselves multiply nothing."""
    L, batches = INV_SHAPES[nw]
    return batches * (20 * L + 2)


def inv_chain(nw: int = 8) -> int:
    """The dependent chain of one inversion, in operations: ~6 a divstep
    (g's parity, the swap test, the selects, g's add, the shift) and ~3 a
    limb of a batch's carry chain (a 64-bit add and shift) plus ~6 for its
    multiple of p; the time of a launch of <= ~16K lanes is this chain's
    latency, not its work."""
    L, batches = INV_SHAPES[nw]
    return batches * (30 * 6 + 3 * L + 6)


class Bound:
    """The least time the card takes for a kernel's work (bytes moved, or
    Montgomery products at muls_per_product 32-bit multiplies each; a
    fraction where lazy_products or g1_products counts them)."""

    def __init__(self):
        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        self.clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6

    def __call__(self, nbytes: float, products: float, nw: int = 8) -> tuple:
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = products * muls_per_product(nw) / (INT_MULS_PER_SM_CLOCK * self.sms * self.clock_hz)
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    @staticmethod
    def batch_inv(m: int, nw: int = 8) -> float:
        """Products the inversion of m lanes needs at least: Montgomery's
        trick, 3 a lane, and one inversion (inv_muls). The divstep kernel
        computes the same function by more work, each lane on its own."""
        return 3 * max(m - 1, 0) + inv_muls(nw) / muls_per_product(nw)

    def inv(self, m: int, nw: int = 8) -> tuple:
        """The work of fermat_inv on m lanes: each lane's 2 nw int32 limbs
        read once and written once, and batch_inv's products."""
        return 16 * nw * m, self.batch_inv(m, nw), nw


def proj_edge_lanes(tf, proj, gx, gy, gen):
    """Phase 2's RCB inputs on G1 ((N, 16) affine points gx, gy) or G2 ((N,
    2, 16)): n = N_LANES lanes of P (projective, random z) and Q (affine and
    projective, another random z), Q_i = the affine point of row i+n+1. Lanes
    0-63 double (Q = P), 64-127 are inverse pairs, 128-191 have the identity
    accumulator (0 : z : 0), 192-255 the (0,0) sentinel operand (identity in
    projective), 256-319 both."""
    n = N_LANES
    coord = tuple(gx.shape[1:-1])  # () on G1, (2,) on G2
    f = tf.Fq2Plain if coord else tf.FqPlain
    ax, ay = gx[:n].clone(), gy[:n].clone()
    bx, by = gx[n + 1 : 2 * n + 1].clone(), gy[n + 1 : 2 * n + 1].clone()
    bx[:64], by[:64] = ax[:64], ay[:64]
    bx[64:128], by[64:128] = ax[64:128], tf.neg(tf.FQ, ay[64:128])
    z1, z2 = rand_limbs((n, *coord), gen), rand_limbs((n, *coord), gen)
    p = proj.Proj(f.mul(ax, z1), f.mul(ay, z1), z1.clone())
    q = proj.Proj(f.mul(bx, z2), f.mul(by, z2), z2.clone())
    for lo, hi in ((128, 192), (256, 320)):
        p.x[lo:hi], p.z[lo:hi] = 0, 0
    bx[192:320], by[192:320] = 0, 0
    q.x[192:320], q.z[192:320] = 0, 0
    q.y[192:320] = f.one((128,), DEVICE)
    return p, q, (bx, by)


def g1_edge_lanes(tf, ax, ay, gen, n: int | None = None, edges: bool = True):
    """Phase 2's madd inputs: n (N_LANES by default) Jacobian accumulators
    (x z^2, y z^3, z) with random z and affine operands, P_i + P_(n+i), with
    tests/test_pallas.py:33's edges: lanes 0-63 P = inf (1, 1, 0), 64-127 Q
    = (0,0), 128-191 Q = P (doubling), 192-255 Q = -P, 256-319 P = inf and Q =
    (0,0); with edges=False none (a fixed-base call's later windows)."""
    n = N_LANES if n is None else n
    f = tf.FqPlain
    x, y = ax[:n].clone(), ay[:n].clone()
    qx, qy = ax[n : 2 * n].clone(), ay[n : 2 * n].clone()
    if edges:
        qx[128:256], qy[128:192], qy[192:256] = x[128:256], y[128:192], tf.neg(tf.FQ, y[192:256])
        qx[64:128], qy[64:128], qx[256:320], qy[256:320] = 0, 0, 0, 0
    z = rand_limbs(n, gen)
    z2 = f.sqr(z)
    p = [f.mul(x, z2), f.mul(y, f.mul(z2, z)), z]
    if edges:
        one = f.one((64,), DEVICE)
        for lo in (0, 256):
            p[0][lo : lo + 64], p[1][lo : lo + 64], p[2][lo : lo + 64] = one, one, 0
    return p, (qx, qy)


def madd_work(tf, x, y, z, qx, qy) -> tuple:
    """The bound's work (Bound's arguments) of madd on these lanes: 8 64-byte
    rows a lane, and LAZY_G1_PRODUCTS' products of each lane with both
    operands finite, a doubling lane (Q = P) the escape's instead."""
    f = tf.FqPlain
    finite = ~(z == 0).all(-1) & ~((qx == 0).all(-1) & (qy == 0).all(-1))
    z2 = f.sqr(z)
    dbl = finite & (f.mul(qx, z2) == x).all(-1) & (f.mul(f.mul(qy, z), z2) == y).all(-1)
    return 8 * 64 * z.shape[0], g1_work("madd", int((finite & ~dbl).sum())) + g1_work("madd_dbl", int(dbl.sum()))


def add_work(tf, x1, y1, z1, x2, y2, z2) -> tuple:
    """The bound's work (Bound's arguments) of add on these lanes: 9 64-byte
    rows a lane, and LAZY_G1_PRODUCTS' products of each lane with both
    operands finite, a doubling lane (Q = P) the escape's instead."""
    f = tf.FqPlain
    finite = ~(z1 == 0).all(-1) & ~(z2 == 0).all(-1)
    z1z1, z2z2 = f.sqr(z1), f.sqr(z2)
    same = (finite & (f.mul(x1, z2z2) == f.mul(x2, z1z1)).all(-1)
            & (f.mul(f.mul(y1, z2), z2z2) == f.mul(f.mul(y2, z1), z1z1)).all(-1))
    return 9 * 64 * z1.shape[0], g1_work("add", int((finite & ~same).sum())) + g1_work("add_dbl", int(same.sum()))


def dbl_work(x, y, z) -> tuple:
    """The bound's work (Bound's arguments) of dbl on these lanes: 6 64-byte
    rows a lane, and LAZY_G1_PRODUCTS' products of each finite lane (the
    double of the identity needs none)."""
    return 6 * 64 * z.shape[0], g1_work("dbl", int((z != 0).any(-1).sum()))


def step_work(acc, q, mixed: bool) -> float:
    """The products of one chain step acc + q (host affine points, None the
    identity) as the Jacobian kernels take them: none with an infinite
    operand, the doubling escape's where acc = q."""
    if acc is None or q is None:
        return 0.0
    op = "madd" if mixed else "add"
    return g1_work(op + "_dbl" if acc == q else op, 1)


def jac_ladder_work(h, pts: list, scalars: list, nbits: int) -> tuple:
    """jac_ladder's work on these lanes (host points, their scalars): 2 rows
    and the scalar's in, 3 rows out a lane; a doubling a step once the
    accumulator has left the identity (the kernel runs one on every step)
    and each set bit's mixed add, from a walk of each lane on the host."""
    ops = 0.0
    for p, s in zip(pts, scalars):
        acc = None
        for j in range(nbits - 1, -1, -1):
            ops += 0.0 if acc is None else g1_work("dbl", 1)
            acc = h.ch.pt_dbl(acc)
            if s >> j & 1:
                ops += step_work(acc, p, mixed=True)
                acc = h.ch.pt_add(acc, p)
    return 6 * 64 * len(pts), ops


def jac_sum_work(h, cols: list) -> tuple:
    """jac_sum's work on a stack of K rows of lanes (host points): 3 rows in
    an element, 3 out a lane; the adds of each lane's walk."""
    ops = sum(step_work(acc, q, mixed=False)
              for i in range(len(cols[0]))
              for acc, q in zip(_prefix_sums(h, [col[i] for col in cols]), [col[i] for col in cols]))
    return 3 * 64 * (len(cols) + 1) * len(cols[0]), ops


def _prefix_sums(h, pts: list) -> list:
    """The accumulator before each add of an in-order sum from the identity."""
    out, acc = [], None
    for q in pts:
        out.append(acc)
        acc = h.ch.pt_add(acc, q)
    return out


def jac_horner_work(h, ws: list, c: int) -> tuple:
    """jac_horner's work on W window sums (host points): 3 rows in a window,
    3 out; the walk's doublings of an accumulator other than the identity
    and its adds."""
    ops, acc = 0.0, ws[-1]
    for q in ws[-2::-1]:
        ops += 0.0 if acc is None else c * g1_work("dbl", 1)
        for _ in range(c):
            acc = h.ch.pt_dbl(acc)
        ops += step_work(acc, q, mixed=False)
        acc = h.ch.pt_add(acc, q)
    return 3 * 64 * (len(ws) + 1), ops


def jac_of(tf, G1, pts: list, gen) -> tuple:
    """Host affine points (None the identity) -> Montgomery Jacobian limbs on
    the card, (x z^2, y z^3, z) under random z, (1, 1, 0) for None."""
    f = tf.FqPlain
    ax, ay = (torch.from_numpy(a).to(DEVICE) for a in G1.pack_affine(pts))
    z = rand_limbs(len(pts), gen)
    z2 = f.sqr(z)
    x, y = f.mul(ax, z2), f.mul(ay, f.mul(z2, z))
    inf = torch.tensor([p is None for p in pts], device=DEVICE)
    one = f.one((len(pts),), DEVICE)
    return f.select(inf, one, x), f.select(inf, one, y), f.select(inf, torch.zeros_like(z), z)


def inverse_pair_inf(tf, cc, G1, pt, gen) -> tuple:
    """What `add` leaves on the inverse pair pt + (-pt) (add_plain): the
    generic x3 and y3 under z3 = 0, a Jacobian infinity with X, Y != (1, 1)."""
    x, y, z = jac_of(tf, G1, [pt], gen)
    out = cc.add_plain(x, y, z, x, tf.neg(tf.FQ, y), z)
    one = tf.FqPlain.one((1,), DEVICE)
    require(not bool(out.z.any()) and bool(((out.x != one) | (out.y != one)).any()),
            "add's inverse pair does not leave Z = 0 under X, Y != (1, 1)")
    return tuple(t[0] for t in out)


def chain_inputs(h, tf, cc, G1, name: str, shape: tuple, host_pts: list, scalars: list, gen) -> tuple:
    """(args, work, label, want) of the chain kernel `name` at `shape` with
    edge inputs, `want` the host's affine results of its lanes. jac_ladder at
    (lanes, nbits): the msm_g1 set's first points and scalars (0, 1, r-1, an
    infinity and a repeated point), lanes 3 and 4 taking r and r+2 (the last
    step's mixed add an inverse pair and a doubling); jac_sum at (K, lanes):
    distinct points, lane 0 starting at the identity, lane 1 adding P to P,
    lane 2 P then -P, lane 3 a Jacobian infinity with X, Y != (1, 1) (an
    inverse pair's `add` output, inverse_pair_inf) at row 1 (with one lane:
    P added to P at row 2, that infinity at row 3 and the identity reached
    at row 4); jac_horner at (W, c): window sums where the first add
    doubles, the second gives the identity, window 1 is that infinity and
    window 0 the identity (1, 1, 0)."""
    R = h.R
    if name == "jac_ladder":
        n, nbits = shape
        pts, sc = list(host_pts[:n]), list(scalars[:n])
        for i, v in ((3, R), (4, R + 2)):
            if i < n:
                sc[i] = v
        ax, ay = (torch.from_numpy(a).to(DEVICE) for a in G1.pack_affine(pts))
        limbs = torch.from_numpy(np.array([[(v >> (16 * k)) & 0xFFFF for k in range(16)] for v in sc],
                                          dtype=np.int32)).to(DEVICE)
        want = [None if p is None else h.ch.pt_mul(p, v % (1 << nbits)) for p, v in zip(pts, sc)]
        return (ax, ay, limbs, nbits), jac_ladder_work(h, pts, sc, nbits), f"{n} lanes, nbits={nbits}", want
    if name == "jac_sum":
        K, n = shape
        cols = [list(host_pts[1000 + j * n : 1000 + (j + 1) * n]) for j in range(K)]
        cols[0][0] = None
        edge = (1, 3) if n > 3 and K > 1 else (3, 0) if n == 1 and K > 4 else None
        if edge is not None:
            inf = inverse_pair_inf(tf, cc, G1, cols[edge[0]][edge[1]], gen)
            cols[edge[0]][edge[1]] = None
        if n > 2 and K > 1:
            cols[1][1] = cols[0][1]
            cols[1][2] = h.ch.pt_neg(cols[0][2])
        elif K > 4:
            cols[2][0] = cols[1][0]
            cols[4][0] = h.ch.pt_neg(_prefix_sums(h, [col[0] for col in cols[:5]])[4])
        stack = [jac_of(tf, G1, col, gen) for col in cols]
        args = tuple(torch.stack([st[k] for st in stack]) for k in range(3))
        if edge is not None:
            for a, v in zip(args, inf):
                a[edge] = v
        want = [_prefix_sums(h, [col[i] for col in cols] + [None])[-1] for i in range(n)]
        return args, jac_sum_work(h, cols), f"K={K}, {n} lanes", want
    W, c = shape
    ws = list(host_pts[2000 : 2000 + W])
    if W >= 5:
        ws[W - 2] = h.ch.pt_mul(ws[W - 1], 1 << c)
        ws[W - 3] = h.ch.pt_neg(h.ch.pt_mul(ws[W - 1], 1 << (2 * c + 1)))
        inf = inverse_pair_inf(tf, cc, G1, ws[1], gen)
        ws[0] = ws[1] = None
    x, y, z = jac_of(tf, G1, ws, gen)
    if W >= 5:
        for a, v in zip((x, y, z), inf):
            a[1] = v
    want = None
    for w, pt in enumerate(ws):
        want = h.ch.pt_add(want, None if pt is None else h.ch.pt_mul(pt, 1 << (c * w)))
    return (x, y, z, c), jac_horner_work(h, ws, c), f"W={W}, c={c}", [want]


def chain_rows(h, tf, cc, G1, bound, widths: dict, host_pts: list, scalars: list, gen) -> list:
    """The chain kernels' rows at the shapes the main paths launched them at
    (`widths`: {name: {shape: launches}}): each held limb for limb against
    its plain version and as points against the host's walk at every shape
    on chain_inputs' edge inputs, the row at the shape launched most often,
    where both are timed; every shape's device time logged (graph_ms)."""
    rows = []
    for name in CHAIN_KERNELS:
        shapes = widths.get(name, {})
        require(bool(shapes), f"{name}: no main path launched it")
        ranked = sorted(shapes, key=lambda k: (-shapes[k], -k[0]))
        for shape in ranked:
            args, work, label, want = chain_inputs(h, tf, cc, G1, name, shape, host_pts, scalars, gen)
            fn, plain = getattr(cc, name), getattr(cc, name + "_plain")
            ref, plain_ms = timed_once(lambda: plain(*args))
            got = fn(*args)
            err = max_abs_err(got, ref)
            got = type(got)(*(t.reshape(-1, 16) for t in got))
            require(G1.unpack_jacobian(got) == want, f"{name} {label}: other points than the host's walk")
            ms = cuda_ms(lambda: fn(*args), 5)
            lanes = []
            if name == "jac_ladder":  # its lanes' scalars, 0 where the base is (0,0)
                ax, ay, limbs, _ = args
                inf = ((ax == 0).all(-1) & (ay == 0).all(-1)).tolist()
                lanes = [0 if z else sum(int(v) << (16 * i) for i, v in enumerate(row))
                         for z, row in zip(inf, limbs.tolist())]
            note = (f"{latency_note(chain_levels(name, shape, lanes))}; device time "
                    f"{graph_ms(lambda: fn(*args)):.4f} ms a launch (graph_ms)")
            if shape == ranked[0]:
                rows.append({**kernel_row(bound, name, "hekaton_tpu_torch/csrc/curve.cu",
                                          f"hekaton_tpu/curves/pallas_curve.py:{1289 if name == 'jac_sum' else 1285}",
                                          ms, plain_ms, err, work), "shape": label})
                log(f"[kernels] {name} {label}: {note}")
                continue
            require(err == 0, f"{name} {label}: kernel differs from its plain version (max abs err {err})")
            log(f"[kernels] {name} {label} (x{shapes[shape]}): bit-identical, kernel {ms:.4f} ms, plain "
                f"{plain_ms:.1f} ms, bound {bound(*work)[0]:.6f} ms ({bound(*work)[1]}); {note}")
    return rows


def proj_lanes(tf, ax, ay, gen, m: int):
    """m projective pairs P_i + P_(N-m+i) of the G1 set under random z (the
    collapse's and the suffix's adds: distinct finite points)."""
    f = tf.FqPlain
    N = ax.shape[0]
    out = []
    for lo in (0, N - m):
        z = rand_limbs(m, gen)
        out += [f.mul(ax[lo : lo + m], z), f.mul(ay[lo : lo + m], z), z]
    return tuple(out)


def g1_jacobian_pairs(tf, ax, ay, gen):
    """Phase 2's dbl and add inputs: N_LANES Jacobian P and Q, each (x z^2,
    y z^3, z) with its own random z, Q_i = P_(i+N_LANES) but for the edges:
    lanes 0-63 P = inf (1, 1, 0), 64-127 Q = inf, 128-191 Q = P under another
    z (the doubling escape), 192-255 Q = -P, 256-319 P = Q = inf."""
    n = N_LANES
    f = tf.FqPlain
    x, y = ax[:n].clone(), ay[:n].clone()
    qx, qy = ax[n : 2 * n].clone(), ay[n : 2 * n].clone()
    qx[128:256], qy[128:192], qy[192:256] = x[128:256], y[128:192], tf.neg(tf.FQ, y[192:256])

    def jac(px, py):
        z = rand_limbs(n, gen)
        z2 = f.sqr(z)
        return [f.mul(px, z2), f.mul(py, f.mul(z2, z)), z]

    p, q = jac(x, y), jac(qx, qy)
    one = f.one((64,), DEVICE)
    for pt, lanes in ((p, (0, 256)), (q, (64, 256))):
        for lo in lanes:
            pt[0][lo : lo + 64], pt[1][lo : lo + 64], pt[2][lo : lo + 64] = one, one, 0
    return p, q


def aff_edge_lanes(tf, ax, ay, m: int | None = None) -> tuple:
    """m (N_LANES by default) affine pairs (x1, y1) + (x2, y2) of the G1
    set, P_i + P_(N-m+i), with doubling lanes 0-63, inverse pairs 64-127,
    inf + Q 128-191, P + inf 192-255 and inf + inf 256-319 (as far as m
    reaches)."""
    n, m = ax.shape[0], N_LANES if m is None else m
    x1, y1 = ax[:m].clone(), ay[:m].clone()
    x2, y2 = ax[n - m:].clone(), ay[n - m:].clone()
    x2[:64], y2[:64] = x1[:64], y1[:64]  # doubling lanes
    x2[64:128], y2[64:128] = x1[64:128], tf.neg(tf.FQ, y1[64:128])  # inverse pairs
    x1[128:192], y1[128:192] = 0, 0  # inf + Q
    x2[192:256], y2[192:256] = 0, 0  # P + inf
    x1[256:320], y1[256:320], x2[256:320], y2[256:320] = 0, 0, 0, 0  # inf + inf
    return x1, y1, x2, y2


def unaligned(t):
    """A copy of t one word into its storage: not 16-byte aligned."""
    odd = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    odd.copy_(t)
    return odd


def horner_shapes() -> list:
    """(W, c) of horner_fold in a G1 msm_gpu of 2^20, 2^16, 2^15 and 2^12
    points: c from TorchBackend.msm_params, W = ceil(254 / c) signed-digit
    windows (msm.pippenger.signed_digits_for_windows)."""
    from hekaton_tpu_torch.cpgroth16.backend import TorchBackend

    return [(-(-254 // c), c) for c in (TorchBackend.msm_params(1 << lg)[0] for lg in (20, 16, 15, 12))]


def horner_windows(proj, ax, ay, W: int, ops=None):
    """W projective window sums 2 P_i (z != 1) of the first W affine points
    (G1 by default; `ops` proj.PROJ_G2 for (N, 2, 16) G2 points)."""
    ops = ops or proj.PROJ_G1
    p = ops.dbl(ops.from_affine(ax[:W].contiguous(), ay[:W].contiguous()))
    return proj.Proj(*(t.contiguous() for t in p))


def horner_edge_sets(proj, ax, ay, ops=None) -> list:
    """(label, window sums, c) of the Horner folds' edge cases: identity
    (0:1:0) windows (every third one, and all of them), every window the
    same point (with c=0 the first add is a doubling), P and -P alternating
    (with c=0 the sums cancel), and W=2; G1 by default, G2 with `ops`
    proj.PROJ_G2."""
    ops = ops or proj.PROJ_G1
    p = horner_windows(proj, ax, ay, 20, ops)
    one = ops.inf((), DEVICE).y
    sets = []
    holes = proj.Proj(*(t.clone() for t in p))
    holes.x[::3], holes.y[::3], holes.z[::3] = 0, one, 0
    sets.append(("identity windows (every third)", holes, 13))
    sets.append(("identity windows (all)", proj.Proj(torch.zeros_like(p.x), one.expand_as(p.y).contiguous(),
                                                     torch.zeros_like(p.z)), 13))
    same = proj.Proj(*(t[:1].repeat(20, *([1] * (t.dim() - 1))) for t in p))
    sets += [("all windows equal", same, 13), ("all windows equal", same, 0)]
    alt = proj.Proj(*(t.clone() for t in same))
    alt.y[1::2] = ops.f.neg(alt.y[1::2])
    sets += [("P and -P alternating", alt, 13), ("P and -P alternating", alt, 0)]
    sets.append(("W=2", proj.Proj(*(t[:2].contiguous() for t in p)), 13))
    return sets


def horner_work(W: int, c: int) -> tuple:
    """horner_fold's work: 3 (W, 16) limb rows in, 3 rows out; (W-1) c RCB
    doublings and W-1 adds."""
    return 3 * 64 * (W + 1), (W - 1) * (c * g1_work("pdbl_rcb", 1) + g1_work("padd_rcb", 1))


def horner_g2_work(W: int, c: int) -> tuple:
    """horner_fold_g2's work: 3 (W, 2, 16) limb rows in, 3 (2, 16) rows
    out; (W-1) c G2 RCB doublings and W-1 adds (RCB_G2_PRODUCTS)."""
    return 3 * 128 * (W + 1), (W - 1) * (c * RCB_G2_PRODUCTS["pdbl_rcb_g2"] + RCB_G2_PRODUCTS["padd_rcb_g2"])


def chain_levels(name: str, shape: tuple, scalars: list = ()) -> int:
    """A chain's dependent product levels: the one-warp folds and chains two
    a point op (jac_ladder's slowest lane from its top set bit, given its
    lanes' `scalars`, 0 for a (0,0) base), and the chains' Jacobian ends:
    two levels to store (X Z and Z^2, then Y Z^2) and, in jac_sum and
    jac_horner, two to load each chunk of 32 operands or all the window
    sums (X Z and Z^2, then Z^3, a thread's own products)."""
    if name in ("horner_fold", "horner_fold_g2"):
        W, c = shape
        return 2 * (W - 1) * (c + 1)
    if name == "jac_ladder":
        bits = [s % (1 << shape[1]) for s in scalars]
        return 2 * max(b.bit_length() + bin(b).count("1") for b in bits) + 2
    if name == "jac_horner":
        W, c = shape
        return 2 * (W - 1) * (c + 1) + 4
    return 2 * shape[0] + 2 * -(-shape[0] // 32) + 2  # jac_sum: K adds a lane


def latency_note(levels: int) -> str:
    return (f"latency diagnostic {levels} dependent product levels x {PRODUCT_LATENCY_US} us = "
            f"{levels * PRODUCT_LATENCY_US / 1e3:.4f} ms")


def aff_lanes(x1, y1, x2, y2) -> tuple:
    """(adds, doublings) of batched-affine add lanes: the lanes whose sum
    needs a slope (no infinity operand, no inverse pair), and those of them
    that double."""
    q_inf, p_inf = (y2 == 0).all(-1), (y1 == 0).all(-1)
    same_x = (x1 == x2).all(-1)
    dbl = same_x & (y1 == y2).all(-1)
    adds = ~(q_inf | p_inf | (same_x & ~dbl))
    return int(adds.sum()), int((adds & dbl).sum())


def aff_work(x1, y1, x2, y2, nbytes: int) -> tuple:
    """The bound's work (Bound's arguments) of the batched-affine add of
    these lanes: `nbytes`, and over its adds (aff_lanes) each sum, a
    doubling's x1^2 and Montgomery's trick with its one inversion."""
    adds, dbls = aff_lanes(x1, y1, x2, y2)
    return nbytes, g1_work("aff_sum", adds) + g1_products(0, dbls) + Bound.batch_inv(adds)


def slab_adds(slab, L: int) -> int:
    """The adds a level 1 needs on the (ncols, L*16) packed slab: n - 1 for a
    column of n points other than the (0,0) sentinel (an add with the
    sentinel needs none, and the MSM's points are distinct, so no inverse
    pair or doubling occurs)."""
    n = (slab.reshape(slab.shape[0], L, 16) != 0).any(-1).sum(-1)
    return int((n - 1).clamp(min=0).sum())


def halves_work(slab, L: int) -> tuple:
    """The bound's work of l1_aff_halves on the slab: the slab read once and
    the sums written once; each add's sum and 3 products of Montgomery's
    trick, and one inversion a round."""
    adds = slab_adds(slab, L)
    return slab.shape[0] * (L + 1) * 64, g1_work("aff_sum", adds) + 3 * adds + (L.bit_length() - 1) * Bound.batch_inv(1)


def rand_scalars(rs, n: int, r: int) -> list:
    """n random scalars below r from four 63-bit draws each."""
    words = rs.randint(0, 2**63, size=(n, 4), dtype=np.int64)
    return [(int(a) | int(b) << 63 | int(c) << 126 | int(d) << 189) % r for a, b, c, d in words]


def g2_set(h, G2, rs, n: int):
    """msm_g2's points: N_G2_DISTINCT distinct k_j * G2 by the native
    mul_batch, tiled to n rows on the card, row 5 the infinity sentinel.
    Returns (host points, k_j, x, y)."""
    kg2 = [int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(N_G2_DISTINCT)]
    g2_host = h.accel.mul_batch([h.ch.g2_gen()] * N_G2_DISTINCT, kg2)
    g2x_np, g2y_np = G2.pack_affine(g2_host)
    reps = n // N_G2_DISTINCT
    g2x = torch.from_numpy(g2x_np).to(DEVICE).repeat(reps, 1, 1)
    g2y = torch.from_numpy(g2y_np).to(DEVICE).repeat(reps, 1, 1)
    g2x[5], g2y[5] = 0, 0
    return g2_host, kg2, g2x, g2y


def g2_level1_inputs(pip, g2x, g2y, sc, c: int, L: int, steps: int = 3) -> tuple:
    """pmadd_rcb_g2's and padd_rcb_g2's inputs at the G2 MSM's own width,
    the ncols columns of the msm_g2 set's plan (msm_gpu's G2 route): the
    accumulators after `steps` level-1 steps (on the kernel) with the next
    step's affine operands (padding columns hold the (0,0) sentinel), and
    the same accumulators beside their neighbours, as the collapse's
    stride-1 adds pair them. Returns (ncols, pmadd args, padd args)."""
    from hekaton_tpu_torch.curves.proj import PROJ_G2

    rows, _, meta = pip._plan_sorted_w(g2x, g2y, sc, c, L)
    ncols = meta[4]
    nw = rows.shape[1] // L
    step = pip._mixed_step(PROJ_G2, (2, 16))
    acc = PROJ_G2.inf((ncols,), g2x.device)
    for g in range(steps):
        acc = step(acc, rows[:, g * nw : (g + 1) * nw])
    blk = rows[:, steps * nw : (steps + 1) * nw]
    ax, ay = (pip.unpack_words(w).reshape(ncols, 2, 16) for w in (blk[:, : nw // 2], blk[:, nw // 2 :]))
    nxt = tuple(torch.cat([a[1:], a[:1]]) for a in acc)
    return ncols, (*acc, ax, ay), (*acc, *nxt)


def g1_level1_inputs(pip, slab, L: int, steps: int = 3) -> tuple:
    """pmadd_rcb's inputs at route (c)'s width, the columns of the G1 MSM's
    (ncols, L*16) level-1 slab: the accumulators after `steps` level-1
    steps (route (c)'s `_mixed_step`, on the kernel) with the next step's
    affine operands (the (0,0) sentinel in columns that have no more
    points)."""
    from hekaton_tpu_torch.curves.proj import PROJ_G1

    ncols = slab.shape[0]
    step = pip._mixed_step(PROJ_G1, (16,))
    acc = PROJ_G1.inf((ncols,), slab.device)
    for g in range(steps):
        acc = step(acc, slab[:, g * 16 : (g + 1) * 16])
    blk = slab[:, steps * 16 : (steps + 1) * 16]
    return (*acc, pip.unpack_words(blk[:, :8]).contiguous(), pip.unpack_words(blk[:, 8:]).contiguous())


def mega_work(slab, L: int) -> tuple:
    """The bound's work of l1_rcb_mega on the (ncols, L*16) slab: the slab
    read once and the three (ncols, 16) limb rows written once; a mixed add
    for each add the level 1 needs (slab_adds: a sentinel row, and a
    column's first point, need none)."""
    return slab.shape[0] * (L * 64 + 192), g1_work("pmadd_rcb", slab_adds(slab, L))


def root_width_sweep(tf, cf, calls: dict, gen, reps: int = 5) -> dict:
    """Device ms of tf._batch_inv at every root width of ROOT_WIDTHS on
    random lanes at each (spec, lanes) key of `calls`, the widths in turns
    (forward, then backward; the least of the two means of `reps`), every
    width's result held bit for bit against no tree: fermat_inv on every
    lane, the kernel inv_check holds against mont_inv at the main paths'
    widths. A width at or above the lanes is no tree and is not timed
    again. Returns {(spec name, lanes): {width: ms}}."""
    out = {}
    for spec, m in calls:
        a = rand_limbs(m, gen, spec)
        a[:, 0] |= 1  # nonzero lanes
        direct = cf.fermat_inv(spec, a)
        ms = {}
        for stop in ROOT_WIDTHS + ROOT_WIDTHS[::-1]:
            if stop is not None and stop >= m:
                continue
            if stop is None:
                run = lambda: cf.fermat_inv(spec, a)  # noqa: E731
            else:
                run = lambda stop=stop: tf._batch_inv(spec, a, cf.mont_mul, cf.fermat_inv, stop)  # noqa: E731
                if stop not in ms:
                    require(max_abs_err(run(), direct) == 0, f"batch_inv {spec.name} {m} lanes differs at width {stop}")
            ms.setdefault(stop, []).append(cuda_ms(run, reps))
        out[(spec.name, m)] = {stop: min(ms[None if stop is not None and stop >= m else stop])
                               for stop in ROOT_WIDTHS}
    return out


def inv_rows(tf, cf, bound, inv_calls: dict, totals: dict, gen) -> list:
    """The kernel-table rows of INV_ROWS at the main paths' widths: of each
    row's fields, every width the main paths launched fermat_inv at
    (`inv_calls`: {caller: {path: {(spec, lanes): calls}}}) is logged with
    its launches; at the widest, at the one with the most lanes launched in
    all, and at the one launched most often (the row's shape), inv_lanes
    are held bit for bit against mont_inv and timed."""
    rows = []
    for name, fields in INV_ROWS.items():
        widths = {}
        for calls in inv_calls.values():
            for path_calls in calls.values():
                for (spec, m), n in path_calls.items():
                    if spec.name in fields:
                        widths[(spec, m)] = widths.get((spec, m), 0) + n
        require(sum(widths.values()) == totals[name], f"{name}: {totals[name]} launches, {widths} recorded")
        require(bool(widths), f"{name}: no main path launched it")
        ranked = sorted(widths, key=lambda k: (-widths[k], -k[1]))
        log(f"[kernels] {name} launches by width on the main paths ({len(widths)} widths, "
            f"{width_lanes(name, widths)}): " + width_list(name, widths))
        most = ranked[0]
        for spec, m in dict.fromkeys([max(widths, key=lambda k: k[1]),
                                      max(widths, key=lambda k: (widths[k] * k[1], k[1]))]):
            if (spec, m) == most:
                continue
            require(inv_check(tf, cf, bound, spec, inv_lanes(tf, spec, m, gen))[2] == 0,
                    f"fermat_inv {spec.name} {m} lanes differs from mont_inv")
        spec, m = most
        ms, plain_ms, err, work = inv_check(tf, cf, bound, spec, inv_lanes(tf, spec, m, gen), time_plain=True)
        row = kernel_row(bound, name, "hekaton_tpu_torch/csrc/field.cu", "hekaton_tpu/fields/pallas_field.py:238",
                         ms, plain_ms, err, work, field=", ".join(fields))
        rows.append({**row, "shape": f"{spec.name} {m} lanes"})
    return rows


def horner_rows(tf, cc, proj, bound, widths: dict, ax, ay) -> list:
    """horner_fold's row at the (W, c) the main paths launched it at
    (`widths`: {(W, c): launches}): held limb for limb against
    horner_fold_plain at every one of them and at horner_shapes' (each with
    an empty window), the row at the one launched most often, where both are
    timed; then on horner_edge_sets, at the kernel's widest W
    (cc.horner_max_w(), c=0), and one window past it, which it refuses."""
    one = tf.consts(tf.FQ, DEVICE)["one"]
    ranked = sorted(widths, key=lambda k: (-widths[k], -k[0]))
    rows = []
    for W, hc in dict.fromkeys(ranked + horner_shapes()):
        p = horner_windows(proj, ax, ay, W)
        p.x[3], p.y[3], p.z[3] = 0, one, 0  # an empty window
        ref, plain_ms = timed_once(lambda: cc.horner_fold_plain(p.x, p.y, p.z, hc))
        err = max_abs_err(cc.horner_fold(p.x, p.y, p.z, hc), ref)
        ms = cuda_ms(lambda: cc.horner_fold(p.x, p.y, p.z, hc), 10)
        if (W, hc) == ranked[0]:
            log(f"[kernels] horner_fold W={W}, c={hc}: {latency_note(chain_levels('horner_fold', (W, hc)))}")
            rows.append({**kernel_row(bound, "horner_fold", "hekaton_tpu_torch/csrc/curve.cu",
                                      "hekaton_tpu/curves/pallas_curve.py:625", ms, plain_ms, err, horner_work(W, hc)),
                         "shape": f"W={W}, c={hc}"})
            continue
        require(err == 0, f"horner_fold W={W}, c={hc}: kernel differs from its plain version (max abs err {err})")
        log(f"[kernels] horner_fold W={W}, c={hc} (x{widths.get((W, hc), 0)}): bit-identical, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.1f} ms, bound {bound(*horner_work(W, hc))[0]:.6f} ms")
    for label, p, hc in horner_edge_sets(proj, ax, ay):
        err = max_abs_err(cc.horner_fold(p.x, p.y, p.z, hc), cc.horner_fold_plain(p.x, p.y, p.z, hc))
        require(err == 0, f"horner_fold on {label}, c={hc}: kernel differs from its plain version (max abs err {err})")
        log(f"[kernels] horner_fold on {label} (W={p.x.shape[0]}, c={hc}): bit-identical")
    top = cc.horner_max_w()
    p = horner_windows(proj, ax, ay, top + 1)
    widest = proj.Proj(*(t[:top] for t in p))
    err = max_abs_err(cc.horner_fold(*widest, 0), cc.horner_fold_plain(*widest, 0))
    require(err == 0, f"horner_fold W={top}, c=0: kernel differs from its plain version (max abs err {err})")
    try:
        cc.horner_fold(*p, 0)
        refused = False
    except ValueError:
        refused = True
    require(refused, f"horner_fold took {top + 1} windows, past its limit of {top}")
    log(f"[kernels] horner_fold W={top} (its widest), c=0: bit-identical; W={top + 1} refused")
    return rows


def horner_g2_rows(cc, proj, bound, widths: dict, g2x, g2y) -> list:
    """horner_fold_g2's row at the (W, c) the main paths launched it at
    (`widths`: {(W, c): launches}): held limb for limb against
    horner_fold_g2_plain at every one of them (each with an empty window),
    the row at the one launched most often, where both are timed, with the
    loop of one-lane pdbl_rcb_g2 / padd_rcb_g2 launches it replaces timed
    beside it; then on horner_edge_sets' G2 window sums, at the kernel's
    widest W (HORNER_G2_MAX_W, c=0), and one window past it, which it
    refuses. Apart from the row's timed run, the plain version runs on CPU
    copies of the inputs: on the card its one-lane Fq2 ops take 12-30 s a
    fold, on the host's CPU a few."""
    ops = proj.PROJ_G2
    one = ops.inf((), DEVICE).y
    ranked = sorted(widths, key=lambda k: (-widths[k], -k[0]))
    require(bool(ranked), "horner_fold_g2: no main path launched it")
    rows = []

    def plain_err(p, hc):  # the kernel against the plain version on CPU copies
        got = cc.horner_fold_g2(*p, hc)
        return max_abs_err(tuple(t.cpu() for t in got), cc.horner_fold_g2_plain(*(t.cpu() for t in p), hc))
    for W, hc in ranked:
        p = horner_windows(proj, g2x, g2y, W, ops)
        p.x[3 % W], p.y[3 % W], p.z[3 % W] = 0, one, 0  # an empty window
        ms = cuda_ms(lambda: cc.horner_fold_g2(p.x, p.y, p.z, hc), 10)
        note = latency_note(chain_levels("horner_fold_g2", (W, hc)))
        if (W, hc) == ranked[0]:
            ref, plain_ms = timed_once(lambda: cc.horner_fold_g2_plain(p.x, p.y, p.z, hc))
            err = max_abs_err(cc.horner_fold_g2(p.x, p.y, p.z, hc), ref)
            launches = (W - 1) * (hc + 1)
            require(max_abs_err(cc.fold_windows(ops, *p, hc), ref) == 0,
                    "horner_fold_g2: the loop of one-lane launches differs from the plain version")
            loop_ms = cuda_ms(lambda: cc.fold_windows(ops, *p, hc), 3)
            log(f"[kernels] horner_fold_g2 W={W}, c={hc}: one launch {ms:.4f} ms against the {launches} one-lane "
                f"pdbl_rcb_g2 / padd_rcb_g2 launches it replaces {loop_ms:.3f} ms (CUDA events, host-issued); {note}")
            rows.append({**kernel_row(bound, "horner_fold_g2", "hekaton_tpu_torch/csrc/curve_g2.cu",
                                      "hekaton_tpu/msm/pippenger.py:1145", ms, plain_ms, err, horner_g2_work(W, hc)),
                         "shape": f"W={W}, c={hc}"})
            continue
        err = plain_err(p, hc)
        require(err == 0, f"horner_fold_g2 W={W}, c={hc}: kernel differs from its plain version (max abs err {err})")
        log(f"[kernels] horner_fold_g2 W={W}, c={hc} (x{widths[(W, hc)]}): bit-identical, kernel {ms:.4f} ms, "
            f"bound {bound(*horner_g2_work(W, hc))[0]:.6f} ms; {note}")
    for label, p, hc in horner_edge_sets(proj, g2x, g2y, ops):
        err = plain_err(p, hc)
        require(err == 0, f"horner_fold_g2 on {label}, c={hc}: kernel differs from its plain version (max abs err {err})")
        log(f"[kernels] horner_fold_g2 on {label} (W={p.x.shape[0]}, c={hc}): bit-identical")
    from hekaton_tpu_torch import cuda_lib

    top = cc.HORNER_G2_MAX_W
    lib_top = cuda_lib.lib().hk_horner_g2_max_w()
    require(lib_top == top, f"horner_fold_g2: the kernel takes {lib_top} windows, the wrapper {top}")
    p = horner_windows(proj, g2x, g2y, top + 1, ops)
    err = plain_err(proj.Proj(*(t[:top].contiguous() for t in p)), 0)
    require(err == 0, f"horner_fold_g2 W={top}, c=0: kernel differs from its plain version (max abs err {err})")
    try:
        cc.horner_fold_g2(*p, 0)
        refused = False
    except ValueError:
        refused = True
    require(refused, f"horner_fold_g2 took {top + 1} windows, past its limit of {top}")
    log(f"[kernels] horner_fold_g2 W={top} (its widest), c=0: bit-identical; W={top + 1} refused")
    return rows


def aff_rows(tf, cc, bound, aff_calls: dict, totals: dict, ax, ay) -> list:
    """The kernel-table rows of AFF_ROWS at the main paths' widths: every
    width the main paths launched each at (`aff_calls`: {name: {lanes:
    launches}}) is counted; the kernel is held bit for bit against its plain
    version on aff_edge_lanes at the widest, at the one with the most lanes
    launched in all, and at the one launched most often, the row's shape,
    where both are timed."""
    rows = []
    for name, replaces in AFF_ROWS.items():
        widths = aff_calls.get(name, {})
        require(sum(widths.values()) == totals[name], f"{name}: {totals[name]} launches, {widths} recorded")
        require(bool(widths), f"{name}: no main path launched it")
        ranked = sorted(widths, key=lambda m: (-widths[m], -m))
        log(f"[kernels] {name} launches by width on the main paths ({len(widths)} widths, "
            f"{width_lanes(name, widths)}): " + width_list(name, widths))
        fn, plain = getattr(cc, name), getattr(cc, name + "_plain")
        for m in dict.fromkeys([max(widths), max(widths, key=lambda m: (widths[m] * m, m)), ranked[0]]):
            x1, y1, x2, y2 = aff_edge_lanes(tf, ax, ay, m)
            packed = name == "aff_add_mixed_packed"
            kargs = (x1, y1, cc.AffineOps.pack_rows(cc.Aff(x2, y2))) if packed else (x1, y1, x2, y2)
            ref, plain_ms = timed_once(lambda: plain(*kargs))
            err = max_abs_err(fn(*kargs), ref)
            ms = cuda_ms(lambda: fn(*kargs), 10)
            if m != ranked[0]:
                require(err == 0, f"{name} at {m} lanes: kernel differs from its plain version (max abs err {err})")
                log(f"[kernels] {name} at {m} lanes (x{widths[m]}): bit-identical, kernel {ms:.4f} ms, "
                    f"plain {plain_ms:.3f} ms")
                continue
            work = aff_work(x1, y1, x2, y2, (5 if packed else 6) * 64 * m)
            rows.append({**kernel_row(bound, name, "hekaton_tpu_torch/csrc/curve.cu", replaces, ms, plain_ms, err, work),
                         "shape": f"{m} lanes"})
    return rows


def sweep_summary(inv_calls: dict, sweep: dict) -> str:
    """root_width_sweep's times summed over each path's batch_inv calls at
    every root width with the path's widest calls, then the per-call times
    of each path's most called width and of each field's three widest."""
    parts, named = [], []
    for name, calls in inv_calls.items():
        est = {stop: sum(n * sweep[(spec.name, m)][stop] for (spec, m), n in calls.items()) for stop in ROOT_WIDTHS}
        widest = sorted(calls.items(), key=lambda kv: -kv[0][1])[:6]
        parts.append(f"{name} ({sum(calls.values())} calls; widest {', '.join(f'{m} x{n}' for (_, m), n in widest)}): "
                     + ", ".join(f"{stop or 'no tree'} {v:.3f}" for stop, v in est.items()) + " ms")
        if calls:
            spec, m = max(calls, key=calls.get)
            named.append((spec.name, m))
    for field in sorted({s for s, _ in sweep}):
        named += sorted((k for k in sweep if k[0] == field), key=lambda k: -k[1])[:3]
    parts.append("per call (ms): " + "; ".join(
        f"{s} {m} lanes " + ", ".join(f"{stop or 'no tree'} {sweep[(s, m)][stop]:.4f}" for stop in ROOT_WIDTHS)
        for s, m in dict.fromkeys(named)))
    return " | ".join(parts)


def width_list(name: str, widths: dict) -> str:
    """Every width of `widths` ({width: launches}) with its launches, the
    most launched first: lanes, (columns, L) of a level-1 slab kernel,
    (W, c) of horner_fold and jac_horner, (lanes, nbits) of jac_ladder, (K,
    lanes) of jac_sum, or (field, lanes) of fermat_inv."""
    def label(k):
        if name in ("horner_fold", "horner_fold_g2", "jac_horner"):
            return "W={}, c={}".format(*k)
        if name == "jac_ladder":
            return "{} lanes, nbits={}".format(*k)
        if name == "jac_sum":
            return "K={}, {} lanes".format(*k)
        if isinstance(k, tuple):
            return f"{k[0].name} {k[1]}" if hasattr(k[0], "name") else f"{k[0]} columns x L={k[1]}"
        return str(k)

    def lanes(k):
        if name == "jac_sum" or isinstance(k, tuple) and hasattr(k[0], "name"):
            return k[1]
        return k[0] if isinstance(k, tuple) else k

    ranked = sorted(widths, key=lambda k: (-widths[k], -lanes(k)))
    return ", ".join(f"{label(k)} x{widths[k]}" for k in ranked)


def width_lanes(name: str, widths: dict) -> str:
    """The lanes summed over the launches of `widths` (a level-1 slab
    kernel's columns; a horner_fold launch is one fold)."""
    if name in ("horner_fold", "horner_fold_g2", "jac_horner"):
        return f"{sum(widths.values())} folds"
    if name in ("jac_ladder", "jac_sum"):
        return f"{sum(n * (k[0] if name == 'jac_ladder' else k[1]) for k, n in widths.items()):,} lanes in all"
    unit = "columns" if any(isinstance(k, tuple) and not hasattr(k[0], "name") for k in widths) else "lanes"
    total = sum(n * (k[1] if hasattr(k[0], "name") else k[0]) if isinstance(k, tuple) else n * k
                for k, n in widths.items())
    return f"{total:,} {unit} in all"


def kernel_row(bound, name, source, replaces, ms, plain_ms, err, work, library_ms=None, field=None) -> dict:
    """One row of the kernel table: the kernel held bit for bit against its
    plain version, both times and the bound of `work` (Bound's arguments)."""
    require(err == 0, f"{name}: kernel differs from its plain version (max abs err {err})")
    bound_ms, bound_by = bound(*work)
    library = "none" if library_ms is None else f"{library_ms:.3f} ms"
    log(f"[kernels] {name}: bit-identical, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library {library}, bound {bound_ms:.4f} ms ({bound_by})")
    if field is None:  # the instance whose launches the row counts
        field = "fq2" if name.endswith("_g2") else "fq"
    return {"name": name, "field": field, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def inv_check(tf, cf, bound, spec, a, time_plain: bool = False) -> tuple:
    """fermat_inv (the divstep kernel) on the lanes `a` against mont_inv (the
    plain Fermat chain), bit for bit, inv(0) = 0 on every zero lane, and its
    device time (and the plain version's, with time_plain); logs the bound
    of the function (Bound.inv) and, as diagnostics of the algorithm, its
    divsteps a lane and its dependent chain. Returns (kernel ms, plain ms or
    None, error, work)."""
    nw, m = spec.nlimbs // 2, a.shape[0]
    got = cf.fermat_inv(spec, a)
    err = max_abs_err(got, cf.fermat_inv_plain(spec, a))
    zero = (a == 0).all(-1)
    require(not bool(got[zero].any()), f"fermat_inv {spec.name}: inv(0) is not 0")
    ms = cuda_ms(lambda: cf.fermat_inv(spec, a), 20)
    plain_ms = cuda_ms(lambda: cf.fermat_inv_plain(spec, a), 1) if time_plain else None
    work = bound.inv(m, nw)
    b_ms, b_by = bound(*work)
    plain = "" if plain_ms is None else f", plain {plain_ms:.3f} ms"
    log(f"[kernels] fermat_inv {spec.name} {m} lanes ({int(zero.sum())} zero): max abs err {err}, kernel "
        f"{ms:.4f} ms{plain}, bound {b_ms:.4f} ms ({b_by}: {work[0]} bytes, {work[1]:.0f} products); "
        f"{inv_divsteps(nw)} divsteps a lane, {m * inv_divsteps(nw) / (ms * 1e6):.1f} divsteps a ns, "
        f"dependent chain ~{inv_chain(nw)} operations")
    return ms, plain_ms, err, work


def phase_kernels(h, tf, cf, cc, proj, pip, g1_pts, g2_pts, gen, bound, cuda_lib, g2_l1, msm) -> list:
    """Every kernel against its plain version at the main paths' shapes
    (`g2_l1`: g2_level1_inputs' result; `msm`: the G1 MSM's (scalars, c,
    L), whose v9 plan gives the halves rows their slab). The rows of
    INV_ROWS, AFF_ROWS and horner_fold come after the main paths (inv_rows,
    aff_rows, horner_rows), at the widths those launched; here the
    inversion kernel and the affine pair are held on their edge lanes."""
    rows = []

    def record(*args, **kw):
        rows.append(kernel_row(bound, *args, **kw))

    # mont_mul: 2^20 lanes, Fq and Fr, with 0, 1 and p-1
    errs, times = 0, {}
    for spec in (tf.FQ, tf.FR):
        a, b = rand_limbs(N_MUL, gen), rand_limbs(N_MUL, gen)
        edge = tf.tensor(spec.pack([0, 1, spec.modulus - 1]), DEVICE)
        a[:3], b[3:6], a[6:9], b[6:9] = edge, edge, edge, edge.flip(0)
        got, ref = cf.mont_mul(spec, a, b), cf.mont_mul_plain(spec, a, b)
        torch.cuda.synchronize()
        errs = max(errs, max_abs_err(got, ref))
        times[spec.name] = (cuda_ms(lambda: cf.mont_mul(spec, a, b), 20),
                            cuda_ms(lambda: cf.mont_mul_plain(spec, a, b), 3))
        log(f"[kernels] mont_mul {spec.name} {N_MUL} lanes: kernel {times[spec.name][0]:.3f} ms, "
            f"plain {times[spec.name][1]:.3f} ms")
        # a view one word into its storage: not 16-byte aligned, so the
        # wrapper copies it before the kernel's 16-byte loads
        errs = max(errs, max_abs_err(cf.mont_mul(spec, unaligned(a), b), ref))
    record("mont_mul", "hekaton_tpu_torch/csrc/field.cu", "hekaton_tpu/fields/pallas_field.py:253",
           *times["fq"], errs, (3 * 64 * N_MUL, N_MUL), field="fq, fr")

    # fermat_inv on inv_lanes (the edge lanes, 0 first): Fr and Fq at 1024
    # lanes, Fq at N_LANES (to_affine_device on a fixed-base chunk)
    for spec, m in ((tf.FR, 1024), (tf.FQ, 1024), (tf.FQ, N_LANES)):
        require(inv_check(tf, cf, bound, spec, inv_lanes(tf, spec, m, gen))[2] == 0,
                f"fermat_inv {spec.name} {m} lanes differs from mont_inv")

    # the 24-limb instances (BLS12-381 Fq, 12 words): mont_mul at 2^20 lanes
    # with 0, 1 and p-1, fermat_inv on inv_lanes at 1024 lanes
    spec = tf.FQ_BLS
    a, b = rand_limbs(N_MUL, gen, spec), rand_limbs(N_MUL, gen, spec)
    edge = tf.tensor(spec.pack([0, 1, spec.modulus - 1]), DEVICE)
    a[:3], b[3:6], a[6:9], b[6:9] = edge, edge, edge, edge.flip(0)
    err = max_abs_err(cf.mont_mul(spec, a, b), cf.mont_mul_plain(spec, a, b))
    record("mont_mul fq_bls381", "hekaton_tpu_torch/csrc/field.cu", "hekaton_tpu/fields/pallas_field.py:253",
           cuda_ms(lambda: cf.mont_mul(spec, a, b), 20), cuda_ms(lambda: cf.mont_mul_plain(spec, a, b), 3), err,
           (3 * 96 * N_MUL, N_MUL, 12), field=spec.name)
    m = 1024
    require(inv_check(tf, cf, bound, spec, inv_lanes(tf, spec, m, gen))[2] == 0,
            f"fermat_inv {spec.name} {m} lanes differs from mont_inv")
    a = rand_limbs(m, gen, spec)
    # an unknown field id launches nothing: the C entry points return an
    # error, the wrappers raise before them
    out = torch.empty_like(a)
    stream = cuda_lib.stream_ptr(a.device)
    rcs = (cuda_lib.lib().hk_mont_mul(7, a.data_ptr(), a.data_ptr(), out.data_ptr(), m, m, stream),
           cuda_lib.lib().hk_fermat_inv(7, a.data_ptr(), out.data_ptr(), m, stream))
    require(all(rc != 0 for rc in rcs), f"an unknown field id was launched: {rcs}")
    try:
        cf.mont_mul(tf.FieldSpec(2**61 - 1, "m61", nlimbs=4), a[:, :4].contiguous(), a[:, :4].contiguous())
        refused = False
    except ValueError:
        refused = True
    require(refused, "mont_mul took a field it has no kernel for")
    log(f"[kernels] unknown field id 7: hk_mont_mul, hk_fermat_inv return {rcs}; the wrappers raise")

    # aff_add_fused and aff_add_mixed_packed (the second operand as packed slab
    # rows, the sentinel lanes all-zero rows): 2^18 lanes with infinity,
    # doubling and inverse-pair lanes, lines of their own; their rows come
    # from aff_rows, at the widths the main paths launch them at
    n = N_LANES
    ax, ay = g1_pts
    args = aff_edge_lanes(tf, ax, ay)
    x1, y1, x2, y2 = args
    rows_q = cc.AffineOps.pack_rows(cc.Aff(x2, y2))
    for name, kargs in (("aff_add_fused", args), ("aff_add_mixed_packed", (x1, y1, rows_q))):
        fn, plain = getattr(cc, name), getattr(cc, name + "_plain")
        ref = plain(*kargs)
        # also with every operand a view off the 16-byte grid (the wrapper copies it)
        err = max(max_abs_err(fn(*kargs), ref), max_abs_err(fn(*map(unaligned, kargs)), ref))
        require(err == 0, f"{name} at {n} edge lanes: kernel differs from its plain version (max abs err {err})")
        log(f"[kernels] {name} at {n} lanes (doubling, inverse-pair and infinity lanes): bit-identical, kernel "
            f"{cuda_ms(lambda: fn(*kargs), 10):.4f} ms")

    # aff_prep and aff_fin: the same lanes, fin on the batch inverse of prep's den
    den, num = cc.aff_prep(*args)
    err = max_abs_err((den, num), cc.aff_prep_plain(*args))
    record("aff_prep", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:1305",
           cuda_ms(lambda: cc.aff_prep(*args), 10), cuda_ms(lambda: cc.aff_prep_plain(*args), 2), err,
           (6 * 64 * n, g1_products(0, aff_lanes(*args)[1])))
    fargs = (*args, tf.batch_inv(tf.FQ, den), num)
    err = max_abs_err(cc.aff_fin(*fargs), cc.aff_fin_plain(*fargs))
    record("aff_fin", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:1310",
           cuda_ms(lambda: cc.aff_fin(*fargs), 10), cuda_ms(lambda: cc.aff_fin_plain(*fargs), 2), err,
           (8 * 64 * n, g1_work("aff_sum", aff_lanes(*args)[0])))

    # l1_aff_halves and l1_aff_halves_t: the level-1 slab of the G1 MSM's v9
    # plan (one launch is one level 1), every column held against the plain
    # version, which is timed on the same call; and the slab of a 2^16-point
    # plan at L=32 in both layouts, lines of their own
    sc, mc, mL = msm
    slab, _, meta = pip._plan_sorted_w(ax, ay, sc, mc, mL)
    ncols = meta[4]
    log(f"[kernels] l1_aff_halves slab: {ncols} columns x L={mL} (the {ax.shape[0]}-point G1 MSM's v9 plan, c={mc})")
    work = halves_work(slab, mL)
    log(f"[kernels] l1_aff_halves work: {slab_adds(slab, mL)} adds of {ncols * (mL - 1)} (adds with the sentinel "
        f"need none), bound {bound(*work)[0]:.4f} ms ({bound(*work)[1]})")
    for name, tr in (("l1_aff_halves", False), ("l1_aff_halves_t", True)):
        v = slab.t().contiguous() if tr else slab
        fn, plain = getattr(cc, name), getattr(cc, name + "_plain")
        got = fn(v, mL)
        ref, plain_ms = timed_once(lambda: plain(v, mL))
        err = max(max_abs_err(got, ref), max_abs_err(got.t(), sums) if tr else 0)
        sums = got
        record(name, "hekaton_tpu_torch/csrc/curve.cu", f"hekaton_tpu/curves/pallas_curve.py:{906 if tr else 930}",
               cuda_ms(lambda: fn(v, mL), 5), plain_ms, err, work)
        del ref
    del v, got, sums

    # l1_rcb_mega on the same slab, as routes (a), (e) and (g) launch it (one
    # launch is one level 1): the row in the rows layout, a line in the
    # transposed one, each held against its plain version over every
    # column; then at L=24 (route (b)) on its own plan's slab, a line
    for label, lslab, lL in (("v9", slab, mL), ("L=24", pip._plan_sorted_w(ax, ay, sc, mc, 24)[0], 24)):
        lcols = lslab.shape[0]
        work = mega_work(lslab, lL)
        for tr in (False, True):
            v = lslab.t().contiguous() if tr else lslab
            got = cc.l1_rcb_mega(v, lL, transposed=tr)
            ref, plain_ms = timed_once(lambda: cc.l1_rcb_mega_plain(v, lL, transposed=tr))
            err = max_abs_err(got, ref)
            ms = cuda_ms(lambda: cc.l1_rcb_mega(v, lL, transposed=tr), 10)
            del ref
            if label == "v9" and not tr:
                rows.append({**kernel_row(bound, "l1_rcb_mega", "hekaton_tpu_torch/csrc/curve.cu",
                                          "hekaton_tpu/curves/pallas_curve.py:572", ms, plain_ms, err, work),
                             "shape": f"{lcols} columns x L={lL} (the {ax.shape[0]}-point v9 slab)"})
                continue
            require(err == 0, f"l1_rcb_mega ({label}, {'transposed' if tr else 'rows'}): kernel differs from its "
                              f"plain version (max abs err {err})")
            log(f"[kernels] l1_rcb_mega on the {label} slab ({lcols} columns x L={lL}, "
                f"{'transposed' if tr else 'rows'}): bit-identical over every column, kernel {ms:.3f} ms, plain "
                f"{plain_ms:.1f} ms, bound {bound(*work)[0]:.4f} ms ({bound(*work)[1]}: {slab_adds(lslab, lL)} adds)")
        del v, got
    # pmadd_rcb at route (c)'s width: the v9 slab's columns after 3 level-1
    # steps and the 4th step's operands, every lane held against the plain
    # version: the row
    pargs = g1_level1_inputs(pip, slab, mL)
    m = pargs[0].shape[0]
    ref, plain_ms = timed_once(lambda: cc.pmadd_rcb_plain(*pargs))
    err = max_abs_err(cc.pmadd_rcb(*pargs), ref)
    sentinels = int((pargs[4] == 0).all(-1).sum())
    rows.append({**kernel_row(bound, "pmadd_rcb", "hekaton_tpu_torch/csrc/curve.cu",
                              "hekaton_tpu/curves/pallas_curve.py:1293", cuda_ms(lambda: cc.pmadd_rcb(*pargs), 10),
                              plain_ms, err, (8 * 64 * m, g1_work("pmadd_rcb", m - sentinels))),
                 "shape": f"{m} lanes (route (c)'s level-1 step 4; {sentinels} sentinel lanes)"})
    del slab, pargs, ref
    m = N_PLAN
    c, L = 11, 32
    scal = torch.randint(0, 1 << 16, (m, 16), generator=gen, device=DEVICE, dtype=torch.int32)
    scal[:, 15] %= 0x3064
    slab, _, meta = pip._plan_sorted_w(ax[:m].contiguous(), ay[:m].contiguous(), scal, c, L)
    ncols = meta[4]
    slab_t = slab.t().contiguous()
    got = cc.l1_aff_halves(slab, L)
    got_t = cc.l1_aff_halves_t(slab_t, L)
    err = max(max_abs_err(got, cc.l1_aff_halves_plain(slab, L)), max_abs_err(got_t, cc.l1_aff_halves_t_plain(slab_t, L)),
              max_abs_err(got_t.t(), got), max_abs_err(cc.l1_aff_halves(unaligned(slab), L), got))
    require(err == 0, f"l1_aff_halves at {ncols} columns: a kernel differs from its plain version (max abs err {err})")
    log(f"[kernels] l1_aff_halves, l1_aff_halves_t on a {m}-point plan's slab ({ncols} columns x L={L}, c={c}): "
        f"bit-identical, kernel {cuda_ms(lambda: cc.l1_aff_halves(slab, L), 5):.3f} ms (rows), "
        f"{cuda_ms(lambda: cc.l1_aff_halves_t(slab_t, L), 5):.3f} ms (transposed)")

    # interleave_slab_t: the word planes of the tsort plan of the same points;
    # one PyTorch copy (a permuted .contiguous()) computes the same function
    planes, _, tmeta = pip._plan_sorted_t(ax[:m].contiguous(), ay[:m].contiguous(), scal, c, L)
    err = max_abs_err(cc.interleave_slab_t(planes), cc.interleave_slab_t_plain(planes))
    log(f"[kernels] interleave_slab_t planes: {tuple(planes.shape)} ({planes.numel() * 4 / 2**20:.1f} MiB), "
        f"{tmeta[4]} columns")
    # a view one word into its storage: not 16-byte aligned, so the word-a-thread path
    err = max(err, max_abs_err(cc.interleave_slab_t(unaligned(planes)), cc.interleave_slab_t_plain(planes)))
    record("interleave_slab_t", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:529",
           cuda_ms(lambda: cc.interleave_slab_t(planes), 10),
           cuda_ms(lambda: cc.interleave_slab_t_plain(planes), 10), err, (2 * 4 * planes.numel(), 0),
           library_ms=cuda_ms(lambda: planes.permute(2, 0, 1, 3).contiguous(), 10))
    del planes

    # madd: 2^18 lanes with test_pallas.py:33's edge lanes, also as unaligned
    # views (the row); then at a fixed-base width, no edges (a line)
    jp, (qx, qy) = g1_edge_lanes(tf, ax, ay, gen)
    margs = (*jp, qx, qy)
    ref = cc.madd_plain(*margs)
    err = max(max_abs_err(cc.madd(*margs), ref), max_abs_err(cc.madd(*map(unaligned, margs)), ref))
    record("madd", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:1281",
           cuda_ms(lambda: cc.madd(*margs), 10), cuda_ms(lambda: cc.madd_plain(*margs), 1), err,
           madd_work(tf, *margs))
    jp, (qx, qy) = g1_edge_lanes(tf, ax, ay, gen, MADD_WIDE, edges=False)
    margs = (*jp, qx, qy)
    ref, plain_ms = timed_once(lambda: cc.madd_plain(*margs))
    err = max_abs_err(cc.madd(*margs), ref)
    require(err == 0, f"madd at {MADD_WIDE} lanes: kernel differs from its plain version (max abs err {err})")
    work = bound(*madd_work(tf, *margs))
    log(f"[kernels] madd at {MADD_WIDE} lanes (a fixed-base width, no edges): bit-identical, kernel "
        f"{cuda_ms(lambda: cc.madd(*margs), 10):.4f} ms, plain {plain_ms:.1f} ms, bound {work[0]:.4f} ms ({work[1]})")
    del jp, qx, qy, margs, ref

    # dbl and add: 2^18 Jacobian lanes with infinity, doubling and inverse
    # lanes, also as unaligned views; no product is counted on an infinity
    # lane (dbl_work, add_work), add's doubling only on its 64 escape lanes
    jp, jq = g1_jacobian_pairs(tf, ax, ay, gen)
    ref = cc.dbl_plain(*jp)
    err = max(max_abs_err(cc.dbl(*jp), ref), max_abs_err(cc.dbl(*map(unaligned, jp)), ref))
    record("dbl", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:1285",
           cuda_ms(lambda: cc.dbl(*jp), 10), cuda_ms(lambda: cc.dbl_plain(*jp), 1), err, dbl_work(*jp))
    aargs = (*jp, *jq)
    ref = cc.add_plain(*aargs)
    err = max(max_abs_err(cc.add(*aargs), ref), max_abs_err(cc.add(*map(unaligned, aargs)), ref))
    record("add", "hekaton_tpu_torch/csrc/curve.cu", "hekaton_tpu/curves/pallas_curve.py:1289",
           cuda_ms(lambda: cc.add(*aargs), 10), cuda_ms(lambda: cc.add_plain(*aargs), 1), err,
           add_work(tf, *aargs))

    # the three RCB ops on G2, then on G1: 2^18 lanes with test_pallas.py:58's
    # completeness lanes
    for sfx, pts, src, lines, coord_bytes, products in (
        ("_g2", g2_pts, "curve_g2.cu", (1315, 1320, 1324), 128, tuple(RCB_G2_PRODUCTS.values())),
        ("", g1_pts, "curve.cu", (1293, 1297, 1301), 64,
         tuple(g1_work(op, 1) for op in ("pmadd_rcb", "padd_rcb", "pdbl_rcb"))),
    ):
        gp, gq, (bx, by) = proj_edge_lanes(tf, proj, *pts, gen)
        for op, line, kargs, nio, prods in zip(("pmadd_rcb", "padd_rcb", "pdbl_rcb"), lines,
                                               ((*gp, bx, by), (*gp, *gq), tuple(gp)), (8, 9, 6), products):
            fn, plain = getattr(cc, op + sfx), getattr(cc, op + sfx + "_plain")
            err = max_abs_err(fn(*kargs), plain(*kargs))
            work = (nio * coord_bytes * n, prods * n)
            if op + sfx == "pmadd_rcb":  # its row is at route (c)'s width (above); here its edge lanes, also unaligned
                err = max(err, max_abs_err(fn(*map(unaligned, kargs)), plain(*kargs)))
                require(err == 0, f"pmadd_rcb at {n} edge lanes: kernel differs from its plain version (max abs "
                                  f"err {err})")
                log(f"[kernels] pmadd_rcb at {n} edge lanes (also as unaligned views): bit-identical, kernel "
                    f"{cuda_ms(lambda: fn(*kargs), 10):.4f} ms, bound {bound(*work)[0]:.4f} ms ({bound(*work)[1]})")
                continue
            if op + sfx in ("padd_rcb", "pdbl_rcb"):  # 16-byte rows: also as unaligned views
                err = max(err, max_abs_err(fn(*map(unaligned, kargs)), plain(*kargs)))
            record(op + sfx, f"hekaton_tpu_torch/csrc/{src}", f"hekaton_tpu/curves/pallas_curve.py:{line}",
                   cuda_ms(lambda: fn(*kargs), 10), cuda_ms(lambda: plain(*kargs), 1), err, work)
    # padd_rcb at the suffix scan's and the collapse's widths (lines)
    for m in PADD_WIDTHS:
        kargs = proj_lanes(tf, *g1_pts, gen, m)
        ref, plain_ms = timed_once(lambda: cc.padd_rcb_plain(*kargs))
        err = max_abs_err(cc.padd_rcb(*kargs), ref)
        require(err == 0, f"padd_rcb at {m} lanes: kernel differs from its plain version (max abs err {err})")
        work = bound(9 * 64 * m, g1_work("padd_rcb", m))
        log(f"[kernels] padd_rcb at {m} lanes (distinct finite points): bit-identical, kernel "
            f"{cuda_ms(lambda: cc.padd_rcb(*kargs), 10):.4f} ms, plain {plain_ms:.1f} ms, bound {work[0]:.4f} ms "
            f"({work[1]})")
        del kargs, ref

    # pmadd_rcb_g2 and padd_rcb_g2 at the G2 MSM's own level-1 width, every
    # lane against the plain version: lines of their own, not rows
    g2_cols, pm_args, pa_args = g2_l1
    for op, kargs, nio in (("pmadd_rcb_g2", pm_args, 8), ("padd_rcb_g2", pa_args, 9)):
        fn, plain = getattr(cc, op), getattr(cc, op + "_plain")
        err = max_abs_err(fn(*kargs), plain(*kargs))
        require(err == 0, f"{op} at {g2_cols} lanes: kernel differs from its plain version (max abs err {err})")
        work = bound(nio * 128 * g2_cols, RCB_G2_PRODUCTS[op] * g2_cols)
        log(f"[kernels] {op} at the G2 MSM's level-1 width ({g2_cols} lanes of the msm_g2 plan, all held "
            f"against the plain version): bit-identical, kernel {cuda_ms(lambda: fn(*kargs), 10):.3f} ms, "
            f"bound {work[0]:.4f} ms ({work[1]})")
    # pdbl_rcb_g2 on the same accumulators, on one lane (the one-lane Horner
    # launches horner_fold_g2 replaced: timed, and its device time a launch
    # from the profiler's trace), and on 2^18 edge lanes as views off the
    # 16-byte grid
    fn, plain = cc.pdbl_rcb_g2, cc.pdbl_rcb_g2_plain
    gp = proj_edge_lanes(tf, proj, *g2_pts, gen)[0]
    one_lane = tuple(t[:1].contiguous() for t in pa_args[:3])
    for label, kargs, timed in ((f"{g2_cols} lanes (the msm_g2 level-1 accumulators)", pa_args[:3], True),
                                ("1 lane", one_lane, True),
                                ("1 lane (the identity)", tuple(t[128:129].contiguous() for t in gp), False),
                                (f"{N_LANES} edge lanes, unaligned views", tuple(unaligned(t) for t in gp), False)):
        err = max_abs_err(fn(*kargs), plain(*kargs))
        require(err == 0, f"pdbl_rcb_g2 at {label}: kernel differs from its plain version (max abs err {err})")
        line = f"[kernels] pdbl_rcb_g2 at {label}: bit-identical"
        if timed:
            m = kargs[0].shape[0]
            work = bound(6 * 128 * m, RCB_G2_PRODUCTS["pdbl_rcb_g2"] * m)
            line += f", kernel {cuda_ms(lambda: fn(*kargs), 20):.4f} ms, bound {work[0]:.6f} ms ({work[1]})"
        log(line)
    count, dev = kernel_device_times(lambda: fn(*one_lane), {"pdbl_rcb_g2_kernel": 1}, 50)["pdbl_rcb_g2_kernel"]
    log("[kernels] pdbl_rcb_g2 at 1 lane: device time a launch "
        + (f"{dev:.2f} us (torch.profiler)" if dev is not None
           else f"not measured (the profiler's trace holds {count} of 50 launches)"))

    # l1_rcb_mega on the 2^16-point plan's slab above (L=32) in both layouts,
    # also as an unaligned view: a line (its row is at the v9 slab, above)
    got = cc.l1_rcb_mega(slab, L)
    got_t = cc.l1_rcb_mega(slab_t, L, transposed=True)
    err = max(max_abs_err(got, cc.l1_rcb_mega_plain(slab, L)), max_abs_err(got_t, got),
              max_abs_err(got_t, cc.l1_rcb_mega_plain(slab_t, L, transposed=True)),
              max_abs_err(cc.l1_rcb_mega(unaligned(slab), L), got))
    require(err == 0, f"l1_rcb_mega at {ncols} columns: kernel differs from its plain version (max abs err {err})")
    work = mega_work(slab, L)
    log(f"[kernels] l1_rcb_mega on a {N_PLAN}-point plan's slab ({ncols} columns x L={L}): bit-identical, kernel "
        f"{cuda_ms(lambda: cc.l1_rcb_mega(slab, L), 10):.3f} ms (rows), "
        f"{cuda_ms(lambda: cc.l1_rcb_mega(slab_t, L, transposed=True), 10):.3f} ms (transposed), bound "
        f"{bound(*work)[0]:.4f} ms ({bound(*work)[1]})")
    return rows


def slice_circuit(h):
    """BASELINE.json configuration 1: Big-Merkle, 4 subcircuits, 1 SHA2
    iteration, 8 portals (cli.py's setup-big-merkle arguments)."""
    params = h.MerkleTreeCircuitParams(4 // 2, 1, 8)
    return "big-merkle", h.MerkleTreeCircuit.rand(h.Rng.from_int(1000), params)


def run_work(h, keys, backend, circ, mesh_prover=None):
    """cmd_work's calls through the port: stage 0, stage 1 (stateless
    recommit), or with `mesh_prover` both stages through its stage0_all and
    stage1_all; returns (requests 0, responses 0, responses 1, ipp key, agg
    state, secs)."""
    from hekaton_tpu_torch.protocol.coordinator import CoordinatorStage0State
    from hekaton_tpu_torch.protocol.worker import process_stage0_request, process_stage1_request

    n = circ.num_subcircuits()
    rng = h.Rng.from_int(1000)
    t0 = time.perf_counter()
    stage0 = CoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    if mesh_prover is not None:
        resps0 = mesh_prover.stage0_all(rng, type(circ), reqs0)
    else:
        resps0 = [process_stage0_request(rng.fork(str(i).encode()), type(circ), keys.get_pk(i), reqs0[i], backend)
                  for i in range(n)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ipp_ck = h.ipp_setup(n, h.Rng.from_int(2000))
    stage1 = stage0.process_stage0_responses(ipp_ck, resps0)
    reqs1 = [stage1.gen_request(i) for i in range(n)]
    agg_state = stage1.into_agg_state()
    t2 = time.perf_counter()
    if mesh_prover is not None:
        resps1 = mesh_prover.stage1_all(rng, type(circ), reqs1)
    else:
        resps1 = [
            process_stage1_request(rng.fork(b"s1" + str(i).encode()), type(circ), keys.get_pk(i), reqs0[i],
                                   resps0[i], reqs1[i], backend)
            for i in range(n)
        ]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return reqs0, resps0, resps1, ipp_ck, agg_state, {"stage0": t1 - t0, "exec_tree": t2 - t1, "stage1": t3 - t2}


class Tee(io.StringIO):
    """stdout that is kept as well as printed."""

    def write(self, s):
        sys.__stdout__.write(s)
        sys.__stdout__.flush()
        return super().write(s)


def cli_phase(card: str) -> None:
    """CLI_RUNS through the port's CLI, in-process, on the card: each a
    setup, then work with the stage-0 state spilled to disk; configuration
    1's key file then through `work --mesh 1x1` (a world of one rank on the
    card). The G1 compact msm must have run."""
    from hekaton_tpu_torch import cli

    made = []
    make_backend = cli._backend
    cli._backend = lambda name: made.append(make_backend(name)) or made[-1]  # keep the work backend's `ran`
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    compact = 0
    for label, setup, with_mesh in CLI_RUNS:
        out = Tee()
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=build) as tmp, contextlib.redirect_stdout(out):
            key = os.path.join(tmp, "keys")
            cli.main(["--backend", "gpu", *setup, "--key-out", key])
            t_setup = time.perf_counter() - t
            cli.main(["--backend", "gpu", "work", "--key-file", key, "--spill-dir", os.path.join(tmp, "spill")])
            t_all = time.perf_counter() - t
            ran = made[-1].ran
            mesh_text = None
            if with_mesh:
                mesh_out = Tee()
                t = time.perf_counter()
                with contextlib.redirect_stdout(mesh_out):
                    cli.main(["--backend", "gpu", "work", "--key-file", key, "--mesh", "1x1"])
                t_mesh, mesh_text = time.perf_counter() - t, mesh_out.getvalue()
        text = out.getvalue()
        require("[work] aggregate proof verified: True" in text, f"cli, {label}: the aggregate proof did not verify")
        require("(wire format)" in text, f"cli, {label}: stage 0 was not spilled through the wire format")

        def secs(pattern):
            m = re.search(pattern, text)
            require(m is not None, f"cli, {label}: no line matches {pattern!r}")
            return float(m.group(1))

        setup_s = secs(r"\[setup\] .*, ([\d.]+)s -> ")
        s0, s1, agg = (secs(rf"\[work\] {k} done \(([\d.]+)s\)") for k in ("stage0", "stage1", "aggregation"))
        compact += ran["g1_msm_compact"]
        log(f"[cli] {label} on {card}: setup {setup_s} s (CLI line; {t_setup:.1f} s in all), stage 0 {s0} s, "
            f"stage 1 {s1 - s0:.1f} s (with the spill), aggregation {agg - s1:.1f} s, the whole run {t_all:.1f} s; "
            f"work backend.ran {ran}")
        if mesh_text is not None:
            require("[work] mesh 1x1 (sub x pts) over 1 devices" in mesh_text, f"cli, {label}: no mesh line")
            require("[work] aggregate proof verified: True" in mesh_text,
                    f"cli, {label}: work --mesh 1x1: the aggregate proof did not verify")
            m0, m1, magg = (float(re.search(rf"\[work\] {k} done \(([\d.]+)s\)", mesh_text).group(1))
                            for k in ("stage0", "stage1", "aggregation"))
            log(f"[cli] {label} work --mesh 1x1 on {card}: stage 0 {m0} s, stage 1 {m1 - m0:.1f} s, aggregation "
                f"{magg - m1:.1f} s, the whole run {t_mesh:.1f} s; aggregate proof verified")
    cli._backend = make_backend
    require(compact > 0, "cli: no G1 MSM took the compact route")


def mesh_phase(h, keys, circ, slice_out: dict, card: str, rs) -> None:
    """[mesh]: the slice's keys and requests through MeshProver on a world of
    one rank on the card (NCCL), its commitments and proofs against the
    slice's; stage 0 again with force_ladder; the sharded NTT at D = 1 at
    the slice's domain size against the port's ntt."""
    import torch.distributed as dist

    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.ntt import ntt as nttm
    from hekaton_tpu_torch.ntt.sharded import make_sharded_ntt
    from hekaton_tpu_torch.runtime.mesh_prover import MeshProver
    from hekaton_tpu_torch.runtime.spmd import make_mesh

    t = time.perf_counter()
    mesh = make_mesh(device=DEVICE)
    require(dist.get_backend() == ("nccl" if DEVICE == "cuda" else "gloo") and mesh.shape == (1, 1)
            and mesh.device.type == torch.device(DEVICE).type,
            f"mesh: {mesh.shape} on {mesh.device} over {dist.get_backend()}")
    init_s = time.perf_counter() - t
    n, ssecs = slice_out["n"], slice_out["secs"]
    reqs0, resps0, resps1, _, _, msecs = run_work(h, keys, None, circ, mesh_prover=MeshProver(mesh, keys))
    require([r.com for r in resps0] == [r.com for r in slice_out["resps0"]],
            "mesh: stage-0 commitments differ from the slice's")
    for i in range(n):
        p, q = resps1[i].proof, slice_out["resps1"][i].proof
        require((p.a, p.b, p.c, p.ds) == (q.a, q.b, q.c, q.ds), f"mesh: stage-1 proof {i} differs from the slice's")
    log(f"[mesh] {n} subcircuits on a 1x1 mesh ({dist.get_backend()}, world of one rank, group set up in "
        f"{init_s:.2f} s) on {card}: "
        f"stage0 {msecs['stage0']:.2f} s, stage1 {msecs['stage1']:.2f} s against the slice's sequential "
        f"{ssecs['stage0']:.2f} s / {ssecs['stage1']:.2f} s; commitments and proofs equal the slice's bit for bit")

    ladder = MeshProver(mesh, keys, force_ladder=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lad0 = ladder.stage0_all(h.Rng.from_int(1000), type(circ), reqs0)
    torch.cuda.synchronize()
    lad_s = time.perf_counter() - t
    require([r.com for r in lad0] == [r.com for r in resps0], "mesh: force_ladder stage-0 commitments differ")
    widths = sorted({len(pk.ck.deltas_abc_g[0]) for pk in keys.minimal_pks.values()})
    log(f"[mesh] stage0 with force_ladder (stage-0 widths {widths}; jac_ladder and jac_sum, one batch a domain "
        f"size) on {card}: "
        f"{lad_s:.3f} s (host synthesis included) against {msecs['stage0']:.3f} s on the default route; "
        f"commitments equal")

    m = max(pk.domain_size for pk in keys.minimal_pks.values())
    x = tf.tensor(tf.FR.pack([int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(m)]), DEVICE)
    fwd, inv = make_sharded_ntt(mesh, m), make_sharded_ntt(mesh, m, inverse=True)
    got = fwd(x)
    require(torch.equal(got, nttm.ntt(x)) and torch.equal(inv(got), x), f"mesh: sharded NTT at n={m} differs")
    # in turns (sharded, ntt, ntt, sharded): both issue their launches from the host
    turns = [cuda_ms(fn, 5) for fn in (lambda: fwd(x), lambda: nttm.ntt(x), lambda: nttm.ntt(x), lambda: fwd(x))]
    log(f"[mesh] sharded NTT at D = 1, n = {m}: equals ntt forward and back; {turns[0]:.3f}, {turns[3]:.3f} ms "
        f"against ntt's {turns[1]:.3f}, {turns[2]:.3f} ms (in turns, CUDA events around host-issued launches) on "
        f"{card}")


def sha256_phase(card: str, rs) -> None:
    """[sha256]: N_SHA 64-byte messages (two 32-byte children each) through
    hashes/sha256_torch.py on the card, every digest against hashlib."""
    import hashlib

    from hekaton_tpu_torch.hashes import sha256_torch as sha

    children = rs.bytes(64 * N_SHA)
    msgs = [children[64 * i: 64 * (i + 1)] for i in range(N_SHA)]
    t = time.perf_counter()
    got = sha.sha256_bytes_batch(msgs, device=DEVICE)
    first = time.perf_counter() - t
    t = time.perf_counter()
    sha.sha256_bytes_batch(msgs, device=DEVICE)
    warm = time.perf_counter() - t
    require(got == [hashlib.sha256(m).digest() for m in msgs], "sha256: a digest differs from hashlib's")
    blocks = torch.from_numpy(sha.messages_to_blocks(msgs)).to(DEVICE)
    dev_ms = cuda_ms(lambda: sha.sha256_blocks(blocks), 3)
    log(f"[sha256] {N_SHA} messages of 64 bytes ({blocks.shape[1]} blocks each) equal hashlib's on {card}: "
        f"sha256_bytes_batch first {first:.3f} s, warm {warm:.3f} s ({N_SHA / warm:,.0f} hashes/s, host packing "
        f"and digest bytes included); the compressions alone {dev_ms:.2f} ms ({N_SHA / dev_ms * 1e3:,.0f} "
        f"hashes/s, CUDA events)")


def bls_paths(h, pip, main_path, bn254_kernels: list, card: str, rs, c: int, L: int) -> None:
    """msm_bls: BLS12-381 G1 along msm_gpu's default route for that curve at
    N_MSM points (window c, columns of L), then BLS_ROUTES at N_BLS_ROUTES
    points, each against the host; msm_bls_compact: the compact msm at
    N_BLS_COMPACT points. Both launch the 24-limb instances and no BN254
    kernel."""
    from hekaton_tpu_torch.curves.torch_curve import g1_bls12_381

    bls, curve = h.bls, g1_bls12_381()
    P, R = bls.P, bls.R
    N = N_MSM
    t = time.perf_counter()
    # k_j = k0 + j * delta: one host mul for P_0 and delta * G, then one add per point
    k0, delta = (int.from_bytes(rs.bytes(48), "little") % R for _ in range(2))
    step = bls_mul(bls.G1_GEN, delta, P)
    pts = [bls_mul(bls.G1_GEN, k0, P)]
    for _ in range(N_BLS_DISTINCT - 1):
        pts.append(bls_add(pts[-1], step, P))
    ks = [(k0 + j * delta) % R for j in range(N_BLS_DISTINCT)]
    bx_np, by_np = curve.pack_affine(pts)
    reps = N // N_BLS_DISTINCT
    bx = torch.from_numpy(bx_np).to(DEVICE).repeat(reps, 1)
    by = torch.from_numpy(by_np).to(DEVICE).repeat(reps, 1)
    bx[5], by[5] = 0, 0  # an infinity row
    words = rs.randint(0, 2**63, size=(N, 5), dtype=np.int64)
    scalars = [sum(int(w) << (63 * i) for i, w in enumerate(row)) % R for row in words]
    scalars[0], scalars[1], scalars[2] = 0, 1, R - 1
    above = sum(s >= h.R for s in scalars)  # above BN254's r: packed modulo BN254's r they would change
    sc = pip.pack_scalars(scalars, curve).to(DEVICE)

    def expected(n):
        return bls_mul(bls.G1_GEN, sum(s * ks[i % N_BLS_DISTINCT] for i, s in enumerate(scalars[:n]) if i != 5) % R, P)

    want = expected(N)
    log(f"[msm] BLS12-381 G1: {N_BLS_DISTINCT} distinct points tiled to {N} rows, {N} scalars ({above} at or "
        f"above BN254's r) and the expected sum made on the host in {time.perf_counter() - t:.1f} s")

    def run(label, n, warm_runs, **route):
        x, y, s = bx[:n].contiguous(), by[:n].contiguous(), sc[:n].contiguous()
        exp = want if n == N else expected(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = pip.msm_gpu(x, y, s, c=c, L=L, curve=curve, **route)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        got = curve.unpack_jacobian(type(out)(*(a[None] for a in out)))[0]
        require(got == exp, f"{n}-point BLS12-381 G1 {label} MSM differs from the host result")
        warm = []
        for _ in range(warm_runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pip.msm_gpu(x, y, s, c=c, L=L, curve=curve, **route)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t)
        accum, level1, plan = pip.resolve_route(curve, L, **route)
        log(f"[msm] BLS12-381 G1 {label} (accum={accum}, level1={level1}, plan={plan}) {n} points (c={c}, L={L}, "
            f"nbits=255) equals the host result; first {cold:.3f} s, warm {', '.join(f'{w:.3f}' for w in warm)} s, "
            f"best {n / min(warm):,.0f} points/s on {card}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def msm_path():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            run("default route", N, 3)
            for label, route in BLS_ROUTES:
                run(f"route {label}", N_BLS_ROUTES, 1, **route)
        routed = [str(w.message) for w in seen if str(w.message).startswith("msm_gpu")]
        require(not routed, f"a BLS12-381 route warned: {routed}")  # each runs as asked

    main_path("msm_bls", list(BLS_KERNELS), msm_path, absent=bn254_kernels)

    def compact_path():
        for n in N_BLS_COMPACT:
            host_pts = [None if i == 5 else pts[i] for i in range(n)]
            px, py = (torch.from_numpy(a).to(DEVICE) for a in curve.pack_affine(host_pts))
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = pip.msm(curve, px, py, sc[:n].contiguous())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            got = curve.unpack_jacobian(type(out)(*(a[None] for a in out)))[0]
            require(got == expected(n), f"compact BLS12-381 msm of {n} points differs from the host")
            log(f"[msm_compact] BLS12-381 G1 {n} points equals the host sum; "
                f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms (first, warm) on {card}")

    main_path("msm_bls_compact", [BLS_KERNELS[0]], compact_path, absent=bn254_kernels)


class _Com:
    """A super-commitment stand-in: the exec tree reads only its bytes."""

    def __init__(self, data: bytes):
        self.data = data

    def to_bytes(self) -> bytes:
        return self.data


def exec_tree_phase(h, card: str, rs) -> None:
    """The device exec tree against the host tree on ROM and RAM transcripts
    of N_TREE entries over N_TREE_SUB subcircuits (random lengths)."""
    from hekaton_tpu_torch.protocol import eval_tree_torch as et
    from hekaton_tpu_torch.protocol.coordinator import generate_exec_tree, sort_subtraces_by_addr
    from hekaton_tpu_torch.protocol.transcript import RamTranscriptEntry, RomTranscriptEntry

    stage_fns = {"pack (host)": "_pack_mont", "terms": "_terms", "scan": "_prefix_products",
                 "Poseidon tree": "merkle_levels_device"}
    plain = {name: getattr(et, fn) for name, fn in stage_fns.items()}
    stages = {}

    def timed(name):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = plain[name](*a, **k)
            torch.cuda.synchronize()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    cuts = np.sort(rs.choice(np.arange(1, N_TREE), N_TREE_SUB - 1, replace=False))
    lens = np.diff(np.concatenate([[0], cuts, [N_TREE]])).tolist()
    addrs = rs.randint(1, 1 << 20, size=N_TREE).tolist()
    vals = [int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(N_TREE)]
    reads = rs.randint(0, 2, size=N_TREE).tolist()
    com = _Com(rs.bytes(32))
    for mem in ("rom", "ram"):
        if mem == "rom":
            flat = [RomTranscriptEntry(a, v) for a, v in zip(addrs, vals)]
        else:
            flat = [RamTranscriptEntry(a, v, t, bool(r)) for t, (a, v, r) in enumerate(zip(addrs, vals, reads))]
        time_sts, pos = [], 0
        for n in lens:
            time_sts.append(flat[pos : pos + n])
            pos += n
        addr_sts = sort_subtraces_by_addr(time_sts)
        require("HEKATON_DEVICE_TREE" not in os.environ, "exec tree: HEKATON_DEVICE_TREE is set for the host tree")
        t = time.perf_counter()
        host_tree, host_leaves = generate_exec_tree(mem, com, time_sts, addr_sts)
        host_s = time.perf_counter() - t
        secs = []
        os.environ["HEKATON_DEVICE_TREE"] = "1"  # the coordinator's branch, as a user turns it on
        try:
            for run in range(2):  # the second run's stages timed (a sync around each)
                stages.clear()
                for name, fn in stage_fns.items():
                    setattr(et, fn, timed(name) if run else plain[name])
                torch.cuda.synchronize()
                t = time.perf_counter()
                tree, leaves = generate_exec_tree(mem, com, time_sts, addr_sts)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
        finally:
            del os.environ["HEKATON_DEVICE_TREE"]
            for name, fn in stage_fns.items():
                setattr(et, fn, plain[name])
        require(set(stages) == set(stage_fns), f"exec tree ({mem}): the coordinator did not build the device tree")
        require(tree.root() == host_tree.root() and tree.levels == host_tree.levels,
                f"exec tree ({mem}): the device tree differs from the host tree")
        require([a.to_field_elements() for a in leaves] == [b.to_field_elements() for b in host_leaves],
                f"exec tree ({mem}): the device leaves differ from the host leaves")
        log(f"[exec_tree] {mem.upper()} {N_TREE} entries over {N_TREE_SUB} subcircuits: the device tree equals the "
            f"host tree (root, {len(tree.levels)} levels, leaves); device {', '.join(f'{x:.3f}' for x in secs)} s "
            f"(first, warm; stages of the warm run: {', '.join(f'{k} {v:.3f}' for k, v in stages.items())} s, "
            f"the terms including their packing) on {card}, host {host_s:.3f} s")



def timed_methods(backend) -> dict:
    """Wrap backend.fixed_base and backend.msm to add up their wall time
    per curve (both return host values, so the card has finished when they
    return): secs["fixed_base_g1"], ["fixed_base_g2"], ["msm_g1"], ["msm_g2"]."""
    secs = {"fixed_base_g1": 0.0, "fixed_base_g2": 0.0, "msm_g1": 0.0, "msm_g2": 0.0}
    fixed_base, msm = backend.fixed_base, backend.msm

    def timed_fixed_base(base, scalars, g2=False):
        t = time.perf_counter()
        out = fixed_base(base, scalars, g2=g2)
        secs["fixed_base_g2" if g2 else "fixed_base_g1"] += time.perf_counter() - t
        return out

    def timed_msm(vec, scalars):
        t = time.perf_counter()
        out = msm(vec, scalars)
        secs[f"msm_{vec.curve.name}"] += time.perf_counter() - t
        return out

    backend.fixed_base, backend.msm = timed_fixed_base, timed_msm
    return secs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    from hekaton_tpu_torch import cuda_lib
    from hekaton_tpu_torch import host as h
    from hekaton_tpu_torch.cpgroth16.backend import HostBackend, TorchBackend
    from hekaton_tpu_torch.cpgroth16.verifier import prepare_verifying_key, verify_proof
    from hekaton_tpu_torch.curves import cuda_curve as cc
    from hekaton_tpu_torch.curves import proj
    from hekaton_tpu_torch.curves.torch_curve import G1, G2
    from hekaton_tpu_torch.fields import cuda_field as cf
    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.msm import pippenger as pip
    from hekaton_tpu_torch.runtime.keys import ProvingKeys

    require(h.native_available(), "native host library did not build")
    import_s = time.perf_counter() - t_start
    card = smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; port imported (native host library built) in {import_s:.1f} s")
    t = time.perf_counter()
    path, report = cuda_lib.build()
    cuda_lib.lib()
    log(f"[device] kernels built in {time.perf_counter() - t:.1f} s -> {os.path.basename(path)}")
    resident = cuda_lib.occupancy(cuda_lib.lib())
    for name, regs, spill in ptxas_summary(report):
        log(f"[device] {name}: {regs} registers, {spill} bytes spilled, "
            f"{resident.get(name, 'not queried')} blocks an SM (occupancy query)")
        require(spill == 0, f"{name} spills {spill} bytes")
    bound = Bound()
    log(f"[device] bound: {bound.sms} SMs at {bound.clock_hz / 1e6:.0f} MHz max, "
        f"{INT_MULS_PER_SM_CLOCK} int32 multiplies / SM / clock, {HBM_BYTES_PER_S / 1e12} TB/s")

    # the 2^20-point G1 set of msm_g1; phase 2 takes its shapes' inputs from it
    N = N_MSM
    rs = np.random.RandomState(SEED)
    k0, delta = (int.from_bytes(rs.bytes(32), "little") % h.R for _ in range(2))
    t = time.perf_counter()
    host_pts = chain_points(N, k0, delta, h)
    ks = [(k0 + i * delta) % h.R for i in range(N)]
    host_pts[5], ks[5] = None, 0  # an infinity row
    host_pts[7], ks[7] = host_pts[6], ks[6]  # a duplicate point
    scalars = rand_scalars(rs, N, h.R)
    scalars[0], scalars[1], scalars[2] = 0, 1, h.R - 1
    scalars[7] = scalars[6]
    ax_np, ay_np = G1.pack_affine(host_pts)
    ax, ay = torch.from_numpy(ax_np).to(DEVICE), torch.from_numpy(ay_np).to(DEVICE)
    sc = pip.pack_scalars(scalars, G1).to(DEVICE)
    expected = h.ch.pt_mul(h.ch.g1_gen(), sum(s * k for s, k in zip(scalars, ks)) % h.R)
    log(f"[msm] {N} G1 points and scalars made on the host in {time.perf_counter() - t:.1f} s")

    # the G2 set of msm_g2: 4,096 distinct k_j * G2 by the native mul_batch,
    # tiled to 2^20 rows on the card, row 5 the infinity sentinel
    t = time.perf_counter()
    g2_host, kg2, g2x, g2y = g2_set(h, G2, rs, N)
    e2 = sum(s * kg2[i % N_G2_DISTINCT] for i, s in enumerate(scalars) if i != 5) % h.R
    expected_g2 = h.ch.pt_mul(h.ch.g2_gen(), e2)
    log(f"[msm] {N_G2_DISTINCT} G2 points tiled to {N} rows, expected sum in {time.perf_counter() - t:.1f} s")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    c, L = TorchBackend.msm_params(N)
    rows = phase_kernels(h, tf, cf, cc, proj, pip, (ax, ay), (g2x, g2y), gen, bound, cuda_lib,
                         g2_level1_inputs(pip, g2x, g2y, sc, c, L), (sc, c, L))

    curve_kernels = {"aff_add_fused": cc.aff_add_fused, "l1_aff_halves": cc.l1_aff_halves,
                     "horner_fold": cc.horner_fold, "horner_fold_g2": cc.horner_fold_g2, "madd": cc.madd,
                     "pmadd_rcb_g2": cc.pmadd_rcb_g2,
                     "padd_rcb_g2": cc.padd_rcb_g2, "pdbl_rcb_g2": cc.pdbl_rcb_g2, "dbl": cc.dbl, "add": cc.add,
                     "pmadd_rcb": cc.pmadd_rcb, "padd_rcb": cc.padd_rcb, "pdbl_rcb": cc.pdbl_rcb,
                     "l1_rcb_mega": cc.l1_rcb_mega, "aff_add_mixed_packed": cc.aff_add_mixed_packed,
                     "interleave_slab_t": cc.interleave_slab_t, "l1_aff_halves_t": cc.l1_aff_halves_t,
                     "aff_prep": cc.aff_prep, "aff_fin": cc.aff_fin,
                     **{name: getattr(cc, name) for name in CHAIN_KERNELS}}

    def field_count(fn, fields):
        return lambda: sum(fn.launches_by_field.get(f, 0) for f in fields)

    # the launch count of every row of the kernel table: the field kernels'
    # rows count their instances (BN254 Fq and Fr, or BLS12-381 Fq)
    kernels = {"mont_mul": field_count(cf.mont_mul, ("fq", "fr")),
               "mont_mul fq_bls381": field_count(cf.mont_mul, ("fq_bls381",)),
               **{k: field_count(cf.fermat_inv, fields) for k, fields in INV_ROWS.items()},
               **{k: (lambda fn=fn: fn.launches) for k, fn in curve_kernels.items()}}
    require(set(kernels) == {r["name"] for r in rows} | set(INV_ROWS) | set(AFF_ROWS)
            | {"horner_fold", "horner_fold_g2"} | set(CHAIN_KERNELS),
            "the kernel table and the launch counts name other kernels")
    totals = dict.fromkeys(kernels, 0)
    # the inversion kernel's calls on CUDA tensors by main path, (field,
    # lanes) and caller: tf.batch_inv's (one launch each; the [batch_inv]
    # root-width sweep takes those of SWEPT_PATHS) and to_affine_device's
    # (pippenger imports fermat_inv by name); the callers look both up at
    # call time. inv_rows times the kernel at the widths they launched.
    inv_calls = {"batch_inv": {}, "to_affine_device": {}}
    path_now = [None]

    def recorded(via, fn):
        def run(spec, a):
            m = a.numel() // spec.nlimbs
            if path_now[0] is not None and a.is_cuda and m:
                calls = inv_calls[via].setdefault(path_now[0], {})
                calls[(spec, m)] = calls.get((spec, m), 0) + 1
            return fn(spec, a)
        return run

    tf.batch_inv = recorded("batch_inv", tf.batch_inv)
    pip.fermat_inv = recorded("to_affine_device", pip.fermat_inv)
    # the affine pair's launches on the main paths by width: its wrappers
    # launch through cuda_curve._launch_aff_add, looked up at call time
    aff_calls = {}
    launch_aff = cc._launch_aff_add

    def recorded_aff(fn, entries, x1, *rest):
        m = x1.numel() // 16
        if path_now[0] is not None and m:
            calls = aff_calls.setdefault(fn.__name__, {})
            calls[m] = calls.get(m, 0) + 1
        return launch_aff(fn, entries, x1, *rest)

    cc._launch_aff_add = recorded_aff
    # the point-op kernels' launches on the main paths by width (lanes) and
    # horner_fold's by (W, c): the wrappers launch through
    # cuda_curve._launch_point_op, and pippenger calls horner_fold, both
    # looked up at call time
    op_calls = {}
    launch_op = cc._launch_point_op

    def record_width(name, width):
        calls = op_calls.setdefault(name, {})
        calls[width] = calls.get(width, 0) + 1

    def recorded_op(fn, entry, args, coord_shape, n_out=3):
        m = args[0].numel() // math.prod(coord_shape)
        if path_now[0] is not None and m:
            record_width(fn.__name__, m)
        return launch_op(fn, entry, args, coord_shape, n_out)

    cc._launch_point_op = recorded_op
    fold = pip.horner_fold

    def recorded_fold(x, y, z, c):
        if path_now[0] is not None and x.is_cuda:
            record_width("horner_fold", (x.shape[0], c))
        return fold(x, y, z, c)

    pip.horner_fold = recorded_fold
    fold_g2 = pip.horner_fold_g2

    def recorded_fold_g2(x, y, z, c):
        if path_now[0] is not None and x.is_cuda:
            record_width("horner_fold_g2", (x.shape[0], c))
        return fold_g2(x, y, z, c)

    pip.horner_fold_g2 = recorded_fold_g2
    # msm_gpu's G2 calls on CUDA tensors by main path: each folds its
    # windows in one horner_fold_g2 launch (TorchBackend looks msm_gpu up at
    # call time)
    g2_msms = {}
    bucket_msm = pip.msm_gpu

    def recorded_msm_gpu(ax, *rest, **kw):
        if path_now[0] is not None and ax.is_cuda and tuple(ax.shape[1:]) == (2, 16):
            g2_msms[path_now[0]] = g2_msms.get(path_now[0], 0) + 1
        return bucket_msm(ax, *rest, **kw)

    pip.msm_gpu = recorded_msm_gpu

    # the chain kernels' launches by shape: jac_ladder by (lanes, nbits),
    # jac_sum by (K, lanes), jac_horner by (W, c), from the kernel arguments
    # after the output pointers (lanes and nbits, lanes and K, W and c) that
    # every chain wrapper passes to cuda_curve._launch_chain. The compact
    # msm's BN254 G1 runs by kind: a ladder (N <= MSM_LADDER_THRESHOLD)
    # launches jac_ladder once, a bucket MSM jac_horner once an MSM (TorchBackend
    # looks pippenger's msm up at call time)
    launch_chain = cc._launch_chain
    chain_shape = {"jac_ladder": lambda t: t, "jac_sum": lambda t: (t[1], t[0]), "jac_horner": lambda t: t}

    def recorded_chain(fn, entry, args, out_shape, lanes, *tail):
        if path_now[0] is not None and lanes:
            record_width(fn.__name__, chain_shape[fn.__name__](tail))
        return launch_chain(fn, entry, args, out_shape, lanes, *tail)

    cc._launch_chain = recorded_chain
    compact_runs = {}
    compact = pip.msm

    def record_run(curve, ax, kind, n=1):
        if path_now[0] is not None and ax.is_cuda and pip._is_bn254_g1(curve):
            runs = compact_runs.setdefault(path_now[0], {"jac_ladder": 0, "jac_horner": 0})
            runs[kind] += n

    def recorded_msm(curve, ax, ay, scalars, *rest, **kw):
        # a batched call ((B, N, 16) scalars, the mesh's) launches jac_horner once an MSM
        if not pip.takes_ladder(scalars.shape[-2]):
            record_run(curve, ax, "jac_horner", math.prod(scalars.shape[:-2]))
        return compact(curve, ax, ay, scalars, *rest, **kw)

    pip.msm = recorded_msm
    # a ladder (the compact msm's below MSM_LADDER_THRESHOLD points, or the
    # mesh's batched and forced ones) launches jac_ladder once
    ladder = pip._msm_ladder

    def recorded_ladder(curve, ax, *rest, **kw):
        record_run(curve, ax, "jac_ladder")
        return ladder(curve, ax, *rest, **kw)

    pip._msm_ladder = recorded_ladder

    # the level-1 slab kernels' launches by (columns, L): pippenger imports
    # them by name and calls them with the slab first
    def recorded_slab(fn, transposed: bool):
        def run(slab, L, *rest, **kw):
            tr = transposed or bool(rest and rest[0]) or kw.get("transposed", False)
            ncols = slab.shape[1] if tr else slab.shape[0]
            launches = ncols > 0 and (fn.__name__ == "l1_rcb_mega" or L > 1)  # the halves skip L = 1
            if path_now[0] is not None and slab.is_cuda and launches:
                record_width(fn.__name__, (ncols, L))
            return fn(slab, L, *rest, **kw)
        return run

    for name, tr in (("l1_rcb_mega", False), ("l1_aff_halves", False), ("l1_aff_halves_t", True)):
        setattr(pip, name, recorded_slab(getattr(pip, name), tr))

    def main_path(name: str, expect: list, run,
                  absent=ROUTE_KERNELS + UNFUSED_KERNELS + BLS_KERNELS + NO_PATH_KERNELS):
        """Run one main path with every launch count at 0 before it; fail if
        one of its kernels was not launched, or one of `absent` was, or the
        chain kernels were not launched once a compact BN254 G1 ladder
        (jac_ladder) and once a compact bucket MSM (jac_horner), or
        horner_fold_g2 not once a G2 msm_gpu call."""
        path_now[0] = name
        cf.reset_counts(cf.mont_mul)
        cf.reset_counts(cf.fermat_inv)
        for fn in curve_kernels.values():
            fn.launches = 0
        run()
        torch.cuda.synchronize()
        counts = {k: count() for k, count in kernels.items()}
        for k, v in counts.items():
            totals[k] += v
        log(f"[coverage] {name}: {counts}")
        recorded_by_field = {}
        for calls in inv_calls.values():
            for (spec, _), n in calls.get(name, {}).items():
                recorded_by_field[spec.name] = recorded_by_field.get(spec.name, 0) + n
        require(recorded_by_field == {f: n for f, n in cf.fermat_inv.launches_by_field.items() if n},
                f"{name}: fermat_inv launched {cf.fermat_inv.launches_by_field}, its callers recorded {recorded_by_field}")
        missing = [k for k in expect if counts[k] <= 0]
        require(not missing, f"{name}: kernels never launched on this path: {missing}")
        stray = [k for k in absent if counts[k] > 0]
        require(not stray, f"{name}: kernels of another route launched on this path: {stray}")
        runs = compact_runs.get(name, {"jac_ladder": 0, "jac_horner": 0})
        require(all(counts[k] == v for k, v in runs.items()),
                f"{name}: compact BN254 G1 MSMs {runs}, chain launches "
                f"{ {k: counts[k] for k in runs} } (one a ladder, one a bucket MSM)")
        require(counts["horner_fold_g2"] == g2_msms.get(name, 0),
                f"{name}: {g2_msms.get(name, 0)} G2 msm_gpu calls, {counts['horner_fold_g2']} horner_fold_g2 launches")

    def msm_path(label, x, y, exp, curve, L=L, **route):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = pip.msm_gpu(x, y, sc, c=c, L=L, **route)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        got = curve.unpack_jacobian(type(out)(*(a[None] for a in out)))[0]
        require(got == exp, f"{N}-point {label} MSM differs from the host result")
        warm = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pip.msm_gpu(x, y, sc, c=c, L=L, **route)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t)
        best = min(warm)
        log(f"[msm] {label} {N} points (c={c}, L={L}) equals the host result; first {cold:.3f} s, warm "
            f"{', '.join(f'{w:.3f}' for w in warm)} s, best {N / best:,.0f} points/s on {card}; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    main_path("msm_g1", ["mont_mul", "fermat_inv", "aff_add_fused", "l1_aff_halves", "horner_fold"],
              lambda: msm_path("G1", ax, ay, expected, G1))

    def routes_path():
        for label, route_L, route in ROUTES:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                accum, level1, plan = pip.resolve_route(G1, route_L, **route)
                msm_path(f"G1 route {label} accum={accum}, level1={level1}, plan={plan}", ax, ay, expected, G1,
                         L=route_L, **route)
            for w in {str(w.message) for w in seen}:
                log(f"[msm] route {label} warned: {w}")
            require(bool(seen) == (label in WARNS), f"route {label}: expected a warning: {label in WARNS}")

    main_path("msm_routes", ["l1_rcb_mega", "padd_rcb", "pmadd_rcb", "mont_mul", "fermat_inv", "aff_add_fused",
                             "horner_fold", "aff_add_mixed_packed", "interleave_slab_t", "l1_aff_halves_t"],
              routes_path, absent=UNFUSED_KERNELS + BLS_KERNELS + NO_PATH_KERNELS)

    # the unfused affine add: aff_prep, batch_inv of the denominators, aff_fin
    uargs = aff_edge_lanes(tf, ax, ay)

    def unfused_path():
        torch.cuda.synchronize()
        t = time.perf_counter()
        den, num = cc.aff_prep(*uargs)
        got = cc.aff_fin(*uargs, tf.batch_inv(tf.FQ, den), num)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        require(max_abs_err(got, cc.aff_add_fused(*uargs)) == 0, "aff_prep, batch_inv, aff_fin differ from aff_add_fused")
        log(f"[unfused_affine] aff_prep, batch_inv, aff_fin on {N_LANES} lanes equal aff_add_fused; "
            f"{secs * 1e3:.2f} ms on {card}")

    # batch_inv on the card runs no mont_mul tree: every lane on fermat_inv
    main_path("unfused_affine", ["aff_prep", "aff_fin", "fermat_inv"], unfused_path,
              absent=ROUTE_KERNELS + BLS_KERNELS + NO_PATH_KERNELS + ("mont_mul",))
    del uargs

    # the compact msm at TorchBackend's window widths; the first rows of the
    # G1 and G2 sets hold scalars 0, 1 and r-1, an infinity row and a
    # repeated point with a repeated scalar
    def compact_path():
        for curve_id, n in N_COMPACT:
            curve, label = (G1, "G1") if curve_id == 1 else (G2, "G2")
            pts = list(host_pts[:n]) if curve_id == 1 else [g2_host[i % N_G2_DISTINCT] for i in range(n)]
            pts[5] = None
            pts[7] = pts[6]
            px, py = (torch.from_numpy(a).to(DEVICE) for a in curve.pack_affine(pts))
            psc = sc[:n].contiguous()
            c = TorchBackend.compact_window(n)
            times = []
            for _ in range(2 if curve_id == 1 else 1):  # a G2 one runs plain Fq2 formulas: seconds
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = pip.msm(curve, px, py, psc, c=c)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            got = curve.unpack_jacobian(type(out)(*(a[None] for a in out)))[0]
            require(got == h.ch.msm_host(pts, scalars[:n]), f"compact {label} msm of {n} points differs from msm_host")
            log(f"[msm_compact] {label} {n} points ({'ladder' if n <= pip.MSM_LADDER_THRESHOLD else f'c={c}'}) "
                f"equals msm_host; {', '.join(f'{t * 1e3:.1f}' for t in times)} ms (first, warm) on {card}")

    main_path("msm_compact", ["add", "madd", *CHAIN_KERNELS], compact_path)
    del ax, ay
    main_path("msm_g2", ["mont_mul", "pmadd_rcb_g2", "padd_rcb_g2", "horner_fold_g2"],
              lambda: msm_path("G2", g2x, g2y, expected_g2, G2))
    g2_rows = (g2x[:512].clone(), g2y[:512].clone())  # window sums of horner_g2_rows
    del g2x, g2y, sc

    bls_paths(h, pip, main_path, [k for k in kernels if k not in BLS_KERNELS], card, rs, c, L)
    path_now[0] = None

    # batch_inv's root width: each swept path's calls timed at every width
    t = time.perf_counter()
    swept = {name: inv_calls["batch_inv"].get(name, {}) for name in SWEPT_PATHS}
    keys = sorted({key for calls in swept.values() for key in calls}, key=lambda k: (k[0].name, k[1]))
    sweep = root_width_sweep(tf, cf, keys, gen)
    log(f"[batch_inv] root-width sweep ({len(keys)} widths, {time.perf_counter() - t:.1f} s; tf.batch_inv runs "
        f"no tree): {sweep_summary(swept, sweep)}; on {card}")
    main_path("exec_tree", ["mont_mul"], lambda: exec_tree_phase(h, card, rs))

    # fixed-base: 2^18 scalars per curve through TorchBackend.fixed_base
    fb_scalars = scalars[:N_FB]  # 0, 1 and R-1 first
    sample = np.concatenate([[0, 1, 2], rs.choice(np.arange(3, N_FB), N_SAMPLE - 3, replace=False)])

    def fixed_base_path():
        backend = TorchBackend(DEVICE)
        for g2, gen_pt in ((False, h.ch.g1_gen()), (True, h.ch.g2_gen())):
            base = h.ch.pt_mul(gen_pt, int.from_bytes(rs.bytes(32), "little") % h.R)
            t = time.perf_counter()
            got = backend.fixed_base(base, fb_scalars, g2=g2)
            first = time.perf_counter() - t
            t = time.perf_counter()
            backend.fixed_base(base, fb_scalars, g2=g2)
            warm = time.perf_counter() - t
            want = h.accel.mul_batch([base] * N_SAMPLE, [fb_scalars[i] for i in sample])
            require([got[i] for i in sample] == want, f"fixed-base {'G2' if g2 else 'G1'} differs from the host")
            busy = ""
            if not g2:  # the card's share of a host-bound call, and madd's (32 launches a batch)
                dev_ms, parts = device_busy(lambda: backend.fixed_base(base, fb_scalars), ("madd_kernel",))
                busy = ("; device time not measured (no device time in the trace)" if dev_ms is None else
                        f"; device time a warm call {dev_ms:.2f} ms (torch.profiler), madd_kernel's "
                        f"{parts['madd_kernel']:.2f} ms of it")
            log(f"[fixed_base] {'G2' if g2 else 'G1'} {N_FB} scalars equal the native muls on {N_SAMPLE} "
                f"lanes; first {first:.2f} s (table included), warm {warm:.2f} s, "
                f"{N_FB / warm:,.0f} scalars/s{busy} on {card}")

    main_path("fixed_base", ["mont_mul", "fermat_inv", "madd"], fixed_base_path)

    # the slice: BASELINE.json configuration 1
    slice_out = {}

    def slice_path():
        backend = TorchBackend(DEVICE)
        secs = timed_methods(backend)
        circ_id, circ = slice_circuit(h)
        t = time.perf_counter()
        keys = ProvingKeys.generate(circ_id, circ, backend, lambda i: h.Rng.from_int(50 + i))
        setup_s = time.perf_counter() - t
        fb_s = secs["fixed_base_g1"] + secs["fixed_base_g2"]
        sizes = sorted({len(pk.a_g) for pk in keys.minimal_pks.values()} | {len(pk.h_g) for pk in keys.minimal_pks.values()})
        log(f"[slice] setup: {len(keys.minimal_pks)} unique CRSs in {setup_s:.1f} s, of which "
            f"{fb_s:.1f} s in TorchBackend.fixed_base ({backend.ran['fixed_base_gpu']} batches on the card; "
            f"G1 {secs['fixed_base_g1']:.1f} s, G2 {secs['fixed_base_g2']:.1f} s) and {setup_s - fb_s:.1f} s "
            f"outside it (host synthesis, QAP map); G1 MSM lengths {sizes}")
        secs["msm_g1"] = secs["msm_g2"] = 0.0
        _, resps0, resps1, ipp_ck, agg_state, wsecs = run_work(h, keys, backend, circ)
        n = circ.num_subcircuits()
        t = time.perf_counter()
        for i, r in enumerate(resps1):
            pvk = prepare_verifying_key(keys.get_pk(i).vk)
            require(verify_proof(pvk, r.proof, agg_state.public_inputs), f"proof {i} rejected")
        verify_s = time.perf_counter() - t
        t = time.perf_counter()
        agg_pk = h.AggProvingKey(h.tipa_key_from_ipp(ipp_ck), lambda i: keys.get_pk(i))
        agg_proof = agg_state.gen_agg_proof(agg_pk, resps1)
        agg_s = time.perf_counter() - t
        t = time.perf_counter()
        ok = agg_pk.verify_aggregate(h.agg_transcript(), agg_state.super_com, agg_proof, agg_state.public_inputs)
        agg_verify_s = time.perf_counter() - t
        require(ok is True, "aggregate proof rejected")
        bad = resps1[0].proof
        bad_c = bad.c
        bad.c = h.ch.pt_add(bad.c, h.ch.g1_gen())
        require(not verify_proof(prepare_verifying_key(keys.get_pk(0).vk), bad, agg_state.public_inputs),
                "a tampered proof verified")
        bad.c = bad_c
        log(f"[slice] {circ_id} {circ.get_params()} on {card}: stage0 {wsecs['stage0']:.2f} s, exec tree "
            f"{wsecs['exec_tree']:.2f} s, stage1 {wsecs['stage1']:.2f} s (G1 MSMs {secs['msm_g1']:.2f} s, "
            f"B-G2 MSMs {secs['msm_g2']:.2f} s over stages 0-1), verify {verify_s:.2f} s, aggregate "
            f"{agg_s:.2f} s, aggregate verify {agg_verify_s:.2f} s -> {ok}; tampered proof rejected")
        log(f"[slice] backend.ran {backend.ran}")
        require(set(backend.ran) == {"g1_msm_compact", "g2_msm_compact", "g1_msm_gpu", "g2_msm_gpu",
                                     "fixed_base_gpu", "witness_map_gpu"}, f"unexpected backend routes {backend.ran}")
        require(backend.ran["g2_msm_gpu"] + backend.ran["g2_msm_compact"] == n
                and all(backend.ran[k] > 0 for k in ("g1_msm_compact", "g1_msm_gpu", "fixed_base_gpu",
                                                      "witness_map_gpu")),
                f"a device route did not run: {backend.ran}")
        slice_out.update(keys=keys, circ=circ, resps0=resps0, resps1=resps1, n=n, secs=wsecs)

    main_path("slice", [k for k in kernels if k not in ROUTE_KERNELS + UNFUSED_KERNELS + BLS_KERNELS + NO_PATH_KERNELS],
              slice_path)

    host = HostBackend()
    keys, circ, n = slice_out["keys"], slice_out["circ"], slice_out["n"]
    _, h0, h1, _, _, hsecs = run_work(h, keys, host, circ)
    require([r.com for r in h0] == [r.com for r in slice_out["resps0"]],
            "stage-0 commitments differ from HostBackend's")
    for i in range(n):
        p, q = slice_out["resps1"][i].proof, h1[i].proof
        require((p.a, p.b, p.c, p.ds) == (q.a, q.b, q.c, q.ds), f"stage-1 proof {i} differs from HostBackend's")
    log(f"[slice] all {n} stage-1 proofs equal HostBackend's bit for bit (HostBackend stage1 "
        f"{hsecs['stage1']:.2f} s)")

    def mesh_path():
        mesh_phase(h, keys, circ, slice_out, card, rs)

    # stage 0 takes the ladder below MSM_LADDER_THRESHOLD points, the bucket msm above
    m0 = max(len(pk.ck.deltas_abc_g[0]) for pk in keys.minimal_pks.values())
    stage0_kernels = ["jac_ladder", "jac_sum"] + (["madd", "add", "jac_horner"] if m0 > pip.MSM_LADDER_THRESHOLD else [])
    main_path("mesh", ["mont_mul", "fermat_inv", "aff_add_fused", "l1_aff_halves", "horner_fold", "pmadd_rcb_g2",
                       "padd_rcb_g2", "horner_fold_g2", *stage0_kernels], mesh_path)
    main_path("cli", ["add", "madd", *CHAIN_KERNELS], lambda: cli_phase(card))
    path_now[0] = None
    sha256_phase(card, rs)
    if torch.distributed.is_initialized():  # the [mesh] phase's group, which the CLI's mesh run reused
        torch.distributed.destroy_process_group()

    log(f"[coverage] kernel launches over the main paths: {totals}")
    for name, widths in sorted(op_calls.items()):
        require(sum(widths.values()) == totals[name], f"{name}: {totals[name]} launches, {widths} recorded")
        log(f"[coverage] {name} launches by width on the main paths ({len(widths)} widths, "
            f"{width_lanes(name, widths)}): " + width_list(name, widths))
    require(set(op_calls) >= {"horner_fold", "horner_fold_g2", *CHAIN_KERNELS},
            f"widths recorded for {sorted(op_calls)} only")
    require(sum(g2_msms.values()) == totals["horner_fold_g2"] and "pdbl_rcb_g2" not in op_calls,
            f"G2 msm_gpu calls {g2_msms}, horner_fold_g2 launches {totals['horner_fold_g2']}, pdbl_rcb_g2 widths "
            f"{op_calls.get('pdbl_rcb_g2')}: each G2 MSM folds its windows in one launch, no one-lane double")
    require("dbl" not in op_calls and 1 not in op_calls.get("add", {}),
            "a main path launched dbl, or add on one lane: the compact msm's chains run in the chain kernels")
    path_now[0] = None
    ax, ay = torch.from_numpy(ax_np).to(DEVICE), torch.from_numpy(ay_np).to(DEVICE)
    rows += horner_rows(tf, cc, proj, bound, op_calls["horner_fold"], ax, ay)
    rows += horner_g2_rows(cc, proj, bound, op_calls["horner_fold_g2"], *g2_rows)
    rows += chain_rows(h, tf, cc, G1, bound, op_calls, host_pts, scalars, gen)
    rows += inv_rows(tf, cf, bound, inv_calls, totals, gen)
    rows += aff_rows(tf, cc, bound, aff_calls, totals, ax, ay)
    for row in rows:
        row["launches"] = totals[row["name"]]
    log(f"[done] chip_smoke ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
