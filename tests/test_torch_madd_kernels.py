"""A Python model of the BN254 G1 Jacobian mixed add of the port's madd kernel
(hekaton_tpu_torch/csrc/curve.cu: madd_kernel on the device functions
madd_diffs and madd_finish, with madd_dbl_lane's doubling escape) against
the port's plain version, the JAX package's Jacobian mixed add and a plain
Python-int madd-2007-bl.

The kernel takes _madd_tiles' edge overrides as branches, in its order: P
at infinity (z1 = 0) gives (ax, ay, 1), or (0, 0, 0) for the (0,0) sentinel
Q, before any product; Q the sentinel with P finite gives P; Q = P takes
the doubling escape (dbl-2009-l on P); an inverse pair keeps the generic x3
and y3 and zeroes z3. The generic lane runs madd-2007-bl on lazy sums and
column products: z3 = (z1 + h)^2 - z1z1 - hh as the same value 2 z1 h, and
y3 = r2 (v - x3) - 2 y1 j as one sum of two products and one reduction.
The model reads the two device functions' statements from the source and
runs them on values that carry the interval their words may hold
(tests/test_torch_rcb_kernels.py's V and column form), so every lazy value,
product and closing sum is checked at its worst case and each `// < k`
comment is held. It is held limb for limb to `cuda_curve.madd_plain` on
every lane (chip_smoke.g1_edge_lanes' five edge kinds among them), to a
Python-int madd-2007-bl with the same overrides, and as points to the host
sums and to the JAX `jax_curve` G1 `add_mixed` (run eagerly). The kernel
itself is held to the plain version on the card by chip_smoke.py.
"""
import numpy as np
import torch

import test_torch_rcb_kernels as rk
from hekaton_tpu.curves.jax_curve import G1 as JG1
from hekaton_tpu.curves.jax_curve import Jac as JaxJac
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch

import chip_smoke

torch.set_num_threads(1)

P, R, RINV = rk.P, rk.R, rk.RINV
V = rk.V
DIFFS = rk.kernel_steps("__device__ __forceinline__ void madd_diffs(")
FINISH = rk.kernel_steps("__device__ __forceinline__ void madd_finish(")


def mm(a: int, b: int) -> int:
    """A Montgomery product of canonical values (field.cuh's fe_mul / fe_sqr)."""
    return a * b * RINV % P


def model_jac_dbl(x: int, y: int, z: int) -> tuple:
    """curve.cu::jac_dbl (dbl-2009-l, a = 0) on Montgomery values: the
    doubling escape's result, canonical."""
    a, b = mm(x, x), mm(y, y)
    c = mm(b, b)
    d0 = mm((x + b) % P, (x + b) % P)
    d = 2 * (d0 - a - c) % P
    e = 3 * a % P
    x3 = (mm(e, e) - 2 * d) % P
    y3 = (mm(e, (d - x3) % P) - 8 * c) % P
    return x3, y3, mm(2 * y % P, z)


def model_madd(x1, y1, z1, qx, qy) -> tuple:
    """madd_kernel on one lane of canonical Montgomery inputs: its branches,
    and the steps of madd_diffs and madd_finish from the source, every bound
    comment checked (rk.run_steps)."""
    q_inf = qx == 0 and qy == 0
    if z1 == 0:
        return qx, qy, 0 if q_inf else R
    if q_inf:
        return x1, y1, z1
    ins = {k: V.canonical(v) for k, v in zip(("x1", "y1", "z1", "qx", "qy"), (x1, y1, z1, qx, qy))}
    env = rk.run_steps(DIFFS, dict(rk.OPS, **ins))
    h, rr = env["h"], env["rr"]
    if h.v == 0 and rr.v == 0:
        return model_jac_dbl(x1, y1, z1)
    env = rk.run_steps(FINISH, dict(rk.OPS, x1=ins["x1"], y1=ins["y1"], z1=ins["z1"], h=h, rr=rr))
    return env["x3"].v, env["y3"].v, 0 if h.v == 0 else env["z3"].v


def madd_2007_bl(p, q) -> tuple:
    """madd-2007-bl (a = 0) with _madd_tiles' overrides, in Python ints on
    plain (not Montgomery) coordinates: the reference of the whole lane."""
    x1, y1, z1 = p
    ax, ay = q
    q_inf = ax == 0 and ay == 0
    if z1 == 0:
        return ax, ay, 0 if q_inf else 1
    if q_inf:
        return p
    z1z1 = z1 * z1 % P
    h = (ax * z1z1 - x1) % P
    rr = (ay * z1 * z1z1 - y1) % P
    if h == 0 and rr == 0:  # dbl-2009-l
        a, b = x1 * x1 % P, y1 * y1 % P
        c = b * b % P
        d = 2 * ((x1 + b) ** 2 - a - c) % P
        e = 3 * a % P
        x3 = (e * e - 2 * d) % P
        return x3, (e * (d - x3) - 8 * c) % P, 2 * y1 * z1 % P
    hh = h * h % P
    i = 4 * hh % P
    j, r2, v = h * i % P, 2 * rr % P, x1 * i % P
    x3 = (r2 * r2 - j - 2 * v) % P
    y3 = (r2 * (v - x3) - 2 * y1 * j) % P
    z3 = ((z1 + h) ** 2 - z1z1 - hh) % P
    return x3, y3, 0 if h == 0 else z3


def _lanes():
    """Montgomery Jacobian (x z^2, y z^3, z) of P and affine (ax, ay) of Q per
    lane: random points under random z with g1_edge_lanes' five edge kinds
    (P = inf as (1, 1, 0), Q = (0,0), Q = P, Q = -P, both), P = inf as
    (0, 0, 0); and lanes whose coordinates are 0, 1, p-1, 2^253, p-2 and R
    (not points: the formulas are identities on any canonical input, and
    these reach the lazy values' largest words)."""
    rng = np.random.RandomState(20261020)
    g = ch.g1_gen()
    ps = [ch.pt_mul(g, int(k)) for k in rng.randint(1, 2**62, size=10)]
    qs = [ch.pt_mul(g, int(k)) for k in rng.randint(1, 2**62, size=10)]
    ps[0] = ps[4] = ps[5] = None  # P = inf
    qs[1] = qs[4] = None  # Q = (0,0)
    qs[2], qs[3] = ps[2], ch.pt_neg(ps[3])  # Q = P, Q = -P
    P1 = []
    for i, pt in enumerate(ps):
        z = int.from_bytes(rng.bytes(32), "little") % P
        jac = (0, 0, 0) if i == 5 else (1, 1, 0) if pt is None else (pt[0] * z * z % P, pt[1] * z ** 3 % P, z)
        P1.append(tuple(rk.to_mont(c) for c in jac))
    Q1 = [(0, 0) if q is None else (rk.to_mont(q[0]), rk.to_mont(q[1])) for q in qs]
    edge = [0, 1, P - 1, 1 << 253, P - 2, R]
    for i in range(len(edge)):
        P1.append(tuple(edge[(i + j) % len(edge)] or 1 for j in range(3)))  # z != 0: the generic path
        Q1.append((edge[(i + 3) % len(edge)], edge[(i + 4) % len(edge)] or P - 1))
    return P1, Q1, ps, qs


def test_madd_lazy_bounds_hold_at_their_worst_case():
    """madd_diffs and madd_finish at the top of every interval: each product
    and the closing sum below p 2^256 word for word in the column form on
    the largest words its operands may hold, the bound comments held; the
    lazy values are hh2, i4 and r2 (i4 below 4p); the kernel takes the
    products and reductions chip_smoke.py's bound counts but one product
    that the least formula squares, on a generic lane
    and on a doubling lane (madd_diffs, then jac_dbl)."""
    top = V(P - 1, 0, P - 1)
    env = dict(rk.worst_case_ops(), x1=top, y1=top, z1=top, qx=top, qy=top)
    lazy = {}
    for step in DIFFS + FINISH:
        rk.run_steps([step], env)
        name = step[0].split("=")[0].strip()
        if env[name].hi >= P:
            lazy[name] = (env[name].lo, env[name].hi)
    assert lazy == {"hh2": (0, 2 * P - 2), "i4": (0, 4 * P - 4), "r2": (0, 2 * P - 2)}
    assert 4 * P < 1 << 256  # i4 stays 8 words
    diffs = rk.op_counts(DIFFS)
    wide, squares, reductions = (a + b for a, b in zip(diffs, rk.op_counts(FINISH)))
    assert (wide, squares, reductions) == (11, 3, 10)
    lazy_products = chip_smoke.lazy_products
    # the bound counts madd-2007-bl's least work: the kernel's z3 = 2 z1 h as (z1 + h)^2 - z1z1 - hh, a square
    assert chip_smoke.LAZY_G1_PRODUCTS["madd"] == lazy_products(wide - squares - 1, reductions, squares=squares + 1)
    dbl_wide, dbl_squares, dbl_reductions = rk.op_counts(rk.kernel_steps("__device__ __forceinline__ void jac_dbl("))
    assert (dbl_wide, dbl_squares, dbl_reductions) == (7, 2, 6)
    assert chip_smoke.LAZY_G1_PRODUCTS["madd_dbl"] == (  # the doubling at its least: e = 3 x^2 from a square
        lazy_products(diffs[0] - diffs[1], diffs[2], squares=diffs[1])
        + lazy_products(dbl_wide - dbl_squares - 1, dbl_reductions, squares=dbl_squares + 1))


def test_madd_model_matches_plain_python_and_jax():
    body = rk._body("madd_kernel(")
    marks = ["if (fe_is_zero(z1))", "if (!q_inf)", "madd_diffs(", "madd_dbl_lane(", "madd_finish(",
             "if (same_x) z3 = fe_zero();"]
    at = [body.index(m) for m in marks]
    assert at == sorted(at), "madd_kernel's branches are not in _madd_tiles' order"
    P1, Q1, ps, qs = _lanes()
    args = [rk._tensor([p[c] for p in P1]) for c in range(3)] + [rk._tensor([q[c] for q in Q1]) for c in range(2)]
    model = [model_madd(*p, *q) for p, q in zip(P1, Q1)]
    plain = cc.madd_plain(*args)
    for c in range(3):
        assert [m[c] for m in model] == rk._ints(plain[c]), f"coordinate {c} against madd_plain"
    for i, (p, q) in enumerate(zip(P1, Q1)):  # every lane, points or not
        want = madd_2007_bl(tuple(rk.from_mont(c) for c in p), tuple(rk.from_mont(c) for c in q))
        assert tuple(rk.from_mont(c) for c in model[i]) == want, f"lane {i} against madd-2007-bl in Python ints"
    # the point lanes are the host's sums, and the JAX package's Jacobian mixed add as points
    n = len(ps)
    for i, (p, q) in enumerate(zip(ps, qs)):
        x, y, z = (rk.from_mont(c) for c in model[i])
        zi = pow(z, -1, P) if z else 0
        assert (None if z == 0 else (x * zi * zi % P, y * zi ** 3 % P)) == ch.pt_add(p, q), f"lane {i}"
    ref = JG1.add_mixed(JaxJac(*(rk._j(a[:n]) for a in args[:3])), rk._j(args[3][:n]), rk._j(args[4][:n]))
    assert JG1.unpack_jacobian(ref) == [ch.pt_add(p, q) for p, q in zip(ps, qs)]
