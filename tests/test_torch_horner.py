"""A Python model of horner_fold's kernel (hekaton_tpu_torch/csrc/curve.cu:
horner_kernel, horner_dbl, horner_add) against the port's plain version,
the JAX package's complete projective formulas and a plain Python-int RCB
fold.

The kernel runs one warp over the chain of (W-1)(c+1) point ops. Every lane
holds the accumulator; a point op is two levels of independent Montgomery
products (a double 4 + 4, an add 6 + 6), lane h making product h of a level
(lanes past the level's width repeat one of them, and only lanes below it
write), the sums and mul9s between levels computed by every lane from the
level it reads back. A product is field.cuh's `fe_mul` on one lane, whose
word steps tests/test_torch_aff_kernels.py models; here a product is its
canonical value a b R^-1 mod p.

The model below runs the kernel's schedule, read from the kernel's source
(the operands each `pick(h, ...)` of a level gives lane h), on values
tagged with the level that made them, so that a product reading a value of
its own level or a later one fails. It is held limb for limb to
`cuda_curve.horner_fold_plain` and to the JAX package's
`ProjOps(jf.FqOps, 9)` chain (run eagerly) at small W, to the plain
Python-int RCB fold at the (W, c) of the 2^12, 2^16 and 2^20 MSMs, and on
edge window sums.

The compact msm's chain kernels run the same one-warp ops a lane. jac_ladder
(curve.cu: jac_ladder_kernel) runs horner_dbl and the two-level mixed add
horner_madd (its picks read the same way) from the top set bit of the
scalar, a (0,0) base or a zero scalar the identity. jac_sum_kernel loads a
lane's K Jacobian operands in chunks of 32 as projective points
(load_jac_proj: (X Z : Y : Z^3), a thread's own products; (0:1:0) where Z =
0) and adds them in order with horner_add from (0:1:0); jac_horner_kernel
loads its W window sums the same way and walks them as horner_kernel does
(one body, horner_walk). All three end in the Jacobian form (store_proj_jac:
(X Z, Y Z^2, Z), (1, 1, 0) at Z = 0) in two more levels. Their models are
held limb for limb to the plain versions (`cuda_curve.jac_ladder_plain`,
`jac_sum_plain`, `jac_horner_plain`) and to Python-int RCB chains on edge
lanes (a Jacobian infinity with X, Y != (1, 1), as `add` leaves an inverse
pair; an operand equal to the accumulator and one equal to its negation;
W = 1; K = 1, 32, 33 and 64), and as points to the host's results.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hekaton_tpu.curves.proj import Proj as JaxProj
from hekaton_tpu.curves.proj import ProjOps as JaxProjOps
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.torch_curve import G1, Jac
from hekaton_tpu_torch.fields import torch_field as tf

torch.set_num_threads(1)

P = tf.FQ.modulus
R = (1 << 256) % P
RINV = pow(1 << 256, -1, P)
CURVE_CU = os.path.join(os.path.dirname(__file__), "..", "hekaton_tpu_torch", "csrc", "curve.cu")
LANES = 32  # HORNER_THREADS


class Lv:
    """A field value (Montgomery form, canonical) and the product level
    that made it: 0 for the accumulator and the window sum of the op."""

    def __init__(self, v: int, lvl: int):
        self.v, self.lvl = v % P, lvl

    def __add__(self, o):
        return Lv(self.v + o.v, max(self.lvl, o.lvl))

    def __sub__(self, o):
        return Lv(self.v - o.v, max(self.lvl, o.lvl))

    def __rmul__(self, k: int):  # a small constant: additions in the kernel
        return Lv(k * self.v, self.lvl)


def body_of(head: str) -> str:
    """The source of curve.cu from `head` to the end of its function."""
    src = open(CURVE_CU).read()
    body = src[src.index(head):]
    return body[: body.index("\n}\n")]


def kernel_picks(fn: str, head: str = "__device__ Proj") -> list:
    """The argument lists of the `pick(h, ...)` calls in the body of the
    device function `fn` of curve.cu, in source order."""
    body = body_of(f"{head} {fn}(")
    return [[a.strip() for a in args.split(",")] for args in re.findall(r"pick\(h, ([^()]*)\)", body)]


def kernel_levels():
    """(double, add): per level, product h's operand names, as the kernel's
    picks give them (an add's level-1 operand is the sum of two picks, the
    second zero for the first three products)."""
    name = {"p.x": "x", "p.y": "y", "p.z": "z"}
    d = kernel_picks("horner_dbl")
    dbl = [list(zip([name.get(a, a) for a in d[0]], [name.get(b, b) for b in d[1]])),
           list(zip(d[2], d[3]))]
    a = kernel_picks("horner_add")
    rename = {"p.x": "x1", "p.y": "y1", "p.z": "z1", "q.x": "x2", "q.y": "y2", "q.z": "z2"}

    def summed(u, v):
        return [rename[s] if t == "zero" else f"{rename[s]}+{rename[t]}" for s, t in zip(u, v)]

    add = [list(zip(summed(a[0], a[1]), summed(a[2], a[3]))), list(zip(a[4], a[5]))]
    return dbl, add


def kernel_madd_levels():
    """horner_madd's two levels: product h's operand names."""
    m = kernel_picks("horner_madd")
    name = {"p.x": "x1", "p.y": "y1", "p.z": "z1", "pxy": "x1+y1"}
    return [list(zip([name.get(a, a) for a in m[0]], m[1])), list(zip(m[2], m[3]))]


def level(ops: list, vals: dict, lvl: int, lane_of) -> list:
    """One level of products on the warp: lane l makes product lane_of(l) of
    `ops` from the values it picks, lanes below len(ops) write theirs. Every
    operand must come from an earlier level."""
    n = len(ops)
    slots = [None] * n
    for lane in range(LANES):
        h = lane_of(lane)
        a, b = (vals[k] for k in ops[h])
        assert a.lvl < lvl and b.lvl < lvl, f"product {h} of level {lvl} reads a value of level {max(a.lvl, b.lvl)}"
        r = Lv(a.v * b.v * RINV, lvl)
        if lane < n:
            assert slots[lane] is None and h == lane
            slots[lane] = r
    assert all(s is not None for s in slots), "a product of the level has no lane that writes it"
    return slots


def model_dbl(acc: tuple, levels) -> tuple:
    """horner_dbl: Y^2, YZ, Z^2, XY; then t2 z3, YZ z3, t0 y3, t0 XY."""
    x, y, z = (Lv(v, 0) for v in acc)
    yy, yz, zz, xy = level(levels[0], {"x": x, "y": y, "z": z}, 1, lambda lane: lane & 3)
    t2 = 9 * zz
    z3 = 8 * yy
    vals = {"t2": t2, "yz": yz, "xy": xy, "z3": z3, "y3": yy + t2, "t0": yy - 3 * t2}
    q = level(levels[1], vals, 2, lambda lane: lane & 3)
    return (2 * q[3]).v, (q[0] + q[2]).v, q[1].v


def model_add(acc: tuple, win: tuple, levels) -> tuple:
    """horner_add: the six products of the operands and their sums, then
    the six closing products."""
    v1 = dict(zip(("x1", "y1", "z1", "x2", "y2", "z2"), (Lv(v, 0) for v in (*acc, *win))))
    v1.update({f"{s}+{t}": v1[s] + v1[t] for s in v1 for t in v1})
    m = level(levels[0], v1, 1, lambda lane: lane % 6)
    t0, t1, t2 = m[0], m[1], m[2]
    t3, t4, y3 = m[3] - (t0 + t1), m[4] - (t1 + t2), m[5] - (t0 + t2)
    t2 = 9 * t2
    vals = {"t3": t3, "t4": t4, "t0": 3 * t0, "z3": t1 + t2, "t1": t1 - t2, "y3": 9 * y3}
    q = level(levels[1], vals, 2, lambda lane: lane % 6)
    return (q[0] - q[1]).v, (q[2] + q[3]).v, (q[4] + q[5]).v


def model_madd(acc: tuple, q: tuple, levels) -> tuple:
    """horner_madd: X1 X2, Y1 Y2, (X1+Y1)(X2+Y2), Y2 Z1, X2 Z1 (lane h
    makes product min(h % 6, 4)), then the six closing products."""
    x1, y1, z1 = (Lv(v, 0) for v in acc)
    qx, qy = (Lv(v, 0) for v in q)
    vals = {"x1": x1, "y1": y1, "z1": z1, "x1+y1": x1 + y1, "qx": qx, "qy": qy, "qxy": qx + qy}
    m = level(levels[0], vals, 1, lambda lane: min(lane % 6, 4))
    t0, t1 = m[0], m[1]
    t2 = 9 * z1
    vals = {"t3": m[2] - (t0 + t1), "t4": m[3] + y1, "y3": 9 * (m[4] + x1), "t03": 3 * t0, "z3": t1 + t2,
            "t1m": t1 - t2}
    q2 = level(levels[1], vals, 2, lambda lane: lane % 6)
    return (q2[0] - q2[1]).v, (q2[2] + q2[3]).v, (q2[4] + q2[5]).v


def model_ladder(pt, s: int, nbits: int) -> tuple:
    """jac_ladder_kernel's lane: base pt (Montgomery ints, (0, 0) the
    sentinel), scalar s."""
    dbl, _ = kernel_levels()
    madd = kernel_madd_levels()
    bits = s & ((1 << nbits) - 1)
    acc = (0, R, 0)
    if pt != (0, 0):
        for j in range(bits.bit_length() - 1, -1, -1):
            acc = model_dbl(acc, dbl)
            if bits >> j & 1:
                acc = model_madd(acc, pt, madd)
    return model_store(acc)


def model_store(acc: tuple) -> tuple:
    """store_proj_jac: X Z and Z^2 (lane h makes product h & 1), then Y Z^2;
    (1, 1, 0) where Z = 0."""
    x, y, z = (Lv(v, 0) for v in acc)
    xz, zz = level([("x", "z"), ("z", "z")], {"x": x, "z": z}, 1, lambda lane: lane & 1)
    (yzz,) = level([("y", "zz")], {"y": y, "zz": zz}, 2, lambda lane: 0)
    return (R, R, 0) if z.v == 0 else (xz.v, yzz.v, z.v)


def jac_to_proj(pt: tuple) -> tuple:
    """load_jac_proj (a thread's own products, no level): Jacobian (X, Y, Z)
    -> (X Z : Y : Z^3), (0:1:0) where Z = 0."""
    x, y, z = pt
    return (0, R, 0) if z == 0 else (_mul(x, z), y, _mul(_mul(z, z), z))


def model_jac_sum(ops: list) -> tuple:
    """jac_sum_kernel's lane: the operands in chunks of LANES, thread t
    loading operand k + t into slot t, the warp adding the chunk's slots in
    order (horner_add) into the accumulator, from (0:1:0); then the store."""
    _, add = kernel_levels()
    acc = (0, R, 0)
    for k in range(0, len(ops), LANES):
        slots = [jac_to_proj(op) for op in ops[k : k + LANES]]
        for q in slots:
            acc = model_add(acc, q, add)
    return model_store(acc)


def model_jac_horner(win: list, c: int) -> tuple:
    """jac_horner_kernel: each window sum loaded (thread t takes windows t,
    t + LANES, ...), horner_kernel's walk, then the store."""
    return model_store(model_fold([jac_to_proj(w) for w in win], c))


def model_fold(win: list, c: int) -> tuple:
    """horner_kernel: from the top window down, c doublings and one add."""
    dbl, add = kernel_levels()
    acc = win[-1]
    for w in range(len(win) - 2, -1, -1):
        for _ in range(c):
            acc = model_dbl(acc, dbl)
        acc = model_add(acc, win[w], add)
    return acc


def _mul(a: int, b: int) -> int:
    return a * b * RINV % P


def rcb_dbl(p: tuple) -> tuple:
    """csrc/curve.cu::pdbl_rcb (RCB15 algorithm 9, b3 = 9), in its order."""
    x, y, z = p
    t0 = _mul(y, y)
    z3 = 8 * t0 % P
    t1 = _mul(y, z)
    t2 = 9 * _mul(z, z) % P
    x3 = _mul(t2, z3)
    y3 = (t0 + t2) % P
    z3 = _mul(t1, z3)
    t0 = (t0 - 3 * t2) % P
    y3 = (x3 + _mul(t0, y3)) % P
    return 2 * _mul(t0, _mul(x, y)) % P, y3, z3


def rcb_add(p: tuple, q: tuple) -> tuple:
    """csrc/curve.cu::padd_rcb (RCB15 algorithm 7)."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    t0, t1, t2 = _mul(x1, x2), _mul(y1, y2), _mul(z1, z2)
    t3 = (_mul(x1 + y1, x2 + y2) - t0 - t1) % P
    t4 = (_mul(y1 + z1, y2 + z2) - t1 - t2) % P
    y3 = 9 * ((_mul(x1 + z1, x2 + z2) - t0 - t2) % P) % P
    t0, t2 = 3 * t0 % P, 9 * t2 % P
    z3, t1 = (t1 + t2) % P, (t1 - t2) % P
    return (_mul(t3, t1) - _mul(t4, y3)) % P, (_mul(t1, z3) + _mul(y3, t0)) % P, (_mul(z3, t4) + _mul(t0, t3)) % P


def rcb_madd(p: tuple, q: tuple) -> tuple:
    """csrc/curve.cu::pmadd_rcb (RCB15 algorithm 8) for a finite affine q."""
    (x1, y1, z1), (x2, y2) = p, q
    t0, t1 = _mul(x1, x2), _mul(y1, y2)
    t3 = (_mul(x2 + y2, x1 + y1) - t0 - t1) % P
    t4 = (_mul(y2, z1) + y1) % P
    y3 = 9 * (_mul(x2, z1) + x1) % P
    t0, t2 = 3 * t0 % P, 9 * z1 % P
    z3, t1 = (t1 + t2) % P, (t1 - t2) % P
    return (_mul(t3, t1) - _mul(t4, y3)) % P, (_mul(t1, z3) + _mul(y3, t0)) % P, (_mul(z3, t4) + _mul(t0, t3)) % P


def rcb_ladder(pt, s: int, nbits: int) -> tuple:
    """The ladder of RCB doublings and mixed adds from (0:1:0) over every bit
    j < nbits, then (X Z, Y Z^2, Z), (1, 1, 0) at Z = 0."""
    acc = (0, R, 0)
    for j in range(nbits - 1, -1, -1):
        acc = rcb_dbl(acc)
        if s >> j & 1 and pt != (0, 0):
            acc = rcb_madd(acc, pt)
    return proj_to_jac(acc)


def proj_to_jac(acc: tuple) -> tuple:
    """(X Z, Y Z^2, Z), (1, 1, 0) at Z = 0."""
    x, y, z = acc
    return (R, R, 0) if z == 0 else (_mul(x, z), _mul(y, _mul(z, z)), z)


def rcb_fold(win: list, c: int) -> tuple:
    acc = win[-1]
    for w in range(len(win) - 2, -1, -1):
        for _ in range(c):
            acc = rcb_dbl(acc)
        acc = rcb_add(acc, win[w])
    return acc


def rcb_jac_sum(ops: list) -> tuple:
    """The in-order RCB sum of Jacobian operands from (0:1:0), each loaded
    as (X Z : Y : Z^3) ((0:1:0) at Z = 0), in the Jacobian form."""
    acc = (0, R, 0)
    for op in ops:
        acc = rcb_add(acc, jac_to_proj(op))
    return proj_to_jac(acc)


# -- window sums: ints (Montgomery form) and (W, 16) limb tensors --

def windows(W: int, seed: int) -> list:
    """W projective points k_i G with random z (Montgomery form ints)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(W):
        x, y = ch.pt_mul(ch.g1_gen(), int(rng.randint(1, 2**62)))
        z = int(rng.randint(1, 2**62)) ** 4 % P
        out.append((x * z * R % P, y * z * R % P, z * R % P))
    return out


def edge_windows(kind: str, W: int) -> list:
    """Identity (0:1:0) windows (every third, or all), every window the same
    point, or P and -P alternating."""
    win = windows(W, 3)
    if kind == "identity every third":
        return [(0, R, 0) if i % 3 == 0 else w for i, w in enumerate(win)]
    if kind == "identity all":
        return [(0, R, 0)] * W
    if kind == "all equal":
        return [win[0]] * W
    x, y, z = win[0]
    return [(x, y, z) if i % 2 == 0 else (x, P - y, z) for i in range(W)]


def _limbs(vals: list) -> torch.Tensor:
    return torch.tensor([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in vals], dtype=torch.int32)


def _int(t) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(np.asarray(t).astype(np.int64).reshape(-1)))


def plain(win: list, c: int) -> tuple:
    x, y, z = (_limbs([w[k] for w in win]) for k in range(3))
    return tuple(_int(t) for t in cc.horner_fold_plain(x, y, z, c))


JAX_PROJ_G1 = JaxProjOps(jf.FqOps, 9, "g1_proj_generic")


def jax_chains(cases: list) -> list:
    """The JAX package's complete formulas, run eagerly on one batch: lane i
    runs case i's chain (its windows, its c). The lanes share one sequence
    of ops, that of the case with the most windows and the largest c; a
    lane keeps its accumulator where its own chain has no such op (its
    windows are the last ones of that sequence, its doublings the last of
    each run)."""
    Wm, cm = max(len(w) for w, _ in cases), max(c for _, c in cases)
    win = [[w[i - (Wm - len(w))] if i >= Wm - len(w) else w[-1] for i in range(Wm)] for w, _ in cases]

    def col(i, k):
        return jnp.asarray(_limbs([w[i][k] for w in win]).numpy().view(np.uint32))

    acc = JaxProj(*(col(Wm - 1, k) for k in range(3)))

    def keep(mask, new, old):
        m = jnp.asarray(mask)[:, None]
        return JaxProj(*(jnp.where(m, a, b) for a, b in zip(new, old)))

    for w in range(Wm - 2, -1, -1):
        live = [w >= Wm - len(cw) for cw, _ in cases]
        for d in range(cm):
            acc = keep([lv and d >= cm - c for lv, (_, c) in zip(live, cases)], JAX_PROJ_G1.dbl(acc), acc)
        acc = keep(live, JAX_PROJ_G1.add(acc, JaxProj(*(col(w, k) for k in range(3)))), acc)
    return [tuple(_int(np.asarray(t)[i]) for t in acc) for i in range(len(cases))]


def test_horner_level_schedule():
    """The kernel's picks give each product its operands: a double's Y^2,
    YZ, Z^2, XY then t2 z3, YZ z3, t0 y3, t0 XY; an add's six products of
    the operands and their sums, then the six closing products; every
    product of a level is written by exactly one lane and reads only values
    of earlier levels (model_fold asserts that on every op it runs)."""
    dbl, add = kernel_levels()
    assert dbl == [[("y", "y"), ("y", "z"), ("z", "z"), ("x", "y")],
                   [("t2", "z3"), ("yz", "z3"), ("t0", "y3"), ("t0", "xy")]]
    assert add == [[("x1", "x2"), ("y1", "y2"), ("z1", "z2"), ("x1+y1", "x2+y2"), ("y1+z1", "y2+z2"),
                    ("x1+z1", "x2+z2")],
                   [("t3", "t1"), ("t4", "y3"), ("t1", "z3"), ("y3", "t0"), ("z3", "t4"), ("t0", "t3")]]
    src = open(CURVE_CU).read()
    assert re.search(r"constexpr int HORNER_THREADS = 32;", src)
    assert "const int h = threadIdx.x & 3;" in src and "const int h = threadIdx.x % 6;" in src
    win = windows(3, 1)
    assert model_fold(win, 2) == rcb_fold(win, 2)
    with pytest.raises(AssertionError, match="reads a value of level"):  # a level reading itself is caught
        level([("y", "t")], {"y": Lv(1, 0), "t": Lv(2, 1)}, 1, lambda lane: 0)


def test_horner_model_matches_plain_and_jax():
    cases = [(windows(4, 11), 3), (windows(6, 12), 4)]
    got = [model_fold(w, c) for w, c in cases]
    assert got == [plain(w, c) for w, c in cases]
    assert got == jax_chains(cases)


@pytest.mark.parametrize("log2n", [12, 16, 20])
def test_horner_model_matches_rcb_fold(log2n):
    """At the (W, c) msm_gpu gives the fold for 2^log2n points."""
    c = TorchBackend.msm_params(1 << log2n)[0]
    W = -(-254 // c)  # signed-digit windows, msm.pippenger.signed_digits_for_windows
    win = windows(W, log2n)
    win[W // 2] = (0, R, 0)  # an empty window
    assert model_fold(win, c) == rcb_fold(win, c)


@pytest.mark.parametrize("kind", ["identity every third", "identity all", "all equal", "P and -P", "W=2"])
def test_horner_model_on_edge_windows(kind):
    """Small folds against the plain version, at c=0 too (an add of equal
    points doubles, P + (-P) cancels); the same windows at W=20, c=13
    against the Python-int fold."""
    if kind == "W=2":
        small, big = windows(2, 5), windows(2, 6)
    else:
        small, big = edge_windows(kind, 6), edge_windows(kind, 20)
    for c in (0, 4):
        assert model_fold(small, c) == plain(small, c), f"c={c}"
    assert model_fold(big, 13) == rcb_fold(big, 13)


def test_ladder_model_matches_plain_and_rcb():
    """jac_ladder's kernel model at nbits = 254 limb for limb against
    jac_ladder_plain (the wrapper on CPU tensors) and the Python-int RCB
    ladder, and as points against the host multiples, on lanes with a (0,0)
    base, a zero scalar, r - 1, r (the last add an inverse pair), r + 2
    (the last add a doubling) and a random scalar."""
    from hekaton_tpu_torch.fields.bn254 import R as ORDER

    assert kernel_madd_levels() == [[("x1", "qx"), ("y1", "qy"), ("x1+y1", "qxy"), ("z1", "qy"), ("z1", "qx")],
                                    [("t3", "t1m"), ("t4", "y3"), ("t1m", "z3"), ("y3", "t03"), ("z3", "t4"),
                                     ("t03", "t3")]]
    rng = np.random.RandomState(31)
    pts = [ch.pt_mul(ch.g1_gen(), int(rng.randint(1, 2**62))) for _ in range(6)]
    pts[0] = None
    scal = [12345, 0, ORDER - 1, ORDER, ORDER + 2, int(rng.randint(1, 2**62)) ** 4 % ORDER]
    ax, ay = (torch.from_numpy(a.astype(np.int32)) for a in G1.pack_affine(pts))
    sc = torch.tensor([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in scal], dtype=torch.int32)
    got = cc.jac_ladder(ax, ay, sc, 254)
    mont = [(_int(ax[i]), _int(ay[i])) for i in range(6)]
    for i in range(6):
        want = model_ladder(mont[i], scal[i], 254)
        assert tuple(_int(t[i]) for t in got) == want, f"lane {i}"
        assert rcb_ladder(mont[i], scal[i], 254) == want, f"lane {i}"
    assert G1.unpack_jacobian(got) == [None if p is None else ch.pt_mul(p, s % ORDER) for p, s in zip(pts, scal)]


# -- the compact msm's jac_sum and jac_horner --

def jac_ints(pt, rng) -> tuple:
    """A host affine point (None the identity, (1, 1, 0)) -> Montgomery
    Jacobian ints under a random z."""
    if pt is None:
        return R, R, 0
    z = int(rng.randint(1, 2**62)) ** 4 % P
    return pt[0] * z * z * R % P, pt[1] * z ** 3 * R % P, z * R % P


def inverse_pair_inf() -> tuple:
    """What `add` leaves on an inverse pair P + (-P) (cuda_curve.add_plain):
    the generic x3 and y3, z3 = 0."""
    x, y, z = (_limbs([v]) for v in jac_ints(ch.pt_mul(ch.g1_gen(), 5), np.random.RandomState(7)))
    got = tuple(_int(t) for t in cc.add_plain(x, y, z, x, tf.neg(tf.FQ, y), z))
    assert got[2] == 0 and (got[0], got[1]) != (R, R)
    return got


def test_jac_chain_schedules():
    """The chain kernels' source as the models run it: the load a thread's
    own products with the identity set where Z = 0, before any product; the
    store's two levels (X Z and Z^2 by picks, then Y Z^2); jac_sum's chunks
    of HORNER_THREADS operands, thread t loading operand k + t, added in
    order; jac_horner's load of windows t, t + 32, ..., horner_kernel's walk
    (one body, horner_walk, which both kernels call) and the store; and the
    one store of all three chain kernels."""
    load = body_of("__device__ __forceinline__ Proj load_jac_proj(")
    marks = ["if (fe_is_zero(zz)) return Proj{fe_zero(), fe_one<FQ>(), fe_zero()};",
             "return Proj{fe_mul<FQ>(load_limbs16(x + i * 16), zz), load_limbs16(y + i * 16), "
             "fe_mul<FQ>(fe_sqr<FQ>(zz), zz)};"]
    assert [load.index(m) for m in marks] == sorted(load.index(m) for m in marks) and "level(" not in load
    store = body_of("__device__ __forceinline__ void store_proj_jac(")
    assert kernel_picks("store_proj_jac", "__device__ __forceinline__ void") == [["acc.x", "acc.z"]]
    for m in ("const int h = threadIdx.x & 1;", "level(lv[0], 2, pick(h, acc.x, acc.z), acc.z);",
              "level(lv[1], 1, acc.y, get_fe(lv[0][1]));", "inf ? fe_one<FQ>() : xz"):
        assert m in store, m
    sums = body_of("    jac_sum_kernel(const int32_t*")
    marks = ["for (int k = 0; k < K; k += HORNER_THREADS)", "const int m = min(K - k, HORNER_THREADS);",
             "if ((int)threadIdx.x < m) put_proj(chunk + 24 * threadIdx.x, load_jac_proj(x, y, z, (k + threadIdx.x) * n + i));",
             "__syncwarp();", "for (int j = 0; j < m; j++) acc = horner_add(acc, window_sum(chunk, j), lv);",
             "store_proj_jac(ox, oy, oz, i, acc, lv);"]
    assert [sums.index(m) for m in marks] == sorted(sums.index(m) for m in marks)
    horner = body_of("    jac_horner_kernel(const int32_t*")
    marks = ["for (int w = threadIdx.x; w < W; w += HORNER_THREADS) put_proj(win + 24 * w, load_jac_proj(x, y, z, w));",
             "__syncwarp();", "store_proj_jac(ox, oy, oz, 0, horner_walk(win, W, c, lv), lv);"]
    assert [horner.index(m) for m in marks] == sorted(horner.index(m) for m in marks)
    assert "horner_walk(win, W, c, lv)" in body_of("    horner_kernel(const int32_t*")
    src = open(CURVE_CU).read()
    assert src.count("horner_dbl(acc, lv)") == 2 and src.count("acc = horner_add(") == 2  # the walk, the ladder, the sum
    assert src.count("store_proj_jac(ox, oy, oz,") == 3


@pytest.mark.parametrize("K", [1, 32, 33, 64])
def test_jac_sum_model_matches_plain_and_rcb(K):
    """jac_sum's kernel model on two lanes of K operands (a chunk boundary
    at 32) limb for limb against jac_sum_plain (the wrapper on CPU tensors)
    and the Python-int RCB sum, and as points against the host's sums.
    Lane 0 starts with a Jacobian infinity with X, Y != (1, 1) (an inverse
    pair's `add` output) and holds the identity (1, 1, 0) at K // 2; in lane
    1 (K > 2) operand 1 equals the accumulator (operand 0) and operand 2 is
    its negation's double, -2 P_0, so the sum goes back to the identity."""
    rng = np.random.RandomState(K)
    host = [[ch.pt_mul(ch.g1_gen(), int(rng.randint(1, 2**62))) for _ in range(K)] for _ in range(2)]
    host[0][K // 2] = None
    if K > 2:
        host[1][1] = host[1][0]
        host[1][2] = ch.pt_neg(ch.pt_dbl(host[1][0]))
    ops = [[jac_ints(pt, rng) for pt in lane] for lane in host]
    ops[0][0], host[0][0] = inverse_pair_inf(), None
    x, y, z = (torch.stack([_limbs([op[k] for op in lane]) for lane in ops], 1) for k in range(3))
    got = cc.jac_sum(x, y, z)
    for lane in range(2):
        want = model_jac_sum(ops[lane])
        assert tuple(_int(t[lane]) for t in got) == want, f"lane {lane}"
        assert rcb_jac_sum(ops[lane]) == want, f"lane {lane}"
    sums = [None, None]
    for lane in range(2):
        for pt in host[lane]:
            sums[lane] = ch.pt_add(sums[lane], pt)
    assert G1.unpack_jacobian(got) == sums


@pytest.mark.parametrize("W, c", [(1, 3), (6, 2)])
def test_jac_horner_model_matches_plain_and_rcb(W, c):
    """jac_horner's kernel model limb for limb against jac_horner_plain (the
    wrapper on CPU tensors) and the Python-int RCB fold between the same
    load and store, and as a point against the host's sum: at W = 1 (the
    load and the store alone) and at W = 6, c = 2 on edge windows: window
    W-2 is 2^c S_(W-1) (the first add doubles), W-3 is -2^(2c+1) S_(W-1)
    (the second gives the identity), window 1 an inverse pair's `add`
    output and window 0 the identity (1, 1, 0)."""
    rng = np.random.RandomState(40 + W)
    ws = [ch.pt_mul(ch.g1_gen(), int(rng.randint(1, 2**62))) for _ in range(W)]
    if W >= 6:
        ws[W - 2] = ch.pt_mul(ws[W - 1], 1 << c)
        ws[W - 3] = ch.pt_neg(ch.pt_mul(ws[W - 1], 1 << (2 * c + 1)))
        ws[0] = ws[1] = None
    win = [jac_ints(pt, rng) for pt in ws]
    if W >= 6:
        win[1] = inverse_pair_inf()
    got = cc.jac_horner(*(_limbs([w[k] for w in win]) for k in range(3)), c)
    want = model_jac_horner(win, c)
    assert tuple(_int(t) for t in got) == want
    assert proj_to_jac(rcb_fold([jac_to_proj(w) for w in win], c)) == want
    host = None
    for w, pt in enumerate(ws):
        host = ch.pt_add(host, None if pt is None else ch.pt_mul(pt, 1 << (c * w)))
    assert G1.unpack_jacobian(Jac(*(t[None] for t in got))) == [host]
