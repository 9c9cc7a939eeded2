"""A Python model of the BN254 G1 complete mixed add, complete add and
complete doubling of the port's kernels (hekaton_tpu_torch/csrc/curve.cu:
the device functions pmadd_rcb under pmadd_rcb_kernel and
l1_rcb_mega_kernel, padd_rcb under padd_rcb_kernel and pdbl_rcb under
pdbl_rcb_kernel) against the port's plain versions, the JAX package's
projective formulas and plain Python-int RCB15 formulas.

The kernels run one thread a lane (a slab column for the mega kernel) on
lazy sums: values between the products need not be canonical, and each
closing coordinate of the adds (x3 = t3 t1 - t4 y3, y3 = t1 z3 + y3 t0, z3
= z3 t4 + t0 t3), and the doubling's y3 = t2 z3 + t0 y3, is one sum of two
products and one reduction. The model reads each op's steps from the
kernel's source (the statements of pmadd_rcb, padd_rcb and pdbl_rcb, and
the mega kernel's first point into the identity) and runs them on values
that carry the interval their words may hold, so that every lazy sum is
checked at its worst case: below 2^256 as 8 words, a product's 16-word sum
below p 2^256 (where one reduction and one conditional subtraction give
the canonical value), and each bound comment of the source at least the
model's. The op's products and closing sums run word for word in the
kernel's column form (curve.cu::col_dot: each column of the 16-word sum in a
three-word accumulator, the reduction's m_k p added column by column), the
first point of the mega kernel on field.cuh's row chains (`mac_row` under
`mac_wide`, `redc_wide`). The model is held limb
for limb to `cuda_curve.pmadd_rcb_plain`, `padd_rcb_plain` and
`pdbl_rcb_plain`, to the JAX package's `PROJ_G1.add_mixed`, `PROJ_G1.add`
and `PROJ_G1.dbl` (run eagerly) and to Python-int RCB15 formulas on the
completeness lanes, and its mega chain to `l1_rcb_mega_plain` and the JAX
`_level1_rows(PROJ_G1, ...)` in both slab layouts. The kernels themselves
are held to the plain versions on the card by chip_smoke.py.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hekaton_tpu.curves.proj import PROJ_G1 as JPROJ_G1
from hekaton_tpu.curves.proj import Proj as JProj
from hekaton_tpu.msm.pippenger import _level1_rows as j_level1_rows
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.affine import AFF_G1, Aff
from hekaton_tpu_torch.curves.torch_curve import G1
from hekaton_tpu_torch.fields import torch_field as tf

import chip_smoke

torch.set_num_threads(1)

P = tf.FQ.modulus
MASK = (1 << 32) - 1
NINV = -pow(P, -1, 1 << 32) % (1 << 32)  # csrc/field.cuh NINV[FQ]
P_WORDS = [(P >> (32 * i)) & MASK for i in range(8)]
R = (1 << 256) % P
RINV = pow(1 << 256, -1, P)
CURVE_CU = os.path.join(os.path.dirname(__file__), "..", "hekaton_tpu_torch", "csrc", "curve.cu")


# -- field.cuh's carry chains, word for word --


def mac_row(T: list, i: int, v: list, s: int, e_in: int) -> int:
    """T[i..i+8] += s v (v as 8 words) plus e_in at word i+8, in two carry
    chains: v's even words, then its odd words one word up
    (field.cuh::mac_row<8>). Returns the carries owed to word i+9."""
    e_out = 0
    for h in (0, 1):
        cf = 0
        for j in range(h, 8, 2):
            prod = v[j] * s
            for w, part in ((i + j, prod & MASK), (i + j + 1, prod >> 32)):
                x = T[w] + part + cf
                T[w], cf = x & MASK, x >> 32
        if h == 0:
            x = T[i + 8] + e_in + cf
            T[i + 8], e_out = x & MASK, x >> 32
    return e_out + cf


def words(x: int) -> list:
    assert 0 <= x < 1 << 256, "a value left 8 words"
    return [(x >> (32 * i)) & MASK for i in range(8)]


def mac_wide(T: list, a: int, b: int) -> None:
    """T (16 words) += a b, row i adding a_i b at word i (field.cuh::mac_wide)."""
    aw, bw, e = words(a), words(b), 0
    for i in range(8):
        e = mac_row(T, i, bw, aw[i], e)
    assert e == 0, "the accumulator left 16 words"


def redc_wide(T: list) -> int:
    """T R^-1 mod p for T < p 2^256 (field.cuh::redc_wide): row i adds m p at
    word i, m = T_i (-p^-1) mod 2^32, which clears word i; the rest is below
    2p, and one conditional subtraction (reduce_once) ends it."""
    assert sum(w << (32 * i) for i, w in enumerate(T)) < P << 256, "a sum at or above p 2^256"
    e = 0
    for i in range(8):
        e = mac_row(T, i, P_WORDS, T[i] * NINV & MASK, e)
        assert T[i] == 0
    t = sum(w << (32 * i) for i, w in enumerate(T[8:])) + (e << 256)
    assert t < 2 * P, "a reduction above 2p"
    return t - P if t >= P else t


def row_words(pairs: list) -> int:
    """sum of a b over `pairs` in one 16-word accumulator, one reduction
    (field.cuh's row chains)."""
    T = [0] * 16
    for a, b in pairs:
        mac_wide(T, a, b)
    return redc_wide(T)


def col_words(pairs: list) -> int:
    """(sum of a b over `pairs`) R^-1 mod p by product scanning
    (curve.cu::col_dot): column k gathers the word products a_i b_(k-i) and
    m_i p_(k-i) into (lo, hi, c2), each 64-bit product into (lo, hi) and its
    carry into c2; columns 0-7 set m_k = lo (-p^-1) mod 2^32 and add m_k p_0,
    which clears lo; columns 8-14 give the result's words, the last
    accumulator its word 7 and the bit above. Asserts the sum below p 2^256,
    c2 within its word, every low column cleared and the result below 2p."""
    assert sum(a * b for a, b in pairs) < P << 256, "a sum at or above p 2^256"
    A, B = [words(a) for a, _ in pairs], [words(b) for _, b in pairs]
    m, r = [0] * 8, [0] * 8
    acc = [0, 0, 0]  # lo, hi, c2

    def mad(x: int, y: int) -> None:
        prod = x * y
        s = acc[0] + (prod & MASK)
        acc[0], cf = s & MASK, s >> 32
        s = acc[1] + (prod >> 32) + cf
        acc[1], cf = s & MASK, s >> 32
        acc[2] += cf
        assert acc[2] <= MASK, "a column's carries left their word"

    for k in range(15):
        for a, b in zip(A, B):
            for i in range(max(0, k - 7), min(k, 7) + 1):
                mad(a[i], b[k - i])
        for i in range(max(0, k - 7), min(k, 8)):
            mad(m[i], P_WORDS[k - i])
        if k < 8:
            m[k] = acc[0] * NINV & MASK
            mad(m[k], P_WORDS[0])
            assert acc[0] == 0
        else:
            r[k - 8] = acc[0]
        acc = [acc[1], acc[2], 0]
    r[7] = acc[0]
    t = sum(w << (32 * i) for i, w in enumerate(r)) + (acc[1] << 256)
    assert t < 2 * P, "a reduction above 2p"
    return t - P if t >= P else t


# -- values with the interval of their words --


class V:
    """A field element as the kernel holds it: an integer below 2^256 (not
    always below p) and the interval [lo, hi] it may take on any input whose
    coordinates are canonical."""

    def __init__(self, v: int, lo: int, hi: int):
        assert lo <= v <= hi < 1 << 256, f"{v} outside [{lo}, {hi}] or 8 words"
        self.v, self.lo, self.hi = v, lo, hi

    @staticmethod
    def canonical(v: int):
        return V(v, 0, P - 1)


def _canonical_only(*xs):
    for x in xs:
        assert x.hi < P, "a modular addition of a lazy value"


def fe_mul(a, b):  # field.cuh's row product (the mega kernel's first point)
    assert a.hi * b.hi < P << 256, "a product's worst case at or above p 2^256"
    return V.canonical(row_words([(a.v, b.v)]))


def fe_sqr(a):
    return fe_mul(a, a)


def col_mul(a, b):  # curve.cu::col_mul, the op's products
    assert a.hi * b.hi < P << 256, "a product's worst case at or above p 2^256"
    return V.canonical(col_words([(a.v, b.v)]))


def fe_dot(a, b, c, d):
    """a b + c d in one sum, one reduction (curve.cu::fe_dot, col_dot)."""
    assert a.hi * b.hi + c.hi * d.hi < P << 256, "a closing sum's worst case at or above p 2^256"
    return V.canonical(col_words([(a.v, b.v), (c.v, d.v)]))


def fe_add(a, b):
    _canonical_only(a, b)
    return V.canonical((a.v + b.v) % P)


def fe_sub(a, b):
    _canonical_only(a, b)
    return V.canonical((a.v - b.v) % P)


def mul9(a):  # four modular additions (curve.cu::mul9)
    _canonical_only(a)
    return V.canonical(9 * a.v % P)


def lazy_add(a, b):
    return V(a.v + b.v, a.lo + b.lo, a.hi + b.hi)


def lazy_sub(a, b):
    """a + p - b on words mod 2^256: exact only when it stays in [0, 2^256)."""
    assert a.lo + P - b.hi >= 0 and a.hi + P - b.lo < 1 << 256
    return V(a.v + P - b.v, a.lo + P - b.hi, a.hi + P - b.lo)


def lazy_neg(b):
    _canonical_only(b)
    return V(P - b.v, P - b.hi, P - b.lo)


# -- the kernel's source, run on the model --

OPS = {"fe_mul": fe_mul, "fe_sqr": fe_sqr, "col_mul": col_mul, "fe_dot": fe_dot, "fe_add": fe_add, "fe_sub": fe_sub,
       "mul9": mul9, "lazy_add": lazy_add, "lazy_sub": lazy_sub, "lazy_neg": lazy_neg}


def _body(head: str) -> str:
    src = open(CURVE_CU).read()
    body = src[src.index(head):]
    return body[body.index("{") + 1 : body.index("\n}\n")]


def _python(stmt: str) -> str:
    """One C statement of the op as Python: no types or template arguments,
    members as names (p.x -> p_x)."""
    stmt = re.sub(r"\b(const\s+)?(Fe|Proj)\s+(?=\w+\s*=)", "", stmt.strip())
    stmt = stmt.replace("<FQ>", "")
    return re.sub(r"\b(\w+)\.(\w)\b", r"\1_\2", stmt)


def kernel_steps(head: str = "__device__ __forceinline__ Proj pmadd_rcb(") -> list:
    """The statements of the device function `head` (curve.cu; pmadd_rcb by
    default) as Python, each with the bound its comment states: ('lt', k)
    for `// < k` (units of p), ('in', (a, b)) for `// (a, b)`, None where it
    states none."""
    steps, pending = [], ""
    for line in _body(head).splitlines():
        code, _, comment = line.partition("//")
        pending += " " + code
        if not code.strip().endswith(";"):
            continue
        stmt, pending = pending.strip().rstrip(";"), ""
        if stmt in ("Proj r", "return r"):
            continue
        m = re.match(r"\s*<\s*(\d+)\s*$", comment)
        m2 = re.match(r"\s*\((\d+),\s*(\d+)\)\s*$", comment)
        bound = ("lt", int(m.group(1))) if m else ("in", (int(m2.group(1)), int(m2.group(2)))) if m2 else None
        steps.append((_python(stmt), bound))
    return steps


STEPS = kernel_steps()
PADD_STEPS = kernel_steps("__device__ __forceinline__ Proj padd_rcb(")
PDBL_STEPS = kernel_steps("__device__ __forceinline__ Proj pdbl_rcb(")


def run_steps(steps: list, env: dict) -> dict:
    """Run a device function's steps in `env` (OPS and its inputs), every
    bound comment checked against the model's interval; returns env."""
    for stmt, bound in steps:
        exec(stmt, {}, env)
        name = stmt.split("=")[0].strip()
        if bound is not None:
            val = env[name]
            if bound[0] == "lt":
                assert val.hi < bound[1] * P, f"{stmt}: bound < {bound[1]} p does not hold"
            else:
                assert bound[1][0] * P < val.lo and val.hi < bound[1][1] * P, f"{stmt}: bound {bound[1]} p"
    return env


def worst_case_ops() -> dict:
    """OPS whose products and closing sums also run word for word in the
    column form on the largest words their operands may hold (each interval's
    top), asserting that sum below p 2^256 and its reduction exact."""
    def mul(a, b):
        assert col_words([(a.hi, b.hi)]) == a.hi * b.hi * RINV % P
        return col_mul(a, b)

    def dot(a, b, c, d):
        top = a.hi * b.hi + c.hi * d.hi
        assert col_words([(a.hi, b.hi), (c.hi, d.hi)]) == top * RINV % P
        return fe_dot(a, b, c, d)

    return dict(OPS, col_mul=mul, fe_dot=dot)


def model_op(px, py, pz, ax, ay):
    """pmadd_rcb on canonical inputs, its steps from the source; every bound
    comment checked against the model's interval."""
    env = run_steps(STEPS, dict(OPS, p_x=V.canonical(px), p_y=V.canonical(py), p_z=V.canonical(pz),
                                ax=V.canonical(ax), ay=V.canonical(ay)))
    return env["r_x"].v, env["r_y"].v, env["r_z"].v


def model_padd(p, q):
    """padd_rcb (and padd_rcb_kernel, which has no escape) on canonical
    projective inputs, its steps from the source."""
    env = dict(OPS, **{f"{n}_{c}": V.canonical(v) for n, pt in (("p", p), ("q", q)) for c, v in zip("xyz", pt)})
    env = run_steps(PADD_STEPS, env)
    return env["r_x"].v, env["r_y"].v, env["r_z"].v


def model_pdbl(p):
    """pdbl_rcb (and pdbl_rcb_kernel, which has no branch) on canonical
    projective inputs, its steps from the source."""
    env = run_steps(PDBL_STEPS, dict(OPS, **{f"p_{c}": V.canonical(v) for c, v in zip("xyz", p)}))
    return env["r_x"].v, env["r_y"].v, env["r_z"].v


def model_pmadd(px, py, pz, ax, ay):
    """pmadd_rcb_kernel: the (0,0) sentinel lanes (ay = 0) keep P."""
    return (px, py, pz) if ay == 0 else model_op(px, py, pz, ax, ay)


def model_first(ax, ay):
    """The mega kernel's first point Q into the identity, as its source
    writes it (the `acc = Proj{...}` of its first loop)."""
    body = _body("l1_rcb_mega_kernel(")
    expr = re.search(r"acc = Proj\{(.*?)\};", body).group(1)
    env = dict(OPS, q_x=V.canonical(ax), q_y=V.canonical(ay))
    return tuple(x.v for x in eval("(" + _python(expr) + ")", {}, env))


def model_mega(rows: list, L: int) -> tuple:
    """l1_rcb_mega_kernel on one column's L packed elements (x, y ints, in
    the order the kernel loads them): a sentinel row keeps the sum, the
    first point goes in by model_first, every later one by the op."""
    acc, fresh = (0, R, 0), True
    for x, y in rows[:L]:
        if y == 0:
            continue
        acc = model_first(x, y) if fresh else model_op(*acc, x, y)
        fresh = False
    return acc


# -- the references: plain Python-int RCB15 --


def rcb15_mixed(p, q):
    """RCB15 Algorithm 8 (a = 0, b3 = 9) in Python ints on plain (not
    Montgomery) coordinates; q = None is the (0,0) sentinel, which keeps p."""
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2 = q
    t0, t1 = x1 * x2 % P, y1 * y2 % P
    t3 = ((x2 + y2) * (x1 + y1) - t0 - t1) % P
    t4 = (y2 * z1 + y1) % P
    y3 = (x2 * z1 + x1) % P
    t0 = 3 * t0 % P
    t2 = 9 * z1 % P
    z3 = (t1 + t2) % P
    t1 = (t1 - t2) % P
    y3 = 9 * y3 % P
    return ((t3 * t1 - t4 * y3) % P, (t1 * z3 + y3 * t0) % P, (z3 * t4 + t0 * t3) % P)


def rcb15_add(p, q):
    """RCB15 Algorithm 7 (a = 0, b3 = 9) in Python ints on plain (not
    Montgomery) projective coordinates."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0, t1, t2 = x1 * x2 % P, y1 * y2 % P, z1 * z2 % P
    t3 = ((x1 + y1) * (x2 + y2) - t0 - t1) % P
    t4 = ((y1 + z1) * (y2 + z2) - t1 - t2) % P
    y3 = ((x1 + z1) * (x2 + z2) - t0 - t2) % P
    t0 = 3 * t0 % P
    t2 = 9 * t2 % P
    z3 = (t1 + t2) % P
    t1 = (t1 - t2) % P
    y3 = 9 * y3 % P
    return ((t3 * t1 - t4 * y3) % P, (t1 * z3 + y3 * t0) % P, (z3 * t4 + t0 * t3) % P)


def to_mont(v: int) -> int:
    return v * R % P


def from_mont(v: int) -> int:
    return v * RINV % P


# -- lanes --

_SHIFTS = [1 << (16 * i) for i in range(16)]


def _ints(t: torch.Tensor) -> list:
    return [sum(int(v) * s for v, s in zip(row, _SHIFTS)) for row in t.numpy().astype(np.int64)]


def _tensor(vals: list) -> torch.Tensor:
    return torch.from_numpy(tf.FQ.pack(vals, mont=False).astype(np.int32))


def _j(t: torch.Tensor):
    return jnp.asarray(t.numpy().view(np.uint32))


def _lanes():
    """Montgomery (x, y, z) of P and (ax, ay) of Q per lane: random points
    under random z, P = Q, P = -Q, P = the identity (0:1:0) and (0:z:0),
    the (0,0) sentinel, the identity plus the sentinel; and lanes whose
    coordinates are 0, 1, p-1 and 2^253 (not points: the formulas are
    identities on any canonical input, and these reach the lazy sums'
    largest words)."""
    rng = np.random.RandomState(20261018)
    g = ch.g1_gen()
    ps = [ch.pt_mul(g, int(k)) for k in rng.randint(1, 2**62, size=12)]
    qs = [ch.pt_mul(g, int(k)) for k in rng.randint(1, 2**62, size=12)]
    qs[4], qs[5] = ps[4], ch.pt_neg(ps[5])  # P = Q, P = -Q
    ps[6] = ps[7] = ps[9] = None  # the identity accumulator
    qs[8] = qs[9] = None  # the (0,0) sentinel
    zs = [int.from_bytes(rng.bytes(32), "little") % P for _ in ps]
    zs[6] = 1  # (0:1:0), ProjOps.inf
    P1 = [tuple(to_mont(c) for c in ((0, z, 0) if p is None else (p[0] * z % P, p[1] * z % P, z)))
          for p, z in zip(ps, zs)]
    Q1 = [(0, 0) if q is None else (to_mont(q[0]), to_mont(q[1])) for q in qs]
    edge = [0, 1, P - 1, 1 << 253, P - 2, R]
    for i in range(len(edge)):
        P1.append(tuple(edge[(i + j) % len(edge)] for j in range(3)))
        Q1.append((edge[(i + 3) % len(edge)], edge[(i + 4) % len(edge)] or P - 1))
    return P1, Q1, ps, qs


def test_lazy_bounds_hold_at_their_worst_case():
    """Every lazy value of the op at the top of its interval: each closing
    sum and product below p 2^256 word for word in the column form, its
    reduction canonical and equal to the sum of the products times R^-1;
    the bound comments hold (the model checks them)."""
    assert 5 * P < 1 << 256  # the closing sums' 5 p^2 < p 2^256
    top = V(P - 1, 0, P - 1)
    env = dict(OPS, p_x=top, p_y=top, p_z=top, ax=top, ay=top)
    lazy = {}
    for stmt, _ in STEPS:
        exec(stmt, {}, env)
        name = stmt.split("=")[0].strip()
        if env[name].hi >= P:
            lazy[name] = env[name]
    assert {k: (v.lo, v.hi) for k, v in lazy.items()} == {"t4": (0, 2 * P - 2), "z3": (0, 2 * P - 2),
                                                          "t1": (1, 2 * P - 1)}
    closing = [m.group(1) for m in (re.fullmatch(r"r_\w = fe_dot\((.*)\)", s) for s, _ in STEPS) if m]
    assert len(closing) == 3
    for args in closing:  # each closing sum on the largest words its operands may hold
        names = [a.strip() for a in re.split(r",\s*(?![^()]*\))", args)]
        his = [(env[n].hi if n in env else P) for n in names]  # lazy_neg(y3) reaches p
        assert his[0] * his[1] + his[2] * his[3] < P << 256
        assert col_words([(his[0], his[1]), (his[2], his[3])]) == (his[0] * his[1] + his[2] * his[3]) * RINV % P
    # the operands of the first level's one lazy product: (ax + ay)(X1 + Y1) < 4 p^2
    assert col_words([(2 * P - 2, 2 * P - 2)]) == (2 * P - 2) ** 2 * RINV % P
    # a product just below the limit p 2^256 (its second operand above 2^255), and the row and
    # column forms on the largest canonical product
    b = (P << 256) // (P - 1) - P
    assert (P - 1) * b < P << 256 and b > 1 << 255
    assert col_words([(P - 1, b)]) == (P - 1) * b * RINV % P
    assert row_words([(P - 1, P - 1)]) == col_words([(P - 1, P - 1)]) == (P - 1) ** 2 * RINV % P


def test_model_matches_plain_jax_and_python_rcb():
    P1, Q1, ps, qs = _lanes()
    args = [_tensor([p[c] for p in P1]) for c in range(3)] + [_tensor([q[c] for q in Q1]) for c in range(2)]
    model = [model_pmadd(*p, *q) for p, q in zip(P1, Q1)]
    plain = cc.pmadd_rcb_plain(*args)
    for c in range(3):
        assert [m[c] for m in model] == _ints(plain[c]), f"coordinate {c} against pmadd_rcb_plain"
    jax_out = JPROJ_G1.add_mixed(JProj(*(_j(a) for a in args[:3])), _j(args[3]), _j(args[4]))
    for got, exp in zip(plain, jax_out):
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(exp))
    for i, (p, q) in enumerate(zip(P1, Q1)):  # every lane, points or not
        want = rcb15_mixed(tuple(from_mont(c) for c in p), None if q[1] == 0 else tuple(from_mont(c) for c in q))
        assert tuple(from_mont(c) for c in model[i]) == want, f"lane {i} against the Python-int RCB15 add"
    # the point lanes are the host's sums: P = -Q and the identity plus the sentinel give the identity
    for i, (p, q) in enumerate(zip(ps, qs)):
        x, y, z = (from_mont(c) for c in model[i])
        got = None if z == 0 else (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P)
        assert got == ch.pt_add(p, q), f"lane {i} is not P + Q"


def _padd_lanes():
    """Montgomery projective (x, y, z) of P and of Q per lane: random points
    under random z, P = Q (each under its own z), P = -Q, P, Q or both the
    identity ((0:1:0) or (0:z:0)); and lanes whose coordinates are 0, 1,
    p-1, 2^253, p-2 and R (not points: the formulas are identities on any
    canonical input, and these reach the lazy sums' largest words)."""
    rng = np.random.RandomState(20261019)
    g = ch.g1_gen()
    ps = [ch.pt_mul(g, int(k)) for k in rng.randint(1, 2**62, size=10)]
    qs = [ch.pt_mul(g, int(k)) for k in rng.randint(1, 2**62, size=10)]
    qs[3], qs[4] = ps[3], ch.pt_neg(ps[4])  # P = Q, P = -Q
    ps[5] = ps[7] = None
    qs[6] = qs[7] = None
    lanes = []
    for pts, one in ((ps, 5), (qs, 6)):  # (0:1:0) on lanes 5 and 6, (0:z:0) on lane 7
        zs = [int.from_bytes(rng.bytes(32), "little") % P for _ in pts]
        zs[one] = 1
        lanes.append([tuple(to_mont(c) for c in ((0, z, 0) if pt is None else (pt[0] * z % P, pt[1] * z % P, z)))
                      for pt, z in zip(pts, zs)])
    P1, Q1 = lanes
    edge = [0, 1, P - 1, 1 << 253, P - 2, R]
    for i in range(len(edge)):
        P1.append(tuple(edge[(i + j) % len(edge)] for j in range(3)))
        Q1.append(tuple(edge[(i + j + 3) % len(edge)] for j in range(3)))
    return P1, Q1, ps, qs


def _calls(text: str, fn: str) -> list:
    """The argument lists of every call of `fn` in `text`."""
    out = []
    for m in re.finditer(rf"\b{fn}\(", text):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        out.append([a.strip() for a in re.split(r",\s*(?![^()]*\))", text[m.end() : i - 1])])
    return out


def op_counts(steps: list) -> tuple:
    """(wide products, squares among them, reductions) of a device
    function's steps: col_mul one product (a square where its operands are
    one value) and one reduction, fe_dot two and one."""
    text = " ".join(s for s, _ in steps)
    muls, dots = _calls(text, "col_mul"), _calls(text, "fe_dot")
    return len(muls) + 2 * len(dots), sum(a == b for a, b in muls), len(muls) + len(dots)


def test_padd_lazy_bounds_hold_at_their_worst_case():
    """padd_rcb at the top of every interval: each product and closing sum
    below p 2^256 word for word in the column form on the largest words its
    operands may hold (worst_case_ops), the bound comments held (run_steps);
    the lazy values are t4, z3 and t1, each below 2p; the op takes the 12
    wide products and 9 reductions chip_smoke.py's bound counts."""
    top = V(P - 1, 0, P - 1)
    env = dict(worst_case_ops(), **{f"{n}_{c}": top for n in "pq" for c in "xyz"})
    lazy = {}
    for step in PADD_STEPS:
        run_steps([step], env)
        name = step[0].split("=")[0].strip()
        if env[name].hi >= P:
            lazy[name] = (env[name].lo, env[name].hi)
    assert lazy == {"t4": (1, 2 * P - 1), "z3": (0, 2 * P - 2), "t1": (1, 2 * P - 1)}
    assert sum(bool(re.fullmatch(r"r_\w = fe_dot\(.*\)", s)) for s, _ in PADD_STEPS) == 3
    wide, squares, reductions = op_counts(PADD_STEPS)
    assert (wide, squares, reductions) == (12, 0, 9)
    assert chip_smoke.LAZY_G1_PRODUCTS["padd_rcb"] == chip_smoke.lazy_products(wide, reductions)


def test_padd_model_matches_plain_jax_and_python_rcb():
    P1, Q1, ps, qs = _padd_lanes()
    args = [_tensor([p[c] for p in P1]) for c in range(3)] + [_tensor([q[c] for q in Q1]) for c in range(3)]
    model = [model_padd(p, q) for p, q in zip(P1, Q1)]
    plain = cc.padd_rcb_plain(*args)
    for c in range(3):
        assert [m[c] for m in model] == _ints(plain[c]), f"coordinate {c} against padd_rcb_plain"
    jax_out = JPROJ_G1.add(JProj(*(_j(a) for a in args[:3])), JProj(*(_j(a) for a in args[3:])))
    for got, exp in zip(plain, jax_out):
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(exp))
    for i, (p, q) in enumerate(zip(P1, Q1)):  # every lane, points or not
        want = rcb15_add(tuple(from_mont(c) for c in p), tuple(from_mont(c) for c in q))
        assert tuple(from_mont(c) for c in model[i]) == want, f"lane {i} against the Python-int RCB15 add"
    # the point lanes are the host's sums: P = -Q and the identity plus the identity give the identity
    for i, (p, q) in enumerate(zip(ps, qs)):
        x, y, z = (from_mont(c) for c in model[i])
        got = None if z == 0 else (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P)
        assert got == ch.pt_add(p, q), f"lane {i} is not P + Q"


def rcb15_dbl(p):
    """RCB15 Algorithm 9 (a = 0, b3 = 9) in Python ints on plain (not
    Montgomery) projective coordinates."""
    x, y, z = p
    t0, t1, t2 = y * y % P, y * z % P, 9 * z * z % P
    z3 = 8 * t0 % P
    x3, y3 = t2 * z3 % P, (t0 + t2) % P
    z3 = t1 * z3 % P
    t0 = (t0 - 3 * t2) % P
    y3 = (x3 + t0 * y3) % P
    return 2 * t0 * (x * y % P) % P, y3, z3


def _pdbl_lanes():
    """Montgomery projective (x, y, z) per lane, 16 lanes (the add lanes'
    width, so the eager JAX ops reuse their shapes): random points under
    random z and under z = 1, the identity (0:1:0) and (0:z:0); and lanes
    whose coordinates are 0, 1, p-1, 2^253, p-2 and R (not points: the
    formula is an identity on any canonical input, and these reach the lazy
    sums' largest words)."""
    rng = np.random.RandomState(20261020)
    g = ch.g1_gen()
    ps = [ch.pt_mul(g, int(k)) for k in rng.randint(1, 2**62, size=10)]
    ps[6] = ps[7] = None
    zs = [int.from_bytes(rng.bytes(32), "little") % P for _ in ps]
    zs[3] = zs[4] = zs[6] = 1  # Z = 1 on two points; (0:1:0) on lane 6, (0:z:0) on lane 7
    lanes = [tuple(to_mont(c) for c in ((0, z, 0) if pt is None else (pt[0] * z % P, pt[1] * z % P, z)))
             for pt, z in zip(ps, zs)]
    edge = [0, 1, P - 1, 1 << 253, P - 2, R]
    lanes += [tuple(edge[(i + j) % len(edge)] for j in range(3)) for i in range(len(edge))]
    return lanes, ps


def test_pdbl_lazy_bounds_hold_at_their_worst_case():
    """pdbl_rcb at the top of every interval: each product and the closing
    sum below p 2^256 word for word in the column form on the largest words
    its operands may hold (worst_case_ops), the bound comments held
    (run_steps); the named lazy values are 4 t0 and z3 = 8 t0 (below 2p and
    4p; the operand 2 X is inline); the op takes the 8 wide products (2 of
    them squares) and 7 reductions chip_smoke.py's bound counts."""
    assert 4 * P < 1 << 256 and 5 * P < 1 << 256  # z3's 4p; the closing sum's 5 p^2 < p 2^256
    top = V(P - 1, 0, P - 1)
    env = dict(worst_case_ops(), p_x=top, p_y=top, p_z=top)
    lazy = {}
    for step in PDBL_STEPS:
        run_steps([step], env)
        name = step[0].split("=")[0].strip()
        if env[name].hi >= P:
            lazy[name] = (env[name].lo, env[name].hi)
    assert lazy == {"t0x4": (0, 2 * P - 2), "z3": (0, 4 * P - 4)}
    closing = [m.group(1) for m in (re.fullmatch(r"r_\w = fe_dot\((.*)\)", s) for s, _ in PDBL_STEPS) if m]
    assert closing == ["t2, z3, t0m, y3"]
    his = [env[n].hi for n in ("t2", "z3", "t0m", "y3")]
    assert his[0] * his[1] + his[2] * his[3] == 5 * (P - 1) ** 2 < P << 256
    # the inline operand 2 X of the first product: (2 X) Y < 2 p^2
    assert col_words([(2 * P - 2, P - 1)]) == (2 * P - 2) * (P - 1) * RINV % P
    wide, squares, reductions = op_counts(PDBL_STEPS)
    assert (wide, squares, reductions) == (8, 2, 7)
    assert chip_smoke.LAZY_G1_PRODUCTS["pdbl_rcb"] == chip_smoke.lazy_products(wide - squares, reductions,
                                                                              squares=squares)


def test_pdbl_kernel_rows_and_no_branch():
    """pdbl_rcb_kernel is one thread a lane under the adds' register cap, on
    16-byte rows (the wrapper aligns them), with no branch beyond the lane
    guard (the formula is complete: the identity maps to itself); the
    4-byte row loads it used are gone with it."""
    src = open(CURVE_CU).read()
    head = "__global__ void __launch_bounds__(THREADS, RCB_MIN_BLOCKS)\n    pdbl_rcb_kernel(const int32_t*"
    assert head in src
    body = _body("    pdbl_rcb_kernel(const int32_t*")
    assert "pdbl_rcb(Proj{" + ", ".join(f"load_limbs16({c} + i * 16)" for c in "xyz") + "})" in body
    assert [f"store_limbs16(o{c} + i * 16, r.{c});" in body for c in "xyz"] == [True] * 3
    assert " if " not in body.replace("if (i >= n) return;", "") and "?" not in body
    assert " if " not in _body("__device__ __forceinline__ Proj pdbl_rcb(")
    assert "load_proj(" not in src and "store_proj(" not in src


def test_pdbl_model_matches_plain_jax_and_python_rcb():
    """The model on every lane, and again on its own output (each point
    doubled twice), limb for limb against pdbl_rcb_plain and the JAX
    PROJ_G1.dbl (eager), in plain coordinates against Python-int RCB15 and
    test_torch_horner's Montgomery Python-int rcb_dbl, and on the point
    lanes against the host's 2P and 4P."""
    from test_torch_horner import rcb_dbl

    lanes, ps = _pdbl_lanes()
    args = [_tensor([p[c] for p in lanes]) for c in range(3)]
    jp = JProj(*(_j(a) for a in args))
    for twice in (False, True):
        model = [model_pdbl(p) for p in lanes]
        plain = cc.pdbl_rcb_plain(*args)
        for c in range(3):
            assert [m[c] for m in model] == _ints(plain[c]), f"coordinate {c} against pdbl_rcb_plain ({twice=})"
        jp = JPROJ_G1.dbl(jp)
        for got, exp in zip(plain, jp):
            assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(exp))
        for i, p in enumerate(lanes):  # every lane, points or not
            assert model[i] == rcb_dbl(p), f"lane {i} against the Montgomery Python-int RCB15 double"
            want = rcb15_dbl(tuple(from_mont(c) for c in p))
            assert tuple(from_mont(c) for c in model[i]) == want, f"lane {i} against the Python-int RCB15 double"
        lanes, args = model, list(plain)
        ps = [ch.pt_add(p, p) for p in ps]
        for i, p in enumerate(ps):  # the point lanes are the host's doubles; the identity stays the identity
            x, y, z = (from_mont(c) for c in lanes[i])
            assert (None if z == 0 else (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P)) == p, f"lane {i}"
    assert [lanes[i][2] for i in (6, 7)] == [0, 0] and all(lanes[i][1] for i in (6, 7))


def _slab(L: int, ncols: int = 7):
    """A (ncols, L*16) packed slab of random multiples of G with repeats,
    negations and (0,0) sentinel rows anywhere in a column (the first row
    too), one all-sentinel column; each column's host sum."""
    r = np.random.RandomState(100 + L)
    g = ch.g1_gen()
    pool = [ch.pt_mul(g, int(k)) for k in r.randint(1, 2**62, size=4)]
    pool += [ch.pt_neg(a) for a in pool] + [None, None]
    cols = [[pool[i] for i in r.randint(0, len(pool), size=L)] for _ in range(ncols)]
    cols[0] = [None] * L
    cols[1][:3] = [None, pool[0], pool[0]]  # a sentinel first, then a doubling step
    cols[2][:2] = [pool[1], pool[5]]  # P then -P: the identity mid-column
    slab = np.zeros((ncols, L * 16), np.int32)
    for j, col in enumerate(cols):
        ax, ay = G1.pack_affine(col)
        slab[j] = AFF_G1.pack_rows(Aff(torch.from_numpy(ax), torch.from_numpy(ay))).numpy().reshape(-1)
    return torch.from_numpy(slab), [ch.msm_host(c, [1] * L) for c in cols]


def _packed_ints(words: np.ndarray) -> tuple:
    """A packed element's 16 words (8 x-words, 8 y-words) -> (x, y)."""
    w = [int(v) & MASK for v in words]
    return sum(v << (32 * i) for i, v in enumerate(w[:8])), sum(v << (32 * i) for i, v in enumerate(w[8:]))


@pytest.mark.parametrize("L", [6, 5])
def test_mega_chain_matches_plain_and_jax_level1_rows(L):
    slab, want = _slab(L)
    ncols = slab.shape[0]
    slab_t = slab.t().contiguous()
    # the kernel's loads: rows layout v[c*L*16 + i*16 + w], transposed v[(i*16 + w)*ncols + c]
    rows_layout = [[_packed_ints(slab.numpy()[c, i * 16 : (i + 1) * 16]) for i in range(L)] for c in range(ncols)]
    tr_layout = [[_packed_ints(slab_t.numpy()[i * 16 : (i + 1) * 16, c]) for i in range(L)] for c in range(ncols)]
    assert rows_layout == tr_layout
    model = [model_mega(col, L) for col in rows_layout]
    for tr, v in ((False, slab), (True, slab_t)):
        plain = cc.l1_rcb_mega_plain(v, L, transposed=tr)
        for c in range(3):
            assert [m[c] for m in model] == _ints(plain[c]), f"coordinate {c}, transposed={tr}"
    jax_out = j_level1_rows(JPROJ_G1, _j(slab), ncols, L, (16,))
    for c in range(3):
        assert [m[c] for m in model] == [int(sum(int(v) << (16 * i) for i, v in enumerate(row)))
                                         for row in np.asarray(jax_out[c]).astype(np.int64)]
    for m, w in zip(model, want):
        x, y, z = (from_mont(c) for c in m)
        assert (None if z == 0 else (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P)) == w
    # the first point into the identity is the op's own result there
    x, y = rows_layout[3][0]
    assert model_first(x, y) == model_op(0, R, 0, x, y)
