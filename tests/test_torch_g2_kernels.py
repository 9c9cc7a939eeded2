"""A plain Python model of the split G2 kernels' per-thread arithmetic
(hekaton_tpu_torch/csrc/curve_g2.cu: pmadd_rcb_g2_kernel, padd_rcb_g2_kernel,
pdbl_rcb_g2_kernel) against the port's plain Fq2 formulas and the JAX
package's G2 projective formulas.

The kernels run two threads a lane; thread k computes the c_k half of every
Fq2 value. An Fq2 product's half is a sum of two 8x8-word products into a
16-word accumulator and one Montgomery reduction (`mac_row`'s two carry
chains under `mac_wide` and `redc_wide`, `mac_f2`), c0 = a0 b0 + a1 (p - b1) and c1 = a0 b1 + a1 b0, and RCB's
closing sums of two Fq2 products are one 4-term accumulation and one
reduction (the double's closing y3 = t2 z3 + t0 y3 too). The model below
repeats those word steps in Python ints, in the kernels' round order, with
each thread's view of the operands (both components of the first, its own
and its partner's half of the second), and checks the bounds they rest on
(a lazy sum of k products below k p^2 <= 4 p^2, no carry out of 16 words, a
reduction below 2p). The kernels themselves are held to the plain versions
on the card by chip_smoke.py; here the model is held, exactly, to
`Fq2Plain.mul`, to cuda_curve's plain pmadd/padd/pdbl (CPU tensors) and to
the JAX package's `ProjOps(jf.Fq2Ops, 3*B_G2)`, run eagerly (a jit compiles
~40 s on XLA:CPU).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hekaton_tpu.curves.host as jch
from hekaton_tpu.curves.proj import Proj as JaxProj
from hekaton_tpu.curves.proj import ProjOps as JaxProjOps
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.proj import PROJ_G2, Proj
from hekaton_tpu_torch.curves.torch_curve import G2
from hekaton_tpu_torch.fields import torch_field as tf

torch.set_num_threads(1)

P = tf.FQ.modulus
MASK = (1 << 32) - 1
NINV = -pow(P, -1, 1 << 32) % (1 << 32)  # csrc/field.cuh NINV[FQ]
P_WORDS = [(P >> (32 * i)) & MASK for i in range(8)]
MONT_ONE = (1 << 256) % P


def _words(x: int) -> list:
    return [(x >> (32 * i)) & MASK for i in range(8)]


def mac_row(T: list, i: int, v: list, s: int, e_in: int) -> int:
    """T[i..i+8] += s v (v as 8 words) plus e_in at word i+8, in the
    kernel's two carry chains: v's even words, then its odd words one word
    up (field.cuh::mac_row<8>). Returns the carries owed to word i+9."""
    e_out = 0
    for h in (0, 1):
        cf = 0
        for j in range(h, 8, 2):
            p = v[j] * s
            for w, part in ((i + j, p & MASK), (i + j + 1, p >> 32)):
                x = T[w] + part + cf
                T[w], cf = x & MASK, x >> 32
        if h == 0:
            x = T[i + 8] + e_in + cf
            T[i + 8], e_out = x & MASK, x >> 32
    return e_out + cf


def mac_wide(T: list, a: int, b: int) -> None:
    """T (16 words) += a b, row i adding a_i b at word i (field.cuh::mac_wide)."""
    aw, bw, e = _words(a), _words(b), 0
    for i in range(8):
        e = mac_row(T, i, bw, aw[i], e)
    assert e == 0, "the accumulator left 16 words"


def redc_wide(T: list, terms: int = 2) -> int:
    """T R^-1 mod p: row i adds m p at word i, m = T_i (-p^-1) mod 2^32
    (field.cuh::redc_wide); T is a lazy sum of `terms` products of values
    below p."""
    assert sum(w << (32 * i) for i, w in enumerate(T)) < terms * P * P <= 4 * P * P
    e = 0
    for i in range(8):
        e = mac_row(T, i, P_WORDS, T[i] * NINV & MASK, e)
        assert T[i] == 0
    t = sum(w << (32 * i) for i, w in enumerate(T[8:])) + (e << 256)
    assert t < 2 * P, "a reduction above 2p"
    return t - P if t >= P else t


def _neg(x: int) -> int:
    return P - x if x else 0  # fe_sub(0, x)


def mac_f2(T: list, k: int, x: tuple, y: tuple, neg: bool = False) -> None:
    """T += the k-th half of x y (of -x y when neg), as thread k adds it: x's
    two components, y's own half and the partner's, c0 = x0 y0 + x1 (p - y1),
    c1 = x0 y1 + x1 y0 (curve_g2.cu::mac_f2)."""
    b, bo = y[k], y[1 - k]
    mac_wide(T, x[0], _neg(b) if neg else b)
    mac_wide(T, x[1], _neg(bo) if (k == 0) != neg else bo)


def f2_mul(a: tuple, b: tuple) -> tuple:
    """Both threads of f2_mul_half."""
    out = []
    for k in (0, 1):
        T = [0] * 16
        mac_f2(T, k, a, b)
        out.append(redc_wide(T))
    return tuple(out)


def f2_dot(a: tuple, b: tuple, c: tuple, d: tuple, neg: bool = False) -> tuple:
    """a b + c d (a b - c d when neg) with one reduction a half (rcb_close)."""
    out = []
    for k in (0, 1):
        T = [0] * 16
        mac_f2(T, k, a, b)
        mac_f2(T, k, c, d, neg)
        out.append(redc_wide(T, 4))
    return tuple(out)


def f2_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def f2_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def rcb_close(t0, t1, t3, t4, y3, z3):
    return f2_dot(t3, t1, t4, y3, neg=True), f2_dot(t1, z3, y3, t0), f2_dot(z3, t4, t0, t3)


def pmadd_model(px, py, pz, qx, qy):
    """pmadd_half's rounds: six products, b3 y3, the three closing sums."""
    t0 = f2_mul(px, qx)
    t1 = f2_mul(py, qy)
    t3 = f2_sub(f2_mul(f2_add(qx, qy), f2_add(px, py)), f2_add(t0, t1))
    t4 = f2_add(f2_mul(qy, pz), py)
    y3 = f2_add(f2_mul(qx, pz), px)
    t0 = f2_add(f2_add(t0, t0), t0)
    t2 = f2_mul(pz, B3)
    z3 = f2_add(t1, t2)
    t1 = f2_sub(t1, t2)
    y3 = f2_mul(y3, B3)
    out = rcb_close(t0, t1, t3, t4, y3, z3)
    return (px, py, pz) if qy == (0, 0) else out


def padd_model(x1, y1, z1, x2, y2, z2):
    """padd_half's rounds."""
    t0, t1, t2 = f2_mul(x1, x2), f2_mul(y1, y2), f2_mul(z1, z2)
    t3 = f2_sub(f2_mul(f2_add(x1, y1), f2_add(x2, y2)), f2_add(t0, t1))
    t4 = f2_sub(f2_mul(f2_add(y1, z1), f2_add(y2, z2)), f2_add(t1, t2))
    y3 = f2_sub(f2_mul(f2_add(x1, z1), f2_add(x2, z2)), f2_add(t0, t2))
    t0 = f2_add(f2_add(t0, t0), t0)
    t2 = f2_mul(t2, B3)
    z3 = f2_add(t1, t2)
    t1 = f2_sub(t1, t2)
    y3 = f2_mul(y3, B3)
    return rcb_close(t0, t1, t3, t4, y3, z3)


def pdbl_model(x, y, z):
    """pdbl_half's rounds: Y^2, Z^2, YZ, XY from the inputs; t2 = b3 Z^2,
    y3 = Y^2 + t2, t0 = Y^2 - 3 t2 (z3 = 8 Y^2); the closing t2 z3 + t0 y3
    as one 4-term sum, t1 z3, 2 t0 XY."""
    t0 = f2_mul(y, y)
    zz, t1, xy = f2_mul(z, z), f2_mul(y, z), f2_mul(x, y)
    z3 = f2_add(t0, t0)
    z3 = f2_add(z3, z3)
    z3 = f2_add(z3, z3)
    t2 = f2_mul(zz, B3)
    y3 = f2_add(t0, t2)
    t0 = f2_sub(t0, f2_add(f2_add(t2, t2), t2))
    x3 = f2_mul(t0, xy)
    return f2_add(x3, x3), f2_dot(t2, z3, t0, y3), f2_mul(t1, z3)


# -- conversions: (n, 2, 16) limb tensors <-> per-lane (c0, c1) ints --

_SHIFTS = [1 << (16 * i) for i in range(16)]


def _ints(t: torch.Tensor) -> list:
    a = t.numpy().astype(np.int64)
    return [tuple(sum(int(v) * s for v, s in zip(row[c], _SHIFTS)) for c in (0, 1)) for row in a]


def _tensor(vals: list) -> torch.Tensor:
    return torch.from_numpy(np.array([[[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in pair]
                                      for pair in vals], dtype=np.int32))


def _jax(t: torch.Tensor):
    return jnp.asarray(t.numpy().view(np.uint32))


JAX_PROJ_G2 = JaxProjOps(jf.Fq2Ops, jch.B_G2 * 3, "g2_proj_generic")
B3 = _ints(PROJ_G2._b3[None])[0]  # 9/(9+u), Montgomery form


def _rand_fq2(rng, n: int) -> list:
    return [(int(rng.randint(0, 2**62)) * int(rng.randint(0, 2**62)) ** 3 % P,
             int(rng.randint(0, 2**62)) ** 4 % P) for _ in range(n)]


def _lanes():
    """Projective P and affine / projective Q per lane: generic pairs, P + P
    (Q = P), P + (-P), the identity accumulator (0 : y : 0), the (0,0)
    sentinel operand (identity in projective), and lanes whose coordinates
    are 0, 1 and p-1 (not points: the formulas are identities on any
    canonical input)."""
    rng = np.random.RandomState(20261017)
    ks = [int(k) for k in rng.randint(1, 2**30, size=4)]
    ps = [ch.pt_mul(ch.g2_gen(), k) for k in ks[:2]]
    qs = [ch.pt_mul(ch.g2_gen(), k) for k in ks[2:]]
    aff_p = ps + [ps[0], ps[1], ps[0], ps[1]]
    aff_q = qs + [ps[0], ch.pt_neg(ps[1]), qs[0], None]
    px, py = (_ints(torch.from_numpy(a)) for a in G2.pack_affine(aff_p))
    qx, qy = (_ints(torch.from_numpy(a)) for a in G2.pack_affine(aff_q))
    n = len(aff_p)
    z1, z2 = _rand_fq2(rng, n), _rand_fq2(rng, n)
    P1 = [list(map(f2_mul, px, z1)), list(map(f2_mul, py, z1)), list(z1)]
    Q1 = [list(map(f2_mul, qx, z2)), list(map(f2_mul, qy, z2)), list(z2)]
    P1[0][4], P1[2][4] = (0, 0), (0, 0)  # identity accumulator (0 : y z : 0)
    Q1[0][5], Q1[1][5], Q1[2][5] = (0, 0), (MONT_ONE, 0), (0, 0)  # Q = (0 : 1 : 0)
    edge = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1), (1, P - 1), (P - 1, 0)]
    for i, v in enumerate(edge):  # raw values in every coordinate
        P1 = [c + [edge[(i + j) % len(edge)]] for j, c in enumerate(P1)]
        Q1 = [c + [edge[(i + j + 2) % len(edge)]] for j, c in enumerate(Q1)]
        qx.append(edge[(i + 3) % len(edge)])
        qy.append(v if v != (0, 0) else (1, 1))
    return P1, Q1, qx, qy


def test_fq2_product_model_matches_fq2plain():
    """The component-split product with its lazy reduction, on seeded pairs,
    on 0, 1 and p-1, and on pairs whose a0 b0 < a1 b1 (c0 wraps below 0)."""
    rng = np.random.RandomState(7)
    a, b = _rand_fq2(rng, 24), _rand_fq2(rng, 24)
    edge = [0, 1, P - 1, P // 2]
    a += [(x, y) for x in edge for y in edge]
    b += [(y, x) for x in edge for y in edge]
    a += [(3, P - 2), (1, 1 << 250), (0, 5)]  # a0 b0 < a1 b1
    b += [(5, P - 7), (2, 1 << 251), (9, 9)]
    wrapped = sum(x[0] * y[0] < x[1] * y[1] for x, y in zip(a, b))
    assert wrapped >= 10
    want = _ints(tf.Fq2Plain.mul(_tensor(a), _tensor(b)))
    assert [f2_mul(x, y) for x, y in zip(a, b)] == want
    # a b + c d with one reduction equals the sum of two reduced products
    c, d = b[::-1], a[::-1]
    assert [f2_dot(*v) for v in zip(a, b, c, d)] == _ints(
        tf.Fq2Plain.add(tf.Fq2Plain.mul(_tensor(a), _tensor(b)), tf.Fq2Plain.mul(_tensor(c), _tensor(d))))
    # the 4-term bound: every term below p^2, the sum below 4 p^2 < p 2^256
    assert 4 * P < 1 << 256


@pytest.mark.parametrize("op", ["pmadd", "padd", "pdbl"])
def test_rcb_g2_model_matches_plain_and_jax(op):
    P1, Q1, qx, qy = _lanes()
    if op == "pdbl":  # every lane's P, the identity accumulator and the raw-value lanes among them
        args = [_tensor(c) for c in P1]
        model = [pdbl_model(*lane) for lane in zip(*P1)]
        plain = cc.pdbl_rcb_g2_plain(*args)
        jax_out = JAX_PROJ_G2.dbl(JaxProj(*(_jax(a) for a in args)))
    elif op == "pmadd":
        args = [_tensor(c) for c in P1] + [_tensor(qx), _tensor(qy)]
        model = [pmadd_model(*lane) for lane in zip(*P1, qx, qy)]
        plain = cc.pmadd_rcb_g2_plain(*args)
        jax_out = JAX_PROJ_G2.add_mixed(JaxProj(*(_jax(a) for a in args[:3])), _jax(args[3]), _jax(args[4]))
    else:
        args = [_tensor(c) for c in P1 + Q1]
        model = [padd_model(*lane) for lane in zip(*P1, *Q1)]
        plain = cc.padd_rcb_g2_plain(*args)
        jax_out = JAX_PROJ_G2.add(JaxProj(*(_jax(a) for a in args[:3])), JaxProj(*(_jax(a) for a in args[3:])))
    for i, (got, exp) in enumerate(zip(zip(*model), plain)):
        assert list(got) == _ints(exp), f"{op} coordinate {i}"
    for got, exp in zip(plain, jax_out):
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(exp))
    if op == "pmadd":  # the sentinel lane keeps P; the points agree with the host
        assert [model[5][c] for c in range(3)] == [P1[c][5] for c in range(3)]
    n_pts = 6
    got_pts = G2.unpack_jacobian(PROJ_G2.to_jacobian(Proj(*(a[:n_pts] for a in plain))))
    if op == "pdbl":  # 2 P on the point lanes, the identity stays the identity
        assert got_pts[4] is None and all(got_pts[i] is not None for i in (0, 1, 2, 3, 5))
        return
    assert got_pts[3] is None  # P + (-P)
    assert got_pts[4] is not None and got_pts[2] is not None  # inf + Q, P + P
