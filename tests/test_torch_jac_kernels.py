"""A Python model of the BN254 G1 Jacobian doubling and add of the port's dbl
and add kernels (hekaton_tpu_torch/csrc/curve.cu: dbl_kernel on the device
function jac_dbl, add_kernel on add_diffs and madd_finish with the doubling
escape madd_dbl_lane; the chain kernels' jac_add on the same functions)
against the port's plain versions, the JAX package's Pallas bodies and
plain Python-int formulas.

jac_dbl is dbl-2009-l on lazy sums and column products: d = 2((x + b)^2 - a
- c) as the same value 4 x b, e = 3 x^2 as x (3 x), and y3 = e (d - x3) - 8
c as one sum of two products, -8 c = (2 b) 4 (p - b). The add takes
_add_tiles' overrides as branches, in its order: P at infinity gives Q's
limbs (two infinities too), Q at infinity gives P, Q = P the doubling
escape (dbl-2009-l on P), an inverse pair the generic x3 and y3 with z3 = 0;
the generic lane is add-2007-bl as madd-2007-bl's finish on u1, s1 and z1
z2. The model reads the device functions' statements from the source and
runs them on values that carry their words' interval (the V and column form
of tests/test_torch_rcb_kernels.py), so each `// < k` comment and each
16-word sum's worst case (< p 2^256) is checked. It is held limb for limb
to `cuda_curve.dbl_plain` and `add_plain` on chip_smoke.g1_edge_lanes' five
edge kinds and on lanes at the words' extremes, to Python-int formulas with
the same overrides, and to the JAX `_dbl_tiles` and `_add_tiles` (called
eagerly on transposed limbs). The kernels themselves are held to the plain
versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_rcb_kernels as rk
from hekaton_tpu.curves import pallas_curve as pc
from hekaton_tpu_torch import host as th
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.torch_curve import G1
from hekaton_tpu_torch.fields import torch_field as tf

import chip_smoke

torch.set_num_threads(1)

P, R = rk.P, rk.R
V = rk.V


def lazy_x4(a):
    """curve.cu::lazy_x4: 4 a with no reduction, below 2^256."""
    return V(4 * a.v, 4 * a.lo, 4 * a.hi)


OPS = dict(rk.OPS, lazy_x4=lazy_x4)
DBL = rk.kernel_steps("__device__ __forceinline__ void jac_dbl(")
ADD_DIFFS = rk.kernel_steps("__device__ __forceinline__ void add_diffs(")
FINISH = rk.kernel_steps("__device__ __forceinline__ void madd_finish(")


def model_dbl(x: int, y: int, z: int) -> tuple:
    """jac_dbl on canonical Montgomery inputs, its steps from the source."""
    env = rk.run_steps(DBL, dict(OPS, x=V.canonical(x), y=V.canonical(y), z=V.canonical(z)))
    return env["x3"].v, env["y3"].v, env["z3"].v


def model_add(p: tuple, q: tuple) -> tuple:
    """add_kernel on one lane: its branches, then add_diffs and madd_finish
    from the source."""
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    ins = {f"{c}{k}": V.canonical(v) for k, pt in (("1", p), ("2", q)) for c, v in zip("xyz", pt)}
    env = rk.run_steps(ADD_DIFFS, dict(OPS, **ins))
    h, rr = env["h"], env["rr"]
    if h.v == 0 and rr.v == 0:
        return model_dbl(*p)
    env = rk.run_steps(FINISH, dict(OPS, x1=env["u1"], y1=env["s1"], z1=env["z1z2"], h=h, rr=rr))
    return env["x3"].v, env["y3"].v, 0 if h.v == 0 else env["z3"].v


def dbl_2009_l(x1, y1, z1) -> tuple:
    """dbl-2009-l (a = 0) in Python ints on plain coordinates."""
    a, b = x1 * x1 % P, y1 * y1 % P
    c = b * b % P
    d = 2 * ((x1 + b) ** 2 - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return x3, (e * (d - x3) - 8 * c) % P, 2 * y1 * z1 % P


def add_2007_bl(p, q) -> tuple:
    """add-2007-bl (a = 0) with _add_tiles' overrides, in Python ints on
    plain coordinates."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    if z1 == 0:
        return q
    if z2 == 0:
        return p
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 * z2z2 % P, y2 * z1 * z1z1 % P
    h, rr = (u2 - u1) % P, (s2 - s1) % P
    if h == 0 and rr == 0:
        return dbl_2009_l(x1, y1, z1)
    i = (2 * h) ** 2 % P
    j, r2, v = h * i % P, 2 * rr % P, u1 * i % P
    x3 = (r2 * r2 - j - 2 * v) % P
    y3 = (r2 * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) * h % P
    return x3, y3, 0 if h == 0 else z3


def _lanes(monkeypatch):
    """Montgomery Jacobian P and Q per lane: chip_smoke.g1_edge_lanes at 336
    lanes (0-63 P = inf (1, 1, 0), 64-127 Q = inf, 128-191 Q = P, 192-255 Q
    = -P, 256-319 both at infinity, the rest generic), Q taken to Jacobian
    under its own random z ((1, 1, 0) at infinity), sampled four lanes an
    edge kind and every generic lane; then lanes whose coordinates are 0,
    1, p-1, 2^253, p-2 and R (not points: the formulas are identities on
    canonical inputs, and these reach the lazy values' largest words)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    n = 336
    pts = chip_smoke.chain_points(1024, 0x1234567, 0x89ABCDEF, th)[: 2 * n]
    ax, ay = (torch.from_numpy(a) for a in G1.pack_affine(pts))
    gen = torch.Generator().manual_seed(20261021)
    (x, y, z), (qx, qy) = chip_smoke.g1_edge_lanes(tf, ax, ay, gen, n)
    f = tf.FqPlain
    z2 = chip_smoke.rand_limbs(n, gen)
    zz = f.sqr(z2)
    q_inf = (qx == 0).all(-1) & (qy == 0).all(-1)
    one = f.one((n,), "cpu")
    q = (f.select(q_inf, one, f.mul(qx, zz)), f.select(q_inf, one, f.mul(qy, f.mul(zz, z2))),
         f.select(q_inf, torch.zeros_like(z2), z2))
    keep = [i for lo in range(0, 320, 64) for i in range(lo, lo + 4)] + list(range(320, n))
    P1 = list(zip(*(rk._ints(t[keep]) for t in (x, y, z))))
    Q1 = list(zip(*(rk._ints(t[keep]) for t in q)))
    edge = [0, 1, P - 1, 1 << 253, P - 2, R]
    for i in range(len(edge)):
        P1.append(tuple(edge[(i + j) % len(edge)] or 1 for j in range(3)))  # z != 0: the generic path
        Q1.append(tuple(edge[(i + j + 3) % len(edge)] or 1 for j in range(3)))
    return P1, Q1


def test_dbl_add_lazy_bounds_hold_at_their_worst_case():
    """jac_dbl, add_diffs and madd_finish at the top of every interval: each
    product and closing sum below p 2^256 word for word in the column form
    on the largest words its operands may hold, the bound comments held;
    jac_dbl and add_diffs name no lazy value (their lazy operands are
    inline: 3x, 4x, 2y and 4(p - b), below 4p), madd_finish hh2, i4 and r2;
    chip_smoke.py's bounds count the least work of each op, which is the
    kernel's with one product a square (jac_dbl's e = x (3 x) as x^2 and two
    additions, add's z3 = 2 z1 z2 h as ((z1 + z2)^2 - z1z1 - z2z2) h) and,
    on a doubling lane, add_diffs without z1 z2."""
    top = V(P - 1, 0, P - 1)
    assert 4 * P < 1 << 256 and 5 * P < 1 << 256  # lazy_x4's 4p; the closing sum's 5 p^2 < p 2^256
    lazy = {}
    for steps, names in ((DBL, "xyz"), (ADD_DIFFS, ("x1", "y1", "z1", "x2", "y2", "z2"))):
        env = dict(rk.worst_case_ops(), lazy_x4=lazy_x4, **{k: top for k in names})
        for step in steps:
            rk.run_steps([step], env)
            name = step[0].split("=")[0].strip()
            if env[name].hi >= P:
                lazy[name] = (env[name].lo, env[name].hi)
    assert lazy == {}
    env = dict(rk.worst_case_ops(), x1=top, y1=top, z1=top, h=top, rr=top)
    rk.run_steps(FINISH, env)
    assert (env["i4"].lo, env["i4"].hi) == (0, 4 * P - 4)
    # y3's closing sum on the largest words: e (d - x3) + (2 b) 4 (p - b), 4 (p - b) reaching 4p
    assert rk.col_words([(P - 1, P - 1), (P - 1, 4 * P)]) == ((P - 1) ** 2 + (P - 1) * 4 * P) * rk.RINV % P
    lp = chip_smoke.lazy_products
    dbl = rk.op_counts(DBL)
    diffs = rk.op_counts(ADD_DIFFS)
    add = tuple(a + b for a, b in zip(diffs, rk.op_counts(FINISH)))
    assert (dbl, diffs, add) == ((7, 2, 6), (9, 2, 9), (16, 4, 15))
    least = chip_smoke.LAZY_G1_PRODUCTS
    assert least["dbl"] == lp(dbl[0] - dbl[1] - 1, dbl[2], squares=dbl[1] + 1) < lp(2, 7, squares=5)
    assert least["dbl"] < lp(dbl[0] - dbl[1], dbl[2], squares=dbl[1])  # jac_dbl's own count
    assert least["add"] == lp(add[0] - add[1] - 1, add[2], squares=add[1] + 1)
    assert least["add_dbl"] == lp(diffs[0] - diffs[1] - 1, diffs[2] - 1, squares=diffs[1]) + least["dbl"]
    assert round(least["dbl"] * 264) == 1544 and round(least["add"] * 264) == 3808


def test_add_branches_in_add_tiles_order():
    """add_kernel and the chains' jac_add take _add_tiles' overrides in its
    order: P = inf (Q's limbs, two infinities too) before Q = inf, both
    before any product; then the doubling escape, then the inverse pair's
    z3 = 0 after the generic finish; dbl_kernel and jac_dbl's callers take
    no branch."""
    body = rk._body("    add_kernel(const int32_t*")
    marks = ["const bool p_inf = fe_is_zero(z1);", "if (p_inf || fe_is_zero(qz))", "p_inf ? x2 : x",
             "p_inf ? qz : z1", "add_diffs(", "madd_dbl_lane(", "madd_finish(u1, s1, z1z2",
             "if (same_x) z3 = fe_zero();"]
    at = [body.index(m) for m in marks]
    assert at == sorted(at), "add_kernel's branches are not in _add_tiles' order"
    body = rk._body("__device__ __forceinline__ Jac jac_add(")
    marks = ["if (fe_is_zero(p.z)) return q;", "if (fe_is_zero(q.z)) return p;", "add_diffs(", "jac_dbl(",
             "madd_finish(u1, s1, z1z2", "if (fe_is_zero(h)) r.z = fe_zero();"]
    at = [body.index(m) for m in marks]
    assert at == sorted(at), "jac_add's branches are not in _add_tiles' order"
    body = rk._body("__device__ __forceinline__ Jac jac_madd(")
    marks = ["if (fe_is_zero(p.z))", "if (q_inf) return p;", "madd_diffs(", "jac_dbl(", "madd_finish(",
             "if (fe_is_zero(h)) r.z = fe_zero();"]
    at = [body.index(m) for m in marks]
    assert at == sorted(at), "jac_madd's branches are not in madd_kernel's order"
    assert " if " not in rk._body("    dbl_kernel(const int32_t*").replace("if (i >= n) return;", "")


def _affine(pt: tuple):
    """Montgomery Jacobian limbs as ints -> the host's affine point."""
    x, y, z = (rk.from_mont(v) for v in pt)
    if z == 0:
        return None
    zi = pow(z, -1, P)
    return x * zi * zi % P, y * zi ** 3 % P


def test_dbl_add_model_matches_plain_python_and_pallas(monkeypatch):
    P1, Q1 = _lanes(monkeypatch)
    tp = [rk._tensor([p[c] for p in P1]) for c in range(3)]
    tq = [rk._tensor([q[c] for q in Q1]) for c in range(3)]
    plain = {"dbl": cc.dbl_plain(*tp), "add": cc.add_plain(*tp, *tq)}
    model = {"dbl": [model_dbl(*p) for p in P1], "add": [model_add(p, q) for p, q in zip(P1, Q1)]}
    python = {"dbl": [dbl_2009_l(*(rk.from_mont(v) for v in p)) for p in P1],
              "add": [add_2007_bl(*(tuple(rk.from_mont(v) for v in pt) for pt in (p, q))) for p, q in zip(P1, Q1)]}
    p_col = jnp.asarray(pc._P_ARR)
    j = [jnp.asarray(a.numpy().view(np.uint32).T) for a in tp + tq]
    pallas = {"dbl": pc._dbl_tiles(*j[:3], p_col), "add": pc._add_tiles(*j, p_col)}
    for name in ("dbl", "add"):
        for c in range(3):
            want = [m[c] for m in model[name]]
            assert want == rk._ints(plain[name][c]), f"{name}: coordinate {c} against the plain version"
            got = rk._ints(torch.from_numpy(np.asarray(pallas[name][c]).T.astype(np.int64)))
            assert want == got, f"{name}: coordinate {c} against the Pallas body"
        for i, m in enumerate(model[name]):  # every lane, points or not, in plain coordinates
            assert tuple(rk.from_mont(v) for v in m) == python[name][i], f"{name} lane {i} against Python ints"
    # the point lanes (the sampled edge kinds and the generic ones) are the host's sums and doubles
    for i in range(len(P1) - 6):
        assert _affine(model["add"][i]) == ch.pt_add(_affine(P1[i]), _affine(Q1[i])), f"lane {i} is not P + Q"
        assert _affine(model["dbl"][i]) == ch.pt_dbl(_affine(P1[i])), f"lane {i} is not 2 P"
