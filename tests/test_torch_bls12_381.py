"""BLS12-381 G1 in the port (24-limb Fq) against the JAX package and the host.

- The plain 24-limb field formulas (mont_mul, add, sub, neg, mont_inv,
  batch_inv) against jax_field on FieldSpec(P381, nlimbs=24), and
  mont_mul_pallas in interpret mode on 12 lanes, all bit-identical; the
  CUDA wrappers' field ids and shape checks.
- The generic affine add / add_packed and the projective add / dbl (b3 =
  12) against the JAX generic AffineOps and proj_for_curve(g1_bls12_381()),
  one jitted op each, with doubling, inverse and infinity lanes: the limbs
  are identical (the formulas are the same).
- The compact msm (32 and 33 points) and msm_gpu on every route it resolves
  to on BLS12-381 (40 points, c=6, L=8, nbits=255 by default, an infinity
  point, a zero scalar, r-1 and scalars above BN254's r) against a
  Python-int affine host sum (tests/test_bls12_381.py's), and the route
  resolver against a table written from msm_tpu
  (hekaton_tpu/msm/pippenger.py:998-1051). Scalars pack modulo the curve's
  own r: pack_scalars takes no default field.
- The copied G2 and pairing module's property battery
  (tests/test_bls12_381_pairing.py's).

No test jits msm or msm_tpu; JAX runs one op at a time.
"""
import functools
import random
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hekaton_tpu.curves import jax_curve as jc
from hekaton_tpu.curves.affine import Aff as JAff
from hekaton_tpu.curves.affine import aff_for_curve as jaff_for_curve
from hekaton_tpu.curves.proj import Proj as JProj
from hekaton_tpu.curves.proj import proj_for_curve as jproj_for_curve
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.fields.pallas_field import mont_mul_pallas
from hekaton_tpu_torch.curves.affine import AFF_G1_BLS, Aff, aff_for_curve
from hekaton_tpu_torch.curves.proj import PROJ_G1_BLS, Proj, proj_for_curve
from hekaton_tpu_torch.curves.torch_curve import G1, g1_bls12_381
from hekaton_tpu_torch.fields import bls12_381 as bls
from hekaton_tpu_torch.fields import bls12_381_tower as tower
from hekaton_tpu_torch.fields import cuda_field as cf
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.bn254 import R as R254
from hekaton_tpu_torch.msm import pippenger as pip
from hekaton_tpu_torch.pairing import bls12_381 as pairing

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)

P, R = bls.P, bls.R
JSPEC = jf.FieldSpec(P, "fq_bls381", nlimbs=24)
CURVE = g1_bls12_381()


def _h_add(p, q):
    """Affine P + Q over Python ints (None = infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if (p[1] + q[1]) % P == 0:
            return None
        lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, P) % P
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, P) % P
    x = (lam * lam - p[0] - q[0]) % P
    return (x, (lam * (p[0] - x) - p[1]) % P)


def _h_mul(p, k):
    acc = None
    while k:
        if k & 1:
            acc = _h_add(acc, p)
        p = _h_add(p, p)
        k >>= 1
    return acc


def _h_msm(pts, scalars):
    acc = None
    for p, s in zip(pts, scalars):
        acc = _h_add(acc, _h_mul(p, s)) if p is not None else acc
    return acc


def _vals(n: int, seed: int) -> list:
    """n values of Fq with 0, 1 and p-1 first."""
    r = np.random.RandomState(seed)
    vals = [0, 1, P - 1]
    while len(vals) < n:
        vals.append(int.from_bytes(r.bytes(48), "little") % P)
    return vals


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).view(np.int32) if np.asarray(arr).dtype == np.uint32
                            else np.asarray(arr).astype(np.int32))


def _j(arr):
    return jnp.asarray(np.asarray(arr).astype(np.int64).astype(np.uint32))


def _same(got, ref) -> bool:
    got = got if isinstance(got, (tuple, list)) else [got]
    ref = ref if isinstance(ref, (tuple, list)) else [ref]
    return all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(r)) for g, r in zip(got, ref))


def test_plain_field_ops_match_jax():
    a_vals, b_vals = _vals(40, 1), list(reversed(_vals(40, 2)))
    a_np, b_np = JSPEC.pack(a_vals), JSPEC.pack(b_vals)
    assert np.array_equal(tf.FQ_BLS.pack(a_vals).astype(np.uint32), a_np)
    a, b = _t(a_np), _t(b_np)
    ja, jb = jnp.asarray(a_np), jnp.asarray(b_np)
    for name in ("mont_mul", "add", "sub"):
        got = getattr(tf, name)(tf.FQ_BLS, a, b)
        assert _same(got, jax.jit(lambda x, y, n=name: getattr(jf, n)(JSPEC, x, y))(ja, jb)), name
    assert _same(tf.neg(tf.FQ_BLS, a), jax.jit(lambda x: jf.neg(JSPEC, x))(ja))
    assert tf.FQ_BLS.unpack(tf.mont_mul(tf.FQ_BLS, a, b)) == [x * y % P for x, y in zip(a_vals, b_vals)]
    # a broadcast constant, as ProjOps.mul_b3 multiplies
    assert _same(tf.mont_mul(tf.FQ_BLS, a, b[5]), jax.jit(lambda x, y: jf.mont_mul(JSPEC, x, y))(ja, jb[5]))
    # Fermat inversion (inv(0) = 0) and the batch inversion of nonzero lanes
    small = a[:6]
    got = tf.mont_inv(tf.FQ_BLS, small)
    assert _same(got, jax.jit(lambda x: jf.mont_inv(JSPEC, x))(ja[:6]))
    assert tf.FQ_BLS.unpack(got) == [pow(v, P - 2, P) for v in a_vals[:6]]
    nz = _t(JSPEC.pack([v or 1 for v in a_vals]))
    assert _same(tf.batch_inv(tf.FQ_BLS, nz), jax.jit(lambda x: jf.batch_inv(JSPEC, x))(_j(nz.numpy())))


def test_mont_mul_pallas_interpret_matches_plain():
    """The Pallas CIOS kernel at 24 limbs in interpret mode, on
    tests/test_pallas.py's 12 lanes: 9 random, then 0, 1 and p-1."""
    r = np.random.RandomState(77)
    vals = [int(r.randint(1, 2**62)) * int(r.randint(1, 2**62)) % P for _ in range(9)] + [0, 1, P - 1]
    a_np, b_np = JSPEC.pack(vals), JSPEC.pack(list(reversed(vals)))
    ref = mont_mul_pallas(JSPEC, jnp.asarray(a_np), jnp.asarray(b_np))
    assert _same(tf.mont_mul(tf.FQ_BLS, _t(a_np), _t(b_np)), ref)


def test_wrappers_know_the_24_limb_field():
    assert cf._field_id(tf.FQ) == 0 and cf._field_id(tf.FR) == 1 and cf._field_id(tf.FQ_BLS) == 2
    for spec in (tf.FieldSpec(P, "fq_bls381_16", nlimbs=16), tf.FR_BLS, tf.FieldSpec(2**61 - 1, "m61", nlimbs=4)):
        with pytest.raises(ValueError):
            cf._field_id(spec)
    a = _t(tf.FQ_BLS.pack(_vals(8, 3)))
    cf.check_limbs("x", a, a.device, 24)
    with pytest.raises(ValueError):
        cf.check_limbs("x", a, a.device)  # (..., 16) expected
    with pytest.raises(ValueError):
        cf.check_limbs("x", a[:, :16], a.device, 24)
    # CPU tensors take the plain versions
    assert torch.equal(cf.mont_mul(tf.FQ_BLS, a, a.flip(0)), tf.mont_mul(tf.FQ_BLS, a, a.flip(0)))
    assert torch.equal(cf.fermat_inv(tf.FQ_BLS, a[:3]), tf.mont_inv(tf.FQ_BLS, a[:3]))
    assert tf.FqBlsOps.spec is tf.FQ_BLS and tf.FQ_BLS.nlimbs == 24 and tf.FR_BLS.nlimbs == 16


def _points(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [_h_mul(bls.G1_GEN, rng.randrange(1, 2**40)) for _ in range(n)]


def _pack(pts):
    ax, ay = CURVE.pack_affine(pts)
    return _t(ax), _t(ay)


def test_affine_ops_match_jax_and_host():
    """Six random pairs, then doubling, an inverse pair, inf + Q, P + inf
    and inf + inf (tests/test_affine.py's lanes)."""
    ps, qs = _points(6, 1), _points(6, 2)
    ps += [ps[0], ps[1], None, ps[2], None]
    qs += [ps[0], (ps[1][0], (-ps[1][1]) % P), qs[0], None, None]
    (x1, y1), (x2, y2) = _pack(ps), _pack(qs)
    want = [_h_add(p, q) for p, q in zip(ps, qs)]
    assert aff_for_curve(CURVE) is AFF_G1_BLS and aff_for_curve(G1) is not AFF_G1_BLS
    jaff = jaff_for_curve(jc.g1_bls12_381())
    got = AFF_G1_BLS.add(Aff(x1, y1), Aff(x2, y2))
    ref = jax.jit(lambda a, b, c, d: jaff.add(JAff(a, b), JAff(c, d)))(*(_j(t.numpy()) for t in (x1, y1, x2, y2)))
    assert _same(got, ref)
    assert CURVE.unpack_affine(*got) == want
    rows = AFF_G1_BLS.pack_rows(Aff(x2, y2))
    assert rows.shape == (11, 24) and not rows[-1].any()
    got = AFF_G1_BLS.add_packed(Aff(x1, y1), rows)
    ref = jax.jit(lambda a, b, r: jaff.add_packed(JAff(a, b), r))(_j(x1.numpy()), _j(y1.numpy()), _j(rows.numpy()))
    assert _same(got, ref)
    # one round of the pairwise tree: (a || b) rows -> a + b rows
    pairs = torch.cat([AFF_G1_BLS.pack_rows(Aff(x1, y1)), rows], dim=1)
    assert CURVE.unpack_affine(*AFF_G1_BLS.unpack_rows(AFF_G1_BLS.add_pairs_packed(pairs))) == want


def test_proj_ops_match_jax_and_host():
    """RCB add and dbl with b3 = 12 on projective lanes with random z:
    random pairs, doubling (Q = P under another z), an inverse pair, the
    identity (0 : z : 0) on either side and both."""
    ps, qs = _points(5, 3), _points(5, 4)
    ps += [ps[0], ps[1], None, ps[2], None]
    qs += [ps[0], (ps[1][0], (-ps[1][1]) % P), qs[0], None, None]
    rng = random.Random(5)

    def proj(pts):
        cols = ([], [], [])
        for pt in pts:
            z = rng.randrange(1, P)
            x, y, zz = (0, z, 0) if pt is None else (pt[0] * z % P, pt[1] * z % P, z)
            for col, v in zip(cols, (x, y, zz)):
                col.append(v)
        return [_t(tf.FQ_BLS.pack(c)) for c in cols]

    p, q = Proj(*proj(ps)), Proj(*proj(qs))
    assert proj_for_curve(CURVE) is PROJ_G1_BLS and PROJ_G1_BLS.b3_host == 12
    jproj = jproj_for_curve(jc.g1_bls12_381())
    jp, jq = (JProj(*(_j(t.numpy()) for t in pt)) for pt in (p, q))

    def affine(pt):
        out = []
        for x, y, z in zip(*(tf.FQ_BLS.unpack(t) for t in pt)):
            out.append(None if z == 0 else (x * pow(z, P - 2, P) % P, y * pow(z, P - 2, P) % P))
        return out

    got = PROJ_G1_BLS.add(p, q)
    assert _same(got, jax.jit(jproj.add)(jp, jq))
    assert affine(got) == [_h_add(a, b) for a, b in zip(ps, qs)]
    got = PROJ_G1_BLS.dbl(p)
    assert _same(got, jax.jit(jproj.dbl)(jp))
    assert affine(got) == [_h_add(a, a) for a in ps]


@functools.lru_cache(maxsize=None)
def _msm_set(n: int = 40):
    """tests/test_bls12_381.py's msm_tpu set: points k*G (an infinity one),
    scalars below BLS12-381's r with 0 and r-1, and two above BN254's r."""
    rng = random.Random(11)
    pts = _points(n, 6)
    pts[2] = None
    scal = [rng.randrange(R) for _ in range(n)]
    scal[0], scal[1] = 0, R - 1
    scal[3], scal[4] = R254, R254 + 12345
    return pts, scal


@functools.lru_cache(maxsize=None)
def _msm_expected(n: int):
    pts, scal = _msm_set()
    return _h_msm(pts[:n], scal[:n])


@pytest.mark.parametrize("n", [32, 33])
def test_compact_msm_matches_host(n):
    pts, scal = _msm_set()
    ax, ay = _pack(pts[:n])
    out = pip.msm(CURVE, ax, ay, pip.pack_scalars(scal[:n], CURVE))
    assert CURVE.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == _msm_expected(n)


@pytest.mark.parametrize("route,level1", [
    ({}, "steps"),
    ({"level1": "pair"}, "pair"),
    ({"accum": "proj"}, "steps"),
    ({"plan": "gather"}, "gather"),
])
def test_msm_gpu_routes_match_host(route, level1, monkeypatch):
    pts, scal = _msm_set()
    assert any(s >= R254 for s in scal)
    sc = pip.pack_scalars(scal, CURVE)
    # packed raw below BLS r: BN254's r would reduce them
    assert tf.FR_BLS.unpack(sc, mont=False) == scal != tf.FR.unpack(pip.pack_scalars(scal, G1), mont=False)
    ran = []
    for name in ("_level1_rows", "_level1_pair", "_level1_tpu"):
        fn = getattr(pip, name)
        monkeypatch.setattr(pip, name, lambda *a, _fn=fn, _name=name: ran.append(_name) or _fn(*a))
    ax, ay = _pack(pts)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = pip.msm_gpu(ax, ay, sc, c=6, L=8, curve=CURVE, **route)
    assert ran == [{"steps": "_level1_rows", "pair": "_level1_pair", "gather": "_level1_tpu"}[level1]]
    assert CURVE.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == _msm_expected(len(pts))


def test_pack_scalars_takes_the_curves_r():
    """BLS scalars at or above BN254's r keep their value only because the
    curve names its r; a call without the curve fails, so none reduces them
    modulo BN254's r silently."""
    big = [0, R254, R254 + 12345, R - 1]
    assert CURVE.scalar is tf.FR_BLS and G1.scalar is tf.FR
    assert tf.FR_BLS.unpack(pip.pack_scalars(big, CURVE), mont=False) == big
    assert tf.FR.unpack(pip.pack_scalars(big, G1), mont=False) == [v % R254 for v in big]
    with pytest.raises(TypeError):
        pip.pack_scalars(big)
    # and the bit length the digits read defaults to the curve's r
    assert R.bit_length() == 255 and R254.bit_length() == 254


def test_msm_gpu_refuses_24_limbs_without_the_curve():
    ax, ay = _pack(_points(2, 7))
    sc = pip.pack_scalars([1, 2], CURVE)
    with pytest.raises(ValueError):
        pip.msm_gpu(ax, ay, sc, c=6, L=8)
    with pytest.raises(ValueError):
        pip.msm_gpu(ax[:, :16].contiguous(), ay[:, :16].contiguous(), sc, c=6, L=8, curve=CURVE)


# (L, accum, level1, plan) -> (accum, level1, plan), warns; written from
# msm_tpu's resolution for a G1 curve other than BN254 (is_bn_g1 False,
# hekaton_tpu/msm/pippenger.py:998-1051)
BLS_ROUTES = [
    ((32, None, None, None), ("affine", "steps", "sort"), False),
    ((24, None, None, None), ("affine", "steps", "sort"), False),
    ((32, "proj", None, None), ("proj", "steps", "sort"), False),
    ((32, "affine", "mega", None), ("affine", "steps", "sort"), False),
    ((32, None, "pair", None), ("affine", "pair", "sort"), False),
    ((24, None, "pair", None), ("affine", "steps", "sort"), True),
    ((32, "proj", "pair", None), ("proj", "steps", "sort"), True),
    ((32, None, None, "wsort"), ("affine", "steps", "wsort"), False),
    ((32, None, None, "tsort"), ("affine", "steps", "wsort"), False),
    ((32, None, "pair", "tsort"), ("affine", "pair", "wsort"), False),
    ((32, "proj", "mega", "tsort"), ("proj", "steps", "wsort"), False),
    ((32, None, None, "gather"), ("affine", "steps", "gather"), False),
    ((32, None, "pair", "gather"), ("affine", "steps", "gather"), True),
    ((32, None, "mega", "gather"), ("affine", "steps", "gather"), False),
]


@pytest.mark.parametrize("args,route,warns", BLS_ROUTES)
def test_resolve_route_bls_matches_msm_tpu(args, route, warns):
    L, accum, level1, plan = args
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert pip.resolve_route(CURVE, L, accum, level1, plan) == route
    assert bool(seen) == warns


def test_pairing_module_properties():
    """The copied G2 group law and ate pairing: generator on the curve and of
    order r, and bilinear and non-degenerate."""
    rng = random.Random(17)
    q = pairing.g2_gen()
    assert pairing.g2_is_on_curve(q) and pairing.g2_mul(q, R) is None
    assert pairing.g2_add(q, pairing.g2_neg(q)) is None
    q3 = pairing.g2_add(pairing.g2_add(q, q), q)
    assert pairing.g2_mul(q, 3) == q3 and pairing.g2_is_on_curve(q3)
    a, b = rng.randrange(1, 1 << 64), rng.randrange(1, 1 << 64)
    e = pairing.pairing(bls.G1_GEN, q)
    assert e != tower.Fq12.one() and e.pow(R) == tower.Fq12.one()
    assert pairing.pairing(_h_mul(bls.G1_GEN, a), pairing.g2_mul(q, b)) == e.pow(a * b % R)
