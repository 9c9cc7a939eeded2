"""The port's fixed-base path against the JAX package and the host ground
truth: the plain version of the madd kernel
(hekaton_tpu_torch.curves.cuda_curve.madd_plain), the Jacobian group law of
torch_curve.CurveOps on G1 and G2, and TorchBackend.fixed_base
(msm/pippenger.py::fixed_base_msm + to_affine_device) on CPU tensors.

madd_plain mirrors the Pallas `_madd_tiles`, which agrees with
jax_curve.CurveOps.add_mixed as points but not as limbs on infinity lanes,
so those two are compared in affine; the generic Jacobian formulas are
compared limb for limb. The JAX functions run eagerly: a jit of the Fq2
formulas compiles for tens of seconds on XLA:CPU.
"""
import random

import jax.numpy as jnp
import numpy as np
import torch

import hekaton_tpu.curves.host as jch
from hekaton_tpu.curves.jax_curve import G1 as JG1
from hekaton_tpu.curves.jax_curve import G2 as JG2
from hekaton_tpu.curves.jax_curve import CurveOps as JaxCurveOps
from hekaton_tpu.curves.jax_curve import Jac as JaxJac
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.msm import pippenger as jmsm
from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.torch_curve import G1, G2, CurveOps, Jac
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.bn254 import R
from hekaton_tpu_torch.msm import pippenger as tmsm

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _j(arr):
    return jnp.asarray(np.asarray(arr).view(np.uint32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _ints(pts) -> list:
    """Host points of either package -> ints (G2 coordinates as (c0, c1))."""
    def coord(v):
        return v if isinstance(v, int) else (v.c0, v.c1)

    return [None if p is None else (coord(p[0]), coord(p[1])) for p in pts]


def _madd_lanes():
    """tests/test_pallas.py:33's lanes (an infinity accumulator, an
    infinity operand, a doubling lane, an inverse pair) plus inf + inf."""
    r = np.random.RandomState(77)
    n = 10
    ps = [ch.pt_mul(ch.g1_gen(), int(k)) for k in r.randint(1, 2**30, size=n)]
    ps[3] = None
    qs = [ch.pt_mul(ch.g1_gen(), int(k)) for k in r.randint(1, 2**30, size=n)]
    qs[5] = None
    qs[7] = ps[7]
    qs[8] = (ps[8][0], (-ps[8][1]) % ch.P)
    return ps + [None], qs + [None]


def test_madd_plain_matches_jax_add_mixed_in_affine():
    ps, qs = _madd_lanes()
    ax, ay = G1.pack_affine(ps)
    bx, by = G1.pack_affine(qs)
    p = G1.from_affine(_t(ax), _t(ay))
    one = tf.FqOps.one((), "cpu")
    p.x[10], p.y[10] = one, one  # the last accumulator is inf() = (1, 1, 0)
    got = cc.madd(*p, _t(bx), _t(by))  # the wrapper on CPU tensors is the plain version
    expected = [ch.pt_add(a, b) for a, b in zip(ps, qs)]
    assert G1.unpack_jacobian(got) == expected
    ref = JG1.add_mixed(JaxJac(*(_j(t.numpy()) for t in p)), _j(bx), _j(by))
    assert JG1.unpack_jacobian(ref) == expected
    # the limbs differ only where _madd_tiles and the XLA formula order
    # their infinity overrides differently: the inverse pair (z3 zeroed
    # alone, against inf() = (1, 1, 0)) and inf + inf ((0, 0, 0) against P)
    differ = [i for i in range(len(ps)) if any((_u32(g[i]) != np.asarray(r[i])).any() for g, r in zip(got, ref))]
    assert differ == [8, 10]
    assert not got.z[8].any()
    assert not any(t[10].any() for t in got)
    assert torch.equal(got.x[3], _t(bx)[3]) and torch.equal(got.z[3], one)
    # G1.add_mixed is the madd wrapper
    assert all(torch.equal(a, b) for a, b in zip(G1.add_mixed(p, _t(bx), _t(by)), got))


def test_jacobian_ops_match_jax():
    """The generic formulas, limb for limb: G1 over Fq, G2 over Fq2."""
    r = random.Random(5)
    for curve, jcurve, gen in (
        (CurveOps(tf.FqOps, "g1_generic", tf.FR), JaxCurveOps(jf.FqOps, "g1_generic"), ch.g1_gen()),
        (G2, JG2, ch.g2_gen()),
    ):
        ps = [ch.pt_mul(gen, r.randrange(1, R)) for _ in range(4)]
        qs = [ch.pt_mul(gen, r.randrange(1, R)) for _ in range(4)]
        ps += [ps[0], ps[1], None, ps[2], None]
        qs += [ps[0], ch.pt_neg(ps[1]), qs[0], None, None]
        ax, ay = curve.pack_affine(ps)
        bx, by = curve.pack_affine(qs)
        p, q = curve.from_affine(_t(ax), _t(ay)), curve.from_affine(_t(bx), _t(by))
        jp, jq = jcurve.from_affine(_j(ax), _j(ay)), jcurve.from_affine(_j(bx), _j(by))
        pairs = [
            (curve.add_mixed(p, _t(bx), _t(by)), jcurve.add_mixed(jp, _j(bx), _j(by))),
            (curve.add(p, q), jcurve.add(jp, jq)),
            (curve.dbl(p), jcurve.dbl(jp)),
            (curve.neg(p), jcurve.neg(jp)),
        ]
        for got, ref in pairs:
            for g, e in zip(got, ref):
                assert np.array_equal(_u32(g), np.asarray(e)), curve.name
        expected = _ints([ch.pt_add(a, b) for a, b in zip(ps, qs)])
        assert _ints(curve.unpack_jacobian(pairs[0][0])) == expected
        assert _ints(curve.unpack_jacobian(pairs[1][0])) == expected
        inf = curve.inf((2,), "cpu")
        assert bool(curve.is_inf(inf).all()) and _ints(curve.unpack_jacobian(inf)) == [None, None]
        assert all(np.array_equal(_u32(a), np.asarray(b)) for a, b in zip(inf, jcurve.inf((2,))))


def test_fixed_base_table_matches_jax():
    for curve, jcurve, base in ((G1, JG1, ch.g1_gen()), (G2, JG2, ch.g2_gen())):
        tx, ty = tmsm.fixed_base_table_host(base, curve)
        jbase = base if curve is G1 else tuple(jch.Fq2(v.c0, v.c1) for v in base)
        jx, jy = jmsm.fixed_base_table_host(jbase, jcurve)
        assert tx.shape == (32, 256) + curve.pack_affine([None])[0].shape[1:]
        assert np.array_equal(tx.astype(np.uint32), jx) and np.array_equal(ty.astype(np.uint32), jy)


def test_fixed_base_matches_host():
    """TorchBackend("cpu").fixed_base on both curves against the host
    muls, with 0, 1 and R-1, across chunk edges (FB_CHUNK cut to 5, so
    the last chunk of 2 scalars is padded to 4 lanes)."""
    r = random.Random(9)
    scalars = [0, 1, R - 1] + [r.randrange(R) for _ in range(9)]
    backend = TorchBackend("cpu")
    backend.FB_CHUNK = 5
    for g2, base in ((False, ch.g1_gen()), (True, ch.pt_mul(ch.g2_gen(), 7))):
        got = backend.fixed_base(base, scalars, g2=g2)
        assert got == [ch.pt_mul(base, k) for k in scalars]
        assert got[0] is None and got[1] == base and got[2] == ch.pt_neg(base)
    assert len(backend._fb_tables) == 2 and backend.ran["fixed_base_gpu"] == 2
    assert backend.fixed_base(ch.g1_gen(), []) == []


def test_to_affine_device_maps_infinity_to_sentinel():
    for curve, gen in ((G1, ch.g1_gen()), (G2, ch.g2_gen())):
        pts = [ch.pt_mul(gen, 3), None, ch.pt_mul(gen, 5)]
        ax, ay = curve.pack_affine(pts)
        p = curve.from_affine(_t(ax), _t(ay))
        p = curve.dbl(Jac(*p))  # z != 1 on the finite lanes
        x, y = tmsm.to_affine_device(curve, p)
        assert curve.unpack_affine(x, y) == [ch.pt_dbl(pts[0]), None, ch.pt_dbl(pts[2])]
        assert not x[1].any() and not y[1].any()
