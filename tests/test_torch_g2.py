"""The port's G2 layer against the JAX package and the host ground truth: the
complete projective Fq2 ops behind the three G2 RCB kernels
(hekaton_tpu_torch.curves.cuda_curve.{pmadd,padd,pdbl}_rcb_g2, plain
versions on CPU tensors) and the G2 route of msm_gpu.

The JAX package's reference is its generic `ProjOps(jf.Fq2Ops, 3*B_G2)`,
the formulas its Pallas G2 kernels fuse (tests/test_pallas.py:58 holds the
kernels to the host on the same lanes). The G2 MSM is compared with
ch.msm_host on a stress set instead of compiling msm_tpu under XLA:CPU.
Every comparison is exact; G2 host values cross between the packages as
(c0, c1) integers, since each package's Fq2 equals only its own class.
"""
import pathlib
import random
import re

import jax.numpy as jnp
import numpy as np
import torch

import hekaton_tpu.curves.host as jch
from hekaton_tpu.curves.jax_curve import G2 as JG2
from hekaton_tpu.curves.proj import ProjOps as JaxProjOps
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.msm import pippenger as jmsm
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.proj import PROJ_G2
from hekaton_tpu_torch.curves.torch_curve import G2
from hekaton_tpu_torch.fields.bn254 import R
from hekaton_tpu_torch.msm import pippenger as tmsm

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)

JAX_PROJ_G2 = JaxProjOps(jf.Fq2Ops, jch.B_G2 * 3, "g2_proj_generic")


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _j(arr):
    return jnp.asarray(np.asarray(arr).view(np.uint32))


def _ints(pts) -> list:
    """G2 host points of either package -> ((x.c0, x.c1), (y.c0, y.c1)) ints."""
    return [None if p is None else ((p[0].c0, p[0].c1), (p[1].c0, p[1].c1)) for p in pts]


def _completeness_lanes():
    """tests/test_pallas.py:58's lanes: five generic pairs, then doubling
    through add, an inverse pair, the identity accumulator, and Q = (0,0)."""
    r = np.random.RandomState(77)
    ps = [ch.pt_mul(ch.g2_gen(), int(k)) for k in r.randint(1, 2**30, size=5)]
    qs = [ch.pt_mul(ch.g2_gen(), int(k)) for k in r.randint(1, 2**30, size=5)]
    ps += [ps[0], ps[1], None, ps[2]]
    qs += [ps[0], ch.pt_neg(ps[1]), qs[0], None]
    return ps, qs


def test_b3_constant_matches_jax_and_kernel_source():
    assert (PROJ_G2.b3_host.c0, PROJ_G2.b3_host.c1) == (JAX_PROJ_G2.b3_host.c0, JAX_PROJ_G2.b3_host.c1)
    assert np.array_equal(PROJ_G2._b3.numpy().view(np.uint32), JAX_PROJ_G2._b3)
    # csrc/field.cuh carries the same constant as 32-bit Montgomery words
    src = (pathlib.Path(cc.__file__).parents[1] / "csrc" / "field.cuh").read_text()
    block = src[src.index("B3_G2_WORDS[2][8]") :].split("};")[0]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", block)]
    limbs = PROJ_G2._b3.numpy().astype(np.uint32)
    assert words == [int(limbs[c, 2 * i]) | int(limbs[c, 2 * i + 1]) << 16 for c in range(2) for i in range(8)]


def test_g2_rcb_plain_matches_jax_and_host():
    ps, qs = _completeness_lanes()
    ax, ay = G2.pack_affine(ps)
    bx, by = G2.pack_affine(qs)
    p = PROJ_G2.from_affine(_t(ax), _t(ay))
    q = PROJ_G2.from_affine(_t(bx), _t(by))
    madd = cc.pmadd_rcb_g2(*p, _t(bx), _t(by))
    add = cc.padd_rcb_g2(*p, *q)
    dbl = cc.pdbl_rcb_g2(*p)

    def _jax(ax, ay, bx, by):
        jp = JAX_PROJ_G2.from_affine(ax, ay)
        jq = JAX_PROJ_G2.from_affine(bx, by)
        return JAX_PROJ_G2.add_mixed(jp, bx, by), JAX_PROJ_G2.add(jp, jq), JAX_PROJ_G2.dbl(jp)

    ref = _jax(_j(ax), _j(ay), _j(bx), _j(by))  # eager: a jit compiles ~40 s on XLA:CPU
    for got, exp in zip((madd, add, dbl), ref):
        for g, e in zip(got, exp):
            assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(e))

    expected = _ints([ch.pt_add(a, b) for a, b in zip(ps, qs)])
    assert _ints(G2.unpack_jacobian(PROJ_G2.to_jacobian(madd))) == expected
    assert _ints(G2.unpack_jacobian(PROJ_G2.to_jacobian(add))) == expected
    assert _ints(G2.unpack_jacobian(PROJ_G2.to_jacobian(dbl))) == _ints([ch.pt_dbl(a) if a else None for a in ps])
    # PROJ_G2's methods are the wrappers; the Jacobian round trip keeps points
    assert all(torch.equal(a, b) for a, b in zip(PROJ_G2.add_mixed(p, _t(bx), _t(by)), madd))
    back = PROJ_G2.from_jacobian(PROJ_G2.to_jacobian(add))
    assert _ints(G2.unpack_jacobian(PROJ_G2.to_jacobian(back))) == expected
    assert _ints(G2.unpack_jacobian(PROJ_G2.to_jacobian(PROJ_G2.neg(add)))) == _ints(
        [ch.pt_neg(e) for e in (ch.pt_add(a, b) for a, b in zip(ps, qs))]
    )


def test_g2_pack_unpack_match_jax():
    ps, _ = _completeness_lanes()
    ax, ay = G2.pack_affine(ps)
    jax_pts = [None if pt is None else tuple(jch.Fq2(v.c0, v.c1) for v in pt) for pt in ps]
    jx, jy = JG2.pack_affine(jax_pts)
    assert ax.shape == (len(ps), 2, 16)
    assert np.array_equal(ax.astype(np.uint32), jx) and np.array_equal(ay.astype(np.uint32), jy)
    assert _ints(G2.unpack_affine(_t(ax), _t(ay))) == _ints(ps)
    j = G2.from_affine(_t(ax), _t(ay))
    assert _ints(G2.unpack_jacobian(j)) == _ints(ps)


def _stress_set():
    """Duplicate points, infinity rows, the scalars 0, 1 and R-1, and one
    crowded bucket: 24 lanes share one scalar, so in every window one
    bucket holds 24 points and collapses over several columns."""
    rng = random.Random(11)
    n = 48
    pts = [ch.pt_mul(ch.g2_gen(), rng.randrange(1, R)) for _ in range(n)]
    pts[3] = pts[9] = None
    pts[5] = pts[4]
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[0], scalars[1], scalars[2] = 0, 1, R - 1
    scalars[5] = scalars[4]
    crowd = rng.randrange(R)
    for i in range(20, 44):
        scalars[i] = crowd
    return pts, scalars


def test_msm_gpu_g2_matches_host_and_jax_plan():
    pts, scalars = _stress_set()
    c, L = 4, 4  # B = 9 buckets a window keeps the plain suffix scan small
    ax, ay = G2.pack_affine(pts)
    sc = tmsm.pack_scalars(scalars, G2)
    # the per-window sorted plan on Fq2 rows: same columns as the JAX plan
    # (payload order inside a bucket is not fixed by the unstable JAX sort)
    rows, col_bucket, meta = tmsm._plan_sorted_w(_t(ax), _t(ay), sc, c, L)
    jrows, jcol_bucket, jmeta = jmsm._plan_sorted_w(_j(ax), _j(ay), _j(sc), c, L, 254, lambda y: jf.neg(jf.FQ, y))
    assert meta == jmeta[:5]
    assert np.array_equal(col_bucket.numpy(), np.asarray(jcol_bucket))
    got = rows.numpy().view(np.uint32).reshape(meta[4], L, 32)
    ref = np.asarray(jrows).reshape(meta[4], L, 32)
    for j in range(meta[4]):
        assert sorted(map(tuple, got[j])) == sorted(map(tuple, ref[j])), j

    out = tmsm.msm_gpu(_t(ax), _t(ay), sc, c=c, L=L)
    assert out.x.shape == (2, 16)
    got = G2.unpack_jacobian(type(out)(*(a[None] for a in out)))[0]
    assert _ints([got]) == _ints([ch.msm_host(pts, scalars)])
