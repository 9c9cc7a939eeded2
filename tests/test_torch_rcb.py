"""The port's G1 projective MSM routes (msm_gpu's accum="proj" and
level1="mega"/"steps") and their kernels' plain versions, against the JAX
package and the host ground truth.

- pmadd_rcb_plain / padd_rcb_plain / pdbl_rcb_plain against the JAX
  PROJ_G1.add_mixed / add / dbl on the CPU, where PallasProjG1Ops takes the
  XLA formulas that _pmadd_rcb_tiles, _padd_rcb_tiles and _pdbl_rcb_tiles
  repeat step for step.
- l1_rcb_mega_plain against the JAX `_level1_rows(PROJ_G1, ...)`, the Pallas
  mega kernel's plain reference. The JAX package's only test of the mega
  kernel (tests/test_jax_curve_msm.py::test_msm_tpu_tsort_plan_matches_host)
  runs it in interpret mode inside a jitted msm_tpu and takes over 700 s on
  the CPU; the same L sequential RCB mixed adds, run eagerly, take seconds.
- msm_gpu along each new route against ch.msm_host on the n=60 stress set of
  tests/test_torch_msm.py.
- The route resolver against a table written from msm_tpu
  (hekaton_tpu/msm/pippenger.py:993-1051).

Every comparison is exact. JAX runs eagerly: no jit of msm_tpu, no Pallas
interpret run.
"""
import random
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from hekaton_tpu.curves.proj import PROJ_G1 as JPROJ_G1
from hekaton_tpu.curves.proj import Proj as JProj
from hekaton_tpu.msm.pippenger import _level1_rows as j_level1_rows
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.affine import AFF_G1, Aff
from hekaton_tpu_torch.curves.proj import PROJ_G1, Proj
from hekaton_tpu_torch.curves.torch_curve import G1, G2
from hekaton_tpu_torch.fields import cuda_field
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.bn254 import P, R
from hekaton_tpu_torch.msm import pippenger as tmsm

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _j(arr):
    """int32 limbs or words -> the JAX package's uint32 array."""
    return jnp.asarray(np.asarray(arr).view(np.uint32))


def _same(got, ref) -> bool:
    return all(np.array_equal(g.numpy().astype(np.uint32), np.asarray(r)) for g, r in zip(got, ref))


def _proj(pts, zs):
    """Host affine points and z values -> projective (x z : y z : z) limbs;
    None is the identity (0 : z : 0)."""
    xs = [0 if p is None else p[0] * z % P for p, z in zip(pts, zs)]
    ys = [z if p is None else p[1] * z % P for p, z in zip(pts, zs)]
    zs = [0 if p is None else z for p, z in zip(pts, zs)]
    return tuple(_t(tf.FQ.pack(v)) for v in (xs, ys, zs))


def _edge_lanes():
    """16 lanes of P (projective, random z) and Q (affine, and projective
    under another z): generic lanes, Q = P (doubling through the add), Q = -P
    (an inverse pair), the identity accumulator (0:1:0) and (0:z:0), the
    (0,0) sentinel operand (the identity for the projective add), and both."""
    r = np.random.RandomState(11)
    g = ch.g1_gen()
    ps = [ch.pt_mul(g, int(k)) for k in r.randint(1, 2**62, size=16)]
    qs = [ch.pt_mul(g, int(k)) for k in r.randint(1, 2**62, size=16)]
    qs[6] = ps[6]
    qs[7] = ch.pt_neg(ps[7])
    ps[8] = ps[9] = ps[11] = None
    qs[10] = qs[11] = None
    zp, zq = ([int.from_bytes(r.bytes(32), "little") % P for _ in range(16)] for _ in range(2))
    zp[8] = 1  # (0:1:0), ProjOps.inf
    p = _proj(ps, zp)
    q = _proj(qs, zq)
    ax, ay = G1.pack_affine(qs)
    return p, q, (_t(ax), _t(ay)), ps, qs


def test_rcb_plain_ops_match_jax_proj_and_host():
    p, q, (ax, ay), ps, qs = _edge_lanes()
    jp, jq = JProj(*map(_j, p)), JProj(*map(_j, q))
    want = [ch.pt_add(a, b) for a, b in zip(ps, qs)]

    out = cc.pmadd_rcb_plain(*p, ax, ay)
    assert _same(out, JPROJ_G1.add_mixed(jp, _j(ax), _j(ay)))
    assert G1.unpack_jacobian(PROJ_G1.to_jacobian(out)) == want
    out = cc.padd_rcb_plain(*p, *q)
    assert _same(out, JPROJ_G1.add(jp, jq))
    assert G1.unpack_jacobian(PROJ_G1.to_jacobian(out)) == want
    out = cc.pdbl_rcb_plain(*p)
    assert _same(out, JPROJ_G1.dbl(jp))
    assert G1.unpack_jacobian(PROJ_G1.to_jacobian(out)) == [ch.pt_add(a, a) for a in ps]
    # PROJ_G1 goes through the wrappers, which take CPU tensors to these
    assert torch.equal(torch.stack(PROJ_G1.add_mixed(Proj(*p), ax, ay)), torch.stack(cc.pmadd_rcb(*p, ax, ay)))
    assert torch.equal(torch.stack(PROJ_G1.add(Proj(*p), Proj(*q))), torch.stack(cc.padd_rcb_plain(*p, *q)))
    assert torch.equal(torch.stack(PROJ_G1.dbl(Proj(*p))), torch.stack(cc.pdbl_rcb_plain(*p)))


def _slab(L: int):
    """A (ncols, L*16) packed slab: columns of random multiples of G with
    repeats (doubling steps), negations (inverse steps, the identity mid-column)
    and (0,0) sentinel rows, one all-sentinel column; and each column's host
    sum."""
    r = np.random.RandomState(L)
    g = ch.g1_gen()
    pool = [ch.pt_mul(g, int(k)) for k in r.randint(1, 2**62, size=5)]
    pool += [ch.pt_neg(a) for a in pool] + [None, None]
    cols = [[pool[i] for i in r.randint(0, len(pool), size=L)] for _ in range(9)]
    cols[0] = [None] * L
    cols[1][:3] = [pool[0], pool[0], pool[5]]  # P, P, -P
    slab = np.zeros((len(cols), L * 16), np.int32)
    for j, col in enumerate(cols):
        ax, ay = G1.pack_affine(col)
        slab[j] = AFF_G1.pack_rows(Aff(_t(ax), _t(ay))).numpy().reshape(-1)
    return torch.from_numpy(slab), [ch.msm_host(c, [1] * L) for c in cols]


@pytest.mark.parametrize("L", [8, 6])
def test_l1_rcb_mega_plain_matches_jax_level1_rows(L):
    slab, want = _slab(L)
    out = cc.l1_rcb_mega_plain(slab, L)
    assert all(t.shape == (slab.shape[0], 16) for t in out)
    assert _same(out, j_level1_rows(JPROJ_G1, _j(slab), slab.shape[0], L, (16,)))
    assert G1.unpack_jacobian(PROJ_G1.to_jacobian(out)) == want
    assert torch.equal(torch.stack(cc.l1_rcb_mega(slab, L)), torch.stack(out))
    # the mega route's affine accumulation reads the columns back through from_proj
    aff = AFF_G1.from_proj(*out)
    assert G1.unpack_affine(aff.x, aff.y) == want


def test_plain_versions_stay_plain(monkeypatch):
    """The plain versions run tf.mont_mul directly: none reaches FqOps (the
    mont_mul kernel wrapper), PROJ_G1, AFF_G1 or another kernel wrapper."""

    def kernel_wrapper(*args, **kwargs):
        raise AssertionError("a plain version reached a kernel wrapper")

    monkeypatch.setattr(cuda_field, "mont_mul", kernel_wrapper)
    monkeypatch.setattr(cuda_field, "fermat_inv", kernel_wrapper)
    for name in ("pmadd_rcb", "padd_rcb", "pdbl_rcb", "l1_rcb_mega", "aff_add_fused", "aff_add_mixed_packed",
                 "aff_prep", "aff_fin", "l1_aff_halves", "l1_aff_halves_t", "interleave_slab_t"):
        monkeypatch.setattr(cc, name, kernel_wrapper)
    p, q, (ax, ay), _, _ = _edge_lanes()
    cc.pmadd_rcb_plain(*p, ax, ay)
    cc.padd_rcb_plain(*p, *q)
    cc.pdbl_rcb_plain(*p)
    slab = _slab(4)[0]
    cc.l1_rcb_mega_plain(slab, 4)
    cc.l1_rcb_mega_plain(slab.T.contiguous(), 4, transposed=True)
    cc.horner_fold_plain(*p, 2)
    rows = AFF_G1.pack_rows(Aff(ax, ay))
    x1, y1 = p[0], p[1]  # limbs of points or not, the formulas run all the same
    cc.aff_add_mixed_packed_plain(x1, y1, rows)
    den, num = cc.aff_prep_plain(x1, y1, ax, ay)
    cc.aff_fin_plain(x1, y1, ax, ay, den, num)
    cc.l1_aff_halves_t_plain(slab.T.contiguous(), 4)
    cc.interleave_slab_t_plain(slab.reshape(16, 1, 4, -1))


def _stress_set():
    """tests/test_torch_msm.py's stress set (that of
    tests/test_jax_curve_msm.py), drawn the same way."""
    rng = random.Random(7)
    n = 60
    pts = [ch.pt_mul(ch.g1_gen(), rng.randrange(1, R)) for _ in range(n)]
    pts[5] = None
    pts[7] = pts[6]
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[0] = 0
    scalars[1] = 1
    scalars[2] = R - 1
    scalars[6] = scalars[7]
    return pts, scalars


@pytest.mark.parametrize("L,kw,level1", [
    (8, {"accum": "proj"}, "l1_rcb_mega"),  # (a) mega, projective accumulation
    (6, {}, "l1_rcb_mega"),  # (b) the default at L=6: mega, then from_proj
    (8, {"accum": "proj", "level1": "steps"}, "_level1_rows"),  # (c) one pmadd_rcb per slab row
])
def test_msm_gpu_routes_match_host_on_stress_set(monkeypatch, L, kw, level1):
    ran = []
    for name in ("l1_rcb_mega", "_level1_rows", "_level1_pair"):
        fn = getattr(tmsm, name)
        monkeypatch.setattr(tmsm, name, lambda *a, _fn=fn, _name=name: ran.append(_name) or _fn(*a))
    pts, scalars = _stress_set()
    ax, ay = G1.pack_affine(pts)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tmsm.msm_gpu(_t(ax), _t(ay), tmsm.pack_scalars(scalars, G1), c=6, L=L, **kw)
    assert ran == [level1]
    assert G1.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == ch.msm_host(pts, scalars)


# (g2, L, accum, level1, plan) -> (accum, level1, plan), warns; written from
# msm_tpu's resolution (hekaton_tpu/msm/pippenger.py:993-1051)
ROUTES = [
    ((False, 32, None, None, None), ("affine", "pair", "wsort"), False),
    ((False, 24, None, None, None), ("affine", "mega", "wsort"), False),
    ((False, 32, "proj", None, None), ("proj", "mega", "wsort"), False),
    ((False, 32, "proj", "steps", None), ("proj", "steps", "wsort"), False),
    ((False, 32, "affine", "mega", None), ("affine", "mega", "wsort"), False),
    ((False, 32, "affine", "steps", None), ("affine", "steps", "wsort"), False),
    ((False, 32, "proj", "pair", None), ("proj", "steps", "wsort"), True),
    ((False, 24, None, "pair", None), ("affine", "steps", "wsort"), True),
    ((False, 32, None, None, "sort"), ("affine", "pair", "sort"), False),
    ((False, 32, None, None, "tsort"), ("affine", "pair", "tsort"), False),
    ((False, 24, None, None, "tsort"), ("affine", "mega", "tsort"), False),
    ((False, 32, "proj", "steps", "tsort"), ("proj", "steps", "wsort"), False),
    ((False, 32, None, None, "gather"), ("affine", "steps", "gather"), True),
    ((False, 32, None, "mega", "gather"), ("affine", "mega", "gather"), False),
    ((True, 32, None, None, None), ("proj", "steps", "sort"), False),
    ((True, 24, None, None, None), ("proj", "steps", "sort"), False),
    ((True, 32, "affine", None, None), ("proj", "steps", "sort"), False),
    ((True, 32, None, "mega", None), ("proj", "steps", "sort"), False),
    ((True, 32, None, "pair", None), ("proj", "steps", "sort"), True),
    ((True, 32, None, None, "wsort"), ("proj", "steps", "wsort"), False),
    ((True, 32, None, None, "tsort"), ("proj", "steps", "wsort"), False),
]


@pytest.mark.parametrize("args,route,warns", ROUTES)
def test_resolve_route_matches_msm_tpu(args, route, warns):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        g2, L, accum, level1, plan = args
        assert tmsm.resolve_route(G2 if g2 else G1, L, accum, level1, plan) == route
    assert bool(seen) == warns
