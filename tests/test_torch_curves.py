"""The port's G1 curve layer (hekaton_tpu_torch.curves) against the JAX
package's generic affine and projective ops and the host ground truth.

The plain versions of the three curve kernels (aff_add_fused, l1_aff_halves,
horner_fold) run here on CPU tensors; chip_smoke.py holds the kernels against
them on the card. Every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import hekaton_tpu.curves.host as ch
from hekaton_tpu.curves.affine import AffineOps as JaxAffineOps
from hekaton_tpu.curves.affine import Aff as JaxAff
from hekaton_tpu.curves.jax_curve import G1 as JG1
from hekaton_tpu.curves.proj import Proj as JaxProj
from hekaton_tpu.curves.proj import ProjOps as JaxProjOps
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.msm.pippenger import _level1_pair
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves.affine import AFF_G1, Aff, pack_words, unpack_words
from hekaton_tpu_torch.curves.proj import PROJ_G1
from hekaton_tpu_torch.curves.torch_curve import G1

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)

JAX_AFF = JaxAffineOps(jf.FqOps, "g1_aff_generic")
JAX_PROJ = JaxProjOps(jf.FqOps, 9, "g1_proj_generic")


def _rand_pts(n, seed):
    r = np.random.RandomState(seed)
    return [ch.pt_mul(ch.g1_gen(), int(k)) for k in r.randint(1, 2**60, size=n)]


def _adversarial_pairs():
    """The stress lanes of the JAX affine tests: generic lanes, a doubling
    lane, an inverse pair, inf + Q, P + inf and inf + inf."""
    ps = _rand_pts(6, seed=1)
    qs = _rand_pts(6, seed=2)
    ps += [ps[0], ps[1], None, ps[2], None]
    qs += [ps[0], ch.pt_neg(ps[1]), qs[0], None, None]
    return ps, qs


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _j(arr):
    """int32 limbs or words -> the JAX package's uint32 array."""
    return jnp.asarray(np.asarray(arr).view(np.uint32))


def test_pack_words_round_trip():
    ax, ay = G1.pack_affine(_rand_pts(5, seed=3) + [None])
    x = _t(ax)
    w = pack_words(x)
    assert w.dtype == torch.int32 and w.shape == (6, 8)
    ref = (ax[:, 0::2].astype(np.uint32) | (ax[:, 1::2].astype(np.uint32) << 16)).view(np.int32)
    assert np.array_equal(w.numpy(), ref)
    assert torch.equal(unpack_words(w), x)
    rows = AFF_G1.pack_rows(Aff(x, _t(ay)))
    back = AFF_G1.unpack_rows(rows)
    assert torch.equal(back.x, x) and torch.equal(back.y, _t(ay))


def test_aff_add_fused_matches_jax_and_host():
    ps, qs = _adversarial_pairs()
    px, py = G1.pack_affine(ps)
    qx, qy = G1.pack_affine(qs)
    x3, y3 = cc.aff_add_fused(_t(px), _t(py), _t(qx), _t(qy))
    assert G1.unpack_affine(x3, y3) == [ch.pt_add(a, b) for a, b in zip(ps, qs)]
    j = jax.jit(JAX_AFF.add)(JaxAff(_j(px), _j(py)), JaxAff(_j(qx), _j(qy)))
    assert np.array_equal(x3.numpy().astype(np.uint32), np.asarray(j.x))
    assert np.array_equal(y3.numpy().astype(np.uint32), np.asarray(j.y))
    # AffineOps.add is the same wrapper
    s = AFF_G1.add(Aff(_t(px), _t(py)), Aff(_t(qx), _t(qy)))
    assert torch.equal(s.x, x3) and torch.equal(s.y, y3)


def test_l1_aff_halves_matches_jax_and_host():
    """Columns with doubling pairs, inverse pairs and identity elements (the
    JAX halves-kernel test's columns) reduce to their host sums, as the JAX
    generic pairwise level 1 reduces them."""
    L = 4
    g = ch.g1_gen()
    m = lambda k: ch.pt_mul(g, k)  # noqa: E731
    cols = [
        [m(3), m(5), m(7), m(11)],
        [m(9), m(9), None, m(2)],
        [m(4), None, ch.pt_neg(m(4)), None],
        [None, None, None, None],
        [m(13), None, None, None],
        [m(6), m(6), m(6), m(6)],
        [m(8), ch.pt_neg(m(8)), m(8), ch.pt_neg(m(8))],
    ]
    expected = [ch.msm_host(c, [1] * L) for c in cols]
    slab = np.zeros((len(cols), L * 16), np.int32)
    for j, col in enumerate(cols):
        ax, ay = G1.pack_affine(col)
        slab[j] = AFF_G1.pack_rows(Aff(_t(ax), _t(ay))).numpy().reshape(-1)
    out = AFF_G1.unpack_rows(cc.l1_aff_halves(torch.from_numpy(slab), L))
    assert G1.unpack_affine(out.x, out.y) == expected
    jacc = jax.jit(lambda v: _level1_pair(JAX_AFF, v, len(cols), L))(_j(slab))
    assert np.array_equal(out.x.numpy().astype(np.uint32), np.asarray(jacc.x))
    assert np.array_equal(out.y.numpy().astype(np.uint32), np.asarray(jacc.y))


def test_horner_fold_matches_jax_proj_and_host():
    W, c = 4, 3
    pts = _rand_pts(W - 1, seed=4) + [None]
    ax, ay = G1.pack_affine(pts)
    p = PROJ_G1.from_affine(_t(ax), _t(ay))
    out = cc.horner_fold(p.x, p.y, p.z, c)
    exp = None
    for w, pt in enumerate(pts):
        exp = ch.pt_add(exp, ch.pt_mul(pt, 1 << (c * w)) if pt is not None else None)
    assert G1.unpack_jacobian(PROJ_G1.to_jacobian(out)) == [exp]
    # the same RCB chain in the JAX package's projective ops, coordinate for coordinate
    jp = JAX_PROJ.from_affine(_j(ax), _j(ay))
    acc = JaxProj(jp.x[W - 1], jp.y[W - 1], jp.z[W - 1])
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = JAX_PROJ.dbl(acc)
        acc = JAX_PROJ.add(acc, JaxProj(jp.x[w], jp.y[w], jp.z[w]))
    for got, ref in zip(out, acc):
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref))
    jac = PROJ_G1.to_jacobian(out)
    assert JG1.unpack_jacobian(type(jac)(*(_j(a.numpy())[None] for a in jac))) == [exp]
