"""The port's remaining msm_gpu routes (plan="tsort", plan="gather" and
level1="steps" with affine accumulation) and their kernels' plain versions,
against the JAX package and the host ground truth.

- aff_add_mixed_packed_plain against the JAX generic AffineOps.add_packed
  on tests/test_affine.py's adversarial pairs (the all-zero sentinel row
  among them); aff_prep_plain / aff_fin_plain against the Pallas kernels'
  tile functions `_aff_prep_tiles` / `_aff_fin_tiles`, called eagerly on
  (16, n) arrays (plain jnp, no Pallas).
- _plan_sorted_t, interleave_slab_t_plain, _plan_tpu against the JAX plans
  and the XLA interleave; l1_aff_halves_t_plain against the JAX
  `_level1_pair` (its XLA path off the TPU); _level1_tpu against the JAX
  `_level1_tpu` with the affine add_packed step.
- msm_gpu along each new route against ch.msm_host on the n=60 stress set.

Every comparison is exact. The JAX references are jitted one add or one
level 1 at a time (eagerly they compile every primitive at every shape, ~4x
slower here); msm_tpu is not run, and neither aff_add_mixed_packed nor
l1_aff_halves_t runs in interpret mode (interleave_slab_t does, at one
window of 128 columns).
"""
import random
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hekaton_tpu.curves import pallas_curve as pc
from hekaton_tpu.curves.affine import AFF_G1 as JAFF_G1
from hekaton_tpu.curves.affine import AffineOps as JAffineOps
from hekaton_tpu.curves.affine import Aff as JAff
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.msm import pippenger as jmsm
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.affine import AFF_G1, AffineOps, Aff
from hekaton_tpu_torch.curves.torch_curve import G1
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.bn254 import R
from hekaton_tpu_torch.msm import pippenger as tmsm

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)

C, L = 6, 8  # tests/test_jax_curve_msm.py's stress-set window and column length


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _j(arr):
    """int32 limbs or words -> the JAX package's uint32 array."""
    return jnp.asarray(np.asarray(arr).view(np.uint32))


def _u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.uint32) if not isinstance(t, torch.Tensor) else t.numpy().astype(np.uint32)


def _same(got, ref) -> bool:
    return all(np.array_equal(_u32(g), _u32(r)) for g, r in zip(got, ref))


def _neg(y):
    return jf.neg(jf.FQ, y)


def _adversarial_pairs():
    """tests/test_affine.py's pairs: 6 random ones, then doubling, an
    inverse pair, inf + Q, P + inf and inf + inf."""
    ps, qs = ([ch.pt_mul(ch.g1_gen(), int(k)) for k in np.random.RandomState(s).randint(1, 2**60, size=6)]
              for s in (1, 2))
    ps += [ps[0], ps[1], None, ps[2], None]
    qs += [ps[0], ch.pt_neg(ps[1]), qs[0], None, None]
    return ps, qs


def _pack(pts):
    ax, ay = G1.pack_affine(pts)
    return _t(ax), _t(ay)


def test_aff_add_mixed_packed_plain_matches_jax_and_host():
    ps, qs = _adversarial_pairs()
    (x1, y1), (px, py) = _pack(ps), _pack(qs)
    rows = AffineOps.pack_rows(Aff(px, py))
    assert not rows[-1].any() and not rows[-2].any()  # the all-zero sentinel rows
    got = cc.aff_add_mixed_packed_plain(x1, y1, rows)
    generic = JAffineOps(jf.FqOps, "g1_aff_generic")
    ref = jax.jit(lambda x, y, r: generic.add_packed(JAff(x, y), r))(_j(x1), _j(y1), _j(rows))
    assert _same(got, ref)
    assert G1.unpack_affine(*got) == [ch.pt_add(p, q) for p, q in zip(ps, qs)]
    # AffineOps.add_packed goes through the wrapper, which takes CPU tensors here
    out = AFF_G1.add_packed(Aff(x1, y1), rows)
    assert torch.equal(out.x, got[0]) and torch.equal(out.y, got[1])
    assert _same(cc.aff_add_fused_plain(x1, y1, px, py), got)


def test_aff_prep_fin_plain_match_jax_tiles():
    ps, qs = _adversarial_pairs()
    (x1, y1), (px, py) = _pack(ps), _pack(qs)
    p_col = jnp.asarray(pc._P_ARR)
    jargs = [_j(a.numpy().T) for a in (x1, y1, px, py)]
    den, num = cc.aff_prep_plain(x1, y1, px, py)
    jden, jnum = pc._aff_prep_tiles(*jargs, p_col)
    assert _same((den, num), (np.asarray(jden).T, np.asarray(jnum).T))
    inv = tf.batch_inv_plain(tf.FQ, den)
    x3, y3 = cc.aff_fin_plain(x1, y1, px, py, inv, num)
    jx3, jy3 = pc._aff_fin_tiles(*jargs, _j(inv.numpy().T), _j(num.numpy().T), p_col)
    assert _same((x3, y3), (np.asarray(jx3).T, np.asarray(jy3).T))
    # prep -> batch_inv -> fin is the fused add, and the host's sum
    assert _same((x3, y3), cc.aff_add_fused_plain(x1, y1, px, py))
    assert G1.unpack_affine(x3, y3) == [ch.pt_add(p, q) for p, q in zip(ps, qs)]
    assert _same(cc.aff_prep(x1, y1, px, py), (den, num))
    assert _same(cc.aff_fin(x1, y1, px, py, inv, num), (x3, y3))


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


PTS, SCALARS = _stress_set()
AX, AY = (_t(a) for a in G1.pack_affine(PTS))
SC = tmsm.pack_scalars(SCALARS, G1)


def _columns(v) -> list:
    """Each column's sorted multiset of rows, from a (ncols, L, 16) array."""
    return [sorted(map(tuple, col)) for col in _u32(v)]


@pytest.fixture(scope="module")
def tsort_plans():
    """The port's and the JAX tsort plans of the stress set at blkc=128."""
    got = tmsm._plan_sorted_t(AX, AY, SC, C, L, blkc=128)
    ref = jmsm._plan_sorted_t(_j(AX), _j(AY), _j(SC), C, L, 254, _neg, blkc=128)
    return got, ref


def test_plan_sorted_t_matches_jax(tsort_plans):
    (planes, col_bucket, meta), (jplanes, jcol_bucket, jmeta) = tsort_plans
    assert meta == jmeta[:5]
    assert np.array_equal(col_bucket.numpy(), np.asarray(jcol_bucket))
    W, mcols = meta[0], meta[4] // meta[0]
    assert tuple(planes.shape) == (16, W, L, mcols) and mcols % 128 == 0
    jstack = np.stack([np.asarray(p) for p in jplanes])
    # column (w, m) is planes[:, w, :, m]: L elements of 16 words
    as_cols = lambda p: np.asarray(p).transpose(1, 3, 2, 0).reshape(W * mcols, L, 16)  # noqa: E731
    assert _columns(as_cols(planes.numpy())) == _columns(as_cols(jstack))


def test_interleave_slab_t_plain_matches_jax(tsort_plans):
    (planes, _, meta), (jplanes, _, _) = tsort_plans
    W, ncols = meta[0], meta[4]
    slab_t = cc.interleave_slab_t_plain(planes)
    assert tuple(slab_t.shape) == (L * 16, ncols)
    # the XLA interleave of msm_tpu (pippenger.py:1062-1066) on the port's planes
    jp = [_j(planes[j].numpy()) for j in range(16)]
    ref = jnp.stack(jp, axis=2).transpose(1, 2, 0, 3).reshape(L * 16, ncols)
    assert _same([slab_t], [ref])
    assert torch.equal(cc.interleave_slab_t(planes), slab_t)
    # the Pallas kernel in interpret mode, on window 0 (128 columns)
    one = pc.interleave_slab_t([p[:1] for p in jp], blkc=128)
    assert _same([slab_t[:, : ncols // W]], [one])
    # the slab holds the plan's columns: column c is the slab's c-th column
    assert _columns(slab_t.T.reshape(ncols, L, 16)) == _columns(
        np.stack([np.asarray(p) for p in jplanes]).transpose(1, 3, 2, 0).reshape(ncols, L, 16))


def _slab_t(L_: int, ncols: int = 9):
    """An (L*16, ncols) transposed slab of columns of random multiples of G
    with repeats (doubling), negations (inverse pairs) and (0,0) rows, one
    all-sentinel column; and each column's host sum."""
    r = np.random.RandomState(L_)
    g = ch.g1_gen()
    pool = [ch.pt_mul(g, int(k)) for k in r.randint(1, 2**62, size=5)]
    pool += [ch.pt_neg(a) for a in pool] + [None, None]
    cols = [[pool[i] for i in r.randint(0, len(pool), size=L_)] for _ in range(ncols)]
    cols[0] = [None] * L_
    cols[1][:3] = [pool[0], pool[0], pool[5]]  # P, P, -P
    rows = torch.stack([AffineOps.pack_rows(Aff(*_pack(col))).reshape(-1) for col in cols])
    return rows.T.contiguous(), [ch.msm_host(col, [1] * L_) for col in cols]


def test_l1_aff_halves_t_plain_matches_jax_level1_pair():
    """Two halves rounds (L=4; the routes below run three), against the
    JAX pairwise tree, which pairs neighbours: the column sums agree as
    affine points, so as limbs."""
    L_ = 4
    slab_t, want = _slab_t(L_)
    ncols = slab_t.shape[1]
    out = cc.l1_aff_halves_t_plain(slab_t, L_)
    assert tuple(out.shape) == (16, ncols)
    got = AffineOps.unpack_rows(out.T)
    ref = jax.jit(lambda rows: jmsm._level1_pair(JAFF_G1, rows, ncols, L_))(_j(slab_t.T.numpy()))
    assert _same(got, ref)
    assert G1.unpack_affine(*got) == want
    assert torch.equal(out, cc.l1_aff_halves_plain(slab_t.T.contiguous(), L_).T)
    assert torch.equal(cc.l1_aff_halves_t(slab_t, L_), out)
    slab_t, want = _slab_t(L)
    assert G1.unpack_affine(*AffineOps.unpack_rows(cc.l1_aff_halves_t_plain(slab_t, L).T)) == want


@pytest.mark.parametrize("L_", [8, 6])
def test_l1_rcb_mega_plain_transposed_equals_rows(L_):
    slab_t, want = _slab_t(L_)
    out = cc.l1_rcb_mega_plain(slab_t, L_, transposed=True)
    assert all(torch.equal(a, b) for a, b in zip(out, cc.l1_rcb_mega_plain(slab_t.T.contiguous(), L_)))
    assert all(torch.equal(a, b) for a, b in zip(out, cc.l1_rcb_mega(slab_t, L_, transposed=True)))
    aff = AFF_G1.from_proj(*out)
    assert G1.unpack_affine(aff.x, aff.y) == want


@pytest.mark.parametrize("order,col_pad", [("row", 1), ("col", 128)])
def test_plan_tpu_matches_jax(order, col_pad):
    src, table, col_bucket, meta = tmsm._plan_tpu(AX, AY, SC, C, L, order=order, col_pad=col_pad)
    jsrc, jtable, jcol_bucket, jmeta = jmsm._plan_tpu(_j(AX), _j(AY), _j(SC), C, L, 254, _neg, order=order,
                                                      col_pad=col_pad)
    assert meta == jmeta[:5]
    assert np.array_equal(col_bucket.numpy(), np.asarray(jcol_bucket))
    assert _same([table], [jtable])
    ncols = meta[4]
    assert ncols % col_pad == 0 and col_bucket[-1] == meta[2]  # pad columns carry id NB
    shape = (L, ncols) if order == "row" else (ncols, L)
    assert tuple(src.shape) == shape
    cols = src.numpy() if order == "col" else src.numpy().T
    jcols = np.asarray(jsrc) if order == "col" else np.asarray(jsrc).T
    # each column's multiset of table rows (the sorts' orders inside a bucket may differ)
    assert [sorted(c) for c in cols.tolist()] == [sorted(c) for c in jcols.tolist()]


def test_level1_tpu_matches_jax():
    """64 columns of the stress set's gather plan, the affine steps."""
    src, table, _, _ = tmsm._plan_tpu(AX, AY, SC, C, L)
    src = src[:, :64].contiguous()
    got = tmsm._level1_tpu(AFF_G1, src, table, 64, L, AFF_G1.add_packed, G=2)
    ref = jax.jit(lambda s, t: jmsm._level1_tpu(JAFF_G1, s, t, 64, L, (16,), step=JAFF_G1.add_packed))(
        jnp.asarray(src.numpy().astype(np.int32)), _j(table))
    assert _same(got, ref)
    pts = G1.unpack_affine(*AffineOps.unpack_rows(table))  # the last row, zeros, is None
    assert G1.unpack_affine(*got) == [ch.msm_host([pts[i] for i in col], [1] * L) for col in src.T.tolist()]


# (L, msm_gpu arguments, the level-1 function that runs, warns)
NEW_ROUTES = [
    (8, {"plan": "tsort"}, "l1_aff_halves_t", False),  # tsort + pair
    (6, {"plan": "tsort"}, "l1_rcb_mega", False),  # tsort + mega, then affine
    (8, {"plan": "tsort", "accum": "proj"}, "l1_rcb_mega", False),  # tsort + mega, projective
    (8, {"plan": "gather"}, "_level1_tpu", True),  # the gather default: pair -> steps
    (8, {"plan": "gather", "level1": "mega"}, "l1_rcb_mega", False),
    (8, {"plan": "gather", "accum": "proj", "level1": "steps"}, "_level1_tpu", False),
    (8, {"plan": "gather", "level1": "steps", "G": 1}, "_level1_tpu", False),
    (8, {"plan": "gather", "level1": "steps", "G": 2}, "_level1_tpu", False),
    (8, {"level1": "steps"}, "_level1_rows", False),  # wsort + steps + affine
    (6, {"level1": "steps"}, "_level1_rows", False),
]


@pytest.mark.parametrize("L_,kw,level1,warns", NEW_ROUTES)
def test_msm_gpu_new_routes_match_host_on_stress_set(monkeypatch, L_, kw, level1, warns):
    ran = []
    for name in ("l1_rcb_mega", "l1_aff_halves", "l1_aff_halves_t", "_level1_rows", "_level1_pair",
                 "_level1_tpu", "interleave_slab_t"):
        fn = getattr(tmsm, name)
        monkeypatch.setattr(tmsm, name, lambda *a, _fn=fn, _name=name, **k: ran.append(_name) or _fn(*a, **k))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = tmsm.msm_gpu(AX, AY, SC, c=C, L=L_, **kw)
    assert bool(seen) == warns
    assert ran == (["interleave_slab_t"] if kw.get("plan") == "tsort" else []) + [level1]
    assert G1.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == ch.msm_host(PTS, SCALARS)


def test_msm_gpu_rejects_a_fetch_that_does_not_divide_l():
    with pytest.raises(ValueError, match="G=3"):
        tmsm.msm_gpu(AX[:4], AY[:4], SC[:4], c=C, L=L, plan="gather", level1="steps", G=3)


def test_msm_gpu_g2_gather_matches_host_and_jax_plan(monkeypatch):
    """The gather plan on Fq2 rows (G2 resolves to proj + steps): the
    plan's table (x || -y rows, the (0,0) infinity row last) and columns
    against the JAX `_plan_tpu`, and the MSM, two steps a gather, against
    the host. 12 points with infinity, a repeat and a shared scalar, c=4
    and L=4, so the plain Fq2 formulas stay cheap."""
    from hekaton_tpu_torch.curves.torch_curve import G2

    rng = random.Random(7)
    pts = [ch.pt_mul(ch.g2_gen(), rng.randrange(1, 2**30)) for _ in range(12)]
    pts[3], pts[5] = None, pts[4]
    scalars = [rng.randrange(R) for _ in range(12)]
    scalars[0], scalars[1], scalars[2] = 0, 1, R - 1
    scalars[6:10] = [scalars[6]] * 4
    ax, ay = (_t(a) for a in G2.pack_affine(pts))
    sc = tmsm.pack_scalars(scalars, G2)
    c, L_ = 4, 4
    src, table, col_bucket, meta = tmsm._plan_tpu(ax, ay, sc, c, L_)
    jsrc, jtable, jcol_bucket, jmeta = jmsm._plan_tpu(_j(ax), _j(ay), _j(sc), c, L_, 254, _neg)
    assert meta == jmeta[:5]
    assert np.array_equal(col_bucket.numpy(), np.asarray(jcol_bucket))
    assert _same([table], [jtable]) and not table[-1].any()
    assert [sorted(col) for col in src.numpy().T.tolist()] == [sorted(col) for col in np.asarray(jsrc).T.tolist()]

    ran = []
    fn = tmsm._level1_tpu
    monkeypatch.setattr(tmsm, "_level1_tpu", lambda *a, **k: ran.append(k) or fn(*a, **k))
    out = tmsm.msm_gpu(ax, ay, sc, c=c, L=L_, plan="gather", G=2)
    assert len(ran) == 1 and tuple(out.x.shape) == (2, 16)
    assert G2.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == ch.msm_host(pts, scalars)
