"""The compact msm's chains of BN254 G1 Jacobian ops, one launch each
(curves/cuda_curve.py: jac_ladder, jac_sum, jac_horner, whose kernels are
csrc/curve.cu's jac_ladder_kernel, jac_sum_kernel and jac_horner_kernel)
against the loops of single ops they replace and the JAX package:

- each chain wrapper on CPU tensors against the loop the compact msm ran
  before it, CurveOps' ladder, sum_in_order and horner through G1's
  single-op wrappers (dbl, add and add_mixed), as affine points: the chains
  run the complete projective formulas (jac_ladder_plain, jac_sum_plain,
  jac_horner_plain), whose limbs tests/test_torch_horner.py holds to the
  kernels' models and Python-int RCB chains;
- each against an eager walk of the Pallas bodies `_dbl_tiles`,
  `_madd_tiles` and `_add_tiles` (no pallas_call; their field ops
  `tile_mul`, `tile_add` and `tile_sub` each jitted alone, which keeps the
  walk to seconds) at a short ladder (nbits = 16: the JAX `_msm_ladder`'s
  steps), a sum of K = 4 and a small Horner (W = 3, c = 2), as affine
  points;
- msm/pippenger.py::msm on BN254 G1 at 1, 5, 28, 32 and 33 points (32-bit
  scalars, nbits = 32) as points against curves/host.py::msm_host, with one
  jac_ladder call a ladder, one jac_horner call a bucket MSM, and no dbl
  call and no one-lane add call left.

On the CPU every wrapper runs its plain version; chip_smoke.py holds the
kernels against them on the card, at the main paths' shapes and on edge
lanes.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hekaton_tpu.curves import pallas_curve as pc
from hekaton_tpu_torch.cpgroth16.backend import TorchBackend
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.torch_curve import G1, CurveOps, Jac
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.bn254 import P, R
from hekaton_tpu_torch.msm import pippenger as tmsm

torch.set_num_threads(1)

NBITS = 16  # the short ladder of the loop and Pallas comparisons
LANES = 4


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _tiles(t: torch.Tensor):
    """(n, 16) limbs -> the Pallas bodies' (16, n) uint32 tile."""
    return jnp.asarray(t.numpy().view(np.uint32).T)


def _limbs(tile) -> torch.Tensor:
    return torch.from_numpy(np.asarray(tile).T.astype(np.int32))


def _jacobian(pts: list, r: random.Random) -> Jac:
    """Host affine points (None the identity, (1, 1, 0)) -> Montgomery
    Jacobian limbs under random z."""
    xs, ys, zs = [], [], []
    for pt in pts:
        z = 0 if pt is None else r.randrange(2, P)
        xs.append(1 if pt is None else pt[0] * z * z % P)
        ys.append(1 if pt is None else pt[1] * z ** 3 % P)
        zs.append(z)
    return Jac(*(_t(tf.FQ.pack(v)) for v in (xs, ys, zs)))


def _inputs(seed: int = 13):
    """LANES affine points (an identity lane) with 16-bit scalars (0, 1 and
    2^16 - 1 among them); a (K=4, LANES) Jacobian stack with an identity, a
    doubling (P added to P), an inverse pair and a Jacobian infinity with
    X, Y != (1, 1) (an inverse pair's `add` output); and LANES sets of W=3
    Jacobian window sums, set i in lane i of a (3, LANES) stack, one with
    an identity window and one with the `add` output's infinity."""
    r = random.Random(seed)
    g = ch.g1_gen()
    pts = [ch.pt_mul(g, r.randrange(1, R)) for _ in range(LANES)]
    pts[1] = None
    scal = [0, 1, (1 << NBITS) - 1] + [r.randrange(1 << NBITS) for _ in range(LANES - 3)]
    ax, ay = (_t(a) for a in G1.pack_affine(pts))
    sc = tmsm.pack_scalars(scal, G1)
    rows = [[ch.pt_mul(g, r.randrange(1, R)) for _ in range(LANES)] for _ in range(4)]
    rows[0][0] = None
    rows[1][1] = rows[0][1]
    rows[1][2] = ch.pt_neg(rows[0][2])
    stack = [_jacobian(row, r) for row in rows]
    stack = Jac(*(torch.stack([s[k] for s in stack]) for k in range(3)))
    ws = [[ch.pt_mul(g, r.randrange(1, R)) for _ in range(LANES)] for _ in range(3)]
    ws[0][3] = None
    ws = [_jacobian(row, r) for row in ws]
    ws = Jac(*(torch.stack([w[k] for w in ws]) for k in range(3)))
    p = _jacobian([ch.pt_mul(g, 7)], r)
    inf = cc.add_plain(*p, p.x, tf.neg(tf.FQ, p.y), p.z)  # z = 0 under the generic x3, y3
    for a, b in zip(stack, inf):
        a[3, 3] = b[0]
    for a, b in zip(ws, inf):
        a[1, 2] = b[0]
    return (ax, ay, sc), stack, ws


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _points(p) -> list:
    """One Jacobian point's (16,) limbs -> [its host affine point]."""
    return G1.unpack_jacobian(Jac(*(a[None] for a in p)))


def test_chain_wrappers_match_the_single_op_loops():
    (ax, ay, sc), stack, ws = _inputs()
    lad = cc.jac_ladder(ax, ay, sc, NBITS)
    assert _same(lad, cc.jac_ladder_plain(ax, ay, sc, NBITS))
    assert G1.unpack_jacobian(lad) == G1.unpack_jacobian(CurveOps.ladder(G1, ax, ay, sc, NBITS))
    sums = cc.jac_sum(*stack)
    assert _same(sums, cc.jac_sum_plain(*stack))
    assert G1.unpack_jacobian(sums) == G1.unpack_jacobian(CurveOps.sum_in_order(G1, stack))
    for lane in range(LANES):
        x, y, z = (a[:, lane].contiguous() for a in ws)
        got = cc.jac_horner(x, y, z, 2)
        assert _same(got, cc.jac_horner_plain(x, y, z, 2)), f"Horner set {lane}"
        assert _points(got) == _points(CurveOps.horner(G1, Jac(x, y, z), 2)), f"Horner set {lane}"
    # the ladder's lanes are the host's multiples, the sum the host's sum
    got = G1.unpack_jacobian(cc.jac_ladder(ax, ay, sc, NBITS))
    pts = G1.unpack_affine(ax, ay)
    scal = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in sc.numpy()]
    assert got == [None if p is None else ch.pt_mul(p, s) for p, s in zip(pts, scal)]
    with pytest.raises(ValueError):
        cc.jac_ladder(ax, ay, sc, 257)
    with pytest.raises(ValueError):
        cc.jac_horner(ws.x[:0, 0], ws.y[:0, 0], ws.z[:0, 0], 2)


def test_chains_match_pallas_bodies(monkeypatch):
    """The chains against eager walks of the Pallas bodies at (16, LANES)
    tiles, as affine points: the ladder's dbl, madd and select a step; the
    sum's adds; the Horner's doubles and adds, LANES independent sets a
    tile."""
    for name in ("tile_mul", "tile_add", "tile_sub"):  # the bodies look them up at call time
        monkeypatch.setattr(pc, name, jax.jit(getattr(pc, name)))
    (ax, ay, sc), stack, ws = _inputs()
    p_col = jnp.asarray(pc._P_ARR)
    one = _tiles(G1.inf((LANES,), "cpu").x)
    inf = (one, one, jnp.zeros_like(one))
    s = sc.long()
    acc, qx, qy = inf, _tiles(ax), _tiles(ay)
    for j in range(NBITS - 1, -1, -1):
        bit = jnp.asarray((((s[:, j // 16] >> (j % 16)) & 1) == 1).numpy())[None, :]
        acc = pc._dbl_tiles(*acc, p_col)
        added = pc._madd_tiles(*acc, qx, qy, p_col)
        acc = tuple(pc.tile_select(bit, a, b) for a, b in zip(added, acc))
    assert G1.unpack_jacobian(cc.jac_ladder(ax, ay, sc, NBITS)) == G1.unpack_jacobian(Jac(*(_limbs(t) for t in acc)))
    acc = inf
    for j in range(stack.x.shape[0]):
        acc = pc._add_tiles(*acc, *(_tiles(a[j]) for a in stack), p_col)
    assert G1.unpack_jacobian(cc.jac_sum(*stack)) == G1.unpack_jacobian(Jac(*(_limbs(t) for t in acc)))
    acc = tuple(_tiles(a[2]) for a in ws)
    for w in (1, 0):
        for _ in range(2):
            acc = pc._dbl_tiles(*acc, p_col)
        acc = pc._add_tiles(*acc, *(_tiles(a[w]) for a in ws), p_col)
    want = G1.unpack_jacobian(Jac(*(_limbs(t) for t in acc)))
    for lane in range(LANES):
        got = cc.jac_horner(*(a[:, lane].contiguous() for a in ws), 2)
        assert _points(got) == [want[lane]], f"Horner set {lane}"


@pytest.mark.parametrize("n", [1, 5, 28, 32, 33])
def test_compact_msm_matches_host(n, monkeypatch):
    """The compact msm on BN254 G1 as points against msm_host, with 32-bit
    scalars (0, 1 and 2^32 - 1 among them), an identity point and a
    repeated point; one jac_ladder call a ladder, one jac_horner call a
    bucket MSM, no dbl call and no add call on one lane."""
    calls = {"jac_ladder": 0, "jac_sum": 0, "jac_horner": 0, "dbl": 0, "add 1 lane": 0}

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    for name in ("jac_ladder", "jac_sum", "jac_horner"):  # G1Ops looks them up at call time
        monkeypatch.setattr(cc, name, counted(name, getattr(cc, name)))
    monkeypatch.setattr(cc, "dbl", counted("dbl", cc.dbl))
    add = cc.add

    def add_counted(*args):
        calls["add 1 lane"] += args[0].numel() == 16
        return add(*args)

    monkeypatch.setattr(cc, "add", add_counted)
    r = random.Random(n)
    g = ch.g1_gen()
    pts = [ch.pt_mul(g, r.randrange(1, R)) for _ in range(min(n, 12))]
    pts = [pts[i % len(pts)] for i in range(n)]
    scal = [r.randrange(1 << 32) for _ in range(n)]
    scal[:3] = [0, 1, (1 << 32) - 1][:n]
    if n > 4:
        pts[3], pts[4] = None, pts[2]
    ax, ay = (_t(a) for a in G1.pack_affine(pts))
    out = tmsm.msm(G1, ax, ay, tmsm.pack_scalars(scal, G1), c=TorchBackend.compact_window(n), nbits=32)
    assert G1.unpack_jacobian(Jac(*(a[None] for a in out)))[0] == ch.msm_host(pts, scal)
    ladder = n <= tmsm.MSM_LADDER_THRESHOLD
    assert (calls["jac_ladder"], calls["jac_horner"]) == ((1, 0) if ladder else (0, 1)), calls
    assert (calls["jac_sum"] >= 1) == (n > 1) and calls["dbl"] == 0 and calls["add 1 lane"] == 0, calls
