"""The port's compact MSM route against the JAX package and the host ground
truth:

- the plain versions of the dbl and add kernels (curves/cuda_curve.py) against
  the Pallas bodies `_dbl_tiles` and `_add_tiles`, called eagerly on
  transposed limbs (no pallas_call, no jit), bit for bit; against the XLA
  `CurveOps.dbl` bit for bit, and the XLA `CurveOps.add` in affine, with the
  lanes that differ as limbs named;
- msm/pippenger.py::msm (G1 on the dbl/add/madd wrappers, G2 on the plain
  Fq2 formulas) against curves/host.py::msm_host (tests/test_torch_msm.py
  holds it against the jitted JAX `msm` at one size: its XLA:CPU compile
  takes ~30 s);
- TorchBackend's routing: TpuBackend's padded length below 4,096 (n <= 2,048)
  to the compact msm with the window width the JAX msm derives from that
  length, longer MSMs to msm_gpu.

On the CPU every kernel wrapper runs its plain version; chip_smoke.py holds
the kernels against them on the card.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hekaton_tpu.curves import pallas_curve as pc
from hekaton_tpu.curves.jax_curve import G1 as JG1
from hekaton_tpu.curves.jax_curve import CurveOps as JaxCurveOps
from hekaton_tpu.curves.jax_curve import Jac as JaxJac
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu_torch.cpgroth16 import backend as tbackend
from hekaton_tpu_torch.cpgroth16.data_structures import PointVec
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.torch_curve import G1, G2, Jac
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.bn254 import P, R
from hekaton_tpu_torch.msm import pippenger as tmsm

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)

JAX_G1 = JaxCurveOps(jf.FqOps, "g1_xla")  # the XLA formulas


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _j(arr):
    return jnp.asarray(np.asarray(arr).view(np.uint32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _jacobian_lanes(n: int = 256):
    """n lanes of Jacobian P and Q, each lane under its own random z:
    lane 0 P = inf (1, 1, 0); lane 1 Q = inf; lane 2 Q = P under another z
    (the doubling escape); lane 3 Q = -P; lane 4 P = (1, 1, 0) and Q = (x, y, 0),
    two infinities with different limbs; the rest generic. Returns (P, Q) as
    packed limb arrays and as host affine points (None = infinity)."""
    r = random.Random(9)
    ps = [ch.pt_mul(ch.g1_gen(), r.randrange(1, R)) for _ in range(n)]
    qs = [ch.pt_mul(ch.g1_gen(), r.randrange(1, R)) for _ in range(n)]
    ps[0], qs[1], qs[2], qs[3] = None, None, ps[2], ch.pt_neg(ps[3])
    ps[4], qs[4] = None, None

    def jac(pts, inf):
        xs, ys, zs = [], [], []
        for i, pt in enumerate(pts):
            if pt is None:
                x, y, z = inf.get(i, (1, 1))[0], inf.get(i, (1, 1))[1], 0
            else:
                z = r.randrange(2, P)
                x, y = pt[0] * z * z % P, pt[1] * z * z * z % P
            xs.append(x)
            ys.append(y)
            zs.append(z)
        return tuple(tf.FQ.pack(v) for v in (xs, ys, zs))

    # Montgomery limbs of x = 1 and y = 1 are the one constant: as inf() = (1, 1, 0)
    one = tf.FQ.from_mont(1)
    p = jac(ps, {0: (one, one), 4: (one, one)})
    q = jac(qs, {1: (one, one), 4: (r.randrange(P), r.randrange(P))})
    return p, q, ps, qs


def test_dbl_add_plain_match_pallas_bodies_and_xla():
    (px, py, pz), (qx, qy, qz), ps, qs = _jacobian_lanes()
    p_col = jnp.asarray(pc._P_ARR)
    tp, tq = tuple(_t(a) for a in (px, py, pz)), tuple(_t(a) for a in (qx, qy, qz))
    jp, jq = tuple(_j(a) for a in (px, py, pz)), tuple(_j(a) for a in (qx, qy, qz))

    got = cc.dbl(*tp)  # the wrapper on CPU tensors is the plain version
    tiles = pc._dbl_tiles(*(a.T for a in jp), p_col)
    xla = JAX_G1.dbl(JaxJac(*jp))
    for g, k, x in zip(got, tiles, xla):
        assert np.array_equal(_u32(g), np.asarray(k).T)
        assert np.array_equal(_u32(g), np.asarray(x))
    assert G1.unpack_jacobian(got) == [None if a is None else ch.pt_dbl(a) for a in ps]
    assert all(torch.equal(a, b) for a, b in zip(G1.dbl(Jac(*tp)), got))

    got = cc.add(*tp, *tq)
    tiles = pc._add_tiles(*(a.T for a in jp), *(a.T for a in jq), p_col)
    for g, k in zip(got, tiles):
        assert np.array_equal(_u32(g), np.asarray(k).T)
    expected = [ch.pt_add(a, b) for a, b in zip(ps, qs)]
    assert G1.unpack_jacobian(got) == expected
    xla = JAX_G1.add(JaxJac(*jp), JaxJac(*jq))
    assert JG1.unpack_jacobian(xla) == expected
    # as limbs they differ where _add_tiles and the XLA formula order their
    # infinity overrides differently: the inverse pair (z3 zeroed alone,
    # against inf() = (1, 1, 0)) and inf + inf (Q against P)
    differ = [i for i in range(len(ps)) if any((_u32(g[i]) != np.asarray(x[i])).any() for g, x in zip(got, xla))]
    assert differ == [3, 4]
    assert not got.z[3].any() and got.x[3].any()
    assert all(torch.equal(a[4], b[4]) for a, b in zip(got, tq))
    assert all(torch.equal(a, b) for a, b in zip(G1.add(Jac(*tp), Jac(*tq)), got))
    # the generic formula (torch_curve.CurveOps.add) is the XLA one, limb for limb
    plain = cc._G1_PLAIN.add(Jac(*tp), Jac(*tq))
    assert all(np.array_equal(_u32(a), np.asarray(b)) for a, b in zip(plain, xla))


def _msm_inputs(curve, n: int, seed: int):
    """n points (an infinity row and a repeated point among them) and
    scalars with 0, 1 and r-1."""
    r = random.Random(seed)
    gen = ch.g1_gen() if curve is G1 else ch.g2_gen()
    base = [ch.pt_mul(gen, r.randrange(1, R)) for _ in range(min(n, 16))]
    pts = [base[i % len(base)] for i in range(n)]
    sc = [r.randrange(R) for _ in range(n)]
    for i, s in zip(range(n), (0, 1, R - 1)):
        sc[i] = s
    if n > 4:
        pts[3] = None
        pts[4] = pts[2]
    return pts, sc


@pytest.mark.parametrize("curve_id,n", [(1, 1), (1, 5), (1, 32), (1, 33), (1, 100), (1, 2048), (2, 33)])
def test_compact_msm_matches_host(curve_id, n):
    curve = G1 if curve_id == 1 else G2
    pts, sc = _msm_inputs(curve, n, seed=n)
    ax, ay = curve.pack_affine(pts)
    c = tbackend.TorchBackend.compact_window(n)
    out = tmsm.msm(curve, _t(ax), _t(ay), tmsm.pack_scalars(sc, curve), c=c)
    got = curve.unpack_jacobian(Jac(*(a[None] for a in out)))[0]
    expected = ch.msm_host(pts, sc)
    if curve_id == 1:
        assert got == expected
    else:
        assert got is not None and (ch.g2_to_bytes(got) == ch.g2_to_bytes(expected))


def test_torch_backend_routes_like_tpu_backend(monkeypatch):
    """n <= 2,048 -> the compact msm with the JAX msm's window width for
    TpuBackend's padded length; longer MSMs -> msm_gpu in chunks."""
    calls = []

    def fake(route):
        def run(*args, **kw):
            ax = args[1] if route == "compact" else args[0]
            calls.append((route, ax.shape[0], kw.get("c")))
            return Jac(*(t[0] for t in G1.inf((1,), "cpu")))

        return run

    monkeypatch.setattr(tmsm, "msm", fake("compact"))
    monkeypatch.setattr(tmsm, "msm_gpu", fake("gpu"))
    backend = tbackend.TorchBackend("cpu")
    monkeypatch.setattr(backend, "G1_CHUNK", 4096)
    vec = PointVec([ch.g1_gen()] * 9000, G1)
    for n in (1, 4, 5, 33, 100, 2048, 2049, 9000):
        assert backend.msm(vec, [1] * n) is None
    assert calls == [("compact", 1, 2), ("compact", 4, 2), ("compact", 5, 2), ("compact", 33, 3),
                     ("compact", 100, 4), ("compact", 2048, 8), ("gpu", 2049, 7),
                     ("gpu", 4096, 7), ("gpu", 4096, 7), ("gpu", 808, 5)]
    assert backend.ran == {"g1_msm_compact": 6, "g2_msm_compact": 0, "g1_msm_gpu": 4, "g2_msm_gpu": 0,
                           "fixed_base_gpu": 0, "witness_map_gpu": 0}
    # the JAX package's rule, at TpuBackend's padded lengths
    for n in (1, 5, 33, 100, 1000, 2048):
        m = 1 << max(2, (n - 1).bit_length())
        assert tbackend.TorchBackend.compact_window(n) == max(2, min(13, int(np.log2(m)) - 3))
    assert tbackend.TorchBackend.compact_window(2049) is None
