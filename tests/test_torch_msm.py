"""The port's G1 MSM (hekaton_tpu_torch.msm.pippenger) against the JAX
package's v9 route and the host ground truth.

The JAX plan sorts with a multi-operand lax.sort that is not stable, so the
order of points inside a bucket column is not defined: the plan is compared
by its per-column bucket ids and each column's multiset of packed rows.

The whole-MSM comparison uses the n=60 stress set of
tests/test_jax_curve_msm.py::test_msm_tpu_wsort_plan_matches_host (zero, one
and r-1 scalars, a duplicated (point, scalar) pair, an infinity row) at the
same c=6, L=8. That test holds the JAX msm_tpu(plan="wsort", level1="pair")
equal to ch.msm_host on this set, so equality with ch.msm_host here is
equality with msm_tpu, without a second ~150 s XLA:CPU compile of it.

The compact msm (TorchBackend's route up to 2,048 points) is held against
the jitted JAX `msm` at one ladder size here, and against the host on more
sizes in tests/test_torch_compact_msm.py.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hekaton_tpu.curves import host as ch
from hekaton_tpu.curves.jax_curve import G1 as JG1
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.fields.bn254 import R
from hekaton_tpu.msm import pippenger as jmsm
from hekaton_tpu_torch.curves.torch_curve import G1, Jac
from hekaton_tpu_torch.msm import pippenger as tmsm

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def _stress_set():
    """tests/test_jax_curve_msm.py's stress set, drawn the same way."""
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


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int32))


def _j(arr):
    return jnp.asarray(np.asarray(arr).view(np.uint32))


@pytest.mark.parametrize("c", [4, 6, 13])
def test_signed_digits_match_jax(c):
    r = np.random.RandomState(c)
    vals = [0, 1, R - 1, (1 << 253) + 5] + [int(x) % R for x in r.randint(0, 2**62, size=28) ** 4]
    sc = tmsm.pack_scalars(vals, G1)
    assert sc.dtype == torch.int32
    assert np.array_equal(sc.numpy().astype(np.uint32), jmsm.pack_scalars(vals))
    assert np.array_equal(tmsm.digits_for_windows(sc, c).numpy(), np.asarray(jmsm.digits_for_windows(_j(sc), c)))
    mag, neg = tmsm.signed_digits_for_windows(sc, c)
    jmag, jneg = jmsm.signed_digits_for_windows(_j(sc), c)
    assert np.array_equal(mag.numpy(), np.asarray(jmag))
    assert np.array_equal(neg.numpy(), np.asarray(jneg).astype(bool))
    # the digits recompose every scalar
    for i, v in enumerate(vals):
        s = sum((-1 if neg[w, i] else 1) * int(mag[w, i]) << (c * w) for w in range(mag.shape[0]))
        assert s == v


def test_plan_matches_jax():
    c, L = 6, 8
    ax, ay = G1.pack_affine(PTS)
    sc = tmsm.pack_scalars(SCALARS, G1)
    rows, col_bucket, meta = tmsm._plan_sorted_w(_t(ax), _t(ay), sc, c, L)
    jrows, jcol_bucket, jmeta = jmsm._plan_sorted_w(
        _j(ax), _j(ay), _j(sc), c, L, 254, lambda y: jf.neg(jf.FQ, y)
    )
    assert meta == jmeta[:5]
    assert np.array_equal(col_bucket.numpy(), np.asarray(jcol_bucket))
    ncols = meta[4]
    got = rows.numpy().view(np.uint32).reshape(ncols, L, 16)
    ref = np.asarray(jrows).reshape(ncols, L, 16)
    for j in range(ncols):  # each column holds the same multiset of rows
        assert sorted(map(tuple, got[j])) == sorted(map(tuple, ref[j])), j


def test_msm_gpu_matches_host_on_stress_set():
    ax, ay = G1.pack_affine(PTS)
    sc = tmsm.pack_scalars(SCALARS, G1)
    out = tmsm.msm_gpu(_t(ax), _t(ay), sc, c=6, L=8)
    got = G1.unpack_jacobian(type(out)(*(a[None] for a in out)))[0]
    assert got == ch.msm_host(PTS, SCALARS)
    # the same Jacobian limbs read back through the JAX package's unpacking
    jac = JG1.unpack_jacobian(type(out)(*(_j(a.numpy())[None] for a in out)))
    assert jac == [got]


@pytest.mark.parametrize("n,c,L", [(1, 4, 2), (5, 4, 4), (33, 5, 8)])
def test_msm_gpu_small_shapes(n, c, L):
    r = random.Random(n)
    pts = [ch.pt_mul(ch.g1_gen(), r.randrange(1, R)) for _ in range(n)]
    scalars = [r.randrange(R) for _ in range(n)]
    ax, ay = G1.pack_affine(pts)
    out = tmsm.msm_gpu(_t(ax), _t(ay), tmsm.pack_scalars(scalars, G1), c=c, L=L)
    assert G1.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == ch.msm_host(pts, scalars)


def test_compact_msm_matches_jax_msm():
    """The JAX msm, jitted (its ladder body compiles once), at one size,
    with a zero scalar, 1, r-1 and an infinity point."""
    pts, sc = PTS[:6], SCALARS[:6]
    ax, ay = G1.pack_affine(pts)
    s = tmsm.pack_scalars(sc, G1)
    out = tmsm.msm(G1, _t(ax), _t(ay), s)
    ref = jax.jit(lambda x, y, k: jmsm.msm(JG1, x, y, k))(_j(ax), _j(ay), _j(s.numpy()))
    expected = ch.msm_host(pts, sc)
    assert JG1.unpack_jacobian(jax.tree.map(lambda a: a[None], ref))[0] == expected
    assert G1.unpack_jacobian(Jac(*(a[None] for a in out)))[0] == expected
