"""The port's mesh runtime (runtime/spmd.py, ntt/sharded.py) on a world of
one rank, in process, over gloo, against the JAX package:

- make_mesh's default shapes against the JAX make_mesh at 1, 2, 4 and 8
  devices (the conftest's 8 virtual CPU devices), and the world-size check;
  a CUDA mesh without a card raises (no fallback to gloo or the CPU);
- make_sharded_ntt at D = 1, forward and inverse at n = 1,024, bit for bit
  against the JAX make_sharded_ntt on a 1x8 mesh;
- fold_partials against the JAX fold_partials, as affine points, on 4
  partials x 2 lanes with an infinity and two equal partials;
- sharded_msm_fn against the JAX package's msm_host.

tests/test_torch_mesh_step.py holds DistributedProverStep and the local
MSMs; tests/test_torch_mesh_ranks.py runs the same code on four ranks.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hekaton_tpu.curves import host as jch
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.torch_curve import G1, Jac
from hekaton_tpu_torch.fields import torch_field as tf
from hekaton_tpu_torch.fields.bn254 import R
from hekaton_tpu_torch.msm import pippenger as pip
from hekaton_tpu_torch.ntt.sharded import make_sharded_ntt
from hekaton_tpu_torch.runtime import spmd

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    m = spmd.make_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_defaults(n):
    import jax

    from hekaton_tpu.runtime.spmd import make_mesh as jmake_mesh

    assert len(jax.devices()) >= 8
    assert spmd.mesh_shape(n) == jmake_mesh(n).devices.shape


def test_make_mesh_world_of_one(mesh):
    assert (mesh.shape, mesh.coords, mesh.device, dist.get_backend()) == ((1, 1), (0, 0), torch.device("cpu"), "gloo")
    assert spmd.make_mesh(1, sub=1, pts=1, device="cpu").shape == (1, 1)
    for kw in ({"n_devices": 2}, {"sub": 2, "pts": 1}, {"sub": 1, "pts": 3}):
        with pytest.raises(ValueError):
            spmd.make_mesh(device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a card"):
            spmd.make_mesh(device="cuda")
    # a CUDA mesh on this gloo group: refused, never run on gloo
    with pytest.raises(RuntimeError):
        spmd.init_group("cuda")


@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_ntt_matches_jax(mesh, inverse):
    import jax
    import jax.numpy as jnp

    from hekaton_tpu.fields import jax_field as jf
    from hekaton_tpu.ntt.sharded import make_sharded_ntt as jmake_sharded_ntt
    from hekaton_tpu.runtime.spmd import make_mesh as jmake_mesh

    n = 1024
    rs = np.random.RandomState(0)
    vals = [int(x) % R for x in rs.randint(1, 2**62, size=n)]
    got = make_sharded_ntt(mesh, n, inverse=inverse)(tf.tensor(tf.FR.pack(vals), "cpu"))
    want = jax.jit(jmake_sharded_ntt(jmake_mesh(8, sub=1, pts=8), n, inverse=inverse))(jnp.asarray(jf.FR.pack(vals)))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def _jac_ints(pt, lam):
    """A host affine point as Jacobian ints (X, Y, Z) = (x l^2, y l^3, l);
    None -> (1, 1, 0)."""
    if pt is None:
        return 1, 1, 0
    return pt[0] * lam * lam % ch.P, pt[1] * pow(lam, 3, ch.P) % ch.P, lam


def test_fold_partials_matches_jax():
    import jax
    import jax.numpy as jnp

    from hekaton_tpu.curves.jax_curve import G1 as JG1
    from hekaton_tpu.curves.jax_curve import Jac as JJac
    from hekaton_tpu.fields import jax_field as jf
    from hekaton_tpu.runtime.spmd import fold_partials as jfold_partials

    p, q, r = (ch.pt_mul(ch.g1_gen(), k) for k in (5, 7, 11))
    # [4 partials, 2 lanes]: lane 0 adds P to an equal P, lane 1 starts at infinity
    parts = [[(p, 3), (None, 1)], [(p, 9), (q, 2)], [(None, 1), (r, 4)], [(q, 6), (r, 8)]]
    ints = [[_jac_ints(pt, lam) for pt, lam in row] for row in parts]

    def coords(pack):
        return [np.stack([pack([row[lane][k] for lane in range(2)]) for row in ints]) for k in range(3)]

    got = spmd.fold_partials(G1, Jac(*(torch.from_numpy(a) for a in coords(tf.FQ.pack))))
    want = jax.jit(lambda p: jfold_partials(JG1, p))(JJac(*(jnp.asarray(a) for a in coords(jf.FQ.pack))))
    expected = [ch.pt_add(ch.pt_add(ch.pt_add(p, p), None), q), ch.pt_add(ch.pt_add(q, r), r)]
    assert G1.unpack_jacobian(got) == JG1.unpack_jacobian(want) == expected
    # one partial: returned as it is
    one = Jac(*(a[:1] for a in Jac(*(torch.from_numpy(a) for a in coords(tf.FQ.pack)))))
    assert all(torch.equal(a, b) for a, b in zip(spmd.fold_partials(G1, one), (c[0] for c in one)))


def test_sharded_msm_matches_host(mesh):
    pts, scal = [], [int(v) for v in np.random.RandomState(0).randint(1, 2**60, size=64, dtype=np.int64)]
    p = ch.g1_gen()
    for _ in range(64):
        pts.append(p)
        p = ch.pt_dbl(p)
    ax, ay = (torch.from_numpy(a) for a in G1.pack_affine(pts))
    out = spmd.sharded_msm_fn(mesh, G1)(ax, ay, pip.pack_scalars(scal, G1))
    assert G1.unpack_jacobian(Jac(*(a[None] for a in out)))[0] == jch.msm_host(pts, scal)
