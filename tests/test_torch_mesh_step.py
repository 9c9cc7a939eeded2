"""DistributedProverStep (runtime/spmd.py) and the mesh's local MSMs on a
world of one rank, in process, over gloo:

- DistributedProverStep's two stages, with the G1 and G2 B tables, on the
  default route and with force_ladder, against the JAX package's msm_host
  and witness_map_host;
- msm_gpu on tables whose tail is (0, 0) rows with zero scalars (the
  padding of MeshProver's tables) against msm_host;
- TorchBackend.msm and the mesh's local MSMs route every length alike
  (cpgroth16/backend.py::device_msm, the one rule of both), a batch of
  compact MSMs in one call.

tests/test_torch_spmd.py holds the mesh, the sharded NTT and the folds;
tests/test_torch_mesh_ranks.py runs the step on four ranks.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import hekaton_tpu.cpgroth16.backend as jbackend
from hekaton_tpu.curves import host as jch
from hekaton_tpu_torch.cpgroth16 import backend as tbackend
from hekaton_tpu_torch.cpgroth16.data_structures import PointVec
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.curves.torch_curve import G1, G2, Jac
from hekaton_tpu_torch.msm import pippenger as pip
from hekaton_tpu_torch.runtime import spmd

import mesh_ranks

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    m = spmd.make_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


@pytest.mark.parametrize("force_ladder", [False, True])
def test_prover_step_matches_host(mesh, force_ladder):
    """Stage 0 and stage 1 (A, H, L, B-G1, B-G2) of S = 2 subcircuits on
    tables of 8 to 64 points (the compact bucket msm at 40 and 64 points on
    the default route, the ladder everywhere with force_ladder), shared
    tables on the default route and per-subcircuit ones with force_ladder."""
    case = mesh_ranks.step_case(ch, tbackend._host_ntt, S=2, m=64, ncols=40)
    got = mesh_ranks.run_step(mesh, case, slice(0, 2), force_ladder=force_ladder, batched_tables=force_ladder)
    jcase = mesh_ranks.step_case(jch, jbackend._host_ntt, S=2, m=64, ncols=40)
    want = mesh_ranks.step_expected(jcase, jch.msm_host, jbackend.witness_map_host)
    for k in want:
        enc, jenc = (ch.g2_to_bytes, jch.g2_to_bytes) if k == "bh" else (ch.g1_to_bytes, jch.g1_to_bytes)
        assert [enc(p) for p in got[k]] == [jenc(p) for p in want[k]], k


@pytest.mark.parametrize("curve,route", [("g1", {}), ("g1", {"accum": "proj"}), ("g2", {})])
def test_msm_gpu_infinity_tail(curve, route):
    """msm_gpu's plan and level 1 on a table padded with (0, 0) rows whose
    scalars are zero, as MeshProver pads its tables, and one (0, 0) row
    with a non-zero scalar: the host's MSM of the real points."""
    c_ops, gen = (G1, ch.g1_gen()) if curve == "g1" else (G2, ch.g2_gen())
    n, tail = (512, 96) if curve == "g1" else (96, 32)
    rs = np.random.RandomState(7)
    pts = [ch.pt_mul(gen, int(k)) for k in rs.randint(1, 2**30, size=n - tail)] + [None] * tail
    pts[3] = None
    scal = [int(v) for v in rs.randint(1, 2**62, size=n - tail, dtype=np.int64)] + [0] * tail
    ax, ay = (torch.from_numpy(a) for a in c_ops.pack_affine(pts))
    out = pip.msm_gpu(ax, ay, pip.pack_scalars(scal, c_ops), c=5, L=4, nbits=64, **route)
    got = c_ops.unpack_jacobian(Jac(*(a[None] for a in out)))[0]
    want = ch.msm_host(pts, scal)
    assert (ch.g1_to_bytes(got) == ch.g1_to_bytes(want)) if curve == "g1" else (ch.g2_to_bytes(got) == ch.g2_to_bytes(want))


def test_local_msm_routes_like_backend(monkeypatch):
    """TorchBackend.msm and the mesh's local MSMs share one rule
    (cpgroth16/backend.py::device_msm): on each length both reach the same
    ladder, bucket msm or msm_gpu call (recorded at pippenger's entry
    points, which return the identity), and two local MSMs of one length
    on the compact route run as one batched call."""
    calls = []
    inf = Jac(*(t[0] for t in G1.inf((1,), "cpu")))
    msm = pip.msm

    def ident(sc):
        return Jac(*(t.expand(sc.shape[:-2] + t.shape) for t in inf))

    def fake_ladder(curve, ax, ay, sc, nbits=None):
        calls.append(("ladder", sc.shape[-2], nbits))
        return ident(sc)

    def fake_msm(curve, ax, ay, sc, c=None, K=32, nbits=None):
        if pip.takes_ladder(sc.shape[-2]):
            return msm(curve, ax, ay, sc, c=c, K=K, nbits=nbits)  # the real msm reaches the ladder
        calls.append(("bucket", sc.shape[-2], c))
        return ident(sc)

    monkeypatch.setattr(pip, "_msm_ladder", fake_ladder)
    monkeypatch.setattr(pip, "msm", fake_msm)
    monkeypatch.setattr(pip, "msm_gpu", lambda ax, ay, sc, c, L, **kw: calls.append(("gpu", ax.shape[0], c, L)) or inf)
    backend = tbackend.TorchBackend("cpu")
    for n in (1, 4, 32, 33, 100, 2048, 2049, 5000):
        vec = PointVec([ch.g1_gen()] * n, G1)
        backend.msm(vec, [1] * n)
        seq = calls[:]
        del calls[:]
        ax, ay = vec.device_chunk(0, n, n, "cpu")
        entry = (ax, ay, pip.pack_scalars([1] * n, G1))
        for k in (1, 2):
            out = spmd._local_msms(G1, [entry] * k, None, False)
            want = seq * k if seq[0][0] == "gpu" else seq
            assert calls == want and len(seq) == 1 and len(out) == k, (n, k, seq, calls)
            del calls[:]
    assert backend.ran["g1_msm_compact"] == 6 and backend.ran["g1_msm_gpu"] == 2
