"""The port imports and runs with JAX and the JAX package blocked.

A subprocess installs a meta-path hook that refuses `jax`, `jaxlib` and
`hekaton_tpu` (the port keeps its own copies of the host modules it needs),
imports every hekaton_tpu_torch module (the CLI, the workloads and the wire
format among them), and runs the whole
PortalChainParams(2) flow on the CPU with the port alone: setup and stage 0
with TorchBackend("cpu"), stage 1 with the port's HostBackend (whose
stateless recommit must reproduce TorchBackend's stage-0 commitments),
per-proof verify, aggregation and aggregate verify. A lazy import that
reaches JAX or the JAX package at run time fails it. It then runs msm_gpu
along the tsort, gather and affine steps routes against msm_host, the
compact msm's chain wrappers (jac_ladder, jac_sum, jac_horner) against
their loops of single ops (as points), the G2 Horner fold (horner_fold_g2) against the
loop of G2 doublings and adds it replaces, msm_gpu on
BLS12-381 G1 against a host sum, and the device exec tree against the host
tree. tests/test_torch_slice.py runs stage 1 on TorchBackend.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import torch

    torch.set_num_threads(1)

    BLOCKED = ("jax", "jaxlib", "hekaton_tpu")

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, _Block())

    import hekaton_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(hekaton_tpu_torch.__path__, "hekaton_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert {"hekaton_tpu_torch.cli", "hekaton_tpu_torch.workloads.vm", "hekaton_tpu_torch.workloads.vkd.vkd",
            "hekaton_tpu_torch.workloads.partitioned_r1cs", "hekaton_tpu_torch.circom.r1cs_file",
            "hekaton_tpu_torch.protocol.wire", "hekaton_tpu_torch.protocol.serialization"} <= set(names)

    from hekaton_tpu_torch.host import (AggProvingKey, PortalChainCircuit, PortalChainParams, Rng,
                                        agg_transcript, ipp_setup, tipa_key_from_ipp)
    from hekaton_tpu_torch.cpgroth16.backend import HostBackend, TorchBackend
    from hekaton_tpu_torch.cpgroth16.verifier import prepare_verifying_key, verify_proof
    from hekaton_tpu_torch.protocol.coordinator import CoordinatorStage0State
    from hekaton_tpu_torch.protocol.worker import process_stage0_request, process_stage1_request
    from hekaton_tpu_torch.runtime.keys import ProvingKeys

    backend = TorchBackend("cpu")
    circ = PortalChainCircuit.rand(Rng.from_int(1000), PortalChainParams(2))
    keys = ProvingKeys.generate("chain", circ, backend, lambda i: Rng.from_int(50 + i))
    n = circ.num_subcircuits()
    rng = Rng.from_int(1000)
    stage0 = CoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    resps0 = [process_stage0_request(rng.fork(str(i).encode()), type(circ), keys.get_pk(i), reqs0[i], backend)
              for i in range(n)]
    ipp_ck = ipp_setup(n, Rng.from_int(2000))
    stage1 = stage0.process_stage0_responses(ipp_ck, resps0)
    reqs1 = [stage1.gen_request(i) for i in range(n)]
    agg_state = stage1.into_agg_state()
    resps1 = [process_stage1_request(rng.fork(b"s1" + str(i).encode()), type(circ), keys.get_pk(i),
                                     reqs0[i], resps0[i], reqs1[i], HostBackend()) for i in range(n)]
    for i, resp in enumerate(resps1):
        assert verify_proof(prepare_verifying_key(keys.get_pk(i).vk), resp.proof, agg_state.public_inputs), i
    agg_pk = AggProvingKey(tipa_key_from_ipp(ipp_ck), keys.get_pk)
    agg_proof = agg_state.gen_agg_proof(agg_pk, resps1)
    assert agg_pk.verify_aggregate(agg_transcript(), agg_state.super_com, agg_proof, agg_state.public_inputs)

    # msm_gpu's tsort, gather and affine steps routes on the CPU
    import random, warnings
    from hekaton_tpu_torch.curves import host as ch
    from hekaton_tpu_torch.curves.torch_curve import G1, CurveOps, Jac
    from hekaton_tpu_torch.fields.bn254 import R
    from hekaton_tpu_torch.msm import pippenger as pip
    r = random.Random(3)
    pts = [ch.pt_mul(ch.g1_gen(), r.randrange(1, R)) for _ in range(20)]
    scalars = [r.randrange(R) for _ in range(20)]
    ax, ay = (torch.from_numpy(a.astype("int32")) for a in G1.pack_affine(pts))
    routes = ({"plan": "tsort"}, {"plan": "tsort", "accum": "proj"}, {"plan": "gather"},
              {"plan": "gather", "level1": "mega"}, {"level1": "steps"})
    for route in routes:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the gather default warns that "pair" becomes "steps"
            out = pip.msm_gpu(ax, ay, pip.pack_scalars(scalars, G1), c=6, L=4, **route)
        assert G1.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == ch.msm_host(pts, scalars), route

    # the compact msm's chain wrappers against their loops of single ops, as
    # points (the chains run the complete projective formulas)
    from hekaton_tpu_torch.curves import cuda_curve as cc
    lx, ly, lsc = ax[:4], ay[:4], pip.pack_scalars(scalars[:4], G1)
    lad = cc.jac_ladder(lx, ly, lsc, 8)
    assert G1.unpack_jacobian(lad) == G1.unpack_jacobian(CurveOps.ladder(G1, lx, ly, lsc, 8))
    stack = Jac(*(torch.stack([a, a.flip(0)]) for a in lad))
    assert G1.unpack_jacobian(cc.jac_sum(*stack)) == G1.unpack_jacobian(CurveOps.sum_in_order(G1, stack))
    one = lambda p: G1.unpack_jacobian(Jac(*(a[None] for a in p)))
    assert one(cc.jac_horner(*lad, 2)) == one(CurveOps.horner(G1, lad, 2))
    print("chains", flush=True)

    # the G2 window Horner fold against the loop of single G2 ops it replaces
    from hekaton_tpu_torch.curves.proj import PROJ_G2, Proj
    from hekaton_tpu_torch.curves.torch_curve import G2
    gx, gy = (torch.from_numpy(a.astype("int32"))
              for a in G2.pack_affine([ch.pt_mul(ch.g2_gen(), r.randrange(1, R)) for _ in range(3)]))
    ws = Proj(*(t.contiguous() for t in PROJ_G2.dbl(PROJ_G2.from_affine(gx, gy))))
    acc = Proj(*(t[2] for t in ws))
    for w in (1, 0):
        for _ in range(2):
            acc = PROJ_G2.dbl(acc)
        acc = PROJ_G2.add(acc, Proj(*(t[w] for t in ws)))
    assert all(torch.equal(a, b) for a, b in zip(cc.horner_fold_g2(*ws, 2), acc))
    print("g2 horner", flush=True)

    # msm_gpu on BLS12-381 G1, a scalar above BN254's r among them
    from hekaton_tpu_torch.curves.torch_curve import g1_bls12_381
    from hekaton_tpu_torch.fields import bls12_381 as bls

    def h_add(p, q):
        if p is None or q is None:
            return q if p is None else p
        if p[0] == q[0]:
            if (p[1] + q[1]) % bls.P == 0:
                return None
            lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, bls.P) % bls.P
        else:
            lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, bls.P) % bls.P
        x = (lam * lam - p[0] - q[0]) % bls.P
        return (x, (lam * (p[0] - x) - p[1]) % bls.P)

    def h_mul(p, k):
        acc = None
        while k:
            if k & 1:
                acc = h_add(acc, p)
            p, k = h_add(p, p), k >> 1
        return acc

    curve = g1_bls12_381()
    ks = [r.randrange(1, 2**32) for _ in range(20)]
    bscal = [r.randrange(bls.R) for _ in range(20)]
    bscal[0] = R + 5
    bx, by = (torch.from_numpy(a) for a in curve.pack_affine([h_mul(bls.G1_GEN, k) for k in ks]))
    out = pip.msm_gpu(bx, by, pip.pack_scalars(bscal, curve), c=6, L=4, curve=curve)
    want = h_mul(bls.G1_GEN, sum(k * s for k, s in zip(ks, bscal)) % bls.R)
    assert curve.unpack_jacobian(type(out)(*(a[None] for a in out)))[0] == want

    # the device exec tree on CPU tensors against the host tree
    from hekaton_tpu_torch.protocol.coordinator import generate_exec_tree, sort_subtraces_by_addr
    from hekaton_tpu_torch.protocol.eval_tree_torch import generate_exec_tree_device
    from hekaton_tpu_torch.protocol.transcript import RomTranscriptEntry
    sts = [[RomTranscriptEntry(r.randrange(1, 100), r.randrange(R)) for _ in range(n)] for n in (2, 3, 0, 1)]
    asts = sort_subtraces_by_addr(sts)
    host_tree, _ = generate_exec_tree("rom", agg_state.super_com, sts, asts)
    dev_tree, _ = generate_exec_tree_device("rom", agg_state.super_com, sts, asts, device="cpu")
    assert host_tree.levels == dev_tree.levels
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("modules", len(names), "ran", backend.ran, "routes", len(routes), "bls", "tree")
    """
)


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "modules" in proc.stdout and "'g1_msm_compact': 2" in proc.stdout, proc.stdout
    assert "routes 5 bls tree" in proc.stdout, proc.stdout
    assert "chains" in proc.stdout and "g2 horner" in proc.stdout, proc.stdout
    assert "'fixed_base_gpu': 0" not in proc.stdout, proc.stdout


def _imports(path: pathlib.Path) -> list:
    """The top-level module names that a source file's import lines name."""
    out = []
    for line in path.read_text().splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            out.append(words[1].split(".")[0])
    return out


def test_no_port_source_imports_jax():
    """No port source and not chip_smoke.py names jax, jaxlib or the JAX
    package in an import line (the port's own imports are relative)."""
    for path in list((REPO / "hekaton_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not {"jax", "jaxlib", "hekaton_tpu"} & set(_imports(path)), path


MESH_SCRIPT = textwrap.dedent(
    """
    import hashlib, sys
    import torch

    torch.set_num_threads(1)

    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "hekaton_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, _Block())

    from hekaton_tpu_torch.fields import torch_field as tf
    from hekaton_tpu_torch.hashes.sha256_torch import sha256_bytes_batch
    from hekaton_tpu_torch.ntt import ntt as nttm
    from hekaton_tpu_torch.ntt.sharded import make_sharded_ntt
    from hekaton_tpu_torch.runtime import DistributedProverStep, fold_partials, make_mesh, sharded_msm_fn  # noqa: F401
    from hekaton_tpu_torch.runtime.mesh_prover import MeshProver  # noqa: F401

    msgs = [bytes([i]) * 64 for i in range(4)]
    assert sha256_bytes_batch(msgs, device="cpu") == [hashlib.sha256(m).digest() for m in msgs]
    mesh = make_mesh(device="cpu")
    x = tf.tensor(tf.FR.pack(list(range(1, 257))), "cpu")
    assert torch.equal(make_sharded_ntt(mesh, 256)(x), nttm.ntt(x))
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "hekaton_tpu") for m in sys.modules)
    print("mesh", mesh.shape)
    """
)


def test_mesh_modules_run_with_jax_blocked():
    """The four modules of the mesh runtime and SHA-256 import and run with
    jax, jaxlib and hekaton_tpu blocked: digests against hashlib and a
    world-1 CPU mesh's sharded NTT against the local NTT."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", MESH_SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "mesh (1, 1)" in proc.stdout, proc.stdout
