"""The port's mesh runtime on four ranks: a rehearsal over gloo on the CPU.

Four processes (tests/mesh_ranks.py, which imports the port alone) join
one process group through a file store under tmp_path, with a 60 s
collective timeout, and build a 2x2 and a 1x4 mesh. They run the sharded
NTT at D = 2 and 4, the sharded MSM over the 2x2 mesh, DistributedProverStep
at 2x2 with S = 4 subcircuits (its G2 B query among the MSMs) and
MeshProver at 2x2 on PortalChainParams(2) with the exec tree's algebraic
test hash. Here the parent holds every rank's results to the JAX package:
the NTT to its host NTT, the MSMs to its msm_host and witness_map_host,
and MeshProver's commitments and proofs, bit for bit, to the JAX package's
sequential process_stage0_request / process_stage1_request on its
HostBackend, from a key file that the JAX package wrote. Every proof and
the aggregate verify. The ranks are joined with a deadline of 120 s."""
import os
import pathlib
import pickle
import subprocess
import sys
import time

import pytest
import torch

import hekaton_tpu.cpgroth16.backend as jbackend
import hekaton_tpu.protocol.eval_tree as jet
import hekaton_tpu.runtime.keys as jkeys
from hekaton_tpu.curves import host as jch
from hekaton_tpu.protocol.coordinator import CoordinatorStage0State as JCoordinatorStage0State
from hekaton_tpu.protocol.ipp import ipp_setup as jipp_setup
from hekaton_tpu.protocol.worker import process_stage0_request, process_stage1_request
from hekaton_tpu.utils.rng import Rng as JRng
from hekaton_tpu.workloads.chain import PortalChainCircuit as JPortalChainCircuit
from hekaton_tpu.workloads.chain import PortalChainParams as JPortalChainParams
from hekaton_tpu_torch.cpgroth16.data_structures import deserialize_proof, serialize_proof
from hekaton_tpu_torch.cpgroth16.verifier import prepare_verifying_key, verify_proof
from hekaton_tpu_torch.runtime.keys import ProvingKeys

import mesh_ranks

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 120


def _jax_sequential(keys, n: int) -> tuple:
    """cmd_work's sequential stages on the JAX package's HostBackend."""
    backend = jbackend.HostBackend()
    circ = JPortalChainCircuit.rand(JRng.from_int(1000), keys.params)
    rng = JRng.from_int(1000)
    stage0 = JCoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    resps0 = [process_stage0_request(rng.fork(str(i).encode()), JPortalChainCircuit, keys.get_pk(i), reqs0[i], backend)
              for i in range(n)]
    stage1 = stage0.process_stage0_responses(jipp_setup(n, JRng.from_int(2000)), resps0)
    resps1 = [process_stage1_request(rng.fork(b"s1" + str(i).encode()), JPortalChainCircuit, keys.get_pk(i),
                                     reqs0[i], resps0[i], stage1.gen_request(i), backend) for i in range(n)]
    return resps0, resps1


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    prev = jet.set_tree_hash(jet.ALGEBRAIC_TEST_HASH)
    try:
        circ = JPortalChainCircuit.rand(JRng.from_int(1000), JPortalChainParams(2))
        keys = jkeys.ProvingKeys.generate("chain", circ, jbackend.HostBackend(), lambda i: JRng.from_int(50 + i))
        key_file = str(tmp / "chain.keys")
        keys.save(key_file)
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        start = time.monotonic()
        procs = []
        for r in range(WORLD):
            log = open(tmp / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "mesh_ranks.py"), str(r), str(WORLD), str(tmp / "store"),
                 str(tmp), key_file], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
        # the JAX package's sequential run, while the ranks work
        n = circ.num_subcircuits()
        seq = _jax_sequential(keys, n)
        for proc, log in procs:
            try:
                proc.wait(timeout=max(1.0, DEADLINE_S - (time.monotonic() - start)))
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        fails = [(r, p.returncode, (tmp / f"rank{r}.log").read_text()[-3000:])
                 for r, (p, _) in enumerate(procs) if p.returncode != 0]
        assert not fails, fails
    finally:
        jet.set_tree_hash(prev)
    outs = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return {"outs": outs, "seq": seq, "key_file": key_file}


def test_rank_layout(ranks):
    """Rank r sits at (r // pts, r % pts) on both meshes."""
    assert [o["coords"] for o in ranks["outs"]] == [((r // 2, r % 2), (0, r)) for r in range(WORLD)]


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ntt(ranks, D):
    """The sharded NTT at D ranks is the JAX package's host NTT on every
    rank, and its inverse gives the input back."""
    import numpy as np

    from hekaton_tpu.fields.bn254 import R

    rs = np.random.RandomState(0)
    vals = [int(v) % R for v in rs.randint(1, 2**62, size=mesh_ranks.N_NTT)]
    want = jbackend._host_ntt(vals)
    for out in ranks["outs"]:
        assert out[f"ntt{D}"] == want
        assert out[f"intt{D}"] == vals


def test_sharded_msm(ranks):
    pts, scal, _ = ranks["outs"][0]["msm"]
    want = jch.msm_host(pts, scal)
    assert all(out["msm"][2] == want for out in ranks["outs"])


def test_prover_step(ranks):
    """DistributedProverStep at 2x2, S = 4: every rank holds all four
    subcircuits' stage-0 and stage-1 MSMs, each the JAX host's."""
    case = mesh_ranks.step_case(jch, jbackend._host_ntt)
    want = mesh_ranks.step_expected(case, jch.msm_host, jbackend.witness_map_host)
    want = {k: [jch.g2_to_bytes(p) if k == "bh" else jch.g1_to_bytes(p) for p in v] for k, v in want.items()}
    for out in ranks["outs"]:
        assert out["step"] == want


def test_mesh_prover_bit_identical(ranks):
    """MeshProver's stage-0 commitments and stage-1 proofs on every rank are
    the JAX package's sequential HostBackend ones, byte for byte."""
    from hekaton_tpu.cpgroth16.data_structures import serialize_proof as jserialize_proof

    seq0, seq1 = ranks["seq"]
    coms = [(r.subcircuit_idx, jch.g1_to_bytes(r.com), r.com_seed) for r in seq0]
    proofs = [(r.subcircuit_idx, jserialize_proof(r.proof)) for r in seq1]
    for out in ranks["outs"]:
        assert out["mesh_prover"]["coms"] == coms
        assert out["mesh_prover"]["proofs"] == proofs


def test_mesh_prover_proofs_verify(ranks):
    keys = ProvingKeys.load(ranks["key_file"])
    mp = ranks["outs"][0]["mesh_prover"]
    for idx, blob in mp["proofs"]:
        proof = deserialize_proof(blob)
        assert serialize_proof(proof) == blob
        assert verify_proof(prepare_verifying_key(keys.get_pk(idx).vk), proof, mp["public_inputs"]), idx
    assert mp["aggregate_verified"] is True
