"""The port's CLI with `work --mesh` (hekaton_tpu_torch/cli.py), in process
on a world of one rank over gloo, with the exec tree's algebraic test hash
set in both packages (restored afterwards):

- `--backend host setup-chain --num-subcircuits 2`, then `--backend cpu
  work --mesh 1x1`: the sequential run's lines plus the mesh line (up to
  times and the backend's name), stage 0 and stage 1 through MeshProver,
  the aggregate proof verified, and stage-0 commitments and stage-1 proofs
  equal, byte for byte, to the JAX package's sequential
  process_stage0_request / process_stage1_request on its HostBackend.

tests/test_torch_cli_mesh_spill.py holds `--mesh --spill-dir` and the
refusals; tests/test_torch_mesh_ranks.py runs MeshProver on four ranks.
"""
import contextlib
import io
import re

import pytest
import torch
import torch.distributed as dist

import hekaton_tpu.cpgroth16.backend as jbackend
import hekaton_tpu.protocol.eval_tree as jet
import hekaton_tpu.runtime.keys as jkeys
import hekaton_tpu_torch.cli as tcli
import hekaton_tpu_torch.runtime.mesh_prover as tmesh
from hekaton_tpu.cpgroth16.data_structures import serialize_proof as jserialize_proof
from hekaton_tpu.curves import host as jch
from hekaton_tpu.protocol.coordinator import CoordinatorStage0State as JCoordinatorStage0State
from hekaton_tpu.protocol.ipp import ipp_setup as jipp_setup
from hekaton_tpu.protocol.worker import process_stage0_request, process_stage1_request
from hekaton_tpu.utils.rng import Rng as JRng
from hekaton_tpu.workloads.chain import PortalChainCircuit as JPortalChainCircuit
from hekaton_tpu.workloads.chain import PortalChainParams as JPortalChainParams
from hekaton_tpu_torch.cpgroth16.data_structures import serialize_proof
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.protocol import eval_tree as tet

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def jax_host_run() -> tuple:
    """The JAX package's setup of PortalChainParams(2) and its sequential
    stage 0 and stage 1 on its HostBackend (the CLI's seeds), with the tree
    hash the caller set."""
    circ = JPortalChainCircuit.rand(JRng.from_int(1000), JPortalChainParams(2))
    keys = jkeys.ProvingKeys.generate("chain", circ, jbackend.HostBackend(), lambda i: JRng.from_int(50 + i))
    n = circ.num_subcircuits()
    rng = JRng.from_int(1000)
    stage0 = JCoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    resps0 = [process_stage0_request(rng.fork(str(i).encode()), JPortalChainCircuit, keys.get_pk(i), reqs0[i],
                                     jbackend.HostBackend()) for i in range(n)]
    stage1 = stage0.process_stage0_responses(jipp_setup(n, JRng.from_int(2000)), resps0)
    resps1 = [process_stage1_request(rng.fork(b"s1" + str(i).encode()), JPortalChainCircuit, keys.get_pk(i),
                                     reqs0[i], resps0[i], stage1.gen_request(i), jbackend.HostBackend())
              for i in range(n)]
    return resps0, resps1


def cli(argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcli.main(argv)
    return out.getvalue()


def keep(monkeypatch, obj, name: str, seen: list):
    fn = getattr(obj, name)
    monkeypatch.setattr(obj, name, lambda *a, **k: seen.append(fn(*a, **k)) or seen[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    key = str(tmp_path_factory.mktemp("cli_mesh") / "chain.keys")
    prev = jet.set_tree_hash(jet.ALGEBRAIC_TEST_HASH), tet.set_tree_hash(tet.ALGEBRAIC_TEST_HASH)
    try:
        setup = cli(["--backend", "host", "setup-chain", "--num-subcircuits", "2", "--key-out", key])
        seq = cli(["--backend", "host", "work", "--key-file", key])
        seen = {"stage0_all": [], "stage1_all": []}
        with pytest.MonkeyPatch.context() as mp:
            for name in seen:
                keep(mp, tmesh.MeshProver, name, seen[name])
            mesh = cli(["--backend", "cpu", "work", "--key-file", key, "--mesh", "1x1"])
        yield {"setup": setup, "seq": seq, "mesh": mesh, "seen": seen, "jax": jax_host_run()}
    finally:
        jet.set_tree_hash(prev[0])
        tet.set_tree_hash(prev[1])
        if dist.is_initialized():
            dist.destroy_process_group()


def _lines(text: str) -> list:
    """The CLI's lines with times and the backend's name blanked."""
    text = re.sub(r"\(\d+\.\d+s\)", "(Ts)", text)
    return re.sub(r"backend=\w+", "backend=B", text).splitlines()


def test_mesh_work_prints_the_sequential_lines(run):
    assert "[setup] chain: 2 subcircuits" in run["setup"]
    mesh, seq = _lines(run["mesh"]), _lines(run["seq"])
    assert mesh[0] == "[work] mesh 1x1 (sub x pts) over 1 devices"
    assert mesh[1:] == seq
    assert "[work] aggregate proof verified: True" in mesh and "backend=torch" in run["mesh"]


def test_mesh_work_proofs_equal_jax_host(run):
    (resps0,), (resps1,) = run["seen"]["stage0_all"], run["seen"]["stage1_all"]
    jresps0, jresps1 = run["jax"]
    assert [(r.subcircuit_idx, ch.g1_to_bytes(r.com), r.com_seed) for r in resps0] == [
        (r.subcircuit_idx, jch.g1_to_bytes(r.com), r.com_seed) for r in jresps0]
    assert [serialize_proof(r.proof) for r in resps1] == [jserialize_proof(r.proof) for r in jresps1]
