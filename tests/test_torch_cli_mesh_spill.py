"""The port's CLI `work --mesh` beside the sequential path, in process on a
world of one rank over gloo, with the exec tree's algebraic test hash set
in both packages (restored afterwards):

- `--mesh 1x1 --spill-dir` takes the sequential stage 1: stage 0 on the
  mesh, spilled in the wire format, then recommitted by
  process_stage1_request (the backend is the port's HostBackend here,
  which gives the same proofs as TorchBackend), its proofs the JAX
  package's sequential HostBackend proofs, byte for byte;
- `--backend host --mesh 1x1` and `--mesh 2x1` on one rank are refused.
"""
import pytest
import torch
import torch.distributed as dist

import hekaton_tpu.protocol.eval_tree as jet
import hekaton_tpu_torch.cli as tcli
import hekaton_tpu_torch.protocol.worker as tworker
import hekaton_tpu_torch.runtime.mesh_prover as tmesh
from hekaton_tpu.cpgroth16.data_structures import serialize_proof as jserialize_proof
from hekaton_tpu_torch.cpgroth16.backend import HostBackend
from hekaton_tpu_torch.cpgroth16.data_structures import serialize_proof
from hekaton_tpu_torch.protocol import eval_tree as tet

from test_torch_cli_mesh import cli, jax_host_run, keep

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def key(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli_mesh_spill")
    prev = jet.set_tree_hash(jet.ALGEBRAIC_TEST_HASH), tet.set_tree_hash(tet.ALGEBRAIC_TEST_HASH)
    try:
        cli(["--backend", "host", "setup-chain", "--num-subcircuits", "2", "--key-out", str(path / "chain.keys")])
        yield path
    finally:
        jet.set_tree_hash(prev[0])
        tet.set_tree_hash(prev[1])
        if dist.is_initialized():
            dist.destroy_process_group()


def test_mesh_spill_takes_sequential_stage1(key, monkeypatch):
    """Stage 0 on the mesh, spilled and reloaded; stage 1 recommits
    sequentially on the backend (no stage1_all)."""
    seen0, seen1 = [], []
    keep(monkeypatch, tmesh.MeshProver, "stage0_all", seen0)
    monkeypatch.setattr(tmesh.MeshProver, "stage1_all", lambda *a: pytest.fail("stage1_all with --spill-dir"))
    keep(monkeypatch, tworker, "process_stage1_request", seen1)
    monkeypatch.setattr(tcli, "_backend", lambda name: HostBackend())
    out = cli(["--backend", "cpu", "work", "--key-file", str(key / "chain.keys"), "--mesh", "1x1",
               "--spill-dir", str(key / "spill")])
    assert "(wire format)" in out and "[work] aggregate proof verified: True" in out, out
    assert len(seen0) == 1 and len(seen1) == 2
    assert [serialize_proof(r.proof) for r in seen1] == [jserialize_proof(r.proof) for r in jax_host_run()[1]]


def test_mesh_refused_on_host_backend_and_wrong_world(key):
    with pytest.raises(SystemExit, match="device backend"):
        cli(["--backend", "host", "work", "--key-file", str(key / "chain.keys"), "--mesh", "1x1"])
    with pytest.raises(ValueError, match="1 ranks"):
        cli(["--backend", "cpu", "work", "--key-file", str(key / "chain.keys"), "--mesh", "2x1"])
