"""The port's CLI (hekaton_tpu_torch/cli.py) and the host modules it brought
with it, against the JAX package:

- a CLI run with the host backend, `setup-chain --num-subcircuits 2`, then
  `work --spill-dir`: the JAX CLI's lines, the stage-0 state spilled in the
  wire format, the aggregate proof verified;
- protocol/wire.py and protocol/serialization.py: every stage-0/stage-1
  message and proof of that run encodes to bytes that the JAX modules decode
  and encode back to the same bytes, and the other way round;
- the VM, VKD and partitioned circom-R1CS workloads at tiny parameters give
  the JAX package's constraint counts, matrices and portal subtraces;
- a JAX-written key file of each new workload loads into the port's classes;
- `write-big-merkle-r1cs` writes the JAX CLI's files, byte for byte.

The `--backend cpu work --spill-dir` run (TorchBackend on the CPU) is in
tests/test_torch_slice.py, on a key file written by the JAX package.
"""
import contextlib
import dataclasses
import io

import pytest
import torch

import hekaton_tpu.cli as jcli
import hekaton_tpu.runtime.keys as jkeys
import hekaton_tpu_torch.cli as tcli
import hekaton_tpu_torch.protocol.coordinator as tcoord
import hekaton_tpu_torch.protocol.worker as tworker
import hekaton_tpu_torch.runtime.keys as tkeys
from hekaton_tpu.protocol import serialization as jser
from hekaton_tpu.protocol import wire as jwire
from hekaton_tpu.protocol.portal_manager import SetupVarPortalManager as JSetupVarPortalManager
from hekaton_tpu.r1cs.builder import ConstraintSystem as JConstraintSystem
from hekaton_tpu.utils.rng import Rng as JRng
from hekaton_tpu.workloads import partitioned_r1cs as jpr
from hekaton_tpu.workloads import vkd as jvkd
from hekaton_tpu.workloads import vm as jvm
from hekaton_tpu.workloads.chain import PortalChainParams as JPortalChainParams
from hekaton_tpu.workloads.vkd.vkd import null_leaf_value as jnull_leaf_value
from hekaton_tpu_torch.protocol import serialization as tser
from hekaton_tpu_torch.protocol import wire as twire
from hekaton_tpu_torch.protocol.portal_manager import SetupVarPortalManager
from hekaton_tpu_torch.r1cs.builder import ConstraintSystem
from hekaton_tpu_torch.utils.rng import Rng
from hekaton_tpu_torch.workloads import partitioned_r1cs as tpr
from hekaton_tpu_torch.workloads import vkd as tvkd
from hekaton_tpu_torch.workloads import vm as tvm
from hekaton_tpu_torch.workloads.chain import PortalChainParams
from hekaton_tpu_torch.workloads.vkd.vkd import null_leaf_value

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    """`--backend host setup-chain --num-subcircuits 2` and `work
    --spill-dir` through the port's CLI, keeping every message and proof of
    the run and what the CLI printed."""
    tmp = tmp_path_factory.mktemp("cli")
    seen = {"stage0": [], "stage1": []}

    def keep(fn, out):
        def run(*args):
            resp = fn(*args)
            out.append((args, resp))
            return resp

        return run

    gen_agg = tcoord.FinalAggState.gen_agg_proof
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tworker, "process_stage0_request", keep(tworker.process_stage0_request, seen["stage0"]))
        mp.setattr(tworker, "process_stage1_request", keep(tworker.process_stage1_request, seen["stage1"]))
        mp.setattr(tcoord.FinalAggState, "gen_agg_proof",
                   lambda self, ck, resps: seen.setdefault("agg_proof", gen_agg(self, ck, resps)))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            key = str(tmp / "chain.keys")
            tcli.main(["--backend", "host", "setup-chain", "--num-subcircuits", "2", "--key-out", key])
            tcli.main(["--backend", "host", "work", "--key-file", key, "--spill-dir", str(tmp / "spill")])
    seen["out"] = out.getvalue()
    seen["spill"] = tmp / "spill" / "stage0.bin"
    return seen


def test_cli_host_setup_and_work_with_spill(host_run):
    lines = host_run["out"].splitlines()
    assert lines[0].startswith("[setup] chain: 2 subcircuits, 2 unique CRSs, ")
    assert lines[1] == "[work] chain: 2 subcircuits, backend=host"
    assert lines[3] == f"[work] stage0 state spilled+reloaded via {host_run['spill']} (wire format)"
    assert "[work] aggregate proof verified: True" in lines
    assert lines[-1] == ("[work] aggregate proof: 1 GIPA rounds, 10952 bytes uncompressed / 10472 bytes "
                         "compressed (measured; GT elements dominate); per-subcircuit G16 proof: 328B/168B")
    assert host_run["spill"].stat().st_size > 0
    # stage 1 recommitted stage 0 from the reloaded seeds: the same commitments
    for (args, resp0), (args1, _) in zip(host_run["stage0"], host_run["stage1"]):
        assert args1[4].com == resp0.com and args1[4].com_seed == resp0.com_seed


def _same_bytes(blob: bytes, port_decode, port_encode, jax_decode, jax_encode):
    assert jax_encode(jax_decode(blob)) == blob
    assert port_encode(port_decode(blob)) == blob


def test_wire_and_serialization_match_jax(host_run):
    mem = "rom"
    for (args, resp0), (args1, resp1) in zip(host_run["stage0"], host_run["stage1"]):
        req0, req1 = args[3], args1[5]
        _same_bytes(twire.stage0_request_to_bytes(req0, mem), twire.stage0_request_from_bytes,
                    lambda r: twire.stage0_request_to_bytes(r, mem), jwire.stage0_request_from_bytes,
                    lambda r: jwire.stage0_request_to_bytes(r, mem))
        _same_bytes(twire.stage0_response_to_bytes(resp0, mem), twire.stage0_response_from_bytes,
                    lambda r: twire.stage0_response_to_bytes(r, mem), jwire.stage0_response_from_bytes,
                    lambda r: jwire.stage0_response_to_bytes(r, mem))
        _same_bytes(twire.stage1_request_to_bytes(req1, mem),
                    lambda b: twire.stage1_request_from_bytes(b, PortalChainParams),
                    lambda r: twire.stage1_request_to_bytes(r, mem),
                    lambda b: jwire.stage1_request_from_bytes(b, JPortalChainParams),
                    lambda r: jwire.stage1_request_to_bytes(r, mem))
        _same_bytes(twire.stage1_response_to_bytes(resp1, mem), twire.stage1_response_from_bytes,
                    lambda r: twire.stage1_response_to_bytes(r, mem), jwire.stage1_response_from_bytes,
                    lambda r: jwire.stage1_response_to_bytes(r, mem))
        for compressed in (False, True):
            _same_bytes(tser.serialize_groth16_proof(resp1.proof, compressed), tser.deserialize_groth16_proof,
                        lambda p, c=compressed: tser.serialize_groth16_proof(p, c), jser.deserialize_groth16_proof,
                        lambda p, c=compressed: jser.serialize_groth16_proof(p, c))
    for compressed in (False, True):
        _same_bytes(tser.serialize_agg_proof(host_run["agg_proof"], compressed), tser.deserialize_agg_proof,
                    lambda p, c=compressed: tser.serialize_agg_proof(p, c), jser.deserialize_agg_proof,
                    lambda p, c=compressed: jser.serialize_agg_proof(p, c))


def _entries(subtraces) -> list:
    return [[dataclasses.astuple(e) for e in st] for st in subtraces]


def _synthesize(circ, manager_cls, cs_cls) -> tuple:
    """Every subcircuit's constraints into one system, as the setup pass of
    tests/test_circom.py: (constraints, matrices, portal subtraces)."""
    pm = manager_cls(cs_cls(), circ.MEM_TYPE)
    for idx in range(circ.num_subcircuits()):
        pm.start_subtrace()
        circ.generate_constraints(pm.cs, idx, pm)
    assert pm.cs.is_satisfied()
    return pm.cs.num_constraints, pm.cs.matrices(), _entries(pm.subtraces)


def _partition_files(tmp_path) -> str:
    from test_circom import _write_partition

    return _write_partition(str(tmp_path))


@pytest.mark.parametrize("workload", ["vm", "vkd", "partitioned-r1cs"])
def test_workloads_match_jax(workload, tmp_path):
    if workload == "vm":
        circ = tvm.VirtualMachine.rand(Rng.from_int(1000), tvm.VirtualMachineParameters(1, 30, 1))
        jcirc = jvm.VirtualMachine.rand(JRng.from_int(1000), jvm.VirtualMachineParameters(1, 30, 1))
    elif workload == "vkd":
        circ = tvkd.VerifiableKeyDirectoryCircuit.new(tvkd.VerifiableKeyDirectoryCircuitParams(3, null_leaf_value()))
        jcirc = jvkd.VerifiableKeyDirectoryCircuit.new(
            jvkd.VerifiableKeyDirectoryCircuitParams(3, jnull_leaf_value()))
    else:
        path = _partition_files(tmp_path)
        circ = tpr.PartitionedR1CSCircuit.rand(Rng.from_int(1000), tpr.PartitionedR1CSCircuitParams(2, 2, path))
        jcirc = jpr.PartitionedR1CSCircuit.rand(JRng.from_int(1000), jpr.PartitionedR1CSCircuitParams(2, 2, path))
    assert circ.num_subcircuits() == jcirc.num_subcircuits()
    assert _entries(circ.get_portal_subtraces()) == _entries(jcirc.get_portal_subtraces())
    assert [circ.representative_subcircuit(i) for i in range(circ.num_subcircuits())] == [
        jcirc.representative_subcircuit(i) for i in range(jcirc.num_subcircuits())]
    got = _synthesize(circ, SetupVarPortalManager, ConstraintSystem)
    assert got[0] > 0
    assert got == _synthesize(jcirc, JSetupVarPortalManager, JConstraintSystem)


def test_jax_key_files_of_new_workloads_load(tmp_path):
    """The key loader maps the JAX package's workload params onto the port's."""
    for circ_id, params, port_cls in (
        ("vm", jvm.VirtualMachineParameters(5, 30, 1024, False), tvm.VirtualMachineParameters),
        ("vkd", jvkd.VerifiableKeyDirectoryCircuitParams(5, jnull_leaf_value()),
         tvkd.VerifiableKeyDirectoryCircuitParams),
        ("partitioned-r1cs", jpr.PartitionedR1CSCircuitParams(2, 4, "x"), tpr.PartitionedR1CSCircuitParams),
    ):
        path = str(tmp_path / f"{circ_id}.keys")
        jkeys.ProvingKeys(circ_id, params, {}, 4, [0, 1, 1, 3]).save(path)
        keys = tkeys.ProvingKeys.load(path)
        assert type(keys) is tkeys.ProvingKeys and type(keys.params) is port_cls
        assert dataclasses.astuple(keys.params) == dataclasses.astuple(params)
        assert (keys.circ_id, keys.num_subcircuits, keys.representatives) == (circ_id, 4, [0, 1, 1, 3])


def test_write_big_merkle_r1cs_matches_jax_cli(tmp_path, capsys):
    outs = {}
    for name, main in (("port", tcli.main), ("jax", jcli.main)):
        r1cs, wit = tmp_path / f"{name}.r1cs", tmp_path / f"{name}.json"
        main(["write-big-merkle-r1cs", "--num-subcircuits", "4", "--num-sha2-iters", "1",
              "--r1cs-out", str(r1cs), "--witness-out", str(wit)])
        outs[name] = (r1cs.read_bytes(), wit.read_bytes(), capsys.readouterr().out.split(" -> ")[0])
    assert outs["port"] == outs["jax"]
    assert outs["port"][2].startswith("[write-r1cs] ")
