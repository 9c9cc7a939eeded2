"""The port's slice as a whole: a CRS written by the JAX package, loaded by
the port, and stage 0 + stage 1 through the port's worker with
TorchBackend("cpu") give the JAX HostBackend's proofs, bit for bit.

The flow is `cmd_work`'s (hekaton_tpu/cli.py), with the same seeds and
coordinator calls, driven once through each package. Stage 1 reuses the
stage-0 commitment builder (`process_stage1_request_with_cb`) instead of
recommitting: the stateless recommit is covered by
tests/test_torch_no_jax.py and chip_smoke.py, and skipping it here saves
two plain-PyTorch MSMs on the CPU."""
import torch

import hekaton_tpu.cpgroth16.backend as jbackend
import hekaton_tpu.protocol.coordinator as jcoord
import hekaton_tpu.protocol.worker as jworker
import hekaton_tpu.runtime.keys as jkeys
import hekaton_tpu_torch.cpgroth16.backend as tbackend
import hekaton_tpu_torch.cpgroth16.data_structures as tds
import hekaton_tpu_torch.protocol.coordinator as tcoord
import hekaton_tpu_torch.protocol.worker as tworker
import hekaton_tpu_torch.runtime.keys as tkeys
from hekaton_tpu.curves import host as ch
from hekaton_tpu.protocol.ipp import ipp_setup
from hekaton_tpu.utils.rng import Rng
from hekaton_tpu.workloads.chain import PortalChainCircuit, PortalChainParams
from hekaton_tpu_torch.cpgroth16.verifier import prepare_verifying_key, verify_proof

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def _work(coord, worker, keys, backend):
    """Stage 0 and stage 1 of every subcircuit (cli.py::cmd_work)."""
    circ = PortalChainCircuit.rand(Rng.from_int(1000), keys.params)
    n = circ.num_subcircuits()
    rng = Rng.from_int(1000)
    stage0 = coord.CoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    built = [
        worker.process_stage0_request_get_cb(rng.fork(str(i).encode()), type(circ), keys.get_pk(i), reqs0[i], backend)
        for i in range(n)
    ]
    resps0 = [b[0] for b in built]
    stage1 = stage0.process_stage0_responses(ipp_setup(n, Rng.from_int(2000)), resps0)
    resps1 = [
        worker.process_stage1_request_with_cb(rng.fork(b"s1" + str(i).encode()), cb, r0.com, kappa, stage1.gen_request(i))
        for i, (r0, cb, kappa) in enumerate(built)
    ]
    return resps0, resps1, stage1.into_agg_state().public_inputs


def test_port_proves_from_jax_key_file(tmp_path):
    params = PortalChainParams(2)
    circ = PortalChainCircuit.rand(Rng.from_int(1000), params)
    path = str(tmp_path / "chain.keys")
    jax_keys = jkeys.ProvingKeys.generate("chain", circ, jbackend.HostBackend(), lambda i: Rng.from_int(50 + i))
    jax_keys.save(path)

    keys = tkeys.ProvingKeys.load(path)
    assert isinstance(keys, tkeys.ProvingKeys)
    pk = keys.get_pk(0)
    assert isinstance(pk, tds.ProvingKey) and isinstance(pk.a_g, tds.PointVec)
    assert pk.a_g.points == jax_keys.get_pk(0).a_g.points and pk.b_h.curve.name == "g2"

    backend = tbackend.TorchBackend("cpu")
    resps0, resps1, public_inputs = _work(tcoord, tworker, keys, backend)
    jresps0, jresps1, jpublic_inputs = _work(jcoord, jworker, jkeys.ProvingKeys.load(path), jbackend.HostBackend())

    assert public_inputs == jpublic_inputs
    assert [r.com for r in resps0] == [r.com for r in jresps0]
    n = keys.num_subcircuits
    for i in range(n):
        p, jp = resps1[i].proof, jresps1[i].proof
        assert (p.a, p.b, p.c, p.ds) == (jp.a, jp.b, jp.c, jp.ds), i
        pvk = prepare_verifying_key(keys.get_pk(i).vk)
        assert verify_proof(pvk, p, public_inputs), i
    # per subcircuit: the stage-0 commit and the A, B-G1, L and H MSMs;
    # B-G2 runs on the host
    assert backend.ran["g1_msm_gpu"] == 5 * n
    assert backend.ran["g2_msm_host"] == n and backend.ran["witness_map_gpu"] == n

    bad = resps1[0].proof
    bad.c = ch.pt_add(bad.c, ch.g1_gen())
    assert not verify_proof(prepare_verifying_key(keys.get_pk(0).vk), bad, public_inputs)
