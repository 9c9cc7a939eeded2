"""The port's slice as a whole, against the JAX package's HostBackend:

- a key file written by the JAX package loads into the port and holds no
  object of the JAX package, and the port's CLI, `--backend cpu work
  --spill-dir` (TorchBackend("cpu"): every MSM of this circuit through the
  compact msm, the witness map through the NTT; stage 0 round-tripped
  through the wire format and recommitted in stage 1), proves from it the
  JAX HostBackend's proofs, bit for bit, and prints that the aggregate
  proof verified;
- the port's setup with TorchBackend("cpu") (every fixed-base batch through
  msm/pippenger.py::fixed_base_msm) gives the JAX HostBackend's CRS point
  for point, G2 points compared as bytes.

The JAX side runs `cmd_work`'s flow (hekaton_tpu/cli.py) with the same
seeds and coordinator calls; its stage 1 reuses the stage-0 commitment
builder (`process_stage1_request_with_cb`) instead of recommitting."""
import pytest
import torch

import hekaton_tpu.cpgroth16.backend as jbackend
import hekaton_tpu.protocol.coordinator as jcoord
import hekaton_tpu.protocol.worker as jworker
import hekaton_tpu.runtime.keys as jkeys
import hekaton_tpu_torch.cli as tcli
import hekaton_tpu_torch.cpgroth16.backend as tbackend
import hekaton_tpu_torch.cpgroth16.data_structures as tds
import hekaton_tpu_torch.protocol.coordinator as tcoord
import hekaton_tpu_torch.protocol.worker as tworker
import hekaton_tpu_torch.runtime.keys as tkeys
from hekaton_tpu.curves import host as jch
from hekaton_tpu.protocol.ipp import ipp_setup as jipp_setup
from hekaton_tpu.utils.rng import Rng as JRng
from hekaton_tpu.workloads.chain import PortalChainCircuit as JPortalChainCircuit
from hekaton_tpu.workloads.chain import PortalChainParams as JPortalChainParams
from hekaton_tpu_torch.cpgroth16.verifier import prepare_verifying_key, verify_proof
from hekaton_tpu_torch.curves import host as ch
from hekaton_tpu_torch.utils.rng import Rng
from hekaton_tpu_torch.workloads.chain import PortalChainCircuit, PortalChainParams

# small tensors: one thread each, since pytest-xdist runs several workers at once
torch.set_num_threads(1)


def _work(coord, worker, keys, backend, circ_cls, rng_cls, ipp):
    """Stage 0 and stage 1 of every subcircuit (cli.py::cmd_work)."""
    circ = circ_cls.rand(rng_cls.from_int(1000), keys.params)
    n = circ.num_subcircuits()
    rng = rng_cls.from_int(1000)
    stage0 = coord.CoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    built = [
        worker.process_stage0_request_get_cb(rng.fork(str(i).encode()), type(circ), keys.get_pk(i), reqs0[i], backend)
        for i in range(n)
    ]
    resps0 = [b[0] for b in built]
    stage1 = stage0.process_stage0_responses(ipp(n, rng_cls.from_int(2000)), resps0)
    resps1 = [
        worker.process_stage1_request_with_cb(rng.fork(b"s1" + str(i).encode()), cb, r0.com, kappa, stage1.gen_request(i))
        for i, (r0, cb, kappa) in enumerate(built)
    ]
    return resps0, resps1, stage1.into_agg_state().public_inputs


def _modules(obj) -> set:
    """The modules of the classes of every object reachable from obj."""
    seen, out, stack = set(), set(), [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen or isinstance(o, (int, str, bytes, float, bool, type(None))):
            continue
        seen.add(id(o))
        out.add(type(o).__module__)
        if isinstance(o, dict):
            stack += list(o.keys()) + list(o.values())
        elif isinstance(o, (list, tuple, set)):
            stack += list(o)
        else:
            stack += list(getattr(o, "__dict__", {}).values())
            stack += [getattr(o, s) for s in getattr(type(o), "__slots__", ()) if hasattr(o, s)]
    return out


def _crs_bytes(pk, g1_to_bytes, g2_to_bytes) -> list:
    """Every group element of a proving key, serialized by its package."""
    vk = pk.vk
    g1 = [*pk.a_g.points, *pk.b_g.points, *pk.h_g.points, pk.beta_g, *pk.deltas_g, vk.alpha_g, *vk.gamma_abc_g]
    g1 += [p for v in pk.ck.deltas_abc_g for p in v.points] + [pk.ck.last_delta_g]
    g2 = [*pk.b_h.points, vk.beta_h, vk.gamma_h, *vk.deltas_h]
    return [g1_to_bytes(p) for p in g1] + [g2_to_bytes(p) for p in g2]


@pytest.fixture(scope="module")
def jax_key_file(tmp_path_factory):
    """The JAX package's HostBackend setup of PortalChainParams(2), and the
    key file it writes."""
    jcirc = JPortalChainCircuit.rand(JRng.from_int(1000), JPortalChainParams(2))
    path = str(tmp_path_factory.mktemp("keys") / "chain.keys")
    jax_keys = jkeys.ProvingKeys.generate("chain", jcirc, jbackend.HostBackend(), lambda i: JRng.from_int(50 + i))
    jax_keys.save(path)
    return jax_keys, path


def test_port_setup_equals_jax_host(jax_key_file):
    jax_keys, _ = jax_key_file
    backend = tbackend.TorchBackend("cpu")
    circ = PortalChainCircuit.rand(Rng.from_int(1000), PortalChainParams(2))
    keys = tkeys.ProvingKeys.generate("chain", circ, backend, lambda i: Rng.from_int(50 + i))
    assert sorted(keys.minimal_pks) == sorted(jax_keys.minimal_pks) and keys.representatives == jax_keys.representatives
    for i, pk in keys.minimal_pks.items():
        jpk = jax_keys.minimal_pks[i]
        assert _crs_bytes(pk, ch.g1_to_bytes, ch.g2_to_bytes) == _crs_bytes(jpk, jch.g1_to_bytes, jch.g2_to_bytes), i
    # per unique CRS: a_g, b_g, b_h, h_g, gamma_abc, deltas_g, deltas_h and
    # one basis per stage, every one on the backend's device
    n_stages = len(keys.get_pk(0).ck.deltas_abc_g)
    assert backend.ran == {"g1_msm_compact": 0, "g2_msm_compact": 0, "g1_msm_gpu": 0, "g2_msm_gpu": 0,
                           "witness_map_gpu": 0, "fixed_base_gpu": len(keys.minimal_pks) * (7 + n_stages)}


def _run_cli(monkeypatch, argv: list) -> dict:
    """Run the port's CLI in-process and keep what `work` made: its backend,
    the stage-0 and stage-1 responses, the final aggregation state."""
    seen = {"resps0": [], "resps1": []}
    make = tcli._backend
    monkeypatch.setattr(tcli, "_backend", lambda name: seen.setdefault("backend", make(name)))
    for stage, fn in ((0, tworker.process_stage0_request), (1, tworker.process_stage1_request)):
        monkeypatch.setattr(tworker, f"process_stage{stage}_request",
                            lambda *a, _fn=fn, _out=seen[f"resps{stage}"]: _out.append(_fn(*a)) or _out[-1])
    into = tcoord.CoordinatorStage1State.into_agg_state
    monkeypatch.setattr(tcoord.CoordinatorStage1State, "into_agg_state",
                        lambda self: seen.setdefault("agg_state", into(self)))
    tcli.main(argv)
    return seen


def test_port_proves_from_jax_key_file(jax_key_file, monkeypatch, capsys, tmp_path):
    jax_keys, path = jax_key_file
    keys = tkeys.ProvingKeys.load(path)
    assert isinstance(keys, tkeys.ProvingKeys) and isinstance(keys.params, PortalChainParams)
    pk = keys.get_pk(0)
    assert isinstance(pk, tds.ProvingKey) and isinstance(pk.a_g, tds.PointVec)
    assert pk.b_h.curve.name == "g2" and isinstance(pk.b_h.points[0][0], ch.Fq2)
    assert pk.a_g.points == jax_keys.get_pk(0).a_g.points
    # the key holds the port's classes only
    assert not any(m == "hekaton_tpu" or m.startswith("hekaton_tpu.") for m in _modules(keys))
    for i, pk in keys.minimal_pks.items():
        assert _crs_bytes(pk, ch.g1_to_bytes, ch.g2_to_bytes) == _crs_bytes(
            jax_keys.minimal_pks[i], jch.g1_to_bytes, jch.g2_to_bytes
        ), i

    seen = _run_cli(monkeypatch, ["--backend", "cpu", "work", "--key-file", path, "--spill-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[work] aggregate proof verified: True" in out and "(wire format)" in out, out
    resps0, resps1, public_inputs = seen["resps0"], seen["resps1"], seen["agg_state"].public_inputs
    jresps0, jresps1, jpublic_inputs = _work(
        jcoord, jworker, jkeys.ProvingKeys.load(path), jbackend.HostBackend(), JPortalChainCircuit, JRng, jipp_setup
    )
    assert public_inputs == jpublic_inputs
    assert [r.com for r in resps0] == [r.com for r in jresps0]
    n = keys.num_subcircuits
    for i in range(n):
        p, jp = resps1[i].proof, jresps1[i].proof
        assert (p.a, p.c, p.ds) == (jp.a, jp.c, jp.ds), i
        assert ch.g2_to_bytes(p.b) == jch.g2_to_bytes(jp.b), i
        assert tds.serialize_proof(p) == tds.serialize_proof(jp), i
        pvk = prepare_verifying_key(keys.get_pk(i).vk)
        assert verify_proof(pvk, p, public_inputs), i
    # per subcircuit, every MSM of this circuit is at most 2,048 points long,
    # so all take the compact route: the stage-0 commit and its recommit and
    # the A, B-G1, L and H MSMs on G1, B-G2 on G2; no host route is left
    assert seen["backend"].ran == {"g1_msm_compact": 6 * n, "g2_msm_compact": n, "g1_msm_gpu": 0,
                                   "g2_msm_gpu": 0, "fixed_base_gpu": 0, "witness_map_gpu": n}

    bad = resps1[0].proof
    bad.c = ch.pt_add(bad.c, ch.g1_gen())
    assert not verify_proof(prepare_verifying_key(keys.get_pk(0).vk), bad, public_inputs)
