"""hekaton-tpu-torch CLI: setup-* / write-big-merkle-r1cs / work on the port.

Port of hekaton_tpu/cli.py, command for command, with the same seeds, the
same printed lines and the same exit status (1 when the aggregate proof
fails). `--backend` picks the compute backend: `gpu` (the default,
TorchBackend("cuda"): every MSM, fixed-base batch and witness map on the
card), `cpu` (TorchBackend("cpu"): the kernels' plain versions, for tests)
or `host` (HostBackend). There is no fallback: `gpu` without a card fails.

    python -m hekaton_tpu_torch.cli --backend cpu setup-chain --num-subcircuits 2 --key-out k.bin
    python -m hekaton_tpu_torch.cli --backend cpu work --key-file k.bin --spill-dir spill/

`work` runs the two-stage proving pipeline in one process (the reference's
all_in_one mode). The JAX CLI's `work --mesh` and `--force-ladder` (the
mesh-sharded prover of hekaton_tpu/runtime/{spmd,mesh_prover}.py) are not
ported yet: they come with the port's torch.distributed runtime. Host
pairings and aggregation run on the coordinator, as in the JAX package.
"""
from __future__ import annotations

import argparse
import sys
import time


def _circuit(circ_id: str, params):
    from .utils.rng import Rng

    if circ_id == "big-merkle":
        from .workloads.merkle import MerkleTreeCircuit

        return MerkleTreeCircuit.rand(Rng.from_int(1000), params)
    if circ_id == "vm":
        from .workloads.vm import VirtualMachine

        return VirtualMachine.rand(Rng.from_int(1000), params)
    if circ_id == "partitioned-r1cs":
        from .workloads.partitioned_r1cs import PartitionedR1CSCircuit

        return PartitionedR1CSCircuit.rand(Rng.from_int(1000), params)
    if circ_id == "vkd":
        from .workloads.vkd import VerifiableKeyDirectoryCircuit

        return VerifiableKeyDirectoryCircuit.new(params)
    if circ_id == "chain":
        from .workloads.chain import PortalChainCircuit

        return PortalChainCircuit.rand(Rng.from_int(1000), params)
    raise ValueError(f"unknown circuit id {circ_id}")


def _backend(name: str):
    from .cpgroth16.backend import HostBackend, TorchBackend

    if name == "host":
        return HostBackend()
    return TorchBackend("cuda" if name == "gpu" else "cpu")


def cmd_setup(args, circ_id: str, params):
    from .runtime.keys import ProvingKeys
    from .utils.rng import Rng

    backend = _backend(args.backend)
    t0 = time.time()
    circ = _circuit(circ_id, params)
    keys = ProvingKeys.generate(circ_id, circ, backend, lambda i: Rng.from_int(50 + i))
    keys.save(args.key_out)
    uniq = len(keys.minimal_pks)
    print(
        f"[setup] {circ_id}: {circ.num_subcircuits()} subcircuits, {uniq} unique CRSs, "
        f"{time.time() - t0:.1f}s -> {args.key_out}"
    )


def _spill(spill_dir: str, circuit_cls, reqs0: list, resps0: list) -> tuple:
    """Round-trip the stage-0 state through disk in the wire format
    (protocol/wire.py: data-only, no pickle across the process boundary);
    stage 1 then recommits from the 32-byte seeds."""
    import os
    import struct

    from .protocol import wire

    mem_type = circuit_cls.MEM_TYPE
    os.makedirs(spill_dir, exist_ok=True)
    spill = os.path.join(spill_dir, "stage0.bin")
    with open(spill, "wb") as f:
        for req, resp in zip(reqs0, resps0):
            rb = wire.stage0_request_to_bytes(req, mem_type)
            f.write(struct.pack("<I", len(rb)) + rb)
            f.write(wire.stage0_response_to_bytes(resp, mem_type))
    n = len(reqs0)
    reqs0, resps0 = [], []
    with open(spill, "rb") as f:
        for _ in range(n):
            (rlen,) = struct.unpack("<I", f.read(4))
            reqs0.append(wire.stage0_request_from_bytes(f.read(rlen)))
            resps0.append(wire.stage0_response_from_bytes(f.read(wire.STAGE0_RESPONSE_SIZE)))
    print(f"[work] stage0 state spilled+reloaded via {spill} (wire format)")
    return reqs0, resps0


def cmd_work(args):
    from .protocol.aggregation import AggProvingKey, agg_transcript
    from .protocol.coordinator import CoordinatorStage0State
    from .protocol.ipp import ipp_setup
    from .protocol.tipa import tipa_key_from_ipp
    from .protocol.worker import process_stage0_request, process_stage1_request
    from .runtime.keys import ProvingKeys
    from .utils.rng import Rng

    backend = _backend(args.backend)
    keys = ProvingKeys.load(args.key_file)
    circ = _circuit(keys.circ_id, keys.params)
    circuit_cls = type(circ)
    n = circ.num_subcircuits()
    rng = Rng.from_int(1000)
    t0 = time.time()

    print(f"[work] {keys.circ_id}: {n} subcircuits, backend={backend.name}")
    stage0 = CoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    resps0 = [
        process_stage0_request(rng.fork(str(i).encode()), circuit_cls, keys.get_pk(i), reqs0[i], backend)
        for i in range(n)
    ]
    print(f"[work] stage0 done ({time.time() - t0:.1f}s)")
    if args.spill_dir:
        reqs0, resps0 = _spill(args.spill_dir, circuit_cls, reqs0, resps0)

    ipp_ck = ipp_setup(n, Rng.from_int(2000))
    stage1 = stage0.process_stage0_responses(ipp_ck, resps0)
    reqs1 = [stage1.gen_request(i) for i in range(n)]
    agg_state = stage1.into_agg_state()
    resps1 = [
        process_stage1_request(
            rng.fork(b"s1" + str(i).encode()), circuit_cls, keys.get_pk(i), reqs0[i], resps0[i], reqs1[i], backend
        )
        for i in range(n)
    ]
    print(f"[work] stage1 done ({time.time() - t0:.1f}s)")

    agg_pk = AggProvingKey(tipa_key_from_ipp(ipp_ck), lambda i: keys.get_pk(i))
    agg_proof = agg_state.gen_agg_proof(agg_pk, resps1)
    print(f"[work] aggregation done ({time.time() - t0:.1f}s)")

    ok = agg_pk.verify_aggregate(agg_transcript(), agg_state.super_com, agg_proof, agg_state.public_inputs)
    print(f"[work] aggregate proof verified: {ok}")
    if not ok:
        sys.exit(1)

    # proof sizes, measured by serializing the proofs
    from .protocol.serialization import serialize_agg_proof, serialize_groth16_proof

    agg_u = serialize_agg_proof(agg_proof, compressed=False)
    agg_c = serialize_agg_proof(agg_proof, compressed=True)
    g16_u = serialize_groth16_proof(resps1[0].proof, compressed=False)
    g16_c = serialize_groth16_proof(resps1[0].proof, compressed=True)
    ncom = len(agg_proof.tipa_proof.cross_coms)
    print(
        f"[work] aggregate proof: {ncom} GIPA rounds, "
        f"{len(agg_u)} bytes uncompressed / {len(agg_c)} bytes compressed "
        f"(measured; GT elements dominate); per-subcircuit G16 proof: "
        f"{len(g16_u)}B/{len(g16_c)}B"
    )


def cmd_write_big_merkle_r1cs(args):
    from .circom import R1CSFile, write_witness
    from .protocol.portal_manager import SetupVarPortalManager
    from .r1cs.builder import ConstraintSystem
    from .utils.rng import Rng
    from .workloads.merkle import MerkleTreeCircuit, MerkleTreeCircuitParams

    params = MerkleTreeCircuitParams(args.num_subcircuits // 2, args.num_sha2_iters, 1)
    circ = MerkleTreeCircuit.rand(Rng.from_int(1000), params)
    cs = ConstraintSystem()
    pm = SetupVarPortalManager(cs, "rom")
    for idx in range(circ.num_subcircuits()):
        pm.start_subtrace()
        circ.generate_constraints(cs, idx, pm)
    f = R1CSFile.from_cs(cs)
    with open(args.r1cs_out, "wb") as fh:
        fh.write(f.write())
    with open(args.witness_out, "w") as fh:
        fh.write(write_witness(f.witness))
    print(f"[write-r1cs] {cs.num_constraints} constraints -> {args.r1cs_out}")


def _log2_exact(n: int) -> int:
    log_n = (n - 1).bit_length()
    if 1 << log_n != n:
        raise SystemExit("num_subcircuits must be a power of two")
    return log_n


def main(argv=None):
    p = argparse.ArgumentParser(prog="hekaton-tpu-torch")
    p.add_argument("--backend", choices=["gpu", "cpu", "host"], default="gpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("setup-big-merkle")
    s.add_argument("--num-subcircuits", type=int, required=True)
    s.add_argument("--num-sha2-iters", type=int, required=True)
    s.add_argument("--num-portals", type=int, required=True)
    s.add_argument("--key-out", required=True)

    s = sub.add_parser("setup-vm")
    s.add_argument("--num-subcircuits", type=int, required=True)
    s.add_argument("--num-cycles-per-subcircuit", type=int, required=True)
    s.add_argument("--use-merkle-memory", action="store_true")
    s.add_argument("--key-out", required=True)

    s = sub.add_parser("setup-vkd")
    s.add_argument("--num-subcircuits", type=int, required=True)
    s.add_argument("--key-out", required=True)

    s = sub.add_parser("setup-r1cs")
    s.add_argument("--num-subcircuits", type=int, required=True)
    s.add_argument("--num-txs", type=int, required=True)
    s.add_argument("--circuit-file", required=True)
    s.add_argument("--key-out", required=True)

    s = sub.add_parser("setup-chain")
    s.add_argument("--num-subcircuits", type=int, required=True)
    s.add_argument("--key-out", required=True)

    s = sub.add_parser("write-big-merkle-r1cs")
    s.add_argument("--num-subcircuits", type=int, required=True)
    s.add_argument("--num-sha2-iters", type=int, required=True)
    s.add_argument("--r1cs-out", required=True)
    s.add_argument("--witness-out", required=True)

    s = sub.add_parser("work")
    s.add_argument("--key-file", required=True)
    s.add_argument("--spill-dir", default=None,
                   help="spill stage-0 state to disk between phases (all_in_one low-mem mode)")

    args = p.parse_args(argv)
    if args.cmd == "setup-big-merkle":
        from .workloads.merkle import MerkleTreeCircuitParams

        params = MerkleTreeCircuitParams(args.num_subcircuits // 2, args.num_sha2_iters, args.num_portals)
        cmd_setup(args, "big-merkle", params)
    elif args.cmd == "setup-vm":
        from .workloads.vm import VirtualMachineParameters

        params = VirtualMachineParameters(
            log_num_subcircuit=_log2_exact(args.num_subcircuits),
            dummy_constraint_num=30,
            operations_per_chunk=args.num_cycles_per_subcircuit,
            use_merkle_memory=args.use_merkle_memory,
        )
        cmd_setup(args, "vm", params)
    elif args.cmd == "setup-vkd":
        from .workloads.vkd import VerifiableKeyDirectoryCircuitParams
        from .workloads.vkd.vkd import null_leaf_value

        params = VerifiableKeyDirectoryCircuitParams(_log2_exact(args.num_subcircuits), null_leaf_value())
        cmd_setup(args, "vkd", params)
    elif args.cmd == "setup-r1cs":
        from .workloads.partitioned_r1cs import PartitionedR1CSCircuitParams

        params = PartitionedR1CSCircuitParams(args.num_subcircuits, args.num_txs, args.circuit_file)
        cmd_setup(args, "partitioned-r1cs", params)
    elif args.cmd == "setup-chain":
        from .workloads.chain import PortalChainParams

        cmd_setup(args, "chain", PortalChainParams(args.num_subcircuits))
    elif args.cmd == "write-big-merkle-r1cs":
        cmd_write_big_merkle_r1cs(args)
    elif args.cmd == "work":
        cmd_work(args)


if __name__ == "__main__":
    main()
