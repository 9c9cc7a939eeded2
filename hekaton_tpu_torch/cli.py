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
all_in_one mode). With `--mesh SUBxPTS` both prover stages run on the
port's torch.distributed mesh (runtime/mesh_prover.py: subcircuits over
`sub` rows of ranks, each MSM's points over the `pts` ranks of a row), one
rank per device: NCCL on the card (`--backend gpu`), gloo on the CPU
(`--backend cpu`); `--backend host` runs no mesh. One process is a world
of one rank (`--mesh 1x1`); more ranks run under torchrun, every rank with
the same arguments, and only rank 0 prints:

    torchrun --nproc-per-node 4 -m hekaton_tpu_torch.cli --backend cpu work --key-file k.bin --mesh 2x2

`--force-ladder` runs every mesh MSM on pippenger's double-and-add ladder.
With `--spill-dir`, stage 1 is the sequential stateless recommit, as in the
JAX CLI. Host pairings and aggregation run on the coordinator (on every
rank), as in the JAX package; the exit status is the aggregate proof's.
"""
from __future__ import annotations

import argparse
import contextlib
import io
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


def _mesh_prover(args, keys):
    """The MeshProver of `work --mesh SUBxPTS` on the backend's device, and
    this process's rank."""
    from .runtime.mesh_prover import MeshProver
    from .runtime.spmd import make_mesh

    if args.backend == "host":
        raise SystemExit("work --mesh runs on a device backend (--backend gpu or cpu), not --backend host")
    sub_ax, pts_ax = (int(x) for x in args.mesh.lower().split("x"))
    mesh = make_mesh(sub_ax * pts_ax, sub=sub_ax, pts=pts_ax, device="cuda" if args.backend == "gpu" else "cpu")
    return MeshProver(mesh, keys, force_ladder=args.force_ladder), mesh.rank


def cmd_work(args):
    import torch.distributed as dist

    from .runtime.keys import ProvingKeys

    keys = ProvingKeys.load(args.key_file)
    own_group = args.mesh and not dist.is_initialized()
    mesh_prover, rank = None, 0
    try:
        if args.mesh:
            mesh_prover, rank = _mesh_prover(args, keys)
        # only rank 0 prints; every rank runs the coordinator and checks the aggregate
        with contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext():
            _work(args, keys, mesh_prover)
    finally:  # also when the mesh is refused, a stage raises or the aggregate fails (sys.exit)
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _work(args, keys, mesh_prover):
    from .protocol.aggregation import AggProvingKey, agg_transcript
    from .protocol.coordinator import CoordinatorStage0State
    from .protocol.ipp import ipp_setup
    from .protocol.tipa import tipa_key_from_ipp
    from .protocol.worker import process_stage0_request, process_stage1_request
    from .utils.rng import Rng

    backend = _backend(args.backend)
    circ = _circuit(keys.circ_id, keys.params)
    circuit_cls = type(circ)
    n = circ.num_subcircuits()
    rng = Rng.from_int(1000)
    t0 = time.time()

    if mesh_prover is not None:
        sub_ax, pts_ax = mesh_prover.mesh.shape
        print(f"[work] mesh {sub_ax}x{pts_ax} (sub x pts) over {sub_ax * pts_ax} devices")
    print(f"[work] {keys.circ_id}: {n} subcircuits, backend={backend.name}")
    stage0 = CoordinatorStage0State(circ)
    reqs0 = [stage0.gen_request(i) for i in range(n)]
    if mesh_prover is not None:
        resps0 = mesh_prover.stage0_all(rng, circuit_cls, reqs0)
    else:
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
    if mesh_prover is not None and not args.spill_dir:
        resps1 = mesh_prover.stage1_all(rng, circuit_cls, reqs1)
    else:  # the sequential path, or with --spill-dir the stateless recommit
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
    s.add_argument("--mesh", default=None, metavar="SUBxPTS",
                   help="run both prover stages on a mesh of ranks, e.g. 2x2 (subcircuit-parallel x "
                        "point-parallel; one rank per device, several under torchrun); replaces the "
                        "reference's MPI worker ranks")
    s.add_argument("--force-ladder", action="store_true",
                   help="with --mesh: every MSM on the double-and-add ladder")
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
