"""Worker request processors: stage-0 commit, stage-1 prove.

Copy of hekaton_tpu/protocol/worker.py with the imports changed: the
coordinator, prover and backend are the port's.

Behavioral equivalent of the reference's distributed-prover/src/worker.rs:
stage 0 builds an empty wrapper prover, derives a fresh commitment seed, and
commits to the subtraces; stage 1 rebuilds the circuit from serialized
witnesses, fills in the leaf/path/root/challenges, and proves. The seed in the
stage-0 response lets a stateless worker recommit deterministically in stage 1
(worker.rs:234-241) — the recovery/elasticity property the reference relies on.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..protocol.subcircuit import SubcircuitWithPortalsProver
from ..utils.rng import Rng

from ..cpgroth16.backend import DEFAULT_BACKEND
from ..cpgroth16.data_structures import Proof
from ..cpgroth16.prover import CommitmentBuilder
from .coordinator import Stage0Request, Stage1Request


@dataclass
class Stage0Response:
    subcircuit_idx: int
    com: object  # G1 host point
    com_seed: bytes


@dataclass
class Stage1Response:
    subcircuit_idx: int
    proof: Proof


def process_stage0_request_get_cb(
    rng: Rng, circuit_cls, pk, req: Stage0Request, backend=DEFAULT_BACKEND
):
    prover = SubcircuitWithPortalsProver(circuit_cls, 2)
    prover.subcircuit_idx = req.subcircuit_idx
    prover.time_ordered_subtrace = req.time_ordered_subtrace
    prover.addr_ordered_subtrace = req.addr_ordered_subtrace

    com_seed = rng.next_seed()
    subcircuit_rng = Rng(com_seed)
    cb = CommitmentBuilder(prover, pk, backend)
    com, kappa = cb.commit(subcircuit_rng)
    return Stage0Response(req.subcircuit_idx, com, com_seed), cb, kappa


def process_stage0_request(rng: Rng, circuit_cls, pk, req: Stage0Request, backend=DEFAULT_BACKEND):
    return process_stage0_request_get_cb(rng, circuit_cls, pk, req, backend)[0]


def process_stage1_request_with_cb(
    rng: Rng, cb: CommitmentBuilder, com, kappa, stage1_req: Stage1Request
) -> Stage1Response:
    circ = cb.circuit
    assert circ.subcircuit_idx == stage1_req.subcircuit_idx

    underlying = circ.circuit_cls.new(stage1_req.circ_params)
    underlying.set_serialized_witnesses(stage1_req.subcircuit_idx, stage1_req.serialized_witnesses)
    circ.circ = underlying
    circ.num_subcircuits = underlying.num_subcircuits()

    circ.cur_leaf = stage1_req.cur_leaf
    circ.next_leaf_membership = stage1_req.next_leaf_membership
    circ.root = stage1_req.root
    circ.challenges = stage1_req.cur_leaf.evals.challenge_list()

    proof = cb.prove([com], [kappa], rng)
    return Stage1Response(stage1_req.subcircuit_idx, proof)


def process_stage1_request(
    rng: Rng,
    circuit_cls,
    pk,
    stage0_req: Stage0Request,
    stage0_resp: Stage0Response,
    stage1_req: Stage1Request,
    backend=DEFAULT_BACKEND,
) -> Stage1Response:
    """Stateless path: recommit deterministically from the stage-0 seed."""
    prover = SubcircuitWithPortalsProver(circuit_cls, 2)
    prover.subcircuit_idx = stage0_req.subcircuit_idx
    prover.time_ordered_subtrace = stage0_req.time_ordered_subtrace
    prover.addr_ordered_subtrace = stage0_req.addr_ordered_subtrace

    cb = CommitmentBuilder(prover, pk, backend)
    subcircuit_rng = Rng(stage0_resp.com_seed)
    com, kappa = cb.commit(subcircuit_rng)
    assert com == stage0_resp.com, "recommitment mismatch: nondeterministic commit"
    return process_stage1_request_with_cb(rng, cb, com, kappa, stage1_req)
