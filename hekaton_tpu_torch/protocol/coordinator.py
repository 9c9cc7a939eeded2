"""Coordinator state machine: PK generation, trace sorting, exec tree, stages.

Copy of hekaton_tpu/protocol/coordinator.py with the imports changed: the
CRS generator and backend are the port's. `crs_plan` and the host exec tree
are unchanged. With HEKATON_DEVICE_TREE set (and the Poseidon tree hash),
`generate_exec_tree` builds the tree on the device instead
(protocol/eval_tree_torch.py, the port of the JAX package's
eval_tree_jax.py) on the card, with the same root, levels and leaves.

Behavioral equivalent of the reference's distributed-prover/src/coordinator.rs:
 - G16ProvingKeyGenerator (coordinator.rs:32-88): per-unique-subcircuit CRS
   with placeholder subtraces (only lengths matter)
 - sort_subtraces_by_addr (coordinator.rs:92-119): flatten, sort by addr (ROM)
   or (addr, timestamp) (RAM), re-chunk to the same lengths
 - generate_exec_tree (coordinator.rs:125-174): running evals scanned over all
   subtraces, one leaf per subcircuit
 - CoordinatorStage0State / CoordinatorStage1State / FinalAggState.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..protocol.eval_tree import ExecTreeLeaf, MerklePath, MerkleTree
from ..protocol.ipp import IppCom, IppCommitmentKey, commit_only_left
from ..protocol.transcript import RamTranscriptEntry, new_running_evaluation, padding_entry
from ..utils.rng import Rng

from ..cpgroth16.backend import DEFAULT_BACKEND
from ..cpgroth16.generator import generate_parameters


class G16ProvingKeyGenerator:
    def __init__(self, circ, backend=DEFAULT_BACKEND):
        self.circ = circ
        self.backend = backend
        self.time_ordered_subtraces = circ.get_portal_subtraces()

    def gen_pk(self, rng: Rng, subcircuit_idx: int):
        from ..protocol.subcircuit import SubcircuitWithPortalsProver

        n = self.circ.num_subcircuits()
        subcirc = SubcircuitWithPortalsProver(type(self.circ), n)
        subcirc.subcircuit_idx = subcircuit_idx
        subcirc.circ = self.circ
        # placeholder subtraces: only the lengths matter for the CRS
        st = self.time_ordered_subtraces[subcircuit_idx]
        subcirc.time_ordered_subtrace = list(st)
        subcirc.addr_ordered_subtrace = list(st)
        return generate_parameters(subcirc, rng, self.backend)


def crs_plan(circ):
    """(unique_indices, representatives) for CRS deduplication.

    Wraps the workload's get_unique_subcircuits/representative_subcircuit
    (lib.rs:70-73) with a protocol-level correction: the subcircuit wrapper
    adds boundary constraints for index 0 (evals==1 / padding checks,
    subcircuit_circuit.rs:193-209) and index n-1 (time-eval == addr-eval,
    :259-264), so those two indices NEVER share a CRS with middle subcircuits
    even when the workload says their shapes match. The reference maps e.g.
    all VKD padding subcircuits to index 0's CRS (vkd_constraints.rs:203) and
    VM's last subcircuit to index 1's (vm_constraints.rs:95), which produces
    unverifiable proofs for those indices — unnoticed there because
    per-subcircuit verification is disabled (subcircuit_circuit.rs:549-551).
    """
    n = circ.num_subcircuits()
    reps = [0] * n
    delegate_cache: dict = {}
    for i in range(n):
        if i == 0 or i == n - 1:
            reps[i] = i
            continue
        r = circ.representative_subcircuit(i)
        if r == 0 or r == n - 1:
            # pick a canonical middle delegate of the same workload shape
            key = r
            if key not in delegate_cache:
                delegate_cache[key] = min(
                    j for j in range(1, n - 1) if circ.representative_subcircuit(j) == key
                )
            r = delegate_cache[key]
        reps[i] = r
    unique = sorted(set(reps))
    return unique, reps


def sort_subtraces_by_addr(time_ordered_subtraces: list) -> list:
    flat = [e for st in time_ordered_subtraces for e in st]
    if flat and isinstance(flat[0], RamTranscriptEntry):
        flat.sort(key=lambda e: (e.addr, e.timestamp))
    else:
        flat.sort(key=lambda e: e.addr)
    out = []
    pos = 0
    for st in time_ordered_subtraces:
        out.append(flat[pos : pos + len(st)])
        pos += len(st)
    return out


def generate_exec_tree(mem_type, super_com: IppCom, time_sts, addr_sts):
    import os

    from .eval_tree import POSEIDON_TREE_HASH, TREE_HASH

    if os.environ.get("HEKATON_DEVICE_TREE") and TREE_HASH is POSEIDON_TREE_HASH:
        # the batched scan and Poseidon Merkle tree, bit-identical to the loop below
        from .eval_tree_torch import generate_exec_tree_device

        return generate_exec_tree_device(mem_type, super_com, time_sts, addr_sts, device="cuda")
    evals = new_running_evaluation(mem_type, super_com.to_bytes())
    leaves = []
    last_entry = padding_entry(mem_type)
    for time_st, addr_st in zip(time_sts, addr_sts):
        for te, ae in zip(time_st, addr_st):
            evals.update_time_ordered(te)
            evals.update_addr_ordered(ae)
            last_entry = ae
        leaves.append(ExecTreeLeaf(evals.clone(), last_entry))
    tree = MerkleTree([leaf.to_field_elements() for leaf in leaves])
    return tree, leaves


@dataclass
class Stage0Request:
    subcircuit_idx: int
    time_ordered_subtrace: list
    addr_ordered_subtrace: list


@dataclass
class Stage1Request:
    subcircuit_idx: int
    cur_leaf: ExecTreeLeaf
    next_leaf_membership: MerklePath
    root: int
    serialized_witnesses: bytes
    circ_params: object


class CoordinatorStage0State:
    def __init__(self, circ):
        self.circ_params = circ.get_params()
        self.circuit_cls = type(circ)
        self.num_subcircuits = circ.num_subcircuits()
        self.all_serialized_witnesses = [
            circ.get_serialized_witnesses(i) for i in range(self.num_subcircuits)
        ]
        self.time_ordered_subtraces = circ.get_portal_subtraces()
        self.addr_ordered_subtraces = sort_subtraces_by_addr(self.time_ordered_subtraces)

    def gen_request(self, subcircuit_idx: int) -> Stage0Request:
        return Stage0Request(
            subcircuit_idx,
            self.time_ordered_subtraces[subcircuit_idx],
            self.addr_ordered_subtraces[subcircuit_idx],
        )

    def process_stage0_responses(self, ipp_ck: IppCommitmentKey, responses: list):
        buf = sorted(responses, key=lambda r: r.subcircuit_idx)
        coms = [r.com for r in buf]
        seeds = [r.com_seed for r in buf]
        super_com = commit_only_left(ipp_ck, coms)
        return CoordinatorStage1State(self, coms, seeds, super_com)


class CoordinatorStage1State:
    def __init__(self, stage0: CoordinatorStage0State, coms, seeds, super_com: IppCom):
        self.circuit_cls = stage0.circuit_cls
        self.circ_params = stage0.circ_params
        self.all_serialized_witnesses = stage0.all_serialized_witnesses
        self.coms = coms
        self.seeds = seeds
        self.super_com = super_com
        tree, leaves = generate_exec_tree(
            stage0.circuit_cls.MEM_TYPE,
            super_com,
            stage0.time_ordered_subtraces,
            stage0.addr_ordered_subtraces,
        )
        self.exec_tree_leaves = leaves
        self.exec_tree_root = tree.root()
        self.exec_tree_leaf_auth_paths = [
            tree.generate_proof(i) for i in range(stage0.num_subcircuits)
        ]

    def gen_request(self, subcircuit_idx: int) -> Stage1Request:
        if subcircuit_idx > 0:
            cur_leaf = self.exec_tree_leaves[subcircuit_idx - 1]
        else:
            cur_leaf = ExecTreeLeaf.padding(self.circuit_cls.MEM_TYPE)
            cur_leaf.evals.challenges = self.exec_tree_leaves[0].evals.challenges
        return Stage1Request(
            subcircuit_idx,
            cur_leaf,
            self.exec_tree_leaf_auth_paths[subcircuit_idx],
            self.exec_tree_root,
            self.all_serialized_witnesses[subcircuit_idx],
            self.circ_params,
        )

    def into_agg_state(self) -> "FinalAggState":
        public_inputs = list(self.exec_tree_leaves[0].evals.challenge_list()) + [
            self.exec_tree_root
        ]
        return FinalAggState(public_inputs, self.super_com)


class FinalAggState:
    def __init__(self, public_inputs: list, super_com: IppCom):
        self.public_inputs = public_inputs
        self.super_com = super_com

    def gen_agg_proof(self, agg_ck, resps: list):
        from ..protocol.aggregation import agg_subcircuit_proofs, agg_transcript

        buf = sorted(resps, key=lambda r: r.subcircuit_idx)
        proofs = [r.proof for r in buf]
        return agg_subcircuit_proofs(
            agg_ck, agg_transcript(), self.super_com, proofs, self.public_inputs
        )
