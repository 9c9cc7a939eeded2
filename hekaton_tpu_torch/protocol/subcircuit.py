"""The two-stage per-subcircuit prover circuit.

Equivalent of SubcircuitWithPortalsProver
(distributed-prover/src/subcircuit_circuit.rs:30-277):
stage 0 witnesses both subtraces (the committed stage); stage 1 witnesses the
previous exec-tree leaf + auth path, takes the challenges and tree root as
public inputs, runs the workload's constraints through the prover portal
manager, re-derives the next leaf and proves its tree membership, and on the
final subcircuit closes the permutation argument (time eval == addr eval).
"""
from __future__ import annotations

import math

from ..r1cs.builder import ConstraintSystem, MultiStageSynthesizer
from ..r1cs.gadgets import FpVar
from .eval_tree import ExecTreeLeaf, ExecTreeLeafVar, MerklePath, MerklePathVar
from .portal_manager import prover_portal_manager
from .transcript import num_challenges, witness_entry_var


class SubcircuitWithPortalsProver(MultiStageSynthesizer):
    def __init__(self, circuit_cls, num_subcircuits: int):
        self.circuit_cls = circuit_cls
        self.num_subcircuits = num_subcircuits
        self.subcircuit_idx = 0
        self.circ = None  # workload instance (CircuitWithPortals)

        # stage 0 values
        self.time_ordered_subtrace = []
        self.addr_ordered_subtrace = []
        self._time_vars = None
        self._addr_vars = None

        # stage 1 values
        auth_len = max(1, int(math.log2(num_subcircuits)))
        self.cur_leaf = ExecTreeLeaf.padding(circuit_cls.MEM_TYPE)
        self.next_leaf_membership = MerklePath(0, [0] * auth_len)
        self.challenges = [0] * num_challenges(circuit_cls.MEM_TYPE)
        self.root = 0

    def total_num_stages(self):
        return 2

    def generate_constraints(self, stage: int, cs: ConstraintSystem):
        cs.begin_stage()
        if stage == 0:
            self._time_vars = [witness_entry_var(cs, e) for e in self.time_ordered_subtrace]
            self._addr_vars = [witness_entry_var(cs, e) for e in self.addr_ordered_subtrace]
            cs.end_stage()
            return
        assert stage == 1

        cur_leaf_var = ExecTreeLeafVar.witness(cs, self.cur_leaf)
        path_var = MerklePathVar.witness(cs, self.next_leaf_membership)
        chal_vars = [FpVar.input(cs, c) for c in self.challenges]
        root_var = FpVar.input(cs, self.root)

        if self.subcircuit_idx == 0:
            cur_leaf_var.evals.time_ordered_eval.enforce_equal(1)
            cur_leaf_var.evals.addr_ordered_eval.enforce_equal(1)
            cur_leaf_var.last_subtrace_entry.is_padding().enforce_true()

        running_evals = cur_leaf_var.evals.clone()
        running_evals.set_challenges(chal_vars)

        # Prepend the previous leaf's last entry to the addr-ordered subtrace
        full_addr = [cur_leaf_var.last_subtrace_entry] + list(self._addr_vars)
        last_subtrace_entry = full_addr[-1]

        pm = prover_portal_manager(
            self.circuit_cls.MEM_TYPE, list(self._time_vars), full_addr, running_evals
        )
        self.circ.generate_constraints(cs, self.subcircuit_idx, pm)

        next_leaf = ExecTreeLeafVar(pm.running_evals, last_subtrace_entry)
        path_var.verify_membership(root_var, next_leaf.to_field_elements())

        if self.subcircuit_idx == self.num_subcircuits - 1:
            next_leaf.evals.time_ordered_eval.enforce_equal(next_leaf.evals.addr_ordered_eval)

        cs.end_stage()
