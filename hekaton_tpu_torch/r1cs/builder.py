"""R1CS constraint system with multi-stage witness allocation.

Host-side replacement for ark-relations' ConstraintSystem plus cp-groth16's
MultiStageConstraintSystem (cp-groth16/src/constraint_synthesizer.rs:14-134):
tracks per-stage witness ranges so each allocation stage can be committed
separately by the CP-Groth16 committer. Constraint synthesis is irregular,
string/name-driven host work (SURVEY.md §7 "hard parts"); only its *outputs* —
sparse matrices and witness vectors — flow to the TPU kernels.

Variable keys: instance i -> 2i (key 0 = the constant ONE), witness j -> 2j+1.
Linear combinations are plain dicts {key: coeff mod r}.
"""
from __future__ import annotations

from ..fields.bn254 import R


def var_instance(i: int) -> int:
    return i << 1


def var_witness(j: int) -> int:
    return (j << 1) | 1


ONE = var_instance(0)


class ConstraintSystem:
    def __init__(self, setup_mode: bool = False, value_only: bool = False):
        # setup_mode mirrors ark-relations SynthesisMode::Setup: placeholder
        # values are allowed, so witness-consistency assertions are skipped.
        #
        # value_only mirrors arkworks' witness-generation-without-matrices
        # optimization hint (what a production prover does once the matrices
        # are compiled per unique subcircuit shape): allocations and witness
        # values are computed exactly as in full mode — the ALLOCATION ORDER
        # is the contract — but linear combinations are not materialized and
        # enforce() is a no-op. Per-proof satisfiability/evals then come from
        # r1cs.fastsynth.CompiledMatrices against this assignment.
        self.setup_mode = setup_mode
        self.value_only = value_only
        self.instance_assignment = [1]
        self.witness_assignment = []
        self.a_rows: list = []
        self.b_rows: list = []
        self.c_rows: list = []
        # multi-stage bookkeeping: list of [start, end) witness index ranges
        self.stage_ranges: list = []

    # -- allocation ----------------------------------------------------------
    def new_witness(self, value: int) -> int:
        self.witness_assignment.append(value % R)
        return var_witness(len(self.witness_assignment) - 1)

    def new_input(self, value: int) -> int:
        self.instance_assignment.append(value % R)
        return var_instance(len(self.instance_assignment) - 1)

    @property
    def num_instance(self) -> int:
        return len(self.instance_assignment)

    @property
    def num_witness(self) -> int:
        return len(self.witness_assignment)

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    # -- constraints -----------------------------------------------------------
    def enforce(self, a_lc, b_lc, c_lc):
        """Add the constraint <a,z> * <b,z> = <c,z>."""
        if self.value_only:
            return
        self.a_rows.append(dict(a_lc))
        self.b_rows.append(dict(b_lc))
        self.c_rows.append(dict(c_lc))

    # -- multi-stage -------------------------------------------------------------
    def begin_stage(self):
        self.stage_ranges.append([self.num_witness, self.num_witness])

    def end_stage(self):
        self.stage_ranges[-1][1] = self.num_witness

    def current_stage_witness(self) -> list:
        s, e = self.stage_ranges[-1]
        return self.witness_assignment[s:e]

    def stage_witness(self, i: int) -> list:
        s, e = self.stage_ranges[i]
        return self.witness_assignment[s:e]

    # -- evaluation --------------------------------------------------------------
    def var_value(self, key: int) -> int:
        if key & 1:
            return self.witness_assignment[key >> 1]
        return self.instance_assignment[key >> 1]

    def lc_value(self, lc: dict) -> int:
        return sum(c * self.var_value(k) for k, c in lc.items()) % R

    def full_assignment(self) -> list:
        return self.instance_assignment + self.witness_assignment

    def is_satisfied(self) -> bool:
        return self.which_unsatisfied() is None

    def which_unsatisfied(self):
        for i, (a, b, c) in enumerate(zip(self.a_rows, self.b_rows, self.c_rows)):
            if self.lc_value(a) * self.lc_value(b) % R != self.lc_value(c):
                return i
        return None

    # -- export for the prover/generator -------------------------------------------
    def column_of(self, key: int) -> int:
        """Global column index in the [instance..., witness...] layout."""
        if key & 1:
            return self.num_instance + (key >> 1)
        return key >> 1

    def matrices(self):
        """Sparse COO rows: three lists of [(col, coeff), ...] per constraint."""

        def conv(rows):
            return [[(self.column_of(k), c % R) for k, c in row.items()] for row in rows]

        return conv(self.a_rows), conv(self.b_rows), conv(self.c_rows)


class MultiStageSynthesizer:
    """Base class mirroring MultiStageConstraintSynthesizer: stages of
    generate_constraints(stage, cs), each wrapped in begin/end_stage."""

    def total_num_stages(self) -> int:
        raise NotImplementedError

    def last_stage(self) -> int:
        return self.total_num_stages() - 1

    def generate_constraints(self, stage: int, cs: ConstraintSystem):
        raise NotImplementedError

    def synthesize_all(self, cs: ConstraintSystem):
        for stage in range(self.total_num_stages()):
            self.generate_constraints(stage, cs)
