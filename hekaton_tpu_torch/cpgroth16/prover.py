"""CP-Groth16 commitment builder and prover.

Copy of hekaton_tpu/cpgroth16/prover.py with the imports changed: the
backend and the data structures are the port's.

Behavioral equivalent of the reference's cp-groth16/src/committer.rs (stage-
by-stage commit with last_delta blinding, final prove subtracting sum kappa_i
delta_i from C) and prover.rs (A/B/C assembly with the QAP witness map).
The MSMs and the witness-map NTTs route through the pluggable backend
(the port's TorchBackend in production).
"""
from __future__ import annotations

from ..curves import host as ch
from ..fields.bn254 import R
from ..r1cs.builder import ConstraintSystem, MultiStageSynthesizer
from ..utils.rng import Rng

from .backend import DEFAULT_BACKEND
from .data_structures import Proof, ProvingKey


def _matrix_evals(cs: ConstraintSystem, domain_size: int):
    """A.z, B.z, C.z over the evaluation domain, with input-consistency rows."""
    z = cs.full_assignment()
    nc, ni = cs.num_constraints, cs.num_instance
    a_rows, b_rows, c_rows = cs.matrices()

    def matvec(rows):
        out = [0] * domain_size
        for i, row in enumerate(rows):
            acc = 0
            for col, coeff in row:
                acc += coeff * z[col]
            out[i] = acc % R
        return out

    a_evals = matvec(a_rows)
    b_evals = matvec(b_rows)
    c_evals = matvec(c_rows)
    for i in range(ni):
        a_evals[nc + i] = z[i]
    return a_evals, b_evals, c_evals


def prove_last_stage(
    cs: ConstraintSystem,
    circuit: MultiStageSynthesizer,
    pk: ProvingKey,
    r: int,
    s: int,
    backend=DEFAULT_BACKEND,
) -> tuple:
    """Returns (A, B, C) group elements (no commitments attached yet)."""
    from ..utils.timing import span

    with span("prove.synthesize"):
        circuit.generate_constraints(circuit.last_stage(), cs)
    with span("prove.matrix_evals"):
        if cs.value_only:
            # fast path: precompiled matrices (generator-attached) provide the
            # evals AND the satisfiability check against the value-only witness
            a_evals, b_evals, c_evals = pk.compiled.evals(
                cs.full_assignment(), pk.domain_size, check=True
            )
        else:
            assert cs.is_satisfied(), f"unsatisfied constraint {cs.which_unsatisfied()}"
            a_evals, b_evals, c_evals = _matrix_evals(cs, pk.domain_size)

    z = cs.full_assignment()

    # A = alpha + <a_g, z> + r*delta_last
    with span("prove.msm_a"):
        a_acc = backend.msm(pk.a_g, z)
    a_pt = ch.pt_add(ch.pt_add(a_acc, pk.vk.alpha_g), ch.pt_mul(pk.last_delta_g, r))

    # B (G2) = beta + <b_h, z> + s*delta_last
    with span("prove.msm_b_g2"):
        b_acc_h = backend.msm(pk.b_h, z)
    b_pt_h = ch.pt_add(ch.pt_add(b_acc_h, pk.vk.beta_h), ch.pt_mul(pk.vk.last_delta_h, s))

    # B (G1), only needed when r != 0
    if r % R != 0:
        with span("prove.msm_b_g1"):
            b_acc_g = backend.msm(pk.b_g, z)
        b_pt_g = ch.pt_add(ch.pt_add(b_acc_g, pk.beta_g), ch.pt_mul(pk.last_delta_g, s))
    else:
        b_pt_g = None

    # L-aux over the last stage's witness
    last_witness = cs.current_stage_witness()
    with span("prove.msm_l"):
        l_aux = backend.msm(pk.last_ck(), last_witness)

    # h query
    with span("prove.witness_map"):
        h = backend.witness_map(a_evals, b_evals, c_evals)
    with span("prove.msm_h"):
        h_acc = backend.msm(pk.h_g, h)

    # C = s*A + r*B - r*s*delta_last + l_aux + h_acc
    c_pt = ch.pt_mul(a_pt, s)
    c_pt = ch.pt_add(c_pt, ch.pt_mul(b_pt_g, r))
    c_pt = ch.pt_sub(c_pt, ch.pt_mul(pk.last_delta_g, r * s % R))
    c_pt = ch.pt_add(c_pt, l_aux)
    c_pt = ch.pt_add(c_pt, h_acc)

    return a_pt, b_pt_h, c_pt


class CommitmentBuilder:
    """Stage-by-stage committer (committer.rs:15-123): commit() synthesizes the
    current stage and commits its witness; prove() runs the final stage."""

    def __init__(self, circuit: MultiStageSynthesizer, pk: ProvingKey, backend=DEFAULT_BACKEND):
        # value-only synthesis when the PK carries compiled matrices
        # (generator-attached; absent on hand-built/legacy keys)
        self.cs = ConstraintSystem(value_only=getattr(pk, "compiled", None) is not None)
        self.circuit = circuit
        self.cur_stage = 0
        self.pk = pk
        self.backend = backend

    def commit(self, rng: Rng):
        self.circuit.generate_constraints(self.cur_stage, self.cs)
        # value-only mode defers the satisfiability check to prove time
        # (CompiledMatrices.evals checks every row, incl. this stage's)
        assert self.cs.value_only or self.cs.is_satisfied(), (
            f"unsatisfied constraint {self.cs.which_unsatisfied()}"
        )
        witness = self.cs.current_stage_witness()
        current_ck = self.pk.ck.deltas_abc_g[self.cur_stage]
        assert len(witness) == len(current_ck), (
            f"stage {self.cur_stage}: witness {len(witness)} != ck {len(current_ck)}"
        )
        kappa = rng.next_fr()
        com = ch.pt_add(
            self.backend.msm(current_ck, witness), ch.pt_mul(self.pk.ck.last_delta_g, kappa)
        )
        self.cur_stage += 1
        return com, kappa

    def prove(self, comms: list, comm_rands: list, rng: Rng) -> Proof:
        r = rng.next_fr()
        s = rng.next_fr()
        return self.prove_with_randomness(comms, comm_rands, r, s)

    def prove_with_randomness(self, comms: list, comm_rands: list, r: int, s: int) -> Proof:
        a, b, c = prove_last_stage(self.cs, self.circuit, self.pk, r, s, self.backend)
        # C -= sum kappa_i * delta_i over the committed stages
        assert len(self.pk.deltas_g) == len(comm_rands) + 1
        for kappa, delta_g in zip(comm_rands, self.pk.deltas_g):
            c = ch.pt_sub(c, ch.pt_mul(delta_g, kappa))
        return Proof(a, b, c, list(comms))
