"""CP-Groth16 CRS generation (setup).

Copy of hekaton_tpu/cpgroth16/generator.py with the imports changed: the
backend, the data structures and the host Domain are the port's.

Behavioral equivalent of the reference's cp-groth16/src/generator.rs:18-238:
per-stage deltas, libsnark-style QAP instance map (domain = constraints +
instances, with input-consistency rows added to A), gamma/delta-divided ABC
columns, and group queries computed by fixed-base scalar multiplication — on
TPU via the table-based batch kernel when a TpuBackend is given.
"""
from __future__ import annotations

from ..curves import host as ch
from ..fields.bn254 import R
from ..fields.host import fr_inv
from ..r1cs.builder import ConstraintSystem, MultiStageSynthesizer
from ..utils.rng import Rng

from ..ntt.ntt import Domain
from .backend import DEFAULT_BACKEND
from .data_structures import CommitterKey, PointVec, ProvingKey, VerifyingKey, g1vec, g2vec


def qap_instance_map(cs: ConstraintSystem, t: int):
    """Evaluate the QAP column polynomials u_i, v_i, w_i at tau=t.

    Domain size = num_constraints + num_instance; the extra rows put the
    identity on instance columns of A (libsnark input-consistency trick).
    Returns (a, b, c, zt, domain) with one entry per global column.
    """
    nc, ni = cs.num_constraints, cs.num_instance
    domain = Domain(nc + ni)
    u = domain.lagrange_coeffs_at(t)
    zt = domain.vanishing_at(t)
    ncols = ni + cs.num_witness
    a = [0] * ncols
    b = [0] * ncols
    c = [0] * ncols
    for i in range(ni):
        a[i] = u[nc + i]
    a_rows, b_rows, c_rows = cs.matrices()
    for row_idx, row in enumerate(a_rows):
        ui = u[row_idx]
        for col, coeff in row:
            a[col] = (a[col] + coeff * ui) % R
    for row_idx, row in enumerate(b_rows):
        ui = u[row_idx]
        for col, coeff in row:
            b[col] = (b[col] + coeff * ui) % R
    for row_idx, row in enumerate(c_rows):
        ui = u[row_idx]
        for col, coeff in row:
            c[col] = (c[col] + coeff * ui) % R
    return a, b, c, zt, domain


def generate_parameters(
    circuit: MultiStageSynthesizer, rng: Rng, backend=DEFAULT_BACKEND
) -> ProvingKey:
    alpha = rng.next_nonzero_fr()
    beta = rng.next_nonzero_fr()
    gamma = rng.next_nonzero_fr()
    deltas = [rng.next_nonzero_fr() for _ in range(circuit.total_num_stages())]

    g1_gen = ch.pt_mul(ch.g1_gen(), rng.next_nonzero_fr())
    g2_gen = ch.pt_mul(ch.g2_gen(), rng.next_nonzero_fr())

    cs = ConstraintSystem(setup_mode=True)
    circuit.synthesize_all(cs)

    ni = cs.num_instance
    # compile the (shape-defining, value-independent) matrices once: per
    # proof the worker then synthesizes values-only (r1cs/fastsynth.py)
    from ..r1cs.fastsynth import CompiledMatrices

    compiled = CompiledMatrices(cs)
    # tau outside the domain
    domain_probe = Domain(cs.num_constraints + ni)
    while True:
        t = rng.next_fr()
        if domain_probe.vanishing_at(t) != 0:
            break

    a, b, c, zt, domain = qap_instance_map(cs, t)

    gamma_inv = fr_inv(gamma)
    gamma_abc = [(beta * a[i] + alpha * b[i] + c[i]) * gamma_inv % R for i in range(ni)]

    deltas_abc = []
    for delta, (s, e) in zip(deltas, cs.stage_ranges):
        dinv = fr_inv(delta)
        cols = range(ni + s, ni + e)
        deltas_abc.append(
            [(beta * a[i] + alpha * b[i] + c[i]) * dinv % R for i in cols]
        )

    last_delta_inv = fr_inv(deltas[-1])
    m = domain.n
    # h query scalars: t^i * Z(t) / delta_last, i in 0..m-2
    h_scalars = []
    cur = zt * last_delta_inv % R
    for _ in range(m - 1):
        h_scalars.append(cur)
        cur = cur * t % R

    # Group queries
    fb1 = lambda scalars: g1vec(backend.fixed_base(g1_gen, scalars))
    fb2 = lambda scalars: g2vec(backend.fixed_base(g2_gen, scalars, g2=True))

    a_g = fb1(a)
    b_g = fb1(b)
    b_h = fb2(b)
    h_g = fb1(h_scalars)
    gamma_abc_g = backend.fixed_base(g1_gen, gamma_abc)
    deltas_g = backend.fixed_base(g1_gen, deltas)
    deltas_h = backend.fixed_base(g2_gen, deltas, g2=True)
    deltas_abc_g = [fb1(v) for v in deltas_abc]

    alpha_g = ch.pt_mul(g1_gen, alpha)
    beta_g = ch.pt_mul(g1_gen, beta)
    beta_h = ch.pt_mul(g2_gen, beta)
    gamma_h = ch.pt_mul(g2_gen, gamma)

    vk = VerifyingKey(alpha_g, beta_h, gamma_h, deltas_h, gamma_abc_g)
    ck = CommitterKey(deltas_g[-1], deltas_abc_g)
    return ProvingKey(
        vk=vk,
        beta_g=beta_g,
        a_g=a_g,
        b_g=b_g,
        b_h=b_h,
        h_g=h_g,
        ck=ck,
        deltas_g=deltas_g,
        domain_size=m,
        num_instance=ni,
        compiled=compiled,
    )
