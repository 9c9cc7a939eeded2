"""SnarkPack-style aggregation of the per-subcircuit CP-Groth16 proofs.

Behavioral equivalent of distributed-prover/src/aggregation.rs:
 - AggProvingKey::new (aggregation.rs:60-135): per-circuit CRS columns
   s_j (public-input bases), h (gamma_h), delta0/delta1 (per-stage deltas_h),
   alpha/beta, plus IPP commitments to each column.
 - agg_subcircuit_proofs (aggregation.rs:138-345): commit to (A,B), C, reuse
   the D super-commitment, Fiat-Shamir twist r, 4x4 cross pairing products,
   challenges s/t combining the four Groth16 pairing columns into one twisted
   inner-pairing-product instance, proven with TIPA.

Beyond the reference (which only verifies its own TIPA inline and leaves the
outer verifier unimplemented — README.md:16-19), `verify_aggregate` implements
the full aggregate verifier: cross-term consistency against the alpha/beta
column, commitment recombination, and TIPA verification.

The reference generalization note: the reference hardcodes 4 public-input
columns (3 public inputs, aggregation.rs:27-32); we keep one column per
public input so RAM-type circuits (5 inputs) aggregate too.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..curves import host as ch
from ..fields.bn254 import R
from ..fields.host import Fq12, fr_inv
from ..pairing.host import multi_pairing
from ..utils.fiat_shamir import Transcript
from .ipp import IppCom, commit_only_left, commit_only_right, commit_pair
from .tipa import GipaInstance, GipaWitness, TipaProof, TipaProverKey, tipa_prove, tipa_verify

# Fiat-Shamir domain label shared by the aggregation prover and verifier.
# The reference hardcodes b"test-e2e" at both call sites
# (distributed-prover/src/coordinator.rs:411); here it is one constant so the
# two sides cannot drift.
AGG_TRANSCRIPT_LABEL = b"hekaton-agg-v1"


def agg_transcript() -> Transcript:
    return Transcript(AGG_TRANSCRIPT_LABEL)


def structured_scalar_power(n: int, s: int) -> list:
    """[1, s, s^2, ..., s^{n-1}] (pairing_ops.rs:42-48)."""
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * s % R
    return out


def scalar_pairing(points: list, scalars: list) -> list:
    """Batched point*scalar (pairing_ops.rs:32-39)."""
    return [ch.pt_mul(p, s) for p, s in zip(points, scalars)]


@dataclass
class AggProof:
    com_ab: IppCom
    com_c: IppCom
    cross_terms: list  # 4x4 [[Fq12]]
    tipa_proof: TipaProof


class AggProvingKey:
    def __init__(self, tipa_pk: TipaProverKey, pk_fetcher):
        """pk_fetcher(i) -> the i-th subcircuit's CP-Groth16 ProvingKey."""
        self.tipa_pk = tipa_pk
        n = tipa_pk.supported_size
        ck = tipa_pk.ck

        vk0 = pk_fetcher(0).vk
        self.num_pub_inputs = len(vk0.gamma_abc_g) - 1

        # s_vecs[j][i] = gamma_abc_g[j] of circuit i (aggregation.rs:85-88)
        self.s_vecs = [[None] * n for _ in range(self.num_pub_inputs + 1)]
        self.h = [None] * n
        self.delta0 = [None] * n
        self.delta1 = [None] * n
        self.alpha = [None] * n
        self.beta = [None] * n
        for i in range(n):
            vk = pk_fetcher(i).vk
            assert len(vk.deltas_h) == 2, "aggregation expects 2-stage circuits"
            for j in range(self.num_pub_inputs + 1):
                self.s_vecs[j][i] = vk.gamma_abc_g[j]
            self.h[i] = vk.gamma_h
            self.delta0[i] = vk.deltas_h[0]
            self.delta1[i] = vk.deltas_h[1]
            self.alpha[i] = vk.alpha_g
            self.beta[i] = vk.beta_h

        self.com_s = [commit_only_left(ck, sv) for sv in self.s_vecs]
        self.com_h = commit_only_right(ck, self.h)
        self.com_delta0 = commit_only_right(ck, self.delta0)
        self.com_delta1 = commit_only_right(ck, self.delta1)

    def vk(self):
        return self  # verifier needs the column commitments + alpha/beta + tipa vk

    def _prepared_input(self, pub_inputs: list) -> list:
        """S_i = s0_i + sum_j pubinput_j * s(j+1)_i (aggregation.rs:193-205)."""
        assert len(pub_inputs) == self.num_pub_inputs
        out = []
        for i in range(self.tipa_pk.supported_size):
            acc = self.s_vecs[0][i]
            for j, x in enumerate(pub_inputs):
                acc = ch.pt_add(acc, ch.pt_mul(self.s_vecs[j + 1][i], x))
            out.append(acc)
        return out

    def _com_prepared_input(self, pub_inputs: list) -> IppCom:
        acc = self.com_s[0]
        for j, x in enumerate(pub_inputs):
            acc = acc + self.com_s[j + 1] * x
        return acc

    def agg_subcircuit_proofs(
        self, pt: Transcript, super_com: IppCom, proofs: list, pub_inputs: list
    ) -> AggProof:
        ck = self.tipa_pk.ck
        n = len(proofs)
        assert n == self.tipa_pk.supported_size

        a_vals = [p.a for p in proofs]
        b_vals = [p.b for p in proofs]
        c_vals = [p.c for p in proofs]
        d_vals = [p.ds[0] for p in proofs]  # stage0 commitment per proof

        com_ab = commit_pair(ck, a_vals, b_vals)
        com_c = commit_only_left(ck, c_vals)
        com_d = super_com
        com_prepared_input = self._com_prepared_input(pub_inputs)
        prepared_input = self._prepared_input(pub_inputs)

        # Fiat-Shamir twist (aggregation.rs:219-222)
        pt.append_serializable(b"AB-commitment", [com_ab.t, com_ab.u])
        pt.append_serializable(b"C-commitment", [com_c.t, com_c.u])
        pt.append_serializable(b"D-commitment", [com_d.t, com_d.u])
        twist = pt.challenge_nonzero_fr(b"r-random-fiatshamir")

        twist_powers = structured_scalar_power(n, twist)
        a_r = scalar_pairing(a_vals, twist_powers)
        c_r = scalar_pairing(c_vals, twist_powers)
        d_r = scalar_pairing(d_vals, twist_powers)
        prepared_input_r = scalar_pairing(prepared_input, twist_powers)

        # 4x4 cross pairing products (aggregation.rs:255-263)
        lhs_cols = [a_r, prepared_input_r, d_r, c_r]
        rhs_cols = [b_vals, self.h, self.delta0, self.delta1]
        cross_terms = [[multi_pairing(l, r) for r in rhs_cols] for l in lhs_cols]

        pt.append_serializable(b"cross-terms", [x for row in cross_terms for x in row])
        s = pt.challenge_nonzero_fr(b"s-random-fiatshamir")
        t = pt.challenge_nonzero_fr(b"t-random-fiatshamir")
        s2, s3 = s * s % R, s * s * s % R
        t2, t3 = t * t % R, t * t * t % R

        # L_i = A_i + s*S_i + s^2*D_i + s^3*C_i; R_i = B_i + t*H_i + t^2*d0 + t^3*d1
        left = [
            ch.pt_add(
                ch.pt_add(a, ch.pt_mul(si, s)),
                ch.pt_add(ch.pt_mul(d, s2), ch.pt_mul(c, s3)),
            )
            for a, si, d, c in zip(a_vals, prepared_input, d_vals, c_vals)
        ]
        right = [
            ch.pt_add(
                ch.pt_add(b, ch.pt_mul(h, t)),
                ch.pt_add(ch.pt_mul(d0, t2), ch.pt_mul(d1, t3)),
            )
            for b, h, d0, d1 in zip(b_vals, self.h, self.delta0, self.delta1)
        ]

        com_lr = (
            com_ab
            + com_prepared_input * s
            + com_d * s2
            + com_c * s3
            + self.com_h * t
            + self.com_delta0 * t2
            + self.com_delta1 * t3
        )
        z_lr = _twisted_inner_product(left, right, twist)

        instance = GipaInstance(size=n, output=z_lr, commitment=com_lr, twist=twist)
        witness = GipaWitness(left=left, right=right)
        tipa_proof = tipa_prove(self.tipa_pk, instance, witness)
        return AggProof(com_ab, com_c, cross_terms, tipa_proof)

    def verify_aggregate(
        self, pt: Transcript, super_com: IppCom, agg_proof: AggProof, pub_inputs: list
    ) -> bool:
        n = self.tipa_pk.supported_size
        com_ab, com_c = agg_proof.com_ab, agg_proof.com_c
        com_d = super_com
        cross = agg_proof.cross_terms
        # structural validation of untrusted proof material: exactly a 4x4
        # grid of Fq12 elements, or the indexing below would raise instead
        # of returning False
        if len(cross) != 4 or any(
            len(row) != 4 or any(not isinstance(x, Fq12) for x in row) for row in cross
        ):
            return False

        pt.append_serializable(b"AB-commitment", [com_ab.t, com_ab.u])
        pt.append_serializable(b"C-commitment", [com_c.t, com_c.u])
        pt.append_serializable(b"D-commitment", [com_d.t, com_d.u])
        twist = pt.challenge_nonzero_fr(b"r-random-fiatshamir")

        # Check the twisted Groth16 relation on the cross-term diagonal
        # (the per-proof relation summed with twist powers):
        #   z_ab = e(alpha_r, beta) * z_sh * z_ddelta0 * z_cdelta1
        twist_powers = structured_scalar_power(n, twist)
        alpha_r = scalar_pairing(self.alpha, twist_powers)
        alpha_beta = multi_pairing(alpha_r, self.beta)
        if cross[0][0] != alpha_beta * cross[1][1] * cross[2][2] * cross[3][3]:
            return False

        pt.append_serializable(b"cross-terms", [x for row in cross for x in row])
        s = pt.challenge_nonzero_fr(b"s-random-fiatshamir")
        t = pt.challenge_nonzero_fr(b"t-random-fiatshamir")
        s_pows = [1, s, s * s % R, s * s * s % R]
        t_pows = [1, t, t * t % R, t * t * t % R]

        com_prepared_input = self._com_prepared_input(pub_inputs)
        com_lr = (
            com_ab
            + com_prepared_input * s_pows[1]
            + com_d * s_pows[2]
            + com_c * s_pows[3]
            + self.com_h * t_pows[1]
            + self.com_delta0 * t_pows[2]
            + self.com_delta1 * t_pows[3]
        )
        # z_lr = prod_{u,v} cross[u][v]^{s^u t^v}
        z_lr = Fq12.one()
        for u in range(4):
            for v in range(4):
                z_lr = z_lr * cross[u][v].pow(s_pows[u] * t_pows[v] % R)

        instance = GipaInstance(size=n, output=z_lr, commitment=com_lr, twist=twist)
        return tipa_verify(self.tipa_pk.vk(), instance, agg_proof.tipa_proof)


def _twisted_inner_product(left: list, right: list, twist: int) -> Fq12:
    """prod_i e(L_i, R_i)^{twist^i} (PairingInnerProduct::twisted_inner_product)."""
    n = len(left)
    tp = structured_scalar_power(n, twist)
    twisted_left = [ch.pt_mul(l, t) for l, t in zip(left, tp)]
    return multi_pairing(twisted_left, right)


def agg_subcircuit_proofs(agg_pk: AggProvingKey, pt, super_com, proofs, pub_inputs):
    """Free-function form used by FinalAggState (coordinator.rs:392-417)."""
    return agg_pk.agg_subcircuit_proofs(pt, super_com, proofs, pub_inputs)
