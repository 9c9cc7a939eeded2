"""TIPA: trusted-setup inner-pairing-product argument (GIPA + KZG final keys).

Plays the role of `ark_ip_proofs::tipa::TIPA` in the reference
(distributed-prover/src/aggregation.rs:328-341, which proves a
single *twisted* inner-pairing-product instance produced by the SnarkPack-style
proof aggregation). The construction is the standard one from "Proofs for Inner
Pairing Products and Applications" (ripp) / SnarkPack:

 - instance: size n, Z = prod_i e(L_i, R_i)^{r^i}, a doubled pair-group
   commitment (T, U) to (L, R) under the structured key (v1, v2, w1, w2),
   and the twist r.
 - the twist is removed up-front by rescaling R_i <- r^i * R_i and
   w_i <- r^{-i} * w_i, which leaves the commitment unchanged and turns Z
   into a plain inner product.
 - log n GIPA halving rounds, each publishing cross commitments
   (com_L, com_R) and cross inner products (z_L, z_R); Fiat-Shamir challenge
   x folds: L' = L_lo + x*L_hi, R' = R_lo + x^{-1}*R_hi,
   v' = v_lo + x^{-1}*v_hi, w' = w_lo + x*w_hi,
   T' = T * T_L^x * T_R^{1/x}, Z' = Z * z_L^x * z_R^{1/x}.
 - final folded keys are commitments (in the exponent) to the structured
   polynomials f_v(X) = prod_k (1 + x_k^{-1} X^{2^{l-k}}) and
   f_w(X) = X^n * prod_k (1 + x_k (X/r)^{2^{l-k}}); the prover ships them with
   KZG opening proofs at a transcript-derived point z, so the verifier runs in
   O(log n) field work + O(1) pairings instead of refolding O(n) keys.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..curves import host as ch
from ..fields.bn254 import R
from ..fields.host import Fq12, fr_inv
from ..pairing.host import multi_pairing, pairing
from ..utils.fiat_shamir import Transcript
from ..utils.rng import Rng
from .ipp import IppCom, IppCommitmentKey, ipp_setup


@dataclass
class TipaVerifierKey:
    supported_size: int
    g: tuple  # G1 base of the w vectors
    h: tuple  # G2 base of the v vectors
    g_a: tuple  # g^a (G1)
    g_b: tuple  # g^b (G1)
    h_a: tuple  # h^a (G2)
    h_b: tuple  # h^b (G2)


class TipaProverKey:
    """IPP commitment key + the KZG SRS needed to open the folded keys.

    v1_i = h^{a^i}, v2_i = h^{b^i} (i < n); w1_i = g^{a^{n+i}}, w2_i = g^{b^{n+i}}.
    The SRS is the full power ladder: h^{a^i}, h^{b^i} (i < n) for the v-polys
    and g^{a^i}, g^{b^i} (i < 2n) for the w-polys.
    """

    def __init__(self, ck: IppCommitmentKey, g_a_powers, g_b_powers, h_a_powers, h_b_powers):
        self.ck = ck
        self.supported_size = len(ck.v1)
        self.g_a_powers = g_a_powers  # [G1] len 2n
        self.g_b_powers = g_b_powers  # [G1] len 2n
        self.h_a_powers = h_a_powers  # [G2] len n
        self.h_b_powers = h_b_powers  # [G2] len n

    def vk(self) -> TipaVerifierKey:
        return TipaVerifierKey(
            self.supported_size,
            self.ck.g,
            self.ck.h,
            self.g_a_powers[1],
            self.g_b_powers[1],
            self.h_a_powers[1],
            self.h_b_powers[1],
        )


def tipa_setup(n: int, rng: Rng) -> TipaProverKey:
    """Mirror of TIPA::setup (invoked at mpi-snark/src/coordinator.rs:91-93)."""
    assert n & (n - 1) == 0, "TIPA instance size must be a power of two"
    return tipa_key_from_ipp(ipp_setup(n, rng))


def tipa_key_from_ipp(ck: IppCommitmentKey) -> TipaProverKey:
    """Extend an existing IPP commitment key (the one that produced the
    super-commitment) into a full TIPA prover key by deriving the KZG SRS
    power ladders from the retained trapdoor."""
    n = len(ck.v1)
    a, b = ck._a, ck._b
    g_a = [ch.pt_mul(ck.g, pow(a, i, R)) for i in range(2 * n)]
    g_b = [ch.pt_mul(ck.g, pow(b, i, R)) for i in range(2 * n)]
    h_a = [ch.pt_mul(ck.h, pow(a, i, R)) for i in range(max(n, 2))]
    h_b = [ch.pt_mul(ck.h, pow(b, i, R)) for i in range(max(n, 2))]
    return TipaProverKey(ck, g_a, g_b, h_a, h_b)


@dataclass
class GipaInstance:
    size: int
    output: Fq12  # Z = prod e(L_i, R_i)^{twist^i}
    commitment: IppCom
    twist: int


@dataclass
class GipaWitness:
    left: list  # [G1]
    right: list  # [G2]


@dataclass
class KzgOpening:
    value: tuple  # the final folded key element (group point)
    proof: tuple  # KZG witness point, same group as `value`


@dataclass
class TipaProof:
    cross_coms: list  # [(IppCom, IppCom)] per round: (com_L, com_R)
    cross_zs: list  # [(Fq12, Fq12)] per round: (z_L, z_R)
    final_a: tuple  # G1
    final_b: tuple  # G2 (of the twist-rescaled right vector)
    v1_opening: KzgOpening  # G2 elements
    v2_opening: KzgOpening
    w1_opening: KzgOpening  # G1 elements
    w2_opening: KzgOpening


def _structured_scalar_powers(s: int, n: int) -> list:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * s % R
    return out


def _fold_points(lo, hi, x):
    return [ch.pt_add(l, ch.pt_mul(h, x)) for l, h in zip(lo, hi)]


def _commit_cross(v1, v2, w1, w2, a_vec, b_vec):
    """(T, U) = (prod e(a_i, v1_i) prod e(w1_i, b_i), same with v2/w2)."""
    t = multi_pairing(a_vec + w1, v1 + b_vec)
    u = multi_pairing(a_vec + w2, v2 + b_vec)
    return IppCom(t, u)


def _append_instance(pt: Transcript, instance: GipaInstance):
    pt.append_serializable(b"gipa-com-t", instance.commitment.t)
    pt.append_serializable(b"gipa-com-u", instance.commitment.u)
    pt.append_serializable(b"gipa-output", instance.output)
    pt.append_serializable(b"gipa-twist", instance.twist)


def _challenge_poly_coeffs(challenges: list, n: int, use_inverse: bool) -> list:
    """Coefficients of prod_{k=1}^{l} (1 + c_k X^{2^{l-k}}) where c_k is
    x_k^{-1} (v keys) or x_k (w keys)."""
    coeffs = [1]
    ell = len(challenges)
    for k, x in enumerate(challenges):
        c = fr_inv(x) if use_inverse else x
        step = 1 << (ell - 1 - k)
        new = [0] * (len(coeffs) + step)
        for i, co in enumerate(coeffs):
            new[i] = (new[i] + co) % R
            new[i + step] = (new[i + step] + co * c) % R
        coeffs = new
    assert len(coeffs) == n
    return coeffs


def _kzg_open(coeffs: list, z: int, srs: list) -> tuple:
    """Witness point for f at z over base-power SRS: commit((f(X)-f(z))/(X-z))."""
    n = len(coeffs)
    q = [0] * (n - 1)
    rem = 0
    for i in range(n - 1, -1, -1):
        cur = (coeffs[i] + rem * z) % R
        if i > 0:
            q[i - 1] = cur
            rem = cur
    proof = None
    for i, c in enumerate(q):
        if c:
            proof = ch.pt_add(proof, ch.pt_mul(srs[i], c))
    return proof


def _kzg_verify_v(vk: TipaVerifierKey, g_power_g1, opening: KzgOpening, z: int, fz: int) -> bool:
    # v-polys: commitment/opening live in G2 over base h; pair against G1 SRS.
    lhs = pairing(ch.pt_sub(g_power_g1, ch.pt_mul(vk.g, z)), opening.proof)
    rhs = pairing(vk.g, ch.pt_sub(opening.value, ch.pt_mul(vk.h, fz)))
    return lhs == rhs


def _kzg_verify_w(vk: TipaVerifierKey, h_power_g2, opening: KzgOpening, z: int, fz: int) -> bool:
    # w-polys: commitment/opening live in G1 over base g; pair against G2 SRS.
    lhs = pairing(opening.proof, ch.pt_sub(h_power_g2, ch.pt_mul(vk.h, z)))
    rhs = pairing(ch.pt_sub(opening.value, ch.pt_mul(vk.g, fz)), vk.h)
    return lhs == rhs


def tipa_prove(pk: TipaProverKey, instance: GipaInstance, witness: GipaWitness) -> TipaProof:
    n = instance.size
    assert n == len(witness.left) == len(witness.right)
    assert n & (n - 1) == 0
    r = instance.twist % R

    # Remove the twist: R_i <- r^i R_i, w_i <- r^{-i} w_i (commitment invariant).
    r_pows = _structured_scalar_powers(r, n)
    rinv_pows = _structured_scalar_powers(fr_inv(r), n)
    a_vec = list(witness.left)
    b_vec = [ch.pt_mul(bi, ri) for bi, ri in zip(witness.right, r_pows)]
    v1, v2 = list(pk.ck.v1), list(pk.ck.v2)
    w1 = [ch.pt_mul(wi, ri) for wi, ri in zip(pk.ck.w1, rinv_pows)]
    w2 = [ch.pt_mul(wi, ri) for wi, ri in zip(pk.ck.w2, rinv_pows)]

    pt = Transcript(b"tipa")
    _append_instance(pt, instance)

    cross_coms, cross_zs, challenges = [], [], []
    m = n
    while m > 1:
        h = m // 2
        a_lo, a_hi = a_vec[:h], a_vec[h:]
        b_lo, b_hi = b_vec[:h], b_vec[h:]
        com_l = _commit_cross(v1[:h], v2[:h], w1[h:], w2[h:], a_hi, b_lo)
        com_r = _commit_cross(v1[h:], v2[h:], w1[:h], w2[:h], a_lo, b_hi)
        z_l = multi_pairing(a_hi, b_lo)
        z_r = multi_pairing(a_lo, b_hi)
        cross_coms.append((com_l, com_r))
        cross_zs.append((z_l, z_r))

        pt.append_serializable(b"com-l", [com_l.t, com_l.u])
        pt.append_serializable(b"com-r", [com_r.t, com_r.u])
        pt.append_serializable(b"z-l", z_l)
        pt.append_serializable(b"z-r", z_r)
        x = pt.challenge_nonzero_fr(b"gipa-x")
        challenges.append(x)
        xi = fr_inv(x)

        a_vec = _fold_points(a_lo, a_hi, x)
        b_vec = _fold_points(b_lo, b_hi, xi)
        v1 = _fold_points(v1[:h], v1[h:], xi)
        v2 = _fold_points(v2[:h], v2[h:], xi)
        w1 = _fold_points(w1[:h], w1[h:], x)
        w2 = _fold_points(w2[:h], w2[h:], x)
        m = h

    final_a, final_b = a_vec[0], b_vec[0]
    final_v1, final_v2, final_w1, final_w2 = v1[0], v2[0], w1[0], w2[0]

    # KZG openings of the folded keys at a transcript point z.
    pt.append_serializable(b"final-v1", final_v1)
    pt.append_serializable(b"final-v2", final_v2)
    pt.append_serializable(b"final-w1", final_w1)
    pt.append_serializable(b"final-w2", final_w2)
    z = pt.challenge_nonzero_fr(b"kzg-z")

    v_coeffs = _challenge_poly_coeffs(challenges, n, use_inverse=True)
    pi_v1 = _kzg_open(v_coeffs, z, pk.h_a_powers)
    pi_v2 = _kzg_open(v_coeffs, z, pk.h_b_powers)

    w_coeffs = _w_poly_coeffs(challenges, n, r)
    pi_w1 = _kzg_open(w_coeffs, z, pk.g_a_powers)
    pi_w2 = _kzg_open(w_coeffs, z, pk.g_b_powers)

    return TipaProof(
        cross_coms,
        cross_zs,
        final_a,
        final_b,
        KzgOpening(final_v1, pi_v1),
        KzgOpening(final_v2, pi_v2),
        KzgOpening(final_w1, pi_w1),
        KzgOpening(final_w2, pi_w2),
    )


def _w_poly_coeffs(challenges: list, n: int, twist: int) -> list:
    """w'_i = g^{a^{n+i} r^{-i}}: as a polynomial in a the folded key is
    X^n * prod_k (1 + x_k (X/r)^{2^{l-k}}), degree 2n-1."""
    rinv = fr_inv(twist % R)
    coeffs = [1]
    ell = len(challenges)
    for k, x in enumerate(challenges):
        step = 1 << (ell - 1 - k)
        c = x * pow(rinv, step, R) % R
        new = [0] * (len(coeffs) + step)
        for i, co in enumerate(coeffs):
            new[i] = (new[i] + co) % R
            new[i + step] = (new[i + step] + co * c) % R
        coeffs = new
    return [0] * n + coeffs


def _eval_v_poly(challenges: list, z: int) -> int:
    acc = 1
    ell = len(challenges)
    for k, x in enumerate(challenges):
        acc = acc * (1 + fr_inv(x) * pow(z, 1 << (ell - 1 - k), R)) % R
    return acc


def _eval_w_poly(challenges: list, n: int, twist: int, z: int) -> int:
    rinv = fr_inv(twist % R)
    acc = pow(z, n, R)
    ell = len(challenges)
    for k, x in enumerate(challenges):
        step = 1 << (ell - 1 - k)
        acc = acc * (1 + x * pow(rinv * z % R, step, R)) % R
    return acc


def tipa_verify(vk: TipaVerifierKey, instance: GipaInstance, proof: TipaProof) -> bool:
    n = instance.size
    if n & (n - 1) or n < 1 or (n.bit_length() - 1) != len(proof.cross_coms):
        return False
    # a malformed proof with fewer cross_zs must not silently shorten the
    # GIPA folding recursion below
    if len(proof.cross_zs) != len(proof.cross_coms):
        return False

    pt = Transcript(b"tipa")
    _append_instance(pt, instance)

    # Refold commitment and output from the published cross terms.
    t_acc, u_acc, z_acc = instance.commitment.t, instance.commitment.u, instance.output
    challenges = []
    for (com_l, com_r), (z_l, z_r) in zip(proof.cross_coms, proof.cross_zs):
        pt.append_serializable(b"com-l", [com_l.t, com_l.u])
        pt.append_serializable(b"com-r", [com_r.t, com_r.u])
        pt.append_serializable(b"z-l", z_l)
        pt.append_serializable(b"z-r", z_r)
        x = pt.challenge_nonzero_fr(b"gipa-x")
        challenges.append(x)
        xi = fr_inv(x)
        t_acc = t_acc * com_l.t.pow(x) * com_r.t.pow(xi)
        u_acc = u_acc * com_l.u.pow(x) * com_r.u.pow(xi)
        z_acc = z_acc * z_l.pow(x) * z_r.pow(xi)

    pt.append_serializable(b"final-v1", proof.v1_opening.value)
    pt.append_serializable(b"final-v2", proof.v2_opening.value)
    pt.append_serializable(b"final-w1", proof.w1_opening.value)
    pt.append_serializable(b"final-w2", proof.w2_opening.value)
    z = pt.challenge_nonzero_fr(b"kzg-z")

    fv = _eval_v_poly(challenges, z)
    fw = _eval_w_poly(challenges, n, instance.twist, z)
    if not _kzg_verify_v(vk, vk.g_a, proof.v1_opening, z, fv):
        return False
    if not _kzg_verify_v(vk, vk.g_b, proof.v2_opening, z, fv):
        return False
    if not _kzg_verify_w(vk, vk.h_a, proof.w1_opening, z, fw):
        return False
    if not _kzg_verify_w(vk, vk.h_b, proof.w2_opening, z, fw):
        return False

    a, b = proof.final_a, proof.final_b
    if z_acc != pairing(a, b):
        return False
    if t_acc != pairing(a, proof.v1_opening.value) * pairing(proof.w1_opening.value, b):
        return False
    if u_acc != pairing(a, proof.v2_opening.value) * pairing(proof.w2_opening.value, b):
        return False
    return True
