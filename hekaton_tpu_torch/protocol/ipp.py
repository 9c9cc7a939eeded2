"""Inner-pairing-product (TIPP/SnarkPack-style) commitments.

The coordinator commits to all workers' stage-0 commitments with a pair-group
commitment ("super-commitment") whose bytes seed the Fiat-Shamir transcript
challenges (distributed-prover/src/coordinator.rs:336-339,
rom_transcript.rs:42-75; the reference uses ark-ip-proofs' TIPPCommitment).

Structure (SnarkPack): toxic a, b; v1_i = h^{a^i}, v2_i = h^{b^i} in G2 commit
G1 vectors; w1_i = g^{a^{n+i}}, w2_i = g^{b^{n+i}} in G1 commit G2 vectors.
com(A, B) = (prod e(A_i,v1_i) prod e(w1_i,B_i), prod e(A_i,v2_i) prod e(w2_i,B_i)).
"""
from __future__ import annotations

from ..curves import host as ch
from ..fields.bn254 import R
from ..fields.host import Fq12
from ..pairing.host import multi_pairing
from ..utils.rng import Rng


class IppCommitmentKey:
    def __init__(self, v1, v2, w1, w2, g, h, a, b):
        self.v1 = v1  # [G2] length n
        self.v2 = v2
        self.w1 = w1  # [G1] length n
        self.w2 = w2
        self.g = g  # G1 generator used
        self.h = h  # G2 generator used
        # Toxic waste retained only for KZG-style opening key generation in
        # the aggregation setup (mirrors TIPA::setup); never shipped to workers.
        self._a = a
        self._b = b

    def half(self) -> "IppCommitmentKey":
        n = len(self.v1) // 2
        return IppCommitmentKey(
            self.v1[:n], self.v2[:n], self.w1[:n], self.w2[:n], self.g, self.h, self._a, self._b
        )

    def __getstate__(self):
        """Never persist or ship the toxic waste: any serialized form of the
        commitment key has the trapdoors stripped. KZG opening-key derivation
        (tipa_key_from_ipp) must happen in the setup process, before the key
        crosses any process/disk boundary."""
        d = dict(self.__dict__)
        d["_a"] = None
        d["_b"] = None
        return d


def ipp_setup(n: int, rng: Rng) -> IppCommitmentKey:
    a = rng.next_nonzero_fr()
    b = rng.next_nonzero_fr()
    g = ch.pt_mul(ch.g1_gen(), rng.next_nonzero_fr())
    h = ch.pt_mul(ch.g2_gen(), rng.next_nonzero_fr())
    v1 = [ch.pt_mul(h, pow(a, i, R)) for i in range(n)]
    v2 = [ch.pt_mul(h, pow(b, i, R)) for i in range(n)]
    w1 = [ch.pt_mul(g, pow(a, n + i, R)) for i in range(n)]
    w2 = [ch.pt_mul(g, pow(b, n + i, R)) for i in range(n)]
    return IppCommitmentKey(v1, v2, w1, w2, g, h, a, b)


class IppCom:
    def __init__(self, t: Fq12, u: Fq12):
        self.t = t
        self.u = u

    @staticmethod
    def identity() -> "IppCom":
        return IppCom(Fq12.one(), Fq12.one())

    def __add__(self, other: "IppCom") -> "IppCom":
        """Group op on commitments (GT is multiplicative; arkworks' Commitment
        `+` is component-wise GT mul, aggregation.rs:170-173,321-323)."""
        return IppCom(self.t * other.t, self.u * other.u)

    def __mul__(self, scalar: int) -> "IppCom":
        """Scalar `exponentiation` of the commitment (Commitment * scalar)."""
        return IppCom(self.t.pow(scalar), self.u.pow(scalar))

    def __eq__(self, other):
        return self.t == other.t and self.u == other.u

    def to_bytes(self) -> bytes:
        out = b""
        for x in (self.t, self.u):
            for c in x.to_coeffs():
                out += c.to_bytes(32, "little")
        return out


def commit_only_left(ck: IppCommitmentKey, g1_vec: list) -> IppCom:
    n = len(g1_vec)
    t = multi_pairing(g1_vec, ck.v1[:n])
    u = multi_pairing(g1_vec, ck.v2[:n])
    return IppCom(t, u)


def commit_only_right(ck: IppCommitmentKey, g2_vec: list) -> IppCom:
    n = len(g2_vec)
    t = multi_pairing(ck.w1[:n], g2_vec)
    u = multi_pairing(ck.w2[:n], g2_vec)
    return IppCom(t, u)


def commit_pair(ck: IppCommitmentKey, g1_vec: list, g2_vec: list) -> IppCom:
    left = commit_only_left(ck, g1_vec)
    right = commit_only_right(ck, g2_vec)
    return IppCom(left.t * right.t, left.u * right.u)
