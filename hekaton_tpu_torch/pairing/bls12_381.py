"""Host-side BLS12-381 ate pairing + G2 group ops.

Completes the north-star curve's tower (the round-1 build shipped
field/G1/MSM only): G2 over Fq2 = Fq[u]/(u^2+1) with b' = 4(1+u) (M-type
sextic twist), and the ate pairing e(P, Q) = f_{|x|,Q}(P)^{(p^12-1)/r}
with the negative-x inversion folded in before the final exponentiation.

Same architecture as the BN254 pairing (pairing/host.py): affine Miller
loop in the full Fq12 embedding — pairings are tiny and latency-bound, so
they stay host-side (SURVEY.md §7); the reference keeps BLS12-381 as an
unused dependency (SURVEY.md §6), so this layer is parity-plus.
"""
from __future__ import annotations

from ..fields.bls12_381 import BLS_X, P, R
from ..fields.bls12_381_tower import XI, Fq2, Fq6, Fq12

# G2: y^2 = x^3 + 4*(1+u) over Fq2 (M-twist of y^2 = x^3 + 4)
B_G2 = Fq2(4, 4)

# Canonical generator (draft-irtf-cfrg-pairing-friendly-curves / zkcrypto).
G2_GEN = (
    Fq2(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    Fq2(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)


def g2_gen():
    return G2_GEN


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y.square() - x.square() * x - B_G2).is_zero()


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1.square() * 3) * (y1 + y1).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.square() - x1 - x2
    return (x3, lam * (x1 - x3) - y1)


def g2_mul(pt, k: int):
    k %= R
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, pt)
        pt = g2_add(pt, pt)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# Ate pairing
# ---------------------------------------------------------------------------

# Untwist E'(Fq2) -> E(Fq12) for the M twist: (x', y') -> (x'/w^2, y'/w^3)
# with w^6 = xi, i.e. x'*v^2/xi and y'*v*w/xi in the tower basis.
_XI_INV = XI.inv()


def _embed_g2(pt):
    x, y = pt
    xe = Fq12(Fq6(Fq2.zero(), Fq2.zero(), x * _XI_INV), Fq6.zero())
    ye = Fq12(Fq6.zero(), Fq6(Fq2.zero(), y * _XI_INV, Fq2.zero()))
    return (xe, ye)


def _embed_g1(pt):
    x, y = pt
    return (Fq12.from_fq(x), Fq12.from_fq(y))


def _line(a, b, p):
    """Line through Fq12-points a, b evaluated at p (vertical lines return a
    subfield element that dies in the final exponentiation)."""
    xa, ya = a
    xb, yb = b
    xp, yp = p
    if xa == xb and ya == yb:
        if ya.is_zero():
            return xp - xa
        lam = (xa.square() * Fq12.from_fq(3)) * (ya + ya).inv()
    elif xa == xb:
        return xp - xa
    else:
        lam = (yb - ya) * (xb - xa).inv()
    return yp - ya - lam * (xp - xa)


def _add_e(a, b):
    if a is None:
        return b
    if b is None:
        return a
    xa, ya = a
    xb, yb = b
    if xa == xb:
        if ya == yb:
            if ya.is_zero():
                return None
            lam = (xa.square() * Fq12.from_fq(3)) * (ya + ya).inv()
        else:
            return None
    else:
        lam = (yb - ya) * (xb - xa).inv()
    x3 = lam.square() - xa - xb
    return (x3, lam * (xa - x3) - ya)


def miller_loop(p, q) -> Fq12:
    """f_{|x|, Q}(P) over the Fq12 embedding (x = BLS_X < 0; the caller
    inverts). P in G1, Q in G2 (affine, not None)."""
    qe = _embed_g2(q)
    pe = _embed_g1(p)
    t = abs(BLS_X)
    bits = bin(t)[3:]  # MSB already consumed by initializing r = Q
    f = Fq12.one()
    r = qe
    for bit in bits:
        f = f.square() * _line(r, r, pe)
        r = _add_e(r, r)
        if bit == "1":
            f = f * _line(r, qe, pe)
            r = _add_e(r, qe)
    return f


FINAL_EXP = (P**12 - 1) // R


def pairing(p, q) -> Fq12:
    """e(P, Q) for P in G1 (int pair), Q in G2 (Fq2 pair); None -> 1."""
    if p is None or q is None:
        return Fq12.one()
    f = miller_loop(p, q)
    f = f.inv()  # ate loop count x is negative
    return f.pow(FINAL_EXP)
