"""Host-side BN254 optimal-ate pairing.

Pairings are tiny and latency-bound (the reference performs them inside
verification and TIPA aggregation only — cp-groth16/src/verifier.rs:38,
distributed-prover/src/aggregation.rs:255-263), so they stay on
host, exactly as SURVEY.md §7 prescribes. The implementation works in full
Fq12 affine coordinates after untwisting (x', y') -> (x' w^2, y' w^3), with
denominator elimination (vertical lines lie in Fq6 and die in the final
exponentiation).
"""
from __future__ import annotations

from ..fields.bn254 import ATE_LOOP_COUNT, P, R
from ..fields.host import Fq2, Fq6, Fq12, FROB_V, FROB_W

# Untwist embeds G2 into E(Fq12): basis elements w^2 = v, w^3 = v*w.


def _embed_g2(pt):
    x, y = pt
    xe = Fq12(Fq6(Fq2.zero(), x, Fq2.zero()), Fq6.zero())  # x * v
    ye = Fq12(Fq6.zero(), Fq6(Fq2.zero(), y, Fq2.zero()))  # y * v*w
    return (xe, ye)


def _embed_g1(pt):
    x, y = pt
    return (Fq12.from_fq(x), Fq12.from_fq(y))


def _line(a, b, p):
    """Value of the line through Fq12-points a, b evaluated at p.

    Returns an Fq12 element; vertical lines return (xp - xa) which lies in a
    proper subfield and vanishes under final exponentiation.
    """
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


def _g2_frobenius(pt):
    """p-power Frobenius on a (twisted-coordinates) G2 point."""
    x, y = pt
    return (x.conj() * FROB_V, y.conj() * FROB_V * FROB_W)


def miller_loop(p_g1, q_g2) -> Fq12:
    """f_{6x+2,Q}(P) * l_{T,piQ}(P) * l_{T+piQ,-pi2Q}(P) — no final exp."""
    if p_g1 is None or q_g2 is None:
        return Fq12.one()
    pe = _embed_g1(p_g1)
    qe = _embed_g2(q_g2)
    t = qe
    f = Fq12.one()
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip leading 1
    for bit in bits:
        f = f.square() * _line(t, t, pe)
        t = _add_e(t, t)
        if bit == "1":
            f = f * _line(t, qe, pe)
            t = _add_e(t, qe)
    q1 = _embed_g2(_g2_frobenius(q_g2))
    q2 = _embed_g2(_g2_frobenius(_g2_frobenius(q_g2)))
    nq2 = (q2[0], -q2[1])
    f = f * _line(t, q1, pe)
    t = _add_e(t, q1)
    f = f * _line(t, nq2, pe)
    return f


_HARD_EXP = (P**4 - P**2 + 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    # easy part: f^((p^6-1)(p^2+1))
    f = f.conj() * f.inv()
    f = f.frobenius().frobenius() * f
    # hard part: f^((p^4 - p^2 + 1)/r)
    return f.pow(_HARD_EXP)


def pairing(p_g1, q_g2) -> Fq12:
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing(g1s, g2s) -> Fq12:
    """prod_i e(P_i, Q_i) with one shared final exponentiation.

    Mirrors E::multi_miller_loop usage at
    cp-groth16/src/verifier.rs:38 and
    distributed-prover/src/pairing_ops.rs:9-29.
    """
    assert len(g1s) == len(g2s)
    f = Fq12.one()
    for p, q in zip(g1s, g2s):
        f = f * miller_loop(p, q)
    return final_exponentiation(f)


GT_ONE = Fq12.one()


# ---------------------------------------------------------------------------
# Native acceleration (see curves/host.py note). Also routes Fq12.pow through
# the native tower, which dominates TIPA fold/verify cost.
# ---------------------------------------------------------------------------
try:  # pragma: no cover - exercised via tests/test_native.py
    from ..native import available as _native_available

    if _native_available():
        from ..native import accel as _accel

        pairing = _accel.pairing
        multi_pairing = _accel.multi_pairing

        from ..fields.bn254 import R as _R_ORDER

        _fq12_pow_py = Fq12.pow

        def _fq12_pow_native(self, e: int):
            # gt_pow takes a 32-byte exponent; only valid for 0 <= e < R.
            # (final_exponentiation's hard exponent is ~1020 bits: Python path.)
            if 0 <= e < _R_ORDER:
                return _accel.gt_pow(self, e)
            return _fq12_pow_py(self, e)

        Fq12.pow = _fq12_pow_native
except Exception:  # noqa: BLE001
    pass
