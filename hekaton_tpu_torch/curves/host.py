"""Host-side BN254 G1/G2 affine group operations (Python ints / Fq2).

Ground truth for the TPU Jacobian kernels and the small, latency-bound group
work (generators, verifier-side points, TIPA bookkeeping). G1 points live over
Fq (plain ints), G2 points over Fq2; both are `(x, y)` tuples with `None` as
the point at infinity. Mirrors the role arkworks' `ark-bn254` plays for the
reference (distributed-prover/Cargo.toml:12-19).
"""
from __future__ import annotations

from ..fields.bn254 import B_G1, G1_GEN, G2_GEN_X, G2_GEN_Y, P, R
from ..fields.host import Fq2, fq_inv

# G2 curve coefficient b2 = 3 / (9 + u)
B_G2 = Fq2(3) * Fq2(9, 1).inv()

G2_GEN = (Fq2(*G2_GEN_X), Fq2(*G2_GEN_Y))


def _inv(x):
    return fq_inv(x) if isinstance(x, int) else x.inv()


def _is_zero(x):
    return x % P == 0 if isinstance(x, int) else x.is_zero()


def _norm(x):
    return x % P if isinstance(x, int) else x


def _eq(a, b):
    return _norm(a) == _norm(b) if isinstance(a, int) else a == b


def pt_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P if isinstance(y, int) else -y)


def pt_dbl(pt):
    if pt is None:
        return None
    x, y = pt
    if _is_zero(y):
        return None
    lam = 3 * x * x * _inv(2 * y) if isinstance(x, int) else (x.square() * 3) * (y * 2).inv()
    x3 = lam * lam - 2 * x if isinstance(x, int) else lam.square() - x - x
    y3 = lam * (x - x3) - y
    return (_norm(x3), _norm(y3))


def pt_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if _eq(x1, x2):
        if _eq(y1, y2):
            return pt_dbl(p)
        return None
    lam = (y2 - y1) * _inv(x2 - x1) if isinstance(x1, int) else (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2 if isinstance(x1, int) else lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (_norm(x3), _norm(y3))


def pt_sub(p, q):
    return pt_add(p, pt_neg(q))


def _jac_dbl(p):
    x, y, z = p
    a = _norm(x * x)
    b = _norm(y * y)
    c = _norm(b * b)
    t = x + b
    d = _norm(2 * (_norm(t * t) - a - c))
    e = _norm(3 * a)
    f = _norm(e * e)
    x3 = _norm(f - 2 * d)
    y3 = _norm(e * (d - x3) - 8 * c)
    z3 = _norm(2 * y * z)
    return (x3, y3, z3)


def _jac_add_mixed(p, qa):
    """Jacobian + affine; returns Jacobian. q must not be infinity."""
    x1, y1, z1 = p
    x2, y2 = qa
    z1z1 = _norm(z1 * z1)
    u2 = _norm(x2 * z1z1)
    s2 = _norm(y2 * z1 * z1z1)
    h = _norm(u2 - x1)
    r = _norm(s2 - y1)
    if _is_zero(h):
        if _is_zero(r):
            return _jac_dbl(p)
        return None
    hh = _norm(h * h)
    i = _norm(4 * hh)
    j = _norm(h * i)
    r2 = _norm(2 * r)
    v = _norm(x1 * i)
    x3 = _norm(r2 * r2 - j - 2 * v)
    y3 = _norm(r2 * (v - x3) - 2 * y1 * j)
    z3 = _norm((z1 + h) * (z1 + h) - z1z1 - hh)
    return (x3, y3, z3)


def _jac_to_affine(p):
    if p is None:
        return None
    x, y, z = p
    if _is_zero(z):
        return None
    zi = _inv(z)
    zi2 = _norm(zi * zi)
    return (_norm(x * zi2), _norm(y * zi2 * zi))


def _jac_add(p, q):
    """Full Jacobian + Jacobian addition (None = infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = _norm(z1 * z1)
    z2z2 = _norm(z2 * z2)
    u1 = _norm(x1 * z2z2)
    u2 = _norm(x2 * z1z1)
    s1 = _norm(y1 * z2 * z2z2)
    s2 = _norm(y2 * z1 * z1z1)
    h = _norm(u2 - u1)
    r = _norm(s2 - s1)
    if _is_zero(h):
        if _is_zero(r):
            return _jac_dbl(p)
        return None
    i = _norm(4 * h * h)
    j = _norm(h * i)
    r2 = _norm(2 * r)
    v = _norm(u1 * i)
    x3 = _norm(r2 * r2 - j - 2 * v)
    y3 = _norm(r2 * (v - x3) - 2 * s1 * j)
    zs = z1 + z2
    z3 = _norm((_norm(zs * zs) - z1z1 - z2z2) * h)
    return (x3, y3, z3)


def pt_mul(pt, k: int):
    """Scalar multiplication (Jacobian ladder, one final inversion)."""
    k %= R
    if k == 0 or pt is None:
        return None
    one = 1 if isinstance(pt[0], int) else Fq2.one()
    acc = None
    add = (pt[0], pt[1], one)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        if k > 1:
            add = _jac_dbl(add)
        k >>= 1
    return _jac_to_affine(acc)


def _jac_mul(pt, k: int):
    k %= R
    if k == 0 or pt is None:
        return None
    one = 1 if isinstance(pt[0], int) else Fq2.one()
    acc = None
    add = (pt[0], pt[1], one)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        if k > 1:
            add = _jac_dbl(add)
        k >>= 1
    return acc


def msm_host(points, scalars):
    """Host MSM (Jacobian accumulation) — ground truth for tests/small work."""
    acc = None
    for p, s in zip(points, scalars):
        acc = _jac_add(acc, _jac_mul(p, s))
    return _jac_to_affine(acc)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B_G1) % P == 0


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y.square() - x.square() * x - B_G2).is_zero()


def g1_gen():
    return G1_GEN


def g2_gen():
    return G2_GEN


# ---------------------------------------------------------------------------
# Canonical serialization (framework-internal, arkworks-inspired layout:
# little-endian coordinates, flag bits in the top byte; used for Fiat–Shamir
# hashing and on-disk artifacts).
# ---------------------------------------------------------------------------

INF_FLAG = 1 << 6


def fr_to_bytes(x: int) -> bytes:
    return (x % R).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little") % R


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        out = bytearray(64)
        out[63] |= INF_FLAG
        return bytes(out)
    x, y = pt
    return (x % P).to_bytes(32, "little") + (y % P).to_bytes(32, "little")


def g1_from_bytes(b: bytes):
    if b[63] & INF_FLAG:
        return None
    return (int.from_bytes(b[:32], "little"), int.from_bytes(b[32:], "little") & ((1 << 254) - 1))


def g2_to_bytes(pt) -> bytes:
    if pt is None:
        out = bytearray(128)
        out[127] |= INF_FLAG
        return bytes(out)
    x, y = pt
    return b"".join(c.to_bytes(32, "little") for c in (x.c0, x.c1, y.c0, y.c1))


def g2_from_bytes(b: bytes):
    if b[127] & INF_FLAG:
        return None
    c = [int.from_bytes(b[32 * i : 32 * (i + 1)], "little") for i in range(4)]
    c[3] &= (1 << 254) - 1
    return (Fq2(c[0], c[1]), Fq2(c[2], c[3]))


# ---------------------------------------------------------------------------
# Native acceleration: override the hot group ops with the C++ library when
# available (native/hekaton_native.cpp). The Python definitions above remain
# the ground truth (tests compare both); set HEKATON_NO_NATIVE=1 to disable.
# ---------------------------------------------------------------------------
try:  # pragma: no cover - exercised via tests/test_native.py
    from ..native import available as _native_available

    if _native_available():
        from ..native import accel as _accel

        pt_add = _accel.pt_add
        pt_mul = _accel.pt_mul
        msm_host = _accel.msm_host
except Exception:  # noqa: BLE001 - any native failure falls back to Python
    pass


# ---------------------------------------------------------------------------
# Compressed serialization (arkworks-style: x plus a y-sign flag in the two
# spare MSB bits; p is 254 bits so bits 254/255 of the last byte are free).
# Used for the proof-size accounting the reference prints at the end of
# `work` (mpi-snark/src/bin/node.rs:608-617).
# ---------------------------------------------------------------------------

_COMP_INF = 1 << 6
_COMP_NEG = 1 << 7


def _fq_sqrt(a: int) -> int:
    """Square root in Fq (p = 3 mod 4): a^((p+1)/4); raises if non-residue."""
    r = pow(a % P, (P + 1) // 4, P)
    if r * r % P != a % P:
        raise ValueError("not a quadratic residue")
    return r


def _fq2_sqrt(a: "Fq2") -> "Fq2":
    """Square root in Fq2 = Fq[u]/(u^2+1) via the norm trick."""
    if a.is_zero():
        return Fq2(0, 0)
    if a.c1 == 0:
        try:
            return Fq2(_fq_sqrt(a.c0), 0)
        except ValueError:
            # sqrt(c0) = s*u with s^2 = -c0
            return Fq2(0, _fq_sqrt((-a.c0) % P))
    # norm = c0^2 + c1^2 is a residue for squares; alpha = sqrt(norm)
    alpha = _fq_sqrt((a.c0 * a.c0 + a.c1 * a.c1) % P)
    delta = (a.c0 + alpha) * fq_inv(2) % P
    if pow(delta, (P - 1) // 2, P) != 1:
        delta = (a.c0 - alpha) * fq_inv(2) % P
    x0 = _fq_sqrt(delta)
    x1 = a.c1 * fq_inv(2 * x0 % P) % P
    return Fq2(x0, x1)


def g1_to_bytes_compressed(pt) -> bytes:
    if pt is None:
        out = bytearray(32)
        out[31] |= _COMP_INF
        return bytes(out)
    x, y = pt
    out = bytearray(x.to_bytes(32, "little"))
    if y > P - y:  # lexicographically-largest convention
        out[31] |= _COMP_NEG
    return bytes(out)


def g1_from_bytes_compressed(b: bytes):
    flags = b[31] & 0xC0
    if flags & _COMP_INF:
        return None
    x = int.from_bytes(bytes(b[:31]) + bytes([b[31] & 0x3F]), "little")
    y = _fq_sqrt((x * x % P * x + B_G1) % P)
    if (y > P - y) != bool(flags & _COMP_NEG):
        y = P - y
    return (x, y)


def g2_to_bytes_compressed(pt) -> bytes:
    if pt is None:
        out = bytearray(64)
        out[63] |= _COMP_INF
        return bytes(out)
    x, y = pt
    out = bytearray(x.c0.to_bytes(32, "little") + x.c1.to_bytes(32, "little"))
    # sign convention on (c1, c0) lexicographic order of y
    neg = (y.c1, y.c0) > ((P - y.c1) % P, (P - y.c0) % P)
    if neg:
        out[63] |= _COMP_NEG
    return bytes(out)


def _mul_unreduced(pt, k: int):
    """Double-and-add WITHOUT reducing k mod R (for order checks)."""
    if k == 0 or pt is None:
        return None
    one = 1 if isinstance(pt[0], int) else Fq2.one()
    acc = None
    add = (pt[0], pt[1], one)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        if k > 1:
            add = _jac_dbl(add)
        k >>= 1
    return acc


def g2_in_subgroup(pt) -> bool:
    """Prime-order subgroup membership: R*Q == infinity. BN254's G2 curve
    over Fq2 has a large cofactor, so an on-curve point is NOT necessarily in
    G2 — arkworks' CanonicalDeserialize performs this check and so must any
    boundary that accepts untrusted G2 bytes."""
    return _mul_unreduced(pt, R) is None


def g2_from_bytes_compressed(b: bytes):
    flags = b[63] & 0xC0
    if flags & _COMP_INF:
        return None
    c0 = int.from_bytes(b[:32], "little")
    c1 = int.from_bytes(bytes(b[32:63]) + bytes([b[63] & 0x3F]), "little")
    x = Fq2(c0, c1)
    y = _fq2_sqrt(x * x * x + B_G2)
    neg = (y.c1, y.c0) > ((P - y.c1) % P, (P - y.c0) % P)
    if neg != bool(flags & _COMP_NEG):
        y = Fq2((P - y.c0) % P, (P - y.c1) % P)
    pt = (x, y)
    if not g2_is_on_curve(pt):
        raise ValueError("invalid G2 encoding: x is not on the curve")
    if not g2_in_subgroup(pt):
        raise ValueError("invalid G2 encoding: point not in the prime-order subgroup")
    return pt
