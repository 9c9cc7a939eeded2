"""The plain reference: BN254 G1 and G2 arithmetic on Python ints.

Written from the curve's public parameters (EIP-196 / EIP-197) and imports
nothing of the program. It makes the benchmark's points (`g1_chain`,
`g2_chain`), works out the point each MSM call should return, and reads the
program's outputs, whose limbs it decodes itself (`from_mont_limbs`).

Field elements of Fq are ints in [0, P); those of Fq2 = Fq[u]/(u^2 + 1) are
pairs (c0, c1) = c0 + c1 u. A point is an affine pair or None, the point at
infinity.
"""
from __future__ import annotations

import numpy as np

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
MONT_R = 1 << 256  # the program's Montgomery radix: 16 limbs of 16 bits
MONT_R_INV = pow(MONT_R, -1, P)

G1_GEN = (1, 2)
G1_B = 3
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


class Fq:
    """Fq on ints."""

    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)


class Fq2:
    """Fq2 = Fq[u]/(u^2 + 1) on pairs of ints."""

    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)

    @staticmethod
    def inv(a):
        n = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
        return (a[0] * n % P, -a[1] * n % P)


class Curve:
    """y^2 = x^3 + b over the field F; `gen` generates its order-R group."""

    def __init__(self, name: str, F, b, gen):
        self.name, self.F, self.b, self.gen = name, F, b, gen

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        F = self.F
        x, y = pt
        return F.mul(y, y) == F.add(F.mul(F.mul(x, x), x), self.b)

    def add(self, p, q):
        """Affine p + q (one inversion)."""
        F = self.F
        if p is None:
            return q
        if q is None:
            return p
        if p[0] == q[0]:
            if F.add(p[1], q[1]) == F.zero:
                return None
            lam = F.mul(F.mul(F.mul(p[0], p[0]), (3, 0) if F is Fq2 else 3), F.inv(F.add(p[1], p[1])))
        else:
            lam = F.mul(F.sub(q[1], p[1]), F.inv(F.sub(q[0], p[0])))
        x3 = F.sub(F.sub(F.mul(lam, lam), p[0]), q[0])
        return (x3, F.sub(F.mul(lam, F.sub(p[0], x3)), p[1]))

    def _jdbl(self, j):
        F = self.F
        x, y, z = j
        if z == F.zero:
            return j
        a = F.mul(x, x)
        b = F.mul(y, y)
        c = F.mul(b, b)
        d = F.sub(F.mul(F.add(x, b), F.add(x, b)), F.add(a, c))
        d = F.add(d, d)
        e = F.add(F.add(a, a), a)
        x3 = F.sub(F.mul(e, e), F.add(d, d))
        c8 = F.add(c, c)
        c8 = F.add(c8, c8)
        c8 = F.add(c8, c8)
        y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
        z3 = F.mul(y, z)
        return (x3, y3, F.add(z3, z3))

    def _jadd_affine(self, j, q):
        """Jacobian j + affine q."""
        F = self.F
        x1, y1, z1 = j
        if z1 == F.zero:
            return (q[0], q[1], F.one)
        z1z1 = F.mul(z1, z1)
        u2 = F.mul(q[0], z1z1)
        s2 = F.mul(F.mul(q[1], z1), z1z1)
        h = F.sub(u2, x1)
        rr = F.sub(s2, y1)
        if h == F.zero:
            return self._jdbl(j) if rr == F.zero else (F.one, F.one, F.zero)
        hh = F.mul(h, h)
        hhh = F.mul(h, hh)
        v = F.mul(x1, hh)
        x3 = F.sub(F.sub(F.mul(rr, rr), hhh), F.add(v, v))
        y3 = F.sub(F.mul(rr, F.sub(v, x3)), F.mul(y1, hhh))
        return (x3, y3, F.mul(z1, h))

    def to_affine(self, j):
        F = self.F
        if j[2] == F.zero:
            return None
        zi = F.inv(j[2])
        zi2 = F.mul(zi, zi)
        return (F.mul(j[0], zi2), F.mul(F.mul(j[1], zi2), zi))

    def mul(self, pt, k: int):
        """k * pt by double-and-add in Jacobian coordinates."""
        k %= R
        if pt is None or k == 0:
            return None
        acc = (self.F.one, self.F.one, self.F.zero)
        for bit in bin(k)[2:]:
            acc = self._jdbl(acc)
            if bit == "1":
                acc = self._jadd_affine(acc, pt)
        return self.to_affine(acc)

    def jacobian_equals(self, j, pt) -> bool:
        """Whether the Jacobian (X, Y, Z) is the affine point pt (None =
        infinity): X = x Z^2 and Y = y Z^3, Z != 0; or Z = 0 for infinity."""
        F = self.F
        x, y, z = j
        if pt is None:
            return z == F.zero
        if z == F.zero:
            return False
        z2 = F.mul(z, z)
        return x == F.mul(pt[0], z2) and y == F.mul(F.mul(pt[1], z2), z)


G1 = Curve("bn254_g1", Fq, G1_B, G1_GEN)
G2 = Curve("bn254_g2", Fq2, Fq2.mul((3, 0), Fq2.inv((9, 1))), G2_GEN)
CURVES = {c.name: c for c in (G1, G2)}


def chain(curve: Curve, n: int, k0: int, delta: int) -> list:
    """The n points (k0 + i delta) G for i < n, by n - 1 affine additions."""
    step = curve.mul(curve.gen, delta)
    out = [curve.mul(curve.gen, k0)]
    for _ in range(n - 1):
        out.append(curve.add(out[-1], step))
    return out


# ---------------------------------------------------------------------------
# Limbs: 16 limbs of 16 bits, least significant first (the program's layout)
# ---------------------------------------------------------------------------


def to_limbs(vals, mont: bool = False) -> np.ndarray:
    """ints -> (n, 16) int64 limbs, x R mod P first where `mont`."""
    vals = [v * MONT_R % P if mont else v for v in vals]
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").astype(np.int64).reshape(len(vals), 16)


def from_limbs(arr) -> list:
    """(..., 16) limbs (each read as an unsigned 16-bit word) -> ints."""
    a = np.ascontiguousarray(np.asarray(arr).reshape(-1, 16).astype(np.int64) & 0xFFFF).astype("<u2")
    raw = a.tobytes()
    return [int.from_bytes(raw[32 * i: 32 * i + 32], "little") for i in range(a.shape[0])]


def from_mont_limbs(arr) -> list:
    """(..., 16) Montgomery limbs of Fq -> ints in [0, P)."""
    return [v * MONT_R_INV % P for v in from_limbs(arr)]


def pack_points(curve: Curve, pts: list) -> tuple:
    """Affine points -> the program's (x, y) Montgomery limb arrays: (n, 16)
    on G1, (n, 2, 16) on G2 (c0 then c1); infinity as zeros."""
    if curve.F is Fq:
        xs = [0 if p is None else p[0] for p in pts]
        ys = [0 if p is None else p[1] for p in pts]
        return to_limbs(xs, mont=True), to_limbs(ys, mont=True)
    coords = []
    for k in (0, 1):
        c = [(0, 0) if p is None else p[k] for p in pts]
        coords.append(np.stack([to_limbs([v[0] for v in c], mont=True),
                                to_limbs([v[1] for v in c], mont=True)], axis=1))
    return coords[0], coords[1]


def unpack_jacobian(curve: Curve, x, y, z):
    """The program's Jacobian output (Montgomery limbs, one point) -> a
    Jacobian triple of field elements."""
    if curve.F is Fq:
        return tuple(from_mont_limbs(t)[0] for t in (x, y, z))
    return tuple(tuple(from_mont_limbs(np.asarray(t).reshape(2, 16))) for t in (x, y, z))
