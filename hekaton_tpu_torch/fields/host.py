"""Host-side (CPU, Python-int) BN254 field tower: Fq, Fq2, Fq6, Fq12, Fr.

This is the ground-truth arithmetic layer: it generates test vectors for the
TPU limb kernels, runs the (tiny, latency-bound) pairing computations that the
reference delegates to arkworks (`ark-bn254`), and backs host-side protocol
logic (Fiat–Shamir, coordinator bookkeeping).

Tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - XI), Fq12 = Fq6[w]/(w^2 - v),
with XI = 9 + u (the standard BN254 sextic twist residue).
"""
from __future__ import annotations

from .bn254 import P, R

# ---------------------------------------------------------------------------
# Scalar helpers (plain ints mod P / mod R)
# ---------------------------------------------------------------------------


def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fr_inv(a: int) -> int:
    return pow(a, R - 2, R)


def fr_batch_inv(xs):
    """Montgomery's batch-inversion trick: one modexp for the whole list."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R
    inv = fr_inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * xs[i] % R
    return out


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------


class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero():
        return Fq2(0, 0)

    @staticmethod
    def one():
        return Fq2(1, 0)

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        return Fq2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    __rmul__ = __mul__

    def square(self):
        a0, a1 = self.c0, self.c1
        return Fq2(a0 * a0 - a1 * a1, 2 * a0 * a1)

    def conj(self):
        return Fq2(self.c0, -self.c1)

    def inv(self):
        d = fq_inv((self.c0 * self.c0 + self.c1 * self.c1) % P)
        return Fq2(self.c0 * d, -self.c1 * d)

    def __truediv__(self, o):
        return self * o.inv()

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"

    def pow(self, e: int):
        acc, base = Fq2.one(), self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc


XI = Fq2(9, 1)  # v^3 = 9 + u

# Frobenius constants: v^p = FROB_V * v, w^p = FROB_W * w
FROB_V = XI.pow((P - 1) // 3)
FROB_W = XI.pow((P - 1) // 6)


def _mul_xi(a: Fq2) -> Fq2:
    return Fq2(9 * a.c0 - a.c1, 9 * a.c1 + a.c0)


# ---------------------------------------------------------------------------
# Fq6
# ---------------------------------------------------------------------------


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one():
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + _mul_xi((a1 + a2) * (b1 + b2) - t1 - t2)
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + _mul_xi(t2)
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_fq2(self, k: Fq2):
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self):
        # (c0 + c1 v + c2 v^2) * v = XI*c2 + c0 v + c1 v^2
        return Fq6(_mul_xi(self.c2), self.c0, self.c1)

    def square(self):
        return self * self

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - _mul_xi(a1 * a2)
        t1 = _mul_xi(a2.square()) - a0 * a1
        t2 = a1.square() - a0 * a2
        d = (a0 * t0 + _mul_xi(a1 * t2) + _mul_xi(a2 * t1)).inv()
        return Fq6(t0 * d, t1 * d, t2 * d)

    def __eq__(self, o):
        return (
            isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2
        )

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))


# ---------------------------------------------------------------------------
# Fq12
# ---------------------------------------------------------------------------


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def zero():
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    @staticmethod
    def from_fq(x: int):
        return Fq12(Fq6(Fq2(x), Fq2.zero(), Fq2.zero()), Fq6.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self):
        return self * self

    def conj(self):
        """The p^6-power Frobenius: w -> -w."""
        return Fq12(self.c0, -self.c1)

    def inv(self):
        d = (self.c0.square() - self.c1.square().mul_by_v()).inv()
        return Fq12(self.c0 * d, -(self.c1 * d))

    def __truediv__(self, o):
        return self * o.inv()

    def __eq__(self, o):
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def pow(self, e: int):
        acc, base = Fq12.one(), self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc

    def frobenius(self):
        """The p-power Frobenius endomorphism."""

        def f6(x: Fq6, w_shift: int) -> Fq6:
            # phi(c v^i w^j) = conj(c) FROB_V^i FROB_W^j v^i w^j
            ks = [FROB_V.pow(i) * FROB_W.pow(w_shift) for i in range(3)]
            return Fq6(x.c0.conj() * ks[0], x.c1.conj() * ks[1], x.c2.conj() * ks[2])

        return Fq12(f6(self.c0, 0), f6(self.c1, 1))

    def to_coeffs(self):
        """12 Fq ints: (c0.c0.c0, c0.c0.c1, c0.c1.c0, ..., c1.c2.c1)."""
        out = []
        for six in (self.c0, self.c1):
            for two in (six.c0, six.c1, six.c2):
                out.extend((two.c0, two.c1))
        return out

    @staticmethod
    def from_coeffs(cs):
        assert len(cs) == 12
        sixes = []
        for half in range(2):
            twos = [Fq2(cs[half * 6 + 2 * i], cs[half * 6 + 2 * i + 1]) for i in range(3)]
            sixes.append(Fq6(*twos))
        return Fq12(sixes[0], sixes[1])
