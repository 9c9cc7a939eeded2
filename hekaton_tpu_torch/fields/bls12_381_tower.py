"""BLS12-381 extension-field tower: Fq2 = Fq[u]/(u^2+1),
Fq6 = Fq2[v]/(v^3 - xi) with xi = 1 + u, Fq12 = Fq6[w]/(w^2 - v).

Host ground truth for the BLS12-381 G2/pairing layer (north-star curve;
the reference lists ark-bls12-381 as a dependency but never exercises it in
the pipeline — SURVEY.md §6). Mirrors the structure of the BN254 tower in
fields/host.py:47-260, parameterized only by the modulus and xi.
"""
from __future__ import annotations

from .bls12_381 import P


def fq_inv(a: int) -> int:
    return pow(a % P, P - 2, P)


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
        d = fq_inv(self.c0 * self.c0 + self.c1 * self.c1)
        return Fq2(self.c0 * d, -self.c1 * d)

    def __truediv__(self, o):
        return self * o.inv()

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2_381({self.c0}, {self.c1})"

    def pow(self, e: int):
        acc, base = Fq2.one(), self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc


XI = Fq2(1, 1)  # v^3 = 1 + u  (M-type sextic twist: b' = b*xi)


def _mul_xi(a: Fq2) -> Fq2:
    return Fq2(a.c0 - a.c1, a.c0 + a.c1)


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
        return Fq6(_mul_xi(self.c2), self.c0, self.c1)

    def square(self):
        return self * self

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - _mul_xi(a1 * a2)
        t1 = _mul_xi(a2.square()) - a0 * a1
        t2 = a1.square() - a0 * a2
        d = (a0 * t0 + _mul_xi(a2 * t1) + _mul_xi(a1 * t2)).inv()
        return Fq6(t0 * d, t1 * d, t2 * d)

    def __eq__(self, o):
        return isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __repr__(self):
        return f"Fq6_381({self.c0}, {self.c1}, {self.c2})"


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
        return Fq12(self.c0, -self.c1)

    def inv(self):
        d = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()).inv()
        return Fq12(self.c0 * d, -(self.c1 * d))

    def __truediv__(self, o):
        return self * o.inv()

    def __eq__(self, o):
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __repr__(self):
        return f"Fq12_381({self.c0}, {self.c1})"

    def pow(self, e: int):
        acc, base = Fq12.one(), self
        while e:
            if e & 1:
                acc = acc * base
            base = base.square()
            e >>= 1
        return acc
