"""In-circuit unsigned 32-bit integers (bit-vector representation).

Equivalent of distributed-prover/src/uint32.rs: ripple-carry
increment, MSB-first greater-than comparison, equality. Used by the RAM
transcript's timestamps.
"""
from __future__ import annotations

from ..r1cs.gadgets import Boolean, FpVar


class UInt32Var:
    __slots__ = ("bits",)

    def __init__(self, bits: list):
        assert len(bits) == 32
        self.bits = bits  # LSB first

    @property
    def value(self) -> int:
        return sum(b.value << i for i, b in enumerate(self.bits))

    @staticmethod
    def witness(cs, v: int) -> "UInt32Var":
        return UInt32Var([Boolean.witness(cs, (v >> i) & 1) for i in range(32)])

    @staticmethod
    def constant(cs, v: int) -> "UInt32Var":
        return UInt32Var([Boolean.constant(cs, (v >> i) & 1) for i in range(32)])

    def as_fpvar(self) -> FpVar:
        acc = None
        for i, b in enumerate(self.bits):
            term = b.var.scale(1 << i)
            acc = term if acc is None else acc + term
        return acc

    def increment(self) -> "UInt32Var":
        """x + 1 mod 2^32 via ripple carry (uint32.rs:80-89)."""
        carry = Boolean.constant(self.bits[0].var.cs, 1)
        out = []
        for b in self.bits:
            out.append(b ^ carry)
            carry = b & carry
        return UInt32Var(out)

    def is_greater_than(self, other: "UInt32Var") -> Boolean:
        """MSB-first comparison scan (uint32.rs:91-109)."""
        cs = self.bits[0].var.cs
        eq_so_far = Boolean.constant(cs, 1)
        gt = Boolean.constant(cs, 0)
        for i in range(31, -1, -1):
            a, b = self.bits[i], other.bits[i]
            gt = gt | (eq_so_far & a & b.not_())
            eq_so_far = eq_so_far & (a ^ b).not_()
        return gt

    def enforce_equal(self, other: "UInt32Var"):
        self.as_fpvar().enforce_equal(other.as_fpvar())

    def is_eq(self, other: "UInt32Var") -> Boolean:
        return self.as_fpvar().is_eq(other.as_fpvar())
