"""Gadget layer: field variables, booleans, and bit arithmetic over the R1CS.

Plays the role of ark-r1cs-std's FpVar/Boolean/UInt8 stack (reference L1 —
SURVEY.md §1). An FpVar carries a symbolic linear combination plus its concrete
value, so constraints are emitted with fully-flattened LCs (no separate
inlining/finalize pass is needed, unlike ark-relations' cs.finalize()).
"""
from __future__ import annotations

from ..fields.bn254 import R
from .builder import ONE, ConstraintSystem


class FpVar:
    __slots__ = ("cs", "lc", "value")

    def __init__(self, cs: ConstraintSystem, lc: dict, value: int):
        self.cs = cs
        self.lc = lc
        self.value = value % R

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def constant(cs: ConstraintSystem, c: int) -> "FpVar":
        return FpVar(cs, {ONE: c % R}, c)

    @staticmethod
    def witness(cs: ConstraintSystem, value: int) -> "FpVar":
        key = cs.new_witness(value)
        # value_only: no linear combinations (allocation order is the
        # contract; matrices come precompiled — r1cs/fastsynth.py)
        return FpVar(cs, None if cs.value_only else {key: 1}, value)

    @staticmethod
    def input(cs: ConstraintSystem, value: int) -> "FpVar":
        key = cs.new_input(value)
        return FpVar(cs, None if cs.value_only else {key: 1}, value)

    def is_constant(self) -> bool:
        # constants keep a {ONE: c} lc even in value_only mode so that the
        # constant-folding branches (and hence witness ALLOCATION ORDER) are
        # identical between modes
        return self.lc is not None and all(k == ONE for k in self.lc)

    # -- linear ops (free) -------------------------------------------------------
    def _combine(self, other, sign: int) -> "FpVar":
        other = self._coerce(other)
        value = (self.value + sign * other.value) % R
        if self.lc is None or other.lc is None:
            return FpVar(self.cs, None, value)
        lc = dict(self.lc)
        for k, c in other.lc.items():
            lc[k] = (lc.get(k, 0) + sign * c) % R
        if self.cs.value_only and not (self.is_constant() and other.is_constant()):
            lc = None
        return FpVar(self.cs, lc, value)

    def _coerce(self, other) -> "FpVar":
        if isinstance(other, FpVar):
            return other
        return FpVar.constant(self.cs, other)

    def __add__(self, other):
        return self._combine(other, 1)

    __radd__ = __add__

    def __sub__(self, other):
        return self._combine(other, -1)

    def __rsub__(self, other):
        return self._coerce(other)._combine(self, -1)

    def __neg__(self):
        if self.lc is None:
            return FpVar(self.cs, None, -self.value)
        return FpVar(self.cs, {k: (-c) % R for k, c in self.lc.items()}, -self.value)

    def scale(self, c: int) -> "FpVar":
        c %= R
        if self.lc is None:
            return FpVar(self.cs, None, self.value * c)
        return FpVar(self.cs, {k: v * c % R for k, v in self.lc.items()}, self.value * c)

    # -- multiplication (1 constraint unless a side is constant) -------------------
    def __mul__(self, other):
        other = self._coerce(other)
        if self.is_constant():
            return other.scale(self.lc.get(ONE, 0))
        if other.is_constant():
            return self.scale(other.lc.get(ONE, 0))
        out = FpVar.witness(self.cs, self.value * other.value % R)
        self.cs.enforce(self.lc, other.lc, out.lc)
        return out

    __rmul__ = __mul__

    def square(self):
        return self * self

    # -- constraints -----------------------------------------------------------------
    def enforce_equal(self, other):
        other = self._coerce(other)
        diff = self - other
        self.cs.enforce(diff.lc, {ONE: 1}, {})
        assert self.cs.setup_mode or diff.value == 0, "enforce_equal on unequal values (witness bug)"

    def conditional_enforce_equal(self, other, cond: "Boolean"):
        other = self._coerce(other)
        diff = self - other
        self.cs.enforce(diff.lc, cond.var.lc, {})
        assert self.cs.setup_mode or diff.value == 0 or cond.value == 0

    def is_zero(self) -> "Boolean":
        """Allocates b = (self == 0) with the standard 2-constraint gadget."""
        cs = self.cs
        v = self.value
        b_val = 1 if v == 0 else 0
        inv_val = 0 if v == 0 else pow(v, R - 2, R)
        b = FpVar.witness(cs, b_val)
        inv = FpVar.witness(cs, inv_val)
        # self * inv = 1 - b ; self * b = 0
        cs.enforce(self.lc, inv.lc, (FpVar.constant(cs, 1) - b).lc)
        cs.enforce(self.lc, b.lc, {})
        return Boolean(b, trusted=True)

    def is_eq(self, other) -> "Boolean":
        return (self - self._coerce(other)).is_zero()

    def inverse(self) -> "FpVar":
        assert self.cs.setup_mode or self.value != 0
        inv = FpVar.witness(self.cs, pow(self.value, R - 2, R) if self.value else 0)
        self.cs.enforce(self.lc, inv.lc, {ONE: 1})
        return inv

    # -- bit decomposition ---------------------------------------------------------
    def to_bits_le(self, nbits: int) -> list:
        """Decompose into nbits booleans, enforcing the recomposition.

        Soundness requires nbits < 254 so no wraparound is possible; callers
        use this for bounded quantities (u32/u64 words, tree indices).
        """
        assert nbits < 254
        assert self.cs.setup_mode or self.value < (1 << nbits), "value too large for bit decomposition"
        bits = [Boolean.witness(self.cs, (self.value >> i) & 1) for i in range(nbits)]
        acc = FpVar.constant(self.cs, 0)
        for i, b in enumerate(bits):
            acc = acc + b.var.scale(1 << i)
        acc.enforce_equal(self)
        return bits


    def to_canonical_bits(self) -> list:
        """Full 254-bit little-endian decomposition with a canonical-form
        (< R) enforcement, so low-bit extraction is sound for arbitrary field
        elements (e.g. Poseidon outputs). The reference sidesteps this with
        byte-level SHA digests (vkd/util.rs:19-27) or skips the constraint
        entirely in its Poseidon branch (vkd/hash.rs:146-152); here we pay
        ~3x254 constraints to bind the decomposition.
        """
        nbits = 254
        bits = [Boolean.witness(self.cs, (self.value >> i) & 1) for i in range(nbits)]
        acc = FpVar.constant(self.cs, 0)
        for i, b in enumerate(bits):
            acc = acc + b.var.scale(1 << i)
        acc.enforce_equal(self)
        # enforce bits < R (MSB-first scan against the constant modulus)
        lt = Boolean.constant(self.cs, 0)
        prefix_eq = Boolean.constant(self.cs, 1)
        for i in range(nbits - 1, -1, -1):
            r_bit = (R >> i) & 1
            if r_bit:
                lt = lt | (prefix_eq & bits[i].not_())
                prefix_eq = prefix_eq & bits[i]
            else:
                prefix_eq = prefix_eq & bits[i].not_()
        lt.enforce_true()
        return bits


class Boolean:
    __slots__ = ("var",)

    def __init__(self, var: FpVar, trusted: bool = False):
        self.var = var
        if not trusted:
            # b * (1 - b) = 0
            var.cs.enforce(var.lc, (FpVar.constant(var.cs, 1) - var).lc, {})

    @property
    def value(self) -> int:
        return self.var.value

    @staticmethod
    def witness(cs: ConstraintSystem, bit: int) -> "Boolean":
        return Boolean(FpVar.witness(cs, bit & 1))

    @staticmethod
    def constant(cs: ConstraintSystem, bit: int) -> "Boolean":
        return Boolean(FpVar.constant(cs, bit & 1), trusted=True)

    def __and__(self, other: "Boolean") -> "Boolean":
        return Boolean(self.var * other.var, trusted=True)

    def __or__(self, other: "Boolean") -> "Boolean":
        return Boolean(self.var + other.var - self.var * other.var, trusted=True)

    def __xor__(self, other: "Boolean") -> "Boolean":
        return Boolean(self.var + other.var - (self.var * other.var).scale(2), trusted=True)

    def not_(self) -> "Boolean":
        return Boolean(FpVar.constant(self.var.cs, 1) - self.var, trusted=True)

    def select(self, t: FpVar, f: FpVar) -> FpVar:
        """cond ? t : f — one constraint."""
        return f + self.var * (t - f)

    def enforce_true(self):
        self.var.enforce_equal(1)

    def enforce_false(self):
        self.var.enforce_equal(0)


def lc_sum(vars_) -> FpVar:
    acc = None
    for v in vars_:
        acc = v if acc is None else acc + v
    return acc
