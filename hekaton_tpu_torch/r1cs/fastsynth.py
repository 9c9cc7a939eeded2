"""Compiled R1CS matrices: fast per-proof evals for value-only synthesis.

The reference's prover re-synthesizes constraints per proof in Rust, where
that costs seconds; in Python the LC-dict bookkeeping dominates the whole
stage-1 wall time at canonical scale. Production split used here (the same
one circom/snarkjs-style provers use): per UNIQUE subcircuit shape the
matrices are compiled ONCE into numpy arrays (at CRS generation, which
synthesizes anyway), and each proof then runs the circuit in value-only
mode (r1cs/builder.py) — identical allocation order, no LCs — plus a
vectorized matvec here for A.z/B.z/C.z and the satisfiability check.

Coefficient encoding exploits circuit structure: almost every coefficient
is small (+-1, small constants: 1 u64 multiply per entry) or a power of two
(one nonzero 16-bit limb); only genuinely random field constants (Poseidon
ARK/MDS combinations) take the general 16-limb path.
"""
from __future__ import annotations

import numpy as np

from ..fields.bn254 import R
from .builder import ConstraintSystem

_SMALL = 1 << 31
_WIDE = 34  # u64 accumulator limbs: 16 (value) + 16 (coeff) + carries


def _pack_z(vals: list) -> np.ndarray:
    """Assignment ints -> (n, 16) u32 16-bit limbs (plain, not Montgomery)."""
    out = np.zeros((len(vals), 16), dtype=np.uint32)
    for i, v in enumerate(vals):
        v = int(v) % R
        b = v.to_bytes(32, "little")
        out[i] = np.frombuffer(b, dtype="<u2").astype(np.uint32)
    return out


class _MatrixGroup:
    """One matrix's entries, classified by coefficient shape, sorted by row."""

    def __init__(self, rows):
        small = []  # (row, col, signed v)
        single = []  # (row, col, limb_idx, limb_val)
        full = []  # (row, col, 16 limbs)
        for r, row in enumerate(rows):
            for col, coeff in row:
                c = coeff % R
                if c == 0:
                    continue
                if c < _SMALL:
                    small.append((r, col, c))
                    continue
                if R - c < _SMALL:
                    small.append((r, col, -(R - c)))
                    continue
                limbs = [(c >> (16 * j)) & 0xFFFF for j in range(16)]
                nz = [j for j, lv in enumerate(limbs) if lv]
                if len(nz) == 1:
                    single.append((r, col, nz[0], limbs[nz[0]]))
                else:
                    full.append((r, col, limbs))

        def arr(entries, extract, dtype=np.int64):
            return np.asarray([extract(e) for e in entries], dtype=dtype)

        self.s_row = arr(small, lambda e: e[0])
        self.s_col = arr(small, lambda e: e[1])
        self.s_val = arr(small, lambda e: e[2])
        self.g_row = arr(single, lambda e: e[0])
        self.g_col = arr(single, lambda e: e[1])
        self.g_off = arr(single, lambda e: e[2])
        self.g_val = arr(single, lambda e: e[3], dtype=np.uint64)
        self.f_row = arr(full, lambda e: e[0])
        self.f_col = arr(full, lambda e: e[1])
        self.f_limbs = (
            np.asarray([e[2] for e in full], dtype=np.uint64)
            if full
            else np.zeros((0, 16), dtype=np.uint64)
        )

    def matvec_wide(self, z: np.ndarray, nc: int) -> tuple:
        """(pos, neg) accumulators, each (nc, _WIDE) u64 in base 2^16."""
        pos = np.zeros((nc, _WIDE), dtype=np.uint64)
        neg = np.zeros((nc, _WIDE), dtype=np.uint64)

        def accum(out, rows, contrib, off=0):
            # entries are row-sorted: segment-sum via reduceat at row starts
            if len(rows) == 0:
                return
            starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
            sums = np.add.reduceat(contrib, starts, axis=0)
            out[rows[starts], off : off + contrib.shape[1]] += sums

        if len(self.s_row):
            zv = z[self.s_col].astype(np.uint64)  # (E, 16) 16-bit values
            p = self.s_val > 0
            accum(pos, self.s_row[p], zv[p] * self.s_val[p].astype(np.uint64)[:, None])
            n = ~p
            accum(neg, self.s_row[n], zv[n] * (-self.s_val[n]).astype(np.uint64)[:, None])
        if len(self.g_row):
            zv = z[self.g_col].astype(np.uint64)
            contrib = zv * self.g_val[:, None]
            for off in range(16):
                m = self.g_off == off
                if m.any():
                    accum(pos, self.g_row[m], contrib[m], off=off)
        if len(self.f_row):
            zv = z[self.f_col].astype(np.uint64)
            for j in range(16):
                lv = self.f_limbs[:, j]
                nzm = lv != 0
                if nzm.any():
                    accum(pos, self.f_row[nzm], zv[nzm] * lv[nzm][:, None], off=j)
        return pos, neg


def _wide_to_ints(pos: np.ndarray, neg: np.ndarray) -> list:
    """Per-row (pos - neg) mod R from base-2^16 u64 accumulators."""
    # carry-normalize to 16-bit limbs (vectorized; no u64 overflow: every
    # accumulated term is < 2^48 and rows have << 2^16 entries)
    def norm(w):
        w = w.copy()
        for k in range(_WIDE - 1):
            carry = w[:, k] >> np.uint64(16)
            w[:, k] &= np.uint64(0xFFFF)
            w[:, k + 1] += carry
        w[:, _WIDE - 1] &= np.uint64(0xFFFF)
        return w.astype("<u2")

    pb = norm(pos).tobytes()
    nb = norm(neg).tobytes()
    step = _WIDE * 2
    out = []
    for i in range(pos.shape[0]):
        p = int.from_bytes(pb[i * step : (i + 1) * step], "little")
        n = int.from_bytes(nb[i * step : (i + 1) * step], "little")
        out.append((p - n) % R)
    return out


class CompiledMatrices:
    """Built once per unique subcircuit shape from a fully-synthesized CS."""

    def __init__(self, cs: ConstraintSystem):
        self.num_constraints = cs.num_constraints
        self.num_instance = cs.num_instance
        a_rows, b_rows, c_rows = cs.matrices()
        self.a = _MatrixGroup(a_rows)
        self.b = _MatrixGroup(b_rows)
        self.c = _MatrixGroup(c_rows)

    def evals(self, full_assignment: list, domain_size: int, check: bool = True):
        """A.z, B.z, C.z over the evaluation domain (with the instance-
        consistency rows), mirroring cpgroth16.prover._matrix_evals; with
        check=True also verifies satisfiability row-by-row (replacing the
        full-synthesis is_satisfied pass)."""
        nc, ni = self.num_constraints, self.num_instance
        assert domain_size >= nc + ni
        z = _pack_z(full_assignment)
        a = _wide_to_ints(*self.a.matvec_wide(z, nc))
        b = _wide_to_ints(*self.b.matvec_wide(z, nc))
        c = _wide_to_ints(*self.c.matvec_wide(z, nc))
        if check:
            for i in range(nc):
                if a[i] * b[i] % R != c[i]:
                    raise AssertionError(f"unsatisfied constraint {i}")
        a_evals = a + [0] * (domain_size - nc)
        b_evals = b + [0] * (domain_size - nc)
        c_evals = c + [0] * (domain_size - nc)
        for i in range(ni):
            a_evals[nc + i] = int(full_assignment[i]) % R
        return a_evals, b_evals, c_evals
