"""Batched Jacobian curve arithmetic and host interop, generic over the field.

Port of hekaton_tpu/curves/jax_curve.py (`Jac`, `CurveOps`, :28-191, and
`PallasG1Ops.add_mixed`, :227-232). G1 runs over Fq ((..., 16) int32 limb
tensors, fields/torch_field.py), G2 over Fq2 ((..., 2, 16)); the
short-Weierstrass a=0 formulas are the same, with every edge case
(infinity, doubling, inverse points) handled by selects. Affine infinity is
(0, 0), Jacobian infinity is z == 0.

The Jacobian group law serves the fixed-base scalar muls of setup
(msm/pippenger.py::fixed_base_msm) and the compact `msm`, which runs its
loops of point ops as `ladder`, `sum_in_order` and `horner`. G1's `dbl`, `add`
and `add_mixed` are the dbl, add and madd kernel wrappers
(curves/cuda_curve.py): the CUDA kernel on CUDA tensors, its plain version on
CPU tensors, as `PallasG1Ops` dispatches to the Pallas kernels; its three
loops are one launch each of the chain kernel wrappers. The plain
versions of `add` and `add_mixed` mirror the Pallas `_add_tiles` and
`_madd_tiles`, which agree with `CurveOps.add` and `CurveOps.add_mixed` as
points but not as limbs on infinity lanes; `dbl` is the same formula in all
of them. G2 keeps the plain formulas, as the JAX package's `G2` has no
kernel either, and so does BLS12-381 G1 (`g1_bls12_381`, over the 24-limb
Fq), whose products alone run on the mont_mul kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields.host import Fq2
from ..fields.torch_field import FR, FR_BLS, FieldSpec, FqBlsOps, FqOps, Fq2Ops


class Jac(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class CurveOps:
    def __init__(self, fops, name: str, scalar: FieldSpec):
        self.f = fops
        self.name = name
        self.scalar = scalar  # the field of the group order r, in which scalars are packed

    # -- constructors -------------------------------------------------------
    def inf(self, batch_shape, device) -> Jac:
        f = self.f
        return Jac(f.one(batch_shape, device), f.one(batch_shape, device), f.zeros(batch_shape, device))

    def from_affine(self, ax, ay) -> Jac:
        """Affine (x, y) -> Jacobian; (0,0) lanes become infinity."""
        f = self.f
        inf_mask = f.is_zero(ax) & f.is_zero(ay)
        batch = ax.shape[: ax.dim() - f.ndim]
        return Jac(ax, ay, f.select(inf_mask, f.zeros(batch, ax.device), f.one(batch, ax.device)))

    def is_inf(self, p: Jac):
        return self.f.is_zero(p.z)

    def select(self, cond, p: Jac, q: Jac) -> Jac:
        f = self.f
        return Jac(f.select(cond, p.x, q.x), f.select(cond, p.y, q.y), f.select(cond, p.z, q.z))

    def neg(self, p: Jac) -> Jac:
        return Jac(p.x, self.f.neg(p.y), p.z)

    # -- group law -----------------------------------------------------------
    def dbl(self, p: Jac) -> Jac:
        """2P via dbl-2009-l (a=0): 2M + 5S. Infinity-safe (z3 = 2yz = 0)."""
        f = self.f
        a = f.sqr(p.x)
        b = f.sqr(p.y)
        c = f.sqr(b)
        d0 = f.sqr(f.add(p.x, b))
        d1 = f.sub(f.sub(d0, a), c)
        d = f.add(d1, d1)
        e = f.add(f.add(a, a), a)
        x3 = f.sub(f.sqr(e), f.add(d, d))
        c8 = f.add(f.add(c, c), f.add(c, c))
        c8 = f.add(c8, c8)
        y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
        z3 = f.mul(f.add(p.y, p.y), p.z)
        return Jac(x3, y3, z3)

    def add(self, p: Jac, q: Jac) -> Jac:
        """P + Q via add-2007-bl with branchless edge handling."""
        res, same_x, same_y = self.add_core(p, q)
        res = self.select(same_x & ~same_y, self.inf(same_x.shape, same_x.device), res)
        res = self.select(self.is_inf(p), q, res)
        return self.select(self.is_inf(q), p, res)

    def add_core(self, p: Jac, q: Jac):
        """add-2007-bl with the doubling escape, before any infinity
        override: (result, same_x, same_y). add and the add kernel's plain
        version (cuda_curve.add_plain) each add their own overrides."""
        f = self.f
        z1z1 = f.sqr(p.z)
        z2z2 = f.sqr(q.z)
        u1 = f.mul(p.x, z2z2)
        u2 = f.mul(q.x, z1z1)
        s1 = f.mul(f.mul(p.y, q.z), z2z2)
        s2 = f.mul(f.mul(q.y, p.z), z1z1)
        h = f.sub(u2, u1)
        rr = f.sub(s2, s1)
        same_x = f.is_zero(h)
        same_y = f.is_zero(rr)
        i = f.sqr(f.add(h, h))
        j = f.mul(h, i)
        r2 = f.add(rr, rr)
        v = f.mul(u1, i)
        x3 = f.sub(f.sub(f.sqr(r2), j), f.add(v, v))
        s1j = f.mul(s1, j)
        y3 = f.sub(f.mul(r2, f.sub(v, x3)), f.add(s1j, s1j))
        z3 = f.mul(f.sub(f.sub(f.sqr(f.add(p.z, q.z)), z1z1), z2z2), h)
        res = Jac(x3, y3, z3)
        if bool((same_x & same_y).any()):  # the doubling escape, only where a lane takes it
            res = self.select(same_x & same_y, self.dbl(p), res)
        return res, same_x, same_y

    def madd_core(self, p: Jac, ax, ay):
        """madd-2007-bl with the doubling escape, before any infinity
        override: (result, same_x, same_y). add_mixed and the madd kernel's
        plain version (cuda_curve.madd_plain) each add their own overrides."""
        f = self.f
        z1z1 = f.sqr(p.z)
        u2 = f.mul(ax, z1z1)
        s2 = f.mul(f.mul(ay, p.z), z1z1)
        h = f.sub(u2, p.x)
        rr = f.sub(s2, p.y)
        same_x = f.is_zero(h)
        same_y = f.is_zero(rr)
        hh = f.sqr(h)
        i = f.add(f.add(hh, hh), f.add(hh, hh))
        j = f.mul(h, i)
        r2 = f.add(rr, rr)
        v = f.mul(p.x, i)
        x3 = f.sub(f.sub(f.sqr(r2), j), f.add(v, v))
        yj = f.mul(p.y, j)
        y3 = f.sub(f.mul(r2, f.sub(v, x3)), f.add(yj, yj))
        z3 = f.sub(f.sub(f.sqr(f.add(p.z, h)), z1z1), hh)
        res = Jac(x3, y3, z3)
        if bool((same_x & same_y).any()):  # the doubling escape, only where a lane takes it
            res = self.select(same_x & same_y, self.dbl(p), res)
        return res, same_x, same_y

    def add_mixed(self, p: Jac, ax, ay) -> Jac:
        """P + (affine Q) via madd-2007-bl with edge handling."""
        f = self.f
        q_inf = f.is_zero(ax) & f.is_zero(ay)
        res, same_x, same_y = self.madd_core(p, ax, ay)
        res = self.select(same_x & ~same_y, self.inf(same_x.shape, same_x.device), res)
        batch = ax.shape[: ax.dim() - f.ndim]
        q_jac = Jac(ax, ay, f.select(q_inf, f.zeros(batch, ax.device), f.one(batch, ax.device)))
        res = self.select(self.is_inf(p), q_jac, res)
        return self.select(q_inf, p, res)

    # -- chains of the group law (the compact msm's loops) ---------------------
    def ladder(self, ax, ay, scalars, nbits: int) -> Jac:
        """Lane i's s_i * P_i for (N, ...) affine limbs ((0,0) = infinity)
        and (N, 16) plain scalar limbs: from the identity, bit j = nbits-1
        down to 0, a dbl, then where bit j is set the mixed add (a select)."""
        s = scalars.long()
        acc = self.inf((ax.shape[0],), ax.device)
        for j in range(nbits - 1, -1, -1):
            bit = ((s[:, j // 16] >> (j % 16)) & 1) == 1
            acc = self.dbl(acc)
            acc = self.select(bit, self.add_mixed(acc, ax, ay), acc)
        return acc

    def sum_in_order(self, stack: Jac) -> Jac:
        """acc = add(acc, p_j) from the identity over the leading axis of a
        (K, ...) stack, j = 0 .. K-1 in that order."""
        acc = self.inf(stack.x.shape[1 : stack.x.dim() - self.f.ndim], stack.x.device)
        for j in range(stack.x.shape[0]):
            acc = self.add(acc, Jac(*(a[j] for a in stack)))
        return acc

    def horner(self, window_sums: Jac, c: int) -> Jac:
        """sum_w 2^(c w) S_w of (W, ...) window sums on one lane: from window
        sum W-1 down, c doublings and the add of the next window sum a
        window."""
        W = window_sums.x.shape[0]
        acc = Jac(*(a[W - 1] for a in window_sums))
        for w in range(W - 2, -1, -1):
            for _ in range(c):
                acc = self.dbl(acc)
            acc = self.add(acc, Jac(*(a[w] for a in window_sums)))
        return acc

    # -- host interop ---------------------------------------------------------
    def _zero(self):
        return 0 if self.f.ndim == 1 else Fq2.zero()

    def pack_affine(self, host_points) -> tuple:
        """Host affine points (None = infinity) -> (ax, ay) int32 limb arrays."""
        f = self.f
        zero = self._zero()
        xs = [zero if pt is None else pt[0] for pt in host_points]
        ys = [zero if pt is None else pt[1] for pt in host_points]
        return np.asarray(f.pack(xs)), np.asarray(f.pack(ys))

    def unpack_jacobian(self, p: Jac) -> list:
        """Device Jacobian points -> host affine points (None = infinity)."""
        f = self.f
        out = []
        for x, y, z in zip(f.unpack(p.x), f.unpack(p.y), f.unpack(p.z)):
            if z == self._zero():
                out.append(None)
            elif f.ndim == 1:
                mod = f.spec.modulus
                zi = pow(z, mod - 2, mod)
                zi2 = zi * zi % mod
                out.append((x * zi2 % mod, y * zi2 * zi % mod))
            else:
                zi = z.inv()
                zi2 = zi.square()
                out.append((x * zi2, y * zi2 * zi))
        return out

    def unpack_affine(self, ax, ay) -> list:
        f = self.f
        zero = self._zero()
        return [None if (x == zero and y == zero) else (x, y) for x, y in zip(f.unpack(ax), f.unpack(ay))]


class G1Ops(CurveOps):
    """BN254 G1 ops whose group law is the dbl, add and madd kernel
    wrappers, and whose chains (ladder, sum_in_order, horner) are one launch
    each of the chain kernel wrappers jac_ladder, jac_sum and jac_horner, the
    limbs of CurveOps' loops on those single ops."""

    def dbl(self, p: Jac) -> Jac:
        from .cuda_curve import dbl

        return dbl(*(t.contiguous() for t in p))

    def add(self, p: Jac, q: Jac) -> Jac:
        from .cuda_curve import add

        return add(*(t.contiguous() for t in (*p, *q)))

    def add_mixed(self, p: Jac, ax, ay) -> Jac:
        from .cuda_curve import madd

        return madd(*(t.contiguous() for t in (*p, ax, ay)))

    def ladder(self, ax, ay, scalars, nbits: int) -> Jac:
        from .cuda_curve import jac_ladder

        return jac_ladder(ax.contiguous(), ay.contiguous(), scalars.contiguous(), nbits)

    def sum_in_order(self, stack: Jac) -> Jac:
        from .cuda_curve import jac_sum

        return jac_sum(*(a.contiguous() for a in stack))

    def horner(self, window_sums: Jac, c: int) -> Jac:
        from .cuda_curve import jac_horner

        return jac_horner(*(a.contiguous() for a in window_sums), c)


G1 = G1Ops(FqOps, "g1", FR)
G2 = CurveOps(Fq2Ops, "g2", FR)
G1_BLS = CurveOps(FqBlsOps, "g1_bls381", FR_BLS)


def g1_bls12_381() -> CurveOps:
    """G1 over BLS12-381 (jax_curve.py::g1_bls12_381, :239-245): the generic
    a=0 Jacobian formulas over the 24-limb Fq, their products on the
    mont_mul kernel for CUDA tensors. It has no point kernel: the JAX
    package's Pallas point kernels are BN254-only."""
    return G1_BLS
