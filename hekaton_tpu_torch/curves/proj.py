"""Homogeneous-projective curve arithmetic with complete addition formulas
(Renes-Costello-Batina 2015, j-invariant-0 algorithms 7, 8 and 9), generic
over the field adapter.

Port of hekaton_tpu/curves/proj.py (`ProjOps`, :42-170; `PallasProjG1Ops`,
:171-209; `PallasProjG2Ops` and `proj_g2`, :212-283). The formulas are
complete: identity (0:1:0), doubling and inverse pairs flow through the same
straight-line code; only the affine operand of a mixed add needs one
select, for the (0,0) sentinel.

`PROJ_G1` (b3 = 9) and `PROJ_G2` (b3 = 3 * B_G2 = 9/(9+u)) send
`add_mixed`, `add` and `dbl` to the three kernel wrappers of their curve in
curves/cuda_curve.py, which launch their CUDA kernels on CUDA tensors and
run these formulas on CPU tensors, as `PallasProjG1Ops` and
`PallasProjG2Ops` reach the Pallas kernels on a TPU. The G2 MSM and the G1
MSM's accum="proj" routes accumulate in them; every G1 route takes
`from_affine` and `to_jacobian` of its window sums from `PROJ_G1`.
`proj_for_curve` (:250-268) picks the ops of a curve: `PROJ_G1`, `PROJ_G2`, or
for BLS12-381 G1 the generic `PROJ_G1_BLS` (b3 = 3 * 4 = 12), whose products
alone run on a kernel (the 24-limb mont_mul).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import bls12_381 as bls
from ..fields import torch_field as tf
from ..fields.torch_field import FqBlsOps, FqOps, Fq2Ops
from .host import B_G2
from .torch_curve import Jac, products


class Proj(NamedTuple):
    """x = X/Z, y = Y/Z; identity = (0:1:0)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class ProjOps:
    """Complete-formula group ops over a field adapter; `b3_host` is 3*b of
    the curve as a host value (9 for BN254 G1, an Fq2 for G2)."""

    def __init__(self, fops, b3_host, name: str):
        self.f = fops
        self.name = name
        self.b3_host = b3_host
        self._b3 = torch.from_numpy(fops.pack([b3_host])[0])

    def inf(self, batch_shape, device) -> Proj:
        f = self.f
        return Proj(f.zeros(batch_shape, device), f.one(batch_shape, device), f.zeros(batch_shape, device))

    def from_affine(self, ax, ay) -> Proj:
        """(0,0) sentinel lanes become the identity (0:1:0)."""
        f = self.f
        inf_mask = f.is_zero(ay)
        batch = ax.shape[: ax.dim() - f.ndim]
        y = f.select(inf_mask, f.one(batch, ax.device), ay)
        z = f.select(inf_mask, f.zeros(batch, ax.device), f.one(batch, ax.device))
        return Proj(ax, y, z)

    def is_inf(self, p: Proj):
        return self.f.is_zero(p.z)

    def select(self, cond, p: Proj, q: Proj) -> Proj:
        f = self.f
        return Proj(f.select(cond, p.x, q.x), f.select(cond, p.y, q.y), f.select(cond, p.z, q.z))

    def neg(self, p: Proj) -> Proj:
        return Proj(p.x, self.f.neg(p.y), p.z)

    def mul_b3(self, a):
        return self.f.mul(a, self._b3.to(a.device))

    def add(self, p: Proj, q: Proj) -> Proj:
        """Complete P + Q: RCB15 Algorithm 7 (a=0), its 12 products and 2
        products by b3 in three calls of the field's mul."""
        f = self.f
        x1, y1, z1 = p
        x2, y2, z2 = q
        b3 = self._b3.to(x1.device)
        t0, t1, t2, t3, t4, y3 = products(f, (x1, x2), (y1, y2), (z1, z2), (f.add(x1, y1), f.add(x2, y2)),
                                          (f.add(y1, z1), f.add(y2, z2)), (f.add(x1, z1), f.add(x2, z2)))
        t3 = f.sub(t3, f.add(t0, t1))
        t4 = f.sub(t4, f.add(t1, t2))
        y3 = f.sub(y3, f.add(t0, t2))
        x3 = f.add(t0, t0)
        t0 = f.add(x3, t0)
        t2, y3 = products(f, (t2, b3), (y3, b3))
        z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        return self._finish(t0, t1, t3, t4, y3, z3)

    def _finish(self, t0, t1, t3, t4, y3, z3) -> Proj:
        """The six closing products of Algorithms 7 and 8, in one call."""
        f = self.f
        m = products(f, (t3, t1), (t4, y3), (t1, z3), (y3, t0), (z3, t4), (t0, t3))
        return Proj(f.sub(m[0], m[1]), f.add(m[2], m[3]), f.add(m[4], m[5]))

    def add_mixed(self, p: Proj, ax, ay) -> Proj:
        """P + (affine Q): RCB15 Algorithm 8 (a=0, Z2=1), its 11 products and
        2 products by b3 in three calls of the field's mul. Complete except
        for the affine sentinel (0,0) (y = 0 only there on prime-order a=0
        curves), resolved by one final select."""
        f = self.f
        x1, y1, z1 = p
        q_inf = f.is_zero(ay)
        b3 = self._b3.to(x1.device)
        t0, t1, t3, t4, y3, t2 = products(f, (x1, ax), (y1, ay), (f.add(ax, ay), f.add(x1, y1)), (ay, z1),
                                          (ax, z1), (z1, b3))
        t3 = f.sub(t3, f.add(t0, t1))
        t4 = f.add(t4, y1)
        y3 = f.add(y3, x1)
        x3 = f.add(t0, t0)
        t0 = f.add(x3, t0)
        z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        y3 = self.mul_b3(y3)
        return self.select(q_inf, p, self._finish(t0, t1, t3, t4, y3, z3))

    def dbl(self, p: Proj) -> Proj:
        """2P: RCB15 Algorithm 9 (a=0), its 8 products and 1 product by b3
        in three calls of the field's mul (y^2 and z^2 as products: the
        same canonical values as sqr)."""
        f = self.f
        x, y, z = p
        t0, t1, t2, xy = products(f, (y, y), (y, z), (z, z), (x, y))
        z3 = f.add(t0, t0)
        z3 = f.add(z3, z3)
        z3 = f.add(z3, z3)
        t2 = self.mul_b3(t2)
        y3 = f.add(t0, t2)
        t0 = f.sub(t0, f.add(f.add(t2, t2), t2))
        x3, z3, y3, x3b = products(f, (t2, z3), (t1, z3), (t0, y3), (t0, xy))
        y3 = f.add(x3, y3)
        return Proj(f.add(x3b, x3b), y3, z3)

    def to_jacobian(self, p: Proj) -> Jac:
        """(X:Y:Z) -> Jacobian (XZ, YZ^2, Z)."""
        f = self.f
        z2 = f.sqr(p.z)
        return Jac(f.mul(p.x, p.z), f.mul(p.y, z2), p.z)

    def from_jacobian(self, p: Jac) -> Proj:
        """Jacobian (X, Y, Z) -> (XZ : Y : Z^3); Z = 0 maps to (0:Y:0) = inf."""
        f = self.f
        return Proj(f.mul(p.x, p.z), p.y, f.mul(f.sqr(p.z), p.z))


class KernelProjOps(ProjOps):
    """Projective ops whose add_mixed / add / dbl are a curve's three RCB
    kernel wrappers (plain formulas on CPU tensors, kernels on CUDA);
    `_kernels` returns them as (mixed add, add, double)."""

    def _kernels(self):
        raise NotImplementedError

    def add(self, p: Proj, q: Proj) -> Proj:
        return Proj(*self._kernels()[1](*(t.contiguous() for t in (*p, *q))))

    def add_mixed(self, p: Proj, ax, ay) -> Proj:
        return Proj(*self._kernels()[0](*(t.contiguous() for t in (*p, ax, ay))))

    def dbl(self, p: Proj) -> Proj:
        return Proj(*self._kernels()[2](*(t.contiguous() for t in p)))


class ProjG1Ops(KernelProjOps):
    """BN254 G1: the pmadd_rcb / padd_rcb / pdbl_rcb wrappers."""

    def _kernels(self):
        from .cuda_curve import padd_rcb, pdbl_rcb, pmadd_rcb

        return pmadd_rcb, padd_rcb, pdbl_rcb


class ProjG2Ops(KernelProjOps):
    """BN254 G2: the Fq2 wrappers pmadd_rcb_g2 / padd_rcb_g2 / pdbl_rcb_g2."""

    def _kernels(self):
        from .cuda_curve import padd_rcb_g2, pdbl_rcb_g2, pmadd_rcb_g2

        return pmadd_rcb_g2, padd_rcb_g2, pdbl_rcb_g2


PROJ_G1 = ProjG1Ops(FqOps, 9, "g1_proj")
PROJ_G2 = ProjG2Ops(Fq2Ops, B_G2 * 3, "g2_proj")
PROJ_G1_BLS = ProjOps(FqBlsOps, 3 * bls.B_G1, "g1_bls381_proj")


def proj_for_curve(curve) -> ProjOps:
    """The complete-formula ops over a curve's base field: BN254 G1 (the RCB
    kernels), BN254 G2 (the Fq2 RCB kernels) or BLS12-381 G1 (generic)."""
    if curve.f.ndim == 2:
        return PROJ_G2
    modulus = curve.f.spec.modulus
    if modulus == tf.FQ.modulus:
        return PROJ_G1
    if modulus == tf.FQ_BLS.modulus:
        return PROJ_G1_BLS
    raise ValueError(f"no projective ops for the field {curve.f.spec.name}")
