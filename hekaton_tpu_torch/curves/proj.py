"""Homogeneous-projective G1 arithmetic with complete addition formulas
(Renes-Costello-Batina 2015, j-invariant-0 algorithms 7 and 9).

Port of hekaton_tpu/curves/proj.py (`ProjOps`, :42-170) for BN254 G1:
`from_affine`, `add`, `dbl` and `to_jacobian`. The formulas are complete:
identity (0:1:0), doubling and inverse pairs flow through the same
straight-line code. These are the plain formulas the Horner kernel
(curves/cuda_curve.py::horner_fold) is held against; the MSM itself uses
only `from_affine` and `to_jacobian` on its window sums.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields.torch_field import FqOps
from .torch_curve import Jac


class Proj(NamedTuple):
    """x = X/Z, y = Y/Z; identity = (0:1:0)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class ProjOps:
    """Complete-formula group ops over a field adapter; `b3_host` is 3*b
    (9 for BN254 G1)."""

    def __init__(self, fops, b3_host: int, name: str):
        self.f = fops
        self.name = name
        self.b3_host = b3_host
        self._b3 = fops.pack([b3_host])[0]

    def from_affine(self, ax, ay) -> Proj:
        """(0,0) sentinel lanes become the identity (0:1:0)."""
        f = self.f
        inf_mask = f.is_zero(ay)
        batch = ax.shape[: ax.dim() - f.ndim]
        y = f.select(inf_mask, f.one(batch, ax.device), ay)
        z = f.select(inf_mask, f.zeros(batch, ax.device), f.one(batch, ax.device))
        return Proj(ax, y, z)

    def mul_b3(self, a):
        return self.f.mul(a, torch.as_tensor(self._b3, device=a.device))

    def add(self, p: Proj, q: Proj) -> Proj:
        """Complete P + Q: RCB15 Algorithm 7 (a=0)."""
        f = self.f
        x1, y1, z1 = p
        x2, y2, z2 = q
        t0 = f.mul(x1, x2)
        t1 = f.mul(y1, y2)
        t2 = f.mul(z1, z2)
        t3 = f.mul(f.add(x1, y1), f.add(x2, y2))
        t3 = f.sub(t3, f.add(t0, t1))
        t4 = f.mul(f.add(y1, z1), f.add(y2, z2))
        t4 = f.sub(t4, f.add(t1, t2))
        y3 = f.mul(f.add(x1, z1), f.add(x2, z2))
        y3 = f.sub(y3, f.add(t0, t2))
        x3 = f.add(t0, t0)
        t0 = f.add(x3, t0)
        t2 = self.mul_b3(t2)
        z3 = f.add(t1, t2)
        t1 = f.sub(t1, t2)
        y3 = self.mul_b3(y3)
        x3 = f.sub(f.mul(t3, t1), f.mul(t4, y3))
        y3 = f.add(f.mul(t1, z3), f.mul(y3, t0))
        z3 = f.add(f.mul(z3, t4), f.mul(t0, t3))
        return Proj(x3, y3, z3)

    def dbl(self, p: Proj) -> Proj:
        """2P: RCB15 Algorithm 9 (a=0)."""
        f = self.f
        x, y, z = p
        t0 = f.sqr(y)
        z3 = f.add(t0, t0)
        z3 = f.add(z3, z3)
        z3 = f.add(z3, z3)
        t1 = f.mul(y, z)
        t2 = f.sqr(z)
        t2 = self.mul_b3(t2)
        x3 = f.mul(t2, z3)
        y3 = f.add(t0, t2)
        z3 = f.mul(t1, z3)
        t1 = f.add(t2, t2)
        t2 = f.add(t1, t2)
        t0 = f.sub(t0, t2)
        y3 = f.mul(t0, y3)
        y3 = f.add(x3, y3)
        t1 = f.mul(x, y)
        x3 = f.mul(t0, t1)
        x3 = f.add(x3, x3)
        return Proj(x3, y3, z3)

    def to_jacobian(self, p: Proj) -> Jac:
        """(X:Y:Z) -> Jacobian (XZ, YZ^2, Z)."""
        f = self.f
        z2 = f.sqr(p.z)
        return Jac(f.mul(p.x, p.z), f.mul(p.y, z2), p.z)


PROJ_G1 = ProjOps(FqOps, 9, "g1_proj")
