"""Curve descriptors and host interop for the device point layouts.

Port of the interop part of hekaton_tpu/curves/jax_curve.py (`Jac`,
`pack_affine`, `unpack_jacobian`, `unpack_affine`, :142-192). Device points
are `(..., 16)` int32 limb tensors per coordinate (fields/torch_field.py);
affine infinity is (0, 0), Jacobian infinity is z == 0.

The port runs no Jacobian arithmetic: the G1 MSM accumulates in complete
affine and projective coordinates (curves/affine.py, curves/proj.py), and the
G2 MSM and the fixed-base scalar muls run on the host (cpgroth16/backend.py).
So `G2` is a host-only descriptor: it names the curve for PointVec and packs
nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields.torch_field import FqOps


class Jac(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class CurveOps:
    def __init__(self, fops, name: str):
        self.f = fops
        self.name = name

    def _field(self):
        if self.f is None:
            raise NotImplementedError(f"{self.name} points have no device layout in this port")
        return self.f

    def pack_affine(self, host_points) -> tuple:
        """Host affine points (None = infinity) -> (ax, ay) int32 limb arrays."""
        f = self._field()
        xs = [0 if pt is None else pt[0] for pt in host_points]
        ys = [0 if pt is None else pt[1] for pt in host_points]
        return np.asarray(f.pack(xs)), np.asarray(f.pack(ys))

    def unpack_jacobian(self, p: Jac) -> list:
        """Device Jacobian points -> host affine points (None = infinity)."""
        f = self._field()
        mod = f.spec.modulus
        out = []
        for x, y, z in zip(f.unpack(p.x), f.unpack(p.y), f.unpack(p.z)):
            if z == 0:
                out.append(None)
                continue
            zi = pow(z, mod - 2, mod)
            zi2 = zi * zi % mod
            out.append((x * zi2 % mod, y * zi2 * zi % mod))
        return out

    def unpack_affine(self, ax, ay) -> list:
        f = self._field()
        return [
            None if (x == 0 and y == 0) else (x, y) for x, y in zip(f.unpack(ax), f.unpack(ay))
        ]


G1 = CurveOps(FqOps, "g1")
G2 = CurveOps(None, "g2")
