"""Batched complete affine G1 ops: the MSM's bucket-accumulation arithmetic.

Port of hekaton_tpu/curves/affine.py (`Aff`, `AffineOps`, :51-186, with
`from_proj`, :165-177) for BN254 G1. An add costs ~3 products plus a share
of one batch inversion (Montgomery's trick), against 13 for a complete
projective mixed add.
Completeness is branchless: (0,0) is infinity (y = 0 never occurs on the
prime-order a=0 curve), equal-x lanes take the tangent, inverse pairs give
(0,0).

`AffineOps.add` is curves/cuda_curve.py::aff_add_fused and
`AffineOps.add_packed` curves/cuda_curve.py::aff_add_mixed_packed, which
launch their CUDA kernel pairs for CUDA tensors (as `PallasAffG1Ops.add`
and `.add_packed` reach the Pallas pairs, affine.py:188-216) and run their
plain versions for CPU tensors.

Packed rows (the MSM slab) hold two 16-bit limbs per 32-bit word, 8 x-words
then 8 y-words, as int32 bit patterns.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields import torch_field as tf
from ..fields.torch_field import FqOps


class Aff(NamedTuple):
    """Affine point batch; (0,0) = infinity."""

    x: torch.Tensor
    y: torch.Tensor


def pack_words(a: torch.Tensor) -> torch.Tensor:
    """(..., 2k) limbs -> (..., k) int32 words holding two limbs each."""
    w = a[..., 0::2].long() | (a[..., 1::2].long() << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).int()


def unpack_words(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int32 words -> (..., 2k) limbs."""
    w = w.long() & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(w.shape[:-1] + (2 * w.shape[-1],)).int()


class AffineOps:
    """Complete batched-affine G1 ops."""

    def __init__(self, fops, name: str):
        self.f = fops
        self.name = name

    def inf(self, batch_shape, device) -> Aff:
        f = self.f
        return Aff(f.zeros(batch_shape, device), f.zeros(batch_shape, device))

    def select(self, cond, p: Aff, q: Aff) -> Aff:
        f = self.f
        return Aff(f.select(cond, p.x, q.x), f.select(cond, p.y, q.y))

    def add(self, p: Aff, q: Aff) -> Aff:
        """Complete P + Q (both affine with the (0,0) sentinel)."""
        from .cuda_curve import aff_add_fused

        args = [t.contiguous() for t in (p.x, p.y, q.x, q.y)]
        return Aff(*aff_add_fused(*args))

    def add_packed(self, p: Aff, rows) -> Aff:
        """P + the points of the packed (n, 16) rows (8 x-words || 8
        y-words): the level-1 step of the affine steps routes
        (PallasAffG1Ops.add_packed, affine.py:211)."""
        from .cuda_curve import aff_add_mixed_packed

        return Aff(*aff_add_mixed_packed(p.x.contiguous(), p.y.contiguous(), rows.contiguous()))

    def from_proj(self, x, y, z) -> Aff:
        """Batched projective (x : y : z) -> affine by one batch inversion
        of the z's (the mont_mul and Fermat kernels on CUDA tensors); z = 0
        lanes give the (0,0) sentinel."""
        f = self.f
        batch = x.shape[:-1]
        inf = f.is_zero(z)
        zinv = tf.batch_inv(f.spec, f.select(inf, f.one(batch, z.device), z))
        zero = f.zeros(batch, x.device)
        return Aff(f.select(inf, zero, f.mul(x, zinv)), f.select(inf, zero, f.mul(y, zinv)))

    @staticmethod
    def unpack_rows(rows) -> Aff:
        """(n, 16) packed rows (8 x-words || 8 y-words) -> affine batch."""
        return Aff(unpack_words(rows[..., :8]), unpack_words(rows[..., 8:]))

    @staticmethod
    def pack_rows(p: Aff):
        """Affine batch -> (n, 16) packed rows."""
        return torch.cat([pack_words(p.x), pack_words(p.y)], dim=-1)


AFF_G1 = AffineOps(FqOps, "g1_aff")
