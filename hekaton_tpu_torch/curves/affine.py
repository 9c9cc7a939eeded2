"""Batched complete affine G1 ops: the MSM's bucket-accumulation arithmetic.

Port of hekaton_tpu/curves/affine.py (`Aff`, `AffineOps`, :51-186,
`PallasAffG1Ops`, :188-216, `aff_for_curve`, :221-236). An add costs ~3
products plus a share of one batch inversion (Montgomery's trick), against
13 for a complete projective mixed add.
Completeness is branchless: (0,0) is infinity (y = 0 never occurs on a
prime-order a=0 curve), equal-x lanes take the tangent, inverse pairs give
(0,0).

`AffineOps` is the JAX package's generic class over any prime-field ops
object (BLS12-381 G1 takes it): `_prep` and `_fin` in plain torch with the
products through `f.mul` (the mont_mul kernel on CUDA tensors, as
`_big_mul` reaches the Pallas CIOS kernel) and one `tf.batch_inv` of the
denominators between them (on CUDA tensors every lane on the divstep
inversion kernel).

`AFF_G1` (BN254 G1) is `KernelAffG1Ops`: its `add` is
curves/cuda_curve.py::aff_add_fused and its `add_packed`
curves/cuda_curve.py::aff_add_mixed_packed, which launch their CUDA kernel
pairs for CUDA tensors (as `PallasAffG1Ops.add` and `.add_packed` reach the
Pallas pairs) and run their plain versions for CPU tensors.

Packed rows (the MSM slab) hold two 16-bit limbs per 32-bit word, the
x-words then the y-words (8 and 8 on BN254, 12 and 12 on BLS12-381), as
int32 bit patterns.
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
    """Complete batched-affine ops over a prime-field ops object (the JAX
    package's generic `AffineOps`)."""

    def __init__(self, fops, name: str):
        self.f = fops
        self.name = name

    def inf(self, batch_shape, device) -> Aff:
        f = self.f
        return Aff(f.zeros(batch_shape, device), f.zeros(batch_shape, device))

    def is_inf(self, p: Aff):
        return self.f.is_zero(p.y)

    def select(self, cond, p: Aff, q: Aff) -> Aff:
        f = self.f
        return Aff(f.select(cond, p.x, q.x), f.select(cond, p.y, q.y))

    def _cases(self, p: Aff, q: Aff):
        """(p_inf, q_inf, dx, dy, same_x, dbl) of P + Q."""
        f = self.f
        dx = f.sub(q.x, p.x)
        dy = f.sub(q.y, p.y)
        same_x = f.is_zero(dx)
        return self.is_inf(p), self.is_inf(q), dx, dy, same_x, same_x & f.is_zero(dy)

    def _prep(self, p: Aff, q: Aff):
        """(den, num) of the slope: the tangent's 3x^2 / 2y on doubling
        lanes, dy / dx elsewhere; degenerate lanes' den masked to 1."""
        f = self.f
        p_inf, q_inf, dx, dy, same_x, dbl = self._cases(p, q)
        x1sq = f.mul(p.x, p.x)
        num_dbl = f.add(f.add(x1sq, x1sq), x1sq)
        den = f.select(dbl, f.add(p.y, p.y), dx)
        num = f.select(dbl, num_dbl, dy)
        degen = q_inf | p_inf | (same_x & ~dbl)
        den = f.select(degen, f.one(p.x.shape[:-1], p.x.device), den)
        return den, num

    def _fin(self, p: Aff, q: Aff, inv, num) -> Aff:
        f = self.f
        p_inf, q_inf, _, _, same_x, dbl = self._cases(p, q)
        lam = f.mul(num, inv)
        x2s = f.select(dbl, p.x, q.x)
        x3 = f.sub(f.sub(f.mul(lam, lam), p.x), x2s)
        y3 = f.sub(f.mul(lam, f.sub(p.x, x3)), p.y)
        inverse = same_x & ~dbl & ~(p_inf | q_inf)
        zero = f.zeros(p.x.shape[:-1], p.x.device)
        x3 = f.select(inverse, zero, x3)
        y3 = f.select(inverse, zero, y3)
        x3 = f.select(q_inf, p.x, x3)
        y3 = f.select(q_inf, p.y, y3)
        x3 = f.select(p_inf, q.x, x3)
        y3 = f.select(p_inf, q.y, y3)
        return Aff(x3, y3)

    def add(self, p: Aff, q: Aff) -> Aff:
        """Complete P + Q (both affine with the (0,0) sentinel)."""
        den, num = self._prep(p, q)
        return self._fin(p, q, tf.batch_inv(self.f.spec, den), num)

    def add_packed(self, p: Aff, rows) -> Aff:
        """P + the points of the packed rows (x-words || y-words): the
        level-1 step of the affine steps routes."""
        return self.add(p, self.unpack_rows(rows))

    def add_pairs_packed(self, v):
        """(m, 2*nw) packed PAIRS (a || b rows) -> (m, nw) packed sums: one
        round of the generic pairwise level-1 tree (affine.py:154-161);
        every add of a round shares one batch inversion."""
        nw = v.shape[-1] // 2
        return self.pack_rows(self.add(self.unpack_rows(v[:, :nw]), self.unpack_rows(v[:, nw:])))

    def from_proj(self, x, y, z) -> Aff:
        """Batched projective (x : y : z) -> affine by one batch inversion
        of the z's (the inversion kernel on CUDA tensors); z = 0
        lanes give the (0,0) sentinel."""
        f = self.f
        batch = x.shape[:-1]
        inf = f.is_zero(z)
        zinv = tf.batch_inv(f.spec, f.select(inf, f.one(batch, z.device), z))
        zero = f.zeros(batch, x.device)
        return Aff(f.select(inf, zero, f.mul(x, zinv)), f.select(inf, zero, f.mul(y, zinv)))

    @staticmethod
    def unpack_rows(rows) -> Aff:
        """(n, 2k) packed rows (k x-words || k y-words) -> affine batch of
        (n, 2k) limbs."""
        half = rows.shape[-1] // 2
        return Aff(unpack_words(rows[..., :half]), unpack_words(rows[..., half:]))

    @staticmethod
    def pack_rows(p: Aff):
        """Affine batch -> (n, nlimbs) packed rows."""
        return torch.cat([pack_words(p.x), pack_words(p.y)], dim=-1)


class KernelAffG1Ops(AffineOps):
    """BN254 G1: `add` and `add_packed` are the aff_add_fused and
    aff_add_mixed_packed kernel pairs (PallasAffG1Ops, affine.py:188-216)."""

    def add(self, p: Aff, q: Aff) -> Aff:
        from .cuda_curve import aff_add_fused

        args = [t.contiguous() for t in (p.x, p.y, q.x, q.y)]
        return Aff(*aff_add_fused(*args))

    def add_packed(self, p: Aff, rows) -> Aff:
        """P + the points of the packed (n, 16) rows (8 x-words || 8
        y-words) (PallasAffG1Ops.add_packed, affine.py:211)."""
        from .cuda_curve import aff_add_mixed_packed

        return Aff(*aff_add_mixed_packed(p.x.contiguous(), p.y.contiguous(), rows.contiguous()))


AFF_G1 = KernelAffG1Ops(FqOps, "g1_aff")
AFF_G1_BLS = AffineOps(tf.FqBlsOps, "g1_bls381_aff")


def aff_for_curve(curve) -> AffineOps:
    """The complete-affine ops over a G1 curve's base field (affine.py:221-236):
    AFF_G1 on BN254, the generic AFF_G1_BLS on BLS12-381."""
    if curve.f.ndim != 1:
        raise ValueError("batched-affine accumulation is a G1 path")
    modulus = curve.f.spec.modulus
    if modulus == tf.FQ.modulus:
        return AFF_G1
    if modulus == tf.FQ_BLS.modulus:
        return AFF_G1_BLS
    raise ValueError(f"no affine ops for the field {curve.f.spec.name}")
