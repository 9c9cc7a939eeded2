"""Plain PyTorch arithmetic modulo a 254-bit prime on 16 limbs of 16 bits.

The benchmark makes its 2^20 BN254 G1 points and the discrete logs of every
point with this, on the device, in a few hundred batched torch calls: limbs
are int64, so a column of 16 limb products (< 2^36) plus the reduction's 16
(< 2^36) never overflows. Imports nothing of the program.
"""
from __future__ import annotations

import torch

from . import bn254

MASK = 0xFFFF
NL = 16


def _limbs(v: int, device) -> torch.Tensor:
    return torch.tensor(bn254.to_limbs([v])[0], dtype=torch.int64, device=device)


class ModArith:
    """Canonical residues modulo `m` as (n, 16) int64 limbs; `mul` is the
    Montgomery product a b 2^-256 mod m."""

    def __init__(self, m: int, device):
        self.m = m
        self.device = device
        self.p = _limbs(m, device)
        self.ninv = (-pow(m, -1, 1 << 16)) % (1 << 16)

    def tensor(self, vals, mont: bool = False) -> torch.Tensor:
        """ints -> (n, 16) limbs on the device (x 2^256 mod m where `mont`)."""
        vals = [v % self.m * (1 << 256) % self.m if mont else v % self.m for v in vals]
        return torch.from_numpy(bn254.to_limbs(vals)).to(self.device)

    @staticmethod
    def _carry(t: torch.Tensor) -> torch.Tensor:
        """Propagate carries (and borrows) along the last axis, in place;
        the top column keeps what overflows."""
        for j in range(t.shape[1] - 1):
            t[:, j + 1] += t[:, j] >> 16
            t[:, j] &= MASK
        return t

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """t (n, 17) normalised, below 2m -> t mod m as (n, 16)."""
        d = self._carry(t - torch.cat([self.p, self.p[:1] * 0]))
        return torch.where((d[:, NL] < 0)[:, None], t[:, :NL], d[:, :NL])

    def _wide(self, t: torch.Tensor) -> torch.Tensor:
        """(n, 16) unnormalised limbs -> (n, 17) normalised."""
        return self._carry(torch.cat([t, torch.zeros_like(t[:, :1])], dim=1))

    def add(self, a, b):
        return self._reduce_once(self._wide(a + b))

    def sub(self, a, b):
        return self._reduce_once(self._wide(a - b + self.p))

    def mul(self, a, b):
        n = a.shape[0]
        t = torch.zeros((n, 2 * NL + 1), dtype=torch.int64, device=a.device)
        for i in range(NL):
            t[:, i:i + NL] += a[:, i:i + 1] * b
        for i in range(NL):
            m = ((t[:, i] & MASK) * self.ninv) & MASK
            t[:, i:i + NL] += m[:, None] * self.p
            t[:, i + 1] += t[:, i] >> 16
        out = self._carry(t[:, NL:].clone())  # below 2m: column 2*NL ends 0
        return self._reduce_once(out[:, :NL + 1])

    def batch_inv(self, a):
        """Montgomery-form inverses of Montgomery-form a (no lane 0): a
        product tree, one host inversion at its root."""
        n = a.shape[0]
        if n == 1:
            v = bn254.from_limbs(a.cpu().numpy())[0] * pow(1 << 256, -1, self.m) % self.m
            if v == 0:
                raise ZeroDivisionError("batch_inv: a lane is 0")
            return self.tensor([pow(v, -1, self.m)], mont=True)
        if n % 2:
            a = torch.cat([a, self.tensor([1], mont=True)])
        ev, od = a[0::2].contiguous(), a[1::2].contiguous()
        root = self.batch_inv(self.mul(ev, od))
        out = torch.stack([self.mul(root, od), self.mul(root, ev)], dim=1).reshape(-1, NL)
        return out[:n]


def g1_block_sums(arith: ModArith, ax, ay, bx, by):
    """Affine sums A_a + B_b of every pair, row a*len(B) + b, on the device:
    Montgomery limbs in, Montgomery limbs out. Raises where some A_a and B_b
    share an x (the sum would need the doubling or be infinity)."""
    na, nb = ax.shape[0], bx.shape[0]
    x1 = ax[:, None, :].expand(na, nb, NL).reshape(-1, NL)
    y1 = ay[:, None, :].expand(na, nb, NL).reshape(-1, NL)
    x2 = bx[None, :, :].expand(na, nb, NL).reshape(-1, NL)
    y2 = by[None, :, :].expand(na, nb, NL).reshape(-1, NL)
    den = arith.sub(x2, x1)
    if bool((den == 0).all(dim=1).any()):
        raise ValueError("g1_block_sums: two summands share an x coordinate")
    lam = arith.mul(arith.sub(y2, y1), arith.batch_inv(den))
    x3 = arith.sub(arith.sub(arith.mul(lam, lam), x1), x2)
    y3 = arith.sub(arith.mul(lam, arith.sub(x1, x3)), y1)
    return x3, y3
