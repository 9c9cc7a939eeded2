"""Radix-2 NTT over BN254-Fr on torch tensors, with the four-step split.

Port of hekaton_tpu/ntt/ntt.py. Sizes <= 256 run an iterative Cooley-Tukey
(bit-reversal permutation, then log2(n) butterfly stages, each one batched
Montgomery multiply plus an add and a sub); larger sizes use the four-step
split N = N1*N2 (column NTTs, cross-twiddle multiply, row NTTs, transpose).

Data is (..., n, 16) int32 Montgomery limbs in natural order. Every
Montgomery multiply goes through fields/cuda_field.py::mont_mul, so on CUDA
tensors it is the kernel and on CPU tensors the plain formula; adds and subs
are the plain elementwise formulas on the tensors' device. The twiddle,
permutation and coset tables are precomputed on the host once per domain
size and moved to each device once.

`root_of_unity`, `COSET_GEN` and the host `Domain` are the JAX module's
setup-time helpers (pure Python ints), carried here so that the port's
generator needs no JAX.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.bn254 import FR_TWO_ADIC_ROOT, NLIMBS, R, TWO_ADICITY
from ..fields.host import fr_batch_inv, fr_inv

from ..fields import torch_field as tf
from ..fields.cuda_field import mont_mul

BASE = 256


def root_of_unity(n: int) -> int:
    assert n & (n - 1) == 0 and n <= (1 << TWO_ADICITY)
    return pow(FR_TWO_ADIC_ROOT, (1 << TWO_ADICITY) // n, R)


def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    rev = np.zeros(n, dtype=np.int64)
    for i in range(n):
        b = 0
        x = i
        for _ in range(bits):
            b = (b << 1) | (x & 1)
            x >>= 1
        rev[i] = b
    return rev


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mont_mul(tf.FR, a.contiguous(), b.contiguous())


class _BasePlan:
    def __init__(self, n: int, omega: int):
        self.n = n
        self.perm = _bitrev_perm(n)
        self.stage_tw = []
        m = 1
        while m < n:
            w = pow(omega, n // (2 * m), R)  # primitive 2m-th root
            self.stage_tw.append(tf.FR.pack([pow(w, j, R) for j in range(m)]))
            m *= 2
        self._dev = {}

    def consts(self, device: str) -> dict:
        """The permutation and twiddle tables as tensors on one device."""
        if device not in self._dev:
            self._dev[device] = {
                "perm": torch.from_numpy(self.perm).to(device),
                "tw": [tf.tensor(t, device) for t in self.stage_tw],
            }
        return self._dev[device]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        batch = tuple(x.shape[:-2])
        k = self.consts(str(x.device))
        x = x.index_select(-2, k["perm"])
        m = 1
        while m < n:
            twj = k["tw"][m.bit_length() - 1]
            x = x.reshape(batch + (n // (2 * m), 2, m, NLIMBS))
            e = x[..., 0, :, :]
            o = _mul(x[..., 1, :, :], twj)
            x = torch.stack([tf.add(tf.FR, e, o), tf.sub(tf.FR, e, o)], dim=-3)
            x = x.reshape(batch + (n, NLIMBS))
            m *= 2
        return x


class _SplitPlan:
    def __init__(self, n: int, omega: int):
        self.n = n
        bits = n.bit_length() - 1
        n1 = 1 << ((bits + 1) // 2)
        n2 = n // n1
        self.n1, self.n2 = n1, n2
        self.sub1 = _make_plan(n1, pow(omega, n2, R))
        self.sub2 = _make_plan(n2, pow(omega, n1, R))
        # cross twiddles: tw[k1, j2] = omega^{k1*j2}
        flat = []
        for k1 in range(n1):
            wk = pow(omega, k1, R)
            cur = 1
            for _ in range(n2):
                flat.append(cur)
                cur = cur * wk % R
        self.cross = tf.FR.pack(flat).reshape(n1, n2, NLIMBS)
        self._dev = {}

    def consts(self, device: str) -> torch.Tensor:
        """The cross twiddles as a tensor on one device."""
        if device not in self._dev:
            self._dev[device] = tf.tensor(self.cross, device)
        return self._dev[device]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        n1, n2 = self.n1, self.n2
        batch = tuple(x.shape[:-2])
        x = x.reshape(batch + (n1, n2, NLIMBS))
        # column NTTs (size n1, batched over n2)
        a = self.sub1.apply(x.transpose(-3, -2))  # (..., n2, n1, 16)
        a = a.reshape(batch + (n2, n1, NLIMBS)).transpose(-3, -2)  # (..., n1, n2, 16)
        t = _mul(a, self.consts(str(x.device)))
        b = self.sub2.apply(t).reshape(batch + (n1, n2, NLIMBS))  # row NTTs over n2
        return b.transpose(-3, -2).reshape(batch + (self.n, NLIMBS))  # X[k1 + n1*k2] = B[k1,k2]


@functools.lru_cache(maxsize=None)
def _make_plan(n: int, omega: int):
    return _BasePlan(n, omega) if n <= BASE else _SplitPlan(n, omega)


@functools.lru_cache(maxsize=None)
def _inv_scale(n: int, device: str) -> torch.Tensor:
    return tf.tensor(tf.FR.pack([fr_inv(n)])[0], device)


@functools.lru_cache(maxsize=None)
def _coset_pows(n: int, g: int, inverse: bool, device: str) -> torch.Tensor:
    gg = fr_inv(g) if inverse else g
    pows = [1] * n
    cur = 1
    for i in range(n):
        pows[i] = cur
        cur = cur * gg % R
    return tf.tensor(tf.FR.pack(pows), device)


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward/inverse NTT over the size-n subgroup domain; natural order."""
    n = x.shape[-2]
    omega = root_of_unity(n)
    if inverse:
        omega = fr_inv(omega)
    out = _make_plan(n, omega).apply(x)
    if inverse:
        out = _mul(out, _inv_scale(n, str(x.device)))
    return out


# Default coset generator (any element outside the 2^28 subgroup works)
COSET_GEN = 5


def coset_ntt(x: torch.Tensor, g: int = COSET_GEN) -> torch.Tensor:
    """Evaluations of the polynomial (coeff form x) over the coset g*H."""
    n = x.shape[-2]
    return ntt(_mul(x, _coset_pows(n, g, False, str(x.device))))


def coset_intt(x: torch.Tensor, g: int = COSET_GEN) -> torch.Tensor:
    n = x.shape[-2]
    return _mul(ntt(x, inverse=True), _coset_pows(n, g, True, str(x.device)))


# ---------------------------------------------------------------------------
# Host-side domain utilities (setup-time polynomial algebra), as in the JAX
# module
# ---------------------------------------------------------------------------


class Domain:
    """Host-side multiplicative subgroup domain of size n (power of two)."""

    def __init__(self, n: int):
        size = 1
        while size < n:
            size <<= 1
        self.n = size
        self.omega = root_of_unity(size)
        self.omega_inv = fr_inv(self.omega)

    def vanishing_at(self, t: int) -> int:
        return (pow(t, self.n, R) - 1) % R

    def lagrange_coeffs_at(self, t: int) -> list:
        """[L_i(t)] for all i: Z(t) * w^i / (n * (t - w^i)) — batch-inverted."""
        z = self.vanishing_at(t)
        pows = [1] * self.n
        for i in range(1, self.n):
            pows[i] = pows[i - 1] * self.omega % R
        denoms = [(t - w) % R for w in pows]
        if any(d == 0 for d in denoms):
            # t in the domain: L_i(t) = delta_{t == w^i}
            return [1 if d == 0 else 0 for d in denoms]
        invs = fr_batch_inv(denoms)
        ninv = fr_inv(self.n)
        return [z * w % R * inv % R * ninv % R for w, inv in zip(pows, invs)]

    def elements(self) -> list:
        pows = [1] * self.n
        for i in range(1, self.n):
            pows[i] = pows[i - 1] * self.omega % R
        return pows
