"""Compute backends for CP-Groth16: host (Python ints) and torch (the port's
device path).

Copy of hekaton_tpu/cpgroth16/backend.py's host side (`_host_ntt`,
`witness_map_host`, `HostBackend`, unchanged apart from imports), plus
`TorchBackend`, which takes the place of the JAX package's TpuBackend and
runs every curve operation and witness map on its device.
The protocol layer is backend-agnostic: MSMs, fixed-base scalar-muls, and
the QAP witness map route through a Backend.
"""
from __future__ import annotations

import math

import torch

from ..curves import host as ch
from ..fields.bn254 import R
from ..fields.host import fr_inv

from ..ntt.ntt import COSET_GEN, root_of_unity
from ..curves.torch_curve import G1, G2, Jac
from .data_structures import PointVec


def _host_ntt(vals: list, invert: bool = False) -> list:
    """Iterative radix-2 NTT over Fr with Python ints (host ground truth)."""
    n = len(vals)
    assert n & (n - 1) == 0
    om = root_of_unity(n)
    if invert:
        om = fr_inv(om)
    a = list(vals)
    # bit-reverse
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wlen = pow(om, n // length, R)
        for i in range(0, n, length):
            w = 1
            for k in range(i, i + length // 2):
                u, v = a[k], a[k + length // 2] * w % R
                a[k] = (u + v) % R
                a[k + length // 2] = (u - v) % R
                w = w * wlen % R
        length <<= 1
    if invert:
        ninv = fr_inv(n)
        a = [x * ninv % R for x in a]
    return a


def witness_map_host(a_evals: list, b_evals: list, c_evals: list) -> list:
    """h coefficients of (A*B - C)/Z over the coset, host ints."""
    m = len(a_evals)
    g = COSET_GEN
    gpows = [1] * m
    for i in range(1, m):
        gpows[i] = gpows[i - 1] * g % R

    def coset_evals(evals):
        coeffs = _host_ntt(evals, invert=True)
        return _host_ntt([c * gp % R for c, gp in zip(coeffs, gpows)])

    ca, cb, cc = coset_evals(a_evals), coset_evals(b_evals), coset_evals(c_evals)
    zinv = fr_inv((pow(g, m, R) - 1) % R)
    q = [(x * y - z) * zinv % R for x, y, z in zip(ca, cb, cc)]
    hc = _host_ntt(q, invert=True)
    ginv = fr_inv(g)
    gipows = [1] * m
    for i in range(1, m):
        gipows[i] = gipows[i - 1] * ginv % R
    h = [c * gp % R for c, gp in zip(hc, gipows)]
    return h[: m - 1]


class HostBackend:
    name = "host"

    def __init__(self):
        self._tables = {}

    def msm(self, vec: PointVec, scalars: list) -> object:
        return ch.msm_host(vec.points[: len(scalars)], scalars)

    def fixed_base(self, base, scalars: list, g2: bool = False) -> list:
        """Windowed-table batch scalar-mul (8-bit windows, Jacobian)."""
        try:
            from ..native import accel, available

            if available():
                return accel.mul_batch([base] * len(scalars), scalars)
        except Exception:
            pass
        key = base if not g2 else (base[0], base[1])
        if key not in self._tables:
            tbl = []
            cur = base
            for _ in range(32):
                row = [None]
                acc = None
                for _ in range(255):
                    acc = ch._jac_add(acc, (cur[0], cur[1], 1 if not g2 else type(cur[0]).one()))
                    row.append(acc)
                tbl.append(row)
                for _ in range(8):
                    cur = ch.pt_dbl(cur)
            self._tables[key] = tbl
        tbl = self._tables[key]
        out = []
        for s in scalars:
            s %= ch.R
            acc = None
            for j in range(32):
                d = (s >> (8 * j)) & 0xFF
                if d:
                    acc = ch._jac_add(acc, tbl[j][d])
            out.append(ch._jac_to_affine(acc))
        return out

    def witness_map(self, a_evals, b_evals, c_evals) -> list:
        return witness_map_host(a_evals, b_evals, c_evals)


def device_msm(curve, ax, ay, scalars, nbits: int | None = None) -> tuple:
    """MSMs of n points on the tensors' device, routed by n: scalars (n, 16),
    or (B, n, 16) for B MSMs of equal length, with points to match. The
    compact msm/pippenger.py::msm with TorchBackend.compact_window(n) below
    COMPACT_PAD (the B MSMs as one batched call), else msm_gpu with
    TorchBackend.msm_params(n), one MSM after another. Returns (route,
    Jacobian point with the leading axes), route "compact" or "gpu".
    TorchBackend.msm and the mesh's local MSMs (runtime/spmd.py) both route
    through it."""
    from ..msm import pippenger as pip

    lead, n = scalars.shape[:-2], scalars.shape[-2]
    c = TorchBackend.compact_window(n)
    if c is not None:
        return "compact", pip.msm(curve, ax, ay, scalars, c=c, nbits=nbits)
    c, L = TorchBackend.msm_params(n)
    ax, ay, scalars = (a.reshape((-1,) + a.shape[len(lead):]) for a in (ax, ay, scalars))
    outs = [pip.msm_gpu(x, y, s, c=c, L=L, nbits=nbits, curve=curve) for x, y, s in zip(ax, ay, scalars)]
    return "gpu", Jac(*(torch.stack(t).reshape(lead + t[0].shape) for t in zip(*outs)))


def witness_map_device(evals: torch.Tensor) -> torch.Tensor:
    """h = (A*B - C)/Z over the coset on the tensor's device: evals
    [3, ..., m, 16] holds the evaluations of A, B and C (Montgomery limbs,
    any batch axes between) -> h [..., m, 16], Montgomery limbs. One NTT
    call for the three vectors; its Montgomery multiplies are the mont_mul
    kernel on a CUDA device. TorchBackend.witness_map and the mesh's
    prover step (runtime/spmd.py) both run it."""
    from ..fields import torch_field as tf
    from ..fields.cuda_field import mont_mul
    from ..ntt import ntt as nttm

    m = evals.shape[-2]
    zinv = tf.tensor(tf.FR.pack([fr_inv((pow(COSET_GEN, m, R) - 1) % R)])[0], evals.device)
    ca, cb, cc = nttm.coset_ntt(nttm.ntt(evals, inverse=True))
    q = mont_mul(tf.FR, tf.sub(tf.FR, mont_mul(tf.FR, ca.contiguous(), cb.contiguous()), cc).contiguous(), zinv)
    return nttm.coset_intt(q)


class TorchBackend:
    """The port's backend: every MSM, fixed-base batch and witness map on
    `device`; no route runs on the host.

    - `msm` routes as the JAX TpuBackend does, by the length n of the MSM
      padded as TpuBackend pads it, m = next_pow2(max(n, 4)) (`device_msm`,
      the one rule that the mesh's local MSMs share): below
      COMPACT_PAD = 4,096 (n <= 2,048) it runs the compact
      msm/pippenger.py::msm on the curve's Jacobian group law (G1: the dbl,
      add and madd kernels), with the window width `msm` derives from m;
      otherwise msm/pippenger.py::msm_gpu, in chunks of G1_CHUNK / G2_CHUNK
      points whose partial sums are folded on the host (the JAX
      TpuBackend's chunking; its G2 chunk of 2^18 was a TPU memory limit,
      and a 2^20-point G2 chunk's ~3 GB slab fits the card). Nothing is
      padded: nothing here compiles per shape.
    - msm_gpu's window width c and column length L come from the chunk
      length n by a fixed rule (`msm_params`): with lg = ceil(log2(n)),
      c = min(13, max(4, lg - 5)), and L = 32 from 2^12 points on, else
      L = 8. Each bucket then receives about 2^(lg - c + 1) = 64 points per
      window, and from 2^18 points on c = 13, L = 32, the JAX defaults. At
      2^16 points c = 11: c = 13 would leave most slab slots padding. Below
      2^12 points (a short last chunk) the slab is small and a bucket's pads
      (L/2 on average) are the larger cost: L = 8 runs a 1K-point G1 MSM
      ~20% faster than L = 32 on the plain CPU path.
    - The packed scalars of one list are cached (A, B-G1, B-G2 share z).
    - `fixed_base` runs msm/pippenger.py::fixed_base_msm and
      to_affine_device on `device` in chunks of FB_CHUNK scalars (each
      padded to at least 4 lanes), with the 32 x 256 window table of each
      base built on the host once and cached on the device (TpuBackend's
      fixed_base).
    - `witness_map` runs the port's NTT on `device`; its Montgomery
      multiplies are the mont_mul kernel on a CUDA device.

    `ran` counts the calls by route.
    """

    name = "torch"
    COMPACT_PAD = 1 << 12
    G1_CHUNK = 1 << 20
    G2_CHUNK = 1 << 20
    FB_CHUNK = 1 << 18

    def __init__(self, device):
        self.device = torch.device(device)
        self._sc_cache = None
        self._fb_tables = {}
        self.ran = {"g1_msm_compact": 0, "g2_msm_compact": 0, "g1_msm_gpu": 0, "g2_msm_gpu": 0,
                    "fixed_base_gpu": 0, "witness_map_gpu": 0}

    @staticmethod
    def msm_params(n: int) -> tuple:
        """(c, L) of msm_gpu for an n-point chunk (rule in the class
        docstring); the last chunk of a long MSM may be short."""
        lg = max(1, math.ceil(math.log2(max(n, 2))))
        return min(13, max(4, lg - 5)), (32 if n >= 1 << 12 else 8)

    @classmethod
    def compact_window(cls, n: int):
        """The compact msm's window width for an n-point MSM, derived from
        TpuBackend's padded length m = next_pow2(max(n, 4)) as the JAX msm
        derives it, or None where m reaches COMPACT_PAD (msm_gpu's route)."""
        m = 1 << max(2, (n - 1).bit_length())
        return max(2, min(13, m.bit_length() - 4)) if m < cls.COMPACT_PAD else None

    def msm(self, vec: PointVec, scalars: list) -> object:
        n = len(scalars)
        if n == 0:
            return None
        chunk = self.G1_CHUNK if vec.curve.name == "g1" else self.G2_CHUNK
        if n <= chunk:
            ax, ay = vec.device_chunk(0, n, n, self.device)
            route, out = device_msm(vec.curve, ax, ay, self._packed_scalars(scalars, 0, n, vec.curve))
            self.ran[f"{vec.curve.name}_msm_{route}"] += 1
            return self._unpack(vec, out)
        acc = None
        for lo in range(0, n, chunk):
            acc = ch.pt_add(acc, self._msm_chunk(vec, scalars, lo, min(lo + chunk, n)))
        return acc

    def _packed_scalars(self, scalars: list, lo: int, hi: int, curve) -> torch.Tensor:
        """Pack+transfer scalars[lo:hi] modulo `curve`'s r once per scalar
        list: the Groth16 A / B-G1 / B-G2 MSMs run over the same assignment
        z, so the packed chunks are cached keyed on list identity (a strong
        ref to the list keeps the identity stable until the next list
        arrives) and the scalar field."""
        from ..msm.pippenger import pack_scalars

        if self._sc_cache is None or self._sc_cache[0] is not scalars:
            self._sc_cache = (scalars, {})
        cache = self._sc_cache[1]
        key = (curve.scalar.name, lo, hi)
        if key not in cache:
            cache[key] = pack_scalars(scalars[lo:hi], curve).to(self.device)
        return cache[key]

    def _unpack(self, vec: PointVec, out):
        return vec.curve.unpack_jacobian(type(out)(*(a[None] for a in out)))[0]

    def _msm_chunk(self, vec: PointVec, scalars: list, lo: int, hi: int):
        from ..msm.pippenger import msm_gpu

        ax, ay = vec.device_chunk(lo, hi, hi - lo, self.device)
        c, L = self.msm_params(hi - lo)
        out = msm_gpu(ax, ay, self._packed_scalars(scalars, lo, hi, vec.curve), c=c, L=L)
        self.ran[f"{vec.curve.name}_msm_gpu"] += 1
        return self._unpack(vec, out)

    def fixed_base(self, base, scalars: list, g2: bool = False) -> list:
        from ..msm.pippenger import fixed_base_msm, fixed_base_table_host, pack_scalars, to_affine_device

        curve = G2 if g2 else G1
        key = (curve.name, base)
        if key not in self._fb_tables:
            tx, ty = fixed_base_table_host(base, curve)
            self._fb_tables[key] = (torch.from_numpy(tx).to(self.device), torch.from_numpy(ty).to(self.device))
        table = self._fb_tables[key]
        out = []
        for lo in range(0, len(scalars), self.FB_CHUNK):
            part = scalars[lo : lo + self.FB_CHUNK]
            sc = pack_scalars(list(part) + [0] * (4 - len(part)), curve).to(self.device)
            ax, ay = to_affine_device(curve, fixed_base_msm(curve, table, sc))
            out.extend(curve.unpack_affine(ax, ay)[: len(part)])
        self.ran["fixed_base_gpu"] += 1
        return out

    def witness_map(self, a_evals, b_evals, c_evals) -> list:
        from ..fields import torch_field as tf

        m = len(a_evals)
        evals = tf.tensor(tf.FR.pack(list(a_evals) + list(b_evals) + list(c_evals)), self.device)
        h = witness_map_device(evals.reshape(3, m, 16))
        self.ran["witness_map_gpu"] += 1
        return tf.FR.unpack(h)[: m - 1]


DEFAULT_BACKEND = HostBackend()
