"""Batched multi-limb Montgomery field arithmetic on torch tensors.

Port of hekaton_tpu/fields/jax_field.py. Field elements are `(..., nlimbs)`
`torch.int32` tensors holding little-endian 16-bit limbs in Montgomery form
(radix R = 2^(16 nlimbs)), the JAX package's layout: 16 limbs (R = 2^256) on
BN254's Fq and Fr, 24 (R = 2^384) on BLS12-381's Fq (`FQ_BLS`); Fq2 =
Fq[u]/(u^2+1) elements are `(..., 2, 16)` (c0, c1). Every function here is
the plain PyTorch formula: it runs on whatever device its tensors are on,
computes in int64 and returns int32 limbs. The CUDA kernels
(fields/cuda_field.py) compute the same canonical values on 32-bit words;
since R is the same power of two either way, the two agree bit for bit.

`batch_inv` is the one function that dispatches: on CUDA tensors it goes
through the inversion kernel's wrapper in cuda_field.py, as the JAX version
reaches the Pallas kernels on a TPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import bls12_381 as bls
from .bn254 import LIMB_BITS, LIMB_MASK, NLIMBS, P, R, from_limbs, to_limbs
from ..utils.timing import count

M16 = LIMB_MASK


class FieldSpec:
    """Static per-modulus data: limb-encoded modulus and Montgomery constants
    (jax_field.FieldSpec, with int32 numpy arrays)."""

    def __init__(self, modulus: int, name: str, nlimbs: int = NLIMBS):
        self.modulus = modulus
        self.name = name
        self.nlimbs = nlimbs
        self.mont_r = 1 << (LIMB_BITS * nlimbs)
        self.r_mod = self.mont_r % modulus
        self.r2_mod = (self.mont_r * self.mont_r) % modulus
        self.ninv = (-pow(modulus, -1, self.mont_r)) % self.mont_r
        self.p_limbs = np.array(to_limbs(modulus, nlimbs), dtype=np.int32)
        self.ninv_limbs = np.array(to_limbs(self.ninv, nlimbs), dtype=np.int32)
        self.one_mont = np.array(to_limbs(self.r_mod, nlimbs), dtype=np.int32)
        # 2^(16*nlimbs) - p: adding it is subtracting p modulo the limb width
        self.p_comp_limbs = np.array(to_limbs(self.mont_r - modulus, nlimbs), dtype=np.int32)

    @property
    def mont_rinv(self) -> int:
        inv = getattr(self, "_mont_rinv", None)
        if inv is None:
            inv = self._mont_rinv = pow(self.mont_r, -1, self.modulus)
        return inv

    def from_mont(self, x: int) -> int:
        return x * self.mont_rinv % self.modulus

    def pack(self, xs, mont: bool = True) -> np.ndarray:
        """ints -> (n, nlimbs) int32 limb array (Montgomery form by default)."""
        m, r = self.modulus, self.mont_r
        nb = self.nlimbs * 2
        if mont:
            buf = b"".join(((x % m) * r % m).to_bytes(nb, "little") for x in xs)
        else:
            buf = b"".join((x % m).to_bytes(nb, "little") for x in xs)
        arr = np.frombuffer(buf, dtype="<u2").astype(np.int32)
        return arr.reshape(len(xs), self.nlimbs)

    def unpack(self, arr, mont: bool = True) -> list:
        """(..., nlimbs) limbs (tensor or array) -> list of ints."""
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(arr).reshape(-1, self.nlimbs))
        if ((arr >> 16) != 0).any() or (arr < 0).any():
            out = []
            for row in arr:
                v = from_limbs(int(x) for x in row)
                out.append(self.from_mont(v) if mont else v % self.modulus)
            return out
        b = arr.astype("<u2").tobytes()
        nb = self.nlimbs * 2
        m = self.modulus
        vals = [int.from_bytes(b[i * nb : (i + 1) * nb], "little") for i in range(arr.shape[0])]
        if mont:
            rinv = self.mont_rinv
            return [v * rinv % m for v in vals]
        return [v % m for v in vals]


FQ = FieldSpec(P, "fq")
FR = FieldSpec(R, "fr")
# BLS12-381: the 381-bit base field takes 24 limbs (jax_curve.py::g1_bls12_381);
# the scalar field fits 16, and packs scalars (mont=False) below its own r
FQ_BLS = FieldSpec(bls.P, "fq_bls381", nlimbs=bls.NLIMBS_FQ)
FR_BLS = FieldSpec(bls.R, "fr_bls381", nlimbs=bls.NLIMBS_FR)


def tensor(arr, device) -> torch.Tensor:
    """numpy limb/word array -> int32 tensor on `device` (uint32 words keep
    their bit pattern)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr.astype(np.int32, copy=False)).to(device)


@functools.lru_cache(maxsize=None)
def _dev_consts(spec: FieldSpec, device: str) -> dict:
    """The spec's limb constants and product matrices as tensors on one
    device (built once per device)."""
    nl = spec.nlimbs
    p = [int(x) for x in spec.p_limbs]
    ninv = [int(x) for x in spec.ninv_limbs]
    # 0/1 map of the flattened (nl, nl) outer product onto 2*nl columns
    cols = np.zeros((nl * nl, 2 * nl))
    # Toeplitz matrices: x @ T gives the product columns of x with a constant
    ninv_lo = np.zeros((nl, nl))
    ninv_hi = np.zeros((nl, nl))
    p_t = np.zeros((nl, 2 * nl))
    for i in range(nl):
        for j in range(nl):
            cols[i * nl + j, i + j] = 1
            p_t[i, i + j] = p[j]
            if i + j < nl:
                ninv_lo[i, i + j] = ninv[j]
            if i + j + 1 < nl:
                ninv_hi[i, i + j + 1] = ninv[j]
    f64 = functools.partial(torch.tensor, dtype=torch.float64, device=device)
    i64 = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    return {
        "cols": f64(cols),
        "ninv_lo": f64(ninv_lo),
        "ninv_hi": f64(ninv_hi),
        "p_t": f64(p_t),
        "low_weight": f64([2.0 ** (16 * (k - nl)) for k in range(nl)]),
        "p": i64(p),
        "p_comp": i64([int(x) for x in spec.p_comp_limbs]),
        "one": torch.tensor([int(x) for x in spec.one_mont], dtype=torch.int32, device=device),
    }


def consts(spec: FieldSpec, device) -> dict:
    return _dev_consts(spec, str(torch.device(device)))


# ---------------------------------------------------------------------------
# limb primitives (int64 columns)
# ---------------------------------------------------------------------------


def _carry(x: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Non-negative int64 columns -> canonical 16-bit limbs of their value
    mod 2^(16W) (callers widen x by one zero column to keep a carry out).

    Each pass moves every column's excess one limb up: columns < 2^(16k+16)
    settle in k passes, which callers pass from their bounds. What is left
    is carries of at most 1 rippling through runs of 0xFFFF limbs (after
    one more pass if any column still exceeds 16 bits), which
    `_ripple_units` resolves at once instead of one pass per limb."""
    for _ in range(passes):
        x = (x & M16) + F.pad(x >> LIMB_BITS, (1, -1))
    hi = x >> LIMB_BITS
    if hi.is_cuda:  # the any() below waits for the device (on the CPU plain versions run this too)
        count("host_syncs")
    if bool(hi.any()):
        x = _ripple_units((x & M16) + F.pad(hi, (1, -1)))
    return x


def _ripple_units(x: torch.Tensor) -> torch.Tensor:
    """Columns <= 0x1FFFE (a 16-bit limb plus a carry of at most 1) ->
    canonical limbs mod 2^(16W), by carry lookahead over bit masks: limb i
    generates a carry when it exceeds 16 bits (its low part is then at most
    0xFFFE) and propagates one when its low part is 0xFFFF, so with G and P
    those bits, the carries into the limbs are the bits of (P + 2G) ^ P."""
    W = x.shape[-1]
    bit = 1 << torch.arange(W, device=x.device)
    low = x & M16
    p = ((low == M16).long() * bit).sum(-1)
    g = ((x >> LIMB_BITS) * bit).sum(-1) << 1
    cin = (((p + g) ^ p).unsqueeze(-1) & bit) != 0
    return (low + cin.long()) & M16


def _broadcast(a, b):
    a = a.long()
    b = b.long()
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    return a, b


# ---------------------------------------------------------------------------
# modular ops
# ---------------------------------------------------------------------------


def _reduce_once(spec: FieldSpec, r: torch.Tensor) -> torch.Tensor:
    """(..., nl + 1) columns holding a value < 2p (canonical limbs plus a
    carry column) -> its canonical residue: adding 2^(16 nl) - p carries
    into the top column iff the value is at least p."""
    nl = spec.nlimbs
    d = _carry(r + F.pad(consts(spec, r.device)["p_comp"], (0, 1)))
    return torch.where((d[..., nl] > 0).unsqueeze(-1), d[..., :nl], r[..., :nl])


def add(spec: FieldSpec, a, b):
    a, b = _broadcast(a, b)
    return _reduce_once(spec, _carry(F.pad(a + b, (0, 1)))).int()


def sub(spec: FieldSpec, a, b):
    a, b = _broadcast(a, b)
    # a + (2^(16 nl) - 1 - b) + 1 carries out iff a >= b; otherwise add p back
    x = F.pad(a + (M16 - b), (0, 1))
    x[..., 0] += 1
    d = _carry(x)
    nl = spec.nlimbs
    fixed = _carry(d[..., :nl] + consts(spec, d.device)["p"])
    return torch.where((d[..., nl] == 0).unsqueeze(-1), fixed, d[..., :nl]).int()


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


_ROW_PRODUCT_LANES = 512


def _product_cols(a, b, k):
    """Raw columns (< nl * 2^32 <= 2^37) of the schoolbook product a*b.
    Narrow batches take one float64 matrix product of the outer product
    (few tensor ops); wide ones accumulate nl shifted rows (less memory
    traffic per lane)."""
    nl = a.shape[-1]
    if a.numel() < _ROW_PRODUCT_LANES * nl:
        outer = (a.double().unsqueeze(-1) * b.double().unsqueeze(-2)).flatten(-2)
        return (outer @ k["cols"]).long()
    t = a.new_zeros(a.shape[:-1] + (2 * nl,))
    for i in range(nl):
        t[..., i : i + nl].addcmul_(a[..., i : i + 1], b)
    return t


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a*b*R^-1 mod p, canonical (separated REDC).

    The product columns t are raw int64 sums (< 2^37 at 24 limbs); m =
    t*ninv mod R is formed from t's low columns split at 16 bits (column
    sums < 2^42, exact); m*p is another exact float64 product. The low half
    of t + m*p is exactly c*R with c < 2^23, read off as its weighted column
    sum (exact in float64 after rounding: the rounding errors of the
    fractional terms stay far below 1/2) instead of rippling carries
    through nl limbs that all end up zero. The same bounds hold at 16 and
    24 limbs."""
    nl = spec.nlimbs
    k = consts(spec, a.device)
    a, b = _broadcast(a, b)
    t = _product_cols(a, b, k)
    low = t[..., :nl]
    mcols = (low & M16).double() @ k["ninv_lo"] + (low >> LIMB_BITS).double() @ k["ninv_hi"]
    m = _carry(mcols.long(), 3)
    s = t + (m.double() @ k["p_t"]).long()
    c = (s[..., :nl].double() @ k["low_weight"]).round().long()
    high = F.pad(s[..., nl:], (0, 1)) + F.pad(c.unsqueeze(-1), (0, nl))
    return _reduce_once(spec, _carry(high, 3)).int()


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def is_zero(spec: FieldSpec, a):
    return (a == 0).all(-1)


def select(cond, a, b):
    """cond: (...,) bool; a, b limb tensors with matching batch dims."""
    extra = a.dim() - cond.dim()
    return torch.where(cond.reshape(cond.shape + (1,) * extra), a, b)


def mont_inv(spec: FieldSpec, a):
    """Batched Fermat inversion a^(p-2) (left-to-right square-and-multiply
    over the public exponent bits); inv(0) = 0."""
    e = spec.modulus - 2
    acc = a
    for i in reversed(range(e.bit_length() - 1)):
        acc = mont_sqr(spec, acc)
        if (e >> i) & 1:
            acc = mont_mul(spec, acc, a)
    return acc


def _batch_inv(spec: FieldSpec, a, mul, root_inv, stop: int):
    """Invert every lane of `a` by a product tree that halves the lanes
    until at most `stop` remain, `root_inv` on those, and the tree walked
    back. The lanes are padded with ones to the least multiple of
    2^levels; at most `stop` lanes are inverted directly, unpadded."""
    shape = a.shape
    nl = spec.nlimbs
    a2 = a.reshape(-1, nl).contiguous()
    M = a2.shape[0]
    if M == 0:
        return a2.reshape(shape)
    if M <= stop:
        return root_inv(spec, a2).reshape(shape)
    k = 1
    while -(-M >> k) > stop:  # ceil(M / 2^k)
        k += 1
    Mp = -(-M >> k) << k
    if Mp > M:
        ones = consts(spec, a.device)["one"].expand(Mp - M, nl)
        a2 = torch.cat([a2, ones])
    levels = []
    cur = a2
    for _ in range(k):
        lo, hi = cur[0::2].contiguous(), cur[1::2].contiguous()
        levels.append((lo, hi))
        cur = mul(spec, lo, hi)
    inv = root_inv(spec, cur)
    for lo, hi in reversed(levels):
        ilo = mul(spec, inv, hi)
        ihi = mul(spec, inv, lo)
        inv = torch.stack([ilo, ihi], dim=1).reshape(2 * lo.shape[0], nl)
    return inv[:M].reshape(shape)


def _host_inv(spec: FieldSpec, root):
    """Invert the one-lane root of a plain tree on the host: the value the
    Fermat formulas give (the canonical inverse), without ~360 dependent
    one-lane products, each a hundred tensor ops."""
    x = spec.unpack(root)[0]
    inv = pow(x, spec.modulus - 2, spec.modulus)
    return tensor(spec.pack([inv]), root.device)


def batch_inv_plain(spec: FieldSpec, a):
    """batch_inv on the plain formulas: the tree runs down to one lane."""
    return _batch_inv(spec, a, mont_mul, _host_inv, 1)


def batch_inv(spec: FieldSpec, a):
    """Simultaneous inversion of a batch (jax_field.batch_inv).

    a: (..., nlimbs) nonzero Montgomery elements; callers mask degenerate
    lanes to 1 first (inv(0) = 0 is not preserved, unlike mont_inv). A CPU
    tensor takes a binary product tree (Montgomery's trick, log-depth form)
    on the plain formulas down to one lane, inverted on the host. A CUDA
    tensor runs no tree: the divstep inversion kernel (cuda_field.fermat_inv)
    inverts every lane, one thread a lane, which beat a mont_mul tree down
    to any root width at every width the main paths invert (chip_smoke.py's
    [batch_inv] sweep over _batch_inv's widths, PERF.md). Both give the
    canonical inverse.
    """
    if not a.is_cuda:
        return batch_inv_plain(spec, a)
    from .cuda_field import fermat_inv

    return fermat_inv(spec, a.contiguous())


class FpOps:
    """Prime-field ops namespace over a FieldSpec (jax_field.make_fp_ops):
    the field adapter the curve layer is templated on. `mul` goes through
    the mont_mul kernel wrapper, so CUDA tensors multiply on the kernel;
    with plain=True it is the plain formula on every device (the reference
    the kernels are held against)."""

    ndim = 1

    def __init__(self, spec: FieldSpec, plain: bool = False):
        self.spec = spec
        self.plain = plain

    def add(self, a, b):
        return add(self.spec, a, b)

    def sub(self, a, b):
        return sub(self.spec, a, b)

    def neg(self, a):
        return neg(self.spec, a)

    def mul(self, a, b):
        if self.plain:
            return mont_mul(self.spec, a, b)
        from .cuda_field import mont_mul as kmul

        a, b = torch.broadcast_tensors(a, b)
        return kmul(self.spec, a.contiguous(), b.contiguous())

    def sqr(self, a):
        return self.mul(a, a)

    def is_zero(self, a):
        return is_zero(self.spec, a)

    @staticmethod
    def select(cond, a, b):
        return select(cond, a, b)

    def zeros(self, batch_shape, device):
        return torch.zeros(tuple(batch_shape) + (self.spec.nlimbs,), dtype=torch.int32, device=device)

    def one(self, batch_shape, device):
        return consts(self.spec, device)["one"].expand(tuple(batch_shape) + (self.spec.nlimbs,))

    def pack(self, vals) -> np.ndarray:
        return self.spec.pack(vals)

    def unpack(self, arr):
        return self.spec.unpack(arr)


FqOps = FpOps(FQ)
FqPlain = FpOps(FQ, plain=True)
FqBlsOps = FpOps(FQ_BLS)  # BLS12-381 Fq: products on the 24-limb mont_mul kernel on CUDA


# ---------------------------------------------------------------------------
# Fq2 = Fq[u]/(u^2+1): shape (..., 2, 16) (jax_field.py:464-497, 582-629)
# ---------------------------------------------------------------------------


class Fq2Field:
    """Fq2 ops namespace, the G2 field adapter. `mul` is Karatsuba over three
    Fq products and `sqr` takes two, stacked into one call of
    `FpOps(FQ, plain)`'s `mul`: the mont_mul kernel on CUDA tensors (one
    launch), or (plain=True) the plain formula on every device. Every
    result is canonical, so the two agree bit for bit."""

    ndim = 2
    spec = FQ

    def __init__(self, plain: bool = False):
        self.fp = FpOps(FQ, plain)

    @staticmethod
    def add(a, b):
        return add(FQ, a, b)  # elementwise over the (2,) component dim

    @staticmethod
    def sub(a, b):
        return sub(FQ, a, b)

    @staticmethod
    def neg(a):
        return neg(FQ, a)

    def mul(self, a, b):
        """c0 = a0 b0 - a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1."""
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        sums = add(FQ, torch.stack([a0, b0]), torch.stack([a1, b1]))  # a0 + a1, b0 + b1
        t0, t1, s = self.fp.mul(torch.stack([a0, a1, sums[0]]), torch.stack([b0, b1, sums[1]]))
        c0, c1 = sub(FQ, torch.stack([t0, sub(FQ, s, t0)]), t1)
        return torch.stack([c0, c1], dim=-2)

    def sqr(self, a):
        """(a0 + a1)(a0 - a1) + 2 a0 a1 u: two Fq products, the same
        canonical values as mul(a, a)."""
        a0, a1 = a[..., 0, :], a[..., 1, :]
        c0, m = self.fp.mul(torch.stack([add(FQ, a0, a1), a0]), torch.stack([sub(FQ, a0, a1), a1]))
        return torch.stack([c0, add(FQ, m, m)], dim=-2)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1).all(-1)

    @staticmethod
    def select(cond, a, b):
        return select(cond, a, b)

    @staticmethod
    def zeros(batch_shape, device):
        return torch.zeros(tuple(batch_shape) + (2, FQ.nlimbs), dtype=torch.int32, device=device)

    @staticmethod
    def one(batch_shape, device):
        one = torch.zeros((2, FQ.nlimbs), dtype=torch.int32, device=device)
        one[0] = consts(FQ, device)["one"]
        return one.expand(tuple(batch_shape) + (2, FQ.nlimbs))

    @staticmethod
    def pack(vals) -> np.ndarray:
        """Host Fq2 values -> (n, 2, 16) int32 Montgomery limbs."""
        return np.stack([FQ.pack([v.c0 for v in vals]), FQ.pack([v.c1 for v in vals])], axis=1)

    @staticmethod
    def unpack(arr) -> list:
        """(..., 2, 16) limbs -> list of host Fq2."""
        from .host import Fq2

        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        arr = np.asarray(arr).reshape(-1, 2, FQ.nlimbs)
        return [Fq2(a, b) for a, b in zip(FQ.unpack(arr[:, 0]), FQ.unpack(arr[:, 1]))]


Fq2Ops = Fq2Field()
Fq2Plain = Fq2Field(plain=True)
