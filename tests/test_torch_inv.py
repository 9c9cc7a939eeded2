"""The port's modular inversion (csrc/field.cu::fermat_inv_kernel, Bernstein-
Yang divsteps) and batch_inv's root width, on the CPU.

A model of the kernel's word steps in numpy, lane-parallel, with the
kernel's own integer widths (uint32 divsteps on the low words; int32 signed
30-bit limbs with int64 sums in the matrix updates; the words <-> limbs
conversions by the kernel's shift formulas), is held exactly to pow(x,
p - 2, p) in Montgomery form and to the JAX package's jf.mont_inv (eager,
numpy in and out) for BN254 Fq, Fr and BLS12-381 Fq, on seeded values and
chip_smoke.py's edge lanes. It also checks the invariants the kernel rests
on (every batch's matrix within +-2^30 with |u| + |v| <= 2^30, the low 30
bits of each update zero, every limb in range and every sum inside int64,
g = 0 and |f| = 1 at the end, d in (-2p, p)), that the fixed count is at
least Bernstein and Yang's bound for the bit length, and that field.cu
holds the constants the model computes. The kernel itself runs on the card
(chip_smoke.py, benches/torch_aff_ab.py).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hekaton_tpu.fields import jax_field as jf
from hekaton_tpu.fields.bls12_381 import P as P381
from hekaton_tpu_torch.fields import cuda_field as cf
from hekaton_tpu_torch.fields import torch_field as tf

torch.set_num_threads(1)

FIELD_CU = Path(__file__).resolve().parents[1] / "hekaton_tpu_torch" / "csrc" / "field.cu"
M30 = (1 << 30) - 1
I32 = (-(1 << 31), (1 << 31) - 1)
SHAPES = chip_smoke.INV_SHAPES  # words -> (limbs, batches of 30 divsteps), as field.cu's InvShape
FIELDS = [(tf.FQ, jf.FQ, 0), (tf.FR, jf.FR, 1), (tf.FQ_BLS, jf.FieldSpec(P381, "fq_bls381", nlimbs=24), 2)]
IDS = ["fq", "fr", "fq_bls381"]


def by_bound(bits: int) -> int:
    """Bernstein-Yang, Theorem 11.2: divsteps that take (f, g), f odd and
    0 <= g < f < 2^bits, to g = 0, from delta = 1 (bits >= 46)."""
    return (49 * bits + 57) // 17


def s30(x: int, L: int) -> list:
    return [(x >> (30 * i)) & M30 for i in range(L - 1)] + [x >> (30 * (L - 1))]


def in_range(a, lo, hi) -> bool:
    return bool(((a >= lo) & (a <= hi)).all())


def to_s30(w, L: int):
    """(n, NW) uint32 words -> (n, L) int64 limbs (field.cu::to_s30)."""
    nw = w.shape[1]
    out = np.zeros((w.shape[0], L), dtype=np.int64)
    for k in range(L):
        j, s = 30 * k // 32, 30 * k % 32
        x = w[:, j] >> np.uint32(s)
        if s > 2 and j + 1 < nw:
            x = x | (w[:, j + 1] << np.uint32(32 - s))
        out[:, k] = x & np.uint32(M30)
    return out


def from_s30(r, nw: int):
    """(n, L) limbs, canonical -> (n, NW) uint32 words (field.cu::from_s30)."""
    L = r.shape[1]
    u = r.astype(np.uint32)
    out = np.zeros((r.shape[0], nw), dtype=np.uint32)
    for j in range(nw):
        k, s = 32 * j // 30, 32 * j % 30
        x = u[:, k] >> np.uint32(s)
        if k + 1 < L:
            x = x | (u[:, k + 1] << np.uint32(30 - s))
        if k + 2 < L and s > 28:
            x = x | (u[:, k + 2] << np.uint32(60 - s))
        out[:, j] = x
    return out


def divsteps_30(delta, f, g):
    """30 branch-free divsteps on uint32 low words (field.cu::divsteps_30):
    a swap (delta > 0, g odd) takes (delta, f, g, u, v, q, r) to (-delta, g,
    -f, q, r, -u, -v); then an odd g adds f to g (u, v to q, r); then g
    halves, u and v double and delta grows by 1."""
    n = f.shape[0]
    u, v, q, r = (np.full(n, x, dtype=np.uint32) for x in (1, 0, 0, 1))
    f, g = f.copy(), g.copy()
    f0, g0 = f.copy(), g.copy()
    zero = np.uint32(0)
    for s in range(30):
        odd = (g & np.uint32(1)) == 1
        swap = odd & (delta > 0)
        fs, us, vs = f, u, v
        f, u, v = np.where(swap, g, f), np.where(swap, q, u), np.where(swap, r, v)
        g, q, r = np.where(swap, zero - fs, g), np.where(swap, zero - us, q), np.where(swap, zero - vs, r)
        delta = np.where(swap, -delta, delta)
        g, q, r = np.where(odd, g + f, g), np.where(odd, q + u, q), np.where(odd, r + v, r)
        g = g >> np.uint32(1)
        u = u << np.uint32(1)
        v = v << np.uint32(1)
        delta = delta + np.int32(1)
        assert (f & np.uint32(1)).all()  # f stays odd
        # the matrix tracks the steps: u f0 + v g0 = 2^(s+1) f (mod 2^32)
        assert ((u * f0 + v * g0) == (f << np.uint32(s + 1))).all()
        assert ((q * f0 + r * g0) == (g << np.uint32(s + 1))).all()
    t = [a.view(np.int32).astype(np.int64) for a in (u, v, q, r)]
    uu, vv, qq, rr = t
    assert (np.abs(uu) + np.abs(vv) <= 1 << 30).all() and (np.abs(qq) + np.abs(rr) <= 1 << 30).all()
    return delta, t


def update_fg(f, g, t):
    u, v, q, r = t
    L = f.shape[1]
    cf_ = u * f[:, 0] + v * g[:, 0]
    cg = q * f[:, 0] + r * g[:, 0]
    assert not (cf_ & M30).any() and not (cg & M30).any()
    cf_ >>= 30
    cg >>= 30
    for k in range(1, L):
        cf_ = cf_ + u * f[:, k] + v * g[:, k]
        cg = cg + q * f[:, k] + r * g[:, k]
        assert in_range(np.abs(cf_), 0, 1 << 62) and in_range(np.abs(cg), 0, 1 << 62)
        f[:, k - 1] = cf_ & M30
        cf_ >>= 30
        g[:, k - 1] = cg & M30
        cg >>= 30
    assert in_range(cf_, *I32) and in_range(cg, *I32)  # (int32_t)cf keeps the value
    f[:, L - 1] = cf_
    g[:, L - 1] = cg


def update_de(d, e, t, p30, pinv):
    u, v, q, r = t
    L = d.shape[1]
    sd, se = d[:, L - 1] >> 31, e[:, L - 1] >> 31
    md, me = (u & sd) + (v & se), (q & sd) + (r & se)
    cd = u * d[:, 0] + v * e[:, 0]
    ce = q * d[:, 0] + r * e[:, 0]
    md = md - ((pinv * (cd & 0xFFFFFFFF) + (md & 0xFFFFFFFF)) & M30)
    me = me - ((pinv * (ce & 0xFFFFFFFF) + (me & 0xFFFFFFFF)) & M30)
    assert in_range(md, *I32) and in_range(me, *I32)
    cd = cd + p30[0] * md
    ce = ce + p30[0] * me
    assert not (cd & M30).any() and not (ce & M30).any()
    cd >>= 30
    ce >>= 30
    for k in range(1, L):
        cd = cd + u * d[:, k] + v * e[:, k] + p30[k] * md
        ce = ce + q * d[:, k] + r * e[:, k] + p30[k] * me
        assert in_range(np.abs(cd), 0, 1 << 62) and in_range(np.abs(ce), 0, 1 << 62)
        d[:, k - 1] = cd & M30
        cd >>= 30
        e[:, k - 1] = ce & M30
        ce >>= 30
    assert in_range(cd, *I32) and in_range(ce, *I32)
    d[:, L - 1] = cd
    e[:, L - 1] = ce


def carry30(r):
    for k in range(r.shape[1] - 1):
        r[:, k + 1] += r[:, k] >> 30
        r[:, k] &= M30


def normalize(r, sign, p30):
    add, neg = r[:, -1:] >> 31, sign[:, None] >> 31
    r[:] = ((r + (p30 & add)) ^ neg) - neg
    carry30(r)
    r += p30 & (r[:, -1:] >> 31)
    carry30(r)


def value(r) -> list:
    """(n, L) signed 30-bit limbs -> Python ints."""
    weights = np.array([1 << (30 * i) for i in range(r.shape[1])], dtype=object)
    return list((r.astype(object) * weights).sum(axis=1))


def model_inv(spec, limbs):
    """The kernel's steps on (n, 2 NW) Montgomery limbs; returns the (n, 2
    NW) limbs of the inverses and the (f, g, d) of the last batch."""
    p, nw = spec.modulus, spec.nlimbs // 2
    L, batches = SHAPES[nw]
    p30 = np.array(s30(p, L), dtype=np.int64)
    r2 = np.array(s30(spec.mont_r ** 2 % p, L), dtype=np.int64)
    pinv = pow(p, -1, 1 << 30)
    lw = limbs.astype(np.uint32)
    words = lw[:, 0::2] | (lw[:, 1::2] << np.uint32(16))
    n = words.shape[0]
    g = to_s30(words, L)
    f = np.tile(p30, (n, 1))
    d = np.zeros((n, L), dtype=np.int64)
    e = np.tile(r2, (n, 1))
    delta = np.ones(n, dtype=np.int32)
    for _ in range(batches):
        delta, t = divsteps_30(delta, f[:, 0].astype(np.uint32), g[:, 0].astype(np.uint32))
        update_de(d, e, t, p30, pinv)
        update_fg(f, g, t)
        for a in (f, g, d, e):  # limbs 0..L-2 in [0, 2^30), the top one an int32
            assert in_range(a[:, :-1], 0, M30) and in_range(a[:, -1], *I32)
        assert all(-2 * p < x < p for x in value(d) + value(e))
    fin = (f.copy(), g.copy(), d.copy())
    normalize(d, f[:, -1], p30)
    out = from_s30(d, nw)
    limbs_out = np.stack([out & np.uint32(0xFFFF), out >> np.uint32(16)], axis=-1).reshape(n, 2 * nw)
    return limbs_out.astype(np.int32), fin


def cu_array(name: str) -> list:
    """The rows of a __constant__ array of field.cu, as lists of ints."""
    src = FIELD_CU.read_text()
    body = re.search(name + r"(?:\[\d+\])+ = \{(.*?)\};", src, re.S).group(1)
    rows = re.findall(r"\{([^{}]*)\}", body) or [body]
    return [[int(x, 16) for x in re.findall(r"0x[0-9a-f]+", row)] for row in rows]


def seeded(p: int, n: int, seed: int) -> list:
    rs = np.random.RandomState(seed)
    return [int.from_bytes(rs.bytes(48), "little") % p for _ in range(n)]


@pytest.mark.parametrize("spec,jspec,fid", FIELDS, ids=IDS)
def test_divstep_model_equals_pow_and_jax(spec, jspec, fid):
    p = spec.modulus
    nw = spec.nlimbs // 2
    L, batches = SHAPES[nw]
    # the fixed count covers the proven bound for the bit length
    assert 30 * batches >= by_bound(p.bit_length())
    # field.cu's constants are the model's
    assert cu_array("INV_P30")[fid][:L] == s30(p, L)
    assert cu_array("INV_R2_30")[fid][:L] == s30(spec.mont_r ** 2 % p, L)
    assert cu_array("INV_PINV30")[0][fid] == pow(p, -1, 1 << 30)
    src = FIELD_CU.read_text()
    assert f"L = Field<F>::NW == 8 ? {SHAPES[8][0]} : {SHAPES[12][0]}" in src
    assert f"BATCHES = Field<F>::NW == 8 ? {SHAPES[8][1]} : {SHAPES[12][1]}" in src

    edges = chip_smoke.inv_edge_values(spec)
    assert {0, 1, pow(spec.mont_r, -1, p)} <= set(edges)  # 0, the Montgomery one, the raw word 1
    vals = edges + seeded(p, 2000, 11 + fid)
    got, (f, g, d) = model_inv(spec, spec.pack(vals))
    # the steps end at g = 0 and f = +-1 (f = p for x = 0, where d stays 0)
    fv, gv = value(f), value(g)
    assert all(x == 0 for x in gv)
    assert all(abs(x) == 1 if v else (x == p and dv == 0) for x, v, dv in zip(fv, vals, value(d)))
    exp = spec.pack([pow(v, p - 2, p) for v in vals])
    assert np.array_equal(got, exp)
    # the JAX package's Fermat inversion on 96 of these lanes: the first 32
    # edge values, the first 32 raw-word edges and 32 seeded values (eagerly
    # on XLA:CPU it takes ~2.5 ms a lane at 16 limbs, ~6 at 24)
    half = len(edges) // 2
    sub = edges[:32] + edges[half : half + 32] + seeded(p, 32, 31 + fid)
    jgot = np.asarray(jf.mont_inv(jspec, jnp.asarray(jspec.pack(sub))))
    assert np.array_equal(model_inv(spec, spec.pack(sub))[0], jgot)


@pytest.mark.parametrize("spec", [tf.FQ, tf.FQ_BLS], ids=["fq", "fq_bls381"])
def test_batch_inv_same_limbs_at_every_root_width(spec):
    """_batch_inv on the plain multiply gives mont_inv's limbs whatever the
    root width: a tree to 1, 4 or 16 lanes (odd lengths padded to a multiple
    of 2^levels), or at a width of at least the lanes (inverted directly,
    unpadded)."""
    p = spec.modulus
    calls = []

    def root(s, x):  # the root lanes' inverses, on the host
        calls.append(x.shape[0])
        return tf.tensor(s.pack([pow(v, p - 2, p) for v in s.unpack(x)]), "cpu")

    for m in (1, 5, 13, 33):
        vals = [v or 1 for v in seeded(p, m, 40 + m)]
        a = tf.tensor(spec.pack(vals), "cpu")
        exp = tf.tensor(spec.pack([pow(v, p - 2, p) for v in vals]), "cpu")
        for stop in (1, 4, 16, m, m + 7):
            calls.clear()
            got = tf._batch_inv(spec, a, tf.mont_mul, root, stop)
            assert torch.equal(got, exp), (m, stop)
            if m <= stop:
                assert calls == [m]
            else:  # the tree stops at the first level of at most `stop` lanes
                assert len(calls) == 1 and stop / 2 < calls[0] <= stop
    nz = tf.tensor(spec.pack([v or 1 for v in seeded(p, 12, 9)]), "cpu").reshape(3, 4, spec.nlimbs)
    assert torch.equal(tf.batch_inv_plain(spec, nz), cf.fermat_inv(spec, nz))  # on the CPU: mont_inv
    assert tf.batch_inv_plain(spec, nz[:0]).shape == (0, 4, spec.nlimbs)
