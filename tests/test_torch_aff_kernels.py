"""Models of the port's carry-chain field arithmetic and of the affine
kernel pairs' fold schedules, on the CPU.

csrc/field.cuh computes every product on PTX carry chains: `mac_row` adds a
row s*v (v of N words) as two chains (v's even words, then its odd words one
word up) with the carries owed to the row's top word handed on; `fe_mul` is
the whole 2 NW-word product (`mac_wide`) then its reduction (`redc_wide`:
NW rows m*p, then one conditional subtraction, `reduce_once`); `fe_sqr`
adds each cross product a_i a_j (i < j) once (`sqr_rows`), doubles the sum
on one chain and adds the squares a_i^2 on another. The model below repeats
those instructions word for word in Python ints with a carry flag, and is
held exactly to the plain Montgomery product (`tf.mont_mul` on CPU tensors)
and to a b R^-1 mod p on the host, at 8 words (BN254 Fq, Fr) and 12
(BLS12-381 Fq), on edge values (0, 1, p-1, values near R) and seeded ones;
it also checks the ranges the kernels rest on (no carry out of 2 NW words,
every reduced word cleared, a reduction below 2p, no carry out of the
doubling).

csrc/curve.cu's affine pairs give every add its 1/den by Montgomery's
trick in two levels: each thread's chain of dens (K_ADD strided lanes of
an add; a slab column's pairs in a halves round, in the bit-reversed chain
order `chain_pair`), then a butterfly across the 32 chains of a warp
(`warp_fold`), whose root batch_inv inverts; the finish unfolds. The halves
step kernel also builds the next round's chains as its pairs complete. The
models below run those schedules on host values, with ragged last warps
and doubling, inverse-pair, infinity and degenerate lanes, and hold every
1/den to `tf.batch_inv_plain` and the sums to the plain versions
(cuda_curve.aff_add_fused_plain, l1_aff_halves_plain); every add of both
models, its den and its sum from the model's 1/den, is also held to the
JAX package's formulas of the same adds (pallas_curve._aff_prep_tiles and
_aff_fin_tiles, the bodies of its affine kernels), run eagerly. The
kernels run on the card (chip_smoke.py, benches/torch_aff_ab.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hekaton_tpu.curves import pallas_curve as jpc
from hekaton_tpu_torch import cuda_lib
from hekaton_tpu_torch import host as h
from hekaton_tpu_torch.curves import cuda_curve as cc
from hekaton_tpu_torch.curves.torch_curve import G1
from hekaton_tpu_torch.fields import torch_field as tf

torch.set_num_threads(1)

MASK = (1 << 32) - 1
FIELDS = [tf.FQ, tf.FR, tf.FQ_BLS]
IDS = ["fq", "fr", "fq_bls381"]


class Chain:
    """The carry flag and the instructions of field.cuh's `ptx::`."""

    def __init__(self):
        self.cc = 0

    def _set(self, s: int) -> int:
        self.cc = s >> 32
        return s & MASK

    def add_cc(self, a, b):
        return self._set(a + b)

    def addc_cc(self, a, b):
        return self._set(a + b + self.cc)

    def addc(self, a, b):
        return (a + b + self.cc) & MASK

    def _borrow(self, s: int) -> int:
        self.cc = int(s < 0)
        return s & MASK

    def sub_cc(self, a, b):
        return self._borrow(a - b)

    def subc_cc(self, a, b):
        return self._borrow(a - b - self.cc)

    def subc(self, a, b):
        return (a - b - self.cc) & MASK

    def mad_lo_cc(self, a, b, c):
        return self._set((a * b & MASK) + c)

    def madc_lo_cc(self, a, b, c):
        return self._set((a * b & MASK) + c + self.cc)

    def madc_hi_cc(self, a, b, c):
        return self._set((a * b >> 32) + c + self.cc)


class Words:
    """field.cuh's functions over NW words of the field `spec`."""

    def __init__(self, spec):
        self.p = spec.modulus
        self.nw = spec.nlimbs // 2
        self.pw = self.words(self.p)
        self.ninv = -pow(self.p, -1, 1 << 32) % (1 << 32)
        self.x = Chain()

    def words(self, v: int) -> list:
        return [(v >> (32 * i)) & MASK for i in range(self.nw)]

    def mac_row(self, T: list, o: int, v: list, s: int, e_in: int) -> int:
        """T[o..o+N] += s v + e_in 2^(32 N) (field.cuh::mac_row<N>); returns
        the carries owed to word o+N+1."""
        x, N = self.x, len(v)
        T[o] = x.mad_lo_cc(v[0], s, T[o])
        T[o + 1] = x.madc_hi_cc(v[0], s, T[o + 1])
        for j in range(2, N, 2):
            T[o + j] = x.madc_lo_cc(v[j], s, T[o + j])
            T[o + j + 1] = x.madc_hi_cc(v[j], s, T[o + j + 1])
        if N % 2 == 0:
            T[o + N] = x.addc_cc(T[o + N], e_in)
        e1 = x.addc(0, 0)
        if N == 1:
            T[o + 1] = x.add_cc(T[o + 1], e_in)
        else:
            T[o + 1] = x.mad_lo_cc(v[1], s, T[o + 1])
            T[o + 2] = x.madc_hi_cc(v[1], s, T[o + 2])
            for j in range(3, N, 2):
                T[o + j] = x.madc_lo_cc(v[j], s, T[o + j])
                T[o + j + 1] = x.madc_hi_cc(v[j], s, T[o + j + 1])
            if N % 2 == 1:
                T[o + N] = x.addc_cc(T[o + N], e_in)
        e_out = x.addc(e1, 0)
        assert e_out <= 2
        return e_out

    def reduce_once(self, t: list, top: int) -> int:
        x = self.x
        d = [x.sub_cc(t[0], self.pw[0])] + [x.subc_cc(t[i], self.pw[i]) for i in range(1, self.nw)]
        ge = x.subc(top, 0) != MASK
        return sum(w << (32 * i) for i, w in enumerate(d if ge else t))

    def redc_wide(self, T: list) -> int:
        e = 0
        for i in range(self.nw):
            e = self.mac_row(T, i, self.pw, T[i] * self.ninv & MASK, e)
            assert T[i] == 0, "a reduction row left its word"
        t = sum(w << (32 * i) for i, w in enumerate(T[self.nw:])) + (e << (32 * self.nw))
        assert t < 2 * self.p, "a reduction above 2p"
        return self.reduce_once(T[self.nw:], e)

    def mul(self, a: int, b: int) -> int:
        """fe_mul: mac_wide, then redc_wide."""
        aw, bw, T, e = self.words(a), self.words(b), [0] * (2 * self.nw), 0
        for i in range(self.nw):
            e = self.mac_row(T, i, bw, aw[i], e)
        assert e == 0, "the product left 2 NW words"
        return self.redc_wide(T)

    def sqr(self, a: int) -> int:
        """fe_sqr: sqr_rows, the doubling chain, the diagonal chain, redc_wide."""
        x, nw, aw = self.x, self.nw, self.words(a)
        T, e = [0] * (2 * nw), 0
        for i in range(nw - 1):
            e = self.mac_row(T, 2 * i + 1, aw[i + 1:], aw[i], e)
        T[2 * nw - 1] = e
        T[1] = x.add_cc(T[1], T[1])
        for k in range(2, 2 * nw - 1):
            T[k] = x.addc_cc(T[k], T[k])
        assert T[2 * nw - 1] < 1 << 31, "the doubling carries out of 2 NW words"
        T[2 * nw - 1] = x.addc(T[2 * nw - 1], T[2 * nw - 1])
        T[0] = x.mad_lo_cc(aw[0], aw[0], T[0])
        T[1] = x.madc_hi_cc(aw[0], aw[0], T[1])
        for i in range(1, nw):
            T[2 * i] = x.madc_lo_cc(aw[i], aw[i], T[2 * i])
            T[2 * i + 1] = x.madc_hi_cc(aw[i], aw[i], T[2 * i + 1])
        assert x.cc == 0, "the square left 2 NW words"
        return self.redc_wide(T)

    def add(self, a: int, b: int) -> int:
        x, aw, bw = self.x, self.words(a), self.words(b)
        t = [x.add_cc(aw[0], bw[0])] + [x.addc_cc(aw[i], bw[i]) for i in range(1, self.nw)]
        return self.reduce_once(t, x.addc(0, 0))

    def sub(self, a: int, b: int) -> int:
        x, aw, bw = self.x, self.words(a), self.words(b)
        d = [x.sub_cc(aw[0], bw[0])] + [x.subc_cc(aw[i], bw[i]) for i in range(1, self.nw)]
        mask = x.subc(0, 0)
        d[0] = x.add_cc(d[0], self.pw[0] & mask)
        for i in range(1, self.nw):
            d[i] = x.addc_cc(d[i], self.pw[i] & mask)
        return sum(w << (32 * i) for i, w in enumerate(d))


def edge_values(spec) -> list:
    """0, 1, p-1, p-2, and values near R = 2^(32 NW) and its powers mod p."""
    p, R = spec.modulus, 1 << (16 * spec.nlimbs)
    return [0, 1, 2, p - 1, p - 2, R % p, (R - 1) % p, (R + 1) % p, (R >> 1) % p, R * R % p, (p - 1) // 2,
            (1 << (16 * spec.nlimbs - 32)) % p]


@pytest.mark.parametrize("spec", FIELDS, ids=IDS)
def test_carry_chain_product_and_square(spec):
    p, model = spec.modulus, Words(spec)
    rinv = pow(1 << (16 * spec.nlimbs), -1, p)
    rs = np.random.RandomState(91)
    vals = edge_values(spec) + [int.from_bytes(rs.bytes(8 * spec.nlimbs // 2), "little") % p for _ in range(24)]
    pairs = [(a, b) for a in vals for b in vals]
    got = [model.mul(a, b) for a, b in pairs]
    assert got == [a * b * rinv % p for a, b in pairs]
    A = tf.tensor(spec.pack([a for a, _ in pairs], mont=False), "cpu")
    B = tf.tensor(spec.pack([b for _, b in pairs], mont=False), "cpu")
    assert spec.unpack(tf.mont_mul(spec, A, B).numpy(), mont=False) == got
    sq = [model.sqr(a) for a in vals]
    assert sq == [model.mul(a, a) for a in vals] == [a * a * rinv % p for a in vals]
    assert [model.add(a, b) for a, b in pairs] == [(a + b) % p for a, b in pairs]
    assert [model.sub(a, b) for a, b in pairs] == [(a - b) % p for a, b in pairs]


# -- the fold schedules, on host values in Montgomery form --

P = tf.FQ.modulus
R = 1 << 256
ONE = R % P  # Montgomery one
RINV = pow(R, -1, P)


def mont(a: int, b: int) -> int:
    """fe_mul's function (test_carry_chain_product_and_square)."""
    return a * b * RINV % P


def den_num(p, q):
    """curve.cu::aff_flags / den_of / aff_num on (x, y) Montgomery values,
    (0, 0) infinity: (den, num, flags)."""
    (x1, y1), (x2, y2) = p, q
    q_inf, p_inf = y2 == 0, y1 == 0
    dx, dy = (x2 - x1) % P, (y2 - y1) % P
    same_x = dx == 0
    dbl = same_x and dy == 0
    den = 2 * y1 % P if dbl else dx
    if q_inf or p_inf or (same_x and not dbl):
        den = ONE
    num = 3 * mont(x1, x1) % P if dbl else dy
    return den, num, (q_inf, p_inf, same_x, dbl)


def aff_sum(p, q, inv, num, flags):
    """curve.cu::aff_sum."""
    q_inf, p_inf, same_x, dbl = flags
    (x1, y1), (x2, y2) = p, q
    lam = mont(num, inv)
    x3 = (mont(lam, lam) - x1 - (x1 if dbl else x2)) % P
    r = (x3, (mont(lam, (x1 - x3) % P) - y1) % P)
    if same_x and not dbl and not (p_inf or q_inf):
        r = (0, 0)
    if q_inf:
        r = p
    if p_inf:
        r = q
    return r


def warp_fold(ends: list) -> tuple:
    """curve.cu::warp_fold over the chains' ends, in warps of 32 (a ragged
    last warp padded with ones, as its spare threads hold): (each chain's
    `others`, each warp's root)."""
    others, roots = [], []
    for w in range(0, len(ends), 32):
        g = ends[w:w + 32] + [ONE] * (32 - len(ends[w:w + 32]))
        oth = [None] * 32
        for d in (1, 2, 4, 8, 16):
            q = [g[t ^ d] for t in range(32)]
            oth = q if d == 1 else [mont(o, v) for o, v in zip(oth, q)]
            g = [mont(a, v) for a, v in zip(g, q)]
        assert len(set(g)) == 1, "the warp's lanes disagree on its root"
        others += oth[:len(ends[w:w + 32])]
        roots.append(g[0])
    return others, roots


def inverted(roots: list) -> list:
    """batch_inv of the warp roots, as the wrappers call it."""
    t = tf.tensor(tf.FQ.pack(roots, mont=False), "cpu")
    return tf.FQ.unpack(tf.batch_inv(tf.FQ, t).numpy(), mont=False)


def plain_invs(dens: list) -> list:
    t = tf.tensor(tf.FQ.pack(dens, mont=False), "cpu")
    return tf.FQ.unpack(tf.batch_inv_plain(tf.FQ, t).numpy(), mont=False)


@pytest.fixture(scope="module")
def points():
    """2,048 G1 points (x, y) in Montgomery form, and their limb rows."""
    pts = chip_smoke.chain_points(2048, 0x1234567, 0x89abcd, h)
    mont_pts = [(x * R % P, y * R % P) for x, y in pts]
    ax, ay = (torch.from_numpy(a) for a in G1.pack_affine(pts))
    return mont_pts, ax, ay


def edge_pairs(pts: list, n: int) -> list:
    """n pairs P_i + P_(n+i) with chip_smoke.aff_edge_lanes' edges: doubling
    (0-63), inverse pairs (64-127), inf + Q, P + inf, inf + inf; then two
    lanes with the same x (an inverse pair again, on the last warp)."""
    pairs = [(pts[i], pts[n + i]) for i in range(n)]
    for i in range(min(n, 320)):
        p, q = pairs[i]
        if i < 64:
            q = p
        elif i < 128:
            q = (p[0], (P - p[1]) % P)
        elif i < 192:
            p = (0, 0)
        elif i < 256:
            q = (0, 0)
        else:
            p = q = (0, 0)
        pairs[i] = (p, q)
    pairs[-1] = (pairs[-1][0], (pairs[-1][0][0], (P - pairs[-1][0][1]) % P))
    return pairs


JAX_W = 1024  # the lanes of every eager JAX call: each new shape compiles every primitive again


def jax_adds(adds: list) -> list:
    """(den, sum) of each add (p, q, inv) by the JAX package's tile formulas
    (_aff_prep_tiles, then _aff_fin_tiles on inv), run eagerly on (16,
    JAX_W) tiles whose spare lanes add infinity to infinity."""
    assert len(adds) <= JAX_W
    adds = adds + [((0, 0), (0, 0), ONE)] * (JAX_W - len(adds))

    def tile(vals):
        return jnp.asarray(np.ascontiguousarray(tf.FQ.pack(vals, mont=False).astype(np.uint32).T))

    def vals(t):
        return tf.FQ.unpack(np.asarray(t).T, mont=False)

    x1, y1, x2, y2, inv = (tile(v) for v in zip(*((p[0], p[1], q[0], q[1], i) for p, q, i in adds)))
    p_col = jnp.asarray(jpc._P_ARR)
    den, num = jpc._aff_prep_tiles(x1, y1, x2, y2, p_col)
    x3, y3 = jpc._aff_fin_tiles(x1, y1, x2, y2, inv, num, p_col)
    return list(zip(vals(den), zip(vals(x3), vals(y3))))


def aff_pair_model(pairs: list, k: int) -> tuple:
    """aff_root_kernel / batch_inv / aff_fin_kernel on `pairs` at k lanes a
    chain: chain t of lanes j*nthreads + t, the warp fold, the walk back.
    Returns each lane's (den, num, flags), 1/den and sum."""
    n = len(pairs)
    nthreads = (n + k - 1) // k
    lanes = [[j * nthreads + t for j in range(k) if j * nthreads + t < n] for t in range(nthreads)]
    dens = [den_num(p, q) for p, q in pairs]
    pre, ends = [], []
    for chain in lanes:
        acc, pc = ONE, []
        for j, lane in enumerate(chain):
            acc = dens[lane][0] if j == 0 else mont(acc, dens[lane][0])
            pc.append(acc)
        pre.append(pc)
        ends.append(acc)
    others, roots = warp_fold(ends)
    rinv = inverted(roots)
    invs, sums = [None] * n, [None] * n
    for t, chain in enumerate(lanes):
        inv_run = mont(rinv[t >> 5], others[t])
        for j in range(len(chain) - 1, -1, -1):
            lane = chain[j]
            den, num, flags = dens[lane]
            invs[lane] = mont(inv_run, pre[t][j - 1]) if j > 0 else inv_run
            sums[lane] = aff_sum(*pairs[lane], invs[lane], num, flags)
            inv_run = mont(inv_run, den)
    return dens, invs, sums


@pytest.mark.parametrize("n,k", [(700, 8), (700, 3), (333, 1), (45, 16), (1, 8)])
def test_aff_pair_fold_schedule(points, n, k):
    """Every lane of the aff pair's schedule gets its 1/den, and its sum is
    aff_add_fused_plain's."""
    pts, ax, ay = points
    pairs = edge_pairs(pts, n) if n > 1 else [(pts[0], pts[1])]
    dens, invs, sums = aff_pair_model(pairs, k)
    assert invs == plain_invs([d for d, _, _ in dens])
    x1, y1, x2, y2 = (tf.tensor(tf.FQ.pack([pq[s][c] for pq in pairs], mont=False), "cpu")
                      for s, c in ((0, 0), (0, 1), (1, 0), (1, 1)))
    ox, oy = cc.aff_add_fused_plain(x1, y1, x2, y2)
    assert sums == list(zip(tf.FQ.unpack(ox.numpy(), mont=False), tf.FQ.unpack(oy.numpy(), mont=False)))


def chain_pair(p: int, k: int, flip: bool) -> int:
    """curve.cu::chain_pair: p, or k-1-p when flip, bit-reversed over log2 k bits."""
    q, bits = (k - 1 - p if flip else p), k.bit_length() - 1
    return int(format(q, f"0{bits}b")[::-1], 2) if bits else 0


def halves_model(cols: list, L: int) -> tuple:
    """halves_root_kernel, then for each round batch_inv of the warp roots
    and halves_step_kernel, on columns of L points: (the column sums, every
    add's (P, Q, den, 1/den, sum))."""
    ncols, k, flip = len(cols), L // 2, False
    chains = []  # per column: [(pair index, den)] in chain order
    for col in cols:
        chains.append([(chain_pair(p, k, flip), den_num(col[chain_pair(p, k, flip)], col[k + chain_pair(p, k, flip)])[0])
                       for p in range(k)])
    checked = []
    while True:
        ends, pres = [], []
        for ch in chains:
            acc, pc = ONE, []
            for p, (_, den) in enumerate(ch):
                acc = den if p == 0 else mont(acc, den)
                pc.append(acc)
            ends.append(acc)
            pres.append(pc)
        others, roots = warp_fold(ends)
        rinv = inverted(roots)
        nxt_cols, nxt_chains = [], []
        for c, col in enumerate(cols):
            inv_run = mont(rinv[c >> 5], others[c])
            out, held, nxt = [None] * k, None, []
            for p in range(k - 1, -1, -1):
                i = chain_pair(p, k, flip)
                assert chains[c][p][0] == i, "a chain position holds another pair than the kernel reads"
                a, b = col[i], col[k + i]
                den, num, flags = den_num(a, b)
                inv = mont(inv_run, pres[c][p - 1]) if p > 0 else inv_run
                out[i] = aff_sum(a, b, inv, num, flags)
                checked.append((a, b, den, inv, out[i]))
                inv_run = mont(inv_run, den)
                if k > 1 and p % 2 == 1:
                    held = (i, out[i])
                elif k > 1:
                    j_hi, s_hi = held
                    assert abs(j_hi - i) == k // 2
                    lo, hi = (held[1], out[i]) if flip else (out[i], held[1])
                    assert (i < j_hi) != flip, "the lower pair is not where the kernel takes it"
                    nxt.append((min(i, j_hi), den_num(lo, hi)[0]))
            nxt_cols.append(out)
            nxt_chains.append(nxt)
        if k == 1:
            return [col[0] for col in nxt_cols], checked
        cols, chains, k, flip = nxt_cols, nxt_chains, k // 2, not flip
        for ch in chains:  # the next kernel reads the pair chain_pair(g) at position g
            assert [j for j, _ in ch] == [chain_pair(g, k, flip) for g in range(k)]


@pytest.mark.parametrize("ncols,L", [(70, 8), (33, 32), (40, 2), (65, 4)])
def test_halves_fold_schedule(points, ncols, L):
    """Every add of every round gets its 1/den, and the columns' sums equal
    l1_aff_halves_plain, with a ragged last warp and doubling, inverse-pair,
    infinity and all-equal columns."""
    pts, ax, ay = points
    rs = np.random.RandomState(ncols * L)
    idx = rs.randint(0, len(pts), size=(ncols, L))
    cols = [[pts[i] for i in row] for row in idx]
    h2 = L // 2
    cols[0][h2:] = cols[0][:h2]  # doubling pairs in round 1
    cols[1][h2:] = [(x, (P - y) % P) for x, y in cols[1][:h2]]  # inverse pairs
    cols[2][::2] = [(0, 0)] * len(cols[2][::2])  # infinity rows
    cols[3] = [cols[3][0]] * L  # one point L times: doublings every round
    cols[4] = [(0, 0)] * L
    sums, checked = halves_model(cols, L)
    assert [inv for _, _, _, inv, _ in checked] == plain_invs([den for _, _, den, _, _ in checked])
    xs = tf.tensor(tf.FQ.pack([pt[0] for col in cols for pt in col], mont=False), "cpu")
    ys = tf.tensor(tf.FQ.pack([pt[1] for col in cols for pt in col], mont=False), "cpu")
    rows = cc.AffineOps.pack_rows(cc.Aff(xs, ys)).reshape(ncols, L * 16)
    ref = cc.AffineOps.unpack_rows(cc.l1_aff_halves_plain(rows, L))
    assert sums == list(zip(tf.FQ.unpack(ref.x.numpy(), mont=False), tf.FQ.unpack(ref.y.numpy(), mont=False)))


def test_aff_pair_model_matches_jax(points):
    """Each lane of the aff pair's model at 700 edge lanes (k=4): its den
    and its sum from the model's 1/den are the JAX package's."""
    pts, _, _ = points
    pairs = edge_pairs(pts, 700)
    dens, invs, sums = aff_pair_model(pairs, 4)
    got = jax_adds([(p, q, inv) for (p, q), inv in zip(pairs, invs)])
    assert got[:700] == [(d, s) for (d, _, _), s in zip(dens, sums)]


def test_halves_model_matches_jax(points):
    """Every add of every round of the halves model on 40 columns of 8
    points (round 1's doubling, inverse-pair and infinity columns): its den
    and its sum from the model's 1/den are the JAX package's."""
    pts, _, _ = points
    rs = np.random.RandomState(7)
    cols = [[pts[i] for i in row] for row in rs.randint(0, len(pts), size=(40, 8))]
    cols[0][4:] = cols[0][:4]
    cols[1][4:] = [(x, (P - y) % P) for x, y in cols[1][:4]]
    cols[2][::2] = [(0, 0)] * 4
    cols[3] = [cols[3][0]] * 8
    _, checked = halves_model(cols, 8)
    assert len(checked) == 40 * 7
    got = jax_adds([(a, b, inv) for a, b, _, inv, _ in checked])
    assert got[:len(checked)] == [(den, s) for _, _, den, _, s in checked]


def test_aligned_copies_only_views_off_the_16_byte_grid():
    """cuda_lib.aligned, which the wrappers of the kernels with 16-byte row
    loads call: an aligned tensor as it is, a view one word into its
    storage as an aligned copy."""
    t = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    assert cuda_lib.aligned(t) is t
    odd = torch.empty(65, dtype=torch.int32)[1:].view(4, 16)
    odd.copy_(t)
    assert odd.data_ptr() % 16 != 0
    got = cuda_lib.aligned(odd)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
