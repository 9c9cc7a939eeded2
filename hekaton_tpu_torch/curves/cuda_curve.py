"""Curve kernels: the G1 MSM's complete batched-affine add (also with a
packed-row operand, and unfused as prep / finish), level-1 halves pairing
(on either slab layout), the tsort plan's slab interleave and the window
Horner fold; its three complete projective ops and projective level 1 (the
accum="proj" and level1="mega" routes); the G1 Jacobian mixed add of the
fixed-base muls; and the G2 MSM's three complete projective Fq2 ops and its
window Horner fold.

Port of the main-path kernels of hekaton_tpu/curves/pallas_curve.py. Source:
csrc/curve.cu (G1 kernels), csrc/curve_g2.cu (G2 kernels), csrc/field.cuh
(Fq and Fq2 device functions).

- `aff_add_fused` replaces `aff_add_fused` (pallas_curve.py:760; kernels
  `_aff_root_kernel` :426 and `_aff_fin_tree_kernel` :442).
- `aff_add_mixed_packed` replaces `aff_add_mixed_packed` (pallas_curve.py:712;
  kernels `_aff_root_packed_kernel` :650 and `_aff_fin_tree_packed_kernel`
  :661): the second operand is a packed slab row. No padding of n.
- `aff_prep` and `aff_fin` replace `aff_prep` and `aff_fin`
  (pallas_curve.py:1305/1310; kernels `_aff_prep_kernel` :957 and
  `_aff_fin_kernel` :963 on `_aff_prep_tiles` :374 / `_aff_fin_tiles` :392).
- `l1_aff_halves` replaces `l1_aff_halves` with tr=False (pallas_curve.py:930;
  kernels `_aff_halves_root_kernel` :802 and `_aff_halves_fin_kernel` :822);
  `l1_aff_halves_t` replaces `l1_aff_halves_t` (:906, the same bodies with
  tr=True) on the transposed (L*16, ncols) slab.
- `interleave_slab_t` replaces `interleave_slab_t` (pallas_curve.py:529;
  kernel `_interleave_slab_t_kernel` :498) on the port's (16, W, L, mcols)
  stack of the 16 word planes; it needs no L % 8 == 0.
- `horner_fold` replaces `horner_fold` (pallas_curve.py:625; kernel
  `_horner_kernel` :583).
- `madd` replaces `madd` (pallas_curve.py:1281; kernel `_madd_kernel`
  :1178 on `_madd_tiles` :164 with the `_dbl_tiles` escape :146).
- `dbl` and `add` replace `dbl` and `add` (pallas_curve.py:1285/1289;
  kernels `_dbl_kernel` :1188 on `_dbl_tiles` :146 and `_add_kernel` :1196
  on `_add_tiles` :210).
- `jac_ladder`, `jac_sum` and `jac_horner` run the JAX compact msm's loops
  of kernels (hekaton_tpu/msm/pippenger.py: `_msm_ladder`'s fori_loop of
  dbl and madd :209, `_tree_reduce`'s in-order chunk adds :159, `msm`'s
  Horner combine of dbl and add :258) in one launch each, on the complete
  projective formulas: their plain versions (`jac_ladder_plain`,
  `jac_sum_plain`, `jac_horner_plain`) give those loops' points, not their
  limbs.
- `pmadd_rcb`, `padd_rcb`, `pdbl_rcb` replace the wrappers of the same names
  (pallas_curve.py:1293/1297/1301; kernels `_pmadd_rcb_kernel` :1206 on
  `_pmadd_rcb_tiles` :264, `_padd_rcb_kernel` :1216, `_pdbl_rcb_kernel`
  :1226). Their interface keeps the JAX shape: (..., 16) int32 Montgomery
  limbs per coordinate.
- `l1_rcb_mega` replaces `l1_rcb_mega` (pallas_curve.py:572; kernel
  `_l1_mega_kernel` :470) on the port's own (ncols, L*16) slab, or with
  transposed=True on JAX's (L*16, ncols) one.
- `pmadd_rcb_g2`, `padd_rcb_g2`, `pdbl_rcb_g2` replace the wrappers of the
  same names (pallas_curve.py:1315/1320/1324; kernels `_pmadd_rcb_g2_kernel`
  :1115, `_padd_rcb_g2_kernel` :1130, `_pdbl_rcb_g2_kernel` :1148, all
  through the one `pallas_call` of `_build` :1250). Their interface keeps
  the JAX shape: (..., 2, 16) int32 Fq2 limbs per coordinate.
- `horner_fold_g2` replaces the G2 MSM's window combine, the fori_loop of
  `proj.dbl` / `proj.add` at hekaton_tpu/msm/pippenger.py:1145-1153 (XLA
  Fq2 formulas at one lane on the TPU), in one launch.

Bounds on an H100 and the design that meets them are in the source note of
csrc/curve.cu: the adds are bound by integer multiply throughput and run as
a root kernel / batch_inv / finish kernel split, a prefix chain a thread and
the chains of a warp folded into one batch_inv root; a halves level 1 is a
root kernel and one step kernel a round, each step finishing a round and
building the next one's chains; every product is field.cuh's carry-chain
one; the Horner folds (`horner_fold`, and `horner_fold_g2` over Fq2, a half
of an Fq2 product a lane) are one warp, bound by the latency of their chain,
each point op two levels of independent products, and so is each lane of
the chain kernels `jac_ladder` and `jac_sum` (a warp a lane) and the one
lane of `jac_horner`.
`madd`, `dbl`, `add` and the G1 RCB ops are one thread per lane,
straight-line formulas, bound by integer multiply throughput or by bytes
once the card is full; the G1 mixed add (`pmadd_rcb`, and each add of
`l1_rcb_mega`), the full add `padd_rcb`, `madd`, `dbl` and `add` run on
lazy sums, each
closing coordinate of the RCB adds (and madd's y3) one sum of two products
and one reduction, their products by product scanning (column by column
into a three-register accumulator), on 16-byte rows, 4 blocks an SM;
`madd` and `add` take their edge overrides as branches before the
arithmetic they make moot, their doubling escape out of line; the G2 trio (`pmadd_rcb_g2`, `padd_rcb_g2`, `pdbl_rcb_g2`) runs two
threads a lane, one Fq2 component each, with its operands in shared memory;
`l1_rcb_mega` is
one thread per slab column, its accumulator in registers for all L adds
(csrc/curve.cu, csrc/curve_g2.cu).
`interleave_slab_t`, `aff_prep` and `aff_fin` are bound by bytes.

Each wrapper takes CPU tensors to its plain PyTorch version (`*_plain`) and
CUDA tensors to its kernels; nothing falls back. The kernels that move rows
16 bytes at a time get rows on 16-byte boundaries: a wrapper copies a view
that does not start on one (`cuda_lib.aligned`). `launches` on each wrapper
counts its kernel launches (one per add, per halves level 1, per fold, per
level-1 slab, per interleave, per batch of point ops, per chain).
"""
from __future__ import annotations

import math

import torch

from .. import cuda_lib
from ..fields import torch_field as tf
from ..fields.cuda_field import check_limbs
from ..fields.torch_field import FQ
from .affine import Aff, AffineOps
from .host import B_G2
from .proj import Proj, ProjOps
from .torch_curve import CurveOps, Jac

K_ADD = 4  # lanes per thread (one prefix chain) in the aff_add kernel pair, chosen on the card (PERF.md)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _aff_flags(x1, y1, px, py):
    q_inf = tf.is_zero(FQ, py)
    p_inf = tf.is_zero(FQ, y1)
    dx = tf.sub(FQ, px, x1)
    dy = tf.sub(FQ, py, y1)
    same_x = tf.is_zero(FQ, dx)
    return q_inf, p_inf, dx, dy, same_x, same_x & tf.is_zero(FQ, dy)


def aff_prep_plain(x1, y1, px, py):
    """(den, num) of the slope of (x1, y1) + (px, py), as
    pallas_curve.py::_aff_prep_tiles: den = px - x1 and num = py - y1, on
    doubling lanes 2*y1 and 3*x1^2; den = 1 where either operand is the
    (0,0) infinity or the pair is inverse, so a batch inversion stays
    defined."""
    q_inf, p_inf, dx, dy, same_x, dbl = _aff_flags(x1, y1, px, py)
    num = dy
    if bool(dbl.any()):  # doubling lanes need 3*x1^2 (as _num_tiles' lax.cond)
        x1sq = tf.mont_mul(FQ, x1, x1)
        num = tf.select(dbl, tf.add(FQ, tf.add(FQ, x1sq, x1sq), x1sq), dy)
    den = tf.select(dbl, tf.add(FQ, y1, y1), dx)
    degen = q_inf | p_inf | (same_x & ~dbl)
    den = tf.select(degen, tf.consts(FQ, den.device)["one"].expand(den.shape), den)
    return den, num


def aff_fin_plain(x1, y1, px, py, inv, num):
    """The complete sum from inv = 1/den and the given num, as
    pallas_curve.py::_aff_fin_tiles: lam = num * inv, x3 = lam^2 - x1 - x2,
    y3 = lam (x1 - x3) - y1; an inverse pair gives (0,0), an infinite
    operand the other one."""
    q_inf, p_inf, dx, dy, same_x, dbl = _aff_flags(x1, y1, px, py)
    lam = tf.mont_mul(FQ, num, inv)
    x2s = tf.select(dbl, x1, px)
    x3 = tf.sub(FQ, tf.sub(FQ, tf.mont_mul(FQ, lam, lam), x1), x2s)
    y3 = tf.sub(FQ, tf.mont_mul(FQ, lam, tf.sub(FQ, x1, x3)), y1)
    inverse = same_x & ~dbl & ~(p_inf | q_inf)
    zero = torch.zeros_like(x3)
    x3 = tf.select(inverse, zero, x3)
    y3 = tf.select(inverse, zero, y3)
    x3 = tf.select(q_inf, x1, x3)
    y3 = tf.select(q_inf, y1, y3)
    x3 = tf.select(p_inf, px, x3)
    y3 = tf.select(p_inf, py, y3)
    return x3, y3


def aff_add_fused_plain(x1, y1, px, py):
    """Complete batched-affine (x1, y1) + (px, py) on the plain formulas
    (curves/affine.py::AffineOps._prep/_fin of the JAX package)."""
    den, num = aff_prep_plain(x1, y1, px, py)
    return aff_fin_plain(x1, y1, px, py, tf.batch_inv_plain(FQ, den), num)


def aff_add_mixed_packed_plain(x1, y1, rows):
    """Complete batched-affine (x1, y1) + the points of the packed rows
    (..., 16) (8 x-words || 8 y-words), on the plain formulas."""
    q = AffineOps.unpack_rows(rows)
    return aff_add_fused_plain(x1, y1, q.x, q.y)


def l1_aff_halves_plain(rows, L: int):
    """(ncols, L*16) packed slab -> (ncols, 16) packed column sums, by
    log2(L) rounds of element i + element l/2+i, on the plain formulas."""
    ncols = rows.shape[0]
    l = L
    while l > 1:
        k = l // 2
        v = rows.reshape(ncols, l, 16)
        a = AffineOps.unpack_rows(v[:, :k])
        b = AffineOps.unpack_rows(v[:, k:])
        rows = AffineOps.pack_rows(Aff(*aff_add_fused_plain(a.x, a.y, b.x, b.y))).reshape(ncols, k * 16)
        l = k
    return rows


def l1_aff_halves_t_plain(slab_t, L: int):
    """l1_aff_halves_plain on the transposed slab: (L*16, ncols), word w of
    column c's element i in row i*16 + w, -> (16, ncols); every round's
    slab is (l*16, ncols)."""
    ncols = slab_t.shape[1]
    l = L
    while l > 1:
        k = l // 2
        v = slab_t.reshape(l, 16, ncols).transpose(1, 2)  # (l, ncols, 16) packed elements
        a = AffineOps.unpack_rows(v[:k])
        b = AffineOps.unpack_rows(v[k:])
        s = AffineOps.pack_rows(Aff(*aff_add_fused_plain(a.x, a.y, b.x, b.y)))
        slab_t = s.transpose(1, 2).reshape(k * 16, ncols)
        l = k
    return slab_t


def interleave_slab_t_plain(planes):
    """(16, W, L, mcols) word planes -> the (L*16, W*mcols) transposed slab,
    slab_t[r*16 + j, w*mcols + m] = planes[j, w, r, m] (the XLA interleave
    of hekaton_tpu/msm/pippenger.py:1062-1066)."""
    _, W, L, mcols = planes.shape
    return planes.permute(2, 0, 1, 3).reshape(L * 16, W * mcols)


_PROJ_G1_PLAIN = ProjOps(tf.FqPlain, 9, "g1_proj_plain")
_PROJ_G2_PLAIN = ProjOps(tf.Fq2Plain, B_G2 * 3, "g2_proj_plain")


def fold_windows(proj, x, y, z, c: int) -> Proj:
    """The window Horner combine on the projective ops `proj`, one op at a
    time on one lane: from window sum W-1 of the (W, ...) coordinates down,
    c doublings and the add of the next window sum a window."""
    W = x.shape[0]
    acc = Proj(x[W - 1], y[W - 1], z[W - 1])
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = proj.dbl(acc)
        acc = proj.add(acc, Proj(x[w], y[w], z[w]))
    return acc


def horner_fold_plain(x, y, z, c: int):
    """(W, 16) projective window sums -> sum_w 2^(c*w) * S_w, MSB window
    first, on the plain complete RCB formulas (curves/proj.py)."""
    return fold_windows(_PROJ_G1_PLAIN, x, y, z, c)


def pmadd_rcb_plain(x, y, z, ax, ay):
    """G1 projective + affine on the plain RCB formulas (curves/proj.py)."""
    return _PROJ_G1_PLAIN.add_mixed(Proj(x, y, z), ax, ay)


def padd_rcb_plain(x1, y1, z1, x2, y2, z2):
    return _PROJ_G1_PLAIN.add(Proj(x1, y1, z1), Proj(x2, y2, z2))


def pdbl_rcb_plain(x, y, z):
    return _PROJ_G1_PLAIN.dbl(Proj(x, y, z))


def l1_rcb_mega_plain(rows, L: int, transposed: bool = False) -> Proj:
    """(ncols, L*16) packed slab, or (transposed) an (L*16, ncols) one ->
    each column's L packed rows added in order into the identity (0:1:0)
    on the plain formulas: projective (x, y, z), each (ncols, 16)."""
    if transposed:
        ncols = rows.shape[1]
        v = rows.reshape(L, 16, ncols).permute(2, 0, 1)
    else:
        ncols = rows.shape[0]
        v = rows.reshape(ncols, L, 16)
    acc = _PROJ_G1_PLAIN.inf((ncols,), rows.device)
    for g in range(L):
        q = AffineOps.unpack_rows(v[:, g])
        acc = _PROJ_G1_PLAIN.add_mixed(acc, q.x, q.y)
    return acc


_G1_PLAIN = CurveOps(tf.FqPlain, "g1_plain", tf.FR)  # its dbl is _dbl_tiles' dbl-2009-l


def pmadd_rcb_g2_plain(x, y, z, ax, ay):
    """G2 projective + affine on the plain RCB formulas (curves/proj.py)."""
    return _PROJ_G2_PLAIN.add_mixed(Proj(x, y, z), ax, ay)


def padd_rcb_g2_plain(x1, y1, z1, x2, y2, z2):
    return _PROJ_G2_PLAIN.add(Proj(x1, y1, z1), Proj(x2, y2, z2))


def pdbl_rcb_g2_plain(x, y, z):
    return _PROJ_G2_PLAIN.dbl(Proj(x, y, z))


def horner_fold_g2_plain(x, y, z, c: int):
    """(W, 2, 16) BN254-G2 projective window sums -> sum_w 2^(c*w) * S_w, MSB
    window first, on the plain complete RCB formulas over Fq2
    (curves/proj.py, b3 = 9/(9+u)): three (2, 16) tensors."""
    return fold_windows(_PROJ_G2_PLAIN, x, y, z, c)


def madd_plain(x1, y1, z1, ax, ay):
    """G1 Jacobian + affine by madd-2007-bl with the edge overrides of
    pallas_curve.py::_madd_tiles, in its order: the doubling escape; an
    inverse pair zeroes only z3; P at infinity gives (ax, ay, 1), or
    (0, 0, 0) when Q is the (0,0) sentinel too; Q at infinity (P finite)
    gives P. The points equal torch_curve.CurveOps.add_mixed's; the limbs of
    infinity lanes need not."""
    f = tf.FqPlain
    q_inf = f.is_zero(ax) & f.is_zero(ay)
    p_inf = f.is_zero(z1)
    (x3, y3, z3), same_x, same_y = _G1_PLAIN.madd_core(Jac(x1, y1, z1), ax, ay)
    zero = torch.zeros_like(z3)
    z3 = f.select(same_x & ~same_y, zero, z3)
    qz = f.select(q_inf, zero, f.one(q_inf.shape, z3.device))
    x3, y3, z3 = f.select(p_inf, ax, x3), f.select(p_inf, ay, y3), f.select(p_inf, qz, z3)
    keep_p = q_inf & ~p_inf
    return Jac(f.select(keep_p, x1, x3), f.select(keep_p, y1, y3), f.select(keep_p, z1, z3))


def dbl_plain(x, y, z):
    """2 * G1 Jacobian (x, y, z) by dbl-2009-l (pallas_curve.py::_dbl_tiles,
    the same formula as torch_curve.CurveOps.dbl)."""
    return _G1_PLAIN.dbl(Jac(x, y, z))


def add_plain(x1, y1, z1, x2, y2, z2):
    """G1 Jacobian P + Q by add-2007-bl with the edge overrides of
    pallas_curve.py::_add_tiles, in its order: the doubling escape; an
    inverse pair zeroes only z3; P at infinity gives Q; Q at infinity (P
    finite) gives P, so two infinite inputs give Q. The points equal
    torch_curve.CurveOps.add's; the limbs of those lanes need not."""
    f = tf.FqPlain
    p_inf = f.is_zero(z1)
    q_inf = f.is_zero(z2)
    (x3, y3, z3), same_x, same_y = _G1_PLAIN.add_core(Jac(x1, y1, z1), Jac(x2, y2, z2))
    z3 = f.select(same_x & ~same_y, torch.zeros_like(z3), z3)
    x3, y3, z3 = f.select(p_inf, x2, x3), f.select(p_inf, y2, y3), f.select(p_inf, z2, z3)
    keep_p = q_inf & ~p_inf
    return Jac(f.select(keep_p, x1, x3), f.select(keep_p, y1, y3), f.select(keep_p, z1, z3))


def _jac_load_plain(x, y, z) -> Proj:
    """The chain kernels' load of Jacobian limbs: (X, Y, Z) -> (X Z : Y :
    Z^3), the identity (0:1:0) where Z = 0 (whatever X and Y are there)."""
    proj, f = _PROJ_G1_PLAIN, tf.FqPlain
    inf = f.is_zero(z)
    return proj.select(inf, proj.inf(inf.shape, z.device), proj.from_jacobian(Jac(x, y, z)))


def _jac_store_plain(acc: Proj) -> Jac:
    """The chain kernels' store: projective -> the port's Jacobian form (X Z,
    Y Z^2, Z), (1, 1, 0) where Z = 0."""
    f = _PROJ_G1_PLAIN.f
    jac = _PROJ_G1_PLAIN.to_jacobian(acc)
    inf = f.is_zero(acc.z)
    one = f.one(inf.shape, acc.z.device)
    return Jac(f.select(inf, one, jac.x), f.select(inf, one, jac.y), jac.z)


def jac_ladder_plain(ax, ay, scalars, nbits: int) -> Jac:
    """Lane i's s_i * P_i for (N, 16) affine limbs ((0,0) = infinity) and
    (N, 16) plain scalar limbs, on the plain complete RCB formulas
    (curves/proj.py, b3 = 9): from the identity (0:1:0), bit j = nbits-1
    down to 0, a doubling, then where bit j is set the mixed add of (ax, ay)
    (a (0,0) lane keeps the accumulator); the projective result in the
    port's Jacobian form (_jac_store_plain)."""
    proj = _PROJ_G1_PLAIN
    s = scalars.long()
    acc = proj.inf((ax.shape[0],), ax.device)
    for j in range(nbits - 1, -1, -1):
        bit = ((s[:, j // 16] >> (j % 16)) & 1) == 1
        acc = proj.dbl(acc)
        acc = proj.select(bit, proj.add_mixed(acc, ax, ay), acc)
    return _jac_store_plain(acc)


def jac_sum_plain(x, y, z) -> Jac:
    """The in-order sum over the leading axis of a (K, ..., 16) Jacobian
    stack on the plain complete RCB formulas: each operand loaded as a
    projective point (_jac_load_plain), added in order into the identity
    (0:1:0), the sum in the Jacobian form (_jac_store_plain)."""
    proj = _PROJ_G1_PLAIN
    ops = _jac_load_plain(x, y, z)
    acc = proj.inf(x.shape[1:-1], x.device)
    for j in range(x.shape[0]):
        acc = proj.add(acc, Proj(*(t[j] for t in ops)))
    return _jac_store_plain(acc)


def jac_horner_plain(x, y, z, c: int) -> Jac:
    """sum_w 2^(c*w) * S_w of (W, ..., 16) Jacobian window sums, each lane on
    its own: the sums loaded as projective points (_jac_load_plain), folded
    by horner_fold_plain, the result in the Jacobian form (_jac_store_plain)."""
    return _jac_store_plain(horner_fold_plain(*_jac_load_plain(x, y, z), c))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_batch(fn, args: tuple, coord_shape: tuple) -> None:
    """Each of `args` a contiguous int32 (..., *coord_shape) tensor on the
    first one's device, of the first one's shape."""
    first = args[0]
    for i, t in enumerate(args):
        check_limbs(f"{fn.__name__} argument {i}", t, first.device)
        if t.shape != first.shape or tuple(t.shape[t.dim() - len(coord_shape):]) != coord_shape:
            raise ValueError(f"{fn.__name__}: argument {i} {tuple(t.shape)} is not (..., "
                             f"{', '.join(map(str, coord_shape))}) of shape {tuple(first.shape)}")


def _launch_point_op(fn, entry: str, args: tuple, coord_shape: tuple, n_out: int = 3):
    """Launch the point-op kernel `entry` on `args`, each a contiguous int32
    (..., *coord_shape) batch of one shape on one device; count the launch
    on the wrapper `fn` and return its `n_out` outputs of that shape."""
    _check_batch(fn, args, coord_shape)
    args = tuple(cuda_lib.aligned(t) for t in args)
    first = args[0]
    n = first.numel() // math.prod(coord_shape)
    outs = tuple(torch.empty_like(first) for _ in range(n_out))
    if n:
        rc = getattr(cuda_lib.lib(), entry)(
            *(t.data_ptr() for t in args), *(o.data_ptr() for o in outs), n,
            cuda_lib.stream_ptr(first.device),
        )
        cuda_lib.check(entry, rc)
        fn.launches += 1
    return outs


def _fold_scratch(nchains: int, k: int, dev) -> tuple:
    """The scratch of k-link chains folded a warp at a time: the planar
    prefixes ((k-1)*8, nchains), each chain's product of the other chains
    of its warp (8, nchains), and one root a warp as limb rows (the
    batch_inv operand)."""
    return (torch.empty(((k - 1) * 8, nchains), dtype=torch.int32, device=dev),
            torch.empty((8, nchains), dtype=torch.int32, device=dev),
            torch.empty(((nchains + 31) // 32, 16), dtype=torch.int32, device=dev))


def _launch_aff_add(fn, entries: tuple, x1, y1, q_args: tuple):
    """The root kernel / batch_inv / finish kernel of one complete batched
    affine add of (x1, y1) and the second operand `q_args` (the limb rows
    px, py, or packed rows): a chain of K_ADD lanes a thread, lanes strided
    by the thread count, the chains folded a warp at a time, so batch_inv
    inverts one root a warp. Counts one launch on the wrapper `fn`."""
    n = x1.numel() // 16
    x1, y1, *q_args = (cuda_lib.aligned(t) for t in (x1, y1, *q_args))
    ox = torch.empty_like(x1)
    oy = torch.empty_like(y1)
    if n == 0:
        return ox, oy
    k = K_ADD
    nthreads = (n + k - 1) // k
    dev = x1.device
    pre, ex, roots = _fold_scratch(nthreads, k, dev)
    lib = cuda_lib.lib()
    ins = (x1.data_ptr(), y1.data_ptr(), *(t.data_ptr() for t in q_args))
    rc = getattr(lib, entries[0])(*ins, pre.data_ptr(), ex.data_ptr(), roots.data_ptr(), n, nthreads, k,
                                  cuda_lib.stream_ptr(dev))
    cuda_lib.check(entries[0], rc)
    rinv = tf.batch_inv(FQ, roots)
    rc = getattr(lib, entries[1])(*ins, pre.data_ptr(), ex.data_ptr(), rinv.data_ptr(), ox.data_ptr(),
                                  oy.data_ptr(), n, nthreads, k, cuda_lib.stream_ptr(dev))
    cuda_lib.check(entries[1], rc)
    fn.launches += 1
    return ox, oy


def aff_add_fused(x1, y1, px, py):
    """Complete batched-affine add on (..., 16) limb tensors of one shape."""
    if not x1.is_cuda:
        return aff_add_fused_plain(x1, y1, px, py)
    _check_batch(aff_add_fused, (x1, y1, px, py), (16,))
    return _launch_aff_add(aff_add_fused, ("hk_aff_root", "hk_aff_fin"), x1, y1, (px, py))


aff_add_fused.launches = 0


def aff_add_mixed_packed(x1, y1, rows):
    """Complete batched-affine (x1, y1) + the points of `rows`: (..., 16)
    limb tensors and (..., 16) packed rows (8 x-words || 8 y-words) of one
    shape."""
    if not x1.is_cuda:
        return aff_add_mixed_packed_plain(x1, y1, rows)
    _check_batch(aff_add_mixed_packed, (x1, y1, rows), (16,))
    return _launch_aff_add(aff_add_mixed_packed, ("hk_aff_root_packed", "hk_aff_fin_packed"), x1, y1, (rows,))


aff_add_mixed_packed.launches = 0


def aff_prep(x1, y1, px, py):
    """(den, num) of the complete batched-affine add, (..., 16) limbs."""
    if not x1.is_cuda:
        return aff_prep_plain(x1, y1, px, py)
    return _launch_point_op(aff_prep, "hk_aff_prep", (x1, y1, px, py), (16,), n_out=2)


aff_prep.launches = 0


def aff_fin(x1, y1, px, py, inv, num):
    """The complete batched-affine sum from inv = 1/den and num, (..., 16)
    limbs."""
    if not x1.is_cuda:
        return aff_fin_plain(x1, y1, px, py, inv, num)
    return _launch_point_op(aff_fin, "hk_aff_finish", (x1, y1, px, py, inv, num), (16,), n_out=2)


aff_fin.launches = 0


def _check_slab(fn, v, shape: tuple) -> None:
    if v.dtype != torch.int32 or tuple(v.shape) != shape:
        raise ValueError(f"{fn.__name__}: expected an int32 {shape} slab, got {v.dtype} {tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{fn.__name__}: expected a contiguous slab")


def _halves_rounds(fn, v, L: int, ncols: int, transposed: bool):
    """The log2(L) halves rounds on the (ncols, L*16) slab, or (transposed)
    the (L*16, ncols) one: a root kernel (round 1's chains), then for each
    round batch_inv of its warp roots and a step kernel, which finishes the
    round and builds the next one's chains; the rounds between keep their
    sums in transposed slabs. One launch on `fn` a call."""
    if L == 1 or ncols == 0:
        return v
    v = cuda_lib.aligned(v)
    dev = v.device
    lib = cuda_lib.lib()
    k = L // 2
    pre, ex, roots = _fold_scratch(ncols, k, dev)
    rc = lib.hk_halves_root(v.data_ptr(), pre.data_ptr(), ex.data_ptr(), roots.data_ptr(), ncols, k,
                            int(transposed), cuda_lib.stream_ptr(dev))
    cuda_lib.check("hk_halves_root", rc)
    src, src_tr, flip = v, transposed, False
    while True:
        rinv = tf.batch_inv(FQ, roots)
        if k == 1:
            out = torch.empty((16, ncols) if transposed else (ncols, 16), dtype=torch.int32, device=dev)
            nxt = (out,) * 3  # not written: no next round
        else:
            out = torch.empty((k * 16, ncols), dtype=torch.int32, device=dev)
            nxt = _fold_scratch(ncols, k // 2, dev)
        rc = lib.hk_halves_step(src.data_ptr(), pre.data_ptr(), ex.data_ptr(), rinv.data_ptr(), out.data_ptr(),
                                *(t.data_ptr() for t in nxt), ncols, k, int(src_tr),
                                int(transposed or k > 1), int(flip), cuda_lib.stream_ptr(dev))
        cuda_lib.check("hk_halves_step", rc)
        if k == 1:
            fn.launches += 1
            return out
        src, src_tr, flip, k = out, True, not flip, k // 2
        pre, ex, roots = nxt


def l1_aff_halves(rows, L: int):
    """MSM level 1: reduce the (ncols, L*16) packed slab of bucket-pure
    columns to one packed affine point per column ((ncols, 16))."""
    if L & (L - 1):
        raise ValueError(f"l1_aff_halves: L={L} is not a power of two")
    if not rows.is_cuda:
        return l1_aff_halves_plain(rows, L)
    _check_slab(l1_aff_halves, rows, (rows.shape[0], L * 16))
    return _halves_rounds(l1_aff_halves, rows, L, rows.shape[0], transposed=False)


l1_aff_halves.launches = 0


def l1_aff_halves_t(slab_t, L: int):
    """l1_aff_halves on the transposed (L*16, ncols) slab of the tsort plan:
    every round reads and writes (l*16, ncols) slabs; returns the (16,
    ncols) packed column sums."""
    if L & (L - 1):
        raise ValueError(f"l1_aff_halves_t: L={L} is not a power of two")
    if not slab_t.is_cuda:
        return l1_aff_halves_t_plain(slab_t, L)
    _check_slab(l1_aff_halves_t, slab_t, (L * 16, slab_t.shape[1]))
    return _halves_rounds(l1_aff_halves_t, slab_t, L, slab_t.shape[1], transposed=True)


l1_aff_halves_t.launches = 0


def interleave_slab_t(planes):
    """The tsort plan's (16, W, L, mcols) word planes -> the (L*16,
    W*mcols) transposed slab (interleave_slab_t_plain)."""
    if not planes.is_cuda:
        return interleave_slab_t_plain(planes)
    if planes.dim() != 4 or planes.shape[0] != 16:
        raise ValueError(f"interleave_slab_t: expected (16, W, L, mcols) planes, got {tuple(planes.shape)}")
    _check_slab(interleave_slab_t, planes, tuple(planes.shape))
    _, W, L, mcols = planes.shape
    if W > 65535 or 16 * L > 65535:
        raise ValueError(f"interleave_slab_t: W={W} or 16*L={16 * L} is out of the grid's range")
    out = torch.empty((L * 16, W * mcols), dtype=torch.int32, device=planes.device)
    if out.numel():
        rc = cuda_lib.lib().hk_interleave_slab_t(planes.data_ptr(), out.data_ptr(), W, L, mcols,
                                                  cuda_lib.stream_ptr(planes.device))
        cuda_lib.check("hk_interleave_slab_t", rc)
        interleave_slab_t.launches += 1
    return out


interleave_slab_t.launches = 0


def horner_max_w() -> int:
    """The most window sums horner_fold's kernel takes (csrc/curve.cu's
    HORNER_MAX_W: the sums in its block's shared memory)."""
    return cuda_lib.lib().hk_horner_max_w()


def horner_fold(x, y, z, c: int):
    """(W, 16) BN254-G1 projective window sums -> the projective point
    sum_w 2^(c*w) * S_w (three (16,) tensors)."""
    if not x.is_cuda:
        return horner_fold_plain(x, y, z, c)
    for name, t in (("x", x), ("y", y), ("z", z)):
        check_limbs(f"horner_fold {name}", t, x.device)
        if t.dim() != 2 or t.shape != x.shape:
            raise ValueError(f"horner_fold: {name} must be (W, 16), got {tuple(t.shape)}")
    W = x.shape[0]
    ox, oy, oz = (torch.empty(16, dtype=torch.int32, device=x.device) for _ in range(3))
    rc = cuda_lib.lib().hk_horner(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), ox.data_ptr(), oy.data_ptr(), oz.data_ptr(),
        W, int(c), cuda_lib.stream_ptr(x.device),
    )
    if rc != 0 and not (1 <= W <= horner_max_w() and c >= 0):
        raise ValueError(f"horner_fold: {W} windows, c={c}; the kernel takes 1 to {horner_max_w()} windows, c >= 0")
    cuda_lib.check("hk_horner", rc)
    horner_fold.launches += 1
    return Proj(ox, oy, oz)


horner_fold.launches = 0


def madd(x, y, z, ax, ay):
    """G1 Jacobian (x, y, z) + affine (ax, ay), (..., 16) limbs, with the
    edge handling of madd_plain."""
    if not x.is_cuda:
        return madd_plain(x, y, z, ax, ay)
    return Jac(*_launch_point_op(madd, "hk_madd", (x, y, z, ax, ay), (16,)))


madd.launches = 0


def dbl(x, y, z):
    """2 * G1 Jacobian (x, y, z), (..., 16) limbs."""
    if not x.is_cuda:
        return dbl_plain(x, y, z)
    return Jac(*_launch_point_op(dbl, "hk_dbl", (x, y, z), (16,)))


dbl.launches = 0


def add(x1, y1, z1, x2, y2, z2):
    """G1 Jacobian P + Q, (..., 16) limbs, with the edge handling of
    add_plain."""
    if not x1.is_cuda:
        return add_plain(x1, y1, z1, x2, y2, z2)
    return Jac(*_launch_point_op(add, "hk_add", (x1, y1, z1, x2, y2, z2), (16,)))


add.launches = 0


def _launch_chain(fn, entry: str, args: tuple, out_shape: tuple, lanes: int, *tail) -> Jac:
    """Launch the chain kernel `entry` on `args` (checked, contiguous int32
    limb tensors on one device), 16-byte aligned, with `tail` after the
    output pointers; count the launch on the wrapper `fn` and return the
    three (out_shape) outputs."""
    args = tuple(cuda_lib.aligned(t) for t in args)
    dev = args[0].device
    outs = tuple(torch.empty(out_shape, dtype=torch.int32, device=dev) for _ in range(3))
    if lanes:
        rc = getattr(cuda_lib.lib(), entry)(*(t.data_ptr() for t in args), *(o.data_ptr() for o in outs), *tail,
                                            cuda_lib.stream_ptr(dev))
        cuda_lib.check(entry, rc)
        fn.launches += 1
    return Jac(*outs)


def jac_ladder(ax, ay, scalars, nbits: int) -> Jac:
    """The compact msm's per-point ladders in one launch, a warp a lane: for
    (N, 16) affine limbs ((0,0) = infinity) and (N, 16) int32 plain scalar
    limbs, lane i's s_i * P_i from its top nbits bits, as (N, 16) Jacobian
    limbs (jac_ladder_plain's, limb for limb)."""
    if not 1 <= nbits <= 256:
        raise ValueError(f"jac_ladder: nbits={nbits} is not in 1..256 (16 limbs of 16 bits)")
    if not ax.is_cuda:
        return jac_ladder_plain(ax, ay, scalars, nbits)
    _check_batch(jac_ladder, (ax, ay, scalars), (16,))
    if ax.dim() != 2:
        raise ValueError(f"jac_ladder: expected (N, 16) limbs, got {tuple(ax.shape)}")
    n = ax.shape[0]
    return _launch_chain(jac_ladder, "hk_jac_ladder", (ax, ay, scalars), (n, 16), n, n, nbits)


jac_ladder.launches = 0


def jac_sum(x, y, z) -> Jac:
    """The in-order sum over the leading axis of a (K, ..., 16) Jacobian
    stack in one launch, a warp a lane (jac_sum_plain's limbs)."""
    if not x.is_cuda:
        return jac_sum_plain(x, y, z)
    _check_batch(jac_sum, (x, y, z), (16,))
    if x.dim() < 2:
        raise ValueError(f"jac_sum: expected a (K, ..., 16) stack, got {tuple(x.shape)}")
    K, out_shape = x.shape[0], tuple(x.shape[1:])
    n = math.prod(out_shape) // 16
    return _launch_chain(jac_sum, "hk_jac_sum", (x, y, z), out_shape, n, n, K)


jac_sum.launches = 0


def jac_horner(x, y, z, c: int) -> Jac:
    """The compact msm's Horner combine of (W, ..., 16) Jacobian window sums,
    sum_w 2^(c*w) * S_w for each lane (the axes between W and the limbs), a
    launch on one warp a lane (jac_horner_plain's limbs): three (..., 16)
    tensors."""
    if x.dim() < 2 or x.shape[0] < 1 or c < 0:
        raise ValueError(f"jac_horner: expected (W, ..., 16) window sums, W >= 1, and c >= 0, got "
                         f"{tuple(x.shape)}, c={c}")
    if not x.is_cuda:
        return jac_horner_plain(x, y, z, c)
    _check_batch(jac_horner, (x, y, z), (16,))
    W, out_shape = x.shape[0], tuple(x.shape[1:])
    if W > horner_max_w():
        raise ValueError(f"jac_horner: {W} windows; the kernel takes 1 to {horner_max_w()}")
    lanes = [t.reshape(W, -1, 16) for t in (x, y, z)]
    outs = [_launch_chain(jac_horner, "hk_jac_horner", tuple(t[:, i].contiguous() for t in lanes), (16,), 1, W,
                          int(c)) for i in range(lanes[0].shape[1])]
    return Jac(*(torch.stack(t).reshape(out_shape) for t in zip(*outs)))


jac_horner.launches = 0


def pmadd_rcb(x, y, z, ax, ay):
    """G1 projective (x, y, z) + affine (ax, ay), (..., 16) limbs."""
    if not x.is_cuda:
        return pmadd_rcb_plain(x, y, z, ax, ay)
    return Proj(*_launch_point_op(pmadd_rcb, "hk_pmadd_rcb", (x, y, z, ax, ay), (16,)))


pmadd_rcb.launches = 0


def padd_rcb(x1, y1, z1, x2, y2, z2):
    """G1 projective + projective, (..., 16) limbs."""
    if not x1.is_cuda:
        return padd_rcb_plain(x1, y1, z1, x2, y2, z2)
    return Proj(*_launch_point_op(padd_rcb, "hk_padd_rcb", (x1, y1, z1, x2, y2, z2), (16,)))


padd_rcb.launches = 0


def pdbl_rcb(x, y, z):
    """2 * G1 projective, (..., 16) limbs."""
    if not x.is_cuda:
        return pdbl_rcb_plain(x, y, z)
    return Proj(*_launch_point_op(pdbl_rcb, "hk_pdbl_rcb", (x, y, z), (16,)))


pdbl_rcb.launches = 0


def l1_rcb_mega(rows, L: int, transposed: bool = False) -> Proj:
    """MSM level 1 on projective accumulators: each column of the (ncols,
    L*16) packed slab, or (transposed) of the (L*16, ncols) one, to the
    projective sum of its L rows, added in order into the identity ((ncols,
    16) each)."""
    if not rows.is_cuda:
        return l1_rcb_mega_plain(rows, L, transposed)
    ncols = rows.shape[1] if transposed else rows.shape[0]
    _check_slab(l1_rcb_mega, rows, (L * 16, ncols) if transposed else (ncols, L * 16))
    rows = cuda_lib.aligned(rows)
    outs = tuple(torch.empty((ncols, 16), dtype=torch.int32, device=rows.device) for _ in range(3))
    if ncols:
        rc = cuda_lib.lib().hk_l1_rcb_mega(rows.data_ptr(), *(o.data_ptr() for o in outs), ncols, L,
                                           int(transposed), cuda_lib.stream_ptr(rows.device))
        cuda_lib.check("hk_l1_rcb_mega", rc)
        l1_rcb_mega.launches += 1
    return Proj(*outs)


l1_rcb_mega.launches = 0


def pmadd_rcb_g2(x, y, z, ax, ay):
    """G2 projective (x, y, z) + affine (ax, ay), (..., 2, 16) limbs."""
    if not x.is_cuda:
        return pmadd_rcb_g2_plain(x, y, z, ax, ay)
    return Proj(*_launch_point_op(pmadd_rcb_g2, "hk_pmadd_rcb_g2", (x, y, z, ax, ay), (2, 16)))


pmadd_rcb_g2.launches = 0


def padd_rcb_g2(x1, y1, z1, x2, y2, z2):
    """G2 projective + projective, (..., 2, 16) limbs."""
    if not x1.is_cuda:
        return padd_rcb_g2_plain(x1, y1, z1, x2, y2, z2)
    return Proj(*_launch_point_op(padd_rcb_g2, "hk_padd_rcb_g2", (x1, y1, z1, x2, y2, z2), (2, 16)))


padd_rcb_g2.launches = 0


def pdbl_rcb_g2(x, y, z):
    """2 * G2 projective, (..., 2, 16) limbs."""
    if not x.is_cuda:
        return pdbl_rcb_g2_plain(x, y, z)
    return Proj(*_launch_point_op(pdbl_rcb_g2, "hk_pdbl_rcb_g2", (x, y, z), (2, 16)))


pdbl_rcb_g2.launches = 0

HORNER_G2_MAX_W = 398  # csrc/curve_g2.cu's HG2_MAX_W: the window table in a block's 227 KB of shared memory


def horner_fold_g2(x, y, z, c: int):
    """(W, 2, 16) BN254-G2 projective window sums -> the projective point
    sum_w 2^(c*w) * S_w (three (2, 16) tensors), in one launch of one warp;
    1 <= W <= HORNER_G2_MAX_W, c >= 0."""
    if x.dim() != 3 or tuple(x.shape[1:]) != (2, 16) or not 1 <= x.shape[0] <= HORNER_G2_MAX_W or c < 0:
        raise ValueError(f"horner_fold_g2: expected (W, 2, 16) window sums with 1 <= W <= {HORNER_G2_MAX_W} "
                         f"and c >= 0, got {tuple(x.shape)}, c={c}")
    if not x.is_cuda:
        return horner_fold_g2_plain(x, y, z, c)
    _check_batch(horner_fold_g2, (x, y, z), (2, 16))
    x, y, z = (cuda_lib.aligned(t) for t in (x, y, z))
    outs = tuple(torch.empty((2, 16), dtype=torch.int32, device=x.device) for _ in range(3))
    rc = cuda_lib.lib().hk_horner_g2(*(t.data_ptr() for t in (x, y, z, *outs)), x.shape[0], int(c),
                                     cuda_lib.stream_ptr(x.device))
    cuda_lib.check("hk_horner_g2", rc)
    horner_fold_g2.launches += 1
    return Proj(*outs)


horner_fold_g2.launches = 0
