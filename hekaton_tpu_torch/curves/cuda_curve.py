"""Curve kernels: the G1 MSM's complete batched-affine add, level-1 halves
pairing and window Horner fold; its three complete projective ops and
projective level 1 (the accum="proj" and level1="mega" routes); the G1
Jacobian mixed add of the fixed-base muls; and the G2 MSM's three complete
projective Fq2 ops.

Port of the main-path kernels of hekaton_tpu/curves/pallas_curve.py. Source:
csrc/curve.cu (G1 kernels), csrc/curve_g2.cu (G2 kernels), csrc/field.cuh
(Fq and Fq2 device functions).

- `aff_add_fused` replaces `aff_add_fused` (pallas_curve.py:760; kernels
  `_aff_root_kernel` :426 and `_aff_fin_tree_kernel` :442).
- `l1_aff_halves` replaces `l1_aff_halves` with tr=False (pallas_curve.py:930;
  kernels `_aff_halves_root_kernel` :802 and `_aff_halves_fin_kernel` :822).
- `horner_fold` replaces `horner_fold` (pallas_curve.py:625; kernel
  `_horner_kernel` :583).
- `madd` replaces `madd` (pallas_curve.py:1281; kernel `_madd_kernel`
  :1178 on `_madd_tiles` :164 with the `_dbl_tiles` escape :146).
- `dbl` and `add` replace `dbl` and `add` (pallas_curve.py:1285/1289;
  kernels `_dbl_kernel` :1188 on `_dbl_tiles` :146 and `_add_kernel` :1196
  on `_add_tiles` :210).
- `pmadd_rcb`, `padd_rcb`, `pdbl_rcb` replace the wrappers of the same names
  (pallas_curve.py:1293/1297/1301; kernels `_pmadd_rcb_kernel` :1206 on
  `_pmadd_rcb_tiles` :264, `_padd_rcb_kernel` :1216, `_pdbl_rcb_kernel`
  :1226). Their interface keeps the JAX shape: (..., 16) int32 Montgomery
  limbs per coordinate.
- `l1_rcb_mega` replaces `l1_rcb_mega` (pallas_curve.py:572; kernel
  `_l1_mega_kernel` :470) on the port's own (ncols, L*16) slab, not JAX's
  transposed (L*16, ncols) one.
- `pmadd_rcb_g2`, `padd_rcb_g2`, `pdbl_rcb_g2` replace the wrappers of the
  same names (pallas_curve.py:1315/1320/1324; kernels `_pmadd_rcb_g2_kernel`
  :1115, `_padd_rcb_g2_kernel` :1130, `_pdbl_rcb_g2_kernel` :1148, all
  through the one `pallas_call` of `_build` :1250). Their interface keeps
  the JAX shape: (..., 2, 16) int32 Fq2 limbs per coordinate.

Bounds on an H100 and the design that meets them are in the source note of
csrc/curve.cu: the adds are bound by integer multiply throughput and run as a
root kernel / batch_inv / finish kernel split with one thread per prefix
chain; the Horner fold is one thread, bound by the latency of its chain.
`madd`, `dbl`, `add`, the G1 RCB ops and the G2 ops are one thread per
lane, straight-line formulas, bound by integer multiply throughput once the
card is full; `l1_rcb_mega` is one thread per slab column, its accumulator
in registers for all L adds (csrc/curve.cu, csrc/curve_g2.cu).

Each wrapper takes CPU tensors to its plain PyTorch version (`*_plain`) and
CUDA tensors to its kernels; nothing falls back. `launches` on each wrapper
counts its kernel launches (one per add, per halves round, per fold, per
level-1 slab, per batch of point ops).
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

K_ADD = 8  # lanes per thread (one prefix chain) in the aff_add kernel pair


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def aff_add_fused_plain(x1, y1, px, py):
    """Complete batched-affine (x1, y1) + (px, py) on the plain formulas
    (curves/affine.py::AffineOps._prep/_fin of the JAX package)."""
    q_inf = tf.is_zero(FQ, py)
    p_inf = tf.is_zero(FQ, y1)
    dx = tf.sub(FQ, px, x1)
    dy = tf.sub(FQ, py, y1)
    same_x = tf.is_zero(FQ, dx)
    dbl = same_x & tf.is_zero(FQ, dy)
    num = dy
    if bool(dbl.any()):  # doubling lanes need 3*x1^2 (as _num_tiles' lax.cond)
        x1sq = tf.mont_mul(FQ, x1, x1)
        num = tf.select(dbl, tf.add(FQ, tf.add(FQ, x1sq, x1sq), x1sq), dy)
    den = tf.select(dbl, tf.add(FQ, y1, y1), dx)
    degen = q_inf | p_inf | (same_x & ~dbl)
    den = tf.select(degen, tf.consts(FQ, den.device)["one"].expand(den.shape), den)
    inv = tf.batch_inv_plain(FQ, den)
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


_PROJ_G1_PLAIN = ProjOps(tf.FqPlain, 9, "g1_proj_plain")
_PROJ_G2_PLAIN = ProjOps(tf.Fq2Plain, B_G2 * 3, "g2_proj_plain")


def horner_fold_plain(x, y, z, c: int):
    """(W, 16) projective window sums -> sum_w 2^(c*w) * S_w, MSB window
    first, on the plain complete RCB formulas (curves/proj.py)."""
    proj = _PROJ_G1_PLAIN
    W = x.shape[0]
    acc = Proj(x[W - 1], y[W - 1], z[W - 1])
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = proj.dbl(acc)
        acc = proj.add(acc, Proj(x[w], y[w], z[w]))
    return acc


def pmadd_rcb_plain(x, y, z, ax, ay):
    """G1 projective + affine on the plain RCB formulas (curves/proj.py)."""
    return _PROJ_G1_PLAIN.add_mixed(Proj(x, y, z), ax, ay)


def padd_rcb_plain(x1, y1, z1, x2, y2, z2):
    return _PROJ_G1_PLAIN.add(Proj(x1, y1, z1), Proj(x2, y2, z2))


def pdbl_rcb_plain(x, y, z):
    return _PROJ_G1_PLAIN.dbl(Proj(x, y, z))


def l1_rcb_mega_plain(rows, L: int) -> Proj:
    """(ncols, L*16) packed slab -> each column's L packed rows added in
    order into the identity (0:1:0) on the plain formulas: projective
    (x, y, z), each (ncols, 16)."""
    ncols = rows.shape[0]
    v = rows.reshape(ncols, L, 16)
    acc = _PROJ_G1_PLAIN.inf((ncols,), rows.device)
    for g in range(L):
        q = AffineOps.unpack_rows(v[:, g])
        acc = _PROJ_G1_PLAIN.add_mixed(acc, q.x, q.y)
    return acc
_G1_PLAIN = CurveOps(tf.FqPlain, "g1_plain")  # its dbl is _dbl_tiles' dbl-2009-l


def pmadd_rcb_g2_plain(x, y, z, ax, ay):
    """G2 projective + affine on the plain RCB formulas (curves/proj.py)."""
    return _PROJ_G2_PLAIN.add_mixed(Proj(x, y, z), ax, ay)


def padd_rcb_g2_plain(x1, y1, z1, x2, y2, z2):
    return _PROJ_G2_PLAIN.add(Proj(x1, y1, z1), Proj(x2, y2, z2))


def pdbl_rcb_g2_plain(x, y, z):
    return _PROJ_G2_PLAIN.dbl(Proj(x, y, z))


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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _launch_point_op(fn, entry: str, args: tuple, coord_shape: tuple):
    """Launch the one-thread-per-lane point kernel `entry` on `args`, each a
    contiguous int32 (..., *coord_shape) batch of one shape on one device;
    count the launch on the wrapper `fn` and return the three output
    coordinates."""
    first = args[0]
    for i, t in enumerate(args):
        check_limbs(f"{fn.__name__} argument {i}", t, first.device)
        if t.shape != first.shape or tuple(t.shape[t.dim() - len(coord_shape):]) != coord_shape:
            raise ValueError(f"{fn.__name__}: argument {i} {tuple(t.shape)} is not (..., "
                             f"{', '.join(map(str, coord_shape))}) of shape {tuple(first.shape)}")
    n = first.numel() // math.prod(coord_shape)
    outs = tuple(torch.empty_like(first) for _ in range(3))
    if n:
        rc = getattr(cuda_lib.lib(), entry)(
            *(t.data_ptr() for t in args), *(o.data_ptr() for o in outs), n,
            cuda_lib.stream_ptr(first.device),
        )
        cuda_lib.check(entry, rc)
        fn.launches += 1
    return outs


def aff_add_fused(x1, y1, px, py):
    """Complete batched-affine add on (..., 16) limb tensors of one shape."""
    if not x1.is_cuda:
        return aff_add_fused_plain(x1, y1, px, py)
    for name, t in (("x1", x1), ("y1", y1), ("px", px), ("py", py)):
        check_limbs(f"aff_add_fused {name}", t, x1.device)
        if t.shape != x1.shape:
            raise ValueError(f"aff_add_fused: {name} {tuple(t.shape)} != {tuple(x1.shape)}")
    n = x1.numel() // 16
    ox = torch.empty_like(x1)
    oy = torch.empty_like(y1)
    if n == 0:
        return ox, oy
    nthreads = (n + K_ADD - 1) // K_ADD
    dev = x1.device
    pre = torch.empty((K_ADD * nthreads, 8), dtype=torch.int32, device=dev)
    roots = torch.empty((nthreads, 16), dtype=torch.int32, device=dev)
    lib = cuda_lib.lib()
    rc = lib.hk_aff_root(
        x1.data_ptr(), y1.data_ptr(), px.data_ptr(), py.data_ptr(), pre.data_ptr(),
        roots.data_ptr(), n, nthreads, K_ADD, cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check("hk_aff_root", rc)
    rinv = tf.batch_inv(FQ, roots)
    rc = lib.hk_aff_fin(
        x1.data_ptr(), y1.data_ptr(), px.data_ptr(), py.data_ptr(), pre.data_ptr(),
        rinv.data_ptr(), ox.data_ptr(), oy.data_ptr(), n, nthreads, K_ADD,
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check("hk_aff_fin", rc)
    aff_add_fused.launches += 1
    return ox, oy


aff_add_fused.launches = 0


def l1_aff_halves(rows, L: int):
    """MSM level 1: reduce the (ncols, L*16) packed slab of bucket-pure
    columns to one packed affine point per column ((ncols, 16))."""
    if L & (L - 1):
        raise ValueError(f"l1_aff_halves: L={L} is not a power of two")
    if not rows.is_cuda:
        return l1_aff_halves_plain(rows, L)
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != L * 16:
        raise ValueError(f"l1_aff_halves: expected an int32 (ncols, {L * 16}) slab, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("l1_aff_halves: expected a contiguous slab")
    ncols = rows.shape[0]
    dev = rows.device
    lib = cuda_lib.lib()
    l = L
    while l > 1 and ncols:
        k = l // 2
        pre = torch.empty((k * ncols, 8), dtype=torch.int32, device=dev)
        roots = torch.empty((ncols, 16), dtype=torch.int32, device=dev)
        rc = lib.hk_halves_root(rows.data_ptr(), pre.data_ptr(), roots.data_ptr(), ncols, k,
                                cuda_lib.stream_ptr(dev))
        cuda_lib.check("hk_halves_root", rc)
        rinv = tf.batch_inv(FQ, roots)
        out = torch.empty((ncols, k * 16), dtype=torch.int32, device=dev)
        rc = lib.hk_halves_fin(rows.data_ptr(), pre.data_ptr(), rinv.data_ptr(), out.data_ptr(),
                               ncols, k, cuda_lib.stream_ptr(dev))
        cuda_lib.check("hk_halves_fin", rc)
        l1_aff_halves.launches += 1
        rows = out
        l = k
    return rows


l1_aff_halves.launches = 0


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
    if W < 1:
        raise ValueError("horner_fold: no windows")
    ox, oy, oz = (torch.empty(16, dtype=torch.int32, device=x.device) for _ in range(3))
    rc = cuda_lib.lib().hk_horner(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), ox.data_ptr(), oy.data_ptr(), oz.data_ptr(),
        W, int(c), cuda_lib.stream_ptr(x.device),
    )
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


def l1_rcb_mega(rows, L: int) -> Proj:
    """MSM level 1 on projective accumulators: each column of the (ncols,
    L*16) packed slab to the projective sum of its L rows, added in order
    into the identity ((ncols, 16) each)."""
    if not rows.is_cuda:
        return l1_rcb_mega_plain(rows, L)
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != L * 16:
        raise ValueError(f"l1_rcb_mega: expected an int32 (ncols, {L * 16}) slab, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("l1_rcb_mega: expected a contiguous slab")
    ncols = rows.shape[0]
    outs = tuple(torch.empty((ncols, 16), dtype=torch.int32, device=rows.device) for _ in range(3))
    if ncols:
        rc = cuda_lib.lib().hk_l1_rcb_mega(rows.data_ptr(), *(o.data_ptr() for o in outs), ncols, L,
                                           cuda_lib.stream_ptr(rows.device))
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
