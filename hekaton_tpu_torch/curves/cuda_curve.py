"""G1 curve kernels of the MSM: the complete batched-affine add, the level-1
halves pairing, and the window Horner fold.

Port of the main-path kernels of hekaton_tpu/curves/pallas_curve.py. Source:
csrc/curve.cu (kernels), csrc/field.cuh (field device functions).

- `aff_add_fused` replaces `aff_add_fused` (pallas_curve.py:760; kernels
  `_aff_root_kernel` :426 and `_aff_fin_tree_kernel` :442).
- `l1_aff_halves` replaces `l1_aff_halves` with tr=False (pallas_curve.py:930;
  kernels `_aff_halves_root_kernel` :802 and `_aff_halves_fin_kernel` :822).
- `horner_fold` replaces `horner_fold` (pallas_curve.py:625; kernel
  `_horner_kernel` :583).

Bounds on an H100 and the design that meets them are in the source note of
csrc/curve.cu: the adds are bound by integer multiply throughput and run as a
root kernel / batch_inv / finish kernel split with one thread per prefix
chain; the Horner fold is one thread, bound by the latency of its chain.

Each wrapper takes CPU tensors to its plain PyTorch version (`*_plain`) and
CUDA tensors to its kernels; nothing falls back. `launches` on each wrapper
counts its kernel launches (one per add, per halves round, per fold).
"""
from __future__ import annotations

import torch

from .. import cuda_lib
from ..fields import torch_field as tf
from ..fields.cuda_field import check_limbs
from ..fields.torch_field import FQ
from .affine import Aff, AffineOps
from .proj import Proj, ProjOps

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


def horner_fold_plain(x, y, z, c: int):
    """(W, 16) projective window sums -> sum_w 2^(c*w) * S_w, MSB window
    first, on the plain complete RCB formulas (curves/proj.py)."""
    proj = ProjOps(tf.FqPlain, 9, "g1_proj_plain")
    W = x.shape[0]
    acc = Proj(x[W - 1], y[W - 1], z[W - 1])
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = proj.dbl(acc)
        acc = proj.add(acc, Proj(x[w], y[w], z[w]))
    return acc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


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

