"""Variable-base Pippenger MSMs and fixed-base batch scalar muls on torch
tensors, for BN254 G1 and G2, and the variable-base MSMs on BLS12-381 G1.

`msm` ports the compact MSM of hekaton_tpu/msm/pippenger.py (`msm`, :232-268,
with `_msm_ladder`, `_segmented_accumulate`, `_weighted_bucket_sum` and
`_tree_reduce`), which the JAX TpuBackend runs below 4,096 padded points: a
per-point double-and-add ladder up to MSM_LADDER_THRESHOLD points, else per
window a digit sort, a segmented reduce-by-key of the sorted stream into
Jacobian buckets (complete runs scatter-set, lane-boundary runs stitched by
recursion), a suffix scan and tree sum of the weighted buckets, and a Horner
combine. It runs on the curve's Jacobian group law (curves/torch_curve.py:
G1 on the add and madd kernels, G2 on the plain Fq2 formulas, BLS12-381
G1 on the plain formulas over the 24-limb mont_mul kernel); the ladders,
the tree reduction's in-order chunk sums and the Horner combine are the
curve's `ladder`, `sum_in_order` and `horner`, on BN254 G1 one launch each
of curves/cuda_curve.py's chain kernels (jac_ladder, jac_sum, jac_horner):
the points of the loops of single ops, on the complete projective formulas
(other limbs). The JAX
code scans the windows one after another; here every window is one row of a
leading window axis, so each step of the reduce-by-key is one batched point
op over all windows.

`msm_gpu` ports hekaton_tpu/msm/pippenger.py::msm_tpu (:940-1154) with its
route parameters `accum`, `level1`, `plan`, `p_super`, `depth` and `G`;
`resolve_route` resolves the first three as msm_tpu does (:993-1051). The
stages below are those of BN254; BLS12-381 G1 (`curve=g1_bls12_381()`) has
no point kernel, so it resolves as msm_tpu does for a G1 curve other than
BN254: the per-window sorted plan, `level1="steps"` (an explicit "pair" runs
the generic pairwise tree, `_level1_pair`, and the gather plan
`_level1_tpu`), its adds on the generic AffineOps or ProjOps of
curves/affine.py and curves/proj.py (plain torch, products and inversion
roots on the 24-limb mont_mul and inversion kernels), and the generic Horner:

  1. signed window digits (`signed_digits_for_windows`);
  2. the plan, which lays the points out in bucket-pure columns of L:
     - `plan="wsort"` (the G1 default, v9), `_plan_sorted_w`: per window,
       the points and per-bucket alignment pads sorted by digit, so each
       L-run of the (ncols, L*16) slab is one bucket's points. The JAX G2
       route takes the flat `plan="sort"` instead; its columns hold the same
       bucket sums, so the port serves `plan="sort"` with this one plan on
       both curves;
     - `plan="tsort"` (v10), `_plan_sorted_t`: the same sorted stream as 16
       word planes, which curves/cuda_curve.py::interleave_slab_t turns into
       the transposed (L*16, ncols) slab;
     - `plan="gather"` (v6), `_plan_tpu`: a flat sort of the window-offset
       digits and per-bucket source rows into the packed point table, every
       bucket at least one column;
  3. level 1 reduces every column to one point: `level1="pair"` (the G1
     default for affine accumulation and a power-of-two L) by the halves
     pairing of curves/cuda_curve.py::l1_aff_halves, or `l1_aff_halves_t`
     on the tsort slab; `level1="mega"` (G1 otherwise) by
     curves/cuda_curve.py::l1_rcb_mega, L sequential complete projective
     mixed adds per column in one kernel, on either slab layout (the gather
     plan gathers its slab first); `level1="steps"` by `_level1_rows` on
     the sorted slab or `_level1_tpu` on the gather plan (G steps' rows a
     gather), the same L adds as one launch per step: AffineOps.add_packed
     (the aff_add_mixed_packed kernel pair and a batch inversion) on
     affine accumulators, the curve's projective mixed-add kernel on
     projective ones;
  4. `_collapse_columns`: stride-doubling adjacent-pair adds and compaction
     until every bucket owns one column, then the bucket readout;
  5. `_suffix_weighted`: sum_b b * B_b per window by a suffix scan and a
     halving tree;
  6. the window Horner combine, in one launch on BN254
     (curves/cuda_curve.py::horner_fold on G1, horner_fold_g2 on G2); on
     BLS12-381, and for one window, c projective doubles and one add per
     window on one lane.

`accum="affine"` (the G1 default) accumulates stages 3-5 in complete batched
affine (curves/affine.py: the aff_add kernel pair and the inversion kernel;
after the mega level 1, `AffineOps.from_proj`), `accum="proj"` (always on
G2) in complete projective coordinates (curves/proj.py: PROJ_G1 on the
three G1 RCB kernels, PROJ_G2 on the three G2 RCB kernels). Stages 4-5 take
either ops object. On CPU tensors the same code runs the kernels' plain
versions. Every route that `resolve_route` returns runs.

`fixed_base_table_host`, `fixed_base_msm` and `to_affine_device` port the
fixed-base batch scalar muls of setup (:1247-1309): 32 windows of 8 bits,
one Jacobian mixed add per window (G1: the madd kernel), then one inversion
per lane (the divstep inversion kernel).

Scalars are (N, 16) int32 limbs in plain (non-Montgomery) form, below the
curve's group order (`pack_scalars(vals, curve)` packs them modulo
`curve.scalar`; BLS12-381's r exceeds BN254's); digits and
keys are int64 (this torch has no uint32 add, shift or searchsorted). Packed
slab words are int32 bit patterns of uint32 words.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..curves.affine import AffineOps, KernelAffG1Ops, aff_for_curve, pack_words, unpack_words
from ..curves.cuda_curve import (fold_windows, horner_fold, horner_fold_g2, interleave_slab_t, l1_aff_halves,
                                 l1_aff_halves_t, l1_rcb_mega)
from ..curves.host import pt_add, pt_dbl
from ..curves.proj import Proj, proj_for_curve
from ..curves.torch_curve import G1, G2, CurveOps, Jac
from ..fields import torch_field as tf
from ..fields.cuda_field import fermat_inv
from ..fields.torch_field import FieldSpec
from ..utils.timing import count, recording, span

SENT = 0xFFFFFFFF  # sort key of the tail padding (sorts last)


def pack_scalars(vals, curve: CurveOps) -> torch.Tensor:
    """Host ints -> (N, 16) int32 plain limb tensor on the CPU, reduced
    modulo the group order of `curve` (`curve.scalar`: BN254's r for G1 and
    G2, BLS12-381's, which is larger, for g1_bls12_381())."""
    return torch.from_numpy(curve.scalar.pack(vals, mont=False))


def digits_for_windows(scalars: torch.Tensor, c: int, nbits: int = 254) -> torch.Tensor:
    """(N, 16) plain limbs -> (W, N) int64 window digits, LSB window first."""
    s = scalars.long()
    nwin = (nbits + c - 1) // c
    outs = []
    for w in range(nwin):
        bit = w * c
        limb, sh = bit // 16, bit % 16
        val = s[:, limb] >> sh
        if sh + c > 16 and limb + 1 < s.shape[1]:
            val = val | (s[:, limb + 1] << (16 - sh))
        if sh + c > 32 and limb + 2 < s.shape[1]:
            val = val | (s[:, limb + 2] << (32 - sh))
        outs.append(val & ((1 << c) - 1))
    return torch.stack(outs, dim=0)


def signed_digits_for_windows(scalars: torch.Tensor, c: int, nbits: int = 254):
    """(N, 16) plain limbs -> ((W, N) magnitudes in [0, 2^(c-1)], (W, N)
    bool signs): s = sum_w (-1)^neg_w * mag_w * 2^(cw)."""
    digits = digits_for_windows(scalars, c, nbits)
    W = digits.shape[0]
    if W * c <= nbits:
        raise ValueError("top window needs slack for the signed carry")
    half = 1 << (c - 1)
    mags, negs = [], []
    carry = torch.zeros_like(digits[0])
    for w in range(W):
        d = digits[w] + carry
        neg = d > half
        carry = neg.long()
        mags.append(torch.where(neg, (1 << c) - d, d))
        negs.append(neg)
    return torch.stack(mags), torch.stack(negs)


# ---------------------------------------------------------------------------
# The compact MSM
# ---------------------------------------------------------------------------

MSM_LADDER_THRESHOLD = 32


def _tree_map(fn, *trees):
    """fn over the matching coordinate tensors of point tuples (a Jac, or an
    affine (ax, ay) pair)."""
    out = [fn(*arrs) for arrs in zip(*trees)]
    return Jac(*out) if isinstance(trees[0], Jac) else tuple(out)


def _tree_index(tree, i):
    return _tree_map(lambda a: a[i], tree)


def _tree_set(tree, idx, val):
    """tree[idx] = val in every coordinate, in place. Within one idx only
    the trash slot may repeat (which write lands there is unspecified)."""
    for a, v in zip(tree, val):
        a[idx] = v


def _segmented_accumulate(curve: CurveOps, digits, vals, buckets, dummy: int, mixed: bool, K: int = 32):
    """Reduce-by-key of each window's digit-sorted stream into its buckets
    (scatter-set, in place).

    digits: (W, M) int64, each row sorted; vals: affine (ax, ay) if mixed
    else a Jac, (W, M, ...) each; buckets: a Jac of (W, dummy + 2, ...),
    slot dummy + 1 the trash slot. Complete runs are scatter-set; the two
    runs at each lane's ends recurse on a 2C-element stream."""
    W, M = digits.shape
    dev = digits.device
    rows = torch.arange(W, device=dev)
    if M > K and M % K:
        # pad the stream to a lane multiple with dummy-digit identity elements
        pad = K - M % K
        digits = torch.cat([digits, digits.new_full((W, pad), dummy)], 1)
        if mixed:
            vals = _tree_map(lambda a: torch.cat([a, a.new_zeros((W, pad) + a.shape[2:])], 1), vals)
        else:
            vals = _tree_map(lambda a, i: torch.cat([a, i], 1), vals, curve.inf((W, pad), dev))
        M += pad
    if M <= K:
        # single-lane sequential pass; every run here is complete
        acc = curve.inf((W,), dev)
        cur = digits.new_full((W,), dummy)
        for j in range(M):
            dj = digits[:, j]
            boundary = dj != cur
            _tree_set(buckets, (rows, torch.where(boundary, cur, dummy + 1)), acc)
            acc = curve.select(boundary, curve.inf((W,), dev), acc)
            if mixed:
                acc = curve.add_mixed(acc, vals[0][:, j], vals[1][:, j])
            else:
                acc = curve.add(acc, _tree_index(vals, (slice(None), j)))
            cur = dj
        _tree_set(buckets, (rows, cur), acc)
        return buckets

    C = M // K
    d_cols = digits.reshape(W, C, K).permute(2, 0, 1)  # (K, W, C): column j of every lane
    cols = _tree_map(lambda a: a.reshape((W, C, K) + a.shape[2:]).movedim(2, 0), vals)
    inf_c = curve.inf((W, C), dev)
    acc = prefix = inf_c
    prefix_digit = digits.new_zeros((W, C))
    flushed = torch.zeros((W, C), dtype=torch.bool, device=dev)
    lane_rows = rows[:, None].expand(W, C)
    for j in range(K):
        if j > 0:  # column 0 has no boundary
            dprev = d_cols[j - 1]
            boundary = d_cols[j] != dprev
            first = boundary & ~flushed
            # first flush of a lane -> boundary-stitch set
            prefix = curve.select(first, acc, prefix)
            prefix_digit = torch.where(first, dprev, prefix_digit)
            # later flushes are complete runs -> straight into buckets
            _tree_set(buckets, (lane_rows, torch.where(boundary & flushed, dprev, dummy + 1)), acc)
            flushed = flushed | boundary
            acc = curve.select(boundary, inf_c, acc)
        if mixed:
            acc = curve.add_mixed(acc, cols[0][j], cols[1][j])
        else:
            acc = curve.add(acc, _tree_index(cols, j))

    suffix_digit = d_cols[K - 1]
    # lanes that never flushed contribute an identity prefix at the suffix digit
    prefix_digit = torch.where(flushed, prefix_digit, suffix_digit)
    prefix = curve.select(flushed, prefix, inf_c)
    # interleave (prefix_i, suffix_i): still sorted by digit
    e_digits = torch.stack([prefix_digit, suffix_digit], 2).reshape(W, 2 * C)
    e_vals = _tree_map(lambda p, q: torch.stack([p, q], 2).reshape((W, 2 * C) + p.shape[2:]), prefix, acc)
    return _segmented_accumulate(curve, e_digits, e_vals, buckets, dummy, mixed=False, K=K)


def _tree_reduce(curve: CurveOps, pts: Jac, K: int = 64) -> Jac:
    """Sum of a (W, M) Jac batch over its second axis -> (W,), by chunked
    sequential adds."""
    W, M = pts.x.shape[:2]
    dev = pts.x.device
    while M > 1:
        pad = (-M) % K if M > K else 0
        if pad:
            pts = _tree_map(lambda a, i: torch.cat([a, i], 1), pts, curve.inf((W, pad), dev))
            M += pad
        if M <= K:
            return curve.sum_in_order(_tree_map(lambda a: a.movedim(1, 0), pts))
        C = M // K
        pts, M = curve.sum_in_order(_tree_map(lambda a: a.reshape((W, C, K) + a.shape[2:]).movedim(2, 0), pts)), C
    return _tree_index(pts, (slice(None), 0))


def _weighted_bucket_sum(curve: CurveOps, buckets: Jac, nbuckets: int) -> Jac:
    """sum_{k=1}^{nb-1} k * B_k per window via a suffix scan then a
    reduction: (W, nb + 2) buckets -> (W,)."""
    # drop bucket 0 and the trash slots; operate on B_1..B_{nb-1}
    b = _tree_map(lambda a: a[:, 1:nbuckets], buckets)
    W, m = b.x.shape[:2]
    idx = torch.arange(m, device=b.x.device)
    for i in range(max(1, math.ceil(math.log2(m)))):
        d = 1 << i
        shifted = _tree_map(lambda a: torch.roll(a, -d, dims=1), b)
        b = curve.select((idx + d < m).expand(W, m), curve.add(b, shifted), b)
    return _tree_reduce(curve, b)


def takes_ladder(n: int) -> bool:
    """Whether `msm` runs an n-point MSM on `_msm_ladder` (at most
    MSM_LADDER_THRESHOLD points) rather than on buckets."""
    return n <= MSM_LADDER_THRESHOLD


def _msm_ladder(curve: CurveOps, ax, ay, scalars, nbits: int | None = None) -> Jac:
    """Small-N MSM: batched per-point double-and-add ladders (lane i computes
    s_i * P_i MSB-first) and a tree reduction of the lanes.

    scalars (..., N, 16) and points (..., N, ...) with at most one leading
    batch axis: B MSMs of N points each run as one ladder over all B*N
    lanes, each MSM's lanes summed on a row of their own, and the result
    has the leading axes (an unbatched call is the case B = 1). `nbits`
    defaults to the bit length of the curve's r."""
    if nbits is None:
        nbits = curve.scalar.modulus.bit_length()
    lead, N = scalars.shape[:-2], scalars.shape[-2]
    acc = curve.ladder(ax.flatten(0, len(lead)), ay.flatten(0, len(lead)), scalars.flatten(0, len(lead)), nbits)
    out = _tree_reduce(curve, _tree_map(lambda a: a.reshape((-1, N) + a.shape[1:]), acc))
    return _tree_map(lambda a: a.reshape(lead + a.shape[1:]), out)


def msm(curve: CurveOps, ax, ay, scalars, c: int | None = None, K: int = 32, nbits: int | None = None) -> Jac:
    """Compact variable-base MSM: sum_i scalars[i] * P_i.

    ax, ay: (N, ...) affine limbs ((0,0) = infinity); scalars: (N, 16) int32
    plain limbs on the same device, `nbits` their bit length (by default
    that of the curve's r: 254 on BN254, 255 on BLS12-381). c defaults to
    the JAX package's rule for N points. Returns a Jacobian point of
    unbatched tensors.

    With one leading batch axis, (B, N, ...) points and (B, N, 16) scalars,
    B MSMs of N points run as one: their windows are the rows of one bucket
    accumulation (as the JAX prover step vmaps equal-length MSMs) and one
    Horner call combines the window sums of all B; the result is
    (B,)-batched, each MSM's equal to its unbatched call's."""
    lead, N = scalars.shape[:-2], scalars.shape[-2]
    if nbits is None:
        nbits = curve.scalar.modulus.bit_length()
    if takes_ladder(N):
        return _msm_ladder(curve, ax, ay, scalars, nbits)
    if c is None:
        c = max(2, min(13, int(math.log2(max(N, 2))) - 3))
    nbuckets = 1 << c
    ax, ay, scalars = (a.flatten(0, len(lead)) for a in (ax, ay, scalars))  # (B*N, ...)
    B = scalars.shape[0] // N
    digits = digits_for_windows(scalars, c, nbits)  # (W, B*N)
    W = digits.shape[0]
    # row b*W + w: window w of MSM b
    digits = digits.reshape(W, B, N).transpose(0, 1).reshape(B * W, N)
    sd, order = torch.sort(digits, dim=1)
    order = order + (torch.arange(B, device=ax.device) * N).repeat_interleave(W)[:, None]
    buckets = _tree_map(lambda a: a.clone(memory_format=torch.contiguous_format),
                        curve.inf((B * W, nbuckets + 2), ax.device))
    buckets = _segmented_accumulate(curve, sd, (ax[order], ay[order]), buckets, nbuckets, mixed=True, K=K)
    window_sums = _weighted_bucket_sum(curve, buckets, nbuckets)  # (B*W, ...)

    def by_window(a):  # (W, *lead, ...): each MSM's window sums down the leading axis
        return a.reshape((B, W) + a.shape[1:]).transpose(0, 1).reshape((W,) + lead + a.shape[1:])

    return curve.horner(_tree_map(by_window, window_sums), c)  # from the top window down


# ---------------------------------------------------------------------------
# msm_gpu: the v9 msm_tpu route
# ---------------------------------------------------------------------------


def _point_table(ax, ay, fspec: FieldSpec = tf.FQ) -> torch.Tensor:
    """(2N+1, nw) packed rows: [0, N) = x||y, [N, 2N) = x||-y (negated in
    the base field `fspec`), 2N = zeros (pads and tail). A G2 coordinate's
    (2, 16) limbs pack to 16 words, a BLS12-381 one's 24 limbs to 12."""
    N = ax.shape[0]
    px = pack_words(ax.reshape(N, -1))
    return torch.cat([
        torch.cat([px, pack_words(ay.reshape(N, -1))], dim=1),
        torch.cat([px, pack_words(tf.neg(fspec, ay).reshape(N, -1))], dim=1),
        torch.zeros((1, 2 * px.shape[1]), dtype=torch.int32, device=ax.device),
    ])


def _pad_keys(counts: torch.Tensor, L: int) -> torch.Tensor:
    """(..., B) per-bucket point counts -> (..., B*(L-1)) alignment pad
    keys: bucket b gets (-count_b mod L) pads keyed b, the other slots SENT."""
    *lead, B = counts.shape
    pads = (L - counts % L) % L
    ids = torch.arange(B, dtype=torch.int64, device=counts.device)
    slot = torch.arange(L - 1, dtype=torch.int64, device=counts.device)
    keys = torch.where(slot < pads[..., None], ids[:, None], SENT)
    return keys.reshape(*lead, B * (L - 1))


def _sorted_stream(ax, ay, scalars, c: int, L: int, nbits: int, blkc: int = 1, fspec: FieldSpec = tf.FQ):
    """The sorted plans' stream: per window, the N digits plus per-bucket
    alignment pads (each bucket's run filled to a multiple of L) and tail
    sentinels, stably sorted by digit, with each element's row in the
    (2N+1)-row `_point_table` (signed by its digit's sign; 2N for pads and
    tail). Each window has mcols columns of L elements, mcols rounded up to
    a multiple of `blkc`.

    Returns (table, src, col_bucket, (W, B, NB, n_in, ncols)): src is the
    (W, mcols*L) table row of every sorted element, col_bucket the bucket id
    per column. Each window's tail-sentinel columns get id w*B + B, which
    for w < W-1 aliases window w+1's digit-0 bucket (weight 0, dropped by
    _suffix_weighted) and for the last window is NB, the global sentinel.

    The JAX plans carry the payload words through a multi-operand lax.sort;
    here one stable argsort of the keys orders an index into the table, and
    one gather builds the slab. The order of points inside a bucket is not
    fixed by either (the JAX sort is not stable); bucket ids and each
    column's multiset of points are.
    """
    N = ax.shape[0]
    dev = ax.device
    mag, neg = signed_digits_for_windows(scalars, c, nbits)  # (W, N)
    W = mag.shape[0]
    B = (1 << (c - 1)) + 1
    NB = W * B

    counts = torch.zeros((W, B), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, mag, torch.ones_like(mag))
    if recording():
        count("nonzero_digits", counts[:, 1:].sum())
    pad_keys = _pad_keys(counts, L)
    npad = pad_keys.shape[1]
    M0 = N + npad
    mcols = ((M0 + L - 1) // L + blkc - 1) // blkc * blkc
    tail_n = mcols * L - M0
    keys = torch.cat([mag, pad_keys, torch.full((W, tail_n), SENT, dtype=torch.int64, device=dev)], 1)

    table = _point_table(ax, ay, fspec)
    src = torch.cat([
        torch.arange(N, dtype=torch.int64, device=dev)[None, :] + N * neg.long(),
        torch.full((W, npad + tail_n), 2 * N, dtype=torch.int64, device=dev),
    ], dim=1)
    sk, order = torch.sort(keys, dim=1, stable=True)
    src = torch.gather(src, 1, order)

    col_keys = sk[:, ::L]  # (W, mcols) first key of each column
    wbase = (torch.arange(W, dtype=torch.int64, device=dev) * B)[:, None]
    col_bucket = torch.where(col_keys == SENT, wbase + B, wbase + col_keys).reshape(-1)
    return table, src, col_bucket, (W, B, NB, W * N, W * mcols)


def _plan_sorted_w(ax, ay, scalars, c: int, L: int, nbits: int = 254, fspec: FieldSpec = tf.FQ):
    """The v9 plan (pippenger.py::_plan_sorted_w, :644-730): the sorted
    stream gathered into the (ncols, L*nw) packed slab, so each slab row's
    L elements are one bucket's points.

    Returns (rows, col_bucket, (W, B, NB, n_in, ncols)) as `_sorted_stream`.
    """
    table, src, col_bucket, meta = _sorted_stream(ax, ay, scalars, c, L, nbits, fspec=fspec)
    rows = table[src.reshape(-1)].reshape(meta[4], L * table.shape[1])
    return rows, col_bucket, meta


# the tsort plan's column multiple in msm_gpu: a warp's 32 words, so every row
# of the planes and of the transposed slab starts 128-byte aligned (JAX pads
# to its 1,024-column kernel blocks, or 128 off the TPU; pad columns are
# whole L-runs of infinity rows that every level-1 round still reads)
TSORT_BLKC = 32


def _plan_sorted_t(ax, ay, scalars, c: int, L: int, nbits: int = 254, blkc: int = TSORT_BLKC):
    """The v10 plan (pippenger.py::_plan_sorted_t, :733-829): the sorted
    stream with mcols a multiple of `blkc`, placed as 16 word planes in
    which column m's L elements are the planes' m-th entries of rows 0..L-1:
    planes[j, w, g, m] = word j (8 x-words, then 8 y-words) of element
    m*L + g of window w's sorted stream.

    JAX places the payload by two more sorts (a rank sort with an iota and
    an inversion sort onto p_static[r] = (r % L)*mcols + r // L); here the
    table's transposed words are gathered straight to those positions.
    Returns (planes (16, W, L, mcols), col_bucket, (W, B, NB, n_in, ncols)).
    """
    table, src, col_bucket, meta = _sorted_stream(ax, ay, scalars, c, L, nbits, blkc)
    W, nw = meta[0], table.shape[1]
    mcols = meta[4] // W
    place = src.reshape(W, mcols, L).transpose(1, 2).reshape(-1)  # rank m*L + g -> (w, g, m)
    planes = torch.index_select(table.t().contiguous(), 1, place).reshape(nw, W, L, mcols)
    return planes, col_bucket, meta


def _plan_tpu(ax, ay, scalars, c: int, L: int, nbits: int = 254, order: str = "row", col_pad: int = 1,
              fspec: FieldSpec = tf.FQ):
    """The v6 gather plan (pippenger.py::_plan_tpu, :449-536): one flat
    stable sort of the window-offset digits carrying each element's table
    row, then per bucket ceil(count/L) columns (at least one, so empty
    buckets own a column) of L source rows, the column's missing rows the
    infinity row 2N. ncols = n_in // L + NB (an upper bound for any
    digits), rounded up to a multiple of `col_pad`; columns past the last
    real one carry bucket id NB.

    Returns (src, table, col_bucket, (W, B, NB, n_in, ncols)): src the
    source rows into `table` (`_point_table`), (L, ncols) for order="row"
    (one slab row a step) or (ncols, L) for order="col" (a (ncols, L*nw)
    slab in one gather).
    """
    if order not in ("row", "col"):
        raise ValueError(f"_plan_tpu: order={order!r} is not 'row' or 'col'")
    N = ax.shape[0]
    dev = ax.device
    mag, neg = signed_digits_for_windows(scalars, c, nbits)  # (W, N)
    if recording():
        count("nonzero_digits", torch.count_nonzero(mag))
    W = mag.shape[0]
    B = (1 << (c - 1)) + 1
    NB = W * B
    keys = (mag + (torch.arange(W, dtype=torch.int64, device=dev) * B)[:, None]).reshape(-1)
    payload = (torch.arange(N, dtype=torch.int64, device=dev)[None, :] + N * neg.long()).reshape(-1)
    sk, perm = torch.sort(keys, stable=True)
    prow = payload[perm]
    n_in = sk.shape[0]
    ncols0 = n_in // L + NB
    ncols = (ncols0 + col_pad - 1) // col_pad * col_pad

    ids = torch.arange(NB, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(sk, ids, side="left")
    counts = torch.cat([starts[1:], starts.new_full((1,), n_in)]) - starts
    cols_per = torch.clamp((counts + L - 1) // L, min=1)
    col_starts = torch.cumsum(cols_per, 0) - cols_per
    col_idx = torch.arange(ncols, dtype=torch.int64, device=dev)
    pad_col = col_idx >= col_starts[-1] + cols_per[-1]  # beyond the last real column
    col_bucket = torch.searchsorted(col_starts, col_idx, side="right") - 1
    within = col_idx - col_starts[col_bucket]
    base = starts[col_bucket] + within * L
    cnt = torch.where(pad_col, 0, counts[col_bucket])
    col_bucket = torch.where(pad_col, NB, col_bucket)

    r = torch.arange(L, dtype=torch.int64, device=dev)
    if order == "row":
        r, within, base, cnt = r[:, None], within[None, :], base[None, :], cnt[None, :]
    else:
        r = r[None, :]
        within, base, cnt = within[:, None], base[:, None], cnt[:, None]
    valid = within * L + r < cnt
    src = torch.where(valid, prow[torch.where(valid, base + r, 0)], 2 * N)
    return src, _point_table(ax, ay, fspec), col_bucket, (W, B, NB, n_in, ncols)


def _level1_pair(ops, rows, L: int):
    """Stage 3, `level1="pair"` (pippenger.py::_level1_pair, :854-882): every
    bucket-pure slab column to one affine point. BN254 G1 takes the halves
    kernels; other affine ops (BLS12-381) the generic pairwise tree, log2(L)
    rounds of `add_pairs_packed` on adjacent elements of each column, each
    round one batch inversion."""
    if isinstance(ops, KernelAffG1Ops):
        return ops.unpack_rows(l1_aff_halves(rows, L))
    ncols = rows.shape[0]
    nw = rows.shape[1] // L  # packed words per element
    m = ncols * L
    out = rows.reshape(m, nw)
    while m > ncols:
        out = ops.add_pairs_packed(out.reshape(m // 2, 2 * nw))
        m //= 2
    return ops.unpack_rows(out)


def _level1_mega(ops, slab, L: int, transposed: bool = False):
    """Stage 3, `level1="mega"`: every slab column to its projective sum in
    one kernel; to affine by one batch inversion when `ops` accumulates in
    affine."""
    acc = l1_rcb_mega(slab, L, transposed)
    return ops.from_proj(*acc) if isinstance(ops, AffineOps) else acc


def _mixed_step(ops, coord_shape: tuple):
    """The level-1 step of the projective routes: acc + the points of the
    packed (ncols, nw) rows blk, unpacked in torch, by ops.add_mixed."""

    def step(acc, blk):
        half = blk.shape[1] // 2
        ax = unpack_words(blk[:, :half]).reshape((blk.shape[0],) + coord_shape)
        ay = unpack_words(blk[:, half:]).reshape((blk.shape[0],) + coord_shape)
        return ops.add_mixed(acc, ax, ay)

    return step


def _level1_rows(ops, rows, L: int, step):
    """Stage 3, `level1="steps"` on the sorted slab (pippenger.py::_level1_rows,
    :832-851): L sequential steps; step g adds every column's g-th packed
    element, the minor-dim slice [g*nw, (g+1)*nw) of the slab (`step` is
    ops.add_packed on affine accumulators, `_mixed_step` on projective)."""
    ncols = rows.shape[0]
    nw = rows.shape[1] // L  # packed words per element (x || y)
    acc = ops.inf((ncols,), rows.device)
    for g in range(L):
        acc = step(acc, rows[:, g * nw : (g + 1) * nw])
    return acc


def _level1_tpu(ops, src, table, ncols: int, L: int, step, depth: int = 1, G: int = 1):
    """Stage 3 of the gather plan (pippenger.py::_level1_tpu, :884-937): L
    sequential steps, step g adding the table rows src[g] to every column.
    `G` steps' rows come from one `table[src]` gather (L % G == 0); the
    result does not depend on G.

    `depth` is msm_tpu's software-pipelining distance: the TPU loop issues
    the gather of superblock k + depth while superblock k's adds run. Here
    it has nothing to do: every gather and kernel is queued in order on the
    current CUDA stream with no host sync between them, and one stream runs
    them one after another whatever the order of issue. It is accepted, as
    msm_tpu accepts it, and checked."""
    if L % G:
        raise ValueError(f"msm_gpu: G={G} rows per fetch must divide L={L}")
    if depth < 1:
        raise ValueError(f"msm_gpu: depth={depth} must be at least 1")
    src_g = src.reshape(L // G, G * ncols)
    acc = ops.inf((ncols,), src.device)
    for kk in range(L // G):
        rows = table[src_g[kk]]
        for g in range(G):
            acc = step(acc, rows[g * ncols : (g + 1) * ncols])
    return acc


def _collapse_columns(ops, d, acc, M: int, NB: int, L: int, N: int, n_in: int, p: int = 3):
    """Reduce every bucket to one column: stride-doubling adjacent-pair adds
    (strides 1, 2, .., 2^(p-1)) then one stream compaction per round, on a
    two-round schedule sized for the worst case (one bucket holding a whole
    window). `d` is the sorted (M,) bucket id per column, `acc` the
    per-column sums (affine or projective, as `ops` adds them). A stride at
    which no column has a partner is skipped: its adds would all be
    selected away."""
    dev = d.device
    max_cols = (min(N, n_in) + L - 1) // L
    levels = max(1, math.ceil(math.log2(max(2, max_cols))))
    schedule = [min(p, levels)]
    if levels > p:
        schedule.append(levels - p)
    for round_strides in schedule:
        if M <= 1:
            break
        i = torch.arange(M, device=dev)
        first = torch.searchsorted(d, d, side="left")
        win = i - first  # column index within its bucket
        for q in range(round_strides):
            s = 1 << q
            d_next = torch.cat([d[s:], torch.full((s,), NB, dtype=d.dtype, device=dev)])
            can_pair = (win % (2 * s) == 0) & (d_next == d) & (d < NB)
            count("host_syncs")  # the any() below waits for the device
            if not bool(can_pair.any()):
                continue
            nxt = type(acc)(*(torch.cat([a[s:], a[:s]]) for a in acc))
            acc = ops.select(can_pair, ops.add(acc, nxt), acc)
        keep = (win % (1 << round_strides)) == 0
        M_next = min(M, M // (1 << round_strides) + NB)
        csum = torch.cumsum(keep.long(), 0)
        kept_count = csum[M - 1]
        take = torch.arange(1, M_next + 1, dtype=csum.dtype, device=dev)
        perm = torch.clamp(torch.searchsorted(csum, take, side="left"), max=M - 1)
        d = torch.where(torch.arange(M_next, device=dev) < kept_count, d[perm], NB)
        acc = type(acc)(*(a[perm] for a in acc))
        M = M_next
    return d, acc, M


def _plain_sum_axis1(ops, b):
    """Tree-reduce a (W, m) point batch over axis 1 by halving pair-adds."""
    pt = type(b)
    m = b.x.shape[1]
    while m > 1:
        if m % 2:
            inf = ops.inf((b.x.shape[0], 1), b.x.device)
            b = pt(*(torch.cat([a, i], dim=1) for a, i in zip(b, inf)))
            m += 1
        b = ops.add(pt(*(a[:, 0::2] for a in b)), pt(*(a[:, 1::2] for a in b)))
        m //= 2
    return pt(*(a[:, 0] for a in b))


def _suffix_weighted(ops, buckets, W: int, B: int):
    """sum_b b * B_b per window from (W*B,) digit-ordered bucket sums: an
    inclusive suffix scan along the bucket axis, then a halving-tree sum of
    T_1..T_{B-1} per window."""
    pt = type(buckets)
    t = pt(*(a.reshape((W, B) + a.shape[1:]) for a in buckets))
    steps = max(1, int(math.ceil(math.log2(B))))
    idx = torch.arange(B, device=buckets.x.device)
    for i in range(steps):
        sh = 1 << i
        shifted = pt(*(torch.roll(a, -sh, dims=1) for a in t))
        valid = (idx + sh < B)[None, :].expand(W, B)
        t = ops.select(valid, ops.add(t, shifted), t)
    return _plain_sum_axis1(ops, pt(*(a[:, 1:] for a in t)))


def _is_bn254_g1(curve: CurveOps) -> bool:
    """msm_tpu's is_bn_g1: the one curve with point kernels."""
    return curve.f.ndim == 1 and curve.f.spec.modulus == tf.FQ.modulus


def resolve_route(curve: CurveOps, L: int, accum=None, level1=None, plan=None) -> tuple:
    """(accum, level1, plan) as msm_tpu resolves its arguments
    (hekaton_tpu/msm/pippenger.py:993-1051) on `curve`: BN254 G1, BN254 G2
    (Fq2 coordinates) or another G1 curve, BLS12-381.

    BN254 G1: accum "affine", plan "wsort", level1 "pair" for affine
    accumulation and a power-of-two L, else "mega". G2: accum is "proj"
    and level1 "steps" whatever is asked (the mega kernel is G1's), plan
    "sort". Another G1 curve: accum "affine", plan "sort", level1 "steps";
    "mega" becomes "steps" and "tsort" "wsort" (those kernels are BN254's).
    An explicit "pair" that cannot run (projective accumulation, the gather
    plan, L not a power of two) warns and becomes "steps"; "tsort" with
    "steps" becomes "wsort" (its kernels serve the mega and pair routes)."""
    g2 = curve.f.ndim == 2
    bn_g1 = _is_bn254_g1(curve)
    if accum is None:
        accum = "proj" if g2 else "affine"
    if accum not in ("affine", "proj"):
        raise ValueError(f"msm_gpu: accum={accum!r} is not 'affine' or 'proj'")
    if g2:
        accum = "proj"
    if plan is None:
        plan = "wsort" if bn_g1 else "sort"
    if plan not in ("sort", "wsort", "tsort", "gather"):
        raise ValueError(f"msm_gpu: plan={plan!r} is not 'sort', 'wsort', 'tsort' or 'gather'")
    pow2 = L & (L - 1) == 0
    if level1 is None:
        if not bn_g1:
            level1 = "steps"
        else:
            level1 = "pair" if accum == "affine" and pow2 else "mega"
    if level1 not in ("pair", "mega", "steps"):
        raise ValueError(f"msm_gpu: level1={level1!r} is not 'pair', 'mega' or 'steps'")
    if level1 == "pair" and (accum != "affine" or plan == "gather" or not pow2):
        warnings.warn(
            f"msm_gpu: level1='pair' needs accum='affine', a sorted plan and power-of-two L "
            f"(got accum={accum!r}, plan={plan!r}, L={L}); falling back to level1='steps'",
            stacklevel=3,
        )
        level1 = "steps"
    if not bn_g1 and level1 == "mega":
        level1 = "steps"
    if plan == "tsort" and (level1 == "steps" or not bn_g1):
        plan = "wsort"
    return accum, level1, plan


def msm_gpu(ax, ay, scalars, c: int = 13, L: int = 32, nbits: int | None = None, p_super: int = 3,
            accum: str | None = None, level1: str | None = None, plan: str | None = None,
            depth: int = 1, G: int = 1, curve: CurveOps | None = None) -> Jac:
    """sum_i scalars[i] * P_i over BN254 G1, BN254 G2 or BLS12-381 G1.

    ax, ay: affine limbs, (N, 16) for BN254 G1, (N, 2, 16) Fq2 for G2 or
    (N, 24) for BLS12-381 G1 ((0,0) = infinity). `curve` is the CurveOps of
    the points, as msm_tpu takes it; left out, the coordinate shape picks
    BN254 G1 or G2, and (N, 24) coordinates need curve=g1_bls12_381().
    scalars: (N, 16) int32 plain limbs on the same device; `nbits` their
    bit length, by default 254 on BN254 and 255 on BLS12-381. `accum`,
    `level1` and `plan` pick the route as in msm_tpu (`resolve_route`;
    module docstring); `p_super` is the collapse's strides per round;
    `depth` and `G` are the gather plan's (`_level1_tpu`). Returns a
    Jacobian point of unbatched tensors.

    While recording (utils/timing.py) the call is the span "msm" (curve, N,
    c, L and the route as attributes) over five children on every route:
    "msm.plan" (digits to slab; counters `slab_entries`, W x mcols x L, and
    `nonzero_digits`, a 0-d tensor), "msm.level1", "msm.collapse",
    "msm.suffix" (bucket readout, suffix sum, to projective) and
    "msm.horner"; `host_syncs` counts each read of the device by the host
    in the span it falls in."""
    N = ax.shape[0]
    dev = ax.device
    coord_shape = tuple(ax.shape[1:])
    if curve is None:
        curve = {(16,): G1, (2, 16): G2}.get(coord_shape)
        if curve is None:
            raise ValueError(f"msm_gpu: no default curve for {coord_shape} coordinates (BLS12-381 G1 "
                             f"needs curve=g1_bls12_381())")
    f = curve.f
    want = (2, 16) if f.ndim == 2 else (f.spec.nlimbs,)
    if coord_shape != want:
        raise ValueError(f"msm_gpu: {curve.name} takes {want} coordinates, got {coord_shape}")
    if nbits is None:
        nbits = curve.scalar.modulus.bit_length()  # 254 on BN254, 255 on BLS12-381
    accum, level1, plan = resolve_route(curve, L, accum, level1, plan)
    proj = proj_for_curve(curve)
    ops = aff_for_curve(curve) if accum == "affine" else proj
    step = ops.add_packed if accum == "affine" else _mixed_step(proj, coord_shape)
    with span("msm", curve=curve.name, N=N, c=c, L=L, accum=accum, level1=level1, plan=plan):
        with span("msm.plan"):
            if plan == "tsort":
                planes, col_bucket, meta = _plan_sorted_t(ax, ay, scalars, c, L, nbits)
                slab = interleave_slab_t(planes)
                del planes
            elif plan == "gather":
                src, table, col_bucket, meta = _plan_tpu(
                    ax, ay, scalars, c, L, nbits, order="col" if level1 == "mega" else "row", fspec=f.spec)
            else:
                slab, col_bucket, meta = _plan_sorted_w(ax, ay, scalars, c, L, nbits, f.spec)
            W, B, NB, n_in, ncols = meta
            count("slab_entries", ncols * L)
        with span("msm.level1"):
            if plan == "gather":
                if level1 == "mega":
                    acc = _level1_mega(ops, table[src.reshape(-1)].reshape(ncols, L * table.shape[1]), L)
                else:
                    acc = _level1_tpu(ops, src, table, ncols, L, step, depth, G)
                del src, table
            else:
                if level1 == "mega":
                    acc = _level1_mega(ops, slab, L, transposed=plan == "tsort")
                elif plan == "tsort":  # pair
                    acc = ops.unpack_rows(l1_aff_halves_t(slab, L).t().contiguous())
                elif level1 == "pair":
                    acc = _level1_pair(ops, slab, L)
                else:
                    acc = _level1_rows(ops, slab, L, step)
                del slab
        with span("msm.collapse"):
            d, acc, M = _collapse_columns(ops, col_bucket, acc, ncols, NB, L, N, n_in, p=p_super)
        with span("msm.suffix"):
            # one column per bucket now; buckets with no point have no column
            bucket_ids = torch.arange(NB, dtype=d.dtype, device=dev)
            first_pos = torch.clamp(torch.searchsorted(d, bucket_ids, side="left"), max=M - 1)
            present = d[first_pos] == bucket_ids
            buckets = ops.select(present, type(acc)(*(a[first_pos] for a in acc)), ops.inf((NB,), dev))
            ws = _suffix_weighted(ops, buckets, W, B)
            if accum == "affine":
                ws = proj.from_affine(ws.x, ws.y)
        with span("msm.horner"):
            if W > 1 and (_is_bn254_g1(curve) or f.ndim == 2):
                fold = horner_fold if f.ndim == 1 else horner_fold_g2
                return proj.to_jacobian(fold(ws.x.contiguous(), ws.y.contiguous(), ws.z.contiguous(), c))
            return _horner_generic(proj, ws, c)


def _horner_generic(proj, ws: Proj, c: int) -> Jac:
    """The window combine (pippenger.py:1145-1154) of the (W,) projective
    window sums on one lane, for BLS12-381 G1 and a single window: from the
    top window down, c doublings and one add per window. Returns a Jacobian
    point of unbatched tensors."""
    return proj.to_jacobian(fold_windows(proj, *ws, c))


# ---------------------------------------------------------------------------
# Fixed-base batch scalar multiplication (setup)
# ---------------------------------------------------------------------------

FB_WINDOW = 8  # table windows of 8 bits: 32 windows x 256 entries


def fixed_base_table_host(base_host, curve):
    """Host table T[j][b] = b * 2^(8j) * base, packed as (32, 256, ...) int32
    limb arrays (tx, ty); T[j][0] is the (0,0) sentinel."""
    windows = (254 + FB_WINDOW - 1) // FB_WINDOW
    tbl = []
    cur = base_host
    for _ in range(windows):
        row = [None]
        acc = None
        for _ in range(255):
            acc = pt_add(acc, cur)
            row.append(acc)
        tbl.append(row)
        for _ in range(FB_WINDOW):
            cur = pt_dbl(cur)
    packed = [curve.pack_affine(row) for row in tbl]
    return np.stack([x for x, _ in packed]), np.stack([y for _, y in packed])


def fixed_base_msm(curve, table, scalars) -> Jac:
    """out[i] = scalars[i] * base for every lane: one Jacobian mixed add of
    the table entry of each 8-bit digit, window by window.

    table: (tx, ty) tensors of shape (32, 256, ...) on the scalars' device;
    scalars: (N, 16) int32 plain limbs. Returns an (N,)-batched Jac."""
    tx, ty = table
    digits = digits_for_windows(scalars, FB_WINDOW)  # (32, N)
    acc = curve.inf((scalars.shape[0],), scalars.device)
    for j in range(tx.shape[0]):
        acc = curve.add_mixed(acc, tx[j][digits[j]], ty[j][digits[j]])
    return acc


def to_affine_device(curve, p: Jac):
    """Batched Jacobian -> affine with one inversion per lane (the
    fermat_inv kernel's divsteps on CUDA tensors, mont_inv's Fermat chain on
    the CPU; G2 inverts the norm z0^2 + z1^2 of its Fq2 z); infinity -> (0,0)."""
    f = curve.f
    if f.ndim == 1:
        zinv = fermat_inv(tf.FQ, p.z.contiguous())
    else:
        fp = f.fp
        z0, z1 = p.z[..., 0, :], p.z[..., 1, :]
        ninv = fermat_inv(tf.FQ, tf.add(tf.FQ, fp.sqr(z0), fp.sqr(z1)).contiguous())
        zinv = torch.stack([fp.mul(z0, ninv), fp.mul(tf.neg(tf.FQ, z1), ninv)], dim=-2)
    zi2 = f.sqr(zinv)
    ax = f.mul(p.x, zi2)
    ay = f.mul(p.y, f.mul(zi2, zinv))
    inf = curve.is_inf(p)
    batch = ax.shape[: ax.dim() - f.ndim]
    zero = f.zeros(batch, ax.device)
    return f.select(inf, zero, ax), f.select(inf, zero, ay)
