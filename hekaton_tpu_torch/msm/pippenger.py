"""Variable-base Pippenger MSM for BN254 G1 on torch tensors.

Port of the v9 default route of hekaton_tpu/msm/pippenger.py::msm_tpu
(:940-1143) under the name `msm_gpu`:

  1. signed window digits (`signed_digits_for_windows`);
  2. the per-window sorted plan (`_plan_sorted_w`): every (window, point)
     pair and per-bucket alignment pads sorted by digit, so each L-run of
     the slab is one bucket's points;
  3. level 1: the halves pairing of curves/cuda_curve.py::l1_aff_halves
     reduces every slab column to one affine point;
  4. `_collapse_columns`: stride-doubling adjacent-pair adds and compaction
     until every bucket owns one column, then the bucket readout;
  5. `_suffix_weighted`: sum_b b * B_b per window by a suffix scan and a
     halving tree;
  6. curves/cuda_curve.py::horner_fold combines the windows.

All accumulation is complete batched-affine (curves/affine.py), so on CUDA
tensors every add runs the aff_add kernel pair and every root inversion the
Fermat kernel; on CPU tensors the same code runs the plain versions.

Scalars are (N, 16) int32 limbs in plain (non-Montgomery) form; digits and
keys are int64 (this torch has no uint32 add, shift or searchsorted). Packed
slab words are int32 bit patterns of uint32 words.
"""
from __future__ import annotations

import math

import torch

from ..curves.affine import AFF_G1, Aff, pack_words
from ..curves.cuda_curve import horner_fold, l1_aff_halves
from ..curves.proj import PROJ_G1, Proj
from ..curves.torch_curve import Jac
from ..fields import torch_field as tf

SENT = 0xFFFFFFFF  # sort key of the tail padding (sorts last)


def pack_scalars(vals) -> torch.Tensor:
    """Host ints -> (N, 16) int32 plain limb tensor on the CPU."""
    return torch.from_numpy(tf.FR.pack(vals, mont=False))


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


def _plan_sorted_w(ax, ay, scalars, c: int, L: int, nbits: int = 254):
    """The v9 plan: per window, the N digits plus per-bucket alignment pads
    (each bucket's run filled to a multiple of L) sorted by digit, carrying
    each element's packed point row, signed by its digit's sign.

    Returns (rows, col_bucket, (W, B, NB, n_in, ncols)): rows is the
    (ncols, L*16) packed slab, col_bucket the sorted bucket id per column.
    Each window's tail-sentinel columns get id w*B + B, which for w < W-1
    aliases window w+1's digit-0 bucket (weight 0, dropped by
    _suffix_weighted) and for the last window is NB, the global sentinel.

    The JAX plan carries the payload words through a multi-operand
    lax.sort; here one stable argsort of the keys orders an index into a
    (2N+1)-row table of packed rows (x||y, x||-y, and a zero row for pads),
    and one gather builds the slab. The order of points inside a bucket is
    not fixed by either (the JAX sort is not stable); bucket ids and each
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
    pads = (L - counts % L) % L  # (W, B)
    ids = torch.arange(B, dtype=torch.int64, device=dev)
    if L > 1:
        slot = torch.arange(L - 1, dtype=torch.int64, device=dev)
        pad_keys = torch.where(slot[None, None, :] < pads[:, :, None], ids[None, :, None], SENT)
        pad_keys = pad_keys.reshape(W, B * (L - 1))
    else:
        pad_keys = torch.zeros((W, 0), dtype=torch.int64, device=dev)
    npad = pad_keys.shape[1]
    M0 = N + npad
    M = ((M0 + L - 1) // L) * L
    tail_n = M - M0
    keys = torch.cat([mag, pad_keys, torch.full((W, tail_n), SENT, dtype=torch.int64, device=dev)], 1)

    # table rows: [0, N) = x||y, [N, 2N) = x||-y, 2N = zeros (pads, tail)
    px = pack_words(ax)
    table = torch.cat([
        torch.cat([px, pack_words(ay)], dim=1),
        torch.cat([px, pack_words(tf.neg(tf.FQ, ay))], dim=1),
        torch.zeros((1, 16), dtype=torch.int32, device=dev),
    ])
    src = torch.cat([
        torch.arange(N, dtype=torch.int64, device=dev)[None, :] + N * neg.long(),
        torch.full((W, npad + tail_n), 2 * N, dtype=torch.int64, device=dev),
    ], dim=1)
    sk, order = torch.sort(keys, dim=1, stable=True)
    src = torch.gather(src, 1, order)

    mcols = M // L
    col_keys = sk[:, ::L]  # (W, mcols) first key of each column
    wbase = (torch.arange(W, dtype=torch.int64, device=dev) * B)[:, None]
    col_bucket = torch.where(col_keys == SENT, wbase + B, wbase + col_keys).reshape(-1)
    ncols = W * mcols
    rows = table[src.reshape(-1)].reshape(ncols, L * 16)
    return rows, col_bucket, (W, B, NB, W * N, ncols)


def _level1_pair(ops, rows, L: int) -> Aff:
    """Stage 3: every bucket-pure slab column to one affine point."""
    return ops.unpack_rows(l1_aff_halves(rows, L))


def _collapse_columns(ops, d, acc: Aff, M: int, NB: int, L: int, N: int, n_in: int, p: int = 3):
    """Reduce every bucket to one column: stride-doubling adjacent-pair adds
    (strides 1, 2, .., 2^(p-1)) then one stream compaction per round, on a
    two-round schedule sized for the worst case (one bucket holding a whole
    window). `d` is the sorted (M,) bucket id per column, `acc` the
    per-column sums. A stride at which no column has a partner is skipped:
    its adds would all be selected away."""
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
            if not bool(can_pair.any()):
                continue
            nxt = Aff(*(torch.cat([a[s:], a[:s]]) for a in acc))
            acc = ops.select(can_pair, ops.add(acc, nxt), acc)
        keep = (win % (1 << round_strides)) == 0
        M_next = min(M, M // (1 << round_strides) + NB)
        csum = torch.cumsum(keep.long(), 0)
        kept_count = csum[M - 1]
        take = torch.arange(1, M_next + 1, dtype=csum.dtype, device=dev)
        perm = torch.clamp(torch.searchsorted(csum, take, side="left"), max=M - 1)
        d = torch.where(torch.arange(M_next, device=dev) < kept_count, d[perm], NB)
        acc = Aff(*(a[perm] for a in acc))
        M = M_next
    return d, acc, M


def _plain_sum_axis1(ops, b: Aff) -> Aff:
    """Tree-reduce a (W, m) point batch over axis 1 by halving pair-adds."""
    m = b.x.shape[1]
    while m > 1:
        if m % 2:
            inf = ops.inf((b.x.shape[0], 1), b.x.device)
            b = Aff(*(torch.cat([a, i], dim=1) for a, i in zip(b, inf)))
            m += 1
        b = ops.add(Aff(*(a[:, 0::2] for a in b)), Aff(*(a[:, 1::2] for a in b)))
        m //= 2
    return Aff(*(a[:, 0] for a in b))


def _suffix_weighted(ops, buckets: Aff, W: int, B: int) -> Aff:
    """sum_b b * B_b per window from (W*B,) digit-ordered bucket sums: an
    inclusive suffix scan along the bucket axis, then a halving-tree sum of
    T_1..T_{B-1} per window."""
    t = Aff(*(a.reshape(W, B, 16) for a in buckets))
    steps = max(1, int(math.ceil(math.log2(B))))
    idx = torch.arange(B, device=buckets.x.device)
    for i in range(steps):
        sh = 1 << i
        shifted = Aff(*(torch.roll(a, -sh, dims=1) for a in t))
        valid = (idx + sh < B)[None, :].expand(W, B)
        t = ops.select(valid, ops.add(t, shifted), t)
    return _plain_sum_axis1(ops, Aff(*(a[:, 1:] for a in t)))


def msm_gpu(ax, ay, scalars, c: int = 13, L: int = 32, nbits: int = 254) -> Jac:
    """sum_i scalars[i] * P_i over BN254 G1.

    ax, ay: (N, 16) int32 affine limbs ((0,0) = infinity); scalars: (N, 16)
    int32 plain limbs, on the same device. Returns a Jacobian point of (16,)
    tensors. L must be a power of two."""
    N = ax.shape[0]
    ops = AFF_G1
    rows, col_bucket, (W, B, NB, n_in, ncols) = _plan_sorted_w(ax, ay, scalars, c, L, nbits)
    acc = _level1_pair(ops, rows, L)
    d, acc, M = _collapse_columns(ops, col_bucket, acc, ncols, NB, L, N, n_in)

    # one column per bucket now; buckets with no point have no column
    bucket_ids = torch.arange(NB, dtype=d.dtype, device=d.device)
    first_pos = torch.clamp(torch.searchsorted(d, bucket_ids, side="left"), max=M - 1)
    present = d[first_pos] == bucket_ids
    buckets = ops.select(present, Aff(*(a[first_pos] for a in acc)), ops.inf((NB,), d.device))

    ws = _suffix_weighted(ops, buckets, W, B)
    ws = PROJ_G1.from_affine(ws.x, ws.y)
    if W > 1:
        a = horner_fold(ws.x.contiguous(), ws.y.contiguous(), ws.z.contiguous(), c)
    else:
        a = Proj(ws.x[0], ws.y[0], ws.z[0])
    return PROJ_G1.to_jacobian(a)
