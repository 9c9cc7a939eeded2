"""Distributed four-step NTT with one all-to-all between its two stages.

Port of hekaton_tpu/ntt/sharded.py onto torch.distributed. The four-step
factorization n = n1*n2 is split over a mesh axis ("pts" by default) of D
ranks:

  view x as the (n1, n2) matrix x[j1, j2] = x[j1*n2 + j2]; rank d owns the
  columns [d n2/D, (d+1) n2/D):
    1. local length-n1 NTTs down the owned columns (ntt/ntt.py::ntt,
       batched over the columns),
    2. the cross-twiddle product (mont_mul: the CIOS kernel on the card),
    3. ALL-TO-ALL over the axis: row block d of the n1 axis goes to rank d,
       and the blocks a rank receives are concatenated along the column
       axis in the order of the source ranks (the JAX lax.all_to_all with
       split_axis=0, concat_axis=1, tiled=True),
    4. local length-n2 NTTs along the owned rows.

The result is the (n1, n2) matrix with X[k1 + n1*k2] = B[k1, k2], row
blocks on the ranks. The JAX package gets natural order from its output
sharding; here an all-gather over the axis and a swap of the two axes give
it on every rank. With one rank on the axis no collective is issued.

The sub-NTT roots line up with the local plans because
root_of_unity(n)^n2 == root_of_unity(n1) in the two-adic tower.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..fields import torch_field as tf
from ..fields.bn254 import NLIMBS, R
from ..fields.cuda_field import mont_mul
from ..fields.host import fr_inv
from . import ntt as nttm


@functools.lru_cache(maxsize=None)
def _cross_twiddles(n1: int, n2: int, inverse: bool) -> np.ndarray:
    omega = nttm.root_of_unity(n1 * n2)
    if inverse:
        omega = fr_inv(omega)
    rows = []
    for k1 in range(n1):
        wk = pow(omega, k1, R)
        row, cur = [], 1
        for _ in range(n2):
            row.append(cur)
            cur = cur * wk % R
        rows.append(row)
    flat = [v for row in rows for v in row]
    return tf.FR.pack(flat).reshape(n1, n2, NLIMBS)


def make_sharded_ntt(mesh, n: int, axis: str = "pts", inverse: bool = False):
    """Returns f((n, 16) natural order) -> (n, 16) natural order, Montgomery
    limbs on the mesh's device, split over mesh axis `axis` with one
    all-to-all between the two NTT stages. Every rank of the axis passes the
    whole vector and gets the whole transform; each computes its share."""
    D, d = mesh.size(axis), mesh.index(axis)
    bits = n.bit_length() - 1
    n1 = 1 << ((bits + 1) // 2)
    n2 = n // n1
    if n1 % D or n2 % D:
        raise ValueError(f"four-step split {n1}x{n2} must be divisible by {D}")
    n2l = n2 // D
    tw = tf.tensor(_cross_twiddles(n1, n2, inverse)[:, d * n2l:(d + 1) * n2l], mesh.device)

    def run(x: torch.Tensor) -> torch.Tensor:
        # the owned columns, as a batch of n2/D length-n1 vectors
        xt = x.reshape(n1, n2, NLIMBS)[:, d * n2l:(d + 1) * n2l].transpose(0, 1)
        a = nttm.ntt(xt.contiguous(), inverse=inverse).transpose(0, 1)  # (n1, n2/D, 16)
        t = mont_mul(tf.FR, a.contiguous(), tw)
        if D > 1:
            # row block k of the n1 axis to rank k; block s received lands at [s]
            got = torch.empty((D, n1 // D, n2l, NLIMBS), dtype=t.dtype, device=t.device)
            dist.all_to_all_single(got, t, group=mesh.group(axis))
            t = got.permute(1, 0, 2, 3).reshape(n1 // D, n2, NLIMBS)  # columns in source-rank order
        b = nttm.ntt(t.contiguous(), inverse=inverse)  # (n1/D, n2, 16): length-n2 NTTs along the rows
        if D > 1:
            blocks = [torch.empty_like(b) for _ in range(D)]
            dist.all_gather(blocks, b, group=mesh.group(axis))
            b = torch.cat(blocks)
        # X[k1 + n1*k2] = B[k1, k2]; the inverse's 1/n1 and 1/n2 make 1/n
        return b.transpose(0, 1).reshape(n, NLIMBS)

    return run
