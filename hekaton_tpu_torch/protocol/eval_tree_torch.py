"""The exec tree built on the device: the running-eval scan and the Poseidon
Merkle tree.

Port of hekaton_tpu/protocol/eval_tree_jax.py, the opt-in replacement of
the coordinator's one O(total trace) sequential host loop
(protocol/coordinator.py::generate_exec_tree, HEKATON_DEVICE_TREE):

  1. each transcript entry's grand-product term tr_chal - repr(entry) is
     computed over the whole trace at once (`_terms`);
  2. the time- and address-ordered running products are an inclusive
     prefix product (`_prefix_products`), a log-step scan of Fr products
     in place of the JAX package's jax.lax.associative_scan: every product
     is canonical and the product is associative and commutative, so the
     order of association does not change a limb;
  3. each subcircuit's boundary evals are a gather, and the Merkle levels
     are hashed batched (hashes/poseidon_torch.py).

Products go through the Fr mont_mul kernel wrapper (the CUDA kernel on the
card, the plain version on the CPU). Roots, levels and leaves equal the host
tree's (protocol/eval_tree.py) bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields import torch_field as tf
from ..fields.bn254 import R
from ..fields.cuda_field import mont_mul
from ..fields.torch_field import FR
from ..hashes.poseidon_torch import merkle_levels_device
from . import eval_tree
from .eval_tree import ExecTreeLeaf, MerkleTree
from .transcript import new_running_evaluation, padding_entry


def _pack_mont(vals, device) -> torch.Tensor:
    return tf.tensor(FR.pack([int(v) % R for v in vals]), device)


def _terms(entries, challenges, device):
    """tr_chal - repr(entry) for a flat entry list, as (n, 16) Montgomery
    limbs: repr = val + entry_chal * addr (ROM), or val + c1 * addr + c2 *
    timestamp + c3 * read (RAM)."""
    val = _pack_mont([e.val for e in entries], device)
    addr = _pack_mont([e.addr for e in entries], device)
    if len(challenges) == 2:
        entry_chal, tr_chal = challenges
        rep = tf.add(FR, val, mont_mul(FR, addr, _pack_mont([entry_chal], device)[0]))
    else:
        c1, c2, c3, tr_chal = challenges
        ts = _pack_mont([e.timestamp for e in entries], device)
        rd = _pack_mont([int(e.read) for e in entries], device)
        rep = tf.add(FR, val, mont_mul(FR, addr, _pack_mont([c1], device)[0]))
        rep = tf.add(FR, rep, mont_mul(FR, ts, _pack_mont([c2], device)[0]))
        rep = tf.add(FR, rep, mont_mul(FR, rd, _pack_mont([c3], device)[0]))
    return tf.sub(FR, _pack_mont([tr_chal], device), rep)


def _prefix_products(terms: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product over axis 0: ceil(log2 n) steps, step d
    multiplying every row i >= d by row i - d of the step before."""
    x = terms
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], mont_mul(FR, x[d:].contiguous(), x[:-d].contiguous())])
        d *= 2
    return x


def generate_exec_tree_device(mem_type, super_com, time_sts, addr_sts, device="cuda"):
    """coordinator.generate_exec_tree's (tree, leaves), with the scan and the
    leaf and level hashing on `device` (the card unless the caller asks for
    the CPU). Poseidon only: the batched hash is Poseidon."""
    if eval_tree.TREE_HASH is not eval_tree.POSEIDON_TREE_HASH:
        raise ValueError("the device exec tree hashes with Poseidon only")
    evals0 = new_running_evaluation(mem_type, super_com.to_bytes())
    challenges = evals0.challenge_list()

    flat_time = [e for st in time_sts for e in st]
    flat_addr = [e for st in addr_sts for e in st]
    ns = len(time_sts)
    if flat_time:
        one = _pack_mont([1], device)
        t_scan = torch.cat([one, _prefix_products(_terms(flat_time, challenges, device))])
        a_scan = torch.cat([one, _prefix_products(_terms(flat_addr, challenges, device))])
        bounds = torch.from_numpy(np.cumsum([len(st) for st in time_sts])).to(device)  # eval after subcircuit i
        t_evals = FR.unpack(t_scan[bounds])
        a_evals = FR.unpack(a_scan[bounds])
    else:  # no portals anywhere: every running eval stays 1
        t_evals = a_evals = [1] * ns

    # leaves: (evals after subcircuit i, last addr-ordered entry of subtrace i)
    leaves = []
    last_entry = padding_entry(mem_type)
    for i in range(ns):
        if addr_sts[i]:
            last_entry = addr_sts[i][-1]
        ev = evals0.clone()
        ev.time_ordered_eval = t_evals[i]
        ev.addr_ordered_eval = a_evals[i]
        leaves.append(ExecTreeLeaf(ev, last_entry))

    fields = [leaf.to_field_elements() for leaf in leaves]
    cols = [_pack_mont([f[j] for f in fields], device) for j in range(len(fields[0]))]
    levels = [FR.unpack(lv) for lv in merkle_levels_device(cols)]
    return MerkleTree.from_levels(levels), leaves
