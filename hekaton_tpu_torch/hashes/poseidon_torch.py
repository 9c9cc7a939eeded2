"""Batched Poseidon permutation and sponge over BN254 Fr on torch tensors.

Port of hekaton_tpu/hashes/poseidon_jax.py: one permutation runs over a
whole batch of lanes, so a level of the exec tree's Poseidon Merkle tree is
one batched computation (protocol/eval_tree_torch.py). Values are (..., 16)
int32 Montgomery Fr limbs (fields/torch_field.py). Products go through the
Fr mont_mul kernel wrapper (fields/cuda_field.py): its CUDA kernel for
CUDA tensors, its plain version for CPU tensors; additions are the plain
formulas. The parameters come from the port's host Poseidon
(hashes/poseidon.py, the same Grain-LFSR derivation), so the digests equal
the host's and the R1CS gadget's.
"""
from __future__ import annotations

import functools

import torch

from ..fields import torch_field as tf
from ..fields.cuda_field import mont_mul
from ..fields.torch_field import FR
from . import poseidon as pos


@functools.lru_cache(maxsize=None)
def _device_consts(rate: int, device: str):
    """(cfg, ark, mds) of the rate-`rate` config, ark (rounds, width, 16)
    and mds (width, width, 16) Montgomery limbs on `device`."""
    cfg = pos.leaf_config() if rate == 3 else pos.two_to_one_config()
    ark = torch.stack([tf.tensor(FR.pack(row), device) for row in cfg.ark])
    mds = torch.stack([tf.tensor(FR.pack(row), device) for row in cfg.mds])
    return cfg, ark, mds


def _mul(a, b):
    """a * b in Fr; b is a's shape or one (16,) constant."""
    return mont_mul(FR, a.contiguous(), b.contiguous())


def _pow_alpha(x, alpha: int):
    """x^alpha for alpha in {5, 17}: a square chain and one multiply."""
    acc = x
    n = 1
    while n * 2 <= alpha - 1:
        acc = _mul(acc, acc)
        n *= 2
    return _mul(acc, x)


def permute_batch(rate: int, state: list) -> list:
    """One Poseidon permutation of a list of rate+1 batched Fr columns."""
    cfg, ark, mds = _device_consts(rate, str(state[0].device))
    width = cfg.rate + 1
    half = cfg.full_rounds // 2
    total = cfg.full_rounds + cfg.partial_rounds
    for rnd in range(total):
        state = [tf.add(FR, s, ark[rnd, i]) for i, s in enumerate(state)]
        if rnd < half or rnd >= half + cfg.partial_rounds:
            state = [_pow_alpha(s, cfg.alpha) for s in state]
        else:
            state = [_pow_alpha(state[0], cfg.alpha)] + state[1:]
        new = []
        for i in range(width):
            acc = _mul(state[0], mds[i, 0])
            for j in range(1, width):
                acc = tf.add(FR, acc, _mul(state[j], mds[i, j]))
            new.append(acc)
        state = new
    return state


def sponge_hash_batch(rate: int, cols: list):
    """Absorb the batched columns (arkworks CRH: add into state[1 + i],
    permute on a full rate) and squeeze one column."""
    zero = torch.zeros(cols[0].shape[:-1] + (FR.nlimbs,), dtype=torch.int32, device=cols[0].device)
    state = [zero] * (rate + 1)
    idx = 0
    for col in cols:
        if idx == rate:
            state = permute_batch(rate, state)
            idx = 0
        state[1 + idx] = tf.add(FR, state[1 + idx], col)
        idx += 1
    return permute_batch(rate, state)[1]


def hash_leaf_batch(cols: list):
    return sponge_hash_batch(3, cols)


def hash_two_to_one_batch(left, right):
    return sponge_hash_batch(2, [left, right])


def merkle_levels_device(leaf_cols: list) -> list:
    """The Poseidon Merkle tree of the leaf columns: the level digests, leaf
    hashes first and the root last (protocol.eval_tree.MerkleTree.levels)."""
    level = hash_leaf_batch(leaf_cols)
    levels = [level]
    while level.shape[0] > 1:
        level = hash_two_to_one_batch(level[0::2], level[1::2])
        levels.append(level)
    return levels
