"""Execution tree: Poseidon Merkle tree over per-subcircuit protocol state.

Leaf i = (running evals AFTER subcircuit i, last addr-ordered entry of
subtrace i) — distributed-prover/src/eval_tree.rs:53-79.
Host tree construction + auth paths, and the in-circuit membership gadget
(equivalent of ark MerkleTree + PathVar over the Poseidon tree config from
poseidon_util.rs).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..hashes import poseidon as pos
from ..r1cs.gadgets import Boolean, FpVar
from .transcript import (
    RamTranscriptEntryVar,
    RomTranscriptEntryVar,
    default_running_evaluation,
    padding_entry,
    witness_entry_var,
    witness_evals_var,
)


class ExecTreeLeaf:
    def __init__(self, evals, last_subtrace_entry):
        self.evals = evals
        self.last_subtrace_entry = last_subtrace_entry

    @staticmethod
    def padding(mem_type: str) -> "ExecTreeLeaf":
        return ExecTreeLeaf(default_running_evaluation(mem_type), padding_entry(mem_type))

    def to_field_elements(self) -> list:
        return [
            self.evals.time_ordered_eval,
            self.evals.addr_ordered_eval,
        ] + self.last_subtrace_entry.to_field_elements()


class ExecTreeLeafVar:
    def __init__(self, evals_var, last_subtrace_entry_var):
        self.evals = evals_var
        self.last_subtrace_entry = last_subtrace_entry_var

    @staticmethod
    def witness(cs, leaf: ExecTreeLeaf) -> "ExecTreeLeafVar":
        return ExecTreeLeafVar(
            witness_evals_var(cs, leaf.evals), witness_entry_var(cs, leaf.last_subtrace_entry)
        )

    def to_field_elements(self) -> list:
        return [
            self.evals.time_ordered_eval,
            self.evals.addr_ordered_eval,
        ] + self.last_subtrace_entry.to_field_elements()


# ---------------------------------------------------------------------------
# Tree hash configs — the reference abstracts the exec tree's leaf/2-to-1
# hashes behind ExecTreeParams (eval_tree.rs:17-40); here a TreeHash bundles
# host + in-circuit versions. Poseidon (poseidon_util.rs params) is the
# production default; AlgebraicTestHash is a ~2-constraint-per-absorb stand-in
# for runtime/integration tests where Poseidon's ~1k constraints/hash would
# dominate what is being tested (it is NOT collision resistant).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TreeHash:
    name: str
    hash_leaf: object  # list[int] -> int
    hash_two_to_one: object  # (int, int) -> int
    hash_leaf_var: object  # list[FpVar] -> FpVar
    hash_two_to_one_var: object  # (FpVar, FpVar) -> FpVar


POSEIDON_TREE_HASH = TreeHash(
    "poseidon", pos.hash_leaf, pos.hash_two_to_one, pos.hash_leaf_var, pos.hash_two_to_one_var
)


def _alg_leaf(elems: list) -> int:
    from ..fields.bn254 import R

    acc = 3
    for x in elems:
        acc = (acc * acc + acc * (x % R) + 7) % R
    return acc


def _alg_two(l: int, r: int) -> int:
    from ..fields.bn254 import R

    return (l * l + 3 * l * r + 2 * r + 5) % R


def _alg_leaf_var(elems: list) -> FpVar:
    cs = elems[0].cs
    acc = FpVar.constant(cs, 3)
    for x in elems:
        acc = acc * acc + acc * x + 3  # reassociated: (acc+x)*acc + ... keep 2 muls
        acc = acc + 4  # total +7 split to keep value identical to _alg_leaf
    return acc


def _alg_two_var(l: FpVar, r: FpVar) -> FpVar:
    return l * l + (l * r).scale(3) + r.scale(2) + 5


ALGEBRAIC_TEST_HASH = TreeHash("algebraic-test", _alg_leaf, _alg_two, _alg_leaf_var, _alg_two_var)

# module default, switchable for tests (set_tree_hash); production = Poseidon
TREE_HASH = POSEIDON_TREE_HASH


def set_tree_hash(th: TreeHash) -> TreeHash:
    """Swap the exec-tree hash; returns the previous config (for restoring).
    Must be set identically on coordinator and workers (it is part of the
    circuit, hence of the CRS)."""
    global TREE_HASH
    prev = TREE_HASH
    TREE_HASH = th
    return prev


@dataclass
class MerklePath:
    leaf_index: int
    auth_path: list  # sibling digests, leaf level first


class MerkleTree:
    def __init__(self, serialized_leaves: list):
        n = len(serialized_leaves)
        assert n & (n - 1) == 0 and n >= 2, "leaf count must be a power of two >= 2"
        self.n = n
        level = [TREE_HASH.hash_leaf(leaf) for leaf in serialized_leaves]
        self.levels = [level]
        while len(level) > 1:
            level = [
                TREE_HASH.hash_two_to_one(level[i], level[i + 1])
                for i in range(0, len(level), 2)
            ]
            self.levels.append(level)

    @classmethod
    def from_levels(cls, levels: list) -> "MerkleTree":
        """Wrap precomputed digest levels (leaf-hash level first) — used by
        the device tree builder (eval_tree_jax.py), which hashes levels
        batched instead of via the host loop above."""
        tree = cls.__new__(cls)
        tree.n = len(levels[0])
        tree.levels = levels
        assert len(levels[-1]) == 1
        return tree

    def root(self) -> int:
        return self.levels[-1][0]

    def generate_proof(self, leaf_index: int) -> MerklePath:
        auth = []
        idx = leaf_index
        for level in self.levels[:-1]:
            auth.append(level[idx ^ 1])
            idx >>= 1
        return MerklePath(leaf_index, auth)


def verify_path_host(root: int, path: MerklePath, serialized_leaf: list) -> bool:
    cur = TREE_HASH.hash_leaf(serialized_leaf)
    idx = path.leaf_index
    for sib in path.auth_path:
        cur = (
            TREE_HASH.hash_two_to_one(sib, cur)
            if idx & 1
            else TREE_HASH.hash_two_to_one(cur, sib)
        )
        idx >>= 1
    return cur == root


# ---------------------------------------------------------------------------
# In-circuit path verification
# ---------------------------------------------------------------------------


class MerklePathVar:
    """Witnessed auth path + position bits (like ark PathVar: the position is
    a witness so same-shape subcircuits can share one CRS)."""

    def __init__(self, siblings: list, position_bits: list):
        self.siblings = siblings  # [FpVar]
        self.position_bits = position_bits  # [Boolean], leaf level first

    @staticmethod
    def witness(cs, path: MerklePath) -> "MerklePathVar":
        sibs = [FpVar.witness(cs, s) for s in path.auth_path]
        bits = [Boolean.witness(cs, (path.leaf_index >> i) & 1) for i in range(len(path.auth_path))]
        return MerklePathVar(sibs, bits)

    def verify_membership(self, root: FpVar, serialized_leaf_vars: list):
        cur = TREE_HASH.hash_leaf_var(serialized_leaf_vars)
        for sib, bit in zip(self.siblings, self.position_bits):
            left = bit.select(sib, cur)
            right = bit.select(cur, sib)
            cur = TREE_HASH.hash_two_to_one_var(left, right)
        cur.enforce_equal(root)
