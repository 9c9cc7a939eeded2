"""Sparse Merkle tree (depth 128) over Fr inner hashes, native + path gadget.

Behavioral equivalent of
distributed-prover/src/vkd/sparse_tree.rs and
sparse_tree_constraints.rs, with inner hashes as field elements (see hash.py).

Index convention (sparse_tree.rs:24-37): bit j of the index (LSB-first) gives
the position at depth DEPTH-j; `to_bit_vector()[j] = (bit j == 0)`, and the
native compute_root hashes (current, sibling) when that bit-vector entry is
true (= node is a left child). The in-circuit version consumes the RAW bits
(not negated) and selects the opposite way (sparse_tree_constraints.rs:37-40)
— the double negation cancels; we keep both conventions for parity.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ...r1cs.gadgets import FpVar
from .hash import hash_inner_node, hash_inner_node_var, hash_leaf

INITIAL_LEAF_VALUE = bytes(32)


@dataclass(frozen=True)
class MerkleIndex:
    index: int
    depth: int

    def to_bit_vector(self) -> list:
        return [(self.index >> j) & 1 == 0 for j in range(self.depth)]


class SparseMerkleTree:
    def __init__(self, depth: int):
        self.depth = depth
        # sparse_initial_hashes[d] = hash of an empty subtree whose root is at
        # depth d (sparse_tree.rs:72-80)
        hashes = [hash_leaf(INITIAL_LEAF_VALUE)]
        for _ in range(depth):
            hashes.append(hash_inner_node(hashes[-1], hashes[-1]))
        hashes.reverse()
        self.sparse_initial_hashes = hashes
        self.tree: dict = {}
        self.leaves: dict = {}
        self.root = hashes[0]

    def insert(self, index: MerkleIndex, value, node_type: str):
        """node_type: 'leaf' (value: bytes, hashed) or 'internal' (value: int)."""
        i = index.index
        if node_type == "leaf":
            self.leaves[index] = bytes(value)
            node_hash = hash_leaf(bytes(value))
        else:
            node_hash = int(value)
        self.tree[(i, index.depth)] = node_hash
        for d in range(index.depth - 1, -1, -1):
            i >>= 1
            lc, rc = i << 1, (i << 1) + 1
            lh = self.lookup_internal_node(lc, d + 1)[0]
            rh = self.lookup_internal_node(rc, d + 1)[0]
            self.tree[(i, d)] = hash_inner_node(lh, rh)
        self.root = self.tree[(0, 0)]

    def lookup_internal_node(self, index: int, depth: int):
        key = (index, depth)
        if key in self.tree:
            return self.tree[key], True
        return self.sparse_initial_hashes[depth], False

    def lookup_path(self, index: MerkleIndex) -> "MerkleTreePath":
        path = []
        i = index.index
        for d in range(index.depth, 0, -1):
            path.append(self.lookup_internal_node(i ^ 1, d)[0])
            i >>= 1
        return MerkleTreePath(path)

    @staticmethod
    def get_index(leaf_hash: int, depth: int) -> MerkleIndex:
        """Low `depth` bits of the leaf hash (sparse_tree.rs:170-177 reads the
        first depth/8 LE bytes of the digest = hash mod 2^depth)."""
        return MerkleIndex(leaf_hash & ((1 << depth) - 1), depth)


@dataclass
class MerkleTreePath:
    path: list = field(default_factory=list)  # sibling hashes, leaf-level first

    def compute_root(self, value, index_bits: list, node_type: str) -> int:
        """index_bits: to_bit_vector() convention (True = left child)."""
        cur = hash_leaf(bytes(value)) if node_type == "leaf" else int(value)
        for bit, sibling in zip(index_bits, self.path):
            cur = hash_inner_node(cur, sibling) if bit else hash_inner_node(sibling, cur)
        return cur

    def verify(self, root: int, value, index_bits: list, node_type: str) -> bool:
        return self.compute_root(value, index_bits, node_type) == root

    def split(self, split_factor: int) -> list:
        assert split_factor in (2, 4, 8, 16)
        parts = [self.path]
        length = len(self.path)
        while split_factor != 1:
            length //= 2
            split_factor //= 2
            parts = [half for part in parts for half in (part[:length], part[length:])]
        return [MerkleTreePath(p) for p in parts]


class MerkleTreePathVar:
    """Witnessed sibling path; roots recomputed with RAW index bits
    (sparse_tree_constraints.rs:31-58): bit=0 -> current node is left child."""

    def __init__(self, cs, path: MerkleTreePath):
        self.path = [FpVar.witness(cs, h) for h in path.path]

    def compute_root_var_from_internal_node(self, internal_node: FpVar, index_bits: list) -> FpVar:
        cur = internal_node
        for b, sibling in zip(index_bits, self.path):
            lc = b.select(sibling, cur)
            rc = b.select(cur, sibling)
            cur = hash_inner_node_var(lc, rc)
        return cur
