"""Big-Merkle workload: a binary Merkle tree of iterated SHA-256 hashes.

Behavioral equivalent of distributed-prover/src/tree_hash_circuit.rs:
one subcircuit per tree node (2*num_leaves subcircuits incl. one padding),
MLS-style node indexing (level = trailing ones), parents read child hashes via
portal wires, digests truncated to 27 bytes and embedded in Fr, tunable knobs
(num_leaves, num_sha_iters_per_subcircuit, num_portals_per_subcircuit), and a
fast native trace generator that avoids in-circuit hashing.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..hashes import sha256_gadget as shag
from ..protocol.circuit_api import CircuitWithPortals
from ..r1cs.gadgets import FpVar
from ..protocol.portal_manager import SetupRomPortalManager

INNER_HASH_SIZE = 27
LEAF_SIZE = 64
EMPTY_LEAF = bytes(LEAF_SIZE)


@dataclass(frozen=True)
class MerkleTreeCircuitParams:
    num_leaves: int
    num_sha_iters_per_subcircuit: int
    num_portals_per_subcircuit: int


# ---- MLS-style tree math (tree_hash_circuit.rs:560-611) ----


def _level(node: int) -> int:
    k = 0
    while node & 1:
        k += 1
        node >>= 1
    return k


def _left_child(node: int) -> int:
    k = _level(node)
    return node ^ (1 << (k - 1))


def _right_child(node: int) -> int:
    k = _level(node)
    return node ^ (3 << (k - 1))


def _root_idx(num_leaves: int) -> int:
    w = 2 * (num_leaves - 1) + 1 if num_leaves >= 2 else 0
    return (1 << (w.bit_length() - 1)) - 1


def _subcircuit_idx_to_node_idx(subcircuit_idx: int, num_leaves: int) -> int:
    i = 0
    log_leaves = (num_leaves - 1).bit_length() if num_leaves > 1 else 0
    for level in range(_level(_root_idx(num_leaves)) + 1):
        upper_half_size = log_leaves - level
        trailing_ones = (1 << level) - 1
        for upper_half in range(1 << upper_half_size):
            node_idx = (upper_half << (level + 1)) + trailing_ones
            if i == subcircuit_idx:
                return node_idx
            i += 1
    raise ValueError(f"invalid subcircuit idx {subcircuit_idx}")


def _iterated_sha256(data: bytes, iters: int) -> bytes:
    digest = data
    for _ in range(iters):
        digest = hashlib.sha256(digest).digest()
    return digest


def calculate_root(leaves: list, params: MerkleTreeCircuitParams) -> bytes:
    it = lambda d: _iterated_sha256(d, params.num_sha_iters_per_subcircuit)[:INNER_HASH_SIZE]
    cur = [it(leaf) for leaf in leaves]
    while len(cur) > 1:
        cur = [it(cur[i] + cur[i + 1]) for i in range(0, len(cur), 2)]
    return cur[0]


class MerkleTreeCircuit(CircuitWithPortals):
    MEM_TYPE = "rom"

    def __init__(self, leaves: list, root_hash: bytes, params: MerkleTreeCircuitParams):
        self.leaves = leaves
        self.root_hash = root_hash
        self.params = params

    @classmethod
    def rand(cls, rng, params: MerkleTreeCircuitParams):
        leaves = [rng.next_bytes(LEAF_SIZE) for _ in range(params.num_leaves)]
        return cls(leaves, calculate_root(leaves, params), params)

    @classmethod
    def new(cls, params: MerkleTreeCircuitParams):
        assert params.num_sha_iters_per_subcircuit > 0
        return cls([EMPTY_LEAF] * params.num_leaves, bytes(INNER_HASH_SIZE), params)

    def get_params(self):
        return self.params

    def num_subcircuits(self) -> int:
        return 2 * len(self.leaves)

    def get_unique_subcircuits(self) -> list:
        n = self.num_subcircuits()
        out = []
        for i in (0, 1, n - 1, n - 2, n - 3):
            if i not in out:
                out.append(i)
        return out

    def representative_subcircuit(self, idx: int) -> int:
        n = self.num_subcircuits()
        if idx == 0:
            return 0
        if 1 <= idx < n // 2:
            return 1
        if n // 2 <= idx <= n - 3:
            return n - 3
        if idx == n - 1:
            return n - 1
        if idx == n - 2:
            return n - 2
        raise ValueError(idx)

    def get_serialized_witnesses(self, idx: int) -> bytes:
        n = self.num_subcircuits()
        if idx == n - 1:
            return b""
        node_idx = _subcircuit_idx_to_node_idx(idx, len(self.leaves))
        if _level(node_idx) == 0:
            return self.leaves[node_idx // 2]
        if node_idx == _root_idx(len(self.leaves)):
            return self.root_hash
        return b""

    def set_serialized_witnesses(self, idx: int, data: bytes):
        n = self.num_subcircuits()
        if idx == n - 1 or not data:
            return
        node_idx = _subcircuit_idx_to_node_idx(idx, len(self.leaves))
        if _level(node_idx) == 0:
            self.leaves[node_idx // 2] = data
        elif node_idx == _root_idx(len(self.leaves)):
            self.root_hash = data

    # -- constraint generation -------------------------------------------------
    def _iterated_sha256_var(self, cs, input_bytes: list) -> FpVar:
        digest = input_bytes
        for _ in range(self.params.num_sha_iters_per_subcircuit):
            digest = shag.sha256_digest_var(cs, digest)
        return shag.digest_bytes_to_fpvar(digest, INNER_HASH_SIZE)

    def generate_constraints(self, cs, subcircuit_idx: int, pm):
        n = self.num_subcircuits()
        num_leaves = len(self.leaves)
        is_padding = subcircuit_idx == n - 1

        if is_padding:
            inp = shag.witness_bytes(cs, EMPTY_LEAF)
            self._iterated_sha256_var(cs, inp)
        else:
            node_idx = _subcircuit_idx_to_node_idx(subcircuit_idx, num_leaves)
            is_leaf = _level(node_idx) == 0
            is_root = node_idx == _root_idx(num_leaves)
            if is_leaf:
                leaf_var = shag.witness_bytes(cs, self.leaves[node_idx // 2])
                leaf_hash = self._iterated_sha256_var(cs, leaf_var)
                pm.set(f"node {node_idx} hash", leaf_hash)
            else:
                left = _left_child(node_idx)
                right = _right_child(node_idx)
                left_hash = pm.get(f"node {left} hash")
                right_hash = pm.get(f"node {right} hash")
                concat = shag.fpvar_to_digest_bytes(left_hash, INNER_HASH_SIZE) + \
                    shag.fpvar_to_digest_bytes(right_hash, INNER_HASH_SIZE)
                parent_hash = self._iterated_sha256_var(cs, concat)
                pm.set(f"node {node_idx} hash", parent_hash)
                if is_root:
                    expected = FpVar.witness(cs, shag.digest_to_int(self.root_hash, INNER_HASH_SIZE))
                    parent_hash.enforce_equal(expected)

        if subcircuit_idx == 0:
            pm.set("placeholder", FpVar.witness(cs, 0))
        for _ in range(self.params.num_portals_per_subcircuit - 1):
            pm.get("placeholder")

    # -- fast native trace (tree_hash_circuit.rs:402-515) -----------------------
    def get_portal_subtraces(self) -> list:
        num_leaves = len(self.leaves)
        n = self.num_subcircuits()
        iters = self.params.num_sha_iters_per_subcircuit
        pm = SetupRomPortalManager()

        def dummy_ops():
            for _ in range(self.params.num_portals_per_subcircuit - 1):
                pm.get("placeholder")

        for sc_idx, leaf in enumerate(self.leaves):
            pm.start_subtrace()
            node_idx = _subcircuit_idx_to_node_idx(sc_idx, num_leaves)
            leaf_hash = _iterated_sha256(leaf, iters)
            pm.set(f"node {node_idx} hash", shag.digest_to_int(leaf_hash, INNER_HASH_SIZE))
            if sc_idx == 0:
                pm.set("placeholder", 0)
            dummy_ops()

        for sc_idx in range(num_leaves, n - 1):
            pm.start_subtrace()
            node_idx = _subcircuit_idx_to_node_idx(sc_idx, num_leaves)
            left = _left_child(node_idx)
            right = _right_child(node_idx)
            lv = pm.get(f"node {left} hash")
            rv = pm.get(f"node {right} hash")
            lb = lv.to_bytes(32, "little")[:INNER_HASH_SIZE]
            rb = rv.to_bytes(32, "little")[:INNER_HASH_SIZE]
            parent = _iterated_sha256(lb + rb, iters)
            pm.set(f"node {node_idx} hash", shag.digest_to_int(parent, INNER_HASH_SIZE))
            dummy_ops()

        pm.start_subtrace()
        dummy_ops()
        return pm.subtraces
