"""Verifiable Key Directory workload over a depth-128 sparse Merkle tree.

Behavioral equivalent of distributed-prover/src/vkd/vkd.rs and
vkd_constraints.rs: updates/appends are compiled to a flat list of subcircuits
built from 6 primitives (Padding, WritePublicParameter, HashLeaf, GetIndex,
ComputePath, Equality); every depth-128 path is split into SPLIT_FACTOR=4
chunks of 32 stitched through "intermediate root" portals, so one path spans 4
subcircuits (the reference's sequence-parallel decomposition, SURVEY.md §5).
Inner hashes are full Fr elements (see hash.py docstring for the deviation
rationale); subcircuit witnesses serialize with pickle instead of the
reference's NodeAddressBytes/CanonicalSerialize plumbing
(vkd_circuits.rs:26-103).
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass

from ...protocol.circuit_api import CircuitWithPortals
from ...protocol.portal_manager import SetupRomPortalManager
from ...r1cs.gadgets import FpVar
from .circuits import (
    ADDR_FINAL_ROOT,
    ADDR_INITIAL_ROOT,
    ADDR_NULL_LEAF,
    SPLIT_FACTOR,
    ComputePathPrimitive,
    EqualityPrimitive,
    GetIndexPrimitive,
    HashLeafPrimitive,
    PaddingPrimitive,
    SubCircuit,
    WritePublicParameterPrimitive,
    addr_index,
    addr_leaf_hash,
    vkd_update_to_subcircuit,
)
from .hash import hash_bytes, hash_bytes_var, hash_leaf, witness_chunks
from .sparse_tree import MerkleIndex, MerkleTreePath, MerkleTreePathVar, SparseMerkleTree

DEPTH = 128  # vkd.rs:28
PATH_LENGTH = DEPTH // SPLIT_FACTOR  # 32


def concat(username: bytes, key: bytes, counter: int) -> bytes:
    """66-byte leaf: username(32) | counter_le(2) | key(32) (vkd.rs:102-108)."""
    return username + counter.to_bytes(2, "little") + key


def null_leaf_value() -> int:
    """The empty-leaf hash (tree.sparse_initial_hashes[DEPTH])."""
    return SparseMerkleTree(0).root  # depth-0 tree root == hash_leaf(zeros)


@dataclass
class VkdUpdate:
    username: bytes
    counter: int
    key1: bytes
    path: MerkleTreePath
    key2: bytes


@dataclass
class VkdAppend:
    username: bytes
    key: bytes
    path: MerkleTreePath


@dataclass(frozen=True)
class VerifiableKeyDirectoryCircuitParams:
    log_num_subcircuits: int
    null_leaf: int


class VerifiableKeyDirectoryCircuit(CircuitWithPortals):
    MEM_TYPE = "rom"

    def __init__(self, initial_root, params, final_root, updates, subcircuits):
        self.initial_root = initial_root
        self.params = params
        self.final_root = final_root
        self.update = updates
        self.subcircuits = subcircuits

    # -- construction (vkd.rs:121-214) --------------------------------------

    @classmethod
    def random(cls, params: VerifiableKeyDirectoryCircuitParams):
        tree = SparseMerkleTree(DEPTH)
        users = {}
        # genesis user
        zero_user, zero_key = bytes(32), bytes(32)
        users[zero_user] = (0, zero_key)
        leaf_h = hash_bytes(zero_user)
        index = SparseMerkleTree.get_index(leaf_h, DEPTH)
        tree.insert(index, concat(zero_user, zero_key, 0), "leaf")
        initial_root = tree.root

        updates = []
        n = 1 << params.log_num_subcircuits
        num_of_updates = (n - 8) // 8 - 1

        # first: append a fresh user (vkd.rs:143-167)
        username, key = bytes([8] * 32), bytes(32)
        users[username] = (0, key)
        leaf_h = hash_bytes(username)
        index = SparseMerkleTree.get_index(leaf_h, DEPTH)
        path = tree.lookup_path(index)
        tree.insert(index, concat(username, key, 0), "leaf")
        updates.append(VkdAppend(username, key, path))

        # rest: updates of that same user (vkd.rs:168-204)
        for i in range(num_of_updates):
            counter, key1 = users[username]
            leaf_h = hash_bytes(username)
            index = SparseMerkleTree.get_index(leaf_h, DEPTH)
            path = tree.lookup_path(index)
            key2 = bytes([i % 256] * 32)
            users[username] = (counter + 1, key2)
            tree.insert(index, concat(username, key2, counter + 1), "leaf")
            updates.append(VkdUpdate(username, counter, key1, path, key2))

        return cls(initial_root, params, tree.root, updates, vkd_update_to_subcircuit(updates))

    def verify(self, pp: int) -> bool:
        """Native replay of all updates (vkd.rs:216-280)."""
        root = self.initial_root
        ok = True
        for u in self.update:
            if isinstance(u, VkdUpdate):
                leaf_h = hash_bytes(u.username)
                bits = SparseMerkleTree.get_index(leaf_h, DEPTH).to_bit_vector()
                ok &= u.path.verify(root, concat(u.username, u.key1, u.counter), bits, "leaf")
                root = u.path.compute_root(
                    concat(u.username, u.key2, u.counter + 1), bits, "leaf"
                )
            else:
                leaf_h = hash_bytes(u.username)
                bits = SparseMerkleTree.get_index(leaf_h, DEPTH).to_bit_vector()
                ok &= u.path.verify(root, pp, bits, "internal")
                root = u.path.compute_root(concat(u.username, u.key, 0), bits, "leaf")
        return ok and root == self.final_root

    # -- CircuitWithPortals (vkd_constraints.rs) -----------------------------

    @classmethod
    def rand(cls, rng, params):
        return cls.random(params)

    @classmethod
    def new(cls, params):
        return _CIRCUIT_CACHE.setdefault(params, cls.random(params))

    def get_params(self):
        return self.params

    def num_subcircuits(self):
        return 1 << self.params.log_num_subcircuits

    def get_unique_subcircuits(self):
        return [0, 6, 7, 8, 10, 19, self.num_subcircuits() - 1]

    def representative_subcircuit(self, idx):
        t = self.subcircuits[idx].get_type()
        table = {
            "padding": 0,
            "write pp": 6,
            "hash leaf, get index, compute path": 7,
            "compute path": 8,
            "compute path, equality": 10,
            "equality, hash leaf, compute path": 19,
            "equality": self.num_subcircuits() - 1,
        }
        return table[t]

    def get_serialized_witnesses(self, idx) -> bytes:
        return pickle.dumps(self.subcircuits[idx], protocol=4)

    def set_serialized_witnesses(self, idx, data: bytes):
        if data:
            self.subcircuits[idx] = pickle.loads(data)

    # -- native trace generation (vkd_constraints.rs:70-193) -----------------

    def get_portal_subtraces(self):
        pm = SetupRomPortalManager()
        index_memory: dict = {}
        node_memory: dict = {}
        for sub in self.subcircuits:
            pm.start_subtrace()
            for p in sub.compound_primitive_vec:
                if isinstance(p, WritePublicParameterPrimitive):
                    node_memory[ADDR_INITIAL_ROOT] = self.initial_root
                    node_memory[ADDR_FINAL_ROOT] = self.final_root
                    node_memory[ADDR_NULL_LEAF] = self.params.null_leaf
                    pm.set(ADDR_INITIAL_ROOT, self.initial_root)
                    pm.set(ADDR_FINAL_ROOT, self.final_root)
                    pm.set(ADDR_NULL_LEAF, self.params.null_leaf)
                elif isinstance(p, EqualityPrimitive):
                    pm.get(p.addr1)
                    pm.get(p.addr2)
                elif isinstance(p, GetIndexPrimitive):
                    leaf_h = hash_bytes(p.leaf[0:32])
                    bits = SparseMerkleTree.get_index(leaf_h, DEPTH).to_bit_vector()
                    for i in range(SPLIT_FACTOR):
                        addr = addr_index(i, p.leaf)
                        index_memory[addr] = bits[PATH_LENGTH * i : PATH_LENGTH * (i + 1)]
                        chunk_val = (leaf_h >> (PATH_LENGTH * i)) & ((1 << PATH_LENGTH) - 1)
                        pm.set(addr, chunk_val)
                elif isinstance(p, ComputePathPrimitive):
                    index_bits = index_memory[p.index_addr]
                    initial = node_memory[p.initial_value_addr]
                    pm.get(p.initial_value_addr)
                    pm.get(p.index_addr)
                    root = p.path.compute_root(initial, index_bits, "internal")
                    node_memory[p.final_value_addr] = root
                    pm.set(p.final_value_addr, root)
                elif isinstance(p, HashLeafPrimitive):
                    h = hash_leaf(p.leaf)
                    node_memory[addr_leaf_hash(p.leaf)] = h
                    pm.set(addr_leaf_hash(p.leaf), h)
                elif isinstance(p, PaddingPrimitive):
                    pass
                else:
                    raise TypeError(type(p))
        return pm.subtraces

    # -- in-circuit constraint generation (vkd_constraints.rs:237-341) -------

    def generate_constraints(self, cs, subcircuit_idx, pm):
        for p in self.subcircuits[subcircuit_idx].compound_primitive_vec:
            if isinstance(p, EqualityPrimitive):
                v1 = pm.get(p.addr1)
                v2 = pm.get(p.addr2)
                v1.enforce_equal(v2)
            elif isinstance(p, GetIndexPrimitive):
                chunks = witness_chunks(cs, p.leaf[0:32])
                h = hash_bytes_var(chunks)
                bits = h.to_canonical_bits()
                for i in range(SPLIT_FACTOR):
                    part = bits[PATH_LENGTH * i : PATH_LENGTH * (i + 1)]
                    acc = FpVar.constant(cs, 0)
                    for j, b in enumerate(part):
                        acc = acc + b.var.scale(1 << j)
                    pm.set(addr_index(i, p.leaf), acc)
            elif isinstance(p, ComputePathPrimitive):
                initial = pm.get(p.initial_value_addr)
                index_fp = pm.get(p.index_addr)
                index_bits = index_fp.to_bits_le(PATH_LENGTH)
                path_var = MerkleTreePathVar(cs, p.path)
                root = path_var.compute_root_var_from_internal_node(initial, index_bits)
                pm.set(p.final_value_addr, root)
            elif isinstance(p, HashLeafPrimitive):
                chunks = witness_chunks(cs, p.leaf)
                h = hash_bytes_var(chunks)
                pm.set(addr_leaf_hash(p.leaf), h)
            elif isinstance(p, WritePublicParameterPrimitive):
                pm.set(ADDR_INITIAL_ROOT, FpVar.witness(cs, self.initial_root))
                pm.set(ADDR_FINAL_ROOT, FpVar.witness(cs, self.final_root))
                pm.set(ADDR_NULL_LEAF, FpVar.witness(cs, self.params.null_leaf))
            elif isinstance(p, PaddingPrimitive):
                pass
            else:
                raise TypeError(type(p))


# reference memoizes circuit construction per params (vkd_constraints.rs:26-51)
_CIRCUIT_CACHE: dict = {}
