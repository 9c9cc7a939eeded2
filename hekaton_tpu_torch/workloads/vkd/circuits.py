"""VKD subcircuit primitives, portal addressing, and the update->subcircuit
compiler.

Behavioral equivalent of
distributed-prover/src/vkd/vkd_circuits.rs (addresses and the
6 primitive subcircuit types) and vkd/vkd.rs:362-617 (vkd_update_to_subcircuit).
Addresses are carried directly as the portal-name strings the reference's
to_string() methods produce (vkd_circuits.rs:100-198); the byte-roundtrip
NodeAddressBytes layer is unnecessary here because subcircuits serialize with
pickle (vkd.py).
"""
from __future__ import annotations

from dataclasses import dataclass

from .sparse_tree import MerkleTreePath

SPLIT_FACTOR = 4  # vkd/vkd.rs:29


# -- portal-name constructors (vkd_circuits.rs to_string formats) -------------


def addr_path_root(path_id: int, update_idx: int) -> str:
    return f"path root {path_id} {update_idx}"


def addr_intermediate_root(path_id: int, indicator: int, update_idx: int) -> str:
    return f"intermediate root {path_id} {indicator} {update_idx}"


def addr_leaf_hash(leaf: bytes) -> str:
    return f"leaf hash {leaf.hex()}"


def addr_index(indicator: int, leaf: bytes) -> str:
    return f"index {indicator} {leaf[0:32].hex()}"


ADDR_NULL_LEAF = "null leaf"
ADDR_INITIAL_ROOT = "initial root"
ADDR_FINAL_ROOT = "final root"


# -- primitives ----------------------------------------------------------------


@dataclass
class EqualityPrimitive:
    update_idx: int
    addr1: str
    addr2: str
    TYPE = "equality"


@dataclass
class GetIndexPrimitive:
    update_idx: int
    leaf: bytes
    TYPE = "get index"


@dataclass
class ComputePathPrimitive:
    update_idx: int
    path_id: int
    indicator: int
    initial_value_addr: str
    final_value_addr: str
    index_addr: str
    path: MerkleTreePath
    TYPE = "compute path"


@dataclass
class HashLeafPrimitive:
    leaf: bytes
    TYPE = "hash leaf"


@dataclass
class PaddingPrimitive:
    TYPE = "padding"


@dataclass
class WritePublicParameterPrimitive:
    TYPE = "write pp"


@dataclass
class SubCircuit:
    compound_primitive_vec: list

    def get_type(self) -> str:
        return ", ".join(p.TYPE for p in self.compound_primitive_vec)


# -- update -> subcircuit compiler (vkd.rs:362-617) -----------------------------


def get_previous_root_addr(update_idx: int) -> str:
    """vkd.rs:539-558 get_previous_root_from_update_idx."""
    if update_idx == 0:
        return ADDR_INITIAL_ROOT
    return addr_path_root(1, update_idx - 1)


def get_node_addresses(update_idx: int, path_id: int, initial_node: str) -> list:
    """Per-chunk (input, output) addresses for a split path (vkd.rs:560-607)."""
    res = []
    for i in range(SPLIT_FACTOR):
        if i == 0:
            res.append((initial_node, addr_intermediate_root(path_id, i, update_idx)))
        elif i == SPLIT_FACTOR - 1:
            res.append(
                (
                    addr_intermediate_root(path_id, i - 1, update_idx),
                    addr_path_root(path_id, update_idx),
                )
            )
        else:
            res.append(
                (
                    addr_intermediate_root(path_id, i - 1, update_idx),
                    addr_intermediate_root(path_id, i, update_idx),
                )
            )
    return res


def vkd_update_to_subcircuit(updates: list) -> list:
    """updates: list of VkdUpdate/VkdAppend (vkd.py). Mirrors vkd.rs:362-617."""
    from .vkd import VkdAppend, VkdUpdate, concat

    subcircuits = []

    for _ in range(6):
        subcircuits.append(SubCircuit([PaddingPrimitive()]))
    subcircuits.append(SubCircuit([WritePublicParameterPrimitive()]))

    for update_idx, u in enumerate(updates):
        if isinstance(u, VkdUpdate):
            leaf1 = concat(u.username, u.key1, u.counter)
            split_path = u.path.split(SPLIT_FACTOR)
            # path 0: recompute the old root from the old leaf
            node_vector = get_node_addresses(update_idx, 0, addr_leaf_hash(leaf1))
            for i in range(SPLIT_FACTOR):
                subcircuits.append(
                    SubCircuit(
                        [
                            ComputePathPrimitive(
                                update_idx, 0, i, node_vector[i][0], node_vector[i][1],
                                addr_index(i, leaf1), split_path[i],
                            )
                        ]
                    )
                )
            # equality with the previous root + new-leaf hash + path-1 chunk 0
            c = SubCircuit(
                [
                    EqualityPrimitive(
                        update_idx,
                        addr_path_root(0, update_idx),
                        get_previous_root_addr(update_idx),
                    )
                ]
            )
            leaf2 = concat(u.username, u.key2, u.counter + 1)
            c.compound_primitive_vec.append(HashLeafPrimitive(leaf2))
            node_vector = get_node_addresses(update_idx, 1, addr_leaf_hash(leaf2))
            for i in range(SPLIT_FACTOR):
                prim = ComputePathPrimitive(
                    update_idx, 1, i, node_vector[i][0], node_vector[i][1],
                    addr_index(i, leaf1), split_path[i],
                )
                if i == 0:
                    c.compound_primitive_vec.append(prim)
                    subcircuits.append(c)
                else:
                    subcircuits.append(SubCircuit([prim]))
        else:
            assert isinstance(u, VkdAppend)
            leaf = concat(u.username, u.key, 0)
            split_path = u.path.split(SPLIT_FACTOR)
            c = SubCircuit([HashLeafPrimitive(leaf)])
            c.compound_primitive_vec.append(GetIndexPrimitive(update_idx, leaf))
            # path 0: prove the slot was empty (null leaf)
            node_vector = get_node_addresses(update_idx, 0, ADDR_NULL_LEAF)
            last = None
            for i in range(SPLIT_FACTOR):
                prim = ComputePathPrimitive(
                    update_idx, 0, i, node_vector[i][0], node_vector[i][1],
                    addr_index(i, leaf), split_path[i],
                )
                if i == 0:
                    c.compound_primitive_vec.append(prim)
                    subcircuits.append(c)
                elif i == SPLIT_FACTOR - 1:
                    last = SubCircuit([prim])
                else:
                    subcircuits.append(SubCircuit([prim]))
            last.compound_primitive_vec.append(
                EqualityPrimitive(
                    update_idx,
                    addr_path_root(0, update_idx),
                    get_previous_root_addr(update_idx),
                )
            )
            subcircuits.append(last)
            # path 1: the new root with the inserted leaf
            node_vector = get_node_addresses(update_idx, 1, addr_leaf_hash(leaf))
            for i in range(SPLIT_FACTOR):
                subcircuits.append(
                    SubCircuit(
                        [
                            ComputePathPrimitive(
                                update_idx, 1, i, node_vector[i][0], node_vector[i][1],
                                addr_index(i, leaf), split_path[i],
                            )
                        ]
                    )
                )

    subcircuits.append(
        SubCircuit(
            [
                EqualityPrimitive(
                    len(updates) - 1,
                    ADDR_FINAL_ROOT,
                    get_previous_root_addr(len(updates)),
                )
            ]
        )
    )
    return subcircuits
