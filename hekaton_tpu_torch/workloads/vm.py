"""Mock zkVM workload: chunked execution with RAM-portal register state.

Behavioral equivalent of distributed-prover/src/vm/
(vm.rs, vm_constraints.rs, memory.rs): 16 registers carried between cycle
chunks through RAM portals (vm/vm.rs:4-9); each chunk reads the registers,
runs `operations_per_chunk` dummy cycles of `dummy_constraint_num` constraints
each (vm_constraints.rs:109-151), and writes the registers back. Only two
unique subcircuit shapes (vm_constraints.rs:91-97).

`use_merkle_memory` mode: each memory op is replaced by depth-32 Merkle path
verification(s) — one per `get`, two per `set` (vm/memory.rs:28-52, the
Merkle-memory cost model). Deliberate deviation from the reference: its
native trace generator still records portal entries in this mode
(vm_constraints.rs:29-85) while its constraints consume none, so its leaves
can never verify distributed; here the native subtraces are empty in Merkle
mode, keeping the full pipeline sound (the permutation argument closes over
zero entries).

The calibration constant VM_CONSTRAINTS_PER_CYCLE = 1114 (vnTinyRAM, cited at
mpi-snark/src/lib.rs:120-122) maps `dummy_constraint_num` to real VM cycles.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from ..protocol.circuit_api import CircuitWithPortals
from ..protocol.portal_manager import SetupRamPortalManager
from ..r1cs.gadgets import Boolean, FpVar

REGISTER_NUM = 16  # vm/vm.rs:4
VM_CONSTRAINTS_PER_CYCLE = 1114  # mpi-snark/src/lib.rs:120-122
MERKLE_MEMORY_DEPTH = 32  # vm/memory.rs:12


@functools.lru_cache(maxsize=1)
def _merkle_memory_fixture():
    """The synthetic depth-32 tree/path the cost model verifies against
    (vm/memory.rs:55-97): a single all-ones leaf inserted at the index
    derived from its own hash."""
    from .vkd.hash import hash_leaf
    from .vkd.sparse_tree import SparseMerkleTree

    leaf = bytes([1]) * 32
    tree = SparseMerkleTree(MERKLE_MEMORY_DEPTH)
    leaf_hash = hash_leaf(leaf)
    index = SparseMerkleTree.get_index(leaf_hash, MERKLE_MEMORY_DEPTH)
    tree.insert(index, leaf, "leaf")
    path = tree.lookup_path(index)
    return leaf, index, path


def merkle_path_verification(cs):
    """One in-circuit depth-32 path verification: witness the leaf bytes,
    hash them, recompute the root along the witnessed sibling path
    (vm/memory.rs:55-97). The root is left unconstrained exactly as in the
    reference — this is a constraint-cost model for Merkle memory, not a
    binding memory argument."""
    from .vkd.hash import hash_bytes_var, witness_chunks
    from .vkd.sparse_tree import MerkleTreePathVar

    leaf, index, path = _merkle_memory_fixture()
    leaf_var = hash_bytes_var(witness_chunks(cs, leaf))
    bits = [Boolean.witness(cs, (index.index >> j) & 1) for j in range(MERKLE_MEMORY_DEPTH)]
    pv = MerkleTreePathVar(cs, path)
    _ = pv.compute_root_var_from_internal_node(leaf_var, bits)


@dataclass(frozen=True)
class VirtualMachineParameters:
    log_num_subcircuit: int
    dummy_constraint_num: int = 30
    operations_per_chunk: int = 2  # power of two
    use_merkle_memory: bool = False


class VirtualMachine(CircuitWithPortals):
    MEM_TYPE = "ram"

    def __init__(self, params: VirtualMachineParameters):
        self.params = params

    @classmethod
    def rand(cls, rng, params):
        return cls(params)  # vm_constraints.rs:21-23: rand is just new

    @classmethod
    def new(cls, params):
        return cls(params)

    def get_params(self):
        return self.params

    def num_subcircuits(self):
        return 1 << self.params.log_num_subcircuit

    def get_unique_subcircuits(self):
        return [0, 1]

    def representative_subcircuit(self, idx):
        return 0 if idx == 0 else 1

    def get_serialized_witnesses(self, idx):
        return b""  # registers are all ONE in the mock VM (vm_constraints.rs:160-169)

    def set_serialized_witnesses(self, idx, data):
        pass

    def _dummy_ops_native(self, pm: SetupRamPortalManager):
        for _ in range(self.params.operations_per_chunk):
            pm.set("register 1", 1)
            pm.get("register 1")
            pm.get("register 1")

    def get_portal_subtraces(self):
        pm = SetupRamPortalManager()
        for idx in range(self.num_subcircuits()):
            pm.start_subtrace()
            if self.params.use_merkle_memory:
                continue  # no portal ops in Merkle-memory mode (see module doc)
            if idx != 0:
                for i in range(REGISTER_NUM):
                    pm.get(f"register {i}")
                self._dummy_ops_native(pm)
                for i in range(REGISTER_NUM):
                    pm.set(f"register {i}", 1)
            else:
                for i in range(REGISTER_NUM):
                    pm.set(f"register {i}", 1)
                self._dummy_ops_native(pm)
        return pm.subtraces

    def generate_constraints(self, cs, subcircuit_idx, pm):
        merkle = self.params.use_merkle_memory

        def mem_set(name, value):
            # set = two path verifications in Merkle mode (vm/memory.rs:38-51)
            if merkle:
                merkle_path_verification(cs)
                merkle_path_verification(cs)
            else:
                pm.set(name, value)

        def mem_get(name):
            # get = one path verification in Merkle mode (vm/memory.rs:27-36)
            if merkle:
                merkle_path_verification(cs)
            else:
                pm.get(name)

        def set_registers():
            for i in range(REGISTER_NUM):
                mem_set(f"register {i}", FpVar.witness(cs, 1))

        def get_registers():
            for i in range(REGISTER_NUM):
                mem_get(f"register {i}")

        def dummy_operation():
            for _ in range(self.params.operations_per_chunk):
                mem_set("register 1", FpVar.witness(cs, 1))
                mem_get("register 1")
                mem_get("register 1")
                for _ in range(self.params.dummy_constraint_num // 2):
                    fp1 = FpVar.witness(cs, 12)
                    fp2 = FpVar.witness(cs, 12)
                    _ = fp1 * fp2

        if subcircuit_idx != 0:
            get_registers()
            dummy_operation()
            set_registers()
        else:
            set_registers()
            dummy_operation()
