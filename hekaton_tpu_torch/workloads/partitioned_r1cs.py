"""Partitioned circom-R1CS workload.

Behavioral equivalent of
distributed-prover/src/partitioned_r1cs_circuit.rs: loads
externally-partitioned circom circuits — per subcircuit an `.r1cs` file, a
`.json` witness, and a `.meta` file listing owned/borrowed shared wires
(partitioned_r1cs_circuit.rs:66-92) — and replays the raw R1CS rows with
portal set/get for the shared wires (:116-178). `num_txs` tiles the whole
partition into independent copies sharing CRSs (:41-43,124-126).

Meta file format: first line `<total> <num_owned>`, then one wire index per
line; the first `num_owned` are owned (set), the rest borrowed (get).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from ..circom import R1CSFile, read_witness
from ..fields.bn254 import R
from ..protocol.circuit_api import CircuitWithPortals
from ..protocol.portal_manager import SetupRomPortalManager
from ..r1cs.builder import var_instance, var_witness
from ..r1cs.gadgets import FpVar


@dataclass(frozen=True)
class PartitionedR1CSCircuitParams:
    num_subcircuits: int
    num_txs: int
    file_path: str  # prefix: expects {prefix}.{i}.r1cs / .json / .meta


class PartitionedR1CSCircuit(CircuitWithPortals):
    MEM_TYPE = "rom"

    def __init__(self, params: PartitionedR1CSCircuitParams):
        self.params = params
        self.r1cs = []
        self.shared_wires = []  # (owned, borrowed) wire-index lists
        for i in range(params.num_subcircuits):
            with open(f"{params.file_path}.{i}.r1cs", "rb") as f:
                file = R1CSFile.read(f.read())
            with open(f"{params.file_path}.{i}.json") as f:
                file.witness = read_witness(f.read())
            with open(f"{params.file_path}.{i}.meta") as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            num_owned = int(lines[0].split()[1])
            wires = [int(x) for x in lines[1:]]
            owned, borrowed = wires[:num_owned], wires[num_owned:]
            self.r1cs.append(file)
            self.shared_wires.append((owned, borrowed))

    @classmethod
    def rand(cls, rng, params):
        return cls(params)  # partitioned_r1cs_circuit.rs:60-63: rand is new

    @classmethod
    def new(cls, params):
        return cls(params)

    def get_params(self):
        return self.params

    def num_subcircuits(self):
        return self.params.num_subcircuits * self.params.num_txs

    def get_unique_subcircuits(self):
        return list(range(self.params.num_subcircuits))

    def representative_subcircuit(self, idx):
        return idx % self.params.num_subcircuits

    def get_serialized_witnesses(self, idx):
        wit = self.r1cs[idx % self.params.num_subcircuits].witness
        out = len(wit).to_bytes(8, "little")
        return out + b"".join(w.to_bytes(32, "little") for w in wit)

    def set_serialized_witnesses(self, idx, data):
        if not data:
            return
        n = int.from_bytes(data[:8], "little")
        self.r1cs[idx % self.params.num_subcircuits].witness = [
            int.from_bytes(data[8 + 32 * i : 8 + 32 * (i + 1)], "little") for i in range(n)
        ]

    def generate_constraints(self, cs, subcircuit_idx, pm):
        r1cs = self.r1cs[subcircuit_idx % self.params.num_subcircuits]
        owned, borrowed = self.shared_wires[subcircuit_idx % self.params.num_subcircuits]
        group = subcircuit_idx // self.params.num_subcircuits
        num_unique = r1cs.header.n_wires - len(owned) - len(borrowed)

        # wire layout (partitioned_r1cs_circuit.rs:128-150): wire 0 = ONE,
        # wires [1, num_unique) private; then owned portals, then borrowed
        variables = []
        for i in range(num_unique):
            if i == 0:
                variables.append(FpVar.constant(cs, 1))
            else:
                variables.append(FpVar.witness(cs, r1cs.witness[i] % R))
        for i, wire_idx in enumerate(owned):
            v = FpVar.witness(cs, r1cs.witness[num_unique + i] % R)
            pm.set(f"var{group}_{wire_idx}", v)
            variables.append(v)
        for wire_idx in borrowed:
            variables.append(pm.get(f"var{group}_{wire_idx}"))

        def make_lc(vec) -> dict:
            lc: dict = {}
            for idx, coeff in vec:
                v = variables[idx]
                for k, c in v.lc.items():
                    lc[k] = (lc.get(k, 0) + coeff * c) % R
            return lc

        if not cs.value_only:  # replayed rows are pure bookkeeping
            for a, b, c in r1cs.constraints:
                cs.enforce(make_lc(a), make_lc(b), make_lc(c))

        if self.params.num_subcircuits == 1:
            # a single-partition circuit has no cross-subcircuit wires; the
            # protocol needs >=1 portal entry (partitioned_r1cs_circuit.rs:168-170)
            pm.set(f"dummy{subcircuit_idx}", FpVar.constant(cs, 0))

    def get_portal_subtraces(self):
        pm = SetupRomPortalManager()
        for subcircuit_idx in range(self.num_subcircuits()):
            pm.start_subtrace()
            r1cs = self.r1cs[subcircuit_idx % self.params.num_subcircuits]
            owned, borrowed = self.shared_wires[subcircuit_idx % self.params.num_subcircuits]
            group = subcircuit_idx // self.params.num_subcircuits
            num_unique = r1cs.header.n_wires - len(owned) - len(borrowed)
            for i, wire_idx in enumerate(owned):
                pm.set(f"var{group}_{wire_idx}", r1cs.witness[num_unique + i] % R)
            for wire_idx in borrowed:
                pm.get(f"var{group}_{wire_idx}")
            if self.params.num_subcircuits == 1:
                pm.set(f"dummy{subcircuit_idx}", 0)
        return pm.subtraces
