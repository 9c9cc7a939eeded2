"""Minimal portal-chain workload: a squaring chain threaded through portals.

The smallest CircuitWithPortals — subcircuit i reads c_{i-1}, computes
c_i = c_{i-1}^2 + i, and publishes it. Used as the fast end-to-end pipeline
exercise (the protocol wrapper dominates its cost) and as a template for
writing new workloads.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.bn254 import R
from ..protocol.circuit_api import CircuitWithPortals
from ..protocol.portal_manager import SetupRomPortalManager
from ..r1cs.gadgets import FpVar


@dataclass(frozen=True)
class PortalChainParams:
    num_subcircuits: int  # power of two >= 2


class PortalChainCircuit(CircuitWithPortals):
    MEM_TYPE = "rom"

    def __init__(self, seed: int, params: PortalChainParams):
        n = params.num_subcircuits
        assert n >= 2 and n & (n - 1) == 0
        self.seed = seed % R
        self.params = params

    @classmethod
    def rand(cls, rng, params):
        return cls(rng.next_fr(), params)

    @classmethod
    def new(cls, params):
        return cls(0, params)

    def get_params(self):
        return self.params

    def num_subcircuits(self):
        return self.params.num_subcircuits

    def get_unique_subcircuits(self):
        n = self.params.num_subcircuits
        return [0, 1, n - 1] if n > 2 else [0, 1]

    def representative_subcircuit(self, idx):
        n = self.params.num_subcircuits
        if idx == 0 or idx == n - 1:
            return idx
        return 1

    def get_serialized_witnesses(self, idx):
        return self.seed.to_bytes(32, "little") if idx == 0 else b""

    def set_serialized_witnesses(self, idx, data):
        if idx == 0 and data:
            self.seed = int.from_bytes(data, "little") % R

    def _chain(self):
        # NB: the step must not depend on the subcircuit index — index-specific
        # constants would enter the constraint matrices and break CRS sharing
        # across same-shape subcircuits (the reference's dedup invariant).
        vals = [self.seed]
        for _ in range(1, self.params.num_subcircuits):
            vals.append((vals[-1] * vals[-1] + 1) % R)
        return vals

    def generate_constraints(self, cs, subcircuit_idx, pm):
        if subcircuit_idx == 0:
            c = FpVar.witness(cs, self.seed)
            pm.set("c0", c)
        else:
            prev = pm.get(f"c{subcircuit_idx - 1}")
            cur = prev * prev + 1
            pm.set(f"c{subcircuit_idx}", cur)

    def get_portal_subtraces(self):
        pm = SetupRomPortalManager()
        vals = self._chain()
        for i in range(self.params.num_subcircuits):
            pm.start_subtrace()
            if i == 0:
                pm.set("c0", vals[0])
            else:
                pm.get(f"c{i - 1}")
                pm.set(f"c{i}", vals[i])
        return pm.subtraces
