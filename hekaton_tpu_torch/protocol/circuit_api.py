"""The partitionable-circuit abstraction every workload implements.

Python equivalent of the CircuitWithPortals trait
(distributed-prover/src/lib.rs:49-93): per-subcircuit witness
(de)serialization, native portal-trace generation, unique-subcircuit dedup for
CRS reuse, and per-subcircuit constraint generation against a portal manager.
"""
from __future__ import annotations


class CircuitWithPortals:
    MEM_TYPE = "rom"  # or "ram"

    @classmethod
    def rand(cls, rng, params) -> "CircuitWithPortals":
        raise NotImplementedError

    @classmethod
    def new(cls, params) -> "CircuitWithPortals":
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def get_portal_subtraces(self) -> list:
        """Native (non-ZK) trace generation: one subtrace per subcircuit."""
        raise NotImplementedError

    def num_subcircuits(self) -> int:
        raise NotImplementedError

    def get_unique_subcircuits(self) -> list:
        raise NotImplementedError

    def representative_subcircuit(self, subcircuit_idx: int) -> int:
        raise NotImplementedError

    def get_serialized_witnesses(self, subcircuit_idx: int) -> bytes:
        raise NotImplementedError

    def set_serialized_witnesses(self, subcircuit_idx: int, data: bytes):
        raise NotImplementedError

    def generate_constraints(self, cs, subcircuit_idx: int, pm):
        raise NotImplementedError
